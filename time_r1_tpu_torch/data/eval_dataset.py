"""Eval datasets: annotation rows → tokenized engine Requests (port of the
JAX package's `data/eval_dataset.py`; the upstream
src/vllm_inference/data/__init__.py dataset classes):
- TG and MCQ variants with the r1 / default / nothink prompt selection matrix
  (build_dataloader :609-680);
- contiguous index sharding (curr_idx/total_idx) and resume-by-qid filtering;
- message shape: explicit system turn + user turn [video, text];
- nothink appends "<think>\\n</think>\\n" AFTER the generation prompt;
- prepared-video cache (./video_cache/{name}_test_{tokens}/{video_id}.npz)
  and an in-process video cache (default on: Charades averages several
  sentences per video, so consecutive rows re-decode the same file without it;
  LimitedSizeSharedDict semantics, data/__init__.py:99-139);
- parallel host video decode: a worker pool feeds the prefetch window
  (DataLoader num_workers=8 + prefetch, data/__init__.py:671-679). Threads,
  because the native FFmpeg decoder and resize (ctypes) release the GIL, so N
  decodes overlap without pickling ~30 MB frame arrays across processes;
  in-flight futures are deduped by video key so the window never decodes the
  same file twice;
- video decode through the native pipeline (`video/`), budgeted by
  total_pixels/min_pixels like process_vision_info_v3.

Output item: {"request": sampler.Request, "qid", "duration", and
"timestamps" (tg) or "answer"+"options" (mcq), "video_path"}. The request's
patches stay on the host (numpy f32); the engine moves them to its device.
Undecodable videos yield a FAILED item ({"failed": True, no "request"}) so
the eval CLI can emit a scored-as-zero record for the row: the upstream code
emits a prediction for every row, and dropping rows would inflate the
scores' denominators.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..models.processor import Qwen25VLProcessor
from ..sampler.engine import Request
from ..video.pipeline import fetch_video
from .loaders import load_datasets, split_data
from .prompts import ANSWER_PROMPT, DEFAULT_MCQ_PROMPT, DEFAULT_SYS_PROMPT, DEFAULT_TG_PROMPT


class VideoCache:
    """In-process FIFO-eviction cache in place of the upstream
    LimitedSizeSharedDict (src/vllm_inference/data/__init__.py:99-139; one
    process, so no multi-worker Manager dict).

    Eviction is deliberately FIFO, not LRU (`get` does not refresh recency
    and `put` ignores existing keys), because that is what
    LimitedSizeSharedDict does (it pops the oldest *inserted* key). Eval rows
    arrive grouped by video, so insertion order ≈ last-use order. The decode
    workers call it from several threads: a lock guards the check-then-act
    of `put`."""

    def __init__(self, max_size: int = 8):
        self.max_size = max_size
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            return self._d.get(key)

    def put(self, key, value):
        with self._lock:
            if self.max_size <= 0 or key in self._d:
                return
            if len(self._d) >= self.max_size:
                self._d.popitem(last=False)
            self._d[key] = value


class EvalDataset:
    """Iterable over eval items producing ready-to-run engine Requests."""

    def __init__(
        self,
        processor: Qwen25VLProcessor,
        datatype: str,  # "tg" | "mcq"
        dataset_names: Sequence[str],
        split: str = "test",
        curr_idx: int = 0,
        total_idx: int = 1,
        already_finished: Optional[set] = None,
        sys_prompt: str = DEFAULT_SYS_PROMPT,
        prompt: Optional[str] = None,
        min_pixels: int = 16 * 28 * 28,
        total_pixels: int = 3584 * 28 * 28,
        use_r1_thinking_prompt: bool = False,
        prompt_type: str = "r1",
        use_nothink: bool = False,
        use_prepared_video: bool = False,
        use_answer_prompt: bool = False,  # HF-style MCQ assistant-prefix path
        cache_size: int = 8,
        video_cache_root: str = "./video_cache",
        num_workers: int = 8,
    ):
        assert datatype in ("tg", "mcq")
        self.processor = processor
        self.datatype = datatype
        self.sys_prompt = sys_prompt
        self.min_pixels = min_pixels
        self.total_pixels = total_pixels
        self.use_nothink = use_nothink
        self.use_answer_prompt = use_answer_prompt
        self.answer_prompt = ANSWER_PROMPT

        default = DEFAULT_TG_PROMPT if datatype == "tg" else DEFAULT_MCQ_PROMPT
        if prompt is None:
            self.prompt = default[prompt_type] if use_r1_thinking_prompt else default["default"]
        else:
            self.prompt = prompt

        data = load_datasets(list(dataset_names), split=split)
        data = split_data(data, curr_idx, total_idx)
        finished = already_finished or set()
        self.data = [itm for itm in data if itm["qid"] not in finished]

        self.prepared_video_dirs = []
        if use_prepared_video:
            for name in dataset_names:
                self.prepared_video_dirs.append(
                    os.path.join(video_cache_root, f"{name}_test_{total_pixels // 28 // 28}")
                )
        self.cache = VideoCache(cache_size)
        self.num_workers = max(int(num_workers), 0)

    def __len__(self) -> int:
        return len(self.data)

    # ------------------------------------------------------------------
    def _video_ele(self, itm: dict) -> dict:
        ele = {"video": itm["video"], "min_pixels": self.min_pixels, "total_pixels": self.total_pixels}
        if itm.get("video_start") is not None:
            ele["video_start"] = itm["video_start"]
        if itm.get("video_end") is not None:
            ele["video_end"] = itm["video_end"]
        return ele

    def _video_key(self, itm: dict) -> str:
        return repr(sorted(self._video_ele(itm).items()))

    def _load_video(self, itm: dict):
        ele = self._video_ele(itm)
        key = self._video_key(itm)
        cached = self.cache.get(key)
        if cached is not None:
            return cached
        for vdir in self.prepared_video_dirs:
            vid = itm["video"].split("/")[-1].split(".")[0]
            path = os.path.join(vdir, vid + ".npz")
            if os.path.exists(path):
                z = np.load(path)
                out = (z["video"].astype(np.float32), float(z["fps"]))
                self.cache.put(key, out)
                return out
        out = fetch_video(ele)
        self.cache.put(key, out)
        return out

    def _user_text(self, itm: dict) -> str:
        if self.datatype == "tg":
            return self.prompt.format(itm["sentence"])
        letters = [chr(ord("A") + i) for i in range(len(itm["options"]))]
        options = "\n".join(f"({l}) {o}" for l, o in zip(letters, itm["options"]))
        return self.prompt.format(itm["question"], options)

    def _meta_fields(self, itm: dict) -> dict:
        out = {"qid": itm["qid"], "duration": itm.get("duration"), "video_path": itm["video"]}
        if self.datatype == "tg":
            out["timestamps"] = list(itm["timestamp"])
        else:
            out["answer"] = itm["answer"]
            out["options"] = [chr(ord("A") + i) for i in range(len(itm["options"]))]
        return out

    def failed_item(self, itm: dict, error: Exception) -> dict:
        """Item emitted for an undecodable video: carries the row metadata but
        no request, so the CLI writes a scored-as-zero record (keeping the
        upstream every-row denominator, eval_all.py:107-116) and resume
        does not re-attempt the row forever."""
        out = self._meta_fields(itm)
        out["failed"] = True
        out["error"] = str(error)
        return out

    def build_item(self, itm: dict, video=None) -> dict:
        frames, sample_fps = self._load_video(itm) if video is None else video
        messages = [
            {"role": "system", "content": [{"type": "text", "text": self.sys_prompt}]},
            {
                "role": "user",
                "content": [
                    {"type": "video", "video": itm["video"]},
                    {"type": "text", "text": self._user_text(itm)},
                ],
            },
        ]
        if self.use_answer_prompt and self.datatype == "mcq":
            # assistant-prefix trick: render WITHOUT generation prompt, strip
            # the trailing <|im_end|> (data/__init__.py:354-371)
            messages.append(
                {"role": "assistant", "content": [{"type": "text", "text": self.answer_prompt}]}
            )
            text = self.processor.apply_chat_template(messages, add_generation_prompt=False)
            text = "<|im_end|>".join(text.split("<|im_end|>")[:-1])
        else:
            text = self.processor.apply_chat_template(messages, add_generation_prompt=True)
            if self.use_nothink:
                text = text + "<think>\n</think>\n"

        proc = self.processor(text=[text], videos=[frames], fps=[sample_fps])
        ids = proc.input_ids[0][proc.attention_mask[0] == 1].tolist()
        req = Request(
            input_ids=ids,
            patches=proc.pixel_values_videos,
            grid_thw=tuple(int(x) for x in proc.video_grid_thw[0]),
            second_per_grid_t=proc.second_per_grid_ts[0],
        )
        out = self._meta_fields(itm)
        out["request"] = req
        return out

    def __iter__(self) -> Iterator[dict]:
        if self.num_workers > 1:
            yield from self._iter_parallel()
            return
        for itm in self.data:
            try:
                yield self.build_item(itm)
            except Exception as e:
                # decode-failure tolerance (§5.3): the row still reaches the
                # output as a failed item — see failed_item
                print(f"[eval] {itm.get('qid')}: video load failed: {e}")
                yield self.failed_item(itm, e)

    def _iter_parallel(self) -> Iterator[dict]:
        """Decode videos num_workers-wide ahead of consumption, in order.

        A sliding window of ThreadPoolExecutor futures runs _load_video (C
        decode + resize, GIL-released); tokenization stays on the consumer
        thread. In-flight futures are deduped by video key: Charades-style
        consecutive same-video rows share ONE decode even before the result
        lands in the LRU cache."""
        from concurrent.futures import ThreadPoolExecutor

        window = self.num_workers * 2
        inflight: "OrderedDict[int, object]" = OrderedDict()  # row idx → future
        by_key: dict = {}  # video key → future (alive while any row needs it)
        key_of: dict = {}
        refs: dict = {}  # video key → number of in-window rows still needing it

        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            it = enumerate(self.data)
            done = False

            def submit_next():
                nonlocal done
                try:
                    i, itm = next(it)
                except StopIteration:
                    done = True
                    return
                key = self._video_key(itm)
                fut = by_key.get(key)
                if fut is None:
                    fut = ex.submit(self._load_video, itm)
                    by_key[key] = fut
                inflight[i] = fut
                key_of[i] = key
                refs[key] = refs.get(key, 0) + 1

            while len(inflight) < window and not done:
                submit_next()
            while inflight:
                i, fut = next(iter(inflight.items()))
                del inflight[i]
                itm = self.data[i]
                key = key_of.pop(i)
                refs[key] -= 1
                if refs[key] == 0:
                    del refs[key]
                try:
                    video = fut.result()
                    if key not in refs:
                        by_key.pop(key, None)
                    yield self.build_item(itm, video=video)
                except Exception as e:
                    by_key.pop(key, None)
                    print(f"[eval] {itm.get('qid')}: video load failed: {e}")
                    yield self.failed_item(itm, e)
                while len(inflight) < window and not done:
                    submit_next()

    def iter_batches(self, batch_size: int, prefetch: int = 2) -> Iterator[List[dict]]:
        """Batched iteration with background-thread prefetch so host video
        decode overlaps device compute (DataLoader num_workers/prefetch
        capability, data/__init__.py:671-679)."""
        import queue

        def batches():
            batch: List[dict] = []
            for item in self:
                batch.append(item)
                if len(batch) == batch_size:
                    yield batch
                    batch = []
            if batch:
                yield batch

        if prefetch <= 0:
            yield from batches()
            return

        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        SENTINEL = object()
        errors = []

        def producer():
            try:
                for b in batches():
                    q.put(b)
            except Exception as e:  # pragma: no cover
                errors.append(e)
            finally:
                q.put(SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is SENTINEL:
                break
            yield b
        t.join()
        if errors:
            raise errors[0]
