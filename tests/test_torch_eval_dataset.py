"""The port's eval datasets (`time_r1_tpu_torch/data/eval_dataset.py`) against
the JAX package's, on the clip that tests/test_torch_video.py writes with
OpenCV and the tiny config's tokenizer (tests/tiny_tokenizer.py): TG rows
(several per video, timestamp windows, a missing video) and MCQ rows, over
the prompt matrix (r1 / default / nothink / the answer-prompt prefix) and the
prepared-video cache. Every item equals JAX's (request ids, grid and seconds
per grid equal, patches bit-equal; the row metadata; failed items), and the
threaded decode window gives the items of the serial loop."""

import json
import shutil

import numpy as np
import pytest

from test_torch_video import jax_native_libs, write_clip
from tiny_tokenizer import TinyTokenizer
from time_r1_tpu.data import EvalDataset as JaxEvalDataset
from time_r1_tpu.models.processor import Qwen25VLProcessor as JaxProcessor
from time_r1_tpu_torch.data import EvalDataset, VideoCache
from time_r1_tpu_torch.models.processor import Qwen25VLProcessor
from time_r1_tpu_torch.sampler import Request


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A tvgbench_filter file of TG rows over two clips (and one missing
    video) and an mvbench tree of MCQ rows over the first clip."""
    jax_native_libs()
    root = tmp_path_factory.mktemp("eval")
    a = write_clip(root / "a.mp4", seed=0)
    b = write_clip(root / "b.mp4", frames=16, fps=4.0, seed=1)
    tg = [
        {"video": a, "duration": 3.0, "timestamp": [0.5, 1.5], "sentence": "a door opens", "qid": "tg_0"},
        {"video": a, "duration": 3.0, "timestamp": [1.0, 2.0], "sentence": "a man sits", "qid": "tg_1"},
        {"video": b, "duration": 4.0, "timestamp": [0.0, 1.0], "sentence": "lights", "qid": "tg_2",
         "video_start": 1.0, "video_end": 3.5},
        {"video": str(root / "missing.mp4"), "duration": 1.0, "timestamp": [0, 1], "sentence": "x", "qid": "tg_3"},
        {"video": a, "duration": 3.0, "timestamp": [2.0, 3.0], "sentence": "a dog runs", "qid": "tg_4"},
        {"video": b, "duration": 4.0, "timestamp": [1.0, 2.0], "sentence": "rain", "qid": "tg_5"},
    ]
    (root / "tg.json").write_text(json.dumps(tg))
    vdir = root / "mvbench" / "video" / "perception" / "videos"
    vdir.mkdir(parents=True)
    shutil.copy(a, vdir / "a.mp4")
    (root / "mvbench" / "json").mkdir()
    (root / "mvbench" / "json" / "action_count.json").write_text(json.dumps([
        {"video": "a.mp4", "question": "how many?", "candidates": ["1", "2", "3"], "answer": "2"},
        {"video": "a.mp4", "question": "what next?", "candidates": ["run", "sit"], "answer": "sit", "end": 2.0},
    ]))
    return root


def _processors():
    kw = dict(pad_token_id=0, eos_token_id=1)
    return Qwen25VLProcessor(TinyTokenizer(), **kw), JaxProcessor(TinyTokenizer(), **kw)


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w), (g.keys(), w.keys())
        for k in w:
            if k != "request":
                assert g[k] == w[k], k
        if "request" in w:
            gr, wr = g["request"], w["request"]
            assert isinstance(gr, Request)
            assert gr.input_ids == wr.input_ids
            assert gr.grid_thw == wr.grid_thw and gr.second_per_grid_t == wr.second_per_grid_t
            assert gr.patches.dtype == np.float32
            np.testing.assert_array_equal(gr.patches, wr.patches)


def _both(tree, datatype, names, split, monkeypatch, **kw):
    import time_r1_tpu.data.loaders as JL
    import time_r1_tpu_torch.data.loaders as L

    monkeypatch.setattr(L, "DATA_ROOT", str(tree))
    monkeypatch.setattr(JL, "DATA_ROOT", str(tree))
    mine, ref = _processors()
    return (EvalDataset(mine, datatype, names, split=split, **kw),
            JaxEvalDataset(ref, datatype, names, split=split, **kw))


TG_OPTIONS = [dict(), dict(use_r1_thinking_prompt=True), dict(use_r1_thinking_prompt=True, prompt_type="r1_nocot"),
              dict(use_nothink=True, cache_size=0), dict(curr_idx=1, total_idx=2),
              dict(already_finished={"tg_1", "tg_5"}, min_pixels=4 * 28 * 28, total_pixels=8 * 28 * 28)]


@pytest.mark.parametrize("i", range(len(TG_OPTIONS)))
def test_tg_items_match_jax(tree, monkeypatch, i):
    mine, ref = _both(tree, "tg", ["tvgbench_filter"], str(tree / "tg.json"), monkeypatch, num_workers=0,
                      **TG_OPTIONS[i])
    assert len(mine) == len(ref) and mine.prompt == ref.prompt
    got, want = list(mine), list(ref)
    _assert_items_equal(got, want)
    failed = [it for it in got if it.get("failed")]
    assert [it["qid"] for it in failed] == [q for q in ["tg_3"] if q in {r["qid"] for r in mine.data}]
    assert all("request" in it for it in got if not it.get("failed"))


@pytest.mark.parametrize("kw", [dict(), dict(use_answer_prompt=True), dict(use_r1_thinking_prompt=True)])
def test_mcq_items_match_jax(tree, monkeypatch, kw):
    mine, ref = _both(tree, "mcq", ["mvbench"], "test", monkeypatch, num_workers=0, **kw)
    got = list(mine)
    _assert_items_equal(got, list(ref))
    assert [it["options"] for it in got] == [["A", "B", "C"], ["A", "B"]]
    assert [it["answer"] for it in got] == [1, 1]


def test_parallel_items_equal_serial(tree, monkeypatch):
    """The threaded window (more workers than rows of one video, dedup by
    video key) yields the serial loop's items, in order, failed item included."""
    serial, _ = _both(tree, "tg", ["tvgbench_filter"], str(tree / "tg.json"), monkeypatch, num_workers=0)
    want = list(serial)
    for workers in (2, 8):
        par, ref = _both(tree, "tg", ["tvgbench_filter"], str(tree / "tg.json"), monkeypatch, num_workers=workers)
        _assert_items_equal(list(par), want)
        _assert_items_equal(want, list(ref))
    par, _ = _both(tree, "tg", ["tvgbench_filter"], str(tree / "tg.json"), monkeypatch, num_workers=3)
    batches = list(par.iter_batches(4, prefetch=2))
    assert [len(b) for b in batches] == [4, 2]
    _assert_items_equal([it for b in batches for it in b], want)


def test_prepared_video_cache_matches_jax(tree, monkeypatch, tmp_path):
    total = 3584 * 28 * 28
    vdir = tmp_path / f"tvgbench_filter_test_{total // 28 // 28}"
    vdir.mkdir()
    frames = np.random.default_rng(2).uniform(0, 255, size=(4, 3, 56, 84)).astype(np.float16)
    np.savez(vdir / "a.npz", video=frames, fps=np.float32(1.5))
    kw = dict(num_workers=0, use_prepared_video=True, video_cache_root=str(tmp_path), total_pixels=total)
    mine, ref = _both(tree, "tg", ["tvgbench_filter"], str(tree / "tg.json"), monkeypatch, **kw)
    got = list(mine)
    _assert_items_equal(got, list(ref))
    assert got[0]["request"].grid_thw == (2, 4, 6) and got[0]["request"].second_per_grid_t == 2 / 1.5


def test_video_cache_is_fifo_and_thread_safe():
    from concurrent.futures import ThreadPoolExecutor

    c = VideoCache(2)
    c.put("a", 1)
    c.put("b", 2)
    c.get("a")
    c.put("a", 9)  # existing keys are ignored
    c.put("c", 3)  # evicts the oldest insert, "a"
    assert (c.get("a"), c.get("b"), c.get("c")) == (None, 2, 3)
    c = VideoCache(4)
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda i: c.put(i % 13, i), range(2000)))
    assert len(c._d) == 4
