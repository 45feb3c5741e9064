"""Qwen2.5-VL processor: chat template, video-token expansion, patchify
(port of the JAX package's `models/processor.py`).

The HF AutoProcessor video branch as the upstream code uses it
(timer1_trainer.py:310-319, 547-556; collator src/vllm_inference/data/__init__.py:20-96):

- chat-template rendering for the message shapes the pipeline produces
  (optional system turn; user turn with text + one video; generation prompt);
- expansion of one `<|video_pad|>` placeholder into grid_t·grid_h·grid_w/4
  video tokens;
- CLIP-normalized patchify producing `pixel_values_videos` (P, 1176) and
  `video_grid_thw`, in Qwen2VLImageProcessor's reshape/transpose order:
  `patchify_video_native` (one fused pass in `video/native/resize.cpp`, built
  with g++ at first use; a failed build raises) on the processor's path, and
  `patchify_video` (numpy) as its plain version;
- `second_per_grid_ts = temporal_patch_size / fps`.

The text tokenizer is any HF-compatible tokenizer (`from_pretrained` loads
one with transformers' AutoTokenizer; `save_pretrained` writes its files,
which the trainer does into every checkpoint). When the tokenizer ships a chat
template the processor defers to it; otherwise `render_chat_template`
produces the canonical Qwen2-VL-family format.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..video.resize import _native_lib

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

VISION_START = "<|vision_start|>"
VISION_END = "<|vision_end|>"
VIDEO_PAD = "<|video_pad|>"
IMAGE_PAD = "<|image_pad|>"
DEFAULT_SYSTEM = "You are a helpful assistant."


def render_chat_template(messages: Sequence[dict], add_generation_prompt: bool = True) -> str:
    """Render the Qwen2-VL-family chat format for text/video/image content.

    Matches the canonical checkpoint template for the shapes used here:
    a default system turn is inserted when the first message isn't system;
    list content renders text verbatim and vision elements as
    <|vision_start|><pad><|vision_end|>.
    """
    out = []
    for i, message in enumerate(messages):
        if i == 0 and message["role"] != "system":
            out.append(f"<|im_start|>system\n{DEFAULT_SYSTEM}<|im_end|>\n")
        out.append(f"<|im_start|>{message['role']}\n")
        content = message["content"]
        if isinstance(content, str):
            out.append(content)
        else:
            for ele in content:
                etype = ele.get("type")
                if etype == "image" or "image" in ele or "image_url" in ele:
                    out.append(f"{VISION_START}{IMAGE_PAD}{VISION_END}")
                elif etype == "video" or "video" in ele:
                    out.append(f"{VISION_START}{VIDEO_PAD}{VISION_END}")
                elif "text" in ele:
                    out.append(ele["text"])
        out.append("<|im_end|>\n")
    if add_generation_prompt:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


def _check_patch_grid(H: int, W: int, patch_size: int, merge_size: int) -> None:
    if H % (patch_size * merge_size) or W % (patch_size * merge_size):
        raise ValueError(f"frame size {(H, W)} is not a multiple of {patch_size * merge_size}")


def patchify_video_native(
    frames: np.ndarray,  # (T, C, H, W) float, 0..255 unless do_rescale=False
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
    do_rescale: bool = True,
    do_normalize: bool = True,
) -> tuple[np.ndarray, tuple[int, int, int]]:
    """`patchify_video` as one fused native pass (`native/resize.cpp::t1_patchify`:
    one read and one write of the array instead of numpy's rescale, normalize
    and transpose-copy passes), bit-equal to it: the same float32 operations
    in the same order, built with -ffp-contract=off."""
    patches = np.ascontiguousarray(frames, np.float32)
    T, C, H, W = patches.shape
    _check_patch_grid(H, W, patch_size, merge_size)
    if C > 8:
        raise ValueError(f"the native patchify takes at most 8 channels, got {C}")
    lib = _native_lib()
    grid_t = (T + temporal_patch_size - 1) // temporal_patch_size
    grid_h, grid_w = H // patch_size, W // patch_size
    cols = C * temporal_patch_size * patch_size * patch_size
    flat = np.empty((grid_t * grid_h * grid_w, cols), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    rc = lib.t1_patchify(
        patches.ctypes.data_as(f32p), T, C, H, W,
        flat.ctypes.data_as(f32p), temporal_patch_size, patch_size, merge_size,
        OPENAI_CLIP_MEAN.ctypes.data_as(f32p), OPENAI_CLIP_STD.ctypes.data_as(f32p),
        ctypes.c_float(1.0 / 255.0 if do_rescale else 1.0), ctypes.c_int(int(do_normalize)),
    )
    if rc != 0:
        raise RuntimeError(f"t1_patchify failed (code {rc})")
    return flat, (grid_t, grid_h, grid_w)


def patchify_video(
    frames: np.ndarray,  # (T, C, H, W) float, 0..255 unless do_rescale=False
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
    do_rescale: bool = True,
    do_normalize: bool = True,
) -> tuple[np.ndarray, tuple[int, int, int]]:
    """CLIP-normalize + patchify frames → (pixel_values (P, C·tp·ps²), grid_thw),
    in numpy: the plain version of `patchify_video_native`.

    Frames must already be resized to multiples of patch_size·merge_size (28)."""
    patches = np.asarray(frames, np.float32)
    T, C, H, W = patches.shape
    _check_patch_grid(H, W, patch_size, merge_size)
    if do_rescale:
        patches = patches * (1.0 / 255.0)
    if do_normalize:
        patches = (patches - OPENAI_CLIP_MEAN[None, :, None, None]) / OPENAI_CLIP_STD[None, :, None, None]
    if T % temporal_patch_size != 0:
        reps = np.repeat(patches[-1:], temporal_patch_size - (T % temporal_patch_size), axis=0)
        patches = np.concatenate([patches, reps], axis=0)
    grid_t = patches.shape[0] // temporal_patch_size
    grid_h, grid_w = H // patch_size, W // patch_size
    patches = patches.reshape(
        grid_t,
        temporal_patch_size,
        C,
        grid_h // merge_size,
        merge_size,
        patch_size,
        grid_w // merge_size,
        merge_size,
        patch_size,
    )
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = patches.reshape(grid_t * grid_h * grid_w, C * temporal_patch_size * patch_size * patch_size)
    return flat, (grid_t, grid_h, grid_w)


@dataclass
class ProcessedInputs:
    input_ids: np.ndarray  # (B, S) left-padded
    attention_mask: np.ndarray  # (B, S)
    pixel_values_videos: Optional[np.ndarray]  # (ΣP, 1176)
    video_grid_thw: Optional[np.ndarray]  # (n_videos, 3)
    second_per_grid_ts: Optional[list]


class Qwen25VLProcessor:
    """Tokenizer + template + video patchify, as the upstream code uses HF's
    AutoProcessor. `tokenizer` is any HF-compatible tokenizer exposing
    encode/decode/apply_chat_template for the Qwen2.5-VL vocabulary."""

    def __init__(
        self,
        tokenizer,
        patch_size: int = 14,
        temporal_patch_size: int = 2,
        merge_size: int = 2,
        video_token: str = VIDEO_PAD,
        pad_token_id: int = 151643,
        eos_token_id: int = 151645,
    ):
        self.tokenizer = tokenizer
        self.patch_size = patch_size
        self.temporal_patch_size = temporal_patch_size
        self.merge_size = merge_size
        self.video_token = video_token
        self.pad_token_id = pad_token_id
        self.eos_token_id = eos_token_id

    @classmethod
    def from_pretrained(cls, path: str, **kw):
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(path, use_fast=True)
        return cls(tok, **kw)

    def save_pretrained(self, path: str) -> None:
        """Write the tokenizer's files into `path`, so that `from_pretrained(path)`
        loads it back (HF's Trainer saves its processing class with every
        checkpoint in the same way)."""
        if hasattr(self.tokenizer, "save_pretrained"):  # a stand-in (tests/tiny_tokenizer.py) has no files
            self.tokenizer.save_pretrained(path)

    def apply_chat_template(self, messages, add_generation_prompt: bool = True) -> str:
        tok = self.tokenizer
        if getattr(tok, "chat_template", None):
            return tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=add_generation_prompt
            )
        return render_chat_template(messages, add_generation_prompt)

    def expand_video_tokens(self, text: str, grid_thw: Sequence[tuple]) -> str:
        """Replace each <|video_pad|> with grid.prod()/merge² copies."""
        for grid in grid_thw:
            t, h, w = grid
            n = t * h * w // (self.merge_size**2)
            text = text.replace(self.video_token, "<|placeholder|>" * n, 1)
        return text.replace("<|placeholder|>", self.video_token)

    def __call__(
        self,
        text: Sequence[str],
        videos: Optional[Sequence[np.ndarray]] = None,  # each (T, C, H, W) 0..255
        fps: Optional[Sequence[float]] = None,
        do_rescale: bool = True,
        padding_side: str = "left",
    ) -> ProcessedInputs:
        pixel_list, grids = [], []
        if videos is not None:
            for vid in videos:
                flat, grid = patchify_video_native(
                    vid,
                    self.patch_size,
                    self.temporal_patch_size,
                    self.merge_size,
                    do_rescale=do_rescale,
                )
                pixel_list.append(flat)
                grids.append(grid)
            texts = []
            gi = 0
            for s in text:
                n_vids = s.count(self.video_token)
                texts.append(self.expand_video_tokens(s, grids[gi: gi + n_vids]))
                gi += n_vids
            text = texts

        encoded = [self.tokenizer.encode(s, add_special_tokens=False) for s in text]
        S = max(len(e) for e in encoded)
        B = len(encoded)
        ids = np.full((B, S), self.pad_token_id, np.int64)
        mask = np.zeros((B, S), np.int64)
        for i, e in enumerate(encoded):
            if padding_side == "left":
                ids[i, S - len(e):] = e
                mask[i, S - len(e):] = 1
            else:
                ids[i, : len(e)] = e
                mask[i, : len(e)] = 1
        spg = None
        if videos is not None and fps is not None:
            spg = [self.temporal_patch_size / f for f in fps]
        return ProcessedInputs(
            input_ids=ids,
            attention_mask=mask,
            pixel_values_videos=np.concatenate(pixel_list, axis=0) if pixel_list else None,
            video_grid_thw=np.array(grids, np.int64) if grids else None,
            second_per_grid_ts=spg,
        )

    def decode(self, token_ids, skip_special_tokens: bool = False) -> str:
        return self.tokenizer.decode(token_ids, skip_special_tokens=skip_special_tokens)

    def batch_decode(self, sequences, skip_special_tokens: bool = False) -> list[str]:
        return [self.decode(s, skip_special_tokens) for s in sequences]
