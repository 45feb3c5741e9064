"""Video ingestion: timestamped decode → budgeted resize → TCHW float.

The upstream fetch_video_v3 / monkey-patched decord reader
(vision_process.py:426-492 + src/vllm_inference/utils.py:13-57, the variant
that both eval and the demo use):

  1. plan_frame_window: timestamp → frame clamping + smart_nframes + linspace
     sampling (pure math, `utils/vision_math.py`);
  2. native FFmpeg batch decode (`video/decoder.py`);
  3. per-frame pixel budget (total_pixels/nframes·FRAME_FACTOR) + smart_resize;
  4. bicubic antialiased resize → float32 TCHW (`video/resize.py`).

Returns (frames (T, C, H, W) float32 in 0..255, sample_fps): the shape and
scale the processor's patchify expects.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ..utils.vision_math import (
    IMAGE_FACTOR,
    VIDEO_MIN_PIXELS,
    plan_frame_window,
    plan_video_shapes,
    smart_resize,
)
from .decoder import VideoReader
from .resize import resize_frames_device, resize_frames_host


def resize_frames_bicubic(frames_hwc: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(T, H, W, C) uint8 → (T, out_h, out_w, C) uint8, bicubic + antialias.

    The default computes the separable antialiased bicubic in float32 with
    one final rounding, torchvision's antialias=True semantics (the resize
    the upstream code runs, vision_process.py:398-403), by the native banded
    kernel on the host. Alternatives:
      TIMER1_DEVICE_RESIZE=1     the same math as two f32 matmuls on the card
      TIMER1_RESIZE_BACKEND=pil  PIL (rounds to uint8 between the separable
                                 passes: up to 16/255 off on steep edges;
                                 kept for comparison only)."""
    if frames_hwc.shape[1] == out_h and frames_hwc.shape[2] == out_w:
        return frames_hwc
    if os.environ.get("TIMER1_DEVICE_RESIZE") == "1":
        return resize_frames_device(frames_hwc, out_h, out_w).cpu().numpy()
    if os.environ.get("TIMER1_RESIZE_BACKEND") == "pil":
        from PIL import Image

        out = np.empty((frames_hwc.shape[0], out_h, out_w, frames_hwc.shape[3]), np.uint8)
        for i, f in enumerate(frames_hwc):
            out[i] = np.asarray(Image.fromarray(f).resize((out_w, out_h), Image.BICUBIC))
        return out
    return resize_frames_host(frames_hwc, out_h, out_w)


def fetch_video(ele: dict) -> Tuple[np.ndarray, float]:
    """Decode + budget-resize one video element.

    `ele` keys (fetch_video_v3's): video (path), video_start, video_end,
    nframes | fps (+min/max_frames), total_pixels, min_pixels, max_pixels,
    resized_height/width.
    """
    vr = VideoReader(ele["video"])
    try:
        plan = plan_frame_window(ele, total_frames=len(vr), video_fps=vr.get_avg_fps())
        try:
            frames = vr.get_batch(list(plan.indices))  # (T, H, W, C) uint8
        except IOError as e:
            # the upstream per-video backend fallback (vision_process.py:362-368):
            # re-open and decode in the tolerant mode that skips corrupt frames
            # and backfills, instead of dropping the item
            print(f"video decode failed ({e}), retrying with tolerant backend: {ele['video']}")
            vr.close()
            vr = VideoReader(ele["video"])
            frames = vr.get_batch(list(plan.indices), tolerant=True)
    finally:
        vr.close()

    nframes, height, width = frames.shape[0], frames.shape[1], frames.shape[2]
    if "resized_height" in ele and "resized_width" in ele:
        out_h, out_w = smart_resize(ele["resized_height"], ele["resized_width"], factor=IMAGE_FACTOR)
    else:
        out_h, out_w = plan_video_shapes(
            height,
            width,
            nframes=nframes,
            total_pixels=ele.get("total_pixels"),
            min_pixels=ele.get("min_pixels", VIDEO_MIN_PIXELS),
            max_pixels=ele.get("max_pixels"),
        )
    frames = resize_frames_bicubic(frames, out_h, out_w)
    # TCHW float32 (0..255) like torchvision resize(...).float()
    return frames.transpose(0, 3, 1, 2).astype(np.float32), plan.sample_fps


def video_loader(ele: dict) -> Tuple[np.ndarray, float]:
    """The trainer's and the eval datasets' loader (`GRPOTrainer(video_loader=...)`)."""
    return fetch_video(ele)
