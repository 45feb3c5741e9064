"""Pure integer/float math for Qwen2.5-VL-style dynamic-resolution video budgeting
(the port's copy of the JAX package's `utils/vision_math.py`).

Semantics follow the upstream Time-R1 code:
  src/utils/vision_process.py
    - constants                 :24-42
    - round/ceil/floor_by_factor:45-57
    - smart_resize              :60-90
    - smart_nframes             :154-199
    - per-frame pixel budget    :374-377 (inside fetch_video)
  src/vllm_inference/utils.py
    - timestamp→frame-window clamping :33-43 (the variant used by eval/demo)

Everything here is host-side pure math, with no torch. These functions
decide the shapes fed to the device, so the tests hold them equal to the JAX
package's over a grid of sizes, frame counts, fps and windows.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MAX_RATIO = 200

VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 768 * 28 * 28
FRAME_FACTOR = 2
FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 768

# Global video token budget in pixels; env-overridable like the reference
# (vision_process.py:39-41). ~128K tokens * 28^2 px/token * 0.9 headroom.
VIDEO_TOTAL_PIXELS = int(float(os.environ.get("VIDEO_MAX_PIXELS", 128000 * 28 * 28 * 0.9)))


def round_by_factor(number: float, factor: int) -> int:
    """Closest integer to `number` divisible by `factor` (banker's rounding,
    matching Python round() as the reference uses)."""
    return round(number / factor) * factor


def ceil_by_factor(number: float, factor: int) -> int:
    """Smallest integer >= `number` divisible by `factor`."""
    return math.ceil(number / factor) * factor


def floor_by_factor(number: float, factor: int) -> int:
    """Largest integer <= `number` divisible by `factor`."""
    return math.floor(number / factor) * factor


def smart_resize(
    height: int,
    width: int,
    factor: int = IMAGE_FACTOR,
    min_pixels: int = MIN_PIXELS,
    max_pixels: int = MAX_PIXELS,
) -> tuple[int, int]:
    """Pick an output (h, w) with both sides divisible by `factor`, total pixel
    count in [min_pixels, max_pixels], aspect ratio approximately preserved.

    Mirrors reference vision_process.py:60-90 exactly: round first; if over
    budget, scale down by sqrt(hw/max) then floor to factor; if under, scale
    up by sqrt(min/hw) then ceil to factor.
    """
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(
            f"absolute aspect ratio must be smaller than {MAX_RATIO}, "
            f"got {max(height, width) / min(height, width)}"
        )
    h_bar = max(factor, round_by_factor(height, factor))
    w_bar = max(factor, round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = floor_by_factor(height / beta, factor)
        w_bar = floor_by_factor(width / beta, factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def smart_nframes(
    ele: dict,
    total_frames: int,
    video_fps: float,
) -> int:
    """Number of frames to sample for model input.

    `ele` may carry either `nframes` (exact, rounded to FRAME_FACTOR) or `fps`
    (+ optional min_frames/max_frames). Mirrors vision_process.py:154-199:
    target = total/video_fps*fps, clamped to [min_frames, max_frames] then to
    total_frames, floored to FRAME_FACTOR.
    """
    assert not ("fps" in ele and "nframes" in ele), "Only accept either `fps` or `nframes`"
    if "nframes" in ele:
        nframes = round_by_factor(ele["nframes"], FRAME_FACTOR)
    else:
        fps = ele.get("fps", FPS)
        min_frames = ceil_by_factor(ele.get("min_frames", FPS_MIN_FRAMES), FRAME_FACTOR)
        max_frames = floor_by_factor(
            ele.get("max_frames", min(FPS_MAX_FRAMES, total_frames)), FRAME_FACTOR
        )
        nframes = total_frames / video_fps * fps
        nframes = min(min(max(nframes, min_frames), max_frames), total_frames)
        nframes = floor_by_factor(nframes, FRAME_FACTOR)
    if not (FRAME_FACTOR <= nframes <= total_frames):
        raise ValueError(
            f"nframes should in interval [{FRAME_FACTOR}, {total_frames}], but got {nframes}."
        )
    return nframes


def per_frame_max_pixels(
    nframes: int,
    total_pixels: int | None = None,
    min_pixels: int = VIDEO_MIN_PIXELS,
) -> int:
    """Per-frame pixel cap given a whole-video budget.

    Mirrors fetch_video's budget math (vision_process.py:374-377):
    max_pixels = max(min(VIDEO_MAX_PIXELS, total_pixels/nframes*FRAME_FACTOR),
                     int(min_pixels*1.05)).
    Returned as float-compatible value truncated the way the reference computes
    it (the division result stays float in the min()).
    """
    if total_pixels is None:
        total_pixels = VIDEO_TOTAL_PIXELS
    return max(min(VIDEO_MAX_PIXELS, total_pixels / nframes * FRAME_FACTOR), int(min_pixels * 1.05))


@dataclass(frozen=True)
class FrameWindow:
    """Frame-index plan for a timestamped video read."""

    start_frame: int
    end_frame: int  # exclusive in spirit; last sampled index is end_frame - 1
    nframes: int
    indices: tuple[int, ...]
    sample_fps: float


def _linspace_round(start: int, stop: int, num: int) -> list[int]:
    """Integer sample positions: round(linspace(start, stop, num)).

    Matches torch.linspace(...).round().long(): fp32 linspace values rounded
    half-to-even (torch default dtype is float32; torch.round is banker's).
    """
    import numpy as np

    vals = np.linspace(float(start), float(stop), num, dtype=np.float32)
    return [int(v) for v in np.rint(vals)]


def plan_frame_window(
    ele: dict,
    total_frames: int,
    video_fps: float,
) -> FrameWindow:
    """Plan which frame indices to decode for a (possibly timestamped) video.

    Implements the clamping variant from src/vllm_inference/utils.py:33-43
    (used by both vLLM eval and demo via monkey_patch, per SURVEY §7 Phase 1):
      start = max(0, int(video_start * fps)); end = min(total, int(video_end * fps))
      if end <= start: end = start + 1; if end > total: end = total, start = end-1
    Then sample nframes via round(linspace(start, end-1, n)).
    """
    video_start = ele.get("video_start", 0.0)
    if video_start is None:
        video_start = 0.0
    video_end = ele.get("video_end", total_frames / video_fps)
    if video_end is None:
        video_end = total_frames / video_fps

    start_frame = max(0, int(video_start * video_fps))
    end_frame = min(total_frames, int(video_end * video_fps))
    if end_frame <= start_frame:
        end_frame = start_frame + 1
        if end_frame > total_frames:
            end_frame = total_frames
            start_frame = max(0, end_frame - 1)
    effective_frames = end_frame - start_frame
    nframes = smart_nframes(ele, total_frames=effective_frames, video_fps=video_fps)
    if effective_frames == 0:
        indices = [start_frame]
    else:
        indices = _linspace_round(start_frame, end_frame - 1, nframes)
    sample_fps = nframes / max(effective_frames, 1e-6) * video_fps
    return FrameWindow(
        start_frame=start_frame,
        end_frame=end_frame,
        nframes=nframes,
        indices=tuple(indices),
        sample_fps=sample_fps,
    )


def plan_video_shapes(
    height: int,
    width: int,
    nframes: int,
    total_pixels: int | None = None,
    min_pixels: int = VIDEO_MIN_PIXELS,
    max_pixels: int | None = None,
    image_factor: int = IMAGE_FACTOR,
) -> tuple[int, int]:
    """Resolve final (resized_h, resized_w) for a video under the token budget.

    Combines per-frame budget (fetch_video, vision_process.py:374-383) with
    smart_resize. `max_pixels`, when given by the caller, is additionally
    capped by the derived per-frame budget (vision_process.py:378-383).
    """
    budget = per_frame_max_pixels(nframes, total_pixels, min_pixels)
    if max_pixels is not None:
        budget = min(max_pixels, budget)
    return smart_resize(
        height, width, factor=image_factor, min_pixels=min_pixels, max_pixels=budget
    )
