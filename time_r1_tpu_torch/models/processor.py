"""Video patchify for Qwen2.5-VL (numpy path of `time_r1_tpu/models/processor.py`).

CLIP-normalized patchify producing `pixel_values_videos` (P, C·tp·ps²) and
`video_grid_thw`, in the exact reshape/transpose order of
Qwen2VLImageProcessor._preprocess. The chat template, the tokenizer and the
native C++ patchify belong to the host-input slice of the port.
"""

from __future__ import annotations

import numpy as np

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def patchify_video(
    frames: np.ndarray,  # (T, C, H, W) float, 0..255 unless do_rescale=False
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
    do_rescale: bool = True,
    do_normalize: bool = True,
) -> tuple[np.ndarray, tuple[int, int, int]]:
    """CLIP-normalize + patchify frames → (pixel_values (P, C·tp·ps²), grid_thw).

    Frames must already be resized to multiples of patch_size·merge_size (28)."""
    patches = np.asarray(frames, np.float32)
    T, C, H, W = patches.shape
    if H % (patch_size * merge_size) or W % (patch_size * merge_size):
        raise ValueError(f"frame size {(H, W)} is not a multiple of {patch_size * merge_size}")
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
