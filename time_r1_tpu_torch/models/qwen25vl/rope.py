"""M-RoPE 3D position-id computation (host side) for Qwen2.5-VL.

A copy of `time_r1_tpu/models/qwen25vl/rope.py` (numpy only; the port imports
nothing from the JAX package).

Reproduces the semantics of HF `Qwen2_5_VLModel.get_rope_index`: text tokens
advance all three axes together; vision blocks get (t, h, w) grid indices with
the temporal index scaled by `second_per_grid_t * tokens_per_second`; each
subsequent span starts at max(previous positions) + 1.

This is inherently data-dependent host logic (scans token lists), so it runs
in numpy before jit — the device only ever sees the resulting (3, B, S) int32
array. Reference usage: the fps plumbed here is why the reference disables
vLLM's mm-preprocessor cache (vllm_infer.py:55, SURVEY §7 hard-part 5).

Semantics note: recent HF transformers casts `second_per_grid_t` to int64
BEFORE the temporal-index multiply (truncating fractional values like 0.5 → 0),
whereas vLLM — the engine that produced the reference's published eval numbers
(vllm_infer.py:40-58) — keeps float math and truncates only the final product.
We implement the vLLM/float semantics: t_index = int(i * spg * tokens_per_sec).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .config import Qwen25VLConfig


def get_rope_index(
    cfg: Qwen25VLConfig,
    input_ids: np.ndarray,  # (B, S) int
    image_grid_thw: Optional[np.ndarray] = None,  # (n_images, 3)
    video_grid_thw: Optional[np.ndarray] = None,  # (n_videos, 3)
    second_per_grid_ts: Optional[Sequence[float]] = None,  # (n_videos,)
    attention_mask: Optional[np.ndarray] = None,  # (B, S) 1/0
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (position_ids (3, B, S) int32, mrope_deltas (B, 1) int32).

    Padding positions (attention_mask == 0) get position id 1, matching HF.
    """
    input_ids = np.asarray(input_ids)
    B, S = input_ids.shape
    merge = cfg.vision.spatial_merge_size
    tps = cfg.vision.tokens_per_second

    if image_grid_thw is None and video_grid_thw is None:
        if attention_mask is not None:
            pos = np.cumsum(attention_mask, axis=-1) - 1
            pos[attention_mask == 0] = 1
            position_ids = np.broadcast_to(pos[None], (3, B, S)).astype(np.int32)
            deltas = (position_ids.max(axis=0).max(axis=-1, keepdims=True) + 1 - S).astype(np.int32)
        else:
            pos = np.broadcast_to(np.arange(S)[None], (B, S))
            position_ids = np.broadcast_to(pos[None], (3, B, S)).astype(np.int32)
            deltas = np.zeros((B, 1), np.int32)
        return np.ascontiguousarray(position_ids), deltas

    position_ids = np.ones((3, B, S), dtype=np.int64)
    deltas = []
    image_index, video_index = 0, 0
    for i in range(B):
        ids = input_ids[i]
        if attention_mask is not None:
            ids = ids[attention_mask[i] == 1]
        tokens = ids.tolist()
        vision_starts = np.where(ids == cfg.vision_start_token_id)[0]
        next_tokens = ids[vision_starts + 1] if len(vision_starts) else np.array([], ids.dtype)
        image_nums = int((next_tokens == cfg.image_token_id).sum())
        video_nums = int((next_tokens == cfg.video_token_id).sum())
        spans: list[np.ndarray] = []
        st = 0
        remain_images, remain_videos = image_nums, video_nums
        for _ in range(image_nums + video_nums):
            ed_image = tokens.index(cfg.image_token_id, st) if (cfg.image_token_id in tokens[st:] and remain_images > 0) else len(tokens) + 1
            ed_video = tokens.index(cfg.video_token_id, st) if (cfg.video_token_id in tokens[st:] and remain_videos > 0) else len(tokens) + 1
            if ed_image < ed_video:
                t, h, w = (int(x) for x in image_grid_thw[image_index])
                second_per_grid_t = 0.0
                image_index += 1
                remain_images -= 1
                ed = ed_image
            else:
                t, h, w = (int(x) for x in video_grid_thw[video_index])
                if second_per_grid_ts is not None:
                    second_per_grid_t = float(second_per_grid_ts[video_index])
                else:
                    second_per_grid_t = 1.0
                video_index += 1
                remain_videos -= 1
                ed = ed_video
            lt, lh, lw = t, h // merge, w // merge
            text_len = ed - st
            st_idx = int(spans[-1].max()) + 1 if spans else 0
            spans.append(np.broadcast_to(np.arange(text_len)[None], (3, text_len)) + st_idx)
            t_index = (
                (np.arange(lt)[:, None] * second_per_grid_t * tps).astype(np.int64)
                .repeat(lh * lw, axis=1)
                .reshape(lt, lh * lw)
                .flatten()
            )
            h_index = np.broadcast_to(np.arange(lh)[None, :, None], (lt, lh, lw)).flatten()
            w_index = np.broadcast_to(np.arange(lw)[None, None, :], (lt, lh, lw)).flatten()
            spans.append(np.stack([t_index, h_index, w_index]) + text_len + st_idx)
            st = ed + lt * lh * lw
        if st < len(tokens):
            st_idx = int(spans[-1].max()) + 1 if spans else 0
            text_len = len(tokens) - st
            spans.append(np.broadcast_to(np.arange(text_len)[None], (3, text_len)) + st_idx)
        llm_positions = np.concatenate(spans, axis=1).reshape(3, -1)
        if attention_mask is not None:
            position_ids[:, i, attention_mask[i] == 1] = llm_positions
        else:
            position_ids[:, i, :] = llm_positions
        deltas.append(int(llm_positions.max()) + 1 - len(input_ids[i]))
    return position_ids.astype(np.int32), np.array(deltas, np.int32)[:, None]
