"""Rollout post-processing: engine outputs → the split-batch GRPO loss batch.

Port of `build_grpo_split_batch` and its helpers from
`time_r1_tpu/rl/rollout.py` (`:193-280`). The arrays are built on the host
with numpy, exactly as the JAX package builds them, and handed to the
trainer's device as tensors. The full-row `GRPOBatch` builder is not ported
(ROADMAP A7): the default loss is the split batch.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..models.qwen25vl import Qwen25VLConfig, VisionInputs, get_rope_index, prepare_vision_inputs
from .grpo import GRPOSplitBatch


def _bucket(n: int, minimum: int = 128) -> int:
    """Power-of-two bucket (≥128 keeps train-batch shapes flash-eligible)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _bucket256(n: int) -> int:
    """256-granular bucket (min 128) for the shared-prefix prompt rows: the
    prompt pays its padded length in the prompt forward and in every chunk's
    key pass, so the finer ladder is worth it."""
    if n <= 128:
        return 128
    return ((n + 255) // 256) * 256


def _pack_vision(cfg: Qwen25VLConfig, grids: list, patch_list: list, dtype, device) -> VisionInputs:
    """Vision inputs for a batch of unique videos (group-major feature order),
    patch rows bucketed to a merge-unit multiple: the same padded layout the
    engine's `_pack` builds, so the engine's captured hidden states fit it."""
    patches = torch.cat([torch.as_tensor(p).to(device, dtype) for p in patch_list], dim=0)
    unit = cfg.vision.merge_unit
    pad_patches = ((_bucket(patches.shape[0], 256) + unit - 1) // unit) * unit
    prep = prepare_vision_inputs(grids, cfg.vision, pad_patches_to=pad_patches)
    return VisionInputs.build(prep, patches)


def build_grpo_split_batch(
    cfg: Qwen25VLConfig,
    groups: Sequence[dict],
    dtype=torch.bfloat16,
    device="cuda",
) -> GRPOSplitBatch:
    """Shared-prefix train batch: prompts (P, Lp) and completions (B, Lc)
    split, so the loss runs each prompt once and only the completion chunk per
    rollout row. Each group dict carries prompt_ids, completions (G lists),
    advantages (G,), and optional patches / grid_thw / second_per_grid_t for
    its video; G must be the same for every group.

    Completion positions continue the prompt's M-RoPE: completions are plain
    text, so all three axes advance by 1 per token from (max valid prompt
    position + 1), which is what get_rope_index gives on the concatenated row."""
    device = torch.device(device)
    P_groups = len(groups)
    if P_groups < 1:
        raise ValueError("build_grpo_split_batch needs at least one group")
    G = len(groups[0]["completions"])
    if any(len(g["completions"]) != G for g in groups):
        raise ValueError("every group needs the same number of completions")
    Lp = _bucket256(max(len(g["prompt_ids"]) for g in groups))
    Lc = _bucket(max(max((len(c) for c in g["completions"]), default=1) for g in groups))

    ids_p = np.full((P_groups, Lp), cfg.pad_token_id, np.int64)
    mask_p = np.zeros((P_groups, Lp), np.int64)
    grids, spgs, patch_list, feat_starts = [], [], [], []
    feat_cursor = 0
    comp_rows, comp_mask_rows, advs = [], [], []
    for gi, g in enumerate(groups):
        pids = list(g["prompt_ids"])
        ids_p[gi, Lp - len(pids):] = pids  # left pad: last real token at Lp-1
        mask_p[gi, Lp - len(pids):] = 1
        if g.get("grid_thw") is not None:
            grid = tuple(int(x) for x in g["grid_thw"])
            grids.append(grid)
            spgs.append(float(g.get("second_per_grid_t", 1.0)))
            patch_list.append(g["patches"])
            feat_starts.append(feat_cursor)
            feat_cursor += (grid[0] * grid[1] * grid[2]) // cfg.vision.merge_unit
        else:
            feat_starts.append(0)  # text-only group: unused by the merge
        for comp in g["completions"]:
            row = np.full((Lc,), cfg.pad_token_id, np.int64)
            cmask = np.zeros((Lc,), np.int64)
            L = len(comp)
            row[:L] = comp  # right pad: causal masking keeps pads invisible
            eos_pos = next((i for i, t in enumerate(comp) if t == cfg.eos_token_id), None)
            cmask[: L if eos_pos is None else eos_pos + 1] = 1  # up to and including the first EOS
            comp_rows.append(row)
            comp_mask_rows.append(cmask)
        advs.append(np.asarray(g["advantages"], np.float32))

    pos_p, _ = get_rope_index(
        cfg,
        ids_p,
        video_grid_thw=np.array(grids, np.int64) if grids else None,
        second_per_grid_ts=spgs if spgs else None,
        attention_mask=mask_p,
    )
    pos_p = np.asarray(pos_p)
    starts = np.array([pos_p[:, gi, mask_p[gi] == 1].max() + 1 for gi in range(P_groups)], np.int64)
    B = P_groups * G
    comp_pos = np.broadcast_to(
        np.repeat(starts, G)[None, :, None] + np.arange(Lc)[None, None, :], (3, B, Lc)
    ).astype(np.int64)

    vis, feat_offsets = None, None
    if patch_list:
        vis = _pack_vision(cfg, grids, patch_list, dtype, device)
        feat_offsets = torch.tensor(feat_starts, dtype=torch.long, device=device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return GRPOSplitBatch(
        prompt_ids=t(ids_p),
        prompt_pos=t(pos_p),
        prompt_mask=t(mask_p),
        comp_ids=t(np.stack(comp_rows)),
        comp_pos=t(comp_pos),
        comp_mask=t(np.stack(comp_mask_rows)),
        advantages=t(np.concatenate(advs)).float(),
        vision=vis,
        ref_logps=None,
        feat_offsets=feat_offsets,
    )
