"""Rollout post-processing: engine outputs → the GRPO loss batches.

Port of `time_r1_tpu/rl/rollout.py`: `build_grpo_split_batch` (the shared-
prefix layout, the trainer's default) and `build_grpo_batch` /
`build_grpo_batch_groups` (full rows, `shared_prefix_loss=False`). The
arrays are built on the host with numpy, exactly as the JAX package builds
them, and handed to the trainer's device as tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..models.qwen25vl import Qwen25VLConfig, VisionInputs, get_rope_index, prepare_vision_inputs
from .grpo import GRPOBatch, GRPOSplitBatch


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


def _on(device: torch.device, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def build_grpo_batch(
    cfg: Qwen25VLConfig,
    prompt_ids: Sequence[int],
    completions: Sequence[Sequence[int]],
    advantages: np.ndarray,
    patches=None,
    grid_thw: Optional[tuple] = None,
    second_per_grid_t: float = 1.0,
    pad_to: Optional[int] = None,
    dtype=torch.bfloat16,
    device="cuda",
) -> GRPOBatch:
    """The (G, T) full-row batch of one prompt's rollout group: G completion
    token lists, their advantages (G,), and the prompt's video (patches,
    grid_thw, second_per_grid_t) if it has one."""
    group = {"prompt_ids": prompt_ids, "completions": completions, "advantages": advantages, "patches": patches,
             "grid_thw": grid_thw, "second_per_grid_t": second_per_grid_t}
    return build_grpo_batch_groups(cfg, [group], pad_to=pad_to, dtype=dtype, device=device)


def build_grpo_batch_groups(
    cfg: Qwen25VLConfig,
    groups: Sequence[dict],
    pad_to: Optional[int] = None,
    dtype=torch.bfloat16,
    pad_multiple: Optional[int] = None,
    device="cuda",
) -> GRPOBatch:
    """Full-row batch of P prompt groups × G rollouts → (P·G, T) rows,
    group-major. Each group dict carries prompt_ids, completions (G lists),
    advantages (G,), and optional patches / grid_thw / second_per_grid_t.

    T is `pad_to`, or the power-of-two bucket of the longest prompt plus its
    group's longest completion, rounded up to `pad_multiple`. Each group's
    prompts are left-padded so that they end where the group's completions
    begin; the completion mask covers each completion up to and including
    its first EOS. Every row gets a feature offset (its video's first
    feature row; 0 for a text-only row), so a batch that mixes video and
    text-only groups keeps `feat_offsets` row-aligned, and each video enters
    the batch once."""
    device = torch.device(device)
    if len(groups) < 1:
        raise ValueError("build_grpo_batch_groups needs at least one group")
    need = max(len(g["prompt_ids"]) + max((len(c) for c in g["completions"]), default=1) for g in groups)
    T = pad_to or _bucket(need)
    if pad_multiple:
        T = -(-T // pad_multiple) * pad_multiple
    if T < need:
        raise ValueError(f"pad_to={T} is shorter than the longest row ({need} tokens)")

    rows_ids, rows_attn, rows_comp, rows_adv = [], [], [], []
    row_grids, row_spgs, row_feat_starts = [], [], []  # per row: the rope takes one grid a row
    vis_grids, patch_list = [], []  # per group: each video once
    feat_cursor = 0
    for g in groups:
        prompt_ids = list(g["prompt_ids"])
        P = len(prompt_ids)
        completions = g["completions"]
        lead = T - (P + max((len(c) for c in completions), default=1))
        has_video = g.get("grid_thw") is not None
        group_start = 0
        if has_video:
            grid = tuple(int(x) for x in g["grid_thw"])
            vis_grids.append(grid)
            patch_list.append(g["patches"])
            group_start = feat_cursor
            feat_cursor += (grid[0] * grid[1] * grid[2]) // cfg.vision.merge_unit
        for comp in completions:
            ids = np.full((T,), cfg.pad_token_id, np.int64)
            attn = np.zeros((T,), np.int64)
            comp_mask = np.zeros((T,), np.int64)
            ids[lead:lead + P] = prompt_ids
            attn[lead:lead + P] = 1
            L = len(comp)
            ids[lead + P:lead + P + L] = comp
            eos_pos = next((i for i, t in enumerate(comp) if t == cfg.eos_token_id), None)
            comp_mask[lead + P:lead + P + (L if eos_pos is None else eos_pos + 1)] = 1
            attn[lead + P:lead + P + L] = 1
            rows_ids.append(ids)
            rows_attn.append(attn)
            rows_comp.append(comp_mask)
            if has_video:
                row_grids.append(grid)
                row_spgs.append(float(g.get("second_per_grid_t", 1.0)))
            row_feat_starts.append(group_start)
        rows_adv.append(np.asarray(g["advantages"], np.float32))

    ids = np.stack(rows_ids)
    attn = np.stack(rows_attn)
    pos_ids, _ = get_rope_index(
        cfg,
        ids,
        video_grid_thw=np.array(row_grids, np.int64) if row_grids else None,
        second_per_grid_ts=row_spgs if row_spgs else None,
        attention_mask=attn,
    )
    vis, feat_offsets = None, None
    if patch_list:
        vis = _pack_vision(cfg, vis_grids, patch_list, dtype, device)
        feat_offsets = torch.tensor(row_feat_starts, dtype=torch.long, device=device)
    return GRPOBatch(
        input_ids=_on(device, ids),
        position_ids=_on(device, np.asarray(pos_ids)),
        attention_mask=_on(device, attn),
        completion_mask=_on(device, np.stack(rows_comp)),
        advantages=_on(device, np.concatenate(rows_adv)).float(),
        vision=vis,
        ref_logps=None,
        feat_offsets=feat_offsets,
    )


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

    return GRPOSplitBatch(
        prompt_ids=_on(device, ids_p),
        prompt_pos=_on(device, pos_p),
        prompt_mask=_on(device, mask_p),
        comp_ids=_on(device, np.stack(comp_rows)),
        comp_pos=_on(device, comp_pos),
        comp_mask=_on(device, np.stack(comp_mask_rows)),
        advantages=_on(device, np.concatenate(advs)).float(),
        vision=vis,
        ref_logps=None,
        feat_offsets=feat_offsets,
    )
