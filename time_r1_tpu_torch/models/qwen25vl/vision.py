"""Qwen2.5-VL vision tower in PyTorch (window attention + 2x2 patch merger).

Port of `time_r1_tpu/models/qwen25vl/vision.py`. The host plan
(`prepare_vision_inputs`, numpy) is a copy: every attention window is padded
to the fixed `window_patches²·merge_unit` rows, so window attention is a
reshape to (n_windows, win, ...) with a key-validity bias, and the
full-attention blocks attend within each (sample, t)-slice, gathered to
(n_slices, max_slice, ...) and scattered back by an inverse permutation.

The blocks run as a Python loop. With `use_window_kernel` (the frozen tower:
serving, the rollout, `precompute_frozen_vision`, the reference forward) the
attention of the window layers goes through K2 and that of the full layers
through K3 (ops/vision_attention.py), whose wrappers launch the kernels for
CUDA tensors and run their plain versions for CPU tensors. K2/K3 have no
backward, so a tower that is differentiated (the GRPO loss with fix_vit off)
runs without them, as JAX's jnp branch does: rope rounded to the input dtype,
then a differentiable attention over the windows and the slices. Dead
(padding) slots flow through as garbage but are never attention keys and are
dropped by the final original-order gather.

Sharded (`shard=`, a `parallel/sharding.py::ShardContext` over the visual
params): the patch embed is gathered whole on every rank; each block and the
merger gather their FSDP shards over "data" and run the rank's heads
(num_heads/tp, through K2/K3 when frozen) and MLP width, with Megatron's
identity/all-reduce pair around the column-parallel (qkv, gate/up, fc1) and
row-parallel (proj, down, fc2) products; a row-parallel product's bias is
added once, after the all-reduce. The fused qkv is split per head
(`parallel/sharding.py`), so the rank's rows are its q | k | v. An MLP
width the model dim does not split (the 3B's 3420 at tp 8) is whole on every
rank and runs whole there, with neither of the pair.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.attention import NEG_INF, rope
from ...ops.vision_attention import full_attention_rope, window_attention_rope
from ...parallel.tensor import splits
from .config import VisionConfig
from .language import _rms_norm


@dataclass(frozen=True)
class VisionPrep:
    """Host-precomputed static-shape plan for one batch of videos/images.

    Layout arrays are in PADDED-WINDOW order (the order blocks run in):
    consecutive `win_patches` entries form one attention window; windows of a
    (sample, t)-slice are consecutive.
    """

    perm: np.ndarray  # (P_pad,) gather index into the caller's patch rows
    pos_hw: np.ndarray  # (P_pad, 2) rope h/w ids (0 at dead slots)
    key_valid: np.ndarray  # (P_pad,) bool — real patch?
    full_gather: np.ndarray  # (n_slices, max_slice) index into P_pad layout
    full_inverse: np.ndarray  # (P_pad,) index into flattened (n_slices·max_slice)
    reverse: np.ndarray  # (U_pad,) layout-unit index of each ORIGINAL unit
    unit_valid: np.ndarray  # (U_pad,) bool
    n_patches: int  # real patches
    n_units: int  # real merge units


def prepare_vision_inputs(
    grid_thw: list[tuple[int, int, int]],
    cfg: VisionConfig,
    pad_patches_to: int | None = None,  # pad the OUTPUT unit list (see below)
) -> VisionPrep:
    """Build the padded-window layout + slice blocks for (t, h, w) patch grids.

    Window/full segmentation semantics match HF `get_window_index` +
    per-t-slice cu_seqlens: ragged edge windows are padded (not merged), and
    full attention never crosses (sample, t)-slice boundaries.

    `pad_patches_to` pads the ORIGINAL-ORDER output units (U_pad =
    pad_patches_to / merge_unit) so downstream token counts can be bucketed;
    the internal layout is always padded to whole windows regardless.
    """
    m = cfg.spatial_merge_size
    unit = cfg.merge_unit
    wm = cfg.window_patches
    win_units = wm * wm
    win_patches = win_units * unit

    layout_unit_src: list[np.ndarray] = []  # per-layout-unit: original unit idx or -1
    slice_sizes: list[int] = []  # padded patches per (sample, t)-slice
    pos_orig_list = []
    unit_base = 0

    for t, h, w in grid_thw:
        lh, lw = h // m, w // m
        # rope ids in original patch order (merge-unit grouped, HF rot_pos_emb)
        hh = np.arange(h, dtype=np.int32).reshape(lh, m, 1, 1)
        hh = np.broadcast_to(hh, (lh, m, lw, m)).transpose(0, 2, 1, 3).reshape(-1)
        ww = np.arange(w, dtype=np.int32).reshape(1, 1, lw, m)
        ww = np.broadcast_to(ww, (lh, m, lw, m)).transpose(0, 2, 1, 3).reshape(-1)
        pos = np.stack([hh, ww], axis=-1)
        pos_orig_list.append(np.tile(pos, (t, 1)))

        idx = np.arange(t * lh * lw, dtype=np.int64).reshape(t, lh, lw) + unit_base
        pad_h = (-lh) % wm
        pad_w = (-lw) % wm
        idxp = np.pad(idx, ((0, 0), (0, pad_h), (0, pad_w)), constant_values=-1)
        nwh, nww = (lh + pad_h) // wm, (lw + pad_w) // wm
        idxp = idxp.reshape(t, nwh, wm, nww, wm).transpose(0, 1, 3, 2, 4).reshape(-1)
        layout_unit_src.append(idxp)
        slice_sizes.extend([nwh * nww * win_patches] * t)
        unit_base += t * lh * lw

    layout_units = np.concatenate(layout_unit_src)  # (-1 for dead units)
    n_units = unit_base
    n_patches = n_units * unit
    pos_orig = np.concatenate(pos_orig_list, axis=0)

    P_pad = layout_units.shape[0] * unit
    # patch-granularity gather into the caller's (n_patches-row) buffer
    slot = np.arange(unit, dtype=np.int64)[None, :]
    perm = np.where(
        layout_units[:, None] >= 0, layout_units[:, None] * unit + slot, 0
    ).reshape(-1)
    key_valid = np.repeat(layout_units >= 0, unit)
    pos_hw = np.where(key_valid[:, None], pos_orig[np.clip(perm, 0, max(n_patches - 1, 0))], 0)

    # (sample, t)-slice blocks: contiguous runs of `slice_sizes` patches
    max_slice = max(slice_sizes)
    n_slices = len(slice_sizes)
    full_gather = np.zeros((n_slices, max_slice), np.int64)
    full_inverse = np.zeros((P_pad,), np.int64)
    off = 0
    for si, sz in enumerate(slice_sizes):
        full_gather[si, :sz] = np.arange(off, off + sz)
        full_gather[si, sz:] = -1  # pad sentinel; masked as keys in the bias
        full_inverse[off : off + sz] = si * max_slice + np.arange(sz)
        off += sz
    assert off == P_pad

    # original-order unit positions in the layout
    layout_pos = np.zeros((n_units,), np.int64)
    real = layout_units >= 0
    layout_pos[layout_units[real]] = np.nonzero(real)[0]

    u_pad = (pad_patches_to // unit) if pad_patches_to else n_units
    if u_pad < n_units:
        raise ValueError(f"pad_patches_to leaves {u_pad} units for {n_units}")
    reverse = np.zeros((u_pad,), np.int64)
    reverse[:n_units] = layout_pos
    unit_valid = np.arange(u_pad) < n_units

    return VisionPrep(
        perm=perm.astype(np.int32),
        pos_hw=pos_hw.astype(np.int32),
        key_valid=key_valid,
        full_gather=full_gather.astype(np.int32),
        full_inverse=full_inverse.astype(np.int32),
        reverse=reverse.astype(np.int32),
        unit_valid=unit_valid,
        n_patches=n_patches,
        n_units=n_units,
    )


def vision_rope_tables(cfg: VisionConfig, pos_hw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin (P, head_dim) f32 of the 2D rope over (h, w) grid ids:
    head_dim // 4 frequencies per axis."""
    quarter = cfg.head_dim // 4
    inv_freq = 1.0 / (10000.0 ** (torch.arange(0, quarter, dtype=torch.float32, device=pos_hw.device) / quarter))
    fh = pos_hw[:, 0:1].float() * inv_freq
    fw = pos_hw[:, 1:2].float() * inv_freq
    rot = torch.cat([fh, fw], dim=-1)
    emb = torch.cat([rot, rot], dim=-1)
    return emb.cos(), emb.sin()


def _block_attention(q, k, v, key_bias, scale: float) -> torch.Tensor:
    """JAX's `_block_attention`: attention within (n, S, nh, hd) blocks of
    roped q/k, with an additive key bias (n, S); f32 logits and softmax, the
    probabilities rounded to v's dtype before the product. Differentiable."""
    logits = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) * scale + key_bias.float()[:, None, None, :]
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("nhqk,nkhd->nqhd", probs.to(v.dtype), v)


def vision_blocks_forward(
    params: dict,
    cfg: VisionConfig,
    patches: torch.Tensor,  # (n_patch_rows, patch_input_dim)
    prep_perm: torch.Tensor,
    prep_pos_hw: torch.Tensor,
    prep_key_valid: torch.Tensor,
    prep_full_gather: torch.Tensor,
    prep_full_inverse: torch.Tensor,
    use_window_kernel: bool = False,
    shard=None,
    lora=None,
) -> torch.Tensor:
    """Patch embed + the ViT blocks, in window-layout order; returns the
    pre-merger hidden states (P_pad, hidden_size). use_window_kernel routes
    the attention through K2/K3, which have no backward (a frozen tower);
    without it the blocks are differentiable, as JAX's jnp branch. shard: a
    ShardContext over the visual params (see the module). lora=(per-block
    adapters, scaling): merged into each block after its gather, as the
    decoder's layers merge theirs (`language._layer_adapters`)."""
    nh, hd = cfg.num_heads // (1 if shard is None else shard.tp), cfg.head_dim
    eps = cfg.rms_norm_eps
    win_patches = cfg.window_patches * cfg.window_patches * cfg.merge_unit

    perm = prep_perm.long().clamp(0, patches.shape[0] - 1)
    w_embed = params["patch_embed"] if shard is None else shard.whole(params["patch_embed"], "patch_embed")
    x = F.linear(patches.index_select(0, perm).to(w_embed.dtype), w_embed)

    cos, sin = vision_rope_tables(cfg, prep_pos_hw)  # (P, hd)
    key_bias = torch.where(prep_key_valid, 0.0, NEG_INF).float()
    n_slices, max_slice = prep_full_gather.shape
    # pad entries are -1 sentinels: clamp for the gather, mask as keys
    full_pad = prep_full_gather < 0
    fg = torch.where(full_pad, 0, prep_full_gather).long().reshape(-1)
    full_bias = (key_bias.index_select(0, fg).reshape(n_slices, max_slice)
                 + torch.where(full_pad, NEG_INF, 0.0).float())
    cos_full = cos.index_select(0, fg).reshape(n_slices, max_slice, hd)
    sin_full = sin.index_select(0, fg).reshape(n_slices, max_slice, hd)
    inverse = prep_full_inverse.long()
    fullatt = set(cfg.fullatt_block_indexes)

    def slices(t: torch.Tensor) -> torch.Tensor:  # layout rows → (n_slices, max_slice, nh, hd)
        return t.index_select(0, fg).reshape(n_slices, max_slice, nh, hd)

    def windows(t: torch.Tensor) -> torch.Tensor:  # layout rows → (n_windows, win_patches, ...)
        return t.reshape(-1, win_patches, *t.shape[1:])

    def roped(t: torch.Tensor) -> torch.Tensor:  # JAX's rope(): f32, rounded to the input dtype
        return rope(t, cos[:, None, :], sin[:, None, :]).to(t.dtype)

    def enter(t):
        return t if shard is None else shard.enter(t)

    def row_parallel(t, w, b):  # a row-parallel product: its bias once, after the all-reduce
        return F.linear(t, w, b) if shard is None else shard.exit(F.linear(t, w)) + b

    # an MLP width the model dim does not split (3420 at tp 8) stays whole on every rank (`_divisible`): it
    # runs whole there, outside Megatron's pair, so that nothing sums it tp times
    mlp_split = shard is not None and splits(cfg.intermediate_size, shard.tp)

    for i, bp in enumerate(params["blocks"]):
        if shard is not None:
            bp = shard.layer(bp, i, "blocks")
        if lora is not None:
            bp = _block_adapters(bp, lora, i, shard)
        h = enter(_rms_norm(x, bp["norm1"], eps))
        q, k, v = (
            t.reshape(-1, nh, hd).contiguous()
            for t in F.linear(h, bp["qkv_w"], bp["qkv_b"]).chunk(3, dim=-1)
        )
        if use_window_kernel and i in fullatt:
            out = full_attention_rope(slices(q), slices(k), slices(v), cos_full, sin_full, full_bias)
            attn = out.reshape(-1, nh, hd).index_select(0, inverse)
        elif use_window_kernel:
            attn = window_attention_rope(q, k, v, cos, sin, key_bias, win_patches)
        elif i in fullatt:
            out = _block_attention(slices(roped(q)), slices(roped(k)), slices(v), full_bias, hd**-0.5)
            attn = out.reshape(-1, nh, hd).index_select(0, inverse)
        else:
            out = _block_attention(windows(roped(q)), windows(roped(k)), windows(v), windows(key_bias), hd**-0.5)
            attn = out.reshape(-1, nh, hd)
        x = x + row_parallel(attn.reshape(-1, nh * hd), bp["proj_w"], bp["proj_b"])
        h = _rms_norm(x, bp["norm2"], eps)
        h = enter(h) if mlp_split else h
        g = F.linear(h, bp["gate_w"], bp["gate_b"])
        u = F.linear(h, bp["up_w"], bp["up_b"])
        act = F.silu(g) * u
        x = x + (row_parallel(act, bp["down_w"], bp["down_b"]) if mlp_split
                 else F.linear(act, bp["down_w"], bp["down_b"]))
    return x


def _block_adapters(bp: dict, lora: tuple, i: int, shard) -> dict:
    """Block i's params with its adapters merged; under a shard context the
    whole adapters cut to the block's model-local leaves first (the fused
    qkv's per head, as its leaf, `ShardContext.lora_local`)."""
    from ...rl.lora import apply_layer_lora  # rl imports the models: a lazy import, as in JAX

    adapters = lora[0][i] if shard is None else shard.lora_local(lora[0][i], shard.specs["blocks"][i])
    return apply_layer_lora(bp, adapters, lora[1])


def vision_merge_forward(params: dict, cfg: VisionConfig, x: torch.Tensor, prep_reverse: torch.Tensor,
                         shard=None) -> torch.Tensor:
    """Merger: RMSNorm → group 2x2 units → MLP (exact GELU) → gather back to
    original merge-unit order. shard: a ShardContext over the visual params
    (fc1 column-parallel, fc2 row-parallel)."""
    mp = params["merger"] if shard is None else shard.layer(params["merger"], key="merger")
    h = _rms_norm(x, mp["ln_q"], cfg.rms_norm_eps).reshape(-1, cfg.hidden_size * cfg.merge_unit)
    if shard is None:
        h = F.gelu(F.linear(h, mp["fc1_w"], mp["fc1_b"]))
        h = F.linear(h, mp["fc2_w"], mp["fc2_b"])
    else:
        h = F.gelu(F.linear(shard.enter(h), mp["fc1_w"], mp["fc1_b"]))
        h = shard.exit(F.linear(h, mp["fc2_w"])) + mp["fc2_b"]
    return h.index_select(0, prep_reverse.long())


def vision_forward(
    params: dict,
    cfg: VisionConfig,
    patches: torch.Tensor,
    prep_perm: torch.Tensor,
    prep_pos_hw: torch.Tensor,
    prep_key_valid: torch.Tensor,
    prep_full_gather: torch.Tensor,
    prep_full_inverse: torch.Tensor,
    prep_reverse: torch.Tensor,
    use_window_kernel: bool = False,
    shard=None,
    lora=None,
) -> torch.Tensor:
    """The vision tower; returns merged features (U_pad, out_hidden_size) in
    original merge-unit order. use_window_kernel, shard, lora: see
    `vision_blocks_forward` (the merger has no adapters: `rl/lora.py`
    adapts the blocks' weights)."""
    x = vision_blocks_forward(
        params, cfg, patches, prep_perm, prep_pos_hw, prep_key_valid,
        prep_full_gather, prep_full_inverse, use_window_kernel=use_window_kernel, shard=shard, lora=lora,
    )
    return vision_merge_forward(params, cfg, x, prep_reverse, shard=shard)
