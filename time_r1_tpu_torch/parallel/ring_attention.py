"""Ring attention: context-parallel flash attention over a process group (port
of `time_r1_tpu/parallel/ring_attention.py`).

The sequence is split over the ranks of a group; an n-step ring passes the kv
shard (k, v and the key bias) one rank on per step (`comm.ring_shift`, JAX's
`lax.ppermute`) while every rank runs K1 (`ops/flash_attention.py::
flash_attention_fwd`, which returns the lse) on its own q block against the kv
block it holds, and merges the partials by the log-sum-exp rule (`_merge`, in
f32, with JAX's finite NEG_INF sentinel, so an empty/empty merge gives no NaN).

Causality maps onto blocks: for q shard r holding the kv block of source shard
s, s < r is fully visible (K1 non-causal), s == r the diagonal (K1 causal),
s > r fully masked: skipped, launching nothing (the merge with the empty
partial, which JAX's `lax.switch` also makes, stays: it is what leaves fully
masked rows as JAX leaves them). The backward is FA-2's with the GLOBAL lse and
delta: B1 (`flash_bwd_dq`) accumulates dq on the q owner, B2 (`flash_bwd_dkv`)
adds into dk/dv accumulators that travel with their kv block and arrive back at
its owner after n hops.

Per rank and call, K1 runs r + 1 times (contiguous, causal; n non-causal), and
B1 and B2 the same counts in the backward. The zig-zag layout
(`zigzag_indices`: rank r holds chunks r and 2n-1-r of 2n) runs three
half-block pairs a step and gives every rank 2n + 1 K1 launches (and as many
B1 and B2 launches).

The ring's backward communicates inside `backward()`: the ranks are
processes (the autograd engine runs one worker thread per CUDA device, so
ranks as threads of one process would block each other there).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.attention import NEG_INF
from ..ops.flash_attention import flash_attention_fwd, flash_bwd_dkv, flash_bwd_dq
from .comm import all_gather_vector, ring_shift

SKIP, FULL, DIAG = 0, 1, 2
BLOCK = 128  # the flash block: local shards (zig-zag: half-chunks) are multiples of it


def _merge(out, lse, o_i, lse_i):
    """Merge two normalized flash partials (out (B, S, H, D) f32, lse (B, H,
    S) f32) by the stable log-sum-exp rule; o_i None is the empty partial
    (zeros). NEG_INF is finite, so max(w) == 1 and the denominator is ≥ 1."""
    m = torch.maximum(lse, lse_i)
    wa = torch.exp(lse - m)
    wb = torch.exp(lse_i - m)
    denom = wa + wb
    out = out * (wa / denom).permute(0, 2, 1)[..., None]
    if o_i is not None:
        out = out + o_i.float() * (wb / denom).permute(0, 2, 1)[..., None]
    return out, m + torch.log(denom)


def _case(src: int, r: int) -> int:
    """The block case of q shard r against the kv of source shard src."""
    return FULL if src < r else DIAG if src == r else SKIP


def _fwd_step(out, lse, q, k, v, b, case, scale):
    if case == SKIP:
        return _merge(out, lse, None, torch.full_like(lse, NEG_INF))
    o_i, l_i = flash_attention_fwd(q, k, v, b, case == DIAG, scale, 0)
    return _merge(out, lse, o_i, l_i)


def _bwd_step(dq, dk, dv, q, k, v, b, g, lse, delta, case, scale):
    """Adds block (q, k) case's B1 dq into dq and B2 dk/dv into dk/dv (f32,
    in place); a skipped block launches nothing."""
    if case == SKIP:
        return
    dq += flash_bwd_dq(q, k, v, b, g, lse, delta, case == DIAG, scale, 0).float()
    dk_i, dv_i = flash_bwd_dkv(q, k, v, b, g, lse, delta, case == DIAG, scale, 0)
    dk += dk_i
    dv += dv_i


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def _ring_fwd(q, k, v, kv_bias, group, causal, scale):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    B, S, H, D = q.shape
    out = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    kv = [k, v, kv_bias]
    for i in range(n):
        case = _case((r - i) % n, r) if causal else FULL
        out, lse = _fwd_step(out, lse, q, *kv, case, scale)
        if i < n - 1:
            kv = ring_shift(kv, group)
    return out.to(q.dtype), lse


def _ring_bwd(q, k, v, kv_bias, out, lse, g, group, causal, scale):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    # delta = rowsum(dO·O) is global: out and lse are the merged ones
    delta = (g.float() * out.float()).sum(-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    kv = [k, v, kv_bias]
    for i in range(n):
        case = _case((r - i) % n, r) if causal else FULL
        _bwd_step(dq, dk, dv, q, *kv, g, lse, delta, case, scale)
        # the accumulators ride all n hops back to their block's owner; k, v
        # and the bias have no use after the last step
        if i < n - 1:
            *kv, dk, dv = ring_shift([*kv, dk, dv], group)
        else:
            dk, dv = ring_shift([dk, dv], group)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_bias, group, causal, scale):
        q, k, v, kv_bias = (t.contiguous() for t in (q, k, v, kv_bias))
        out, lse = _ring_fwd(q, k, v, kv_bias, group, causal, scale)
        ctx.save_for_backward(q, k, v, kv_bias, out, lse)
        ctx.args = (group, causal, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_bias, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, kv_bias, out, lse, g.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None


def ring_flash_attention(
    q: torch.Tensor,  # (B, S_loc, H, D): this rank's sequence shard
    k: torch.Tensor,  # (B, S_loc, Hkv, D)
    v: torch.Tensor,
    kv_bias: torch.Tensor,  # (B, S_loc) f32 additive (0 / NEG_INF padding)
    group=None,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Context-parallel flash attention: rank r of `group` (None: the default
    group) holds global positions [r·S_loc, (r+1)·S_loc). GQA and the key bias
    work as in `flash_attention`; differentiable in q, k and v (B1/B2 on the
    card). S_loc is a multiple of the flash block on the card."""
    return _Ring.apply(q, k, v, kv_bias, group, causal, _scale(q, scale))


def zigzag_indices(seq_len: int, axis_size: int) -> np.ndarray:
    """The permutation into zig-zag rank-major order: rank r holds [chunk r |
    chunk 2n-1-r] of 2n equal chunks, so every rank does the same causal work.
    Apply with index_select on the sequence dim; invert with zigzag_inverse."""
    if seq_len % (2 * axis_size):
        raise ValueError(f"seq_len={seq_len} must divide into {2 * axis_size} chunks")
    c = seq_len // (2 * axis_size)
    parts = []
    for r in range(axis_size):
        parts.append(np.arange(r * c, (r + 1) * c))
        parts.append(np.arange((2 * axis_size - 1 - r) * c, (2 * axis_size - r) * c))
    return np.concatenate(parts)


def zigzag_inverse(seq_len: int, axis_size: int) -> np.ndarray:
    idx = zigzag_indices(seq_len, axis_size)
    inv = np.empty_like(idx)
    inv[idx] = np.arange(seq_len)
    return inv


def _halves(x: torch.Tensor) -> torch.Tensor:
    """(2, ...) with x's two sequence halves (dim 1), each contiguous."""
    return torch.stack(x.chunk(2, dim=1))


def _zz_cases(src: int, r: int) -> tuple[int, int]:
    """The cases of (front q, front kv) and (back q, back kv) when rank r holds
    the kv of source rank src; (back q, front kv) is always fully visible."""
    return _case(src, r), FULL if src > r else DIAG if src == r else SKIP


def _zz_fwd(q, k, v, kv_bias, group, scale):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    B, S2, H, D = q.shape
    C = S2 // 2
    qf, qb = _halves(q)
    kv = [_halves(k), _halves(v), _halves(kv_bias)]
    zero_out = torch.zeros((B, C, H, D), dtype=torch.float32, device=q.device)
    empty = torch.full((B, H, C), NEG_INF, dtype=torch.float32, device=q.device)
    (out_f, lse_f), (out_b, lse_b) = (zero_out, empty), (zero_out, empty)
    for i in range(n):
        ff, bb = _zz_cases((r - i) % n, r)
        kh, vh, bh = kv
        out_f, lse_f = _fwd_step(out_f, lse_f, qf, kh[0], vh[0], bh[0], ff, scale)
        out_b, lse_b = _fwd_step(out_b, lse_b, qb, kh[0], vh[0], bh[0], FULL, scale)
        out_b, lse_b = _fwd_step(out_b, lse_b, qb, kh[1], vh[1], bh[1], bb, scale)
        if i < n - 1:
            kv = ring_shift(kv, group)
    return torch.cat([out_f, out_b], dim=1).to(q.dtype), torch.cat([lse_f, lse_b], dim=2)


def _zz_bwd(q, k, v, kv_bias, out, lse, g, group, scale):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    C = q.shape[1] // 2
    delta = (g.float() * out.float()).sum(-1)  # (B, 2C, H)
    qf, qb = _halves(q)
    gf, gb = _halves(g)
    df, db = _halves(delta)
    lf, lb = lse[..., :C].contiguous(), lse[..., C:].contiguous()
    dq = torch.zeros((2, *qf.shape), dtype=torch.float32, device=q.device)
    dk = torch.zeros((2, k.shape[0], C, *k.shape[2:]), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    kv = [_halves(k), _halves(v), _halves(kv_bias)]
    for i in range(n):
        ff, bb = _zz_cases((r - i) % n, r)
        kh, vh, bh = kv
        _bwd_step(dq[0], dk[0], dv[0], qf, kh[0], vh[0], bh[0], gf, lf, df, ff, scale)
        _bwd_step(dq[1], dk[0], dv[0], qb, kh[0], vh[0], bh[0], gb, lb, db, FULL, scale)
        _bwd_step(dq[1], dk[1], dv[1], qb, kh[1], vh[1], bh[1], gb, lb, db, bb, scale)
        if i < n - 1:
            *kv, dk, dv = ring_shift([*kv, dk, dv], group)
        else:
            dk, dv = ring_shift([dk, dv], group)
    cat = lambda x: torch.cat([x[0], x[1]], dim=1)  # noqa: E731
    return cat(dq).to(q.dtype), cat(dk).to(k.dtype), cat(dv).to(v.dtype)


class _RingZigzag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_bias, group, scale):
        out, lse = _zz_fwd(q, k, v, kv_bias, group, scale)
        ctx.save_for_backward(q, k, v, kv_bias, out, lse)
        ctx.args = (group, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_bias, out, lse = ctx.saved_tensors
        dq, dk, dv = _zz_bwd(q, k, v, kv_bias, out, lse, g.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None


def ring_flash_attention_zigzag(
    q: torch.Tensor,  # (B, 2C, H, D): this rank's [chunk r | chunk 2n-1-r]
    k: torch.Tensor,  # (B, 2C, Hkv, D)
    v: torch.Tensor,
    kv_bias: torch.Tensor,  # (B, 2C)
    group=None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal ring attention over the zig-zag layout (`zigzag_indices`); inputs
    and output in the permuted layout. Per step at most three half-block
    pairs are live: front q × front kv (full, diagonal or skipped on the chunk
    order), back q × front kv (always visible) and back q × back kv (mirrored),
    2n + 1 visible half-blocks a rank over the n steps."""
    return _RingZigzag.apply(q, k, v, kv_bias, group, _scale(q, scale))


@dataclass(frozen=True)
class ContextParallel:
    """The context-parallel group of a decoder forward: its ranks split the
    sequence, contiguously or in the zig-zag layout (JAX's `cp=(axis_name, n)`
    or `(axis_name, n, "zigzag")`). `group` None is the default group."""

    group: object = None
    layout: str = "contiguous"

    def __post_init__(self):
        if self.layout not in ("contiguous", "zigzag"):
            raise ValueError(f"context_parallel_layout {self.layout!r}: contiguous or zigzag")

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def multiple(self) -> int:
        """What the global sequence length must divide by: every local shard
        (zig-zag: every half-chunk) a whole number of flash blocks."""
        return (2 if self.layout == "zigzag" else 1) * self.size * BLOCK

    def index(self, seq_len: int, device) -> torch.Tensor:
        """The global positions this rank holds, in its local order."""
        n, r = self.size, self.rank
        if self.layout == "zigzag":
            idx = zigzag_indices(seq_len, n)[r * (seq_len // n):(r + 1) * (seq_len // n)]
        else:
            if seq_len % n:
                raise ValueError(f"seq_len={seq_len} must divide into {n} shards")
            idx = np.arange(r * (seq_len // n), (r + 1) * (seq_len // n))
        return torch.from_numpy(idx).to(device)

    def shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's part of the global tensor x along dim (differentiable)."""
        return x.index_select(dim, self.index(x.shape[dim], x.device))

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The global tensor from every rank's part along dim, in global order.
        Its backward keeps this rank's part of the gradient: every rank must
        compute the same function of the result."""
        return _Gather.apply(x, self, dim)

    def attention(self, q, k, v, kv_bias) -> torch.Tensor:
        """Causal ring attention over the local shards."""
        if self.layout == "zigzag":
            return ring_flash_attention_zigzag(q, k, v, kv_bias, self.group)
        return ring_flash_attention(q, k, v, kv_bias, self.group, True)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cp, dim):
        parts = all_gather_vector(x, cp.group)  # (n, *x.shape), rank order
        full = torch.cat(list(parts.unbind(0)), dim=dim)
        S = full.shape[dim]
        if cp.layout == "zigzag":
            full = full.index_select(dim, torch.from_numpy(zigzag_inverse(S, cp.size)).to(x.device))
        ctx.cp, ctx.dim = cp, dim
        return full

    @staticmethod
    def backward(ctx, g):
        return ctx.cp.shard(g, ctx.dim), None, None


def _check_len(S: int, cp: ContextParallel) -> None:
    if S % cp.multiple:
        raise ValueError(f"the {cp.layout} layout over {cp.size} ranks needs S % {cp.multiple} == 0 (S={S}): "
                         "pad the sequence and mask the pads")


def ring_attention_sharded(q, k, v, kv_bias, group=None, causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Global q, k, v (B, S, ·, D) and kv_bias (B, S) on every rank: keep this
    rank's contiguous shard, run the ring, all-gather the output (B, S, H, D).
    S divides by the group size; on the card the shards are flash-block
    multiples. The gradient of the global inputs holds this rank's part:
    summed over the ranks it is the whole."""
    cp = ContextParallel(group)
    q, k, v, kv_bias = (cp.shard(t, 1) for t in (q, k, v, kv_bias))
    return cp.gather(ring_flash_attention(q, k, v, kv_bias, group, causal, scale), 1)


def ring_attention_zigzag_sharded(q, k, v, kv_bias, group=None, scale: Optional[float] = None) -> torch.Tensor:
    """Causal ring attention with the zig-zag layout on global tensors in the
    original order: permute and shard in, ring, gather and permute out. S
    divides by 2 × group size × flash block."""
    cp = ContextParallel(group, "zigzag")
    _check_len(q.shape[1], cp)
    q, k, v, kv_bias = (cp.shard(t, 1) for t in (q, k, v, kv_bias))
    return cp.gather(ring_flash_attention_zigzag(q, k, v, kv_bias, group, scale), 1)


def sequence_parallel_decoder(
    params: dict,
    cfg,
    hidden: torch.Tensor,  # (B, S, hid) global: embeddings with the vision merged
    position_ids: torch.Tensor,  # (3, B, S)
    attention_mask: Optional[torch.Tensor],  # (B, S) 1/0
    group=None,
    remat=False,
    layout: str = "contiguous",
) -> torch.Tensor:
    """The decoder stack with the sequence split over `group`: per-position
    work (norms, projections, MLPs) runs on the rank's shard, attention rides
    the ring, so activations are O(S/n) a rank. Returns the final hidden
    states (B, S, hid), gathered. The parameter gradients of each rank cover
    its own tokens: summed over the ranks (`comm.all_reduce_sum`) they are the
    whole, as JAX's psum on the way out of shard_map.

    S divides by group size × 128 (contiguous) or 2 × group size × 128
    (zigzag): pad tokens and mask them with attention_mask."""
    from ..models.qwen25vl.language import decoder_forward  # the models import this package

    cp = ContextParallel(group, layout)
    B, S, _ = hidden.shape
    _check_len(S, cp)
    if attention_mask is None:
        attention_mask = torch.ones((B, S), dtype=torch.long, device=hidden.device)
    idx = cp.index(S, hidden.device)
    out, _ = decoder_forward(params, cfg, hidden.index_select(1, idx), position_ids.index_select(2, idx),
                             attention_mask.index_select(1, idx), remat=remat, cp=cp)
    return cp.gather(out, 1)
