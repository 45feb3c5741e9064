"""Plain attention for the port (counterpart of `time_r1_tpu/ops/attention.py`).

`mha_reference` (no-cache attention off the flash path, sliding window) and
`mha_cached` (the decode step's attention over [cache prefix | chunk]) are
plain torch, as they are plain jnp in the JAX package. GQA is computed with
grouped matmuls: the repeated KV heads are never materialized. Scores and the
softmax are f32 whatever the operand dtype, as `preferred_element_type=f32`
makes them in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-finite: -inf would turn fully masked pad rows into NaN


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x·cos + rotate_half(x)·sin in f32 (cos/sin broadcast against x), where
    rotate_half(x) = concat(-x2, x1) over the two halves of the last axis."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    return xf * cos + torch.cat([-x2, x1], dim=-1) * sin


def _bias_grouped(bias: torch.Tensor, H: int, Hkv: int) -> torch.Tensor:
    """Broadcast an additive (B, 1|H, Sq, Skv) bias to (B, Hkv, G, Sq, Skv)."""
    b = bias.float()
    if b.shape[1] == 1:
        return b[:, :, None]
    return b.expand(b.shape[0], H, *b.shape[2:]).reshape(b.shape[0], Hkv, H // Hkv, *b.shape[2:])


def mha_reference(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, D)
    bias: Optional[torch.Tensor] = None,  # additive, broadcastable to (B, 1|H, Sq, Skv)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """SDPA with an f32 softmax; returns (B, Sq, H, D) in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if bias is not None:
        logits = logits + _bias_grouped(bias, H, Hkv)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def mha_cached(
    q: torch.Tensor,  # (B, S, H, D) current chunk queries (post-rope)
    k_old: torch.Tensor,  # (B, Lkv, Hkv, D) cache buffer (valid prefix masked by bias_old)
    v_old: torch.Tensor,
    k_new: torch.Tensor,  # (B, S, Hkv, D) current chunk keys (post-rope)
    v_new: torch.Tensor,
    bias_old: torch.Tensor,  # additive, broadcastable to (B, 1|H, S, Lkv)
    bias_new: torch.Tensor,  # additive, broadcastable to (B, 1|H, S, S)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over [cache prefix | chunk] with one softmax combined across
    both parts: identical to attention over their concatenation, without
    building the concatenation."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, S, H, D = q.shape
    Hkv = k_old.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, D).float()
    lo = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_old.float()) * scale
    ln = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_new.float()) * scale
    lo = lo + _bias_grouped(bias_old, H, Hkv)
    ln = ln + _bias_grouped(bias_new, H, Hkv)
    m = torch.maximum(lo.amax(-1), ln.amax(-1))[..., None]
    po = torch.exp(lo - m)
    pn = torch.exp(ln - m)
    denom = po.sum(-1, keepdim=True) + pn.sum(-1, keepdim=True)
    po = (po / denom).to(v_old.dtype).float()
    pn = (pn / denom).to(v_new.dtype).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", po, v_old.float()) + torch.einsum(
        "bhgqk,bkhd->bqhgd", pn, v_new.float()
    )
    return out.reshape(B, S, H, D).to(q.dtype)
