"""Plain attention for the port (counterpart of `time_r1_tpu/ops/attention.py`).

`mha_reference` (no-cache attention off the flash path, sliding window),
`mha_cached` (the decode step's attention over [cache prefix | chunk]) and
its int8-cache form `mha_cached_q8`, and `mha_shared_prefix` (the G-way step
over [shared prefix | own suffix | chunk], bf16 or int8) are plain torch, as
they are plain jnp in the JAX package. GQA is computed with
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


def mha_shared_prefix(
    q: torch.Tensor,  # (B, S, H, D) current chunk queries (post-rope), B = P·R
    k_pref: torch.Tensor,  # (P, Lp, Hkv, D) prompt-prefix cache, one copy per prompt
    v_pref: torch.Tensor,
    ks_pref: Optional[torch.Tensor],  # (P, Lp, Hkv) f32 scales when the prefix is int8
    vs_pref: Optional[torch.Tensor],
    k_own: Optional[torch.Tensor],  # (B, Lo, Hkv, D) per-row suffix cache; None → no suffix
    v_own: Optional[torch.Tensor],
    ks_own: Optional[torch.Tensor],  # (B, Lo, Hkv) f32 scales when the suffix is int8
    vs_own: Optional[torch.Tensor],
    k_new: torch.Tensor,  # (B, S, Hkv, D) current chunk, unquantized
    v_new: torch.Tensor,
    bias_pref: torch.Tensor,  # (P, 1, S|1, Lp) additive (prompt padding)
    bias_own: Optional[torch.Tensor],  # (B|1, 1, S|1, Lo) additive (suffix validity)
    bias_new: torch.Tensor,  # (B|1, 1, S, S) additive (causal within chunk)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-rollout attention with the prompt KV stored once per prompt:
    rows [i·R, (i+1)·R) attend prefix i, their own generated suffix and the
    chunk, with one softmax over all three (`time_r1_tpu/ops/attention.py:101`).
    Serves the G-way decode step off D2, and the split-loss completion chunk
    off the S1 kernel (k_own=None). int8 prefix and suffix scales fold on the
    score axis (K) and the probability axis (V), as in `mha_cached_q8`.
    Differentiable; probabilities are cast to the operand dtype before the
    value products, as in JAX."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, S, H, D = q.shape
    P, Lp, Hkv, _ = k_pref.shape
    R = B // P
    G = H // Hkv
    qf = q.float()
    qp = qf.reshape(P, R, S, Hkv, G, D)
    lp = torch.einsum("prshgd,pkhd->prhgsk", qp, k_pref.to(q.dtype).float()) * scale
    if ks_pref is not None:
        lp = lp * ks_pref.float().transpose(1, 2)[:, None, :, None, None, :]
    lp = lp.reshape(B, Hkv, G, S, Lp)
    bp = bias_pref.float().repeat_interleave(R, dim=0)
    lp = lp + _bias_grouped(bp, H, Hkv)
    qg = qf.reshape(B, S, Hkv, G, D)
    logits = [lp]
    if k_own is not None:
        lo = torch.einsum("bshgd,bkhd->bhgsk", qg, k_own.to(q.dtype).float()) * scale
        if ks_own is not None:
            lo = lo * ks_own.float().transpose(1, 2)[:, :, None, None, :]
        logits.append(lo + _bias_grouped(bias_own, H, Hkv))
    ln = torch.einsum("bshgd,bkhd->bhgsk", qg, k_new.float()) * scale
    logits.append(ln + _bias_grouped(bias_new, H, Hkv))
    m = torch.stack([x.amax(-1) for x in logits]).amax(0)[..., None]
    probs = [torch.exp(x - m) for x in logits]
    denom = sum(p.sum(-1, keepdim=True) for p in probs)
    probs = [p / denom for p in probs]
    pp = probs[0].reshape(P, R, Hkv, G, S, Lp)
    if vs_pref is not None:
        pp = pp * vs_pref.float().transpose(1, 2)[:, None, :, None, None, :]
    out = torch.einsum(
        "prhgsk,pkhd->prshgd", pp.to(q.dtype).float(), v_pref.to(q.dtype).float()
    ).reshape(B, S, H, D)
    if k_own is not None:
        po = probs[1]
        if vs_own is not None:
            po = po * vs_own.float().transpose(1, 2)[:, :, None, None, :]
        out = out + torch.einsum(
            "bhgsk,bkhd->bshgd", po.to(q.dtype).float(), v_own.to(q.dtype).float()
        ).reshape(B, S, H, D)
    pn = probs[-1].to(v_new.dtype).float()
    out = out + torch.einsum("bhgsk,bkhd->bshgd", pn, v_new.float()).reshape(B, S, H, D)
    return out.to(q.dtype)


def mha_cached_q8(
    q: torch.Tensor,  # (B, S, H, D) current chunk queries (post-rope)
    k8_old: torch.Tensor,  # (B, Lkv, Hkv, D) int8 cache
    v8_old: torch.Tensor,
    ks_old: torch.Tensor,  # (B, Lkv, Hkv) f32 per-(token, head) scales
    vs_old: torch.Tensor,
    k_new: torch.Tensor,  # (B, S, Hkv, D) current chunk, unquantized
    v_new: torch.Tensor,
    bias_old: torch.Tensor,
    bias_new: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """`mha_cached` against an int8 cache (`time_r1_tpu/ops/attention.py:198`):
    scores = s·(q·k8) and out = (p·s)·v8, so the dequantized K/V never
    materialize; the chunk stays at full precision."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, S, H, D = q.shape
    Hkv = k8_old.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, D).float()
    lo = torch.einsum("bqhgd,bkhd->bhgqk", qg, k8_old.float())
    lo = lo * (scale * ks_old.float().transpose(1, 2)[:, :, None, None, :])
    ln = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_new.float()) * scale
    lo = lo + _bias_grouped(bias_old, H, Hkv)
    ln = ln + _bias_grouped(bias_new, H, Hkv)
    m = torch.maximum(lo.amax(-1), ln.amax(-1))[..., None]
    po = torch.exp(lo - m)
    pn = torch.exp(ln - m)
    denom = po.sum(-1, keepdim=True) + pn.sum(-1, keepdim=True)
    po = (po / denom * vs_old.float().transpose(1, 2)[:, :, None, None, :]).to(q.dtype).float()
    pn = (pn / denom).to(v_new.dtype).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", po, v8_old.float()) + torch.einsum(
        "bhgqk,bkhd->bqhgd", pn, v_new.float()
    )
    return out.reshape(B, S, H, D).to(q.dtype)
