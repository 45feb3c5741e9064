"""Projections and embedding lookups (bf16/f32 branches of
`time_r1_tpu/ops/quant.py`).

Weights are in torch's (out, in) layout, so every product is `F.linear`. The
JAX package also takes weight-only int8/int4 dicts here; those are not ported
yet (ROADMAP A5), and a quantized dict raises NotImplementedError.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _plain(w) -> torch.Tensor:
    if isinstance(w, dict):
        raise NotImplementedError("quantized weights are not ported yet (ROADMAP A5)")
    return w


def qmatmul(x: torch.Tensor, w, b=None) -> torch.Tensor:
    """x @ w.T (+ b) for an (out, in) weight."""
    return F.linear(x, _plain(w), b)


def embed_lookup(emb, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """Row lookup from a (V, H) embedding table."""
    out = F.embedding(ids, _plain(emb))
    return out if dtype is None else out.to(dtype)


def tied_head_logits(hidden: torch.Tensor, emb) -> torch.Tensor:
    """hidden @ emb.T as f32 logits. F.linear reads the (V, H) table as it is:
    no transposed copy. In bf16 the product is rounded to bf16 before the f32
    cast (JAX keeps the f32 accumulator; torch has no mixed-output matmul that
    every version offers)."""
    return F.linear(hidden, _plain(emb)).float()


def attn_qkv_proj(h: torch.Tensor, attn: dict, nh: int, nkv: int, hd: int):
    """q/k/v projections: (B, S, hid) → (B,S,nh,hd), (B,S,nkv,hd), (B,S,nkv,hd)."""
    B, S = h.shape[:2]
    q = qmatmul(h, attn["q_w"], attn["q_b"])
    k = qmatmul(h, attn["k_w"], attn["k_b"])
    v = qmatmul(h, attn["v_w"], attn["v_b"])
    return q.reshape(B, S, nh, hd), k.reshape(B, S, nkv, hd), v.reshape(B, S, nkv, hd)


def mlp_proj(h: torch.Tensor, mlp: dict) -> torch.Tensor:
    """SwiGLU MLP: down(silu(gate(h)) * up(h))."""
    act = F.silu(qmatmul(h, mlp["gate_w"])) * qmatmul(h, mlp["up_w"])
    return qmatmul(act, mlp["down_w"])
