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


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with the products accumulated and returned in f32 (JAX's
    `preferred_element_type=jnp.float32`). On CUDA the low-precision operands
    stay as they are (`aten::mm.dtype`, cuBLAS); on the CPU the product is
    taken in f32."""
    if a.dtype == torch.float32 or not a.is_cuda:
        return a.float() @ b.float()
    return torch.mm(a, b, out_dtype=torch.float32)


class _HeadF32(torch.autograd.Function):
    """logits = hidden @ w.T in f32 for an (N, H) head matrix. The backward
    takes the f32 logits' cotangent in the weight's dtype and accumulates its
    products in f32, then rounds to the operands' dtypes."""

    @staticmethod
    def forward(ctx, hidden, w):
        ctx.save_for_backward(hidden, w)
        return _mm_f32(hidden.reshape(-1, hidden.shape[-1]), w.t()).reshape(*hidden.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        hidden, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(w.dtype)
        h2 = hidden.reshape(-1, hidden.shape[-1])
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = _mm_f32(g2, w).to(hidden.dtype).reshape(hidden.shape)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(g2.t(), h2.to(w.dtype)).to(w.dtype)
        return dh, dw


def head_logits(hidden: torch.Tensor, w) -> torch.Tensor:
    """hidden @ w.T as f32 logits for an (N, H) matrix, read as it is (no
    transposed copy), with the f32 accumulator kept: the tied LM head, the
    untied one, and the loss chunks' logits."""
    return _HeadF32.apply(hidden, _plain(w))


def tied_head_logits(hidden: torch.Tensor, emb) -> torch.Tensor:
    """hidden @ emb.T as f32 logits against the (V, H) embedding table."""
    return head_logits(hidden, emb)


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
