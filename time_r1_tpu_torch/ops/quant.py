"""Projections, embedding lookups and weight-only quantization (port of
`time_r1_tpu/ops/quant.py`).

Weights are in torch's (out, in) layout, so every product is `F.linear`. A
weight may be a plain tensor or a quantized dict, quantized along its
contraction (last) axis with one f32 scale per output row:

    {"q8": int8 (N, K), "s": f32 (N, 1)}
    {"q4": uint8 (N, K/2), "s": f32 (N, 1)}

The scale is kept (N, 1), not (N,), so that `q * s` dequantizes every layout
(the (V, H) embedding is row-quantized the same way, and serves the tied head).
q4 packs two consecutive k into one byte as offset-8 unsigned nibbles
(u = q + 8 in [1, 15]), the low nibble holding the even k: JAX's convention,
along the same contraction axis. Quantized values and scales are bit-equal to
the JAX package's after the layout transpose (`convert.py`).

Int8 products dequantize and go through `F.linear`, as XLA fuses the convert
into the dot in the JAX package (it has no Pallas kernel for them). On CUDA
tensors two products take kernels, as the JAX package routes them on the TPU:
an int4 weight at M <= 256 rows goes to Q1 (`ops/int4_matmul.py`), and the
fused int8 SwiGLU at B·S <= 128 to Q2 (`ops/fused_mlp.py`). On the CPU both
take the unfused path, as JAX does off the TPU.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .fused_mlp import fused_mlp_eligible, fused_mlp_int8
from .int4_matmul import int4_matmul

QBITS = {"int8": 8, "int4": 4}  # Engine(quantization=...) names; an unknown name is a KeyError


def is_quantized(w) -> bool:
    return isinstance(w, dict) and ("q8" in w or "q4" in w)


@torch.no_grad()
def quantize_weight(w: torch.Tensor, bits: int = 8) -> dict:
    """Symmetric quantization of an (N, K) weight along K: one f32 scale per
    output row, int8 values, or int4 packed two per byte along K."""
    assert bits in (8, 4), bits
    wf = w.detach().float()
    qmax = 127.0 if bits == 8 else 7.0
    scale = wf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / qmax
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)
    if bits == 8:
        return {"q8": q, "s": scale}
    assert q.shape[-1] % 2 == 0, q.shape
    u = (q + 8).to(torch.uint8)
    return {"q4": u[..., 0::2] | (u[..., 1::2] << 4), "s": scale}


def unpack_q4(packed: torch.Tensor) -> torch.Tensor:
    """(..., K/2) uint8 offset-8 nibbles → (..., K) int8, the low nibble first."""
    lo = (packed & 0x0F).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def _qvalues(w: dict) -> torch.Tensor:
    return w["q8"] if "q8" in w else unpack_q4(w["q4"])


def dequantize_weight(w: dict, dtype=torch.bfloat16) -> torch.Tensor:
    return (_qvalues(w).float() * w["s"]).to(dtype)


def qmatmul(x: torch.Tensor, w, b=None) -> torch.Tensor:
    """x @ w.T (+ b) for a plain or quantized (out, in) weight. A quantized
    product rounds to x's dtype before the scale, then adds the bias, as the
    JAX package's `qmatmul(x, w) + b` does."""
    if not is_quantized(w):
        return F.linear(x, w, b)
    M = x.numel() // x.shape[-1]
    if "q4" in w and x.is_cuda and M <= 256:  # decode shapes: the nibbles unpack on chip
        y = int4_matmul(x.reshape(M, x.shape[-1]), w["q4"], w["s"]).reshape(*x.shape[:-1], -1)
    else:
        y = F.linear(x, _qvalues(w).to(x.dtype)) * w["s"].reshape(-1).to(x.dtype)
    return y if b is None else y + b


def embed_lookup(emb, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """Row lookup from a plain or row-quantized (V, H) embedding table."""
    if not is_quantized(emb):
        out = F.embedding(ids, emb)
        return out if dtype is None else out.to(dtype)
    rows = emb["q8"][ids] if "q8" in emb else unpack_q4(emb["q4"][ids])
    out = rows.float() * emb["s"][ids]
    return out.to(dtype if dtype is not None else torch.bfloat16)


@torch.no_grad()
def quantize_embedding(emb: torch.Tensor, bits: int = 8) -> dict:
    """Per-row quantization of the (V, H) embedding: H is the tied head's
    contraction axis, so one scale per row serves the lookup and the head."""
    return quantize_weight(emb, bits=bits)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with the products accumulated and returned in f32 (JAX's
    `preferred_element_type=jnp.float32`). On CUDA the low-precision operands
    stay as they are (`aten::mm.dtype`, cuBLAS); on the CPU the product is
    taken in f32."""
    if a.dtype == torch.float32 or not a.is_cuda:
        return a.float() @ b.float()
    return torch.mm(a, b, out_dtype=torch.float32)


def _mm_f32_cotangent(g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """g (f32) @ b with g kept at f32 precision and the products accumulated in
    f32, as JAX's transpose of an f32-accumulating dot consumes its f32
    cotangent (`dot_general(c: f32, b: bf16, preferred_element_type=f32)`).

    On the CPU the product is taken in f32. On the card `aten::mm.dtype` has no
    f32 x bf16 form, so for a bf16 `b` the cotangent is split into
    g_hi = bf16(g) and g_lo = bf16(g - g_hi) and the two bf16 products are
    summed in f32: g_hi + g_lo carries 16 of g's 24 mantissa bits (relative
    error about 2^-16), for a second head GEMM per loss chunk. The other way,
    up-casting b to f32 per chunk, would write and read an f32 copy of the
    (V, H) head and run the product without tensor cores."""
    if b.dtype == torch.float32 or not g.is_cuda:
        return g.float() @ b.float()
    g_hi = g.to(b.dtype)
    g_lo = (g - g_hi.float()).to(b.dtype)
    return _mm_f32(g_hi, b) + _mm_f32(g_lo, b)


class _HeadF32(torch.autograd.Function):
    """logits = hidden @ w.T in f32 for an (N, H) head matrix. The backward
    keeps the f32 logits' cotangent at f32 precision in both products and
    accumulates them in f32, then rounds to the operands' dtypes."""

    @staticmethod
    def forward(ctx, hidden, w):
        ctx.save_for_backward(hidden, w)
        return _mm_f32(hidden.reshape(-1, hidden.shape[-1]), w.t()).reshape(*hidden.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        hidden, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float()
        h2 = hidden.reshape(-1, hidden.shape[-1])
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = _mm_f32_cotangent(g2, w).to(hidden.dtype).reshape(hidden.shape)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32_cotangent(g2.t(), h2.to(w.dtype)).to(w.dtype)
        return dh, dw


def head_logits(hidden: torch.Tensor, w) -> torch.Tensor:
    """hidden @ w.T as f32 logits for an (N, H) matrix, read as it is (no
    transposed copy), with the f32 accumulator kept: the tied LM head, the
    untied one, and the loss chunks' logits. A row-quantized matrix (the
    rollout engine's) contracts its values in hidden's dtype and applies the
    row scales to the f32 logits, as the JAX package's quantized heads do; it
    has no backward."""
    if not is_quantized(w):
        return _HeadF32.apply(hidden, w)
    q = _qvalues(w).to(hidden.dtype)
    y = _mm_f32(hidden.reshape(-1, hidden.shape[-1]), q.t()) * w["s"].reshape(-1)
    return y.reshape(*hidden.shape[:-1], q.shape[0])


def tied_head_logits(hidden: torch.Tensor, emb) -> torch.Tensor:
    """hidden @ emb.T as f32 logits against the (V, H) embedding table."""
    return head_logits(hidden, emb)


def attn_qkv_proj(h: torch.Tensor, attn: dict, nh: int, nkv: int, hd: int):
    """q/k/v projections from fused ("qkv") or separate layer params:
    (B, S, hid) → (B,S,nh,hd), (B,S,nkv,hd), (B,S,nkv,hd)."""
    B, S = h.shape[:2]
    if "qkv" in attn:
        qkv = qmatmul(h, attn["qkv"]) + attn["qkv_b"]
        q, k, v = qkv.split([nh * hd, nkv * hd, nkv * hd], dim=-1)
    else:
        q = qmatmul(h, attn["q_w"], attn["q_b"])
        k = qmatmul(h, attn["k_w"], attn["k_b"])
        v = qmatmul(h, attn["v_w"], attn["v_b"])
    return q.reshape(B, S, nh, hd), k.reshape(B, S, nkv, hd), v.reshape(B, S, nkv, hd)


def mlp_proj(h: torch.Tensor, mlp: dict) -> torch.Tensor:
    """SwiGLU MLP, down(silu(gate(h)) * up(h)), from fused ("gu") or separate
    layer params. On CUDA tensors the fused int8 layout at B·S <= 128 rows
    (the decode step) runs Q2, JAX's route (`time_r1_tpu/ops/quant.py:298-317`)
    without its TPU-only opt-in and its TPU block shapes."""
    if (
        "gu" in mlp
        and h.is_cuda
        and h.ndim == 3
        and h.shape[0] * h.shape[1] <= 128
        and fused_mlp_eligible(mlp)
    ):
        B, S, hid = h.shape
        out = fused_mlp_int8(h.reshape(B * S, hid), mlp["gu"]["q8"], mlp["gu"]["s"],
                             mlp["down_w"]["q8"], mlp["down_w"]["s"])
        return out.reshape(B, S, hid)
    if "gu" in mlp:
        gate, up = qmatmul(h, mlp["gu"]).chunk(2, dim=-1)
    else:
        gate, up = qmatmul(h, mlp["gate_w"]), qmatmul(h, mlp["up_w"])
    return qmatmul(F.silu(gate) * up, mlp["down_w"])


@torch.no_grad()
def quantize_text_params(text: dict, bits: int = 8, fuse: bool = True) -> dict:
    """Quantize the decode path's heavy weights of a text param dict: the
    attention and MLP projections, the embedding table and the untied head.
    Norm scales and biases stay as they are (and are shared with `text`).
    Idempotent on quantized dicts.

    fuse=True (decode): q/k/v and gate/up are concatenated along the output
    axis before quantization ("qkv"/"qkv_b"/"gu"), fewer and wider products per
    layer; per-row scales make it bit-identical to quantizing them apart.
    fuse=False keeps the q_w/k_w/... names (a LoRA training base)."""
    layers = []
    for lp in text["layers"]:
        lp = dict(lp)
        if not fuse:
            assert "qkv" not in lp and "gu" not in lp, (
                "unfused quantization needs an unfused tree (got decode-fused params)"
            )
            for key in ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w"):
                if not is_quantized(lp[key]):
                    lp[key] = quantize_weight(lp[key], bits=bits)
        else:
            if "qkv" not in lp:
                lp["qkv"] = quantize_weight(torch.cat([lp.pop("q_w"), lp.pop("k_w"), lp.pop("v_w")]), bits=bits)
                lp["qkv_b"] = torch.cat([lp.pop("q_b"), lp.pop("k_b"), lp.pop("v_b")])
            elif not is_quantized(lp["qkv"]):
                lp["qkv"] = quantize_weight(lp["qkv"], bits=bits)
            if "gu" not in lp:
                lp["gu"] = quantize_weight(torch.cat([lp.pop("gate_w"), lp.pop("up_w")]), bits=bits)
            elif not is_quantized(lp["gu"]):
                lp["gu"] = quantize_weight(lp["gu"], bits=bits)
            for key in ("o_w", "down_w"):
                if not is_quantized(lp[key]):
                    lp[key] = quantize_weight(lp[key], bits=bits)
        layers.append(lp)
    out = dict(text, layers=layers)
    # the embedding and the head stay int8 at bits=4, as in the JAX package:
    # the row lookup and the (V, hidden) head have no int4 kernel
    if not is_quantized(text["embed_tokens"]):
        out["embed_tokens"] = quantize_embedding(text["embed_tokens"], bits=8)
    if "lm_head" in text and not is_quantized(text["lm_head"]):
        out["lm_head"] = quantize_weight(text["lm_head"], bits=8)
    return out


def quantize_params(params: dict, bits: int = 8, fuse: bool = True) -> dict:
    """Quantize a {visual, text} tree for decode (fuse=True) or as a LoRA
    training base (fuse=False). The vision tower stays as it is."""
    return {"visual": params["visual"], "text": quantize_text_params(params["text"], bits=bits, fuse=fuse)}


# ---------------------------------------------------------------------------
# KV-cache quantization: per (token, head) symmetric int8 over head_dim. The
# scales fold on the score axis for K and on the probability axis for V
# (`attention.py::mha_cached_q8`), so dequantized K/V never materialize.


@torch.no_grad()
def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(…, hd) → ((…, hd) int8, (…,) f32 per-vector scale)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_kv_cache(cache):
    """A bf16 KVCache (after the prefill) in its int8 decode form: one pass
    over the buffers; scales (L, B, max_len, Hkv) f32."""
    k8, ks = quantize_kv(cache.k)
    v8, vs = quantize_kv(cache.v)
    return dataclasses.replace(cache, k=k8, v=v8, k_scale=ks, v_scale=vs)
