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
import threading

import torch
import torch.nn.functional as F

from .fused_mlp import fused_mlp_eligible, fused_mlp_int8
from .int4_matmul import int4_matmul

QBITS = {"int8": 8, "int4": 4}  # Engine(quantization=...) names; an unknown name is a KeyError


class _ProjName(threading.local):
    value = None


_PROJ_NAME = _ProjName()


class proj_name:
    """Names the products computed inside it ("qkv_proj", "attn_proj",
    "mlp_gu", "mlp_down"), as JAX's `checkpoint_name` tags the projection
    outputs: the selective remat policies
    (`models/qwen25vl/language.py::REMAT_POLICIES`) save the products made
    under the names they list. Outside a checkpointed layer it changes
    nothing."""

    __slots__ = ("name", "prev")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.prev, _PROJ_NAME.value = _PROJ_NAME.value, self.name

    def __exit__(self, *exc):
        _PROJ_NAME.value = self.prev


def current_proj_name():
    """The projection being computed on this thread (None outside one)."""
    return _PROJ_NAME.value


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
        if b is not None and b.dtype != x.dtype:  # the product rounds to x's dtype, then promotes, as in JAX
            return F.linear(x, w) + b
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


class _QuantHeadF32(torch.autograd.Function):
    """logits = (hidden @ q.T) · s in f32 for a row-quantized (N, H) head: the
    values contract in hidden's dtype, the row scales apply to the f32
    logits. The head is frozen (an int8 LoRA base), so the backward gives
    hidden's gradient only: (g · s) @ q with the f32 cotangent kept at f32
    precision and accumulated in f32, as `_HeadF32` gives it, then rounded
    to hidden's dtype. It saves the int8 values, not their cast."""

    @staticmethod
    def forward(ctx, hidden, qv, s):
        ctx.save_for_backward(qv, s)
        ctx.h_dtype, ctx.h_shape = hidden.dtype, hidden.shape
        y = _mm_f32(hidden.reshape(-1, hidden.shape[-1]), qv.to(hidden.dtype).t()) * s.reshape(-1)
        return y.reshape(*hidden.shape[:-1], qv.shape[0])

    @staticmethod
    def backward(ctx, g):
        qv, s = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float() * s.reshape(-1)
        dh = _mm_f32_cotangent(g2, qv.to(ctx.h_dtype)).to(ctx.h_dtype).reshape(ctx.h_shape)
        return dh, None, None


def head_logits(hidden: torch.Tensor, w) -> torch.Tensor:
    """hidden @ w.T as f32 logits for an (N, H) matrix, read as it is (no
    transposed copy), with the f32 accumulator kept: the tied LM head, the
    untied one, and the loss chunks' logits. A row-quantized matrix (the
    rollout engine's, and an int8 LoRA base's in the loss) contracts its
    values in hidden's dtype and applies the row scales to the f32 logits, as
    the JAX package's quantized heads do; its backward reaches hidden only."""
    if not is_quantized(w):
        return _HeadF32.apply(hidden, w)
    return _QuantHeadF32.apply(hidden, _qvalues(w), w["s"])


def tied_head_logits(hidden: torch.Tensor, emb) -> torch.Tensor:
    """hidden @ emb.T as f32 logits against the (V, H) embedding table."""
    return head_logits(hidden, emb)


def lora_delta(h: torch.Tensor, sl: dict, scaling: float) -> torch.Tensor:
    """scaling·(h @ A.T) @ B.T: the side product of one adapter (lora_a (r,
    in), lora_b (out, r), `rl/lora.py`). The same math as h times the merged
    W + scaling·B@A, with the base untouched: a rollout samples LoRA-adapted
    over the trainer's own (int8) tree, with no merge and no second copy."""
    return F.linear(F.linear(h, sl["lora_a"].to(h.dtype)), sl["lora_b"].to(h.dtype)) * scaling


def _side(y: torch.Tensor, h: torch.Tensor, name: str, lora) -> torch.Tensor:
    """y plus the side product of `name`'s adapter, if lora=(slice, scaling)
    holds one."""
    if lora is None or name not in lora[0]:
        return y
    return y + lora_delta(h, lora[0][name], lora[1])


SIDE_GROUPS = {"qkv_side": ("q_w", "k_w", "v_w"), "gu_side": ("gate_w", "up_w")}


def group_side_adapters(layers: list, dtype=None) -> list:
    """The decoder's per-layer adapters in the grouped side layout: q/k/v
    become one adapter ("qkv_side"), gate/up another ("gu_side"), whose
    lora_a stacks the members' along r and whose lora_b holds theirs on its
    block diagonal, so that its one side product (`lora_delta`) is the
    members' side products concatenated along the output axis; o_w and
    down_w (each its own input) stay as they are. dtype: cast the factors
    (the engine's dtype)."""

    def cast(t):  # a copy: the engine's adapters never alias the trainer's
        return t.detach().to(dtype or t.dtype, copy=True)

    out = []
    for sl in layers:
        grouped = {k: {n: cast(t) for n, t in v.items()} for k, v in sl.items()}
        for gname, comps in SIDE_GROUPS.items():
            if all(c in grouped for c in comps):
                members = [grouped.pop(c) for c in comps]
                grouped[gname] = {"lora_a": torch.cat([m["lora_a"] for m in members]),
                                  "lora_b": torch.block_diag(*[m["lora_b"] for m in members])}
        out.append(grouped)
    return out


def attn_qkv_proj(h: torch.Tensor, attn: dict, nh: int, nkv: int, hd: int, lora=None, tp=None):
    """q/k/v projections from fused ("qkv") or separate layer params:
    (B, S, hid) → (B,S,nh,hd), (B,S,nkv,hd), (B,S,nkv,hd).

    lora=(slice, scaling): one layer's side-path adapters (q_w/k_w/v_w, or
    the grouped qkv_side), added from h to either base layout.
    tp (a `parallel/sharding.py::ShardContext`): the weights are the rank's
    column blocks and nh, nkv its local head counts; h enters the model group
    (`ShardContext.enter`) and each bias is the rank's own block."""
    B, S = h.shape[:2]
    if tp is not None:
        h = tp.enter(h)
    grouped = lora[0].get("qkv_side") if lora is not None else None
    with proj_name("qkv_proj"):
        if "qkv" in attn:
            qkv = qmatmul(h, attn["qkv"]) + attn["qkv_b"]
            if grouped is not None:
                qkv = qkv + lora_delta(h, grouped, lora[1])
            q, k, v = qkv.split([nh * hd, nkv * hd, nkv * hd], dim=-1)
        else:
            q = qmatmul(h, attn["q_w"], attn["q_b"])
            k = qmatmul(h, attn["k_w"], attn["k_b"])
            v = qmatmul(h, attn["v_w"], attn["v_b"])
            if grouped is not None:
                dq, dk, dv = lora_delta(h, grouped, lora[1]).split([nh * hd, nkv * hd, nkv * hd], dim=-1)
                q, k, v = q + dq, k + dk, v + dv
    if grouped is None:
        q, k, v = _side(q, h, "q_w", lora), _side(k, h, "k_w", lora), _side(v, h, "v_w", lora)
    return q.reshape(B, S, nh, hd), k.reshape(B, S, nkv, hd), v.reshape(B, S, nkv, hd)


def attn_out_proj(attn_flat: torch.Tensor, lp: dict, lora=None, tp=None) -> torch.Tensor:
    """The attention's output projection o_w, plus its side product. tp: the
    rank's row block of o_w over its heads, the partial sums all-reduced over
    the model group (`ShardContext.exit`)."""
    with proj_name("attn_proj"):
        a = qmatmul(attn_flat, lp["o_w"])
    if tp is not None:
        a = tp.exit(a)
    return _side(a, attn_flat, "o_w", lora)


def mlp_proj(h: torch.Tensor, mlp: dict, lora=None, tp=None) -> torch.Tensor:
    """SwiGLU MLP, down(silu(gate(h)) * up(h)), from fused ("gu") or separate
    layer params.

    On CUDA tensors the fused int8 layout at B·S <= 128 rows (the decode
    step) runs Q2, JAX's route (`time_r1_tpu/ops/quant.py:298-317`) without
    its TPU-only opt-in and its TPU block shapes. JAX takes that route only
    without adapters, and so does the port: with lora=(slice, scaling)
    (side-path adapters, present or not for this layer's MLP) the MLP is the
    dequantize + `F.linear` products, the gate and up side products added
    before the SiLU and down's after its product. That is JAX's semantics,
    not a fallback: Q2 has no side inputs.

    tp (a `parallel/sharding.py::ShardContext`): gate/up are the rank's
    column blocks of the width and down its row block; h enters the model
    group and down's partial sums are all-reduced over it. A serving tree
    split over "model" (`parallel/sharding.py::serving_params`) holds the
    rank's fused int8 gate | up and its columns of down with every scale
    whole: Q2 runs on those local widths (the 3B at tp 2: I 5504; the 7B at
    tp 4: I 4736), and its partial sums are all-reduced like the unfused
    product's. A local shape Q2 cannot take raises in its wrapper. An int4
    serving tree holds the same blocks of q4 (down's packed K/2 bytes split,
    its scales whole): each product runs Q1 at the rank's widths (the 3B at
    tp 2: gate|up 11008 × 2048, down 2048 × 5504), down's partial sums
    all-reduced likewise."""
    if tp is not None:
        h = tp.enter(h)
    if (
        lora is None
        and "gu" in mlp
        and h.is_cuda
        and h.ndim == 3
        and h.shape[0] * h.shape[1] <= 128
        and fused_mlp_eligible(mlp)
    ):
        B, S, hid = h.shape
        out = fused_mlp_int8(h.reshape(B * S, hid), mlp["gu"]["q8"], mlp["gu"]["s"],
                             mlp["down_w"]["q8"], mlp["down_w"]["s"]).reshape(B, S, hid)
        return out if tp is None else tp.exit(out)
    grouped = lora[0].get("gu_side") if lora is not None else None
    with proj_name("mlp_gu"):
        if "gu" in mlp:
            gu = qmatmul(h, mlp["gu"])
            if grouped is not None:
                gu = gu + lora_delta(h, grouped, lora[1])
            gate, up = gu.chunk(2, dim=-1)
        else:
            gate, up = qmatmul(h, mlp["gate_w"]), qmatmul(h, mlp["up_w"])
            if grouped is not None:
                dg, du = lora_delta(h, grouped, lora[1]).chunk(2, dim=-1)
                gate, up = gate + dg, up + du
    if grouped is None:
        gate, up = _side(gate, h, "gate_w", lora), _side(up, h, "up_w", lora)
    act = F.silu(gate) * up
    with proj_name("mlp_down"):
        y = qmatmul(act, mlp["down_w"])
    if tp is not None:
        y = tp.exit(y)
    return _side(y, act, "down_w", lora)


@torch.no_grad()
def quantize_layer(lp: dict, bits: int = 8, fuse: bool = True) -> dict:
    """One decoder layer's projections quantized (`quantize_text_params`),
    fused (qkv, qkv_b, gu) or not; a new dict, the norms and biases shared."""
    lp = dict(lp)
    if not fuse:
        assert "qkv" not in lp and "gu" not in lp, (
            "unfused quantization needs an unfused tree (got decode-fused params)"
        )
        for key in ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w"):
            if not is_quantized(lp[key]):
                lp[key] = quantize_weight(lp[key], bits=bits)
        return lp
    if "qkv" not in lp:
        lp["qkv"] = _cat_rows([lp.pop("q_w"), lp.pop("k_w"), lp.pop("v_w")])
        lp["qkv_b"] = torch.cat([lp.pop("q_b"), lp.pop("k_b"), lp.pop("v_b")])
    if "gu" not in lp:
        lp["gu"] = _cat_rows([lp.pop("gate_w"), lp.pop("up_w")])
    for key in ("qkv", "gu", "o_w", "down_w"):
        if not is_quantized(lp[key]):
            lp[key] = quantize_weight(lp[key], bits=bits)
    return lp


def _cat_rows(ws: list):
    """Weights stacked along their output rows: tensors, or quantized leaves
    (their values and per-row scales alike: the same leaf as quantizing the
    stacked weight)."""
    if all(is_quantized(w) for w in ws):
        return {k: torch.cat([w[k] for w in ws]) for k in ws[0]}
    return torch.cat(ws)


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
    out = dict(text, layers=[quantize_layer(lp, bits=bits, fuse=fuse) for lp in text["layers"]])
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
