"""Qwen2.5-VL language model (decoder with M-RoPE) in PyTorch.

Port of `time_r1_tpu/models/qwen25vl/language.py`: the same math over the
port's per-layer parameter dicts (models/qwen25vl/convert.py), with a Python
loop over the layers where JAX scans.

- No-cache forward: causal attention over the S tokens, with the padding mask
  and the optional sliding window. Through the flash kernel (K1) when
  `_flash_eligible`, else plain grouped attention.
- Cached forward: the S tokens go to positions [length, length+S) of the
  static (L, B, max_len, Hkv, hd) cache. The prefill chunk attends the whole
  cache buffer through K1 with q_offset = length; a decode step (S = 1)
  attends [cache prefix | itself] with one combined softmax (`mha_cached`).
  A chunk that fills an empty buffer (the prompt forward of the GRPO loss and
  of grouped rollouts) writes nothing in place: it is the no-cache forward,
  and the cache it returns is built from the per-layer K/V, so autograd
  reaches them.
- Shared-prefix forward (`shared_decode_forward`): B = P·R rollout rows over
  one prompt-prefix cache per prompt. The loss chunk (no suffix) runs S1 on
  the card; a decode step attends [prefix | own suffix | itself], through D2
  (`ops/decode_attention.py`) on the card, else `mha_shared_prefix`.
- The int8 KV cache (the quantized rollouts' decode form, made after the
  bf16 prefill by `ops/quant.py::quantize_kv_cache`): per-(token, head) f32
  scales beside the int8 buffers; each step quantizes its chunk with
  `quantize_kv` and writes it in place. Weights may be quantized dicts
  (`ops/quant.py`) anywhere a projection, the embedding or the head is read.

LoRA, remat policies and context parallelism are not ported yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from ...device import resolve_device
from ...ops.attention import NEG_INF, mha_cached, mha_cached_q8, mha_reference, mha_shared_prefix, rope
from ...ops.decode_attention import shared_prefix_decode_full
from ...ops.flash_attention import flash_attention, flash_attention_shared_prefix
from ...ops.quant import attn_qkv_proj, head_logits, mlp_proj, qmatmul, quantize_kv
from .config import TextConfig


@dataclass
class KVCache:
    k: torch.Tensor  # (L, B, max_len, Hkv, hd), bf16/f32, or int8 in the decode form
    v: torch.Tensor  # (L, B, max_len, Hkv, hd)
    length: int = 0  # filled prefix length, uniform across the batch; a host int so
    #                  that a decode step never waits on the device to read it
    k_scale: Optional[torch.Tensor] = None  # int8 form only: (L, B, max_len, Hkv) f32
    v_scale: Optional[torch.Tensor] = None

    @staticmethod
    def zeros(cfg: TextConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda",
              quant: bool = False) -> "KVCache":
        """An empty cache; quant=True gives the int8 form with zero scales."""
        device = resolve_device(device)
        shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
        if quant:
            return KVCache(
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device),
                0,
                torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            )
        return KVCache(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
            0,
        )


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def mrope_cos_sin(cfg: TextConfig, position_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin (B, S, head_dim) f32 from 3D position ids (3, B, S). Channel j of
    the half-dim uses the (t|h|w) axis given by mrope_section."""
    half = cfg.head_dim // 2
    device = position_ids.device
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))
    sec = [axis for axis, n in enumerate(cfg.mrope_section) for _ in range(n)]
    axis_map = torch.tensor(sec, dtype=torch.long, device=device)
    pos_sel = position_ids.float().index_select(0, axis_map)  # (half, B, S)
    freqs = pos_sel.permute(1, 2, 0) * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _sliding_flags(cfg: TextConfig) -> list[bool]:
    """Per layer: sliding-window attention (layers ≥ max_window_layers when
    use_sliding_window is set, the Qwen2 convention)."""
    on = cfg.use_sliding_window and cfg.sliding_window is not None
    return [on and i >= cfg.max_window_layers for i in range(cfg.num_hidden_layers)]


def _flash_eligible(cfg: TextConfig, x: torch.Tensor, seq_len: int) -> bool:
    """The flash kernel runs for CUDA tensors with the shapes the JAX package
    sends to its Pallas kernel, and never under a sliding window."""
    return (
        x.is_cuda
        and cfg.head_dim == 128
        and seq_len % 128 == 0
        and not (cfg.use_sliding_window and cfg.sliding_window is not None)
    )


def decoder_forward(
    params: dict,
    cfg: TextConfig,
    hidden: torch.Tensor,  # (B, S, hidden) embeddings (vision already merged)
    position_ids: torch.Tensor,  # (3, B, S)
    attention_mask: Optional[torch.Tensor] = None,  # (B, S) or, with a cache, (B, max_len)
    cache: Optional[KVCache] = None,
    use_flash: Optional[bool] = None,  # force (True) or deny (False) the flash branch
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Run all decoder layers; returns (hidden (B, S, hid), updated cache).

    With a cache, each layer writes its chunk K/V into the cache buffer in
    place before attending (JAX writes all layers once, after its scan); the
    returned KVCache shares the buffers and has length + S. A cached chunk
    takes the flash branch when it is eligible and the cache length and
    buffer are 128-aligned, which a prefill chunk is and a decode step
    (S = 1) is not; JAX needs a static `flash_q_offset` for this, the port
    reads the host-int `cache.length`.

    An int8 cache (`KVCache.k_scale` set) never takes the flash branch: the
    chunk attends [int8 cache | itself] through `mha_cached_q8` and is then
    quantized with `quantize_kv` and written at `cache.length`, with its scales.

    A bf16 chunk that fills an empty buffer (length 0, buffer length S) is the
    no-cache forward (K1 with q_offset 0 and the mask as key bias, the same
    function as JAX's cached call with `flash_q_offset=0`, without a sliding
    window); its cache is a new one stacked from the per-layer K/V, written
    nowhere in place, so the prompt forward of the loss is differentiable in
    them."""
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    B, S, _ = hidden.shape
    device = hidden.device
    cos, sin = mrope_cos_sin(cfg, position_ids)
    cos_b, sin_b = cos[:, :, None, :], sin[:, :, None, :]  # broadcast over heads

    def where_allowed(allowed: torch.Tensor) -> torch.Tensor:
        return torch.where(allowed, 0.0, NEG_INF).float()

    quant_kv = cache is not None and cache.k.dtype == torch.int8
    fills = cache is not None and not quant_kv and cache.length == 0 and cache.k.shape[2] == S
    in_place = cache is not None and not fills
    if in_place:
        L0 = cache.length
        kv_len = cache.k.shape[2]
        flash = use_flash if use_flash is not None else (
            not quant_kv
            and _flash_eligible(cfg, hidden, S)
            and kv_len % 128 == 0
            and L0 % 128 == 0
        )
        if flash and quant_kv:
            raise ValueError("an int8 KV cache has no flash branch")
        if not flash:
            kv_pos = torch.arange(kv_len, device=device)[None, :]
            bias_old = where_allowed(kv_pos < L0)[None, None]  # (1, 1, 1, kv_len)
            i_pos = torch.arange(S, device=device)[:, None]
            j_pos = torch.arange(S, device=device)[None, :]
            bias_new = where_allowed(j_pos <= i_pos)[None, None]
            if attention_mask is not None:
                bias_old = bias_old + where_allowed(attention_mask > 0)[:, None, None, :]
                chunk_pad = attention_mask[:, L0:L0 + S]
                bias_new = bias_new + where_allowed(chunk_pad > 0)[:, None, None, :]
    else:
        flash = use_flash if use_flash is not None else _flash_eligible(cfg, hidden, S)
        kv_len = S
        if not flash:
            kv_pos = torch.arange(S, device=device)[None, :]
            q_pos = torch.arange(S, device=device)[:, None]
            allowed = kv_pos <= q_pos
            bias = where_allowed(allowed)[None, None]
            window_bias = bias
            if cache is None and cfg.use_sliding_window and cfg.sliding_window is not None:
                window_bias = where_allowed(allowed & (kv_pos > q_pos - cfg.sliding_window))[None, None]
            if attention_mask is not None:
                pad = where_allowed(attention_mask > 0)[:, None, None, :]
                bias = bias + pad
                window_bias = window_bias + pad
    if flash:
        if attention_mask is not None:
            kv_bias = where_allowed(attention_mask[:, :kv_len] > 0).contiguous()
        else:
            kv_bias = torch.zeros((B, kv_len), dtype=torch.float32, device=device)

    sliding = _sliding_flags(cfg)
    x = hidden
    layer_kv = []
    for li, lp in enumerate(params["layers"]):
        h = _rms_norm(x, lp["input_layernorm"], eps)
        q, k, v = attn_qkv_proj(h, lp, nh, nkv, hd)
        q = rope(q, cos_b, sin_b).to(x.dtype)
        k = rope(k, cos_b, sin_b).to(x.dtype)
        if fills:
            layer_kv.append((k, v))
        if quant_kv:
            attn = mha_cached_q8(q, cache.k[li], cache.v[li], cache.k_scale[li], cache.v_scale[li],
                                 k, v, bias_old, bias_new)
            _write_q8(cache, li, L0, k, v)
        elif in_place:
            cache.k[li, :, L0:L0 + S] = k.to(cache.k.dtype)
            cache.v[li, :, L0:L0 + S] = v.to(cache.v.dtype)
            layer_k, layer_v = cache.k[li].to(q.dtype), cache.v[li].to(q.dtype)
            if flash:
                attn = flash_attention(q, layer_k, layer_v, kv_bias, True, None, L0)
            else:
                attn = mha_cached(q, layer_k, layer_v, k, v, bias_old, bias_new)
        elif flash:
            attn = flash_attention(q, k.contiguous(), v.contiguous(), kv_bias, True, None, 0)
        else:
            attn = mha_reference(q, k, v, bias=window_bias if sliding[li] else bias)
        a = qmatmul(attn.reshape(B, S, nh * hd).to(x.dtype), lp["o_w"])
        x = x + a
        x = x + mlp_proj(_rms_norm(x, lp["post_attention_layernorm"], eps), lp)

    hidden = _rms_norm(x, params["norm"], eps)
    if fills:
        ks, vs = zip(*layer_kv)
        new_cache = KVCache(torch.stack(ks).to(cache.k.dtype), torch.stack(vs).to(cache.v.dtype), S)
    else:
        new_cache = None if cache is None else dataclasses.replace(cache, length=cache.length + S)
    return hidden, new_cache


def _write_q8(cache: KVCache, li: int, at: int, k: torch.Tensor, v: torch.Tensor) -> None:
    """Quantize a chunk's K/V (B, S, Hkv, hd) and write them, with their
    scales, into layer li of an int8 cache at positions [at, at + S)."""
    S = k.shape[1]
    k8, ks = quantize_kv(k)
    v8, vs = quantize_kv(v)
    cache.k[li, :, at:at + S] = k8
    cache.v[li, :, at:at + S] = v8
    cache.k_scale[li, :, at:at + S] = ks
    cache.v_scale[li, :, at:at + S] = vs


def suffix_cache_zeros(cfg: TextConfig, batch: int, max_new: int, dtype=torch.bfloat16,
                       device="cuda", quant: bool = False) -> KVCache:
    """Empty per-row generated-suffix cache (L, batch, max_new, Hkv, hd) for
    the shared-prefix decode; quant=True gives the int8 form."""
    return KVCache.zeros(cfg, batch, max_new, dtype=dtype, device=device, quant=quant)


def decode_step_attention(q, kp, vp, kps, vps, ko, vo, kos, vos, own_len: int, k, v,
                          prefix_bias) -> torch.Tensor:
    """One decode step's attention (S = 1) through D2: q (B, 1, H, hd) and the
    new K/V (B, 1, Hkv, hd), the caches in the port's token-major layout
    ((P, Lp, Hkv, hd) prefix, (B, Lo, Hkv, hd) suffix, scales without hd).
    The caches go to the kernel as head-major views, read through their
    strides: nothing is transposed, per step or per session. Only q and the
    (B, 1, H, hd) output are regrouped, into D2's (P, Hkv, R·G, hd) rows."""
    B, _, H, hd = q.shape
    P, _, Hkv, _ = kp.shape
    R, G = B // P, H // Hkv

    def hm(x):
        return None if x is None else x.transpose(1, 2)

    q_rows = q.reshape(P, R, Hkv, G, hd).transpose(1, 2).reshape(P, Hkv, R * G, hd)
    # v is a view into the fused qkv product: both tokens go over as (B, Hkv, hd) copies
    ctx = shared_prefix_decode_full(q_rows, hm(kp), hm(vp), hm(kps), hm(vps), prefix_bias,
                                    hm(ko), hm(vo), hm(kos), hm(vos), own_len,
                                    k[:, 0].contiguous(), v[:, 0].contiguous())
    return ctx.reshape(P, Hkv, R, G, hd).transpose(1, 2).reshape(B, 1, H, hd)


def shared_decode_forward(
    params: dict,
    cfg: TextConfig,
    hidden: torch.Tensor,  # (B, S, hidden), B = P·R rollout rows, row-major by prompt
    position_ids: torch.Tensor,  # (3, B, S)
    prefix: KVCache,  # (L, P, Lp, Hkv, hd): one prompt-prefix copy per prompt
    suffix: Optional[KVCache],  # (L, B, max_new, Hkv, hd) per-row generated tokens, or None
    prefix_bias: torch.Tensor,  # (P, Lp) f32 additive (0 valid / NEG_INF pad)
    use_flash: Optional[bool] = None,  # force (True) or deny (False) the S1 branch
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Decoder layers over rows that share their prompt's KV
    (`time_r1_tpu/models/qwen25vl/language.py:448`). Each layer attends
    [shared prefix | own suffix | this chunk] with one combined softmax.

    suffix=None is the GRPO loss chunk: the whole completion is one causal
    S-token chunk over [prefix | itself], differentiable in the prefix K/V,
    whose gradient sums over the R rows of each prompt. It runs S1
    (`flash_attention_shared_prefix`) when the chunk is flash-eligible and
    Lp % 128 == 0, else `mha_shared_prefix`.

    With a suffix it is one decode step: the new K/V are written into the
    suffix buffers in place at the host-int `suffix.length` (quantized, with
    their scales, when the caches are int8), and the returned KVCache shares
    them with length + S. On CUDA tensors a one-token step runs D2
    (`decode_step_attention`) at any prefix length, the route the JAX package
    takes with `prefix_head_major` (which also needs a 128-divisible prefix,
    for its TPU blocks); otherwise `mha_shared_prefix`."""
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    B, S, _ = hidden.shape
    device = hidden.device
    cos, sin = mrope_cos_sin(cfg, position_ids)
    cos_b, sin_b = cos[:, :, None, :], sin[:, :, None, :]
    Lp = prefix.k.shape[2]
    bias_pref = prefix_bias[:, None, None, :]  # (P, 1, 1, Lp): broadcasts over S
    i_pos = torch.arange(S, device=device)
    bias_new = torch.where(i_pos[None, :] <= i_pos[:, None], 0.0, NEG_INF).float()[None, None]
    bias_own = None
    if suffix is not None:
        L0 = suffix.length
        own_valid = torch.arange(suffix.k.shape[2], device=device) < L0
        bias_own = torch.where(own_valid, 0.0, NEG_INF).float()[None, None, None]
    flash = use_flash if use_flash is not None else (
        suffix is None and prefix.k.dtype != torch.int8 and _flash_eligible(cfg, hidden, S) and Lp % 128 == 0
    )
    if flash and suffix is not None:
        raise ValueError("the S1 branch is the loss chunk: it takes no suffix cache")
    quant = suffix is not None and suffix.k.dtype == torch.int8
    d2 = suffix is not None and S == 1 and hidden.is_cuda

    x = hidden
    for li, lp in enumerate(params["layers"]):
        h = _rms_norm(x, lp["input_layernorm"], eps)
        q, k, v = attn_qkv_proj(h, lp, nh, nkv, hd)
        q = rope(q, cos_b, sin_b).to(x.dtype)
        k = rope(k, cos_b, sin_b).to(x.dtype)
        kp, vp = prefix.k[li], prefix.v[li]
        kps = vps = kos = vos = None
        if prefix.k_scale is not None:
            kps, vps = prefix.k_scale[li], prefix.v_scale[li]
        if quant:
            kos, vos = suffix.k_scale[li], suffix.v_scale[li]
        if flash:
            attn = flash_attention_shared_prefix(
                q, kp.to(q.dtype).contiguous(), vp.to(q.dtype).contiguous(),
                k.contiguous(), v.contiguous(), prefix_bias.contiguous(),
            )
        elif suffix is None:
            attn = mha_shared_prefix(q, kp, vp, kps, vps, None, None, None, None,
                                     k, v, bias_pref, None, bias_new)
        else:
            if d2:
                attn = decode_step_attention(q, kp, vp, kps, vps, suffix.k[li], suffix.v[li], kos, vos, L0,
                                             k, v, prefix_bias)
            else:
                attn = mha_shared_prefix(q, kp, vp, kps, vps, suffix.k[li], suffix.v[li], kos, vos,
                                         k, v, bias_pref, bias_own, bias_new)
            if quant:
                _write_q8(suffix, li, L0, k, v)
            else:
                suffix.k[li, :, L0:L0 + S] = k.to(suffix.k.dtype)
                suffix.v[li, :, L0:L0 + S] = v.to(suffix.v.dtype)
        x = x + qmatmul(attn.reshape(B, S, nh * hd).to(x.dtype), lp["o_w"])
        x = x + mlp_proj(_rms_norm(x, lp["post_attention_layernorm"], eps), lp)

    hidden = _rms_norm(x, params["norm"], eps)
    new_suffix = None if suffix is None else dataclasses.replace(suffix, length=suffix.length + S)
    return hidden, new_suffix


def lm_logits(params: dict, cfg: TextConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Final hidden states → f32 vocab logits. The tied head contracts against
    the (V, hidden) embedding table as it is (no transposed copy); a
    row-quantized table or head (`ops/quant.py`) streams its int8 values."""
    return head_logits(hidden, params["embed_tokens"] if cfg.tie_word_embeddings else params["lm_head"])
