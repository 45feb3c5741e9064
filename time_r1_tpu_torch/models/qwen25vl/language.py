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
  the card; a decode step attends [prefix | own suffix | itself]
  (`mha_shared_prefix`).

LoRA, the int8 KV cache, remat policies and context parallelism are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ...device import resolve_device
from ...ops.attention import NEG_INF, mha_cached, mha_reference, mha_shared_prefix, rope
from ...ops.flash_attention import flash_attention, flash_attention_shared_prefix
from ...ops.quant import attn_qkv_proj, head_logits, mlp_proj, qmatmul
from .config import TextConfig


@dataclass
class KVCache:
    k: torch.Tensor  # (L, B, max_len, Hkv, hd)
    v: torch.Tensor  # (L, B, max_len, Hkv, hd)
    length: int = 0  # filled prefix length, uniform across the batch; a host int so
    #                  that a decode step never waits on the device to read it

    @staticmethod
    def zeros(cfg: TextConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda") -> "KVCache":
        device = resolve_device(device)
        shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
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

    A chunk that fills an empty buffer (length 0, buffer length S) is the
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

    fills = cache is not None and cache.length == 0 and cache.k.shape[2] == S
    in_place = cache is not None and not fills
    if in_place:
        L0 = cache.length
        kv_len = cache.k.shape[2]
        flash = use_flash if use_flash is not None else (
            _flash_eligible(cfg, hidden, S)
            and kv_len % 128 == 0
            and L0 % 128 == 0
        )
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
        if in_place:
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
        new_cache = None if cache is None else KVCache(cache.k, cache.v, cache.length + S)
    return hidden, new_cache


def suffix_cache_zeros(cfg: TextConfig, batch: int, max_new: int, dtype=torch.bfloat16,
                       device="cuda") -> KVCache:
    """Empty per-row generated-suffix cache (L, batch, max_new, Hkv, hd) for
    the shared-prefix decode."""
    return KVCache.zeros(cfg, batch, max_new, dtype=dtype, device=device)


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

    With a suffix it is one decode step through `mha_shared_prefix`: the new
    K/V are written into the suffix buffers in place at the host-int
    `suffix.length`, and the returned KVCache shares them with length + S."""
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
        suffix is None and _flash_eligible(cfg, hidden, S) and Lp % 128 == 0
    )
    if flash and suffix is not None:
        raise ValueError("the S1 branch is the loss chunk: it takes no suffix cache")

    x = hidden
    for li, lp in enumerate(params["layers"]):
        h = _rms_norm(x, lp["input_layernorm"], eps)
        q, k, v = attn_qkv_proj(h, lp, nh, nkv, hd)
        q = rope(q, cos_b, sin_b).to(x.dtype)
        k = rope(k, cos_b, sin_b).to(x.dtype)
        kp, vp = prefix.k[li], prefix.v[li]
        if flash:
            attn = flash_attention_shared_prefix(
                q, kp.to(q.dtype).contiguous(), vp.to(q.dtype).contiguous(),
                k.contiguous(), v.contiguous(), prefix_bias.contiguous(),
            )
        elif suffix is None:
            attn = mha_shared_prefix(q, kp, vp, None, None, None, None, None, None,
                                     k, v, bias_pref, None, bias_new)
        else:
            attn = mha_shared_prefix(q, kp, vp, None, None, suffix.k[li], suffix.v[li], None, None,
                                     k, v, bias_pref, bias_own, bias_new)
            suffix.k[li, :, L0:L0 + S] = k.to(suffix.k.dtype)
            suffix.v[li, :, L0:L0 + S] = v.to(suffix.v.dtype)
        x = x + qmatmul(attn.reshape(B, S, nh * hd).to(x.dtype), lp["o_w"])
        x = x + mlp_proj(_rms_norm(x, lp["post_attention_layernorm"], eps), lp)

    hidden = _rms_norm(x, params["norm"], eps)
    new_suffix = None if suffix is None else KVCache(suffix.k, suffix.v, suffix.length + S)
    return hidden, new_suffix


def lm_logits(params: dict, cfg: TextConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Final hidden states → f32 vocab logits. The tied head contracts against
    the (V, hidden) embedding table as it is (no transposed copy)."""
    return head_logits(hidden, params["embed_tokens"] if cfg.tie_word_embeddings else params["lm_head"])
