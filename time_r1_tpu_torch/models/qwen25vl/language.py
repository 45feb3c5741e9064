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

- Remat (`remat`, the trainer's gradient_checkpointing): in the GRPO loss's
  differentiated forwards (the prompt forward and the completion chunk) each
  decoder layer is one `torch.utils.checkpoint` unit, as JAX wraps each
  scanned layer in `jax.checkpoint` (`REMAT_POLICIES`, `_layer_remat`).

- LoRA: `lora=(per-layer adapters, scaling)` merges W + scaling·B@A inside
  each layer function (`rl/lora.py::apply_layer_lora`), the unit that remat
  checkpoints, so one layer's merged weights exist at a time and the
  backward recomputes them (the loss over a frozen, perhaps int8, base);
  `lora_side=` adds the adapters as side products at each projection
  (`ops/quant.py::lora_delta`), over any base and cache (the rollouts'
  decode). The two are refused together, and `lora` with an int8 cache.

- Context parallelism (`cp=`, a `parallel/ring_attention.py::ContextParallel`):
  the no-cache forward over this rank's shard of the sequence (contiguous, or
  the zig-zag chunks), with attention on the ring over K1 (B1/B2 in its
  backward) where JAX forces its flash kernel; no cache and no sliding window.
  `parallel/ring_attention.py::sequence_parallel_decoder` shards, runs and
  gathers.

- Sharded (`shard=`, a `parallel/sharding.py::ShardContext` over the text
  subtree): each layer function gathers its FSDP shards over "data" first
  (`ShardContext.layer`), inside the unit remat checkpoints, so the backward
  gathers again and no gathered weight is a residual; it then runs the
  rank's heads (nh/tp q over nkv/tp kv, G unchanged; or over its one
  replicated kv head where tp is a multiple of nkv) and MLP width, with
  Megatron's identity/all-reduce pair around the column- and row-parallel
  products (`ShardContext.enter` / `exit`). The final norm is whole on every
  rank. The caches it fills hold the rank's kv heads.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Optional

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ...device import resolve_device
from ...ops.attention import NEG_INF, mha_cached, mha_cached_q8, mha_reference, mha_shared_prefix, rope
from ...ops.decode_attention import shared_prefix_decode_full
from ...ops.flash_attention import flash_attention, flash_attention_shared_prefix
from ...ops.quant import attn_out_proj, attn_qkv_proj, current_proj_name, head_logits, mlp_proj, quantize_kv
from .config import TextConfig

# Selective gradient checkpointing, as JAX's: each decoder layer is one
# checkpointed unit, and a policy names the projection outputs it keeps as
# backward residuals (`ops/quant.py::proj_name` plays JAX's checkpoint_name).
# "full" keeps only the layer inputs (the backward reruns the whole layer);
# "dots" keeps every projection product, so the backward reruns only the
# norms, rope, silu and the attention forward; "dots_small" drops the wide
# (B, S, 2·inter) gate/up products, ~3/4 of "dots"' residual bytes.
REMAT_POLICIES = {
    "dots": ("qkv_proj", "attn_proj", "mlp_gu", "mlp_down"),
    "dots_small": ("qkv_proj", "attn_proj", "mlp_down"),
}
# the products a policy keeps: a projection's matmul (its bias add, views and
# casts are rerun)
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)


def _keep_named(names: tuple):
    """A selective-checkpoint policy: keep the products made under `names`
    (keyed on the projection's name and the op, so "dots_small" tells the
    gate/up product from the others), rerun everything else."""

    def policy(ctx, op, *args, **kwargs):
        if op in _PRODUCTS and current_proj_name() in names:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _layer_remat(layer, remat):
    """remat: False → the plain layer; True/"full" → the layer under
    torch.utils.checkpoint; a REMAT_POLICIES key → the same with that
    policy. Without autograd (the reference forward) the plain layer. The
    kernels in the layer (K1 or S1) rerun in the backward: their launch
    counters count them twice."""
    if not remat or not torch.is_grad_enabled():
        return layer
    if remat is True or remat == "full":
        return partial(checkpoint, layer, use_reentrant=False)
    context_fn = partial(create_selective_checkpoint_contexts, _keep_named(REMAT_POLICIES[remat]))
    return partial(checkpoint, layer, use_reentrant=False, context_fn=context_fn)


@dataclass
class KVCache:
    """A static KV cache. Its filled length, uniform across the batch, is kept
    in two forms:

    - `length`, a host int: what a prefill chunk reads, since K1's q_offset
      and the flash branch's 128-alignment test are host values (JAX's static
      `flash_q_offset`);
    - `dev_length`, a (1,) int32 on the cache's device, or None: set by a
      decode loop (`with_device_length`), as JAX's `KVCache.length` is a
      device int32. A cache that has it takes one-token steps (any chunk
      without the flash branch) that read the length from it, write at it
      through index ops and advance it in place, so that a step captured as a
      CUDA graph reads the length as data on every replay. Its `length` then
      stays the host value the loop began from."""

    k: torch.Tensor  # (L, B, max_len, Hkv, hd), bf16/f32, or int8 in the decode form
    v: torch.Tensor  # (L, B, max_len, Hkv, hd)
    length: int = 0
    k_scale: Optional[torch.Tensor] = None  # int8 form only: (L, B, max_len, Hkv) f32
    v_scale: Optional[torch.Tensor] = None
    dev_length: Optional[torch.Tensor] = None

    def with_device_length(self) -> "KVCache":
        """The same buffers with `dev_length` set to the host length: the form
        a decode loop steps."""
        return dataclasses.replace(
            self, dev_length=torch.full((1,), self.length, dtype=torch.int32, device=self.k.device))

    @staticmethod
    def zeros(cfg: TextConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda",
              quant: bool = False, shard=None, layers: Optional[int] = None) -> "KVCache":
        """An empty cache; quant=True gives the int8 form with zero scales.
        shard (a ShardContext): the rank's kv heads (`_heads`), with
        per-token scales a local head in the int8 form. layers: a pipeline
        stage's layer count (default: every layer)."""
        device = resolve_device(device)
        nkv = _heads(cfg, shard)[1]
        shape = (cfg.num_hidden_layers if layers is None else layers, batch, max_len, nkv, cfg.head_dim)
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


_AXIS_MAPS: dict = {}  # (mrope_section, device) -> the (half,) axis of each rotary channel


def _axis_map(sections, device: torch.device) -> torch.Tensor:
    """The (t|h|w) axis of each of the half-dim's channels, built once per
    (mrope_section, device): a decode step makes no host-to-device copy,
    which stream capture would refuse."""
    key = (tuple(sections), device)
    if key not in _AXIS_MAPS:
        sec = [axis for axis, n in enumerate(sections) for _ in range(n)]
        _AXIS_MAPS[key] = torch.tensor(sec, dtype=torch.long, device=device)
    return _AXIS_MAPS[key]


def mrope_cos_sin(cfg: TextConfig, position_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin (B, S, head_dim) f32 from 3D position ids (3, B, S). Channel j of
    the half-dim uses the (t|h|w) axis given by mrope_section."""
    half = cfg.head_dim // 2
    device = position_ids.device
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))
    axis_map = _axis_map(cfg.mrope_section, device)
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
    remat=False,  # gradient checkpointing per layer: False, True/"full", "dots", "dots_small"
    lora: Optional[tuple] = None,  # (per-layer adapters, scaling): merged inside each layer
    lora_side: Optional[tuple] = None,  # (per-layer adapters, scaling): side products
    cp=None,  # parallel.ContextParallel: the inputs are this rank's sequence shard
    shard=None,  # parallel.sharding.ShardContext over the text params: FSDP and TP layers
    layer_offset: int = 0,  # a pipeline stage's first layer: params["layers"] are layers offset, offset + 1, ...
    final_norm: bool = True,  # False: the hidden state before the final norm (a pipeline stage's)
    collect_hiddens: bool = False,  # also return every layer's output (cli/parity.py)
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Run all decoder layers; returns (hidden (B, S, hid), updated cache).

    collect_hiddens=True (the no-cache path only, as in JAX) returns
    (hidden, None, per_layer): per_layer (L, B, S, hid) stacks each layer's
    output before the final norm, HF's `output_hidden_states` slots 1..L.
    cli/parity.py diffs them layer by layer against HF transformers.

    A pipeline stage (`parallel/pipeline.py`) passes its own layers as
    params["layers"], their first index as `layer_offset` (the sliding-window
    flags and the adapters are read at the model's layer index) and a cache
    of that many layers, and takes the hidden state before the final norm
    (final_norm=False; its params then need no "norm").

    With cp, hidden, position_ids and attention_mask are this rank's shard of
    the sequence in the group's layout (S local positions, a whole number of
    flash blocks, zig-zag half-chunks too) and attention is causal ring
    attention over the group (`ContextParallel.attention`); no cache and no
    sliding window, as in JAX.

    With a cache, each layer writes its chunk K/V into the cache buffer in
    place before attending (JAX writes all layers once, after its scan); the
    returned KVCache shares the buffers and has length + S. A cached chunk
    takes the flash branch when it is eligible and the cache length and
    buffer are 128-aligned, which a prefill chunk is and a decode step
    (S = 1) is not; JAX needs a static `flash_q_offset` for this, the port
    reads the host-int `cache.length`. A cache with a device length (a decode
    loop's, `KVCache.with_device_length`) never takes it: its bias, padding
    gather and K/V write read `cache.dev_length` on the device, which then
    advances in place.

    An int8 cache (`KVCache.k_scale` set) never takes the flash branch: the
    chunk attends [int8 cache | itself] through `mha_cached_q8` and is then
    quantized with `quantize_kv` and written at `cache.length`, with its scales.

    A bf16 chunk that fills an empty buffer (length 0, buffer length S) is the
    no-cache forward (K1 with q_offset 0 and the mask as key bias, the same
    function as JAX's cached call with `flash_q_offset=0`, without a sliding
    window); its cache is a new one stacked from the per-layer K/V, written
    nowhere in place, so the prompt forward of the loss is differentiable in
    them."""
    if collect_hiddens and (cache is not None or cp is not None or shard is not None or lora_side is not None):
        raise ValueError("collect_hiddens takes the no-cache forward only: no cache, cp, shard or lora_side")
    nh, nkv, hd = _heads(cfg, shard)
    eps = cfg.rms_norm_eps
    B, S, _ = hidden.shape
    device = hidden.device
    cos, sin = mrope_cos_sin(cfg, position_ids)
    cos_b, sin_b = cos[:, :, None, :], sin[:, :, None, :]  # broadcast over heads

    def where_allowed(allowed: torch.Tensor) -> torch.Tensor:
        return torch.where(allowed, 0.0, NEG_INF).float()

    quant_kv = cache is not None and cache.k.dtype == torch.int8
    on_device = cache is not None and cache.dev_length is not None
    fills = (cache is not None and not quant_kv and not on_device and cache.length == 0
             and cache.k.shape[2] == S)
    in_place = cache is not None and not fills
    if cp is not None:
        if cache is not None:
            raise ValueError("context parallelism covers the no-cache (training) forward only")
        if cfg.use_sliding_window and cfg.sliding_window is not None:
            raise ValueError("context parallelism takes no sliding window")
        block = S // 2 if cp.layout == "zigzag" else S
        if block % 128:
            raise ValueError(f"a context-parallel shard of {S} positions is not a whole number of 128-row "
                             "flash blocks: pad the sequence to the group's multiple")
        use_flash = True  # ring attention rides K1
    if in_place:
        L0 = cache.dev_length if on_device else cache.length
        kv_len = cache.k.shape[2]
        flash = use_flash if use_flash is not None else (
            not quant_kv
            and not on_device
            and _flash_eligible(cfg, hidden, S)
            and kv_len % 128 == 0
            and L0 % 128 == 0
        )
        if flash and quant_kv:
            raise ValueError("an int8 KV cache has no flash branch")
        if flash and on_device:
            raise ValueError("the flash branch needs the host length: a cache with a device length has none")
        if not flash:
            kv_pos = torch.arange(kv_len, device=device)[None, :]
            bias_old = where_allowed(kv_pos < L0)[None, None]  # (1, 1, 1, kv_len)
            i_pos = torch.arange(S, device=device)[:, None]
            j_pos = torch.arange(S, device=device)[None, :]
            bias_new = where_allowed(j_pos <= i_pos)[None, None]
            if attention_mask is not None:
                bias_old = bias_old + where_allowed(attention_mask > 0)[:, None, None, :]
                chunk_pad = attention_mask.index_select(1, L0 + torch.arange(S, device=device))
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
    _check_lora(lora, lora_side, quant_kv)
    mlp_tp = _mlp_shard(cfg, shard)

    def layer(x, lp, li):
        if shard is not None:
            lp = shard.layer(lp, li, "layers")
        lp, side = _layer_adapters(lp, layer_offset + li, lora, lora_side)
        h = _rms_norm(x, lp["input_layernorm"], eps)
        q, k, v = attn_qkv_proj(h, lp, nh, nkv, hd, lora=side, tp=shard)
        q = rope(q, cos_b, sin_b).to(x.dtype)
        k = rope(k, cos_b, sin_b).to(x.dtype)
        if quant_kv:
            attn = mha_cached_q8(q, cache.k[li], cache.v[li], cache.k_scale[li], cache.v_scale[li],
                                 k, v, bias_old, bias_new)
            _write_q8(cache, li, L0, k, v)
        elif in_place:
            _write_at(cache.k, li, L0, k.to(cache.k.dtype))
            _write_at(cache.v, li, L0, v.to(cache.v.dtype))
            layer_k, layer_v = cache.k[li].to(q.dtype), cache.v[li].to(q.dtype)
            if flash:
                attn = flash_attention(q, layer_k, layer_v, kv_bias, True, None, L0)
            else:
                attn = mha_cached(q, layer_k, layer_v, k, v, bias_old, bias_new)
        elif cp is not None:
            attn = cp.attention(q, k, v, kv_bias)
        elif flash:
            attn = flash_attention(q, k.contiguous(), v.contiguous(), kv_bias, True, None, 0)
        else:
            attn = mha_reference(q, k, v, bias=window_bias if sliding[layer_offset + li] else bias)
        x = x + attn_out_proj(attn.reshape(B, S, nh * hd).to(x.dtype), lp, side, tp=shard)
        x = x + mlp_proj(_rms_norm(x, lp["post_attention_layernorm"], eps), lp, lora=side, tp=mlp_tp)
        return x, k, v

    if remat and in_place and torch.is_grad_enabled():
        raise ValueError("remat takes a forward that writes no cache in place (no cache, or one it fills)")
    layer_fn = _layer_remat(layer, remat)
    x = hidden
    layer_kv, per_layer = [], []
    for li, lp in enumerate(params["layers"]):
        x, k, v = layer_fn(x, lp, li)
        if fills:
            layer_kv.append((k, v))
        if collect_hiddens:
            per_layer.append(x)

    hidden = _rms_norm(x, params["norm"], eps) if final_norm else x
    if collect_hiddens:
        return hidden, None, torch.stack(per_layer)
    if fills:
        ks, vs = zip(*layer_kv)
        new_cache = KVCache(torch.stack(ks).to(cache.k.dtype), torch.stack(vs).to(cache.v.dtype), S)
    else:
        new_cache = None if cache is None else _advance(cache, S)
    return hidden, new_cache


def _heads(cfg: TextConfig, shard) -> tuple[int, int, int]:
    """(q heads, kv heads, head dim) of this rank: all of them, or under a
    model dim of tp its nh/tp q heads over nkv/tp kv heads, or over its one
    replicated kv head where tp is a multiple of nkv
    (`parallel/tensor.py::local_heads`)."""
    if shard is None:
        return cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    from ...parallel.tensor import local_heads

    nh, nkv, _, _ = local_heads(cfg, shard.tp, shard.model_rank)
    return nh, nkv, cfg.head_dim


def _mlp_shard(cfg: TextConfig, shard):
    """The context the MLP runs under: `shard`, or None where the model dim
    does not split the MLP's width (the rule table then leaves gate, up and
    down whole on every rank, `parallel/tensor.py::splits`)."""
    from ...parallel.tensor import splits

    return shard if shard is not None and splits(cfg.intermediate_size, shard.tp) else None


def _check_lora(lora, lora_side, quant_kv: bool) -> None:
    """The JAX package's refusals: the in-layer merge is the loss path's (no
    int8 cache), and adapters come one way at a time."""
    if lora is not None and lora_side is not None:
        raise ValueError("pass adapters as lora= or lora_side=, not both")
    if lora is not None and quant_kv:
        raise ValueError("the in-layer LoRA merge is the loss path's: it takes no int8 KV cache")


def _layer_adapters(lp: dict, li: int, lora, lora_side) -> tuple[dict, Optional[tuple]]:
    """Layer li's params with its adapters merged (lora), and its side
    adapters (lora_side) as (slice, scaling) or None. The merge is built
    here, outside every projection's name, so that no remat policy keeps it."""
    if lora is not None:
        from ...rl.lora import apply_layer_lora  # rl imports the models: a lazy import, as in JAX

        return apply_layer_lora(lp, lora[0][li], lora[1]), None
    if lora_side is not None:
        return lp, (lora_side[0][li], lora_side[1])
    return lp, None


def _advance(cache: KVCache, S: int) -> KVCache:
    """The cache after a chunk of S tokens was written: a device length
    advances in place (the same cache comes back), a host length in a new
    KVCache over the same buffers."""
    if cache.dev_length is not None:
        cache.dev_length.add_(S)
        return cache
    return dataclasses.replace(cache, length=cache.length + S)


def _write_at(buf: torch.Tensor, li: int, at, x: torch.Tensor) -> None:
    """buf[li, :, at:at + S] = x for a chunk x (B, S, ...), at a host int or
    at a (1,) device position, which nothing reads back."""
    buf[li].index_copy_(1, at + torch.arange(x.shape[1], device=x.device), x)


def _write_q8(cache: KVCache, li: int, at, k: torch.Tensor, v: torch.Tensor) -> None:
    """Quantize a chunk's K/V (B, S, Hkv, hd) and write them, with their
    scales, into layer li of an int8 cache at positions [at, at + S) (a host
    int or a (1,) device position)."""
    k8, ks = quantize_kv(k)
    v8, vs = quantize_kv(v)
    _write_at(cache.k, li, at, k8)
    _write_at(cache.v, li, at, v8)
    _write_at(cache.k_scale, li, at, ks)
    _write_at(cache.v_scale, li, at, vs)


def suffix_cache_zeros(cfg: TextConfig, batch: int, max_new: int, dtype=torch.bfloat16,
                       device="cuda", quant: bool = False, shard=None) -> KVCache:
    """Empty per-row generated-suffix cache (L, batch, max_new, Hkv, hd) for
    the shared-prefix decode; quant=True gives the int8 form; shard: the
    rank's kv heads, as `KVCache.zeros`."""
    return KVCache.zeros(cfg, batch, max_new, dtype=dtype, device=device, quant=quant, shard=shard)


def decode_step_attention(q, kp, vp, kps, vps, ko, vo, kos, vos, own_len, k, v,
                          prefix_bias) -> torch.Tensor:
    """One decode step's attention (S = 1) through D2: q (B, 1, H, hd) and the
    new K/V (B, 1, Hkv, hd), the caches in the port's token-major layout
    ((P, Lp, Hkv, hd) prefix, (B, Lo, Hkv, hd) suffix, scales without hd), the
    suffix's live length `own_len` a (1,) int32 on the device (a host int on
    the CPU).
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
    remat=False,  # gradient checkpointing per layer (the loss chunk only), as decoder_forward
    lora: Optional[tuple] = None,  # the in-layer merge (the loss chunk only), as decoder_forward
    lora_side: Optional[tuple] = None,  # side products, as decoder_forward
    shard=None,  # parallel.sharding.ShardContext over the text params, as decoder_forward
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
    suffix buffers in place at its length (quantized, with their scales, when
    the caches are int8), and the returned KVCache shares them with length +
    S. The length is `suffix.dev_length` where it is set (a decode loop's,
    advanced in place), else the host-int `suffix.length`. On CUDA tensors a
    one-token step runs D2, which reads the length from device memory,
    (`decode_step_attention`) at any prefix length, the route the JAX package
    takes with `prefix_head_major` (which also needs a 128-divisible prefix,
    for its TPU blocks); otherwise `mha_shared_prefix`."""
    nh, nkv, hd = _heads(cfg, shard)
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
        L0 = suffix.length if suffix.dev_length is None else suffix.dev_length
        own_valid = torch.arange(suffix.k.shape[2], device=device) < L0
        bias_own = torch.where(own_valid, 0.0, NEG_INF).float()[None, None, None]
    flash = use_flash if use_flash is not None else (
        suffix is None and prefix.k.dtype != torch.int8 and _flash_eligible(cfg, hidden, S) and Lp % 128 == 0
    )
    if flash and suffix is not None:
        raise ValueError("the S1 branch is the loss chunk: it takes no suffix cache")
    quant = suffix is not None and suffix.k.dtype == torch.int8
    d2 = suffix is not None and S == 1 and hidden.is_cuda
    if d2 and isinstance(L0, int):  # D2 reads the length from device memory
        L0 = torch.full((1,), L0, dtype=torch.int32, device=device)

    _check_lora(lora, lora_side, quant)
    if lora is not None and suffix is not None:
        raise ValueError("the in-layer LoRA merge is the loss chunk's: it takes no suffix cache")

    def layer(x, lp, li):
        if shard is not None:
            lp = shard.layer(lp, li, "layers")
        lp, side = _layer_adapters(lp, li, lora, lora_side)
        h = _rms_norm(x, lp["input_layernorm"], eps)
        q, k, v = attn_qkv_proj(h, lp, nh, nkv, hd, lora=side, tp=shard)
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
                _write_at(suffix.k, li, L0, k.to(suffix.k.dtype))
                _write_at(suffix.v, li, L0, v.to(suffix.v.dtype))
        x = x + attn_out_proj(attn.reshape(B, S, nh * hd).to(x.dtype), lp, side, tp=shard)
        return x + mlp_proj(_rms_norm(x, lp["post_attention_layernorm"], eps), lp, lora=side,
                            tp=_mlp_shard(cfg, shard))

    if remat and suffix is not None and torch.is_grad_enabled():
        raise ValueError("remat takes the loss chunk (suffix=None): a decode step writes its suffix in place")
    layer_fn = _layer_remat(layer, remat)
    x = hidden
    for li, lp in enumerate(params["layers"]):
        x = layer_fn(x, lp, li)

    hidden = _rms_norm(x, params["norm"], eps)
    return hidden, None if suffix is None else _advance(suffix, S)


def lm_logits(params: dict, cfg: TextConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Final hidden states → f32 vocab logits. The tied head contracts against
    the (V, hidden) embedding table as it is (no transposed copy); a
    row-quantized table or head (`ops/quant.py`) streams its int8 values."""
    return head_logits(hidden, params["embed_tokens"] if cfg.tie_word_embeddings else params["lm_head"])
