"""Batched generation engine (port of `time_r1_tpu/sampler/engine.py`).

- vision features computed once per batch, through K2/K3 on the card;
- CHUNKED PREFILL: prompts stream through the decoder in chunks of up to
  `prefill_chunk_tokens` (the reference's max_num_batched_tokens = 8192)
  writing into the static KV cache; each chunk's attention is K1 on the card;
- the decode as one device program, as JAX's `lax.while_loop`: the loop's
  state (tokens, last tokens, done flags, step counter, the cache's length,
  repetition counts) lives on the device and a step updates it in place; on
  the card the step is captured once as a CUDA graph and replayed
  (`sampler/graph.py`), and the host reads the done flags once per segment
  of `DECODE_SEGMENT` steps, stopping at the first segment boundary after
  every row has hit a stop token (the steps after that write the pad id, as
  JAX's body does); greedy / temperature / top-k / top-p /
  repetition-penalty sampling on the device;
- G-way grouped rollouts (`num_return_sequences > 1`, the GRPO shape): each
  unique prompt is prefilled once and its KV stored once; the G rows decode
  against [shared prefix | own suffix] (`decode_loop_shared`), each step's
  attention through D2 on the card;
- weight-only quantization (`quantization="int8" | "int4"`: the engine keeps
  its own quantized copy, `ops/quant.py::quantize_params`; the decode step's
  MLP runs Q2 at int8 and its projections Q1 at int4 on the card) and the
  int8 KV cache for the decode phase (`kv_cache_quant=True`: the prefill runs
  in the engine's dtype, then one pass quantizes the cache);
- side-path LoRA (`set_lora_side`): adapters added as side products at every
  projection of the prefill and the decode (`ops/quant.py::lora_delta`),
  over the engine's own tree, which may be an int8 LoRA base: the GRPO
  trainer's weight sync over such a base is this call, with no merge and no
  copy;
- stop ids kept in the output (include_stop_token), left-padded power-of-two
  prompt buckets;
- tensor parallelism (`shard=`, a `parallel/sharding.py::ShardContext` over
  a mesh of data 1: the eval's `--tensor_parallel_size`): the engine keeps
  the rank's serving tree (`serving_params`: its q/k/v heads and MLP
  columns, its rows of o and down, the vision tower's heads, int8 quantized
  whole and then split; the embedding, the final norm and the head whole),
  runs the vision tower, the chunked prefill and the decode at the rank's
  heads with one all-reduce after each row-parallel product, and caches its
  own kv heads. Model-rank 0 samples and broadcasts each token over the
  model group, so every rank holds the same tokens. Under a mesh the decode
  is eager (`capture=False`), decided here from the constructor's
  arguments: a gloo collective stages through host memory, which a CUDA
  graph cannot record (JAX runs one compiled program; ROADMAP §C). Its
  weights may be int8 or int4 (quantized whole, then split: Q2 and Q1 at
  the rank's widths on the card).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.qwen25vl import (
    KVCache,
    Qwen25VLConfig,
    VisionInputs,
    forward,
    get_rope_index,
    prepare_vision_inputs,
)
from ..models.qwen25vl.language import NEG_INF, decoder_forward, lm_logits, suffix_cache_zeros
from ..models.qwen25vl.model import (
    compute_vision_features,
    forward_shared_decode,
    merge_vision_embeddings,
    vision_signature,
)
from ..models.qwen25vl.vision import vision_blocks_forward, vision_merge_forward
from ..ops.quant import QBITS, embed_lookup, group_side_adapters, quantize_kv_cache, quantize_params
from ..parallel.comm import broadcast
from .graph import StepGraph
from .params import SamplingParams

PREFILL_CHUNK = 8192  # max_num_batched_tokens parity
DECODE_SEGMENT = 16  # decode steps between two host reads of the done flags


@dataclass
class Request:
    """One tokenized generation request."""

    input_ids: list  # prompt token ids (video placeholder tokens already expanded)
    patches: Optional[np.ndarray] = None  # (P, patch_input_dim) f32 (numpy or tensor)
    grid_thw: Optional[tuple] = None  # (t, h, w)
    second_per_grid_t: float = 1.0


def _bucket(n: int, minimum: int = 128) -> int:
    """Power-of-two bucket (≥128 keeps prefill shapes flash-tile aligned)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def sample_tokens(
    logits: torch.Tensor,  # (B, V) f32
    generator: Optional[torch.Generator],
    sp: SamplingParams,
    token_counts: Optional[torch.Tensor] = None,  # (B, V) generated-token counts
) -> torch.Tensor:
    """Token sampling on the logits' device. Greedy when temperature == 0;
    otherwise the Gumbel-max draw from softmax(logits / T) after top-k / top-p."""
    if sp.repetition_penalty != 1.0 and token_counts is not None:
        penalized = torch.where(logits > 0, logits / sp.repetition_penalty, logits * sp.repetition_penalty)
        logits = torch.where(token_counts > 0, penalized, logits)
    if sp.temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / sp.temperature
    if sp.top_k > 0:
        kth = torch.topk(logits, sp.top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if sp.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = probs.cumsum(dim=-1) - probs < sp.top_p  # smallest prefix reaching top_p
        threshold = torch.where(keep, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < threshold, float("-inf"))
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return (logits + gumbel).argmax(dim=-1)


def prefill_chunk(
    params: dict,
    cfg: Qwen25VLConfig,
    cache: KVCache,
    ids: torch.Tensor,  # (B, C)
    pos_ids: torch.Tensor,  # (3, B, C)
    mask: torch.Tensor,  # (B, max_len)
    feats: Optional[torch.Tensor],  # (U_pad, hidden) or None
    feat_offsets: Optional[torch.Tensor],  # (B,) absolute feature starts
    lora_side: Optional[tuple] = None,  # (per-layer adapters, scaling), Engine.set_lora_side
    shard=None,  # a ShardContext over the text layers (the TP engine's)
) -> tuple[torch.Tensor, KVCache]:
    """One prompt chunk through the decoder, appending to the cache at
    `cache.length`; returns (logits at the chunk's last position (B, 1, V), cache)."""
    embeds = embed_lookup(params["text"]["embed_tokens"], ids, dtype=params["text"]["norm"].dtype)
    if feats is not None:
        embeds = merge_vision_embeddings(
            embeds, ids, feats, (cfg.video_token_id, cfg.image_token_id), feat_offsets
        )
    hidden, cache = decoder_forward(
        params["text"], cfg.text, embeds, pos_ids,
        attention_mask=mask, cache=cache, lora_side=lora_side, shard=shard,
    )
    return lm_logits(params["text"], cfg.text, hidden[:, -1:]), cache


def is_stop(tokens: torch.Tensor, stop_ids: torch.Tensor) -> torch.Tensor:
    """(B,) bool: tokens among stop_ids, by one broadcast compare (torch.isin
    may sort and read back a size, which a captured step cannot)."""
    return (tokens[:, None] == stop_ids[None, :]).any(-1)


def token_pick(generator: Optional[torch.Generator], sp: SamplingParams, group=None) -> Callable:
    """The decode loops' choice of the next tokens from (logits (B, V) or
    None, counts or None, like (B,) long): `sample_tokens` here, or under a
    process group the tokens that the group's rank 0 samples, broadcast to
    every rank (`comm.broadcast`), so that all ranks hold the same tokens;
    the other ranks sample nothing and may pass no logits (a pipeline
    stage's)."""
    import torch.distributed as dist

    def pick(logits, counts, like):
        if group is None:
            return sample_tokens(logits, generator, sp, counts)
        if dist.get_rank(group) == 0:
            tok = sample_tokens(logits, generator, sp, counts).contiguous()
        else:
            tok = torch.empty_like(like)
        return broadcast(tok, 0, group)

    return pick


def _run_decode_loop(
    cfg: Qwen25VLConfig,
    first_logits: Optional[torch.Tensor],  # (B, V) logits at the last prompt position
    start_pos: torch.Tensor,  # (B,) rope position of the first generated token
    sp: SamplingParams,
    generator: Optional[torch.Generator],
    step_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],  # (last (B,), pos3) → logits (B, V)
    capture: bool,
    pick: Optional[Callable] = None,  # token_pick(...): the tokens from the logits
) -> tuple[torch.Tensor, int]:
    """The sample/stop/repetition bookkeeping both decode loops share; the
    cache layout lives in `step_fn`, which must update its cache in place.
    Returns (tokens (B, max_new), number of decode steps run). `pick`
    (default `token_pick(generator, sp)`) turns each step's logits into
    tokens; a rank whose pick broadcasts another's tokens may have no logits
    (first_logits and step_fn's result None).

    The state (last, done, tokens, counts, the step counter) lives on the
    device and the step (`body`) writes it in place, the token at the device
    step through `index_copy_`: it is the step a `StepGraph` captures. The
    host checks `done.all()` before each segment of up to DECODE_SEGMENT
    steps and counts the steps itself (one a step), so no step writes past
    max_new_tokens, as JAX's `cond`; the steps that run after every row is
    done write the pad id, as JAX's body does, so the tokens are those of
    JAX's `while_loop`, which stops at once.

    Position convention: `last` is generated token step-1 (0-based), which
    sits at rope position start_pos + step - 1 on all three mrope axes."""
    B = start_pos.shape[0]
    V = first_logits.shape[-1] if first_logits is not None else cfg.text.vocab_size
    device = start_pos.device
    max_new = sp.max_new_tokens
    pad = cfg.pad_token_id
    stop_ids = torch.tensor(sp.stop_token_ids, dtype=torch.long, device=device)
    track_counts = sp.repetition_penalty != 1.0
    pick = pick or token_pick(generator, sp)
    like = torch.zeros((B,), dtype=torch.long, device=device)

    last = pick(first_logits, None, like)
    counts = torch.zeros((B, V if track_counts else 1), dtype=torch.int32, device=device)
    if track_counts:
        counts.scatter_add_(1, last[:, None], torch.ones((B, 1), dtype=torch.int32, device=device))
    tokens = torch.full((B, max_new), pad, dtype=torch.long, device=device)
    tokens[:, 0] = last
    done = is_stop(last, stop_ids)
    step = torch.ones((1,), dtype=torch.long, device=device)

    def body():
        pos3 = (start_pos + step - 1)[None, :, None].expand(3, B, 1)
        logits = step_fn(last, pos3)
        nxt = pick(logits, counts if track_counts else None, like)
        nxt = torch.where(done, pad, nxt)
        if track_counts:
            counts.scatter_add_(1, nxt[:, None], (~done).int()[:, None])
        tokens.index_copy_(1, step, nxt[:, None])
        done.logical_or_(is_stop(nxt, stop_ids))
        last.copy_(nxt)
        step.add_(1)

    graph = StepGraph(body, device, generator, capture)
    n = 1  # the host's count of the device step
    while n < max_new and not bool(done.all()):
        k = min(DECODE_SEGMENT, max_new - n)
        graph.run(k)
        n += k
    graph.close()
    return tokens, n - 1


def decode_loop(
    params: dict,
    cfg: Qwen25VLConfig,
    cache: KVCache,
    first_logits: torch.Tensor,  # (B, V) logits at the last prompt position
    start_pos: torch.Tensor,  # (B,) rope position of the first generated token
    mask: torch.Tensor,  # (B, max_len)
    sp: SamplingParams,
    generator: Optional[torch.Generator],
    capture: bool = True,
    lora_side: Optional[tuple] = None,
    shard=None,
    pick: Optional[Callable] = None,
) -> tuple[torch.Tensor, int]:
    """Sample + decode up to sp.max_new_tokens over the full per-row cache;
    returns (tokens (B, max_new), number of decode steps run). Each step
    writes at the cache's device length. On the card the step is a captured
    CUDA graph unless capture=False (the eager loop, for holding replay
    against it); on the CPU it runs eagerly. lora_side: side-path adapters,
    read by every step (a capture records their tensors: the graph lives for
    this call only, so adapters installed before the next call are the ones
    it captures). shard: a ShardContext over the text layers (the TP
    engine's, whose steps all-reduce: it passes capture=False); pick: as
    `_run_decode_loop`."""
    if cache.length + sp.max_new_tokens - 1 > cache.k.shape[2]:
        raise ValueError(f"a cache of {cache.k.shape[2]} positions holds {cache.length} and cannot take "
                         f"{sp.max_new_tokens - 1} decode steps")
    cache = cache.with_device_length()

    def step_fn(last, pos3):
        logits, _ = forward(params, cfg, last[:, None], pos3, attention_mask=mask, cache=cache,
                            lora_side=lora_side, shard=shard)
        return logits[:, -1]

    return _run_decode_loop(cfg, first_logits, start_pos, sp, generator, step_fn, capture, pick)


def decode_loop_shared(
    params: dict,
    cfg: Qwen25VLConfig,
    prefix: KVCache,  # (L, P, Lp, ...) shared prompt prefixes, one per prompt
    suffix: KVCache,  # (L, B, max_new_pad, ...) per-row suffix, B = P·G
    first_logits: torch.Tensor,  # (B, V)
    start_pos: torch.Tensor,  # (B,)
    prefix_bias: torch.Tensor,  # (P, Lp) f32 additive (prompt padding)
    sp: SamplingParams,
    generator: Optional[torch.Generator],
    capture: bool = True,
    lora_side: Optional[tuple] = None,
    shard=None,
    pick: Optional[Callable] = None,
) -> tuple[torch.Tensor, int]:
    """decode_loop over the shared-prefix layout: the prompt KV is stored once
    per prompt and each rollout row keeps only its generated-suffix cache
    (language.shared_decode_forward), with the same sampling and stop
    semantics, over bf16 or int8 caches. On the card each step's attention is
    one D2 call per layer, reading the token-major caches through strides, so
    no relayout is made for the session (the JAX package transposes its caches
    head-major here, behind an opt-in), and the suffix's live length from
    device memory; on the CPU it is `mha_shared_prefix`. D2 cannot check that
    length against the suffix without a sync, so it is checked here, once:
    the suffix must hold max_new_tokens positions (the last step writes at
    max_new_tokens - 2). `capture`, `lora_side`, `shard` and `pick` as in
    `decode_loop`."""
    if suffix.length + sp.max_new_tokens > suffix.k.shape[2]:
        raise ValueError(f"a suffix cache of {suffix.k.shape[2]} positions holding {suffix.length} cannot take "
                         f"{sp.max_new_tokens} tokens")
    suffix = suffix.with_device_length()

    def step_fn(last, pos3):
        logits, _ = forward_shared_decode(params, cfg, last[:, None], pos3, prefix, suffix, prefix_bias,
                                          lora_side=lora_side, shard=shard)
        return logits[:, -1]

    return _run_decode_loop(cfg, first_logits, start_pos, sp, generator, step_fn, capture, pick)


def _same_layout(held: list, layers: list) -> bool:
    """Whether per-layer adapters `layers` have the names and shapes of the
    engine's `held` ones (the grouped layout never does)."""
    return len(held) == len(layers) and all(
        h.keys() == l.keys() and all(h[k][n].shape == t.shape for k, ab in l.items() for n, t in ab.items())
        for h, l in zip(held, layers))


class Engine:
    """Request-level generation engine over a loaded model. Every call runs
    under `torch.no_grad()`, so a trainer may hand it parameters that require
    grad.

    shard (a `parallel/sharding.py::ShardContext` built over the whole tree
    on a mesh of data 1, `ShardContext.build(make_mesh(tp), params)`): the
    tensor-parallel engine. `params` (and those of `set_params`) is then the
    whole tree, on any device, and the engine keeps the rank's serving tree
    on its `device` (`serving_params`); or it is already that tree (a
    `ServingTree`, another TP engine's `params`), kept as it is. Every rank
    of the model group calls `generate` / `last_token_logits` together, with
    the same requests. Its decode is eager (the module docstring); FSDP
    shards raise NotImplementedError (A13), as `check_heads` does for a tp
    that would split a q or vision head. Where tp is a multiple of the kv
    heads each rank holds one replicated kv head (`parallel/tensor.py`):
    the context takes the model's kv heads (`ShardContext.with_kv_heads`)."""

    def __init__(
        self,
        params: dict,
        cfg: Qwen25VLConfig,
        dtype=torch.bfloat16,
        prefill_chunk_tokens: int = PREFILL_CHUNK,
        device="cuda",
        quantization: Optional[str] = None,
        kv_cache_quant: bool = False,
        shard=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.quantization = quantization
        self.kv_cache_quant = kv_cache_quant
        self.lora_side: Optional[tuple] = None  # (per-layer adapters, scaling), set_lora_side
        self.shard = shard
        self._text_shard = self._vis_shard = None
        if shard is not None:
            from ..parallel.tensor import check_heads

            check_heads(cfg, shard.tp)
            shard = self.shard = shard.with_kv_heads(cfg.text.num_key_value_heads)
            self._vis_shard = shard.at("visual")
        # a mesh's decode is eager: its collectives stage through host memory over gloo
        self.capture = shard is None
        self.set_params(params)
        self.prefill_chunk_tokens = prefill_chunk_tokens
        # seconds of the last generate(): vision, prefill, decode, and decode steps
        self.timings: dict = {}
        # fix_vit reuse across phases: with capture on, the prefill runs the
        # tower as blocks → merger and keeps (signature, pre-merger hidden);
        # the GRPO trainer's loss and ref forwards reuse the hidden states
        # instead of running the frozen blocks again
        self.capture_vision_hidden = False
        self.captured_vision: Optional[tuple] = None
        self._last_vis_sig: Optional[tuple] = None

    def set_params(self, params: dict, prequantized: bool = False) -> None:
        """Swap in live policy weights (GRPO rollouts). Unquantized, the
        trainer updates its tree in place, so this hands over the same
        tensors: no copy. A quantized engine re-quantizes its own copy; the
        previous copy is dropped first so that its memory serves the new one.
        prequantized: `params` is already the quantized copy (the LoRA
        trainer's merge-then-quantize). An unknown `quantization` name is a
        KeyError, as the JAX package's dict lookup. With a shard, `params` is
        the whole tree and the engine cuts its serving tree from it, or a
        `ServingTree` of this rank, at the asked bits (any when
        `quantization` is None), used as it is."""
        self.params = None
        if self.shard is not None:
            from ..parallel.sharding import ServingTree, serving_context, serving_params

            if isinstance(params, ServingTree):
                params.check(self.shard, QBITS[self.quantization] if self.quantization else None)
            elif prequantized:
                raise ValueError("a tensor-parallel engine quantizes the whole tree itself (prequantized=False)")
            else:
                bits = QBITS[self.quantization] if self.quantization else 0
                params = serving_params(params, self.shard, bits, self.device)
            self._text_shard = serving_context(self.shard.at("text"), params["text"]["layers"])
        elif self.quantization and not prequantized:
            params = quantize_params(params, bits=QBITS[self.quantization])
        self.params = params

    def _pick(self, gen: torch.Generator, sp: SamplingParams) -> Callable:
        """The decode's token choice: under a shard model-rank 0 samples and
        broadcasts (`token_pick`)."""
        return token_pick(gen, sp, None if self.shard is None else self.shard.model_group)

    @torch.no_grad()
    def set_lora_side(self, layers: Optional[list], scaling: float = 1.0) -> None:
        """Install (or, with None, clear) side-path adapters for every later
        prefill and decode step: `layers` is the decoder's per-layer adapter
        dicts (`rl/lora.py::lora_layers_tree`). The engine keeps its own copy
        in its dtype, never the caller's tensors: a set of the installed
        layout is copied into it in place (the GRPO weight sync: no
        allocation), another layout replaces it. A decode graph lives for one
        `generate` (`sampler/graph.py`), so the next one captures what is
        installed then. With TIMER1_GROUP_SIDE_LORA=1 they take the grouped
        layout (`ops/quant.py::group_side_adapters`, q/k/v and gate/up one
        side product each), off by default as in the JAX package."""
        if layers is None:
            self.lora_side = None
            return
        if self.shard is not None:
            raise NotImplementedError("side-path LoRA on a tensor-parallel engine is not ported (ROADMAP A13)")
        if os.environ.get("TIMER1_GROUP_SIDE_LORA", "0") == "1":
            self.lora_side = (group_side_adapters(layers, dtype=self.dtype), scaling)
            return
        held = self.lora_side[0] if self.lora_side is not None else None
        if held is not None and _same_layout(held, layers):
            for dst, src in zip(held, layers):
                for k, ab in src.items():
                    for n, t in ab.items():
                        dst[k][n].copy_(t)
            self.lora_side = (held, scaling)
            return
        self.lora_side = ([{k: {n: t.detach().to(self.dtype, copy=True) for n, t in ab.items()}
                            for k, ab in sl.items()} for sl in layers], scaling)

    def _maybe_quant_cache(self, cache: KVCache) -> KVCache:
        """The prefill runs in the engine's dtype; with kv_cache_quant the
        decode phase reads an int8 copy of its cache (one conversion pass)."""
        return quantize_kv_cache(cache) if self.kv_cache_quant else cache

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    # ------------------------------------------------------------------
    def _pack(self, reqs: Sequence[Request], extra_len: int = 0, with_vision: bool = True):
        """Left-pad prompts → (ids, mask, pos_ids, start_pos, vis, S, max_len);
        ids/mask/pos_ids/start_pos are host numpy arrays. with_vision=False:
        the positions only, vis None and no patch copied to the device (a
        pipeline stage that runs no vision tower)."""
        B = len(reqs)
        S = _bucket(max(len(r.input_ids) for r in reqs))
        max_len = S + _round_up(extra_len, 128) if extra_len else S
        ids = np.full((B, S), self.cfg.pad_token_id, np.int64)
        mask = np.zeros((B, max_len), np.int64)
        for i, r in enumerate(reqs):
            L = len(r.input_ids)
            ids[i, S - L :] = r.input_ids
            mask[i, S - L : S] = 1
        if extra_len:
            mask[:, S:] = 1  # decode slots: the causal limit hides unwritten cells

        vis, grids, spgs, patch_list = None, [], [], []
        for r in reqs:
            if r.patches is not None:
                grids.append(tuple(int(x) for x in r.grid_thw))
                spgs.append(r.second_per_grid_t)
                if with_vision:
                    patch_list.append(torch.as_tensor(r.patches).to(self.device, self.dtype))
        if patch_list:
            patches = torch.cat(patch_list, dim=0)
            unit = self.cfg.vision.merge_unit
            pad_patches = _round_up(_bucket(patches.shape[0], 256), unit)
            prep = prepare_vision_inputs(grids, self.cfg.vision, pad_patches_to=pad_patches)
            vis = VisionInputs.build(prep, patches)
            self._last_vis_sig = vision_signature(grids, vis)

        pos_ids, _ = get_rope_index(
            self.cfg,
            ids,
            video_grid_thw=np.array(grids, np.int64) if grids else None,
            second_per_grid_ts=spgs if spgs else None,
            attention_mask=mask[:, :S],
        )
        start_pos = pos_ids.max(axis=(0, 2)) + 1
        return ids, mask, pos_ids, start_pos, vis, S, max_len

    def _vision(self, vis: VisionInputs) -> torch.Tensor:
        """Merged vision features; with capture on, as blocks → merger with the
        pre-merger hidden states kept for the trainer."""
        if not self.capture_vision_hidden:
            return compute_vision_features(self.params, self.cfg, vis, shard=self._vis_shard)
        vcfg, visual = self.cfg.vision, self.params["visual"]
        hidden = vision_blocks_forward(visual, vcfg, vis.patches, vis.perm, vis.pos_hw,
                                       vis.key_valid, vis.full_gather, vis.full_inverse,
                                       use_window_kernel=True, shard=self._vis_shard)
        self.captured_vision = (self._last_vis_sig, hidden)
        return vision_merge_forward(visual, vcfg, hidden, vis.reverse, shard=self._vis_shard)

    def _prefill(self, ids, mask, pos_ids, vis, S: int, max_len: int, on_chunk: Optional[Callable[[], object]] = None):
        """Vision tower, then chunked prefill → (last-position logits (B, V), cache).

        on_chunk: called between chunks (the continuous-batching engines'
        interleave: resident slots decode while a long admission streams in).
        Its time is left out of `timings["prefill_s"]`."""
        B = ids.shape[0]
        t0 = self._sync()
        if self.capture_vision_hidden:
            self.captured_vision = None  # never serve a previous batch's videos
        feats = self._vision(vis) if vis is not None else None
        t1 = self._sync()
        cache = KVCache.zeros(self.cfg.text, B, max_len, dtype=self.dtype, device=self.device,
                              shard=self._text_shard)
        dev = self.device
        ids_t = torch.from_numpy(ids).to(dev)
        pos_t = torch.from_numpy(pos_ids).to(dev)
        mask_t = torch.from_numpy(mask).to(dev)
        is_vis = np.isin(ids, [self.cfg.video_token_id, self.cfg.image_token_id])
        row_total = is_vis.sum(axis=1)
        row_start = np.cumsum(row_total) - row_total  # absolute feature starts

        chunk = self.prefill_chunk_tokens
        logits = None
        in_callback = 0.0
        for c0 in range(0, S, chunk):
            if c0 > 0 and on_chunk is not None:
                tc = self._sync()
                on_chunk()
                in_callback += self._sync() - tc
            c1 = min(S, c0 + chunk)
            feat_off = None
            if feats is not None:
                feat_off = torch.from_numpy(row_start + is_vis[:, :c0].sum(axis=1)).to(dev)
            logits, cache = prefill_chunk(
                self.params, self.cfg, cache, ids_t[:, c0:c1], pos_t[:, :, c0:c1],
                mask_t, feats, feat_off, lora_side=self.lora_side, shard=self._text_shard,
            )
        t2 = self._sync()
        self.timings = {"vision_s": t1 - t0, "prefill_s": t2 - t1 - in_callback}
        return logits[:, -1], cache, mask_t

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(self, requests: Sequence[Request], sp: SamplingParams) -> list[list[int]]:
        """Generate completions for a batch of requests; returns token lists
        (stop token included when sp.include_stop_token), row-major: with
        G = num_return_sequences > 1, rows [i·G, (i+1)·G) belong to request i.

        G-way rollouts prefill each unique prompt once and keep one copy of
        its prompt KV; the G rows decode against [shared prefix | own suffix]
        (`decode_loop_shared`)."""
        reqs = list(requests)
        G = sp.num_return_sequences
        gen = torch.Generator(device=self.device).manual_seed(sp.seed if sp.seed is not None else 0)
        if G > 1:
            ids, mask, pos_ids, start1, vis, S, _ = self._pack(reqs, extra_len=0)
            first1, prefix, _ = self._prefill(ids, mask, pos_ids, vis, S, S)
            prefix = self._maybe_quant_cache(prefix)
            prefix_bias = torch.where(torch.from_numpy(mask[:, :S] > 0).to(self.device), 0.0, NEG_INF).float()
            suffix = suffix_cache_zeros(self.cfg.text, len(reqs) * G, _round_up(sp.max_new_tokens, 128),
                                        dtype=self.dtype, device=self.device, quant=self.kv_cache_quant,
                                        shard=self._text_shard)
            t0 = self._sync()
            tokens, steps = decode_loop_shared(
                self.params, self.cfg, prefix, suffix, first1.repeat_interleave(G, dim=0),
                torch.from_numpy(np.repeat(start1, G)).to(self.device).long(), prefix_bias, sp, gen,
                capture=self.capture, lora_side=self.lora_side, shard=self._text_shard,
                pick=self._pick(gen, sp),
            )
        else:
            ids, mask, pos_ids, start_pos, vis, S, max_len = self._pack(reqs, extra_len=sp.max_new_tokens)
            first_logits, cache, mask_t = self._prefill(ids, mask, pos_ids, vis, S, max_len)
            cache = self._maybe_quant_cache(cache)
            t0 = self._sync()
            tokens, steps = decode_loop(
                self.params, self.cfg, cache, first_logits,
                torch.from_numpy(start_pos).to(self.device).long(), mask_t, sp, gen,
                capture=self.capture, lora_side=self.lora_side, shard=self._text_shard,
                pick=self._pick(gen, sp),
            )
        tokens = tokens.cpu().numpy()
        self.timings.update(decode_s=time.perf_counter() - t0, decode_steps=steps)
        return self._postprocess(tokens, len(reqs) * G, sp)

    def _postprocess(self, tokens: np.ndarray, n: int, sp: SamplingParams) -> list[list[int]]:
        out = []
        stop_set = set(sp.stop_token_ids)
        for i in range(n):
            row = []
            for tok in tokens[i]:
                t = int(tok)
                if t in stop_set:
                    if sp.include_stop_token:
                        row.append(t)
                    break
                row.append(t)
            out.append(row)
        return out

    # ------------------------------------------------------------------
    @torch.no_grad()
    def last_token_logits(self, requests: Sequence[Request]) -> np.ndarray:
        """(B, V) f32 logits at each prompt's last position (the prob-based MCQ
        path)."""
        ids, mask, pos_ids, _, vis, S, max_len = self._pack(list(requests), extra_len=0)
        logits, _, _ = self._prefill(ids, mask, pos_ids, vis, S, max_len)
        return logits.float().cpu().numpy()
