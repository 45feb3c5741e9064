"""Batched generation engine (port of `time_r1_tpu/sampler/engine.py`).

- vision features computed once per batch, through K2/K3 on the card;
- CHUNKED PREFILL: prompts stream through the decoder in chunks of up to
  `prefill_chunk_tokens` (the reference's max_num_batched_tokens = 8192)
  writing into the static KV cache; each chunk's attention is K1 on the card;
- a Python decode loop with early exit once every row has hit a stop token;
  greedy / temperature / top-k / top-p / repetition-penalty sampling on the
  device;
- G-way grouped rollouts (`num_return_sequences > 1`, the GRPO shape): each
  unique prompt is prefilled once and its KV stored once; the G rows decode
  against [shared prefix | own suffix] (`decode_loop_shared`), each step's
  attention through D2 on the card;
- weight-only quantization (`quantization="int8" | "int4"`: the engine keeps
  its own quantized copy, `ops/quant.py::quantize_params`; the decode step's
  MLP runs Q2 at int8 and its projections Q1 at int4 on the card) and the
  int8 KV cache for the decode phase (`kv_cache_quant=True`: the prefill runs
  in the engine's dtype, then one pass quantizes the cache);
- stop ids kept in the output (include_stop_token), left-padded power-of-two
  prompt buckets.
"""

from __future__ import annotations

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
from ..ops.quant import QBITS, embed_lookup, quantize_kv_cache, quantize_params
from .params import SamplingParams

PREFILL_CHUNK = 8192  # max_num_batched_tokens parity


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
        attention_mask=mask, cache=cache,
    )
    return lm_logits(params["text"], cfg.text, hidden[:, -1:]), cache


def _run_decode_loop(
    cfg: Qwen25VLConfig,
    first_logits: torch.Tensor,  # (B, V) logits at the last prompt position
    start_pos: torch.Tensor,  # (B,) rope position of the first generated token
    sp: SamplingParams,
    generator: Optional[torch.Generator],
    step_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],  # (last (B,), pos3) → logits (B, V)
) -> tuple[torch.Tensor, int]:
    """The sample/stop/repetition bookkeeping both decode loops share; the
    cache layout lives in `step_fn`. Returns (tokens (B, max_new), number of
    decode steps run).

    Position convention: `last` is generated token step-1 (0-based), which
    sits at rope position start_pos + step - 1 on all three mrope axes."""
    B, V = first_logits.shape
    device = first_logits.device
    max_new = sp.max_new_tokens
    stop_ids = torch.tensor(sp.stop_token_ids, dtype=torch.long, device=device)
    track_counts = sp.repetition_penalty != 1.0
    rows = torch.arange(B, device=device)

    last = sample_tokens(first_logits, generator, sp)
    counts = torch.zeros((B, V if track_counts else 1), dtype=torch.int32, device=device)
    if track_counts:
        counts.index_put_((rows, last), torch.ones(B, dtype=torch.int32, device=device), accumulate=True)
    tokens = torch.full((B, max_new), cfg.pad_token_id, dtype=torch.long, device=device)
    tokens[:, 0] = last
    done = torch.isin(last, stop_ids)
    step = 1
    while step < max_new and not bool(done.all()):
        pos3 = (start_pos + step - 1)[None, :, None].expand(3, B, 1)
        logits = step_fn(last, pos3)
        nxt = sample_tokens(logits, generator, sp, counts if track_counts else None)
        nxt = torch.where(done, cfg.pad_token_id, nxt)
        if track_counts:
            counts.index_put_((rows, nxt), (~done).int(), accumulate=True)
        tokens[:, step] = nxt
        done = done | torch.isin(nxt, stop_ids)
        last = nxt
        step += 1
    return tokens, step - 1


def decode_loop(
    params: dict,
    cfg: Qwen25VLConfig,
    cache: KVCache,
    first_logits: torch.Tensor,  # (B, V) logits at the last prompt position
    start_pos: torch.Tensor,  # (B,) rope position of the first generated token
    mask: torch.Tensor,  # (B, max_len)
    sp: SamplingParams,
    generator: Optional[torch.Generator],
) -> tuple[torch.Tensor, int]:
    """Sample + decode up to sp.max_new_tokens over the full per-row cache;
    returns (tokens (B, max_new), number of decode steps run)."""

    def step_fn(last, pos3):
        nonlocal cache
        logits, cache = forward(params, cfg, last[:, None], pos3, attention_mask=mask, cache=cache)
        return logits[:, -1]

    return _run_decode_loop(cfg, first_logits, start_pos, sp, generator, step_fn)


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
) -> tuple[torch.Tensor, int]:
    """decode_loop over the shared-prefix layout: the prompt KV is stored once
    per prompt and each rollout row keeps only its generated-suffix cache
    (language.shared_decode_forward), with the same sampling and stop
    semantics, over bf16 or int8 caches. On the card each step's attention is
    one D2 call per layer, reading the token-major caches through strides, so
    no relayout is made for the session (the JAX package transposes its caches
    head-major here, behind an opt-in); on the CPU it is `mha_shared_prefix`."""

    def step_fn(last, pos3):
        nonlocal suffix
        logits, suffix = forward_shared_decode(params, cfg, last[:, None], pos3, prefix, suffix, prefix_bias)
        return logits[:, -1]

    return _run_decode_loop(cfg, first_logits, start_pos, sp, generator, step_fn)


class Engine:
    """Request-level generation engine over a loaded model. Every call runs
    under `torch.no_grad()`, so a trainer may hand it parameters that require
    grad."""

    def __init__(
        self,
        params: dict,
        cfg: Qwen25VLConfig,
        dtype=torch.bfloat16,
        prefill_chunk_tokens: int = PREFILL_CHUNK,
        device="cuda",
        quantization: Optional[str] = None,
        kv_cache_quant: bool = False,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.quantization = quantization
        self.kv_cache_quant = kv_cache_quant
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

    def set_params(self, params: dict) -> None:
        """Swap in live policy weights (GRPO rollouts). Unquantized, the
        trainer updates its tree in place, so this hands over the same
        tensors: no copy. A quantized engine re-quantizes its own copy; the
        previous copy is dropped first so that its memory serves the new one.
        An unknown `quantization` name is a KeyError, as the JAX package's
        dict lookup."""
        self.params = None
        if self.quantization:
            params = quantize_params(params, bits=QBITS[self.quantization])
        self.params = params

    def _maybe_quant_cache(self, cache: KVCache) -> KVCache:
        """The prefill runs in the engine's dtype; with kv_cache_quant the
        decode phase reads an int8 copy of its cache (one conversion pass)."""
        return quantize_kv_cache(cache) if self.kv_cache_quant else cache

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    # ------------------------------------------------------------------
    def _pack(self, reqs: Sequence[Request], extra_len: int = 0):
        """Left-pad prompts → (ids, mask, pos_ids, start_pos, vis, S, max_len);
        ids/mask/pos_ids/start_pos are host numpy arrays."""
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
            return compute_vision_features(self.params, self.cfg, vis)
        vcfg, visual = self.cfg.vision, self.params["visual"]
        hidden = vision_blocks_forward(visual, vcfg, vis.patches, vis.perm, vis.pos_hw,
                                       vis.key_valid, vis.full_gather, vis.full_inverse,
                                       use_window_kernel=True)
        self.captured_vision = (self._last_vis_sig, hidden)
        return vision_merge_forward(visual, vcfg, hidden, vis.reverse)

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
        cache = KVCache.zeros(self.cfg.text, B, max_len, dtype=self.dtype, device=self.device)
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
                mask_t, feats, feat_off,
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
                                        dtype=self.dtype, device=self.device, quant=self.kv_cache_quant)
            t0 = self._sync()
            tokens, steps = decode_loop_shared(
                self.params, self.cfg, prefix, suffix, first1.repeat_interleave(G, dim=0),
                torch.from_numpy(np.repeat(start1, G)).to(self.device).long(), prefix_bias, sp, gen,
            )
        else:
            ids, mask, pos_ids, start_pos, vis, S, max_len = self._pack(reqs, extra_len=sp.max_new_tokens)
            first_logits, cache, mask_t = self._prefill(ids, mask, pos_ids, vis, S, max_len)
            cache = self._maybe_quant_cache(cache)
            t0 = self._sync()
            tokens, steps = decode_loop(
                self.params, self.cfg, cache, first_logits,
                torch.from_numpy(start_pos).to(self.device).long(), mask_t, sp, gen,
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
