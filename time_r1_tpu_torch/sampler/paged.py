"""Paged KV pool and continuous batching over it (port of
`time_r1_tpu/sampler/paged.py`).

The slot cache of `sampler/continuous.py` reserves max_len rows per slot;
this pool shares fixed-size pages across slots, so device memory is bounded
by the tokens resident rather than slots × max_len.

Layout:
  pool.k / pool.v : (L, Hkv, n_pages, P, hd), the engine's dtype or int8
  pool.k_scale / v_scale : (L, Hkv, n_pages, P) f32 (int8 pools only)
  page_table      : (slots, max_pages) int32, the pool page of each block
  lengths         : (slots,) int32, tokens written per slot

The pool lives on the engine's device and is updated in place (JAX donates
and replaces it): `write_prompt` lays a prefilled prompt into its pages, and
each decode step scatters the new token of every slot into its cell.

- The host keeps a free list of pages (`PageAllocator`); page 0 is the
  scratch sink for dead slots' decode writes.
- `paged_decode_segment` runs `segment` decode steps with no host sync: the
  last tokens, steps, done flags and the pool's lengths and page table stay
  device tensors, and the host reads tokens, steps and done once per segment.
  The engine runs the same step through `PagedDecode`: static buffers that
  the host fills with one copy before each segment, and on the card the step
  captured once per `generate` as a CUDA graph and replayed `segment` times
  (`sampler/graph.py`), as JAX's `lax.scan` is one device program.
  Each layer's attention over the page-resident prefix is P1 (P2 for an int8
  pool, `ops/paged_attention.py`) on the card, reading the pages in place
  through the page table, at any page size and length; the current token is
  folded in by `combine_with_new_token`, and the pool takes one scatter of
  every layer's new K/V per step. On the CPU the same functions run their
  gather-view plain versions.
- `PagedEngine.generate`: longest-first admission into free slots, one
  batched prefill per prompt bucket (`Engine._prefill`: K2/K3 for videos, K1
  for its chunks on the card), and the chunked-prefill interleave: resident
  slots decode a segment between a long admission's prefill chunks and
  between bucket groups.

Side-path LoRA (`set_lora_side`): one set of adapters for every request,
prepared by the prefill engine (`Engine.set_lora_side`) and added as side
products in the prefill and in every paged decode step (`decode_layers`),
over bf16 or int8 pages.

Tensor parallelism (`shard=`, the TP `Engine`'s `ShardContext` over a mesh
of data 1): the prefill engine is the TP `Engine` over the rank's serving
tree, the pool holds the rank's kv heads (nkv/tp, G unchanged; its one
replicated head where tp is a multiple of nkv), each decode step runs the
rank's heads and MLP width with one all-reduce after o and after down, and
model-rank 0 samples every token (the first of each admission too) and
broadcasts it (`engine.token_pick`). Every rank thus holds the same tokens,
so the host takes the same admissions, page allocations and retirements on
every rank. The decode is eager under a shard (`PagedDecode(capture=False)`,
as the TP `Engine`'s; ROADMAP §C).
Side-path LoRA over a shard is refused by the TP `Engine` (A13).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.qwen25vl import Qwen25VLConfig
from ..models.qwen25vl.language import _heads, _mlp_shard, _rms_norm, lm_logits, mrope_cos_sin
from ..ops.attention import rope
from ..ops.paged_attention import combine_with_new_token, paged_prefix_attention, paged_prefix_attention_q8
from ..ops.quant import attn_out_proj, attn_qkv_proj, embed_lookup, mlp_proj, quantize_kv
from .engine import Engine, _bucket, is_stop, token_pick
from .graph import StepGraph
from .params import SamplingParams


@dataclass
class PagedPool:
    k: torch.Tensor  # (L, Hkv, n_pages, P, hd), the engine's dtype or int8
    v: torch.Tensor
    page_table: torch.Tensor  # (slots, max_pages) int32
    lengths: torch.Tensor  # (slots,) int32
    # int8 pools: per-(token, head) f32 scales; None otherwise
    k_scale: Optional[torch.Tensor] = None  # (L, Hkv, n_pages, P)
    v_scale: Optional[torch.Tensor] = None


class PageAllocator:
    """Host free list over pool pages. Page 0 is reserved as the scratch sink
    for dead slots' decode writes: a retired slot's stale page table must
    never receive writes, since its pages may already belong to another slot."""

    def __init__(self, n_pages: int):
        self.free: List[int] = list(range(n_pages - 1, 0, -1))

    def alloc(self, n: int) -> List[int]:
        if n > len(self.free):
            raise MemoryError(f"KV pool exhausted: need {n} pages, have {len(self.free)}")
        return [self.free.pop() for _ in range(n)]

    def release(self, pages: List[int]) -> None:
        self.free.extend(pages)


def make_pool(cfg: Qwen25VLConfig, n_pages: int, page_size: int, slots: int, max_pages: int,
              dtype=torch.bfloat16, kv_quant: bool = False, device="cuda", shard=None) -> PagedPool:
    """An empty pool; kv_quant=True gives int8 pages with zero scales. shard
    (a ShardContext): the rank's kv heads (`language._heads`)."""
    device = resolve_device(device)
    t = cfg.text
    shape = (t.num_hidden_layers, _heads(t, shard)[1], n_pages, page_size, t.head_dim)
    kv_dtype = torch.int8 if kv_quant else dtype
    return PagedPool(
        k=torch.zeros(shape, dtype=kv_dtype, device=device),
        v=torch.zeros(shape, dtype=kv_dtype, device=device),
        page_table=torch.zeros((slots, max_pages), dtype=torch.int32, device=device),
        lengths=torch.zeros((slots,), dtype=torch.int32, device=device),
        k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device) if kv_quant else None,
        v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device) if kv_quant else None,
    )


@torch.no_grad()
def write_prompt(pool: PagedPool, slot: int, prompt_pages, table_row, k_seq: torch.Tensor, v_seq: torch.Tensor,
                 length: int) -> PagedPool:
    """Lay a prefilled sequence into its pages and register the slot, in
    place. k_seq/v_seq are (L, S, Hkv, hd) with S = len(prompt_pages) · P
    (the prompt right-padded to a page multiple); table_row is the slot's full
    (max_pages,) row of prompt and decode pages. An int8 pool quantizes per
    (token, head) at write time (the prefill stays in the engine's dtype)."""
    L = k_seq.shape[0]
    P = pool.k.shape[3]
    dev = pool.k.device
    pages = torch.as_tensor(np.asarray(prompt_pages), dtype=torch.long, device=dev)
    n = pages.shape[0]

    def to_pages(seq):  # (L, n·P, Hkv[, hd]) → (L, Hkv, n, P[, hd])
        return seq.reshape(L, n, P, *seq.shape[2:]).movedim(3, 1)

    if pool.k_scale is not None:
        k8, ks = quantize_kv(k_seq)  # scales (L, S, Hkv)
        v8, vs = quantize_kv(v_seq)
        pool.k[:, :, pages] = to_pages(k8)
        pool.v[:, :, pages] = to_pages(v8)
        pool.k_scale[:, :, pages] = to_pages(ks)
        pool.v_scale[:, :, pages] = to_pages(vs)
    else:
        pool.k[:, :, pages] = to_pages(k_seq).to(pool.k.dtype)
        pool.v[:, :, pages] = to_pages(v_seq).to(pool.v.dtype)
    pool.page_table[slot] = torch.as_tensor(np.asarray(table_row), dtype=torch.int32).to(dev)
    pool.lengths[slot] = int(length)
    return pool


def decode_layers(params: dict, cfg: Qwen25VLConfig, last: torch.Tensor, pos: torch.Tensor,
                  attend: Callable, lora_side: Optional[tuple] = None, shard=None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token per row (last (rows,), rope position pos (rows,)) through
    every decoder layer and the head: the decode step that the paged and the
    slot engines share, each with its own attention. attend(li, q, k, v)
    takes layer li's post-rope q (rows, 1, H, hd) and new k, v (rows, 1, Hkv,
    hd) and returns the context (rows, ...) with H·hd values a row.
    lora_side: (per-layer adapters, scaling), added as side products at every
    projection. shard (a ShardContext over a serving tree's text layers,
    `sharding.serving_context`): the layers are the rank's, H and Hkv its
    local heads, and the o and down products' partial sums are all-reduced
    over the model group (`ops/quant.py`'s `tp=`). Returns (f32 logits
    (rows, V), new K and V (L, rows, Hkv, hd))."""
    tcfg = cfg.text
    nh, nkv, hd = _heads(tcfg, shard)
    mlp_tp = _mlp_shard(tcfg, shard)
    eps = tcfg.rms_norm_eps
    text = params["text"]
    rows = last.shape[0]
    cos, sin = mrope_cos_sin(tcfg, pos[None, :, None].expand(3, rows, 1))
    cos_b, sin_b = cos[:, :, None, :], sin[:, :, None, :]
    x = embed_lookup(text["embed_tokens"], last[:, None], dtype=text["norm"].dtype)
    new_k, new_v = [], []
    for li, lp in enumerate(text["layers"]):
        side = None if lora_side is None else (lora_side[0][li], lora_side[1])
        q, k, v = attn_qkv_proj(_rms_norm(x, lp["input_layernorm"], eps), lp, nh, nkv, hd, lora=side, tp=shard)
        q = rope(q, cos_b, sin_b).to(x.dtype)
        k = rope(k, cos_b, sin_b).to(x.dtype)
        attn = attend(li, q, k, v)
        x = x + attn_out_proj(attn.reshape(rows, 1, nh * hd).to(x.dtype), lp, side, tp=shard)
        x = x + mlp_proj(_rms_norm(x, lp["post_attention_layernorm"], eps), lp, lora=side, tp=mlp_tp)
        new_k.append(k[:, 0])
        new_v.append(v[:, 0])
    logits = lm_logits(text, tcfg, _rms_norm(x, text["norm"], eps))[:, 0]
    return logits, torch.stack(new_k), torch.stack(new_v)


def _paged_one_step(params: dict, pool: PagedPool, cfg: Qwen25VLConfig, sp: SamplingParams,
                    last: torch.Tensor, start_pos: torch.Tensor, steps: torch.Tensor, live: torch.Tensor,
                    generator: Optional[torch.Generator], lora_side: Optional[tuple] = None, shard=None,
                    pick: Optional[Callable] = None) -> torch.Tensor:
    """One decode step over the paged pool → next token per slot (slots,).
    last, start_pos, steps: (slots,) long; live: (slots,) bool. Updates the
    pool in place: the new K/V of every layer at each live slot's cell
    (lengths // P, lengths % P), dead slots into scratch page 0, and
    lengths += live. lora_side, shard: as `decode_layers` (the pool then
    holds the rank's kv heads); pick: the token choice (`engine.token_pick`,
    by default over `generator` alone)."""
    tcfg = cfg.text
    nh, nkv, hd = _heads(tcfg, shard)
    G = nh // nkv
    slots, max_pages = pool.page_table.shape
    P = pool.k.shape[3]
    kv_quant = pool.k_scale is not None

    def attend(li, q, k, v):
        # the prefix over the slot's pages in place (P1/P2 on the card), then the current token
        qg = q[:, 0].reshape(slots, nkv, G, hd)
        if kv_quant:
            acc, m, l = paged_prefix_attention_q8(qg, pool.k[li], pool.v[li], pool.k_scale[li], pool.v_scale[li],
                                                  pool.page_table, pool.lengths, P)
        else:
            acc, m, l = paged_prefix_attention(qg, pool.k[li], pool.v[li], pool.page_table, pool.lengths, P)
        return combine_with_new_token(acc, m, l, qg, k[:, 0], v[:, 0])

    logits, ks, vs = decode_layers(params, cfg, last, start_pos + steps, attend, lora_side, shard)
    # one scatter of every layer's new K/V: (L, slots, Hkv, hd) → the cells
    # (L, Hkv, page, offset); dead slots write into scratch page 0
    cell = pool.lengths.long()
    page = pool.page_table.gather(1, (cell // P).clamp_max(max_pages - 1)[:, None])[:, 0].long()
    page = torch.where(live, page, 0)
    off = torch.where(live, cell % P, 0)
    if kv_quant:
        ks, ksc = quantize_kv(ks)  # scales (L, slots, Hkv)
        vs, vsc = quantize_kv(vs)
        pool.k_scale[:, :, page, off] = ksc.transpose(1, 2)
        pool.v_scale[:, :, page, off] = vsc.transpose(1, 2)
    pool.k[:, :, page, off] = ks.transpose(1, 2).to(pool.k.dtype)
    pool.v[:, :, page, off] = vs.transpose(1, 2).to(pool.v.dtype)
    pool.lengths += live.to(torch.int32)
    nxt = (pick or token_pick(generator, sp))(logits, None, last)
    return torch.where(live, nxt, cfg.pad_token_id)


class PagedDecode:
    """The paged decode's state on the device and its one step, which a
    `StepGraph` runs: eagerly on the CPU (and with capture=False), captured
    once and replayed on the card.

    `io` (6, slots) long holds, per slot, the last token, the rope position
    of the first generated token, the steps run, the active flag, the step
    budget and the done flag; `load` fills it from one host array before a
    segment (the segment's one host-to-device copy) and zeroes the column
    counter. A step reads and writes only `io`, `toks`, `col` and the pool's
    storages in place (admissions write the pool's page table and lengths in
    place too, so every replay reads the current ones). lora_side: the
    engine's side-path adapters, which the capture records (one graph a
    `generate`). shard, pick: as `_paged_one_step`; a step over a shard
    runs collectives, so it runs eagerly whatever `capture` says."""

    def __init__(self, params: dict, pool: PagedPool, cfg: Qwen25VLConfig, sp: SamplingParams, segment: int,
                 generator: Optional[torch.Generator], capture: bool = True, lora_side: Optional[tuple] = None,
                 shard=None, pick: Optional[Callable] = None):
        slots = pool.page_table.shape[0]
        dev = pool.k.device
        self.io = io = torch.zeros((6, slots), dtype=torch.long, device=dev)
        self.toks = toks = torch.zeros((slots, segment), dtype=torch.long, device=dev)
        self.col = col = torch.zeros((1,), dtype=torch.long, device=dev)
        self.segment = segment
        stop_ids = torch.tensor(sp.stop_token_ids, dtype=torch.long, device=dev)
        last, start_pos, steps, active, max_steps, done = io.unbind(0)

        def body():  # reads no `self`: no reference cycle keeps the pool and the weights alive
            # the live slots: active, not done and within their budget
            live = (active != 0) & (done == 0) & (steps < max_steps)
            nxt = _paged_one_step(params, pool, cfg, sp, last, start_pos, steps, live, generator, lora_side,
                                  shard, pick)
            done.bitwise_or_((live & is_stop(nxt, stop_ids)).long())
            last.copy_(torch.where(live, nxt, last))
            steps.add_(live.long())
            toks.index_copy_(1, col, nxt[:, None])
            col.add_(1)

        self.graph = StepGraph(body, dev, generator, capture and shard is None)

    def load(self, host: torch.Tensor) -> None:
        """Fill `io` from a (6, slots) host array (last, start_pos, steps,
        active, max_steps, done)."""
        self.io.copy_(host)
        self.col.zero_()

    def run(self) -> None:
        """One segment: `segment` steps on the device, with no host sync. Every
        step runs, even when no slot is live, as JAX's scan does."""
        self.graph.run(self.segment)


@torch.no_grad()
def paged_decode_segment(params: dict, pool: PagedPool, cfg: Qwen25VLConfig, segment: int, sp: SamplingParams,
                         last: torch.Tensor, start_pos: torch.Tensor, steps: torch.Tensor, active: torch.Tensor,
                         max_steps: torch.Tensor, generator: Optional[torch.Generator]):
    """`segment` decode steps on the device, with no host sync, run eagerly:
    each step's live slots are the active ones not done and within their
    budget (max_steps, per slot). Every step runs, even when no slot is live,
    as JAX's scan does. Returns (tokens (slots, segment), last, steps, done),
    device tensors; a dead row's token is the pad id. `PagedEngine` runs the
    same step through `PagedDecode`, captured on the card."""
    dec = PagedDecode(params, pool, cfg, sp, segment, generator, capture=False)
    done = is_stop(last, torch.tensor(sp.stop_token_ids, dtype=torch.long, device=last.device)) | ~active
    dec.load(torch.stack([last, start_pos, steps, active.long(), max_steps, done.long()]))
    dec.run()
    return dec.toks, dec.io[0].clone(), dec.io[2].clone(), dec.io[5] != 0


def row_generator(device: torch.device, seed: Optional[int], req_idx: int) -> torch.Generator:
    """The generator of request row `req_idx`'s first token (sampled from its
    prefill logits), as JAX draws it with fold_in(PRNGKey(seed), req_idx): one
    stream per row, seeded (seed · 1000003 + req_idx) mod 2**63 (seed None is
    0), so the rows of one call never share a seed."""
    mixed = ((seed if seed is not None else 0) * 1_000_003 + req_idx) % 2**63
    return torch.Generator(device=device).manual_seed(mixed)


def group_by_bucket(admits: list, on_group: Optional[Callable[[], object]], admit_group, register) -> None:
    """Admissions grouped by prompt bucket, one batched prefill per group,
    longest bucket first: `Engine._pack` pads a batch to its longest row's
    bucket, so a mixed wave (200- and 1800-token prompts together) would
    prefill every row at 2048 tokens. `on_group()` runs between groups (a
    decode segment of the slots already resident), and `register(admit,
    info)` is called per row as soon as its group's prefill lands, before the
    next group runs, so those slots are live for the segments in between."""
    groups: dict[int, list] = {}
    for a in admits:
        groups.setdefault(_bucket(len(a[2].input_ids)), []).append(a)
    for gi, bucket in enumerate(sorted(groups, reverse=True)):
        if gi and on_group is not None:
            on_group()
        group = groups[bucket]
        for a, info in zip(group, admit_group(group)):
            register(a, info)


def retire_tokens(tokens: list, sp: SamplingParams) -> list:
    """A finished slot's tokens cut at its first stop id (kept when
    sp.include_stop_token) and at max_new_tokens."""
    stop_set = set(sp.stop_token_ids)
    row = []
    for t in tokens:
        if t in stop_set:
            if sp.include_stop_token:
                row.append(t)
            break
        row.append(t)
    return row[: sp.max_new_tokens]


class PagedEngine:
    """Continuous batching over the paged pool (the semantics of
    `ContinuousEngine`; memory bounded by resident tokens).

    `timings` after `generate`: vision_s and prefill_s summed over admissions
    (prefill_s is the admissions' wall time without the segments run inside
    them), decode_s (every segment), segments and decode_steps (segments ×
    segment), interleaved_segments (segments run inside an admission), and
    admissions: one (rows, prompt bucket S, has_video) per batched prefill.

    shard: the TP engine's `ShardContext` (the module docstring). `params`
    is then the whole tree (cut and quantized as `quantization` asks) or the
    rank's serving tree (`ServingTree`, a TP `Engine`'s `params`: the eval
    hands its engine's tree over), and every rank of the model group calls
    `generate` together with the same requests."""

    def __init__(
        self,
        params: dict,
        cfg: Qwen25VLConfig,
        max_slots: int = 8,
        max_len: int = 4096,
        page_size: int = 128,
        n_pages: Optional[int] = None,
        dtype=torch.bfloat16,
        prefill_chunk_tokens: int = 8192,
        segment: int = 16,
        quantization: Optional[str] = None,  # None | "int8" | "int4" (weight-only, ops/quant.py)
        kv_cache_quant: bool = False,  # int8 pages + per-token scales
        interleave_decode: bool = True,  # decode segments between prefill chunks and groups
        device="cuda",
        shard=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.P = page_size
        self.max_pages = (max_len + page_size - 1) // page_size
        self.n_pages = n_pages or self.max_pages * max_slots
        self.dtype = dtype
        self.segment = segment
        self.kv_cache_quant = kv_cache_quant
        self.interleave_decode = interleave_decode
        self.prefill_chunk_tokens = prefill_chunk_tokens
        # the prefill (and its cache) stay in `dtype`; pages quantize at
        # write_prompt. The prefill engine quantizes the tree once (under a
        # shard it cuts it, or keeps a serving tree) and the decode shares it
        self._prefill_engine = Engine(params, cfg, dtype, prefill_chunk_tokens, device=self.device,
                                      quantization=quantization, shard=shard)
        self.params = self._prefill_engine.params
        self.timings: dict = {}

    @property
    def lora_side(self) -> Optional[tuple]:
        return self._prefill_engine.lora_side

    def set_lora_side(self, layers: Optional[list], scaling: float = 1.0) -> None:
        """Install (or clear) one set of side-path adapters for every later
        prefill and decode step, prepared by the prefill engine
        (`Engine.set_lora_side`) and read from there by the decode."""
        self._prefill_engine.set_lora_side(layers, scaling)

    def _sync(self) -> float:
        return self._prefill_engine._sync()

    def _admit_group(self, pool: PagedPool, allocator: PageAllocator, admits: list, sp: SamplingParams,
                     on_chunk=None) -> list:
        """One batched prefill for a same-bucket admission group; each row's
        KV goes into freshly allocated pages. admits: [(slot, req_idx,
        Request)] → [(first token, start_pos, pages)]. on_chunk runs between
        the prefill's chunks (the interleave)."""
        eng = self._prefill_engine
        eng.params = self.params
        reqs = [r for _, _, r in admits]
        ids, mask, pos_ids, start_pos, vis, S, _ = eng._pack(reqs, extra_len=0)
        first_logits, cache, _ = eng._prefill(ids, mask, pos_ids, vis, S, S, on_chunk=on_chunk)
        self.timings["vision_s"] += eng.timings["vision_s"]
        self.timings["admissions"].append((len(reqs), S, vis is not None))
        out = []
        like = torch.zeros((1,), dtype=torch.long, device=self.device)
        for row, (slot, req_idx, req) in enumerate(admits):
            pick = eng._pick(row_generator(self.device, sp.seed, req_idx), sp)  # under a shard rank 0's, broadcast
            first = int(pick(first_logits[row:row + 1], None, like)[0])
            L_prompt = len(req.input_ids)
            lead = S - L_prompt
            n_prompt_pages = -(-L_prompt // self.P)
            n_total = min(-(-(L_prompt + sp.max_new_tokens) // self.P), self.max_pages)
            pages = allocator.alloc(n_total)
            pad = n_prompt_pages * self.P - L_prompt  # the prompt KV right-padded to a page multiple
            k = F.pad(cache.k[:, row, lead:], (0, 0, 0, 0, 0, pad))
            v = F.pad(cache.v[:, row, lead:], (0, 0, 0, 0, 0, pad))
            table_row = np.zeros((self.max_pages,), np.int32)
            table_row[:n_total] = pages
            write_prompt(pool, slot, pages[:n_prompt_pages], table_row, k, v, L_prompt)
            out.append((first, int(start_pos[row]), pages))
        return out

    @torch.no_grad()
    def generate(self, requests, sp: SamplingParams) -> list[list[int]]:
        """Schedule every request (G = num_return_sequences rows each) through
        the pool; results in input order, row-major."""
        G = sp.num_return_sequences
        rows = [(i, r) for i, r in enumerate([r for r in requests for _ in range(G)])]
        # longest-first: admission waves become bucket-homogeneous and the
        # long-prompt tail never keeps the pool half empty at the end
        rows.sort(key=lambda t: len(t[1].input_ids), reverse=True)
        queue = deque(rows)
        n_total = len(queue)
        results: dict[int, list[int]] = {}
        stop_set = set(sp.stop_token_ids)
        dev = self.device
        self.timings = {"vision_s": 0.0, "prefill_s": 0.0, "decode_s": 0.0, "segments": 0, "decode_steps": 0,
                        "interleaved_segments": 0, "admissions": []}

        eng = self._prefill_engine
        pool = make_pool(self.cfg, self.n_pages, self.P, self.max_slots, self.max_pages, self.dtype,
                         kv_quant=self.kv_cache_quant, device=dev, shard=eng._text_shard)
        allocator = PageAllocator(self.n_pages)
        slot_req: list = [None] * self.max_slots
        slot_tokens: list[list[int]] = [[] for _ in range(self.max_slots)]
        slot_pages: list[list[int]] = [[] for _ in range(self.max_slots)]
        start_pos = np.zeros((self.max_slots,), np.int64)
        steps = np.zeros((self.max_slots,), np.int64)
        last = np.zeros((self.max_slots,), np.int64)
        gen = torch.Generator(device=dev).manual_seed(sp.seed if sp.seed is not None else 0)
        decoder = PagedDecode(self.params, pool, self.cfg, sp, self.segment, gen, capture=eng.capture,
                              lora_side=self.lora_side, shard=eng._text_shard, pick=eng._pick(gen, sp))
        admitting = False

        def retire(slot, idx):
            results[idx] = retire_tokens(slot_tokens[slot], sp)
            allocator.release(slot_pages[slot])
            slot_pages[slot] = []
            slot_req[slot] = None

        def segment_and_retire() -> bool:
            """One decode segment over the live slots, then retirement. False
            when no slot was live (nothing decoded)."""
            nonlocal last, steps
            active = np.array([slot_req[s] is not None and len(slot_tokens[s]) < sp.max_new_tokens
                               and slot_tokens[s][-1] not in stop_set for s in range(self.max_slots)])
            if not active.any():
                return False
            max_steps = np.array([sp.max_new_tokens - len(slot_tokens[s]) + steps[s] if slot_req[s] is not None
                                  else 0 for s in range(self.max_slots)], np.int64)
            t0 = self._sync()
            # done: the inactive slots (an active slot's last token is no stop id)
            decoder.load(torch.from_numpy(np.stack([last, start_pos, steps, active, max_steps, ~active])))
            decoder.run()
            # the segment's one read to the host: the tokens, then io's rows
            host = torch.cat([decoder.toks, decoder.io.t()], dim=1).cpu().numpy()
            self.timings["decode_s"] += time.perf_counter() - t0
            self.timings["segments"] += 1
            self.timings["decode_steps"] += self.segment
            self.timings["interleaved_segments"] += int(admitting)
            seg = self.segment
            toks, steps_old = host[:, :seg], steps
            last, steps, done = host[:, seg].copy(), host[:, seg + 2].copy(), host[:, seg + 5] > 0
            for slot in range(self.max_slots):
                if not active[slot]:
                    continue
                # exactly steps - steps_old real tokens were generated; the
                # rest of the row is pad (the slot went done or out of budget)
                slot_tokens[slot].extend(int(t) for t in toks[slot][: int(steps[slot] - steps_old[slot])])
                if done[slot] or len(slot_tokens[slot]) >= sp.max_new_tokens:
                    retire(slot, slot_req[slot])
            return True

        def register(admit, info):
            slot, idx, _req = admit
            first, sp0, pages = info
            slot_req[slot] = idx
            slot_pages[slot] = pages
            slot_tokens[slot] = [first]
            start_pos[slot] = sp0
            steps[slot] = 0
            last[slot] = first
            if first in stop_set:
                retire(slot, idx)

        while len(results) < n_total:
            admits = []
            for slot in range(self.max_slots):
                if slot_req[slot] is None and queue:
                    idx, req = queue.popleft()
                    if len(req.input_ids) + sp.max_new_tokens > self.max_len:
                        raise ValueError("request exceeds max_len")
                    admits.append((slot, idx, req))
            if admits:
                # resident slots decode between a long admission's prefill
                # chunks and between bucket groups (the chunked-prefill
                # interleave); each group's slots register as soon as its
                # prefill lands, so they are live for the segments after it
                on_chunk = segment_and_retire if self.interleave_decode else None
                t0, d0 = self._sync(), self.timings["decode_s"]
                admitting = True
                group_by_bucket(admits, on_chunk,
                                lambda group: self._admit_group(pool, allocator, group, sp, on_chunk), register)
                admitting = False
                self.timings["prefill_s"] += self._sync() - t0 - (self.timings["decode_s"] - d0)

            if not segment_and_retire():
                # every occupied slot already finished (stop or budget): retire
                for slot in range(self.max_slots):
                    if slot_req[slot] is not None:
                        retire(slot, slot_req[slot])
        decoder.graph.close()
        return [results[i] for i in range(n_total)]

