"""Continuous batching over a pool of contiguous slot caches (port of
`time_r1_tpu/sampler/continuous.py`).

The bucket `Engine` pads every request to the longest prompt and waits for
the slowest row. This engine keeps a fixed pool of slots over one static KV
cache (L, max_slots, max_len, Hkv, hd) and schedules at iteration level:

- a host queue feeds free slots; each admission wave runs one batched prefill
  per prompt bucket and copies each row's KV into its slot's rows;
- decode runs in segments of `segment` steps on the device with no host sync
  (per-slot lengths, positions and done flags stay device tensors, with a
  per-slot length bias on the cache), then the host reads the segment's
  tokens once, retires finished slots and admits new requests.

Each step's attention is `mha_cached` over the slot's contiguous cache, plain
torch, as the JAX package computes it outside any Pallas kernel; the current
token rides in registers and every layer's new K/V land in one scatter per
step. The cache is in the engine's dtype only (no int8 KV, as in JAX); the
weights may be quantized (`quantization`). The state is updated in place
(JAX donates and replaces it). Same request and response semantics as
`Engine.generate` (stop ids, include-stop).

Tensor parallelism (`shard=`): as `sampler/paged.py`'s, over slot caches of
the rank's kv heads; the attention stays `mha_cached` at the local heads.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.qwen25vl import Qwen25VLConfig
from ..models.qwen25vl.language import _heads
from ..ops.attention import NEG_INF, mha_cached
from .engine import Engine, Request, token_pick
from .paged import decode_layers, group_by_bucket, retire_tokens, row_generator
from .params import SamplingParams


@dataclass
class SlotState:
    k: torch.Tensor  # (L, slots, max_len, Hkv, hd), the rank's Hkv under a shard
    v: torch.Tensor
    lengths: torch.Tensor  # (slots,) long: written kv length per slot
    last: torch.Tensor  # (slots,) long: last token
    start_pos: torch.Tensor  # (slots,) long: rope position of the first generated token
    done: torch.Tensor  # (slots,) bool
    steps: torch.Tensor  # (slots,) long: decode steps run


@torch.no_grad()
def decode_segment(params: dict, state: SlotState, cfg: Qwen25VLConfig, segment: int, sp: SamplingParams,
                   generator: Optional[torch.Generator], active: torch.Tensor,
                   max_steps: torch.Tensor, shard=None, pick: Optional[Callable] = None) -> torch.Tensor:
    """`segment` decode steps for the active slots (bool (slots,)) within
    their budgets (max_steps, per slot), on the device and in place on
    `state`. Returns the tokens (slots, segment): the pad id where a slot was
    not live. shard: as `paged.decode_layers`; pick: the token choice
    (`engine.token_pick`, by default over `generator` alone)."""
    pick = pick or token_pick(generator, sp)
    slots, max_len = state.k.shape[1], state.k.shape[2]
    dev = state.k.device
    stop_ids = torch.tensor(sp.stop_token_ids, dtype=torch.long, device=dev)
    kv_pos = torch.arange(max_len, device=dev)[None, :]
    rows = torch.arange(slots, device=dev)
    bias_new = torch.zeros((slots, 1, 1, 1), dtype=torch.float32, device=dev)
    toks = []
    for _ in range(segment):
        live = active & ~state.done & (state.steps < max_steps)
        # prefix-only bias (strict <): the current token rides mha_cached's
        # in-register path, so the cache is written once per step, below
        bias_old = torch.where(kv_pos < state.lengths[:, None], 0.0, NEG_INF).float()[:, None, None, :]

        def attend(li, q, k, v):
            return mha_cached(q, state.k[li].to(q.dtype), state.v[li].to(q.dtype), k, v, bias_old, bias_new)

        logits, ks, vs = decode_layers(params, cfg, state.last, state.start_pos + state.steps, attend, shard=shard)
        # one scatter of every layer's new K/V at each slot's write column
        state.k[:, rows, state.lengths] = ks.to(state.k.dtype)
        state.v[:, rows, state.lengths] = vs.to(state.v.dtype)
        nxt = torch.where(live, pick(logits, None, state.last), cfg.pad_token_id)
        state.done = state.done | (live & torch.isin(nxt, stop_ids))
        state.lengths = state.lengths + live.long()
        state.last = torch.where(live, nxt, state.last)
        state.steps = state.steps + live.long()
        toks.append(nxt)
    return torch.stack(toks, dim=1)


class ContinuousEngine:
    """Iteration-level scheduler over a slot pool.

    `timings` after `generate`, as `PagedEngine.timings`: vision_s,
    prefill_s, decode_s, segments, decode_steps, interleaved_segments (here
    the segments run between the bucket groups of a wave) and admissions.

    shard: the TP engine's `ShardContext`; `params` as `PagedEngine`'s."""

    def __init__(
        self,
        params: dict,
        cfg: Qwen25VLConfig,
        max_slots: int = 8,
        max_len: int = 4096,
        segment: int = 16,
        dtype=torch.bfloat16,
        prefill_chunk_tokens: int = 8192,
        quantization: Optional[str] = None,  # None | "int8" | "int4" (weight-only, ops/quant.py)
        device="cuda",
        shard=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.segment = segment
        self.dtype = dtype
        # the bucket engine prefills the admissions; it quantizes the tree
        # once (under a shard it cuts it, or keeps a serving tree) and the
        # decode shares it
        self._prefill_engine = Engine(params, cfg, dtype, prefill_chunk_tokens, device=self.device,
                                      quantization=quantization, shard=shard)
        self.params = self._prefill_engine.params
        self.timings: dict = {}

    def _sync(self) -> float:
        return self._prefill_engine._sync()

    def _admit_group(self, state: SlotState, admits: list, sp: SamplingParams) -> list:
        """One batched prefill for a same-bucket admission group, each row's
        KV copied into its slot. admits: [(slot, req_idx, Request)] → [first token]."""
        eng = self._prefill_engine
        eng.params = self.params
        reqs = [r for _, _, r in admits]
        ids, mask, pos_ids, start_pos, vis, S, _ = eng._pack(reqs, extra_len=0)
        first_logits, cache, _ = eng._prefill(ids, mask, pos_ids, vis, S, S)
        self.timings["vision_s"] += eng.timings["vision_s"]
        self.timings["admissions"].append((len(reqs), S, vis is not None))
        firsts = []
        like = torch.zeros((1,), dtype=torch.long, device=self.device)
        for row, (slot, req_idx, req) in enumerate(admits):
            pick = eng._pick(row_generator(self.device, sp.seed, req_idx), sp)  # under a shard rank 0's, broadcast
            first = int(pick(first_logits[row:row + 1], None, like)[0])
            L_prompt = len(req.input_ids)
            lead = S - L_prompt  # left padding in the batched prefill cache
            state.k[:, slot, :L_prompt] = cache.k[:, row, lead:].to(state.k.dtype)
            state.v[:, slot, :L_prompt] = cache.v[:, row, lead:].to(state.v.dtype)
            state.lengths[slot] = L_prompt
            state.last[slot] = first
            state.start_pos[slot] = int(start_pos[row])
            state.done[slot] = False
            state.steps[slot] = 0
            firsts.append(first)
        return firsts

    @torch.no_grad()
    def generate(self, requests: Sequence[Request], sp: SamplingParams) -> list[list[int]]:
        """Schedule all requests through the slot pool; results in input order."""
        G = sp.num_return_sequences
        rows = [(i, r) for i, r in enumerate([r for r in requests for _ in range(G)])]
        rows.sort(key=lambda t: len(t[1].input_ids), reverse=True)  # longest first, as PagedEngine
        queue = deque(rows)
        n_total = len(queue)
        results: dict[int, list[int]] = {}
        stop_set = set(sp.stop_token_ids)
        dev = self.device
        self.timings = {"vision_s": 0.0, "prefill_s": 0.0, "decode_s": 0.0, "segments": 0, "decode_steps": 0,
                        "interleaved_segments": 0, "admissions": []}

        tcfg, eng = self.cfg.text, self._prefill_engine
        shape = (tcfg.num_hidden_layers, self.max_slots, self.max_len, _heads(tcfg, eng._text_shard)[1], tcfg.head_dim)
        n = self.max_slots
        state = SlotState(
            k=torch.zeros(shape, dtype=self.dtype, device=dev),
            v=torch.zeros(shape, dtype=self.dtype, device=dev),
            lengths=torch.zeros((n,), dtype=torch.long, device=dev),
            last=torch.zeros((n,), dtype=torch.long, device=dev),
            start_pos=torch.zeros((n,), dtype=torch.long, device=dev),
            done=torch.ones((n,), dtype=torch.bool, device=dev),
            steps=torch.zeros((n,), dtype=torch.long, device=dev),
        )
        slot_req: list = [None] * n  # request index per slot
        slot_tokens: list[list[int]] = [[] for _ in range(n)]
        gen = torch.Generator(device=dev).manual_seed(sp.seed if sp.seed is not None else 0)
        pick = eng._pick(gen, sp)
        admitting = False

        def register(admit, first):
            slot, idx, _req = admit
            slot_req[slot] = idx
            slot_tokens[slot] = [first]
            if first in stop_set:  # finished at its very first token
                results[idx] = [first] if sp.include_stop_token else []
                slot_req[slot] = None
                state.done[slot] = True

        def run_segment():
            """One decode segment over the occupied slots, then retirement;
            nothing when no slot is occupied."""
            occupied = [slot_req[s] is not None for s in range(n)]
            if not any(occupied):
                return
            active = torch.tensor(occupied, device=dev)
            max_steps = torch.tensor([sp.max_new_tokens - 1 if o else 0 for o in occupied], dtype=torch.long,
                                     device=dev)
            t0 = self._sync()
            steps_before = state.steps.clone()
            toks = decode_segment(self.params, state, self.cfg, self.segment, sp, gen, active, max_steps,
                                  shard=eng._text_shard, pick=pick)
            # the segment's one read to the host
            host = torch.cat([toks, (state.steps - steps_before)[:, None], state.done[:, None].long()],
                             dim=1).cpu().numpy()
            self.timings["decode_s"] += time.perf_counter() - t0
            self.timings["segments"] += 1
            self.timings["decode_steps"] += self.segment
            self.timings["interleaved_segments"] += int(admitting)
            for slot in range(n):
                idx = slot_req[slot]
                if idx is None:
                    continue
                # exactly n_new real tokens were generated this segment; the
                # rest is pad (the slot went done or out of budget), never
                # appended, even when the pad id is itself a stop id
                n_new = int(host[slot, -2])
                slot_tokens[slot].extend(int(t) for t in host[slot, :n_new])
                if host[slot, -1] or len(slot_tokens[slot]) >= sp.max_new_tokens:
                    results[idx] = retire_tokens(slot_tokens[slot], sp)
                    slot_req[slot] = None

        while len(results) < n_total:
            admits = []
            for slot in range(n):
                if slot_req[slot] is None and queue:
                    idx, req = queue.popleft()
                    if len(req.input_ids) + sp.max_new_tokens > self.max_len:
                        raise ValueError(
                            f"request length {len(req.input_ids)}+{sp.max_new_tokens} exceeds max_len {self.max_len}"
                        )
                    admits.append((slot, idx, req))
            if admits:
                # one batched prefill per bucket group; resident slots decode between groups
                t0, d0 = self._sync(), self.timings["decode_s"]
                admitting = True
                group_by_bucket(admits, run_segment, lambda group: self._admit_group(state, group, sp), register)
                admitting = False
                self.timings["prefill_s"] += self._sync() - t0 - (self.timings["decode_s"] - d0)
            run_segment()
        return [results[i] for i in range(n_total)]
