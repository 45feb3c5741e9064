"""Pipeline parallelism over processes (port of
`time_r1_tpu/parallel/pipeline.py`; the reference exposes it through vLLM's
--pipeline_parallel_size, vllm_infer.py:42-51).

The mesh is `make_pp_mesh(n_stages, tp)`, dims ("stage", "model"): stage s
holds the decoder layers [s·L/n, (s+1)·L/n) (`stack_stages`; L % n raises)
and, with tp > 1, the model rank's Megatron blocks of them
(`stage_tp_layers`, the rule of `sharding.serving_layer`). Each rank is one
process.

JAX runs each entry point as one SPMD program: every stage executes every
tick, the inactive ones on masked garbage, and hidden states rotate with
`ppermute`. Here the hops are real point-to-point messages
(`comm.send_next` / `recv_prev` over the stage group: staged through pinned
host memory and counted over gloo, direct over NCCL): a stage waits for its
input and computes only its own work. The tokens are the same.

- `pp_decoder_layers`: the full-sequence (no-cache) forward on the GPipe
  schedule of `n_micro` microbatches: stage s runs microbatch t − s at tick
  t, the receive of its input being the tick. Each stage runs
  `decoder_forward` over its layers, K1 carrying the attention where it is
  eligible (JAX runs `mha_reference` there: the same function). It returns
  the hidden state before the final norm, as JAX's does, on every rank (the
  last stage broadcasts it over the stage group).
- `pp_generate`: the prefill relays the prompt through the stages, each
  writing its own layers' KV cache; each decode step relays one token's
  hidden state; the last stage sends the final hidden state back to stage 0,
  which holds the embedding, the final norm and the head, samples, and
  broadcasts the token to every rank (`sampler/engine.py::token_pick`), from
  which the repetition-penalty counts are updated, as JAX's `:351-356`,
  `:385-388`. The decode is eager: its hops are collectives.
- `PPEngine`: stage 0 also holds the vision tower and the engine's
  `_pack` / `_postprocess`; G-way requests expand to G rows (no shared
  prefix across stages), as JAX's. `quantization` composes with pure PP, each
  stage quantizing its own layers (Q2 on every stage at int8); TP×PP with
  `quantization` raises JAX's ValueError.
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist

from ..models.qwen25vl.language import KVCache, _rms_norm, decoder_forward, lm_logits
from .comm import broadcast, recv_prev, send_next
from .mesh import MODEL_AXIS, STAGE_AXIS, make_pp_mesh, mesh_size, model_group, stage_group
from .sharding import ShardContext, _map, serving_context, serving_layer

__all__ = ["PPEngine", "make_pp_mesh", "pp_decoder_layers", "pp_generate", "stack_stages", "stage_tp_layers"]


def stack_stages(layers: list, n_stages: int) -> list:
    """The decoder's per-layer list cut into n_stages contiguous groups
    (JAX's `_stack_stages`: (L, …) → (n_stages, L/n_stages, …)). Raises
    ValueError when n_stages does not divide L."""
    L = len(layers)
    if n_stages < 1 or L % n_stages:
        raise ValueError(f"pipeline_parallel_size={n_stages} does not divide the {L} decoder layers")
    per = L // n_stages
    return [layers[s * per:(s + 1) * per] for s in range(n_stages)]


@torch.no_grad()
def stage_tp_layers(layers: list, tp: int = 1, model_rank: int = 0, bits: int = 0, device=None) -> list:
    """A stage's whole layers as model rank `model_rank` of `tp` holds them
    (JAX's `_stage_tp_specs`): with tp > 1 the Megatron blocks of
    `sharding.serving_layer` (PPEngine refuses quantization there, as JAX
    does); with tp 1 the layers as they are, or quantized and fused at
    `bits` (`ops/quant.py::quantize_layer`, as the engines' decode tree).
    Each leaf goes to `device`."""
    from ..ops.quant import quantize_layer

    if tp > 1:
        return [serving_layer(lp, tp, model_rank, bits, device) for lp in layers]
    out = []
    for lp in layers:
        lp = {k: v.detach().to(device if device is not None else v.device) for k, v in lp.items()}
        out.append(quantize_layer(lp, bits=bits, fuse=True) if bits else lp)
    return out


def stage_context(mesh, layers: list) -> Optional[ShardContext]:
    """The ShardContext a stage's decoder takes over its layers: the mesh's
    model group and this rank's place in it (None at tp 1)."""
    tp = mesh_size(mesh, MODEL_AXIS)
    if tp == 1:
        return None
    return serving_context(ShardContext(None, model_group(mesh), 1, tp, 0, mesh.get_local_rank(MODEL_AXIS), None),
                           layers)


def _stage(mesh) -> tuple[int, int]:
    return mesh.get_local_rank(STAGE_AXIS), mesh_size(mesh, STAGE_AXIS)


@torch.no_grad()
def pp_decoder_layers(
    layers: list,  # every decoder layer of the model (whole), the same on every rank
    cfg,  # TextConfig
    embeds: torch.Tensor,  # (B, S, H): embeddings (vision already merged), the same on every rank
    position_ids: torch.Tensor,  # (3, B, S)
    attention_mask: torch.Tensor,  # (B, S)
    mesh,  # make_pp_mesh(n_stages, tp)
    n_micro: int,
) -> torch.Tensor:
    """All decoder layers on the GPipe schedule over the mesh's stages;
    returns the hidden state (B, S, H) BEFORE the final norm (the caller
    applies the norm and the head), the same on every rank. B must divide
    into n_micro microbatches and L into the stages."""
    s, n = _stage(mesh)
    B, S, H = embeds.shape
    if B % n_micro:
        raise ValueError(f"{B} rows do not divide into {n_micro} microbatches")
    mb = B // n_micro
    per = len(layers) // n
    own = stage_tp_layers(stack_stages(layers, n)[s], mesh_size(mesh, MODEL_AXIS),
                          mesh.get_local_rank(MODEL_AXIS), device=embeds.device)
    ctx, group = stage_context(mesh, own), stage_group(mesh)
    outs = []
    for i in range(n_micro):  # tick t = i + s: microbatch i reaches stage s after s hops
        rows = slice(i * mb, (i + 1) * mb)
        h = embeds[rows] if s == 0 else recv_prev(embeds[rows], group)
        h, _ = decoder_forward({"layers": own}, cfg, h, position_ids[:, rows], attention_mask=attention_mask[rows],
                               shard=ctx, layer_offset=s * per, final_norm=False)
        if s < n - 1:
            send_next(h, group)
        else:
            outs.append(h)  # the last stage banks its finished microbatch
    out = torch.cat(outs) if s == n - 1 else torch.empty((B, S, H), dtype=embeds.dtype, device=embeds.device)
    return broadcast(out.contiguous(), n - 1, group)


@torch.no_grad()
def pp_generate(
    stage: dict,  # {"layers": this stage's layers (stage_tp_layers)}
    other: Optional[dict],  # stage 0: the text params but the layers (embedding, norm, head); else None
    cfg,  # Qwen25VLConfig
    embeds: Optional[torch.Tensor],  # stage 0: (B, S, H) embeddings, vision merged; else None
    pos_ids: torch.Tensor,  # (3, B, S) on every rank
    mask: torch.Tensor,  # (B, max_len): 1 for prompt tokens and decode slots
    start_pos: torch.Tensor,  # (B,) rope position of the first generated token
    sp,  # SamplingParams
    generator: Optional[torch.Generator],
    pick,  # the token choice: sampler.engine.token_pick over the whole group (PPEngine._pick)
    mesh,  # make_pp_mesh(n_stages, tp)
    max_len: int,
    dtype=torch.bfloat16,
    timings: Optional[dict] = None,  # filled with prefill_s, decode_s, decode_steps
) -> torch.Tensor:
    """Generate sp.max_new_tokens over the mesh's stages; returns (B,
    max_new) token ids (pad after stop), the same on every rank. Every rank
    calls it together with the same positions and mask (see the module).
    Global rank 0 (model rank 0 of stage 0) samples (`pick`)."""
    from ..sampler.engine import _run_decode_loop

    tcfg = cfg.text
    s, n = _stage(mesh)
    group = stage_group(mesh)
    device = pos_ids.device
    B, S = pos_ids.shape[1:]
    H = tcfg.hidden_size
    per = tcfg.num_hidden_layers // n
    own = stage["layers"]
    ctx = stage_context(mesh, own)
    cache = KVCache.zeros(tcfg, B, max_len, dtype=dtype, device=device, shard=ctx, layers=len(own))

    def relay(h: Optional[torch.Tensor], pos: torch.Tensor, cache: KVCache, C: int):
        """One C-token chunk through every stage: stage s waits for s − 1,
        writes its layers' cache, and passes on; the last stage's output
        goes back to stage 0, which returns it (the others return None)."""
        like = torch.empty((B, C, H), dtype=dtype, device=device)
        if s > 0:
            h = recv_prev(like, group)
        h, cache = decoder_forward(stage, tcfg, h, pos, attention_mask=mask, cache=cache, shard=ctx,
                                   layer_offset=s * per, final_norm=False)
        if n > 1:
            send_next(h, group)
            h = recv_prev(like, group) if s == 0 else None
        return h, cache

    def head(h: torch.Tensor) -> torch.Tensor:
        return lm_logits(other, tcfg, _rms_norm(h, other["norm"], tcfg.rms_norm_eps))[:, -1]

    t0 = _synced(device)
    h, cache = relay(embeds if s == 0 else None, pos_ids, cache, S)
    first = head(h) if s == 0 else None
    t1 = _synced(device)
    cache = cache.with_device_length()

    def step_fn(last: torch.Tensor, pos3: torch.Tensor):
        x = None
        if s == 0:
            from ..ops.quant import embed_lookup

            x = embed_lookup(other["embed_tokens"], last[:, None], dtype=other["norm"].dtype)
        h, _ = relay(x, pos3, cache, 1)
        return head(h) if s == 0 else None

    tokens, steps = _run_decode_loop(cfg, first, start_pos, sp, generator, step_fn, False, pick)
    if timings is not None:
        timings.update(prefill_s=t1 - t0, decode_s=_synced(device) - t1, decode_steps=steps)
    return tokens


def _synced(device) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class PPEngine:
    """Generation over a (stage, model) mesh (vLLM's PP serving: each rank
    holds L/n_stages decoder layers, or its TP blocks of them, and their KV
    cache). Stage 0 holds the embedding, the final norm, the head and the
    vision tower whole; the other stages hold only their layers. Request
    semantics match `sampler.Engine.generate`; every rank of the mesh calls
    `generate` together with the same requests and gets the same tokens.

    `params` is the whole tree (on any device); each rank keeps its part on
    `device`. `mesh`: an existing `make_pp_mesh(n_stages, tp)` (default: one
    over the process group). TP×PP with `quantization` raises JAX's
    ValueError, as does a tp that does not divide the kv heads or the q
    heads (JAX's assertion, `time_r1_tpu/parallel/pipeline.py:460-463`: no
    kv-head replication inside a stage, ROADMAP §C); a tp that does not
    divide the vision's heads raises NotImplementedError (A13,
    `parallel/tensor.py::check_heads`)."""

    def __init__(self, params: dict, cfg, n_stages: int, dtype=torch.bfloat16, tp: int = 1,
                 quantization: str = "", device="cuda", mesh=None):
        from ..device import resolve_device
        from ..ops.quant import QBITS, quantize_text_params
        from ..sampler.engine import Engine
        from .tensor import check_heads

        stack_stages(params["text"]["layers"], n_stages)  # L % n_stages raises
        if quantization and tp > 1:
            raise ValueError(
                "TP×PP with --quantization is unsupported: the quantized decode tree fuses qkv/gate-up columns, "
                "which cannot be contiguously column-split over the model axis"
            )
        nh, nkv = cfg.text.num_attention_heads, cfg.text.num_key_value_heads
        if tp > 1 and (nkv % tp or nh % tp):
            raise ValueError(f"TP×PP needs num_key_value_heads % tp == 0 and num_attention_heads % tp == 0 (whole "
                             f"GQA groups a rank inside a stage): num_key_value_heads={nkv}, "
                             f"num_attention_heads={nh}, tp={tp}")
        check_heads(cfg, tp)
        self.device = resolve_device(device)
        self.cfg, self.dtype = cfg, dtype
        self.mesh = mesh if mesh is not None else make_pp_mesh(n_stages, tp)
        self.n_stages, self.tp = n_stages, tp
        self.stage, _ = _stage(self.mesh)
        bits = QBITS[quantization] if quantization else 0
        own = stack_stages(params["text"]["layers"], n_stages)[self.stage]
        self.stage_params = {"layers": stage_tp_layers(own, tp, self.mesh.get_local_rank(MODEL_AXIS), bits,
                                                       self.device)}
        self.params = None  # stage 0: the vision tower and the text params but the layers
        if self.stage == 0:
            with torch.no_grad():
                text = {k: v.detach().to(self.device) for k, v in params["text"].items() if k != "layers"}
                text = quantize_text_params(dict(text, layers=[]), bits=bits) if bits else text
                visual = _map(params["visual"], lambda path, x: x.detach().to(self.device))
            self.params = {"visual": visual, "text": text}
        # _pack / _vision / _postprocess; it never touches the layers
        self._packer = Engine(self.params or {}, cfg, dtype, device=self.device)
        self.timings: dict = {}

    @torch.no_grad()
    def generate(self, requests, sp) -> list[list[int]]:
        from ..models.qwen25vl.model import merge_vision_embeddings
        from ..ops.quant import embed_lookup

        G = sp.num_return_sequences
        reqs = [r for r in requests for _ in range(G)]
        ids, mask, pos_ids, start_pos, vis, S, max_len = self._packer._pack(
            reqs, extra_len=sp.max_new_tokens, with_vision=self.stage == 0)
        dev = self.device
        t0 = _synced(dev)
        embeds = None
        if self.stage == 0:
            ids_t = torch.from_numpy(ids).to(dev)
            embeds = embed_lookup(self.params["text"]["embed_tokens"], ids_t, dtype=self.dtype)
            if vis is not None:
                feats = self._packer._vision(vis)
                embeds = merge_vision_embeddings(embeds, ids_t, feats,
                                                 (self.cfg.video_token_id, self.cfg.image_token_id))
        t1 = _synced(dev)
        gen = torch.Generator(device=dev).manual_seed(sp.seed if sp.seed is not None else 0)
        self.timings = {"vision_s": t1 - t0}
        tokens = pp_generate(
            self.stage_params, None if self.params is None else self.params["text"], self.cfg, embeds,
            torch.from_numpy(pos_ids).to(dev), torch.from_numpy(mask).to(dev),
            torch.from_numpy(start_pos).to(dev).long(), sp, gen, self._pick(gen, sp), self.mesh, max_len, self.dtype,
            self.timings,
        )
        return self._packer._postprocess(tokens.cpu().numpy(), len(reqs), sp)

    def _pick(self, gen: torch.Generator, sp):
        """The decode's token choice: global rank 0 samples and broadcasts
        (`sampler.engine.token_pick`)."""
        from ..sampler.engine import token_pick

        return token_pick(gen, sp, dist.group.WORLD)
