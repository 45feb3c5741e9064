"""GRPO loss and train step (port of `time_r1_tpu/rl/grpo.py`).

Semantics are the JAX package's:
- G rollouts per prompt; the completion mask covers everything up to and
  including the first EOS;
- per-token log-probs and full-distribution entropy, computed in 128-token
  chunks so the (B, Lc, V) f32 logits never exist at once;
- KL to a reference model: exp(Δ) − Δ − 1 with Δ = ref_logp − logp, weight β;
- group-normalised advantages (r − μ_G) / (σ_G + 1e-4) with the unbiased std;
- two reductions: use_grpo=True is vanilla GRPO (per-sequence token mean, then
  batch mean); use_grpo=False is PPO-clip with ε = 0.2 and a global token
  mean. Both use the ratio exp(logp − stop_grad(logp)).

Two batch layouts. The split batch (`GRPOSplitBatch`, the trainer's default)
runs the prompt once per prompt through the differentiable prompt forward (K1
forward, B1/B2 backward on the card) and each rollout row only its completion
chunk over the shared prefix (S1 forward, S2 + B2 backward). The full-row
batch (`GRPOBatch`, `shared_prefix_loss=False`) runs every row's prompt and
completion through the decoder with the padding mask as K1's key bias (B1/B2
backward) and reads the log-probs of tokens 1.. from positions ..T-2; both
give the same loss and gradients.

LoRA (`make_lora_train_step`): the base stays frozen and only the adapter
tree (`rl/lora.py`) is differentiated and updated. The decoder's adapters
merge inside each layer function and the ViT's inside each block (`lora=`
of the loss functions, an `Adapters`), so one layer's merged weights exist
at a time, also over an int8 base, whose quantized head carries the
gradient into the hidden states (`ops/quant.py::head_logits`). Under
context parallelism every adapter merges into the base before the loss, as
JAX's step does (`time_r1_tpu/rl/grpo.py:507-510`): the ring decoder takes
no `lora=`.

Across ranks (`parallel/`): `group=` is the data-parallel group whose ranks
each hold their own rows; `cp=` (a `parallel.ContextParallel`) splits the
sequence of full rows that every rank of its group holds alike, the decoder on
ring attention. Either way a rank's loss covers its own tokens over the
GLOBAL normalizer (PPO-clip: the token count of the whole batch, `grpo.py:386`
in JAX; GRPO: the row count, `:380`), so the gradients summed over the ranks
(`grpo_value_and_grad`, before the clip) are the whole batch's, as are the
metrics, which are reduced there too.

Sharded (`shard=`, a `parallel/sharding.py::ShardContext` over the params,
whose leaves are this rank's blocks): every forward gathers each layer's
FSDP shards just before use and runs the rank's heads and MLP width
(`models/qwen25vl/language.py`, `vision.py`); the embedding and the head are
gathered whole once a loss (`model.text_ends`). The gradients come back as
blocks: the data-sharded ones reduce-scattered in the backward, the others
all-reduced over the data group after it; nothing is summed over "model".
The vision tower's gathers (and, where it trains, its reduce-scatters) are
collectives of the data group: a rank whose batch has no video in a step
where another's has runs the tower on a placeholder (`align_vision`). LoRA
over sharded params keeps the adapters whole on every rank: each layer
merges the part of them that its blocks need, and their gradients are
summed over the data group, and over the model group where the base leaf
is cut over it (`lora_value_and_grad`).

`gradient_checkpointing` (False, True/"full", "dots", "dots_small") makes
each decoder layer of both differentiated forwards one checkpointed unit
(`models/qwen25vl/language.py::REMAT_POLICIES`): the backward reruns the
layer's K1 or S1 forward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models.qwen25vl import Qwen25VLConfig, VisionInputs
from ..models.qwen25vl.language import NEG_INF, KVCache, decoder_forward, shared_decode_forward
from ..models.qwen25vl.model import merge_vision_embeddings, text_ends
from ..models.qwen25vl.vision import vision_blocks_forward, vision_forward, vision_merge_forward
from ..ops.quant import embed_lookup, head_logits
from ..parallel.comm import all_reduce_sum
from ..parallel.mesh import DATA_AXIS
from ..parallel.sharding import global_sq_sum


@dataclass(frozen=True)
class GRPOHyperParams:
    num_generations: int = 8
    beta: float = 0.04
    epsilon_low: float = 0.2
    epsilon_high: float = 0.2
    use_grpo: bool = False  # False → PPO-clip (the reference's default path)
    logp_chunk: int = 128  # sequence chunk of the log-softmax
    fix_vit: bool = True  # freeze the ViT except the merger
    gradient_checkpointing: object = False  # remat per decoder layer: False, True/"full", "dots", "dots_small"


class GRPOBatch(NamedTuple):
    """Full-row train batch (B = prompts·G rows, group-major): each row is its
    prompt, left-padded so that a group's prompts end together, followed by
    one completion."""

    input_ids: torch.Tensor  # (B, T) prompt + completion
    position_ids: torch.Tensor  # (3, B, T)
    attention_mask: torch.Tensor  # (B, T) 1 for real tokens
    completion_mask: torch.Tensor  # (B, T) 1 on completion tokens up to and including the first EOS
    advantages: torch.Tensor  # (B,) f32
    vision: Optional[VisionInputs]  # the unique videos' patches, one copy per video
    ref_logps: Optional[torch.Tensor]  # (B, T-1) or None
    feat_offsets: Optional[torch.Tensor] = None  # (B,) first feature row per row (0 for text-only rows)
    vision_hidden: Optional[torch.Tensor] = None  # fix_vit: pre-merger hidden states


class GRPOSplitBatch(NamedTuple):
    """Shared-prefix train batch: prompts and completions split, so the loss
    runs each prompt once (P rows) and only the completion chunk per rollout
    row (B = P·G rows, row-major by prompt)."""

    prompt_ids: torch.Tensor  # (P, Lp) left-padded (last real token at Lp-1)
    prompt_pos: torch.Tensor  # (3, P, Lp)
    prompt_mask: torch.Tensor  # (P, Lp) 1 for real prompt tokens
    comp_ids: torch.Tensor  # (B, Lc) right-padded completion tokens
    comp_pos: torch.Tensor  # (3, B, Lc)
    comp_mask: torch.Tensor  # (B, Lc) 1 up to and including the first EOS
    advantages: torch.Tensor  # (B,) f32
    vision: Optional[VisionInputs]  # the unique videos' patches, one copy per video
    ref_logps: Optional[torch.Tensor]  # (B, Lc) or None
    feat_offsets: Optional[torch.Tensor] = None  # (P,) first feature row per prompt
    vision_hidden: Optional[torch.Tensor] = None  # fix_vit: pre-merger hidden states


def compute_group_advantages(rewards: np.ndarray, num_generations: int) -> np.ndarray:
    """(r − group mean) / (group std + 1e-4), with the unbiased (ddof=1) std."""
    r = np.asarray(rewards, np.float32).reshape(-1, num_generations)
    mean = r.mean(axis=1, keepdims=True)
    std = r.std(axis=1, ddof=1, keepdims=True)
    return ((r - mean) / (std + 1e-4)).reshape(-1)


class Adapters(NamedTuple):
    """The loss's LoRA adapters (`rl/lora.py`), each merged inside its own
    layer function: the decoder layers' (one dict a layer, or None) and the
    ViT blocks' (one dict a block, or None: fix_vit leaves none), with their
    scaling."""

    layers: Optional[list]
    scaling: float
    blocks: Optional[list] = None


def _text_lora(lora) -> Optional[tuple]:
    """The decoder's (layers, scaling) of a `lora=` argument, or None."""
    return None if lora is None or lora.layers is None else (lora.layers, lora.scaling)


def _vision_lora(lora) -> Optional[tuple]:
    """The ViT blocks' (blocks, scaling) of a `lora=` argument, or None."""
    return None if lora is None or lora.blocks is None else (lora.blocks, lora.scaling)


def _at(shard, key: str):
    return None if shard is None else shard.at(key)


def _vision_feats(params: dict, cfg: Qwen25VLConfig, batch, fix_vit: bool, shard=None, lora=None) -> torch.Tensor:
    """Merged vision features for the loss. With `vision_hidden` (the frozen
    blocks' output, precomputed or captured by the rollout) only the trainable
    merger runs here. Otherwise fix_vit runs the blocks without a graph (they
    get no gradient, K2/K3 carry their attention) and the merger with one;
    without fix_vit the whole tower is differentiated, off K2/K3 (they have no
    backward), as JAX's `_vision_feats` passes use_window_kernel=fix_vit, and
    the blocks' adapters (lora, as `grpo_loss`'s) merge inside each block."""
    if fix_vit:
        batch = precompute_frozen_vision(params, cfg, batch, shard)
    v = batch.vision
    if batch.vision_hidden is not None:
        return vision_merge_forward(params["visual"], cfg.vision, batch.vision_hidden, v.reverse,
                                    shard=_at(shard, "visual"))
    return vision_forward(params["visual"], cfg.vision, v.patches, v.perm, v.pos_hw, v.key_valid,
                          v.full_gather, v.full_inverse, v.reverse, use_window_kernel=fix_vit,
                          shard=_at(shard, "visual"), lora=_vision_lora(lora))


def precompute_frozen_vision(params: dict, cfg: Qwen25VLConfig, batch, shard=None):
    """fix_vit: run the frozen ViT blocks once, without a graph (K2/K3 on the
    card), and attach their output to the batch; the policy and ref forwards
    then run only the merger. shard: over sharded params, every data rank
    calls it together (the blocks' gathers are collectives)."""
    if batch.vision is None or batch.vision_hidden is not None:
        return batch
    v = batch.vision
    with torch.no_grad():
        x = vision_blocks_forward(params["visual"], cfg.vision, v.patches, v.perm, v.pos_hw,
                                  v.key_valid, v.full_gather, v.full_inverse, use_window_kernel=True,
                                  shard=_at(shard, "visual"))
    return batch._replace(vision_hidden=x)


PLACEHOLDER_GRID = (1, 2, 2)  # the smallest grid the tower takes: one temporal patch, one 2x2 merge unit


def placeholder_vision(cfg: Qwen25VLConfig, device) -> VisionInputs:
    """Vision inputs of one zero video of `PLACEHOLDER_GRID` (one merge unit,
    padded to one attention window): what a rank with no video runs the
    tower on when another data rank's batch has video (`align_vision`)."""
    from ..models.qwen25vl.vision import prepare_vision_inputs

    t, h, w = PLACEHOLDER_GRID
    patches = torch.zeros((t * h * w, cfg.vision.patch_input_dim), dtype=torch.float32, device=device)
    return VisionInputs.build(prepare_vision_inputs([PLACEHOLDER_GRID], cfg.vision), patches)


def align_vision(cfg: Qwen25VLConfig, batch, shard):
    """The batch as this rank's vision tower must run it. Over sharded params
    the data ranks run the tower's gathers together, and its reduce-scatters
    in the backward where it trains: a rank whose batch has no video, in a
    step where another data rank's has, gets a placeholder video
    (`placeholder_vision`). Its batch has no vision token, so the placeholder's
    features replace no embedding (`merge_vision_embeddings` selects none of
    them): they enter the loss multiplied by 0 and add 0 to every gradient,
    while the tower's collectives fire in the same order as on the other
    ranks. Each rank keeps its own videos; JAX unions them
    (`time_r1_tpu/rl/trainer.py::_global_vision`), which gives the same
    results, since a video's features do not depend on the others' (ROADMAP
    §C). Every data rank calls this together (it is an all-reduce)."""
    if shard is None or shard.dp == 1:
        return batch
    dev = batch.advantages.device
    has = torch.tensor([float(batch.vision is not None)], device=dev)
    all_reduce_sum([has], shard.data_group)
    if batch.vision is None and float(has[0]) > 0:
        return batch._replace(vision=placeholder_vision(cfg, dev))
    return batch


def _merged_embeds(params: dict, cfg: Qwen25VLConfig, batch, ids: torch.Tensor, fix_vit: bool, emb=None,
                   shard=None, lora=None) -> torch.Tensor:
    """The token embeddings of `ids` (from `emb`, the gathered table, or the
    params' own) with the batch's vision features merged at its vision
    tokens, from each row's feature offset."""
    embeds = embed_lookup(params["text"]["embed_tokens"] if emb is None else emb, ids)
    if batch.vision is None:
        return embeds
    feats = _vision_feats(params, cfg, batch, fix_vit, shard, lora)
    return merge_vision_embeddings(
        embeds, ids, feats, (cfg.video_token_id, cfg.image_token_id),
        feature_offset=batch.feat_offsets if batch.feat_offsets is not None else 0,
    )


def _hidden_states(params: dict, cfg: Qwen25VLConfig, batch: GRPOBatch, remat=False, fix_vit: bool = False,
                   lora: Optional[Adapters] = None, cp=None, shard=None, emb=None) -> torch.Tensor:
    """Full rows: embed, merge the vision features, run the decoder over the
    rows with the padding mask (K1 on the card, B1/B2 in its backward) → the
    final hidden states (B, T, H).

    cp (a `parallel.ContextParallel`): the vision tower and the embed/merge
    run whole on every rank; the decoder runs on this rank's positions
    (`cp.index`) with ring attention, and the result is (B, T/n, H) at those
    positions. T must divide by `cp.multiple` (the trainer pads to it)."""
    if cp is not None and lora is not None:
        raise ValueError("LoRA with the context-parallel loss is not plumbed, as in JAX: merge the adapters instead")
    embeds = _merged_embeds(params, cfg, batch, batch.input_ids, fix_vit, emb, shard, lora)
    if cp is None:
        hidden, _ = decoder_forward(params["text"], cfg.text, embeds, batch.position_ids,
                                    attention_mask=batch.attention_mask, remat=remat, lora=_text_lora(lora),
                                    shard=_at(shard, "text"))
        return hidden
    T = embeds.shape[1]
    if T % cp.multiple:
        raise ValueError(f"full rows of {T} tokens: the {cp.layout} layout over {cp.size} ranks needs a multiple "
                         f"of {cp.multiple} (build_grpo_batch_groups' pad_multiple)")
    idx = cp.index(T, embeds.device)
    hidden, _ = decoder_forward(params["text"], cfg.text, embeds.index_select(1, idx),
                                batch.position_ids.index_select(2, idx),
                                attention_mask=batch.attention_mask.index_select(1, idx), remat=remat, cp=cp,
                                shard=_at(shard, "text"))
    return hidden


def _by_position(x: torch.Tensor) -> torch.Tensor:
    """(B, T-1) per-token values of positions 0..T-2 (token t+1 predicted at
    t) as (B, T): position T-1 predicts nothing and gets 0."""
    return torch.nn.functional.pad(x, (0, 1))


def _split_logps_entropy(
    params: dict, cfg: Qwen25VLConfig, hp: GRPOHyperParams, batch: GRPOSplitBatch, fix_vit: bool = False,
    lora: Optional[Adapters] = None, shard=None, ends: Optional[tuple] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared-prefix forward → per-token (logps, entropy), both (B, Lc) f32.

    The P prompt rows run once through the prompt forward (vision merged),
    which yields the prompt K/V prefix; the completion rows run as one causal
    chunk over it. Completion token 0 is predicted by the last prompt token's
    hidden state (column Lp-1, shared by the G rows of a group), token t ≥ 1 by
    the chunk's position t-1. The prefix gradient sums over each prompt's rows.
    lora (`Adapters`): the decoder's merged inside each layer of both
    forwards (`language.decoder_forward`), the ViT's inside each block."""
    text = params["text"]
    emb, head = ends if ends is not None else text_ends(text, cfg.text)
    tshard = _at(shard, "text")
    embeds = _merged_embeds(params, cfg, batch, batch.prompt_ids, fix_vit, emb, shard, lora)
    lora = _text_lora(lora)
    P, Lp, _ = embeds.shape
    B = batch.comp_ids.shape[0]
    cache = KVCache.zeros(cfg.text, P, Lp, dtype=embeds.dtype, device=embeds.device)
    remat = hp.gradient_checkpointing
    hidden_p, prefix = decoder_forward(text, cfg.text, embeds, batch.prompt_pos,
                                       attention_mask=batch.prompt_mask, cache=cache, remat=remat, lora=lora,
                                       shard=tshard)
    embeds_c = embed_lookup(emb, batch.comp_ids)
    prefix_bias = torch.where(batch.prompt_mask > 0, 0.0, NEG_INF).float()
    hidden_c, _ = shared_decode_forward(text, cfg.text, embeds_c, batch.comp_pos, prefix, None, prefix_bias,
                                        remat=remat, lora=lora, shard=tshard)
    h_last = hidden_p[:, -1:].repeat_interleave(B // P, dim=0)  # (B, 1, H), shared within a group
    h_pred = torch.cat([h_last, hidden_c[:, :-1]], dim=1)  # (B, Lc, H)
    return per_token_logps_entropy(params, cfg, h_pred, batch.comp_ids, hp.logp_chunk, head=head)


def _chunk_logps_entropy(h: torch.Tensor, t: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """log p(target) (with a graph) and the entropy (without one, a metric)
    of one chunk, from f32 logits that keep the f32 accumulator."""
    logits = head_logits(h, w)
    logz = torch.logsumexp(logits, dim=-1)
    logp = logits.gather(-1, t[..., None])[..., 0] - logz
    with torch.no_grad():
        lg = logits.detach()
        ent = logz.detach() - (torch.softmax(lg, dim=-1) * lg).sum(-1)  # H = logz − Σ p·logit
    return logp, ent


def per_token_logps_entropy(
    params: dict, cfg: Qwen25VLConfig, hidden: torch.Tensor, targets: torch.Tensor, chunk: int, head=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked per-token log p(target) and full-distribution entropy.

    hidden (B, T, H) at the predicting positions, targets (B, T) the next
    tokens → (logps, entropy), both (B, T) f32. Under autograd each chunk is
    recomputed in the backward (`torch.utils.checkpoint`, as JAX's
    `jax.checkpoint` per chunk): one chunk's f32 logits are B·chunk·V·4 bytes,
    622 MB at B = 8, chunk = 128 and the 3B vocabulary. head: the (V, H)
    head matrix to use (a gathered one), else the params' own."""
    w = text_ends(params["text"], cfg.text)[1] if head is None else head
    remat = torch.is_grad_enabled() and hidden.requires_grad
    logps, ents = [], []
    for c0 in range(0, hidden.shape[1], chunk):
        h, t = hidden[:, c0:c0 + chunk], targets[:, c0:c0 + chunk]
        if remat:
            lp, ent = checkpoint(_chunk_logps_entropy, h, t, w, use_reentrant=False)
        else:
            lp, ent = _chunk_logps_entropy(h, t, w)
        logps.append(lp)
        ents.append(ent)
    return torch.cat(logps, dim=1), torch.cat(ents, dim=1)


def _logps_entropy(params: dict, cfg: Qwen25VLConfig, hp: GRPOHyperParams, batch,
                   lora: Optional[Adapters] = None, cp=None, shard=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token (logps, entropy), f32: (B, Lc) over a split batch's
    completion chunks, (B, T-1) over full rows (token t predicted at t-1).
    With cp, (B, T/n) at this rank's positions, the value at position t that
    of token t+1 (0 at position T-1, which predicts nothing). With shard, the
    embedding and the head are gathered once here."""
    batch = align_vision(cfg, batch, shard)
    emb, head = text_ends(params["text"], cfg.text, _at(shard, "text"))
    if isinstance(batch, GRPOSplitBatch):
        if cp is not None:
            raise ValueError("context parallelism covers the full-row layout (shared_prefix_loss=False)")
        return _split_logps_entropy(params, cfg, hp, batch, fix_vit=hp.fix_vit, lora=lora, shard=shard,
                                    ends=(emb, head))
    hidden = _hidden_states(params, cfg, batch, remat=hp.gradient_checkpointing, fix_vit=hp.fix_vit, lora=lora,
                            cp=cp, shard=shard, emb=emb)
    if cp is None:
        return per_token_logps_entropy(params, cfg, hidden[:, :-1], batch.input_ids[:, 1:], hp.logp_chunk,
                                       head=head)
    targets = cp.shard(_by_position(batch.input_ids[:, 1:]), 1)
    return per_token_logps_entropy(params, cfg, hidden, targets, hp.logp_chunk, head=head)


@torch.no_grad()
def compute_ref_logps(params: dict, cfg: Qwen25VLConfig, hp: GRPOHyperParams, batch,
                      lora: Optional[Adapters] = None, cp=None, shard=None) -> torch.Tensor:
    """Per-token logps under the reference weights, without a graph: (B, Lc)
    for a split batch, (B, T-1) for full rows. Nothing is differentiated
    here, so the reference's ViT blocks run frozen (K2/K3 on the card)
    whatever fix_vit says; with fix_vit the batch's `vision_hidden` (the
    policy's frozen blocks, equal to the reference's) is reused. The LoRA
    trainer's reference is the unmerged base (lora None). With cp the group
    runs the ring forward together and every rank gets the whole (B, T-1).
    With shard, over the reference's blocks (gathered, no reduce-scatter)."""
    batch = align_vision(cfg, batch, shard)
    batch = precompute_frozen_vision(params, cfg, batch, shard)
    logps, _ = _logps_entropy(params, cfg, hp, batch, lora=lora, cp=cp, shard=shard)
    if cp is not None:
        logps = cp.gather(logps, 1)[:, :-1]
    return logps


def grpo_loss(params: dict, cfg: Qwen25VLConfig, hp: GRPOHyperParams, batch,
              lora: Optional[Adapters] = None, cp=None, group=None, shard=None) -> tuple[torch.Tensor, dict]:
    """Loss and metrics (0-d tensors, without a graph) for one split or
    full-row batch; differentiable in every parameter that requires grad,
    and in the adapters of lora (an `Adapters`).

    Over ranks (`group`: data-parallel, each rank its own rows; `cp`: a
    context-parallel group over full rows that every rank holds alike) the
    loss is this rank's share: its tokens' sum over the global normalizer, so
    that the sum over the ranks is the whole batch's loss. The metrics are
    the whole batch's, reduced over the ranks here. Over sharded params
    (`shard`) `group` is the data group (the model ranks hold the same rows)."""
    logps, entropy = _logps_entropy(params, cfg, hp, batch, lora=lora, cp=cp, shard=shard)
    ref_logps = batch.ref_logps
    if isinstance(batch, GRPOSplitBatch):
        comp_mask = batch.comp_mask.float()  # every chunk position predicts a completion token
        comp_len = batch.comp_mask.sum(dim=1).float()
    else:
        comp_mask = batch.completion_mask[:, 1:].float()  # token t is predicted at t-1
        comp_len = batch.completion_mask.sum(dim=1).float()
    adv = batch.advantages[:, None].float()
    denom_seq = comp_mask.sum(dim=1).clamp_min(1.0)  # whole rows: every CP rank holds them
    n_rows, n_tokens = float(comp_mask.shape[0]), comp_mask.sum()
    reduce_over = None
    if cp is not None:
        reduce_over = cp.group
        comp_mask = cp.shard(_by_position(comp_mask), 1)  # this rank's positions
        if ref_logps is not None:
            ref_logps = cp.shard(_by_position(ref_logps), 1)
    elif group is not None:
        reduce_over = group
        counts = torch.stack([torch.tensor(n_rows, device=comp_mask.device), n_tokens])
        all_reduce_sum([counts], group)
        n_rows, n_tokens = counts[0], counts[1]

    def row_mean(x):  # the mean over the whole batch's rows of per-row values
        return x.mean() if reduce_over is None else x.sum() / n_rows

    coef_1 = torch.exp(logps - logps.detach())
    metrics = {}
    per_token_kl = None
    if hp.beta != 0.0 and ref_logps is not None:
        delta = ref_logps - logps
        per_token_kl = torch.exp(delta) - delta - 1.0

    if hp.use_grpo:
        per_token_loss = coef_1 * adv
        if per_token_kl is not None:
            per_token_loss = -(per_token_loss - hp.beta * per_token_kl)
        else:
            per_token_loss = -per_token_loss
        loss = row_mean((per_token_loss * comp_mask).sum(dim=1) / denom_seq)
    else:
        coef_2 = torch.clamp(coef_1, 1.0 - hp.epsilon_low, 1.0 + hp.epsilon_high)
        per_token_loss = -torch.minimum(coef_1 * adv, coef_2 * adv)
        if per_token_kl is not None:
            per_token_loss = per_token_loss + hp.beta * per_token_kl
        denom = n_tokens.clamp_min(1.0)
        loss = (per_token_loss * comp_mask).sum() / denom
        with torch.no_grad():
            c1 = coef_1.detach()
            is_low = (c1 < 1 - hp.epsilon_low) & (adv < 0)
            is_high = (c1 > 1 + hp.epsilon_high) & (adv > 0)
            metrics["clip_ratio/low_mean"] = (is_low * comp_mask).sum() / denom
            metrics["clip_ratio/high_mean"] = (is_high * comp_mask).sum() / denom
            metrics["clip_ratio/region_mean"] = ((is_low | is_high) * comp_mask).sum() / denom

    with torch.no_grad():
        if per_token_kl is not None:
            metrics["kl"] = row_mean((per_token_kl.detach() * comp_mask).sum(dim=1) / denom_seq)
        metrics["generation_entropy"] = row_mean((entropy * comp_mask).sum(dim=1) / denom_seq)
        if cp is None:
            metrics["completion_length"] = row_mean(comp_len)
        if reduce_over is not None:  # each rank's share → the whole batch's
            keys = sorted(metrics)
            shares = torch.stack([metrics[k].float() for k in keys])
            all_reduce_sum([shares], reduce_over)
            metrics = dict(zip(keys, shares.unbind(0)))
        if cp is not None:
            metrics["completion_length"] = comp_len.mean()
    return loss, metrics


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def trainable_leaves(params: dict, fix_vit: bool) -> list[torch.Tensor]:
    """The parameters the optimizer updates, in a fixed order. fix_vit freezes
    the ViT patch embed and blocks (the merger stays trainable): they get no
    gradient and no update, which is what JAX's `zero_frozen` does to their
    gradients and updates."""
    if not fix_vit:
        return _leaves(params)
    visual = {k: v for k, v in params["visual"].items() if k not in ("patch_embed", "blocks")}
    return _leaves({"visual": visual, "text": params["text"]})


def grpo_value_and_grad(params: dict, cfg: Qwen25VLConfig, hp: GRPOHyperParams, batch, cp=None, group=None,
                        shard=None) -> tuple[torch.Tensor, dict, list[torch.Tensor]]:
    """(loss, metrics, grads) with one grad per `trainable_leaves(params,
    hp.fix_vit)` entry (zeros where the loss does not reach a leaf). Marks
    those leaves as requiring grad. Over ranks (`cp` or `group`, as
    `grpo_loss`) the gradients and the loss are summed over the group, so
    every rank holds the whole batch's. Over sharded params (`shard`) each
    grad is the sum over the data group of this rank's block: the
    data-sharded leaves' were reduce-scattered in the backward, the others
    are all-reduced here; a replicated kv block's is then summed over its
    replicas (`shard.kv_group`)."""
    leaves = trainable_leaves(params, hp.fix_vit)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = grpo_loss(params, cfg, hp, batch, cp=cp, group=group, shard=shard)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    loss = loss.detach().reshape(1)
    if shard is None:
        _reduce(grads + [loss], cp, group)
        return loss[0], metrics, grads
    specs = trainable_leaves(shard.specs, hp.fix_vit)
    if shard.dp > 1:
        whole = [g for g, s in zip(grads, specs) if s.axis_dim(DATA_AXIS) is None]
        all_reduce_sum(whole + [loss], shard.data_group)
    if shard.kv_group is not None:
        # a replicated kv head's gradient on each replica is the part its own q heads reach (the data-sharded
        # blocks' already reduce-scattered over "data"): their sum over the replicas is the head's. The sum comes
        # out bit-equal on every replica, and so do the clip's norm (`global_sq_sum`) and the optimizer's
        # elementwise update of bit-equal parameters and state, device-resident or offloaded (`rl/optim.py`
        # runs the same arithmetic on each): the replicas stay bit-equal step after step
        all_reduce_sum([g for g, s in zip(grads, specs) if s.replicas > 1], shard.kv_group)
    return loss[0], metrics, grads


def _reduce(tensors: list, cp, group) -> None:
    """Sum the tensors over the ranks of the loss, in place: the
    context-parallel group, the data-parallel group, or none."""
    over = cp.group if cp is not None else group
    if cp is not None or group is not None:
        all_reduce_sum(tensors, over)


def make_train_step(cfg: Qwen25VLConfig, hp: GRPOHyperParams, optimizer, cp=None, group=None, shard=None):
    """The train step: (params, opt_state, batch) → (params, opt_state, loss,
    metrics). Parameters and optimizer state are updated in place (the same
    objects come back), so an engine holding `params` samples from the new
    weights with no copy. grad_norm is taken over the micro-step gradients
    after the frozen leaves are left out, as JAX takes it after zeroing them,
    and over ranks after the gradients are summed (the optimizer's clip
    reads the same sums). Over sharded params (`shard`) the parameters, the
    gradients and the state are this rank's blocks, and the norm counts each
    whole leaf once (`parallel/sharding.py::global_sq_sum`, which this sets
    as the optimizer's `sq_sum`, so its clip reads the same norm)."""
    specs = None if shard is None else trainable_leaves(shard.specs, hp.fix_vit)
    if shard is not None:
        optimizer.sq_sum = lambda grads: global_sq_sum(grads, specs, shard)

    def train_step(params: dict, opt_state, batch):
        loss, metrics, grads = grpo_value_and_grad(params, cfg, hp, batch, cp=cp, group=group, shard=shard)
        if shard is None:
            gnorm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
        else:
            gnorm = torch.sqrt(global_sq_sum(grads, specs, shard))
        optimizer.update(trainable_leaves(params, hp.fix_vit), grads, opt_state)
        metrics = dict(metrics, grad_norm=gnorm, loss=loss)
        return params, opt_state, loss, metrics

    return train_step


def lora_value_and_grad(base: dict, lora: dict, cfg: Qwen25VLConfig, hp: GRPOHyperParams, lora_cfg, batch,
                        group=None, cp=None, shard=None) -> tuple[torch.Tensor, dict, list[torch.Tensor]]:
    """(loss, metrics, grads) of the LoRA loss, one grad per
    `rl/lora.py::lora_leaves(lora)` entry (zeros where the loss does not
    reach a leaf), summed over the ranks: the whole batch's, alike on every
    rank. Marks the adapter leaves as requiring grad; the base never is. The
    decoder's adapters merge inside each layer and the ViT's (without
    fix_vit) inside each block. `group`: data parallelism, as
    `grpo_value_and_grad`'s.

    cp (a `parallel.ContextParallel`): every adapter merges into the base
    before the loss, inside autograd, as JAX's step does under cp
    (`time_r1_tpu/rl/grpo.py:507-510`), and the gradients are summed over the
    group, whose ranks each hold a piece of every row.

    shard (a ShardContext over `base`, this rank's blocks; the adapters stay
    whole on every rank): each layer merges the part of the adapters that its
    blocks need (under cp, the merge before the loss cuts them to the blocks:
    `merge_lora(shard=)`). A rank's adapter gradient is then its own rows'
    part, and where the base leaf is cut over "model" its own blocks' part:
    every gradient is summed over the data group, and those of adapters
    whose base leaf is cut over "model" (`adapter_specs`) over the model
    group too. Over a leaf that is whole along "model" every model rank
    computed the same gradient, which a sum would multiply by tp. The sums
    come out alike on every rank, so the clip's norm counts each adapter
    once and the ranks' adapters stay bit-equal."""
    from ..parallel.sharding import splits_over_model
    from .lora import adapter_specs, lora_layers_tree, lora_leaves, merge_lora

    leaves = lora_leaves(lora)
    for p in leaves:
        p.requires_grad_(True)
    if cp is not None:
        params, adapters = merge_lora(base, lora, lora_cfg, shard=shard), None
    else:
        dec, rest = lora_layers_tree(lora)
        if set(rest) - {"visual"} or set(rest.get("visual", {})) - {"blocks"}:
            raise ValueError(f"adapters outside the decoder layers and the ViT blocks: {sorted(rest)}")
        params, adapters = base, Adapters(dec, lora_cfg.scaling, rest.get("visual", {}).get("blocks"))
    loss, metrics = grpo_loss(params, cfg, hp, batch, lora=adapters, cp=cp, group=group, shard=shard)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    loss = loss.detach().reshape(1)
    if shard is None:
        _reduce(grads + [loss], cp, group)
        return loss[0], metrics, grads
    if shard.dp > 1:
        all_reduce_sum(grads + [loss], shard.data_group)
    split = [g for g, s in zip(grads, adapter_specs(lora, shard.specs)) if splits_over_model(s, shard.tp)]
    if split:
        all_reduce_sum(split, shard.model_group)
    return loss[0], metrics, grads


def make_lora_train_step(cfg: Qwen25VLConfig, hp: GRPOHyperParams, optimizer, lora_cfg, group=None, cp=None,
                         shard=None):
    """The LoRA train step: (base params, adapters, opt_state, batch) →
    (adapters, opt_state, loss, metrics). Only the adapter leaves get
    gradients (`lora_value_and_grad`, whose `group`, `cp` and `shard` these
    are) and the clip and AdamW of `optimizer`, in place. The gradients are
    whole and alike on every rank, so the norm is the plain one."""
    from .lora import lora_leaves

    def train_step(base: dict, lora: dict, opt_state, batch):
        loss, metrics, grads = lora_value_and_grad(base, lora, cfg, hp, lora_cfg, batch, group=group, cp=cp,
                                                   shard=shard)
        gnorm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
        optimizer.update(lora_leaves(lora), grads, opt_state)
        metrics = dict(metrics, grad_norm=gnorm, loss=loss)
        return lora, opt_state, loss, metrics

    return train_step
