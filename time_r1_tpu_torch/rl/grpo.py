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

Only the split batch (`GRPOSplitBatch`, the trainer's default) is ported: the
prompt runs once per prompt through the differentiable prompt forward (K1
forward, B1/B2 backward on the card) and each rollout row runs only its
completion chunk over the shared prefix (S1 forward, S2 + B2 backward). The
full-row `GRPOBatch` (ROADMAP A7) and the remat policies of
`gradient_checkpointing` (ROADMAP A9) raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models.qwen25vl import Qwen25VLConfig, VisionInputs
from ..models.qwen25vl.language import NEG_INF, KVCache, decoder_forward, shared_decode_forward
from ..models.qwen25vl.model import merge_vision_embeddings
from ..models.qwen25vl.vision import vision_blocks_forward, vision_forward, vision_merge_forward
from ..ops.quant import embed_lookup, head_logits


@dataclass(frozen=True)
class GRPOHyperParams:
    num_generations: int = 8
    beta: float = 0.04
    epsilon_low: float = 0.2
    epsilon_high: float = 0.2
    use_grpo: bool = False  # False → PPO-clip (the reference's default path)
    logp_chunk: int = 128  # sequence chunk of the log-softmax
    fix_vit: bool = True  # freeze the ViT except the merger
    gradient_checkpointing: object = False  # remat policies: not ported (ROADMAP A9)


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


def _vision_feats(params: dict, cfg: Qwen25VLConfig, batch: GRPOSplitBatch, fix_vit: bool) -> torch.Tensor:
    """Merged vision features for the loss. With `vision_hidden` (the frozen
    blocks' output, precomputed or captured by the rollout) only the trainable
    merger runs here. Otherwise fix_vit runs the blocks without a graph (they
    get no gradient, K2/K3 carry their attention) and the merger with one;
    without fix_vit the whole tower is differentiated, off K2/K3 (they have no
    backward), as JAX's `_vision_feats` passes use_window_kernel=fix_vit."""
    if fix_vit:
        batch = precompute_frozen_vision(params, cfg, batch)
    v = batch.vision
    if batch.vision_hidden is not None:
        return vision_merge_forward(params["visual"], cfg.vision, batch.vision_hidden, v.reverse)
    return vision_forward(params["visual"], cfg.vision, v.patches, v.perm, v.pos_hw, v.key_valid,
                          v.full_gather, v.full_inverse, v.reverse, use_window_kernel=fix_vit)


def precompute_frozen_vision(params: dict, cfg: Qwen25VLConfig, batch: GRPOSplitBatch) -> GRPOSplitBatch:
    """fix_vit: run the frozen ViT blocks once, without a graph (K2/K3 on the
    card), and attach their output to the batch; the policy and ref forwards
    then run only the merger."""
    if batch.vision is None or batch.vision_hidden is not None:
        return batch
    v = batch.vision
    with torch.no_grad():
        x = vision_blocks_forward(params["visual"], cfg.vision, v.patches, v.perm, v.pos_hw,
                                  v.key_valid, v.full_gather, v.full_inverse, use_window_kernel=True)
    return batch._replace(vision_hidden=x)


def _split_logps_entropy(
    params: dict, cfg: Qwen25VLConfig, hp: GRPOHyperParams, batch: GRPOSplitBatch, fix_vit: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared-prefix forward → per-token (logps, entropy), both (B, Lc) f32.

    The P prompt rows run once through the prompt forward (vision merged),
    which yields the prompt K/V prefix; the completion rows run as one causal
    chunk over it. Completion token 0 is predicted by the last prompt token's
    hidden state (column Lp-1, shared by the G rows of a group), token t ≥ 1 by
    the chunk's position t-1. The prefix gradient sums over each prompt's rows."""
    text = params["text"]
    embeds = embed_lookup(text["embed_tokens"], batch.prompt_ids)
    if batch.vision is not None:
        feats = _vision_feats(params, cfg, batch, fix_vit)
        embeds = merge_vision_embeddings(
            embeds, batch.prompt_ids, feats, (cfg.video_token_id, cfg.image_token_id),
            feature_offset=batch.feat_offsets if batch.feat_offsets is not None else 0,
        )
    P, Lp, _ = embeds.shape
    B = batch.comp_ids.shape[0]
    cache = KVCache.zeros(cfg.text, P, Lp, dtype=embeds.dtype, device=embeds.device)
    hidden_p, prefix = decoder_forward(text, cfg.text, embeds, batch.prompt_pos,
                                       attention_mask=batch.prompt_mask, cache=cache)
    embeds_c = embed_lookup(text["embed_tokens"], batch.comp_ids)
    prefix_bias = torch.where(batch.prompt_mask > 0, 0.0, NEG_INF).float()
    hidden_c, _ = shared_decode_forward(text, cfg.text, embeds_c, batch.comp_pos, prefix, None, prefix_bias)
    h_last = hidden_p[:, -1:].repeat_interleave(B // P, dim=0)  # (B, 1, H), shared within a group
    h_pred = torch.cat([h_last, hidden_c[:, :-1]], dim=1)  # (B, Lc, H)
    return per_token_logps_entropy(params, cfg, h_pred, batch.comp_ids, hp.logp_chunk)


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
    params: dict, cfg: Qwen25VLConfig, hidden: torch.Tensor, targets: torch.Tensor, chunk: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked per-token log p(target) and full-distribution entropy.

    hidden (B, T, H) at the predicting positions, targets (B, T) the next
    tokens → (logps, entropy), both (B, T) f32. Under autograd each chunk is
    recomputed in the backward (`torch.utils.checkpoint`, as JAX's
    `jax.checkpoint` per chunk): one chunk's f32 logits are B·chunk·V·4 bytes,
    622 MB at B = 8, chunk = 128 and the 3B vocabulary."""
    text = params["text"]
    w = text["embed_tokens"] if cfg.text.tie_word_embeddings else text["lm_head"]
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


def _require_split(batch, hp: GRPOHyperParams) -> None:
    if not isinstance(batch, GRPOSplitBatch):
        raise NotImplementedError("the full-row GRPOBatch loss is not ported yet (ROADMAP A7)")
    if hp.gradient_checkpointing:
        raise NotImplementedError("gradient_checkpointing (remat policies) is not ported yet (ROADMAP A9)")


@torch.no_grad()
def compute_ref_logps(params: dict, cfg: Qwen25VLConfig, hp: GRPOHyperParams, batch: GRPOSplitBatch) -> torch.Tensor:
    """Per-token logps (B, Lc) under the reference weights, without a graph.
    Nothing is differentiated here, so the reference's ViT blocks run frozen
    (K2/K3 on the card) whatever fix_vit says; with fix_vit the batch's
    `vision_hidden` (the policy's frozen blocks, equal to the reference's) is
    reused."""
    _require_split(batch, hp)
    batch = precompute_frozen_vision(params, cfg, batch)
    logps, _ = _split_logps_entropy(params, cfg, hp, batch, fix_vit=hp.fix_vit)
    return logps


def grpo_loss(params: dict, cfg: Qwen25VLConfig, hp: GRPOHyperParams, batch: GRPOSplitBatch
              ) -> tuple[torch.Tensor, dict]:
    """Loss and metrics (0-d tensors, without a graph) for one split batch;
    differentiable in every parameter that requires grad."""
    _require_split(batch, hp)
    logps, entropy = _split_logps_entropy(params, cfg, hp, batch, fix_vit=hp.fix_vit)
    comp_mask = batch.comp_mask.float()  # every chunk position predicts a completion token
    comp_len = batch.comp_mask.sum(dim=1).float()
    adv = batch.advantages[:, None].float()

    coef_1 = torch.exp(logps - logps.detach())
    metrics = {}
    per_token_kl = None
    if hp.beta != 0.0 and batch.ref_logps is not None:
        delta = batch.ref_logps - logps
        per_token_kl = torch.exp(delta) - delta - 1.0

    denom_seq = comp_mask.sum(dim=1).clamp_min(1.0)
    if hp.use_grpo:
        per_token_loss = coef_1 * adv
        if per_token_kl is not None:
            per_token_loss = -(per_token_loss - hp.beta * per_token_kl)
        else:
            per_token_loss = -per_token_loss
        loss = ((per_token_loss * comp_mask).sum(dim=1) / denom_seq).mean()
    else:
        coef_2 = torch.clamp(coef_1, 1.0 - hp.epsilon_low, 1.0 + hp.epsilon_high)
        per_token_loss = -torch.minimum(coef_1 * adv, coef_2 * adv)
        if per_token_kl is not None:
            per_token_loss = per_token_loss + hp.beta * per_token_kl
        denom = comp_mask.sum().clamp_min(1.0)
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
            metrics["kl"] = ((per_token_kl.detach() * comp_mask).sum(dim=1) / denom_seq).mean()
        metrics["completion_length"] = comp_len.mean()
        metrics["generation_entropy"] = ((entropy * comp_mask).sum(dim=1) / denom_seq).mean()
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


def grpo_value_and_grad(params: dict, cfg: Qwen25VLConfig, hp: GRPOHyperParams, batch: GRPOSplitBatch
                        ) -> tuple[torch.Tensor, dict, list[torch.Tensor]]:
    """(loss, metrics, grads) with one grad per `trainable_leaves(params,
    hp.fix_vit)` entry (zeros where the loss does not reach a leaf). Marks
    those leaves as requiring grad."""
    leaves = trainable_leaves(params, hp.fix_vit)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = grpo_loss(params, cfg, hp, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), metrics, grads


def make_train_step(cfg: Qwen25VLConfig, hp: GRPOHyperParams, optimizer):
    """The train step: (params, opt_state, batch) → (params, opt_state, loss,
    metrics). Parameters and optimizer state are updated in place (the same
    objects come back), so an engine holding `params` samples from the new
    weights with no copy. grad_norm is taken over the micro-step gradients
    after the frozen leaves are left out, as JAX takes it after zeroing them."""

    def train_step(params: dict, opt_state, batch: GRPOSplitBatch):
        loss, metrics, grads = grpo_value_and_grad(params, cfg, hp, batch)
        gnorm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
        optimizer.update(trainable_leaves(params, hp.fix_vit), grads, opt_state)
        metrics = dict(metrics, grad_norm=gnorm, loss=loss)
        return params, opt_state, loss, metrics

    return train_step
