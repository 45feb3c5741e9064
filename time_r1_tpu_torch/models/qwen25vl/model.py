"""Qwen2.5-VL combined model: vision features merged into token embeddings.

Port of `time_r1_tpu/models/qwen25vl/model.py`. The vision-token scatter is a
cumsum gather + where (no boolean indexing), as in JAX. The text parameters
may be quantized (`ops/quant.py`: the embedding lookup and the head read the
int8 table) and the caches int8; both pass through to the decoder, as do
side-path LoRA adapters (`lora_side`).

Under a shard context (`text_ends`) the embedding and the LM head are
gathered whole on every rank, so the lookup and the head run replicated over
"model" where JAX's GSPMD computes the same logits vocab-parallel: the
chunked log-softmax of the loss (`rl/grpo.py`) stays as it is.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...ops.quant import embed_lookup
from .config import Qwen25VLConfig
from .language import KVCache, decoder_forward, lm_logits, shared_decode_forward
from .vision import VisionPrep, vision_forward


class VisionInputs(NamedTuple):
    """Device-side vision inputs (host prep arrays as tensors)."""

    patches: torch.Tensor  # (n_patch_rows, patch_input_dim)
    perm: torch.Tensor
    pos_hw: torch.Tensor
    key_valid: torch.Tensor
    full_gather: torch.Tensor
    full_inverse: torch.Tensor
    reverse: torch.Tensor

    @staticmethod
    def build(prep: VisionPrep, patches: torch.Tensor) -> "VisionInputs":
        """A VisionPrep's arrays as tensors on the device of `patches`."""
        dev = patches.device

        def t(a):
            return torch.from_numpy(a).to(dev)

        return VisionInputs(
            patches=patches,
            perm=t(prep.perm).long(),
            pos_hw=t(prep.pos_hw),
            key_valid=t(prep.key_valid),
            full_gather=t(prep.full_gather).long(),
            full_inverse=t(prep.full_inverse).long(),
            reverse=t(prep.reverse).long(),
        )


def text_ends(text: dict, cfg, shard=None) -> tuple:
    """(embedding, head) of the text params for the lookup and the logits:
    the leaves as they are, or, under a ShardContext over the text params,
    gathered whole on every rank (`parallel/fsdp.py::gather_whole`). A tied
    head is the embedding itself, gathered once."""
    emb = text["embed_tokens"] if shard is None else shard.whole(text["embed_tokens"], "embed_tokens")
    if cfg.tie_word_embeddings:
        return emb, emb
    return emb, text["lm_head"] if shard is None else shard.whole(text["lm_head"], "lm_head")


def merge_vision_embeddings(
    embeds: torch.Tensor,  # (B, S, hidden)
    input_ids: torch.Tensor,  # (B, S)
    vision_features: torch.Tensor,  # (U_pad, hidden) in original unit order
    vision_token_ids: tuple[int, ...],
    feature_offset=0,  # first feature row consumed: a scalar, or (B,) per-row starts
) -> torch.Tensor:
    """Replace embeddings at vision-token positions with vision features,
    consumed in order across the flattened (B, S) sequence.

    `feature_offset` is either a scalar added to every row's start (0 for a
    full-sequence forward: row starts are derived from the ids) or a (B,)
    tensor of absolute per-row feature starts (chunked prefill, computed on
    the host from the full sequence)."""
    B, S, H = embeds.shape
    is_vis = torch.zeros_like(input_ids, dtype=torch.bool)
    for tid in vision_token_ids:
        is_vis |= input_ids == tid
    within_row = torch.cumsum(is_vis.long(), dim=1) - 1  # (B, S)
    offset = torch.as_tensor(feature_offset, device=embeds.device).long()
    if offset.ndim == 0:
        per_row_total = is_vis.long().sum(dim=1)
        offset = offset + torch.cumsum(per_row_total, 0) - per_row_total  # exclusive
    idx = (offset[:, None] + within_row).clamp(0, vision_features.shape[0] - 1)
    gathered = vision_features.index_select(0, idx.reshape(-1)).to(embeds.dtype)
    merged = torch.where(is_vis.reshape(-1)[:, None], gathered, embeds.reshape(-1, H))
    return merged.reshape(B, S, H)


def vision_signature(grids, vis: VisionInputs) -> tuple:
    """(grids, padded patch rows): the padded vision layout is a function of
    the two, so inputs with equal signatures are equal. The engine tags the
    ViT hidden states it captures with it, and the trainer checks its loss
    batch (`rl/rollout._pack_vision`) against the tag before reusing them."""
    return tuple(tuple(int(x) for x in g) for g in grids), int(vis.perm.shape[0])


def compute_vision_features(params: dict, cfg: Qwen25VLConfig, vis: VisionInputs, shard=None) -> torch.Tensor:
    """The frozen vision tower; K2/K3 carry its attention when the patches are
    on the card. shard: a ShardContext over the visual params (the rank's
    heads)."""
    return vision_forward(
        params["visual"], cfg.vision, vis.patches, vis.perm, vis.pos_hw,
        vis.key_valid, vis.full_gather, vis.full_inverse, vis.reverse, use_window_kernel=True, shard=shard,
    )


def forward(
    params: dict,
    cfg: Qwen25VLConfig,
    input_ids: torch.Tensor,  # (B, S)
    position_ids: torch.Tensor,  # (3, B, S) from rope.get_rope_index
    attention_mask: Optional[torch.Tensor] = None,
    vision: Optional[VisionInputs] = None,
    cache: Optional[KVCache] = None,
    use_flash: Optional[bool] = None,
    lora_side: Optional[tuple] = None,  # (per-layer adapters, scaling): language.decoder_forward
    shard=None,  # a ShardContext over the text layers (language.decoder_forward); embedding and head whole
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Full forward → (logits (B, S, V) f32, updated KV cache)."""
    embeds = embed_lookup(params["text"]["embed_tokens"], input_ids, dtype=params["text"]["norm"].dtype)
    if vision is not None:
        feats = compute_vision_features(params, cfg, vision)
        embeds = merge_vision_embeddings(embeds, input_ids, feats, (cfg.video_token_id, cfg.image_token_id))
    hidden, new_cache = decoder_forward(
        params["text"], cfg.text, embeds, position_ids,
        attention_mask=attention_mask, cache=cache, use_flash=use_flash, lora_side=lora_side, shard=shard,
    )
    return lm_logits(params["text"], cfg.text, hidden), new_cache


def forward_shared_decode(
    params: dict,
    cfg: Qwen25VLConfig,
    input_ids: torch.Tensor,  # (B, S) decode chunk (no vision tokens)
    position_ids: torch.Tensor,  # (3, B, S)
    prefix: KVCache,  # (L, P, Lp, ...) shared prompt prefixes
    suffix: KVCache,  # (L, B, max_new, ...) per-row generated suffix
    prefix_bias: torch.Tensor,  # (P, Lp) f32 additive
    lora_side: Optional[tuple] = None,  # (per-layer adapters, scaling): language.decoder_forward
    shard=None,  # a ShardContext over the text layers, as forward
) -> tuple[torch.Tensor, KVCache]:
    """Decode-phase forward with the prompt KV shared across rollout rows
    (language.shared_decode_forward) → (logits (B, S, V) f32, new suffix)."""
    embeds = embed_lookup(params["text"]["embed_tokens"], input_ids, dtype=params["text"]["norm"].dtype)
    hidden, new_suffix = shared_decode_forward(
        params["text"], cfg.text, embeds, position_ids, prefix, suffix, prefix_bias, lora_side=lora_side,
        shard=shard,
    )
    return lm_logits(params["text"], cfg.text, hidden), new_suffix
