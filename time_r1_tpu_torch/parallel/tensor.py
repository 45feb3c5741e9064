"""Tensor parallelism over the mesh's "model" dim: Megatron's pair of
functions (the port's own; GSPMD inserts the same all-reduces implicitly).

- `copy_to_model` before a column-parallel product (q/k/v, gate/up, the
  vision qkv and gate/up, the merger's fc1): identity in the forward, an
  all-reduce of the input's gradient in the backward (each rank's product
  reached only its columns);
- `reduce_from_model` after a row-parallel product (o, down, the vision proj
  and down, the merger's fc2): an all-reduce of the partial sums in the
  forward, identity in the backward. A bias of that product is added once,
  after it.

Attention runs on the rank's heads (`local_heads`, read by
`models/qwen25vl/language.py::_heads`). Where tp divides the kv heads, rank m
holds nh/tp q heads over nkv/tp kv heads, so the group size G is unchanged.
Where tp is a multiple of the kv heads (the 3B's 2 at tp 4 or 8), each kv
head is replicated on r = tp/nkv ranks, as vLLM serves such a tp: rank m
holds q heads [m·nh/tp, (m+1)·nh/tp) and the whole kv head m // r, so G is
nh/tp. The k/v weights' spec records the replication (`sharding.Spec.replicas`);
each replica's gradient is the part its own q heads reach, and the trainer
sums it over the ranks that hold the head (`mesh.kv_replica_group`,
`rl/grpo.py::grpo_value_and_grad`). JAX's GSPMD splits a head across devices
there instead; the results agree (ROADMAP §C).

`check_heads` holds the rule: tp divides the kv heads or is a multiple of
them, and divides the q heads and the vision's heads. Any other tp would
split a q head or a vision head, which this layout cannot: it is refused by
name (ROADMAP A13).
"""

from __future__ import annotations

import torch

from .comm import all_reduce_sum


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce_sum([g], ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        y = y.contiguous().clone()
        all_reduce_sum([y], group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce over `group` backward."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyToModel.apply(x, group)
    return x


def reduce_from_model(y: torch.Tensor, group) -> torch.Tensor:
    """All-reduce over `group` forward, identity backward."""
    if torch.is_grad_enabled() and y.requires_grad:
        return _ReduceFromModel.apply(y, group)
    y = y.contiguous().clone()
    all_reduce_sum([y], group)
    return y


def check_heads(cfg, tp: int) -> None:
    """Refuse a tp this layout cannot take (the module docstring): one that
    does not divide the q heads or the vision's heads, or that neither
    divides the kv heads nor is a multiple of them (ROADMAP A13)."""
    if tp <= 1:
        return
    nh, nkv, vh = cfg.text.num_attention_heads, cfg.text.num_key_value_heads, cfg.vision.num_heads
    if nh % tp or vh % tp or (nkv % tp and tp % nkv):
        raise NotImplementedError(
            f"tensor_parallel_size={tp} does not divide num_attention_heads={nh} and the vision's num_heads={vh}, "
            f"or neither divides nor is a multiple of num_key_value_heads={nkv}: JAX's GSPMD splits a head across "
            "devices there; the port's Megatron-style TP gives each rank whole q and vision heads and whole or "
            "replicated kv heads (ROADMAP A13)")


def local_heads(text_cfg, tp: int, m: int = 0) -> tuple[int, int, int, int]:
    """Model rank m of tp's text heads: (q heads, kv heads, index of its
    first kv head, r), r the ranks that hold each of its kv heads (1 unless
    tp is a multiple of the kv heads, the module docstring)."""
    nh, nkv = text_cfg.num_attention_heads, text_cfg.num_key_value_heads
    if tp <= nkv:
        return nh // tp, nkv // tp, m * (nkv // tp), 1
    r = tp // nkv
    return nh // tp, 1, m // r, r


def splits(n: int, tp: int) -> bool:
    """Whether a width of n splits over tp model ranks: the rule table's
    `_divisible`, which leaves a leaf whole along a dim tp does not divide
    (the vision MLP's 3420 columns at tp 8). A product over a whole leaf runs
    whole on every rank, outside Megatron's pair."""
    return tp > 1 and n % tp == 0 and n >= tp
