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

Attention runs on the rank's heads: nh/tp q heads over nkv/tp kv heads, so
the group size G is unchanged (`models/qwen25vl/language.py::_heads`). A tp
that does not divide the kv heads or the vision heads would split a head
across ranks, which GSPMD does and this layout cannot: `check_heads` refuses
it by name.
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
    """Refuse a tp that does not divide the text kv heads or the vision
    heads (ROADMAP A13: Megatron-style TP would need kv-head replication)."""
    if tp <= 1:
        return
    nkv, vh = cfg.text.num_key_value_heads, cfg.vision.num_heads
    if nkv % tp or vh % tp:
        raise NotImplementedError(
            f"tensor_parallel_size={tp} does not divide num_key_value_heads={nkv} and the vision's num_heads={vh}: "
            "JAX's GSPMD splits a head across devices there; the port's Megatron-style TP would need kv-head "
            "replication, which is not ported (ROADMAP A13)")
