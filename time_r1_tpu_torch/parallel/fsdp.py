"""FSDP over the mesh's "data" dim: ZeRO-3's gather-use-drop (the port's own;
GSPMD inserts the same collectives implicitly).

A leaf sharded over "data" is all-gathered just before its layer uses it
(`gather_layer`), inside the layer function that `_layer_remat` checkpoints,
and dropped after it; its gradient is reduce-scattered over the data group
in the backward, so each rank keeps only its block's sum. Under remat the
backward reruns the layer and gathers again: no gathered weight is saved as
a residual. A leaf whole over "data" passes through; its gradient is
all-reduced after the backward, bucketed (`rl/grpo.py::grpo_value_and_grad`).

`gather_whole` also gathers a leaf over "model" for a computation that runs
it whole on every model rank (the embedding, the LM head, the vision patch
embed). Every model rank computes the same gradient for it, so the backward
of that gather takes the rank's own block and sums nothing over "model". A
replicated kv leaf (`sharding.Spec.replicas`) comes back with one replica of
each head: the gather over "model" keeps every r-th rank's block.

`layer_gathers` counts the layer dicts gathered (the forward, and the
backward's rerun under remat); `live_gathered()` the gathered tensors still
alive.
"""

from __future__ import annotations

import weakref

import torch
import torch.distributed as dist

from .comm import all_gather_dim, reduce_scatter_dim
from .mesh import DATA_AXIS, MODEL_AXIS

layer_gathers = 0  # layer dicts gathered over "data"
_gathered: "weakref.WeakSet[torch.Tensor]" = weakref.WeakSet()


def live_gathered() -> int:
    """The gathered tensors still alive (0 once a step has let go of them)."""
    return len(_gathered)


class _GatherData(torch.autograd.Function):
    """forward: the data group's blocks concatenated along `dim`; backward:
    the gradient reduce-scattered back to this rank's block."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


def _model_gather(x: torch.Tensor, dim: int, group, replicas: int) -> torch.Tensor:
    """The model group's blocks concatenated along `dim`, one of each
    `replicas` equal blocks kept."""
    x = all_gather_dim(x, dim, group)
    if replicas > 1:
        blocks = x.chunk(dist.get_world_size(group), dim=dim)
        x = torch.cat(blocks[::replicas], dim=dim)
    return x


class _GatherModel(torch.autograd.Function):
    """forward: the model group's blocks concatenated along `dim` (one
    replica of each replicated block); backward: this rank's block of the
    gradient, which every model rank computed alike (nothing is summed over
    "model")."""

    @staticmethod
    def forward(ctx, x, dim, group, n, r, replicas):
        ctx.dim, ctx.n, ctx.r = dim, n // replicas, r // replicas
        return _model_gather(x, dim, group, replicas)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.r].contiguous(), None, None, None, None, None


def _track(x: torch.Tensor) -> torch.Tensor:
    _gathered.add(x)
    return x


def gather_local(x: torch.Tensor, spec, shard) -> torch.Tensor:
    """The leaf gathered over "data": its model-local form."""
    dim = spec.axis_dim(DATA_AXIS)
    if dim is None or shard.dp == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _track(_GatherData.apply(x, dim, shard.data_group))
    return _track(all_gather_dim(x, dim, shard.data_group))


def gather_whole(x: torch.Tensor, spec, shard) -> torch.Tensor:
    """The leaf gathered over "data" and "model": whole on every rank."""
    from .sharding import _parts_major

    x = gather_local(x, spec, shard)
    dim = spec.axis_dim(MODEL_AXIS)
    if dim is None or shard.tp == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        x = _GatherModel.apply(x, dim, shard.model_group, shard.tp, shard.model_rank, spec.replicas)
    else:
        x = _model_gather(x, dim, shard.model_group, spec.replicas)
    if spec.parts > 1 and dim == 0:
        x = _parts_major(x, spec.parts, shard.tp)
    return _track(x)


def gather_layer(lp: dict, specs: dict, shard) -> dict:
    """A layer dict with each leaf gathered over "data" (`gather_local`)."""
    global layer_gathers
    layer_gathers += 1
    return {k: gather_local(v, specs[k], shard) for k, v in lp.items()}
