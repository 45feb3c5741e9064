"""The process group and the training mesh (port of
`time_r1_tpu/parallel/mesh.py`).

The launcher is `torchrun`: `maybe_init_distributed` reads its environment
(`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR`,
`MASTER_PORT`) where the JAX package reads `JAX_COORDINATOR_ADDRESS`. Each
rank is one process. When the machine shows a card for every local rank, rank
r takes `cuda:LOCAL_RANK` and the group runs over NCCL; when the ranks share
fewer cards (two or four ranks on one card), every rank takes `cuda:0` and the
group runs over gloo, whose collectives `comm.py` stages through pinned host
memory. On the CPU the group is gloo.

The training mesh is a `DeviceMesh` with dims ("data", "model"), as JAX's:
(world / tp, tp). Rank r sits at (r // tp, r % tp), so a model group is made of
adjacent ranks (on one node). The data dim carries FSDP (`sharding.py`,
`fsdp.py`: each rank its own examples, parameters, gradients and optimizer
state sharded over it) or context parallelism (the ranks split one sequence,
`ring_attention.py`); the model dim carries Megatron-style tensor parallelism
(`tensor.py`: heads and MLP width split, one all-reduce after each
row-parallel product; where tp is a multiple of the kv heads, each kv head
is replicated on tp/nkv adjacent model ranks, `kv_replica_group`).
Evaluation takes it with data 1 (`make_mesh(tp)` over a world of tp ranks).

Pipeline generation (`pipeline.py`) takes `make_pp_mesh(n_stages, tp)`, dims
("stage", "model"), as JAX's `time_r1_tpu/parallel/pipeline.py:42-46`: rank
r at (r // tp, r % tp), so a stage's model group is made of adjacent ranks
and the stage group of a model coordinate is every tp-th rank.

`--tp_group_index gi` (eval): `maybe_init_distributed(first_card=gi·tp)`
puts local rank r on card gi·tp + r, as JAX's eval takes the devices
[gi·tp, (gi+1)·tp).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"


def card_group_check(first_card: int, n: int, cards: int, what: str) -> None:
    """JAX's `cli/evaluate.py:201-205` refusal: the cards [first_card,
    first_card + n) must exist. first_card 0 is always allowed: its ranks
    share the first card when the machine shows fewer."""
    if first_card > 0 and cards < first_card + n:
        raise ValueError(f"{what} needs devices [{first_card}, {first_card + n}) but only {cards} exist")


def maybe_init_distributed(device="cuda", first_card: int = 0) -> Optional[torch.device]:
    """Join torchrun's process group; a no-op returning None without its
    environment (one process). Returns this rank's device:
    `cuda:first_card + LOCAL_RANK` when the machine shows a card for every
    local rank from `first_card` on (NCCL), else `cuda:0` shared by all ranks
    (gloo; with first_card > 0 a ValueError, `card_group_check`), or the CPU
    (gloo) when `device` is the CPU. Sets the current CUDA device before the
    group exists, as NCCL needs."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or "RANK" not in os.environ:
        return None
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        card_group_check(first_card, local_world, cards, f"a group of {local_world} ranks from card {first_card}")
        own = cards >= first_card + local_world
        dev = torch.device("cuda", first_card + local_rank if own else 0)
        torch.cuda.set_device(dev)
        backend = "nccl" if own else "gloo"
        note = "" if own else f" (the {local_world} local ranks share one card)"
    else:
        dev, backend, note = torch.device("cpu"), "gloo", ""
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
        print(f"[dist] rank {rank}/{world} on {dev} over {backend}{note}", flush=True)
    return dev


def make_mesh(model_parallel: int = 1):
    """The mesh over every rank of the process group: (data = world /
    model_parallel, model = model_parallel), rank r at (r // model_parallel,
    r % model_parallel). Raises when model_parallel does not divide the world
    (as JAX's `cli/train.py` does). Its device type is where the group's
    collectives run: "cuda" over NCCL, "cpu" over gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: launch with torchrun (maybe_init_distributed)")
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"tensor_parallel_size={model_parallel} does not divide {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world // model_parallel, model_parallel),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def make_pp_mesh(n_stages: int, tp: int = 1):
    """The pipeline mesh over every rank of the process group: dims
    ("stage", "model") of sizes (n_stages, tp), rank r at (r // tp, r % tp).
    Raises ValueError when n_stages·tp is not the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_pp_mesh needs a process group: launch with torchrun (maybe_init_distributed)")
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_stages < 1 or tp < 1 or n_stages * tp != world:
        raise ValueError(f"pipeline_parallel_size={n_stages} × tensor_parallel_size={tp} needs "
                         f"{n_stages * tp} ranks, the group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_stages, tp), mesh_dim_names=(STAGE_AXIS, MODEL_AXIS))


def mesh_size(mesh, axis: str) -> int:
    """The size of the mesh's `axis` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_coordinate(mesh, axis: str) -> int:
    """This rank's coordinate along `axis` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def data_group(mesh):
    """The process group of the mesh's data dim, or None without a mesh."""
    return None if mesh is None else mesh.get_group(DATA_AXIS)


def model_group(mesh):
    """The process group of the mesh's model dim, or None without a mesh."""
    return None if mesh is None else mesh.get_group(MODEL_AXIS)


def stage_group(mesh):
    """The process group of a pipeline mesh's stage dim, or None without a mesh."""
    return None if mesh is None else mesh.get_group(STAGE_AXIS)


def kv_replica_group(mesh, nkv: int):
    """The process group of this rank's kv-head replicas: the model ranks of
    its data coordinate that hold the same kv head when tp = r·nkv (model
    ranks [h·r, (h+1)·r) hold kv head h, `tensor.local_heads`); None when
    no head is replicated (r = 1) or without a mesh. Every rank of the
    group makes every such group, in the same order, as `dist.new_group`
    needs: call it on every rank together."""
    if mesh is None:
        return None
    tp, dp = mesh_size(mesh, MODEL_AXIS), mesh_size(mesh, DATA_AXIS)
    if tp <= nkv:
        return None
    r = tp // nkv
    rank = dist.get_rank()
    mine = None
    for d in range(dp):
        for h in range(nkv):
            ranks = [d * tp + h * r + j for j in range(r)]
            group = dist.new_group(ranks)
            if rank in ranks:
                mine = group
    return mine
