"""Parallelism of the port (port of `time_r1_tpu/parallel/`): the process
group and its mesh (`mesh.py`), the collectives over a group (`comm.py`) and
ring attention over K1, B1 and B2 (`ring_attention.py`). Data parallelism over
processes and context parallelism are ported; FSDP, tensor parallelism and
pipeline generate are not yet (ROADMAP A13)."""

from .mesh import DATA_AXIS, MODEL_AXIS, data_group, make_mesh, maybe_init_distributed
from .ring_attention import (
    ContextParallel,
    ring_attention_sharded,
    ring_attention_zigzag_sharded,
    ring_flash_attention,
    ring_flash_attention_zigzag,
    sequence_parallel_decoder,
    zigzag_indices,
    zigzag_inverse,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "ContextParallel",
    "data_group",
    "make_mesh",
    "maybe_init_distributed",
    "ring_attention_sharded",
    "ring_attention_zigzag_sharded",
    "ring_flash_attention",
    "ring_flash_attention_zigzag",
    "sequence_parallel_decoder",
    "zigzag_indices",
    "zigzag_inverse",
]
