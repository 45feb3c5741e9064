"""Parallelism of the port (port of `time_r1_tpu/parallel/`): the process
group and its (data, model) mesh (`mesh.py`), the collectives over a group
(`comm.py`), the parameter rule table and the sharded trees
(`sharding.py`), FSDP's gather-use-drop (`fsdp.py`), Megatron-style tensor
parallelism (`tensor.py`) and ring attention over K1, B1 and B2
(`ring_attention.py`), the serving shards of the tensor-parallel engine
(`sharding.serving_params`, int8 or int4, which the paged and slot engines
take over as it is) and pipeline-parallel generation (`pipeline.py`:
`pp_decoder_layers`, `pp_generate`, `PPEngine` over `make_pp_mesh`), and
the 7B's memory plan (`plan.py`: `plan_7b_train_step`, `format_budget`)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    STAGE_AXIS,
    data_group,
    kv_replica_group,
    make_mesh,
    make_pp_mesh,
    maybe_init_distributed,
    mesh_coordinate,
    mesh_size,
    model_group,
    stage_group,
)
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
from .sharding import (
    PARAM_RULES,
    ShardContext,
    gather_params,
    param_specs,
    serving_params,
    shard_params,
    spec_for_path,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "STAGE_AXIS",
    "ContextParallel",
    "data_group",
    "PARAM_RULES",
    "ShardContext",
    "gather_params",
    "kv_replica_group",
    "make_mesh",
    "make_pp_mesh",
    "maybe_init_distributed",
    "mesh_coordinate",
    "mesh_size",
    "model_group",
    "param_specs",
    "serving_params",
    "shard_params",
    "spec_for_path",
    "stage_group",
    "ring_attention_sharded",
    "ring_attention_zigzag_sharded",
    "ring_flash_attention",
    "ring_flash_attention_zigzag",
    "sequence_parallel_decoder",
    "zigzag_indices",
    "zigzag_inverse",
]
