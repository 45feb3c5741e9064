"""GRPO training of the port (port of `time_r1_tpu/rl/`): the split-batch and
full-row losses, their batch builders, the optimizer and the single-device
trainer."""

from .grpo import (
    GRPOBatch,
    GRPOHyperParams,
    GRPOSplitBatch,
    compute_group_advantages,
    grpo_loss,
    make_train_step,
)
from .rollout import build_grpo_batch, build_grpo_batch_groups, build_grpo_split_batch
from .trainer import GRPOTrainer, TrainConfig

__all__ = [
    "GRPOBatch",
    "GRPOHyperParams",
    "GRPOSplitBatch",
    "GRPOTrainer",
    "TrainConfig",
    "build_grpo_batch",
    "build_grpo_batch_groups",
    "build_grpo_split_batch",
    "compute_group_advantages",
    "grpo_loss",
    "make_train_step",
]
