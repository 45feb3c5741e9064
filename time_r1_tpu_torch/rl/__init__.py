"""GRPO training of the port (port of `time_r1_tpu/rl/`): the split-batch loss,
its batch builder, the optimizer and the single-device trainer."""

from .grpo import (
    GRPOHyperParams,
    GRPOSplitBatch,
    compute_group_advantages,
    grpo_loss,
    make_train_step,
)
from .rollout import build_grpo_split_batch
from .trainer import GRPOTrainer, TrainConfig

__all__ = [
    "GRPOHyperParams",
    "GRPOSplitBatch",
    "GRPOTrainer",
    "TrainConfig",
    "build_grpo_split_batch",
    "compute_group_advantages",
    "grpo_loss",
    "make_train_step",
]
