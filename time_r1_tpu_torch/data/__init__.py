"""Eval data of the port (port of the JAX package's `data/`): benchmark
annotation loaders, the eval prompt matrix and the eval datasets."""

from .eval_dataset import EvalDataset, VideoCache
from .loaders import (
    LOADERS,
    load_activitynet,
    load_charades,
    load_datasets,
    load_egoschema,
    load_mvbench,
    load_tempcompass,
    load_tvgbench,
    load_tvgbench_filter,
    load_videomme,
    split_data,
)
from .prompts import ANSWER_PROMPT, DEFAULT_MCQ_PROMPT, DEFAULT_SYS_PROMPT, DEFAULT_TG_PROMPT

__all__ = [
    "EvalDataset",
    "VideoCache",
    "LOADERS",
    "load_activitynet",
    "load_charades",
    "load_datasets",
    "load_egoschema",
    "load_mvbench",
    "load_tempcompass",
    "load_tvgbench",
    "load_tvgbench_filter",
    "load_videomme",
    "split_data",
    "ANSWER_PROMPT",
    "DEFAULT_MCQ_PROMPT",
    "DEFAULT_SYS_PROMPT",
    "DEFAULT_TG_PROMPT",
]
