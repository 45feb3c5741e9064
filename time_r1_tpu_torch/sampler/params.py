"""Sampling parameters (vLLM-SamplingParams capability parity, N2).

A copy of `time_r1_tpu/sampler/params.py` (the port imports nothing from the
JAX package).

Reference defaults: greedy (temperature=0), stop ids [151645, 151643],
include_stop_str_in_output=True, skip_special_tokens=False
(vllm_infer.py:106-118)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 → greedy
    top_p: float = 1.0
    top_k: int = -1  # -1 → disabled
    max_new_tokens: int = 128
    stop_token_ids: Tuple[int, ...] = (151645, 151643)
    include_stop_token: bool = True  # include_stop_str_in_output parity
    repetition_penalty: float = 1.0
    seed: Optional[int] = None
    # G-way grouped sampling for GRPO rollouts (num_return_sequences)
    num_return_sequences: int = 1
