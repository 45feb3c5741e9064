"""TimeRFT difficulty-driven data filtering and re-sampling, the curriculum
of the sample-filtering loop (a copy of the JAX package's
`time_r1_tpu/utils/curriculum.py`, pure host code).

Semantics follow the reference `src/utils/process_data.py`:
  - get_difficulty_safe       :11-24
  - random_sample             :45-58
  - difficulty_sorted_sample  :61-80 (sort desc, linspace-round-unique pick)
  - gaussian_sample           :83-107 (probs ∝ exp(-(d-0.3)²/(2·0.2²)))
  - task dispatch             :110-149 ("0070_all" keeps 0<p≤0.7; "gaussian_03")
"""

from __future__ import annotations

import json
import math
import os
import random
from typing import List, Optional

import numpy as np


def get_difficulty_safe(item: dict) -> Optional[float]:
    """The float difficulty, or None (missing, NaN, inf or not a number)."""
    difficulty = item.get("difficulty")
    if difficulty is None:
        return None
    try:
        d = float(difficulty)
        return d if not (math.isnan(d) or math.isinf(d)) else None
    except (ValueError, TypeError):
        return None


def _unwrap(items: List[dict]) -> List[dict]:
    return [it["data"] if isinstance(it, dict) and "data" in it else it for it in items]


def difficulty_sorted_sample(items: List[dict], k: int) -> List[dict]:
    """Sort by difficulty_float descending; pick k stratified indices by
    round(linspace(0, n-1, k)) with duplicates dropped (process_data.py:61-80).

    The reference's torch.unique SORTS ascending: np.unique keeps that order."""
    if not items or k <= 0:
        return []
    n = len(items)
    actual_k = min(n, k)
    sorted_list = sorted(items, key=lambda x: x["difficulty_float"], reverse=True)
    if actual_k >= n:
        return sorted_list
    indices = np.rint(np.linspace(0, n - 1, actual_k, dtype=np.float32)).astype(np.int64)
    indices = np.clip(indices, 0, n - 1)
    unique_indices = np.unique(indices)
    return [sorted_list[int(i)] for i in unique_indices]


def gaussian_sample(
    items: List[dict], k: int, center: float = 0.3, std_dev: float = 0.2,
    rng: np.random.Generator | None = None,
) -> List[dict]:
    """k items without replacement, with probability ∝ a Gaussian of the
    difficulty (in [0, 1]) around `center` (process_data.py:83-107). Without
    `rng` the draw is numpy's global one, as the reference's."""
    if not items or k <= 0:
        return []
    n = len(items)
    difficulties = np.array([it["difficulty_float"] / 100.0 for it in items])
    probs = np.exp(-((difficulties - center) ** 2) / (2 * std_dev**2))
    probs /= probs.sum()
    if rng is None:
        chosen = np.random.choice(n, min(n, k), False, p=probs)
    else:
        chosen = rng.choice(n, min(n, k), False, p=probs)
    return [items[int(i)] for i in chosen]


def random_sample(items: List[dict], k: int, seed: int | None = None) -> List[dict]:
    """A uniform random k-subset (process_data.py:45-58)."""
    n = len(items)
    k = min(n, k)
    if k >= n:
        return list(items)
    r = random.Random(seed) if seed is not None else random
    return r.sample(items, k)


def filter_and_sample(data: List[dict], task: str, k: int = 2500) -> List[dict]:
    """The task dispatch of process_data.process_ddata (:110-149):

    - "0070_all":      keep 0 < p ≤ 0.7, a difficulty-sorted stratified sample of k
    - "gaussian_03":   keep p > 0, a gaussian sample centred at 0.3 (std 0.2)
    - "random_sample": a uniform k-subset of the valid items
    Returns the raw annotation dicts (unwrapped).
    """
    valid = []
    for item in data:
        d = get_difficulty_safe(item)
        if isinstance(item, dict) and d is not None:
            valid.append({"difficulty_float": d, "p_value": d / 100.0, "data": item})
    if not valid:
        return []

    if task == "0070_all":
        subset = [it for it in valid if 0 < it["p_value"] <= 0.7]
        return _unwrap(difficulty_sorted_sample(subset, k))
    if task == "gaussian_03":
        subset = [it for it in valid if it["p_value"] > 0]
        return _unwrap(gaussian_sample(subset, k, center=0.3, std_dev=0.2))
    if task == "random_sample":
        return _unwrap(random_sample(valid, k))
    raise ValueError(f"unknown curriculum task {task!r}")


OUTPUT_SUFFIX = {"0070_all": "_0070_all", "gaussian_03": "_gaussian_03", "random_sample": "_random"}


def process_data_file(input_json: str, output_prefix: str, task: str, k: int = 2500) -> str:
    """process_data.py as a file-level call: read the annotations, filter,
    write `{prefix}{suffix}.json` and return its path."""
    with open(input_json, "r", encoding="utf-8") as f:
        data = json.load(f)
    sampled = filter_and_sample(data, task, k)
    out_path = f"{output_prefix}{OUTPUT_SUFFIX[task]}.json"
    out_dir = os.path.dirname(out_path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(sampled, f, indent=4, ensure_ascii=False)
    return out_path
