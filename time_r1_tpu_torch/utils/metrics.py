"""Benchmark scoring: temporal IoU (hull union), R1@τ and MCQ accuracy (a
copy of the JAX package's `time_r1_tpu/utils/metrics.py`, numpy only).

Semantics follow the reference code:
  src/vllm_inference/eval_all.py
    - compute_IoU :65-87 (vectorized; the union is the CONVEX HULL max - min)
    - calc_score  :120-137 (mIoU and R1@{0.3, 0.5, 0.7} with a strict >)
  src/vllm_inference/calc_difficulty.py
    - calc_difficulty :34-37 (tIoU × 100, 0 if unparsable)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .parsing import mcq_is_correct


def compute_IoU(pred, gt):
    """Pairwise temporal IoU between predicted and ground-truth windows.

    Takes a single [s, e] pair or a list of pairs on each side and returns a
    scalar, a 1-D or a 2-D array accordingly. The union is the hull
    (max(e) - min(s)), as eval_all.py:65-87.
    """
    assert isinstance(pred, list) and isinstance(gt, list)
    pred_is_list = isinstance(pred[0], list)
    gt_is_list = isinstance(gt[0], list)
    if not pred_is_list:
        pred = [pred]
    if not gt_is_list:
        gt = [gt]
    pred_a, gt_a = np.array(pred), np.array(gt)
    inter_left = np.maximum(pred_a[:, 0, None], gt_a[None, :, 0])
    inter_right = np.minimum(pred_a[:, 1, None], gt_a[None, :, 1])
    inter = np.maximum(0.0, inter_right - inter_left)
    union_left = np.minimum(pred_a[:, 0, None], gt_a[None, :, 0])
    union_right = np.maximum(pred_a[:, 1, None], gt_a[None, :, 1])
    union = np.maximum(0.0, union_right - union_left)
    overlap = 1.0 * inter / union
    if not gt_is_list:
        overlap = overlap[:, 0]
    if not pred_is_list:
        overlap = overlap[0]
    return overlap


def calc_difficulty(pred: Sequence[Optional[float]], gt: Sequence[float]) -> float:
    """Per-sample difficulty = tIoU × 100; 0.0 for an unparsable prediction."""
    if None in pred:
        return 0.0
    return float(compute_IoU(list(pred), list(gt)) * 100.0)


TG_DATASETS = ("activitynet", "charades", "tvgbench")


def calc_score(score_by_qid: Dict[str, float], datasetname: str) -> Dict:
    """Aggregate per-qid scores into the published metric dict.

    TG datasets: {"mIoU", 0.3, 0.5, 0.7, "avg"}, R1@τ with a strict > τ
    (eval_all.py:120-130). MCQ datasets: {"correct", "total", "avg"}.
    """
    data = list(score_by_qid.values())
    if datasetname in TG_DATASETS:
        scores: Dict = {}
        scores["mIoU"] = float(np.mean(data)) * 100
        for tau in (0.3, 0.5, 0.7):
            cnt = len([s for s in data if s > tau])
            scores[tau] = cnt / len(score_by_qid) * 100.0
        scores["avg"] = sum(scores.values()) / len(scores)
        return scores
    correct = int(sum(data))
    return {
        "correct": correct,
        "total": len(data),
        "avg": round(correct / len(data) * 100, 2),
    }


def score_tg_records(records: List[dict]) -> Dict[str, float]:
    """Per-qid tIoU of eval jsonl records ({"qid", "pred", "target", ...}),
    0.0 for an unparsable pred (eval_all.py:107-116)."""
    out: Dict[str, float] = {}
    for rec in records:
        score = 0.0
        if rec["pred"] is not None and None not in rec["pred"]:
            score = float(compute_IoU(rec["pred"], rec["target"]))
        out[rec["qid"]] = score
    return out


def score_mcq_records(records: List[dict]) -> Dict[str, float]:
    """Per-qid 0/1 of eval jsonl records; parses output_text when pred is
    None (eval_all.py:111-115)."""
    out: Dict[str, float] = {}
    for rec in records:
        if rec.get("pred") is not None:
            score = int(rec["pred"] == rec["target"])
        else:
            score = mcq_is_correct(rec["output_text"], rec["target"])
        out[rec["qid"]] = float(score)
    return out
