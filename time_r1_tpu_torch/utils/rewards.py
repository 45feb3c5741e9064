"""Verifiable reward and metric functions for GRPO on temporal video grounding.

A copy of the JAX package's `time_r1_tpu/utils/rewards.py` (pure host code,
no jax), kept here because the port imports nothing of that package: the
timestamp parser, the tIoU rewards, the format reward, the MCQ reward, the
think-section metrics and the two registries. The ROUGE-L diversity reward,
which no registry names, is not copied.

All functions take `completions: list[str]` plus per-sample kwargs and return
`list[float]` (or None entries where a metric does not apply).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

_TIMESTAMP_RE = re.compile(r"(\d+\.?\d*) (to|and) (\d+\.?\d*)", re.IGNORECASE)
_ANSWER_RE = re.compile(r"<answer>(.*?)</answer>", re.DOTALL)
_THINK_RE = re.compile(r"<think>(.*?)</think>", re.DOTALL)
_FORMAT_RE = re.compile(r"<think>.*?</think>\s*<answer>.*?</answer>", re.DOTALL)
_TIMESTEP_PAIR_RE = re.compile(
    r"<timestep>\s*(\d+\.?\d*)\s+to\s+(\d+\.?\d*)\s*</timestep>", re.IGNORECASE | re.DOTALL
)

DEFAULT_STRUCTURE_KEYWORDS = (
    "analyze",
    "compare",
    "deduce",
    "however",
    "therefore",
    "because",
    "step",
    "observe",
    "notice",
    "identify",
    "wait",
)


def parse_timestamp_output(output_string: str) -> Optional[tuple[float, float]]:
    """Extract (start, end) seconds from the LAST <answer> block's LAST
    "X to/and Y" match; None when absent (main.py:122-142)."""
    answer_matches = _ANSWER_RE.findall(output_string)
    if not answer_matches:
        return None
    matches = _TIMESTAMP_RE.findall(answer_matches[-1])
    if not matches:
        return None
    last = matches[-1]
    return float(last[0]), float(last[2])


def _hull_iou(pred_start: float, pred_end: float, gt_start: float, gt_end: float) -> float:
    """Temporal IoU with hull union: union = max(ends) - min(starts).

    Matches the scalar math in iou_timestamp_reward (main.py:163-168) and the
    vectorized compute_IoU (eval_all.py:65-87).
    """
    intersection = max(0.0, min(pred_end, gt_end) - max(pred_start, gt_start))
    union = max(pred_end, gt_end) - min(pred_start, gt_start)
    if union > 0:
        return intersection / union
    return 0.0


def iou_timestamp_reward(
    completions: Sequence[str], solution: Sequence[tuple[float, float]], **kwargs
) -> List[float]:
    """Plain tIoU reward; 0.0 when the completion has no parsable answer."""
    rewards = []
    for content, sol in zip(completions, solution):
        reward = 0.0
        parsed = parse_timestamp_output(content)
        if parsed is not None:
            gt_start, gt_end = float(sol[0]), float(sol[1])
            reward = _hull_iou(parsed[0], parsed[1], gt_start, gt_end)
        rewards.append(reward)
    return rewards


def iou_timestamp_reward_v2(
    completions: Sequence[str],
    solution: Sequence[tuple[float, float]],
    durations: Sequence[float] | None = None,
    **kwargs,
) -> List[float]:
    """tIoU × (1-|Δstart|/dur) × (1-|Δend|/dur) — the boundary-normalized
    reward used by the posttrain recipes (main.py:184-231)."""
    durations = durations if durations is not None else kwargs.get("durations")
    rewards = []
    for content, sol, duration in zip(completions, solution, durations):
        reward = 0.0
        parsed = parse_timestamp_output(content)
        if parsed is not None:
            start_time, end_time = parsed
            gt_start, gt_end = float(sol[0]), float(sol[1])
            iou = _hull_iou(start_time, end_time, gt_start, gt_end)
            gt_start_norm = gt_start / duration
            gt_end_norm = gt_end / duration
            pred_start_norm = start_time / duration
            pred_end_norm = end_time / duration
            reward = (
                iou
                * (1 - abs(gt_start_norm - pred_start_norm))
                * (1 - abs(gt_end_norm - pred_end_norm))
            )
        rewards.append(reward)
    return rewards


def format_reward(completions: Sequence[str], **kwargs) -> List[float]:
    """1.0 iff the stripped completion is exactly <think>..</think>\\s*<answer>..</answer>."""
    return [1.0 if _FORMAT_RE.fullmatch(c.strip()) else 0.0 for c in completions]


def _extract_characters_regex(s: str) -> str:
    """finetune.py:233-253: strip answer prefixes, then the FIRST [A-G] char;
    long answers with no option letter yield ''. (Note the reference's list
    concatenates "Best answer:" "Best option:" into one string — preserved.)"""
    s = s.strip()
    answer_prefixes = [
        "The best answer is",
        "The correct answer is",
        "The answer is",
        "The answer",
        "The best option is",
        "The correct option is",
        "Best answer:" "Best option:",
    ]
    for prefix in answer_prefixes:
        s = s.replace(prefix, "")
    if len(s.split()) > 10 and not re.search("[ABCDEFG]", s):
        return ""
    m = re.search(r"[ABCDEFG]", s)
    return m[0] if m else ""


def mqa_answer_reward(
    completions: Sequence[str], solution: Sequence, task_type: Sequence[str] | None = None, **kwargs
) -> List[Optional[float]]:
    """MCQ answer reward (finetune.py:228-285): first <answer> block, option
    letter via _extract_characters_regex, compared against the gt letter.
    Returns None for rows whose task_type is not 'mqa'."""
    if task_type is None:
        task_type = kwargs.get("task_type", ["mqa"] * len(completions))
    rewards: List[Optional[float]] = []
    for content, sol, tt in zip(completions, solution, task_type):
        if tt != "mqa":
            rewards.append(None)
            continue
        reward = 0.0
        match_answer = re.search(r"<answer>(.*?)</answer>", content, re.DOTALL)
        if match_answer:
            gt = sol if isinstance(sol, str) else chr(int(sol) + ord("A"))
            if _extract_characters_regex(match_answer.group(1)) == _extract_characters_regex(gt):
                reward = 1.0
        rewards.append(reward)
    return rewards


def extract_think_content(completion: str) -> Optional[str]:
    """Last <think> block, stripped (main.py:242-247)."""
    matches = _THINK_RE.findall(completion)
    if matches:
        return matches[-1].strip()
    return None


def reward_timestep_pair(
    completions: Sequence[str], weight: float = 0.2, max_count: int = 1, **kwargs
) -> List[float]:
    """weight × min(#<timestep>X to Y</timestep> inside <think>, max_count)."""
    out = []
    for completion in completions:
        think = extract_think_content(completion)
        score = weight * min(len(_TIMESTEP_PAIR_RE.findall(think)), max_count) if think else 0.0
        out.append(max(0.0, score))
    return out


def reward_think_length(
    completions: Sequence[str], weight: float = 0.001, max_length: int = 500, **kwargs
) -> List[float]:
    """weight × min(len(think), max_length)."""
    out = []
    for completion in completions:
        think = extract_think_content(completion)
        score = weight * min(len(think), max_length) if think else 0.0
        out.append(max(0.0, score))
    return out


def reward_keyword_usage(
    completions: Sequence[str],
    keywords: Optional[Sequence[str]] = None,
    weight: float = 0.1,
    max_count: int = 2,
    **kwargs,
) -> List[float]:
    """weight × min(#structure keywords present in think, max_count)."""
    keywords = keywords if keywords is not None else DEFAULT_STRUCTURE_KEYWORDS
    out = []
    for completion in completions:
        think = extract_think_content(completion)
        if think:
            lower = think.lower()
            count = sum(1 for w in keywords if w in lower)
            score = weight * min(count, max_count)
        else:
            score = 0.0
        out.append(max(0.0, score))
    return out


def reward_paragraph_structure(
    completions: Sequence[str], weight: float = 0.05, max_paragraphs: int = 2, **kwargs
) -> List[float]:
    """weight × min(#non-empty think lines, max_paragraphs)."""
    out = []
    for completion in completions:
        think = extract_think_content(completion)
        if think:
            paragraphs = [p for p in think.split("\n") if p.strip()]
            score = weight * min(len(paragraphs), max_paragraphs)
        else:
            score = 0.0
        out.append(max(0.0, score))
    return out


REWARD_FUNCS_REGISTRY = {
    "iou": iou_timestamp_reward,
    "iou_v2": iou_timestamp_reward_v2,
    "format": format_reward,
    "mqa": mqa_answer_reward,
}

METRIC_FUNCS_REGISTRY = {
    "reward_timestep_pair": reward_timestep_pair,
    "reward_think_length": reward_think_length,
    "reward_keyword_usage": reward_keyword_usage,
    "reward_paragraph_structure": reward_paragraph_structure,
}
