"""Answer extraction from generated text, on the eval path (a copy of the JAX
package's `time_r1_tpu/utils/parsing.py`, pure host code; the port imports
nothing of that package). `utils/rewards.py` keeps its own parsers.

Semantics follow the reference code:
  evaluate.py                                extract_answer        :125-155
  src/vllm_inference/calc_difficulty.py      extract_answer_force  :40-46
  src/vllm_inference/eval_all.py             mcq_is_correct        :89-94
"""

from __future__ import annotations

import re
from typing import List, Optional, Union

_TS_RE = re.compile(r"(\d+\.?\d*) (to|and) (\d+\.?\d*)")
_ANSWER_RE = re.compile(r"<answer>(.*?)</answer>")
_MCQ_RE = re.compile(r"\(([A-Z])\)")
_NUMBER_RE = re.compile(r"\d+(?:\.\d+)?")


def extract_answer_tg(output_string: str) -> List[Optional[float]]:
    """TG: the last "X to/and Y" anywhere in the text; if none, the last one
    inside the first <answer> block; else [None, None] (evaluate.py:126-149)."""
    matches = _TS_RE.findall(output_string)
    if not matches:
        answer_match = _ANSWER_RE.search(output_string)
        if answer_match:
            answer_matches = _TS_RE.findall(answer_match.group(1).strip())
            if answer_matches:
                last = answer_matches[-1]
                return [float(last[0]), float(last[2])]
        return [None, None]
    last = matches[-1]
    try:
        return [float(last[0]), float(last[2])]
    except ValueError:
        return [None, None]


def extract_answer_mcq(output_string: str) -> Optional[int]:
    """MCQ: the last "(L)" letter anywhere, as a 0-based index (evaluate.py:151-155)."""
    matches = _MCQ_RE.findall(output_string)
    if matches:
        return ord(matches[-1]) - ord("A")
    return None


def extract_answer(output_string: str, datatype: str) -> Union[List[Optional[float]], Optional[int]]:
    """Dispatch on datatype ('tg' | 'mcq'), as evaluate.py:125-155."""
    if datatype == "tg":
        return extract_answer_tg(output_string)
    if datatype == "mcq":
        return extract_answer_mcq(output_string)
    raise ValueError(f"unknown datatype {datatype!r}")


def extract_answer_force(output_string: str) -> List[Optional[float]]:
    """The rescue parser: the FIRST TWO numbers anywhere in the text
    (calc_difficulty.py:40-46), used when the strict parser fails."""
    nums = [float(n) for n in _NUMBER_RE.findall(output_string)[:2]]
    if len(nums) == 2:
        return nums
    return [None, None]


def mcq_is_correct(pred_text: str, gt: int) -> int:
    """Score raw MCQ output text against a 0-based gt index: the last "(L)"
    if there is one, else the first character (eval_all.py:89-94)."""
    gt_letter = chr(gt + ord("A"))
    matches = _MCQ_RE.findall(pred_text)
    if matches:
        return int(matches[-1] == gt_letter)
    return int(pred_text[0] == gt_letter)
