"""The port's copies of the eval parsers and metrics
(`time_r1_tpu_torch/utils/{parsing,metrics}.py`) against the JAX package's,
exactly: seeded numpy windows (pairs, lists of pairs, zero-length and
inverted windows), None preds and [None, None], generated texts with and
without timestamps, answer blocks and option letters, R1@τ at the
thresholds themselves, and the record scorers."""

import math

import numpy as np
import pytest

from time_r1_tpu.utils import metrics as JM
from time_r1_tpu.utils import parsing as JP
from time_r1_tpu_torch.utils import metrics as M
from time_r1_tpu_torch.utils import parsing as P


def _windows(rng, n):
    s = rng.uniform(0, 30, n).round(2)
    return [[float(a), float(a + d)] for a, d in zip(s, rng.uniform(0, 10, n).round(2))]


def _same(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("seed", range(4))
def test_compute_iou_equal(seed):
    rng = np.random.default_rng(seed)
    preds, gts = _windows(rng, 6), _windows(rng, 5)
    cases = [(p, g) for p, g in zip(preds, gts)]
    cases += [(preds, gts[0]), (preds[0], gts), (preds, gts), ([preds[0]], gts)]
    cases += [([3.0, 3.0], [3.0, 3.0]), ([2.0, 2.0], [1.0, 4.0]), ([5.0, 1.0], gts[1]), ([0.0, 1.0], [5.0, 6.0])]
    with np.errstate(invalid="ignore", divide="ignore"):
        for pred, gt in cases:
            assert _same(M.compute_IoU(pred, gt), JM.compute_IoU(pred, gt)), (pred, gt)


def test_calc_difficulty_equal():
    rng = np.random.default_rng(7)
    cases = [(p, g) for p, g in zip(_windows(rng, 8), _windows(rng, 8))]
    cases += [([None, None], [1.0, 2.0]), ([1.0, None], [1.0, 2.0]), ([None, 3.0], [1.0, 2.0]),
              ((1.0, 2.0), (1.5, 4.0)), ([2.0, 2.0], [0.0, 5.0])]
    for pred, gt in cases:
        got, want = M.calc_difficulty(pred, gt), JM.calc_difficulty(pred, gt)
        assert got == want and type(got) is type(want), (pred, gt)
    with np.errstate(invalid="ignore", divide="ignore"):  # a zero-length pred on a zero-length gt: 0/0
        assert math.isnan(M.calc_difficulty([3.0, 3.0], [3.0, 3.0]))
        assert math.isnan(JM.calc_difficulty([3.0, 3.0], [3.0, 3.0]))


@pytest.mark.parametrize("dataset", ["charades", "activitynet", "tvgbench", "mvbench", "egoschema"])
def test_calc_score_equal(dataset):
    rng = np.random.default_rng(3)
    scores = {f"q{i}": float(v) for i, v in enumerate(rng.uniform(0, 1, 17))}
    scores |= {"t3": 0.3, "t5": 0.5, "t7": 0.7, "zero": 0.0}  # R1@τ is a strict >
    if dataset in ("mvbench", "egoschema"):
        scores = {k: float(v > 0.5) for k, v in scores.items()}
    assert M.calc_score(scores, dataset) == JM.calc_score(scores, dataset)


TEXTS = [
    "<think>the man sits at 2.5 to 4.0</think><answer>3.10 to 7.25</answer>",
    "no numbers at all",
    "<answer>from 1.5 and 9</answer> trailing",
    "<answer>\n12.54 to 17.83\n</answer>",
    "<answer>not a window</answer> 4 5",
    "first 3 then 4.75 and more 8.5",
    "only 7",
    "(A) is wrong, (C) is right",
    "B",
    "12 to 13 and 14 to 15.5",
    "1.2.3 to 4",
    "",
]


@pytest.mark.parametrize("text", TEXTS)
def test_parsers_equal(text):
    assert P.extract_answer_tg(text) == JP.extract_answer_tg(text)
    assert P.extract_answer_mcq(text) == JP.extract_answer_mcq(text)
    assert P.extract_answer(text, "tg") == JP.extract_answer(text, "tg")
    assert P.extract_answer(text, "mcq") == JP.extract_answer(text, "mcq")
    assert P.extract_answer_force(text) == JP.extract_answer_force(text)
    for gt in range(4):
        if text:
            assert P.mcq_is_correct(text, gt) == JP.mcq_is_correct(text, gt)
    with pytest.raises(ValueError):
        P.extract_answer(text, "qa")


def test_score_records_equal():
    rng = np.random.default_rng(11)
    tg = [{"qid": f"q{i}", "pred": p, "target": g} for i, (p, g) in enumerate(zip(_windows(rng, 6), _windows(rng, 6)))]
    tg += [{"qid": "none", "pred": None, "target": [1.0, 2.0]},
           {"qid": "pair_none", "pred": [None, None], "target": [1.0, 2.0]},
           {"qid": "half", "pred": [1.0, None], "target": [1.0, 2.0]}]
    assert M.score_tg_records(tg) == JM.score_tg_records(tg)
    mcq = [{"qid": "a", "pred": 2, "target": 2}, {"qid": "b", "pred": 1, "target": 2},
           {"qid": "c", "pred": None, "target": 0, "output_text": "I pick (A)."},
           {"qid": "d", "pred": None, "target": 1, "output_text": "B because"},
           {"qid": "e", "pred": None, "target": 3, "output_text": "(B) no, (D)"}]
    assert M.score_mcq_records(mcq) == JM.score_mcq_records(mcq)
