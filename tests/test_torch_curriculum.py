"""The port's copy of the TimeRFT curriculum (`time_r1_tpu_torch/utils/curriculum.py`)
against the JAX package's, exactly: difficulties that are missing, None,
NaN, inf, strings and numbers; the stratified pick at k below, at and above
n; the gaussian draw with numpy's global state seeded before each call (and
with a Generator); all three tasks through filter_and_sample and through
process_data_file; and the port's process_data CLI against the JAX one."""

import json

import numpy as np
import pytest

from time_r1_tpu.cli import process_data as jax_process_data
from time_r1_tpu.utils import curriculum as JC
from time_r1_tpu_torch.cli import process_data
from time_r1_tpu_torch.utils import curriculum as C

ODD = [None, float("nan"), float("inf"), float("-inf"), "abc", "13.5", "nan", [], 0, 0.0, -5.0, 70.0, 70.0001, 100]


def _data(seed, n=40):
    rng = np.random.default_rng(seed)
    d = [{"qid": f"q{i}", "difficulty": float(v)} for i, v in enumerate(rng.uniform(0, 100, n).round(3))]
    d += [{"qid": f"odd{i}", "difficulty": v} for i, v in enumerate(ODD)]
    d += [{"qid": "missing"}]
    return d


def test_get_difficulty_safe_equal():
    for item in [{"difficulty": v} for v in ODD] + [{}]:
        assert C.get_difficulty_safe(item) == JC.get_difficulty_safe(item), item


def _wrapped(seed, n):
    return [{"difficulty_float": d, "p_value": d / 100.0, "data": it} for it in _data(seed, n)
            if (d := JC.get_difficulty_safe(it)) is not None]


@pytest.mark.parametrize("k", [0, 1, 3, 10, 49, 52, 200])
def test_difficulty_sorted_sample_equal(k):
    items = _wrapped(1, 40)
    assert C.difficulty_sorted_sample(items, k) == JC.difficulty_sorted_sample(items, k)


@pytest.mark.parametrize("k", [0, 1, 5, 30, 100])
def test_gaussian_sample_equal(k):
    items = [it for it in _wrapped(2, 40) if it["p_value"] > 0]
    np.random.seed(123)
    got = C.gaussian_sample(items, k)
    np.random.seed(123)
    want = JC.gaussian_sample(items, k)
    assert got == want
    got = C.gaussian_sample(items, k, center=0.5, std_dev=0.1, rng=np.random.default_rng(4))
    want = JC.gaussian_sample(items, k, center=0.5, std_dev=0.1, rng=np.random.default_rng(4))
    assert got == want


@pytest.mark.parametrize("k", [1, 7, 100])
def test_random_sample_equal(k):
    items = _wrapped(3, 20)
    assert C.random_sample(items, k, seed=5) == JC.random_sample(items, k, seed=5)


@pytest.mark.parametrize("task", ["0070_all", "gaussian_03", "random_sample"])
@pytest.mark.parametrize("k", [3, 25, 500])
def test_filter_and_sample_equal(task, k):
    import random

    data = _data(4)
    np.random.seed(9)
    random.seed(9)
    got = C.filter_and_sample(data, task, k)
    np.random.seed(9)
    random.seed(9)
    want = JC.filter_and_sample(data, task, k)
    assert got == want
    assert C.filter_and_sample([{"difficulty": None}], task, k) == [] == JC.filter_and_sample([{}], task, k)


def test_unknown_task_refused():
    with pytest.raises(ValueError, match="unknown curriculum task"):
        C.filter_and_sample(_data(0), "easy_first")


@pytest.mark.parametrize("task", ["0070_all", "gaussian_03", "random_sample"])
def test_process_data_file_and_cli_equal(tmp_path, task, capsys):
    import random

    src = tmp_path / "merged.json"
    src.write_text(json.dumps(_data(5)))
    outs = []
    for fn, name in ((C.process_data_file, "port"), (JC.process_data_file, "jax")):
        np.random.seed(1)
        random.seed(1)
        outs.append(fn(str(src), str(tmp_path / name / "next"), task, 12))
    assert outs[0].endswith(C.OUTPUT_SUFFIX[task] + ".json")
    assert open(outs[0], "rb").read() == open(outs[1], "rb").read()
    # the CLI: -t, -k and the default prefix (the input less ".json")
    for mod, name in ((process_data, "port"), (jax_process_data, "jax")):
        d = tmp_path / f"cli_{name}"
        d.mkdir()
        (d / "merged.json").write_text(src.read_text())
        np.random.seed(2)
        random.seed(2)
        mod.main(["--input_json", str(d / "merged.json"), "-t", task, "-k", "9"])
    suffix = C.OUTPUT_SUFFIX[task]
    assert (tmp_path / "cli_port" / f"merged{suffix}.json").read_bytes() == \
        (tmp_path / "cli_jax" / f"merged{suffix}.json").read_bytes()
    assert "save to:" in capsys.readouterr().out
