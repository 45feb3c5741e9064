"""The port's ContinuousEngine (f32, CPU) against the JAX package's
(`time_r1_tpu/sampler/continuous.py`) and the port's bucket Engine: equal
greedy tokens with slot recycling, for a video request, with exact
accounting when the budget runs out, and with int8 weights."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_bridge import CFG, JCFG, jax_params, port_params
from test_torch_paged import _jax_requests, _video_request
from time_r1_tpu.sampler import SamplingParams as JaxSamplingParams
from time_r1_tpu.sampler.continuous import ContinuousEngine as JaxContinuousEngine
from time_r1_tpu_torch.sampler import ContinuousEngine, Engine, Request, SamplingParams

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    jp = jax_params()
    return jp, port_params(jp)


def _requests(n, seed):
    """tests/test_continuous.py's mixed-length prompts (5 to 39 tokens)."""
    rng = np.random.default_rng(seed)
    return [Request(input_ids=list(rng.integers(2, 200, int(rng.integers(5, 40))))) for _ in range(n)]


def _three_way(params, reqs, sp, segment, quantization=None):
    """(port ContinuousEngine, JAX ContinuousEngine, port Engine) greedy tokens."""
    jp, tp = params
    kw = dict(max_slots=2, max_len=256, segment=segment, quantization=quantization)
    eng = ContinuousEngine(tp, CFG, dtype=torch.float32, device="cpu", **kw)
    got = eng.generate(reqs, SamplingParams(**sp))
    want_jax = JaxContinuousEngine(jp, JCFG, dtype=jnp.float32, **kw).generate(_jax_requests(reqs),
                                                                                JaxSamplingParams(**sp))
    want_engine = Engine(tp, CFG, dtype=torch.float32, device="cpu", quantization=quantization).generate(
        reqs, SamplingParams(**sp))
    return got, want_jax, want_engine, eng.timings


def test_continuous_matches_jax_and_bucket_greedy(params):
    """Five requests through two slots: slots recycle."""
    sp = dict(temperature=0.0, max_new_tokens=7, stop_token_ids=CFG.stop_token_ids)
    got, want_jax, want_engine, tm = _three_way(params, _requests(5, 0), sp, segment=3)
    assert got == want_jax == want_engine
    assert len(tm["admissions"]) >= 3 and tm["decode_steps"] == 3 * tm["segments"] > 0


def test_continuous_with_video(params):
    sp = dict(temperature=0.0, max_new_tokens=5, stop_token_ids=CFG.stop_token_ids)
    got, want_jax, want_engine, tm = _three_way(params, [_video_request()], sp, segment=4)
    assert got == want_jax == want_engine and len(got[0]) >= 1
    assert tm["admissions"] == [(1, 128, True)]


def test_continuous_exact_accounting_budget_exhaustion(params):
    """A slot that runs out of max_new_tokens without a stop id returns
    exactly max_new_tokens tokens and no pads, even when the pad id is itself
    a stop id (tests/test_continuous.py:54); budget 5 with segment 4 runs out
    inside a segment."""
    sp = dict(temperature=0.0, max_new_tokens=5, stop_token_ids=(CFG.pad_token_id, 255))
    got, want_jax, want_engine, _ = _three_way(params, _requests(3, 2), sp, segment=4)
    assert got == want_jax == want_engine
    assert all(len(row) <= 5 for row in got) and any(len(row) == 5 for row in got)


def test_continuous_int8_weights_match_jax_and_bucket(params):
    sp = dict(temperature=0.0, max_new_tokens=6, stop_token_ids=CFG.stop_token_ids)
    got, want_jax, want_engine, _ = _three_way(params, _requests(3, 3), sp, segment=3, quantization="int8")
    assert got == want_jax == want_engine


def test_entry_point_defaults_to_the_card(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousEngine(params[1], CFG)
