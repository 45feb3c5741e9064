"""Q1 and Q2 of the port (`ops/int4_matmul.py`, `ops/fused_mlp.py`) against
the JAX package's Pallas kernels in interpret mode, on CPU tensors (so the
wrappers run their plain versions), mirroring tests/test_int4_matmul.py:

- the Q1 plain version against `int4_matmul(interpret=True)` and
  `int4_matmul_reference`, with ragged K and N (JAX pads them; the port's
  kernel masks them);
- the K split the Q1 wrapper chooses covers K in whole staged tiles;
- the Q2 plain version against `fused_mlp_int8(interpret=True)` at M = 1, 4,
  7, 8, 16 and a ragged narrow shape;
- `mlp_proj` on the CPU takes the unfused path over the fused int8 layout, as
  the JAX package does off the TPU, and equals JAX's.

Tolerances (relative to the largest output): Q1 1e-6, f32 sums in another
order; Q2 1e-5, the same, plus the bf16 rounding of the activation, which an
f32 difference in its sum can move by one bf16 step in rare elements."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from time_r1_tpu.ops import quant as jq
from time_r1_tpu.ops.fused_mlp import fused_mlp_int8 as jax_fused_mlp
from time_r1_tpu.ops.int4_matmul import int4_matmul as jax_int4_matmul
from time_r1_tpu.ops.int4_matmul import int4_matmul_reference as jax_int4_reference
from time_r1_tpu_torch.ops import fused_mlp as fm
from time_r1_tpu_torch.ops import int4_matmul as i4
from time_r1_tpu_torch.ops import quant as tq

torch.set_num_threads(2)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.swapaxes(np.asarray(a), -1, -2)))


def _close(got, want, rel):
    want = np.asarray(want)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (np.abs(got - want).max(), np.abs(want).max())


@pytest.mark.parametrize("M,K,N", [(8, 256, 384), (3, 1000, 300), (1, 512, 130), (200, 384, 256)])
def test_q1_plain_matches_jax(M, K, N):
    rng = np.random.default_rng(M + K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = jq.quantize_weight(jnp.asarray(rng.normal(size=(K, N)).astype(np.float32) * 0.05), bits=4)
    i4.int4_matmul.launches = 0
    got = i4.int4_matmul(torch.from_numpy(x), _t(w["q4"]), _t(w["s"])).numpy()
    assert i4.int4_matmul.launches == 0 and got.shape == (M, N)
    _close(got, jax_int4_matmul(jnp.asarray(x), w["q4"], w["s"], interpret=True), 1e-6)
    _close(got, jax_int4_reference(jnp.asarray(x), w["q4"], w["s"]), 1e-6)


@pytest.mark.parametrize("M,K,N", [(8, 2048, 2560), (8, 2048, 2048), (8, 2048, 22016), (8, 11008, 2048),
                                   (200, 2048, 22016), (3, 1000, 300)])
def test_q1_k_split_covers_k(M, K, N):
    per, splits = i4.k_splits(M, K, N)
    assert splits >= 1 and (per % i4.KT == 0 or splits == 1)
    assert (splits - 1) * per < K <= splits * per
    assert splits * -(-N // i4.NT) <= 65535


def _q2_plain_against_jax(M, hid, inter):
    rng = np.random.default_rng(M)
    x = rng.normal(size=(M, hid)).astype(np.float32)
    gu = jq.quantize_weight(jnp.asarray(rng.normal(size=(hid, 2 * inter)).astype(np.float32)))
    dn = jq.quantize_weight(jnp.asarray(rng.normal(size=(inter, hid)).astype(np.float32)))
    want = jax_fused_mlp(jnp.asarray(x), gu["q8"], gu["s"], dn["q8"], dn["s"], interpret=True)
    fm.fused_mlp_int8.launches = 0
    got = fm.fused_mlp_int8(torch.from_numpy(x), _t(gu["q8"]), _t(gu["s"]), _t(dn["q8"]), _t(dn["s"])).numpy()
    assert fm.fused_mlp_int8.launches == 0
    _close(got, want, 1e-5)


@pytest.mark.parametrize("M", [1, 4, 7, 8, 16])
def test_q2_plain_matches_jax(M):
    _q2_plain_against_jax(M, 256, 384)


def test_q2_plain_matches_jax_ragged():
    """A narrow shape both kernels take whose inter is no multiple of 256
    (the TPU kernel's 128-column blocks; five 64-column blocks here)."""
    _q2_plain_against_jax(3, 128, 640)


def test_fused_mlp_eligibility_matches_jax():
    """The port's eligibility is JAX's layout rule (int8 gu and down; int4 is
    not eligible) without its TPU block shapes: where JAX's blocks refuse a
    shape (hid 192, inter 200) the port stays eligible, and the Q2 wrapper
    raises on a CUDA shape its kernel cannot take."""
    from time_r1_tpu.ops.fused_mlp import fused_mlp_eligible as jax_eligible

    rng = np.random.default_rng(0)
    for hid, inter, bits, jax_takes in ((256, 384, 8, True), (256, 384, 4, False), (192, 384, 8, False),
                                        (256, 200, 8, False)):
        w = {"gu": rng.normal(size=(hid, 2 * inter)).astype(np.float32),
             "down_w": rng.normal(size=(inter, hid)).astype(np.float32)}
        jmlp = {k: jq.quantize_weight(jnp.asarray(v), bits=bits) for k, v in w.items()}
        tmlp = {k: tq.quantize_weight(_t(v), bits=bits) for k, v in w.items()}
        assert jax_eligible(jmlp, hid) == jax_takes
        assert fm.fused_mlp_eligible(tmlp) == (bits == 8)
    assert not fm.fused_mlp_eligible({"gate_w": tmlp["gu"], "down_w": tmlp["down_w"]})


def test_mlp_proj_on_cpu_takes_the_unfused_path():
    rng = np.random.default_rng(1)
    hid, inter = 128, 256
    gate, up = rng.normal(size=(hid, inter)) * 0.1, rng.normal(size=(hid, inter)) * 0.1
    jmlp = {"gu": jq.quantize_weight(jnp.asarray(np.concatenate([gate, up], -1), jnp.float32)),
            "down_w": jq.quantize_weight(jnp.asarray(rng.normal(size=(inter, hid)) * 0.1, jnp.float32))}
    tmlp = {k: {n: _t(a) for n, a in v.items()} for k, v in jmlp.items()}
    h = (rng.normal(size=(2, 3, hid)) * 0.5).astype(np.float32)
    fm.fused_mlp_int8.launches = 0
    got = tq.mlp_proj(torch.from_numpy(h), tmlp).numpy()
    assert fm.fused_mlp_int8.launches == 0
    np.testing.assert_allclose(got, np.asarray(jq.mlp_proj(jnp.asarray(h), jmlp)), atol=2e-5, rtol=2e-5)
