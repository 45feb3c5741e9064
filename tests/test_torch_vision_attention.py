"""The port's vision attention (K2 window, K3 full-slice) on CPU tensors, i.e.
their plain versions, against the JAX Pallas kernels run with
interpret=True, at the shapes of tests/test_vision_attention.py, including a
dead tail window and pad keys in a slice."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from time_r1_tpu.ops.vision_attention import full_attention_rope as jax_full
from time_r1_tpu.ops.vision_attention import window_attention_rope as jax_window
from time_r1_tpu_torch.ops.attention import NEG_INF
from time_r1_tpu_torch.ops.vision_attention import (
    full_attention_rope,
    window_attention_rope,
    window_attention_rope_plain,
)

torch.set_num_threads(2)


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("win,pack,nh,hd", [(16, 2, 3, 8), (64, 2, 2, 16)])
def test_window_matches_jax_kernel(win, pack, nh, hd):
    rng = np.random.default_rng(1)
    P = win * pack * 2  # 2 packed TPU blocks
    q, k, v = (_rand(rng, P, nh, hd) for _ in range(3))
    cos, sin = _rand(rng, P, hd), _rand(rng, P, hd)
    key_valid = np.ones((P,), bool)
    key_valid[-win:] = False  # last window entirely pad
    key_valid[3] = False  # one pad key inside a live window
    key_bias = np.where(key_valid, 0.0, NEG_INF).astype(np.float32)

    want = np.asarray(jax_window(*map(jnp.asarray, (q, k, v, cos, sin, key_bias)), win, pack, interpret=True))
    window_attention_rope.launches = 0
    got = window_attention_rope(*map(torch.from_numpy, (q, k, v, cos, sin, key_bias)), win).numpy()
    assert window_attention_rope.launches == 0
    # rows of dead windows differ from the packed TPU version and are never read
    np.testing.assert_allclose(got[key_valid], want[key_valid], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n_slices,S,nh,hd,n_dead", [(3, 24, 3, 8, 5), (2, 64, 2, 16, 17)])
def test_full_matches_jax_kernel(n_slices, S, nh, hd, n_dead):
    rng = np.random.default_rng(2)
    q, k, v = (_rand(rng, n_slices, S, nh, hd) for _ in range(3))
    cos, sin = _rand(rng, n_slices, S, hd), _rand(rng, n_slices, S, hd)
    bias = np.zeros((n_slices, S), np.float32)
    bias[-1, S - n_dead:] = NEG_INF  # -1 sentinels of a shorter slice
    bias[0, 1] = NEG_INF  # a dead patch slot inside a slice

    want = np.asarray(jax_full(*map(jnp.asarray, (q, k, v, cos, sin, bias)), interpret=True))
    full_attention_rope.launches = 0
    got = full_attention_rope(*map(torch.from_numpy, (q, k, v, cos, sin, bias))).numpy()
    assert full_attention_rope.launches == 0
    valid = bias == 0
    np.testing.assert_allclose(got[valid], want[valid], rtol=2e-5, atol=2e-5)


def test_window_plain_is_full_plain_on_one_slice_per_window():
    """K2's function is K3's with every window a slice of its own."""
    rng = np.random.default_rng(3)
    win, nh, hd, n_win = 16, 2, 8, 3
    P = win * n_win
    q, k, v = (torch.from_numpy(_rand(rng, P, nh, hd)) for _ in range(3))
    cos, sin = torch.from_numpy(_rand(rng, P, hd)), torch.from_numpy(_rand(rng, P, hd))
    bias = torch.zeros(P)
    bias[5] = NEG_INF
    a = window_attention_rope_plain(q, k, v, cos, sin, bias, win)

    def s(x):
        return x.reshape(n_win, win, *x.shape[1:])

    b = full_attention_rope(s(q), s(k), s(v), s(cos), s(sin), s(bias)).reshape(P, nh, hd)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
