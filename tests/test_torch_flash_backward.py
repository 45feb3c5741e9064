"""The flash attention backward of the port (B1 `flash_bwd_dq`, B2
`flash_bwd_dkv` and the autograd Function `flash_attention`) on CPU tensors,
i.e. their plain FA-2 versions, against the JAX package: the Pallas
`_flash_bwd_dq` / `_flash_bwd_dkv` in interpret mode on the same lse and
delta, and `jax.grad` of its `flash_attention`, on the cases of
tests/test_flash_attention.py (GQA, left padding, a cached prefix, non-causal).

Cotangents are zero on query rows that see no key (left padding): those rows
are finite garbage in every implementation, and the loss never reads them.
Tolerance 5e-4, the JAX package's own for its gradients (f32, sums over up
to 256 keys in another order).

The JAX package's per-head `_flash_bwd_dkv` branch (G == 1,
`flash_attention.py:400`) maps lse/delta to block (b, h, 0) of a (B·H, 1, Sq)
array, which is another head's row for h > 0, so its dK/dV are wrong there.
The training path never takes it (Qwen2.5-VL-3B has G = 8). The G == 1 case
is held against `jax.grad` of the JAX package's plain `mha_reference`
instead (ROADMAP §C)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_flash_attention import CASES, _inputs, _valid_rows
from time_r1_tpu.ops.attention import mha_reference as jax_mha_reference
from time_r1_tpu.ops.flash_attention import _flash_bwd_dkv, _flash_bwd_dq, _resolve_blocks
from time_r1_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from time_r1_tpu_torch.ops.attention import NEG_INF
from time_r1_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    flash_bwd_dkv,
    flash_bwd_dq,
)

torch.set_num_threads(2)

TOL = dict(atol=5e-4, rtol=5e-4)


def _jax_reference_grads(q, k, v, kv_bias, g, causal, q_offset):
    """jax.grad of the JAX package's plain attention with the same masks."""
    Sq, Skv = q.shape[1], k.shape[1]
    bias = jnp.asarray(kv_bias)[:, None, None, :]
    if causal:
        allowed = jnp.arange(Skv)[None, :] <= q_offset + jnp.arange(Sq)[:, None]
        bias = bias + jnp.where(allowed, 0.0, NEG_INF)[None, None]

    def f(q, k, v):
        return jnp.sum(jax_mha_reference(q, k, v, bias=bias) * g)

    return jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _cotangent(B, Sq, H, D, causal, q_offset, n_pad, seed=7):
    g = np.random.default_rng(seed).normal(size=(B, Sq, H, D)).astype(np.float32)
    g[:, ~_valid_rows(Sq, causal, q_offset, n_pad)] = 0.0
    return g


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,q_offset,n_pad", CASES)
def test_bwd_plain_matches_jax_kernels(B, Sq, Skv, H, Hkv, D, causal, q_offset, n_pad):
    q, k, v, kv_bias = _inputs(B, Sq, Skv, H, Hkv, D, n_pad)
    do = _cotangent(B, Sq, H, D, causal, q_offset, n_pad)
    tq, tk, tv, tb, tdo = map(torch.from_numpy, (q, k, v, kv_bias, do))
    out, lse = flash_attention_plain(tq, tk, tv, tb, causal, None, q_offset)
    delta = (tdo * out).sum(-1)  # (B, Sq, H)

    flash_bwd_dq.launches = flash_bwd_dkv.launches = 0
    dq = flash_bwd_dq(tq, tk, tv, tb, tdo, lse, delta, causal, None, q_offset).numpy()
    dk, dv = (t.numpy() for t in flash_bwd_dkv(tq, tk, tv, tb, tdo, lse, delta, causal, None, q_offset))
    assert flash_bwd_dq.launches == flash_bwd_dkv.launches == 0  # CPU tensors never reach a kernel

    jq, jk, jv, jb, jdo = map(jnp.asarray, (q, k, v, kv_bias, do))
    bq, bk = _resolve_blocks(jq, jk, q_offset, 0, 0)
    jlse, jdelta = jnp.asarray(lse.numpy()), jnp.asarray(delta.numpy())
    scale = D ** -0.5
    want_dq = _flash_bwd_dq(jq, jk, jv, jb, jdo, jlse, jdelta, causal, scale, q_offset, bq, bk)
    if H // Hkv > 1:
        want_dk, want_dv = _flash_bwd_dkv(jq, jk, jv, jb, jdo, jlse, jdelta, causal, scale, q_offset, bq, bk)
    else:  # the JAX per-head branch is wrong for h > 0 (module docstring)
        _, want_dk, want_dv = _jax_reference_grads(q, k, v, kv_bias, do, causal, q_offset)
    np.testing.assert_allclose(dq, np.asarray(want_dq), **TOL)
    np.testing.assert_allclose(dk, np.asarray(want_dk), **TOL)
    np.testing.assert_allclose(dv, np.asarray(want_dv), **TOL)


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,q_offset,n_pad", CASES)
def test_flash_attention_grads_match_jax(B, Sq, Skv, H, Hkv, D, causal, q_offset, n_pad):
    q, k, v, kv_bias = _inputs(B, Sq, Skv, H, Hkv, D, n_pad)
    g = _cotangent(B, Sq, H, D, causal, q_offset, n_pad)

    def f(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, jnp.asarray(kv_bias), causal, None, q_offset) * g)

    if H // Hkv > 1:
        want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    else:  # the JAX per-head branch is wrong for h > 0 (module docstring)
        want = _jax_reference_grads(q, k, v, kv_bias, g, causal, q_offset)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, torch.from_numpy(kv_bias), causal, None, q_offset)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


def test_backward_is_the_fa2_formula_not_autograd_of_the_forward():
    """The Function's backward gives the gradient of the plain forward on every
    row that sees a key, so the FA-2 formula and autograd agree where it counts
    (f32, 1e-5)."""
    B, Sq, Skv, H, Hkv, D, causal, q_offset, n_pad = CASES[1]
    q, k, v, kv_bias = _inputs(B, Sq, Skv, H, Hkv, D, n_pad)
    g = torch.from_numpy(_cotangent(B, Sq, H, D, causal, q_offset, n_pad))
    grads = []
    for fn in (lambda *a: flash_attention(*a), lambda *a: flash_attention_plain(*a)[0]):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out = fn(tq, tk, tv, torch.from_numpy(kv_bias), causal, None, q_offset)
        grads.append(torch.autograd.grad((out * g).sum(), (tq, tk, tv)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
