"""The port's flash attention (K1) on CPU tensors, i.e. its plain version,
against the JAX Pallas kernel run in interpret mode, on the cases of
tests/test_flash_attention.py: GQA, left padding, a cached prefix
(q_offset=128) and non-causal attention."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from time_r1_tpu.ops.flash_attention import _flash_fwd, _resolve_blocks
from time_r1_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from time_r1_tpu_torch.ops.attention import NEG_INF, mha_reference
from time_r1_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_fwd,
    flash_attention_plain,
)

torch.set_num_threads(2)

CASES = [
    # (B, Sq, Skv, H, Hkv, D, causal, q_offset, n_pad)
    (2, 128, 128, 4, 2, 64, True, 0, 0),
    (1, 256, 256, 4, 4, 64, True, 0, 32),
    (2, 128, 256, 4, 2, 64, True, 128, 0),  # cached prefix (decode-chunk)
    (1, 128, 128, 2, 1, 64, False, 0, 16),
]


def _inputs(B, Sq, Skv, H, Hkv, D, n_pad, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    kv_bias = np.zeros((B, Skv), np.float32)
    kv_bias[:, :n_pad] = NEG_INF  # left padding
    return q, k, v, kv_bias


def _valid_rows(Sq, causal, q_offset, n_pad):
    """Rows whose keys are all masked are garbage in every implementation."""
    valid = np.ones((Sq,), bool)
    if n_pad:
        valid[: max(0, n_pad - q_offset)] = False
    return valid


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,q_offset,n_pad", CASES)
def test_flash_matches_jax_kernel(B, Sq, Skv, H, Hkv, D, causal, q_offset, n_pad):
    q, k, v, kv_bias = _inputs(B, Sq, Skv, H, Hkv, D, n_pad)
    want = np.asarray(jax_flash_attention(*map(jnp.asarray, (q, k, v, kv_bias)), causal, None, q_offset))
    flash_attention_fwd.launches = 0
    got = flash_attention(*map(torch.from_numpy, (q, k, v, kv_bias)), causal, None, q_offset).numpy()
    assert flash_attention_fwd.launches == 0  # CPU tensors never reach the kernel
    valid = _valid_rows(Sq, causal, q_offset, n_pad)
    np.testing.assert_allclose(got[:, valid], want[:, valid], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,q_offset,n_pad", CASES)
def test_flash_lse_matches_jax_kernel(B, Sq, Skv, H, Hkv, D, causal, q_offset, n_pad):
    """The log-sum-exp that the backward slice will consume, against the
    Pallas forward's (B, H, Sq) output."""
    q, k, v, kv_bias = _inputs(B, Sq, Skv, H, Hkv, D, n_pad, seed=1)
    jq, jk, jv, jb = map(jnp.asarray, (q, k, v, kv_bias))
    bq, bk = _resolve_blocks(jq, jk, q_offset, 0, 0)
    _, want = _flash_fwd(jq, jk, jv, jb, causal, D**-0.5, q_offset, bq, bk)
    _, got = flash_attention_plain(*map(torch.from_numpy, (q, k, v, kv_bias)), causal, None, q_offset)
    valid = _valid_rows(Sq, causal, q_offset, n_pad)
    np.testing.assert_allclose(got.numpy()[:, :, valid], np.asarray(want)[:, :, valid], atol=2e-5, rtol=2e-5)


def test_flash_plain_matches_grouped_reference():
    """flash_attention_plain == mha_reference with the same causal + pad bias,
    in bf16 as well as f32 (the output keeps the operand dtype)."""
    B, Sq, Skv, H, Hkv, D, q_offset, n_pad = 2, 64, 96, 4, 2, 32, 32, 40
    q, k, v, kv_bias = map(torch.from_numpy, _inputs(B, Sq, Skv, H, Hkv, D, n_pad, seed=2))
    q_pos = q_offset + torch.arange(Sq)[:, None]
    causal = torch.where(torch.arange(Skv)[None, :] <= q_pos, 0.0, NEG_INF)
    want = mha_reference(q, k, v, bias=kv_bias[:, None, None, :] + causal)
    valid = torch.from_numpy(_valid_rows(Sq, True, q_offset, n_pad))
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        got = flash_attention(q.to(dtype), k.to(dtype), v.to(dtype), kv_bias, True, None, q_offset)
        assert got.dtype == dtype
        torch.testing.assert_close(got.float()[:, valid], want[:, valid], atol=tol, rtol=tol)
