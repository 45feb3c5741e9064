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

On the card, bf16 operands run the tensor-core kernels, which round P and dS
to bf16 before their products: an emulation of that rounding is held against
`jax.grad` of the JAX package's `mha_reference` at the tolerance the card's
checks use, and so are the split of B2's q heads over blocks and its fold.

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
    SMS,
    bwd_dkv_split,
    flash_attention,
    flash_attention_plain,
    flash_bwd_dkv,
    flash_bwd_dkv_plain,
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


# ---------------------------------------------------------------------------
# The tensor-core path's arithmetic (bf16 operands on the card)

GRAD_TOL_BF16 = 1e-2  # max |got - want| / max |want| per output, as chip_smoke.py's phase 2


def _bf16(a: np.ndarray) -> torch.Tensor:
    """The f32 tensor of a's values rounded to bf16."""
    return torch.from_numpy(a).bfloat16().float()


def _per_head_p_ds(q, k, v, kv_bias, do, lse, delta, causal, scale, q_offset):
    """p and ds (B, Hkv, G, Sq, Skv) f32 as the kernels form them: the scale
    multiplies the f32 product of unscaled q and k, then the bias and mask."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Sq, Hkv, G, D), k) * scale
    s = s + kv_bias[:, None, None, None, :]
    if causal:
        allowed = torch.arange(Skv)[None, :] <= q_offset + torch.arange(Sq)[:, None]
        s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse.reshape(B, Hkv, G, Sq, 1))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do.reshape(B, Sq, Hkv, G, D), v)
    return p, p * (dp - delta.permute(0, 2, 1).reshape(B, Hkv, G, Sq, 1))


def _tc_emulation(q, k, v, kv_bias, do, lse, delta, causal, q_offset):
    """(dq, dk, dv) as the tensor-core kernels compute them: P and dS rounded
    to bf16 before their products (f32 accumulation), the scale applied in f32
    to S and to dQ/dK, dq stored in bf16."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = D**-0.5
    p, ds = _per_head_p_ds(q, k, v, kv_bias, do, lse, delta, causal, scale, q_offset)
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dq = (torch.einsum("bhgqk,bkhd->bqhgd", ds16, k) * scale).reshape(B, Sq, H, D).bfloat16().float()
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p16, do.reshape(B, Sq, Hkv, G, D))
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds16, q.reshape(B, Sq, Hkv, G, D)) * scale
    return dq, dk, dv


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,q_offset,n_pad", CASES)
def test_bf16_rounding_of_p_and_ds_stays_within_the_card_tolerance(B, Sq, Skv, H, Hkv, D, causal, q_offset, n_pad):
    """bf16 inputs; lse from the f32 forward, delta from the bf16-rounded
    output (as the training step feeds B1/B2): the kernels' rounding of P and
    dS keeps each gradient within 1e-2 of max |jax.grad of mha_reference|."""
    q, k, v, kv_bias = _inputs(B, Sq, Skv, H, Hkv, D, n_pad)
    q16, k16, v16 = (_bf16(a) for a in (q, k, v))
    do16 = _bf16(_cotangent(B, Sq, H, D, causal, q_offset, n_pad))
    bias = torch.from_numpy(kv_bias)
    out, lse = flash_attention_plain(q16, k16, v16, bias, causal, None, q_offset)
    delta = (do16 * out.bfloat16().float()).sum(-1)
    got = _tc_emulation(q16, k16, v16, bias, do16, lse, delta, causal, q_offset)
    want = _jax_reference_grads(*(t.numpy() for t in (q16, k16, v16)), kv_bias, do16.numpy(), causal, q_offset)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b)
        rel = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert rel <= GRAD_TOL_BF16, f"{name}: {rel}"


# (G, Skv, Hkv, B) -> n_split: the prompt forward and the split loss's own
# chunk of Qwen2.5-VL-3B's training step, then small, ragged and large grids.
SPLITS = [
    ((8, 2048, 2, 1), 8),
    ((8, 256, 2, 8), 8),
    ((8, 4096, 2, 1), 4),
    ((8, 16384, 2, 1), 1),
    ((12, 328, 2, 2), 12),
    ((12, 2000, 2, 1), 6),
    ((1, 64, 4, 1), 1),
    ((4, 8192, 4, 1), 1),
]


@pytest.mark.parametrize("shape,want", SPLITS)
def test_bwd_dkv_split(shape, want):
    """The smallest divisor of G that gives two blocks per SM, else G."""
    G, Skv, Hkv, B = shape
    n = bwd_dkv_split(G, Skv, Hkv, B)
    assert n == want and G % n == 0
    blocks = -(-Skv // 64) * Hkv * B
    if n < G:
        assert blocks * n >= 2 * SMS
    if n > 1:
        assert blocks * (n - 1) < 2 * SMS or G % (n - 1) != 0


def test_bwd_dkv_split_is_8_at_the_training_shapes():
    assert SMS == 132
    assert bwd_dkv_split(8, 2048, 2, 1) == 8  # prompt: 512 blocks
    assert bwd_dkv_split(8, 256, 2, 8) == 8  # own chunk: 512 blocks


SPLIT_CASES = CASES + [(1, 128, 192, 16, 2, 64, True, 64, 16)]  # G = 8


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,q_offset,n_pad", SPLIT_CASES)
def test_split_and_fold_equals_the_head_sum(B, Sq, Skv, H, Hkv, D, causal, q_offset, n_pad):
    """B2's split: n_split blocks each sum G / n_split q heads in order, and
    the fold adds their partials in split order. For every divisor of G that
    equals the unsplit head sum up to f32 reassociation (1e-6 of the max)."""
    q, k, v, kv_bias = (torch.from_numpy(a) for a in _inputs(B, Sq, Skv, H, Hkv, D, n_pad))
    do = torch.from_numpy(_cotangent(B, Sq, H, D, causal, q_offset, n_pad))
    out, lse = flash_attention_plain(q, k, v, kv_bias, causal, None, q_offset)
    delta = (do * out).sum(-1)
    G = H // Hkv
    scale = D**-0.5
    p, ds = _per_head_p_ds(q, k, v, kv_bias, do, lse, delta, causal, scale, q_offset)
    qg, dog = (t.reshape(B, Sq, Hkv, G, D) for t in (q, do))
    dv_h = torch.einsum("bhgqk,bqhgd->gbkhd", p, dog)  # per q head
    dk_h = torch.einsum("bhgqk,bqhgd->gbkhd", ds, qg) * scale
    want = flash_bwd_dkv_plain(q, k, v, kv_bias, do, lse, delta, causal, None, q_offset)
    for n_split in [n for n in range(1, G + 1) if G % n == 0]:
        Gs = G // n_split
        for got_h, w in zip((dk_h, dv_h), want):
            parts = []
            for sp in range(n_split):
                acc = torch.zeros_like(w)
                for g in range(sp * Gs, (sp + 1) * Gs):
                    acc = acc + got_h[g]
                parts.append(acc)
            folded = parts[0]
            for part in parts[1:]:
                folded = folded + part
            assert (folded - w).abs().max() <= 1e-6 * w.abs().max(), n_split
