"""The numerics of the tensor-core S1/S2 kernels, emulated in torch on the
CPU, against the JAX package's `flash_attention_shared_prefix` (its Pallas
kernels in interpret mode, products in f32):

- (a) the bf16 rounding the kernels apply: P (and, in the backward, dS)
  rounded to bf16 before their products, the scores, the softmax statistics,
  the scale and the accumulators in f32, the forward walked in 64-key tiles
  with an online max, out and dq stored in bf16. At this file's shapes, with
  bf16 inputs, the emulation stays within 1e-2 of max |JAX| for the output
  and for every gradient: the tolerance (`GRAD_TOL` of chip_smoke.py) that
  the kernels are held to on the card;
- (b) `bwd_dkv_split`, the split of the prefix dK/dV's R·G (row, q head)
  pairs over blocks: it divides R·G, fills two blocks per SM where the shape
  allows, gives 8 at the split-loss shape and leaves B2's (R = 1) as it was;
- (c) the split's partial sums folded in a fixed order equal the unsplit sum
  over the R·G pairs to f32 reassociation (1e-6)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_shared_prefix import _sp_inputs
from time_r1_tpu.ops.flash_attention import flash_attention_shared_prefix as jax_sp
from time_r1_tpu_torch.ops.attention import NEG_INF
from time_r1_tpu_torch.ops.flash_attention import SMS, bwd_dkv_split

torch.set_num_threads(2)

BK = 64  # the kernels' key tile
TC_TOL = 1e-2  # max |emulation - JAX| / max |JAX| per output (chip_smoke.py GRAD_TOL, bf16)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _keys(kp, vp, ko, vo, pb, R):
    """Row b's keys, values and additive scores bias (B, Hkv, Lp + Sc, ...):
    [the prefix of prompt b // R with its bias | its own chunk], causal on
    the own chunk."""
    B, Sc = ko.shape[:2]
    Lp = kp.shape[1]
    k = torch.cat([kp.repeat_interleave(R, 0), ko], 1).transpose(1, 2)  # (B, Hkv, L, D)
    v = torch.cat([vp.repeat_interleave(R, 0), vo], 1).transpose(1, 2)
    i = torch.arange(Sc)
    causal = torch.where(i[None, :] <= i[:, None], 0.0, NEG_INF)  # (Sc, Sc)
    bias = torch.cat([pb.repeat_interleave(R, 0)[:, None, :].expand(B, Sc, Lp), causal.expand(B, Sc, Sc)], -1)
    return k, v, bias[:, None, None]  # bias (B, 1, 1, Sc, L)


def tc_forward(q, kp, vp, ko, vo, pb, scale):
    """S1's tensor-core arithmetic: (out in bf16 as f32, lse f32)."""
    B, Sc, H, D = q.shape
    P, Lp, Hkv, _ = kp.shape
    G = H // Hkv
    k, v, bias = _keys(kp, vp, ko, vo, pb, B // P)
    qg = q.reshape(B, Sc, Hkv, G, D).permute(0, 2, 3, 1, 4)  # (B, Hkv, G, Sc, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k) * scale + bias
    m = torch.full((B, Hkv, G, Sc, 1), NEG_INF)
    l = torch.zeros_like(m)
    o = torch.zeros(B, Hkv, G, Sc, D)
    for k0 in range(0, s.shape[-1], BK):  # prefix tiles, then own tiles (Lp % 64 == 0)
        x = s[..., k0:k0 + BK]
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)  # the unrounded f32 P
        o = o * alpha + torch.einsum("bhgqk,bhkd->bhgqd", _bf16(p), v[:, :, k0:k0 + BK])
        m = m_new
    l_safe = l.clamp_min(1e-30)
    out = _bf16(o / l_safe).permute(0, 3, 1, 2, 4).reshape(B, Sc, H, D)
    return out, (m + torch.log(l_safe)).reshape(B, H, Sc)


def tc_backward(q, kp, vp, ko, vo, pb, do, lse, delta, scale):
    """S2's (and the own chunk's B2) tensor-core arithmetic given the global
    lse (B, H, Sc) and delta (B, Sc, H): (dq in bf16 as f32, dkp, dvp, dko,
    dvo in f32)."""
    B, Sc, H, D = q.shape
    P, Lp, Hkv, _ = kp.shape
    G, R = H // Hkv, B // P
    k, v, bias = _keys(kp, vp, ko, vo, pb, R)
    qg = q.reshape(B, Sc, Hkv, G, D).permute(0, 2, 3, 1, 4)
    dog = do.reshape(B, Sc, Hkv, G, D).permute(0, 2, 3, 1, 4)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k) * scale + bias
    p = torch.exp(s - lse.reshape(B, Hkv, G, Sc, 1))
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v)
    ds = p * (dp - delta.permute(0, 2, 1).reshape(B, Hkv, G, Sc, 1))
    p16, ds16 = _bf16(p), _bf16(ds)
    dq = _bf16(torch.einsum("bhgqk,bhkd->bhgqd", ds16, k) * scale).permute(0, 3, 1, 2, 4).reshape(B, Sc, H, D)
    dv = torch.einsum("bhgqk,bhgqd->bkhd", p16, dog)  # (B, L, Hkv, D), summed over the G heads
    dk = torch.einsum("bhgqk,bhgqd->bkhd", ds16, qg) * scale
    dkp = dk[:, :Lp].reshape(P, R, Lp, Hkv, D).sum(1)
    dvp = dv[:, :Lp].reshape(P, R, Lp, Hkv, D).sum(1)
    return dq, dkp, dvp, dk[:, Lp:], dv[:, Lp:]


@pytest.mark.parametrize("R", [1, 2, 4])
def test_tc_rounding_stays_within_the_kernels_tolerance(R):
    """(a): the emulated tensor-core S1 + S2 against JAX's kernels on the same
    bf16-valued inputs, forward and every gradient, at 1e-2 of max |JAX|."""
    _check_tc_rounding(R=R)


def test_tc_rounding_at_the_7b_head_grouping():
    """(a) at G = 7 (the 7B's 28 q heads over 4 kv heads), head dim 128."""
    _check_tc_rounding(R=2, H=14, Hkv=2, D=128)


def _check_tc_rounding(**shape):
    inputs = _sp_inputs(**shape)
    arrays = [_bf16(torch.from_numpy(a)).numpy() for a in inputs[:5]] + [inputs[5]]
    q, kp, vp, ko, vo, pb = arrays
    g = _bf16(torch.from_numpy(np.random.default_rng(3).normal(size=q.shape).astype(np.float32))).numpy()

    def f(q, kp, vp, ko, vo):
        return jnp.sum(jax_sp(q, kp, vp, ko, vo, jnp.asarray(pb)) * g)

    want_out = np.asarray(jax_sp(*map(jnp.asarray, arrays)))
    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays[:5]))

    t = [torch.from_numpy(a) for a in arrays]
    scale = q.shape[-1] ** -0.5
    out, lse = tc_forward(*t, scale)
    gt = torch.from_numpy(g)
    delta = (gt * out).sum(-1)  # rowsum(dO·O) of the bf16 output, as the autograd Function takes it
    got = tc_backward(*t, gt, lse, delta, scale)
    for name, a, b in zip(("out", "q", "kp", "vp", "ko", "vo"), (out, *got), (want_out, *want)):
        b = np.asarray(b)
        rel = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert rel <= TC_TOL, (name, rel)
        assert rel > 0 or name == "out"  # the rounding is there to see


@pytest.mark.parametrize("G,Skv,Hkv,B,R", [
    (8, 2048, 2, 1, 8),  # S2's prefix dK/dV at the split-loss shape
    (8, 2048, 2, 1, 1),  # B2 at the prompt shape
    (8, 256, 2, 1, 1),  # B2 at the own chunk: G alone is not enough
    (1, 2048, 4, 1, 8),  # G = 1: only the rows split
    (2, 256, 2, 1, 8),  # R·G cannot fill the card: the whole of it
    (4, 640, 2, 2, 4),
    (8, 128, 2, 1, 2),
    (7, 2048, 4, 1, 8),  # the 7B's split loss: G = 7 over 4 kv heads
    (7, 2048, 4, 1, 1),  # B2 at the 7B's prompt
])
def test_dkv_split_divides_rows_times_heads_and_fills_the_card(G, Skv, Hkv, B, R):
    """(b): n_split divides R·G, and the grid has at least two blocks per SM
    where R·G allows it; it is the smallest such divisor."""
    n = bwd_dkv_split(G, Skv, Hkv, B, R)
    blocks = -(-Skv // 64) * Hkv * B
    assert (R * G) % n == 0
    if blocks * R * G >= 2 * SMS:
        assert blocks * n >= 2 * SMS
        assert all(blocks * d < 2 * SMS for d in range(1, n) if (R * G) % d == 0)
    else:
        assert n == R * G
    if (G, Skv, Hkv, B, R) == (8, 2048, 2, 1, 8):
        assert n == 8 and blocks * n == 512
    if R == 1:  # B2's split divides G, as before the rows could split
        assert G % n == 0 and n == bwd_dkv_split(G, Skv, Hkv, B)


@pytest.mark.parametrize("G,R,n_split", [(8, 8, 8), (8, 8, 16), (1, 8, 4), (2, 3, 3)])
def test_split_and_fold_equal_the_unsplit_sum(G, R, n_split):
    """(c): block `split` sums the (row, q head) pairs split·(R·G/n)… in the
    kernel's order (pair = r·G + g, query tiles innermost) and the fold adds
    the n partials in order; against one sum over all pairs, at 1e-6."""
    rng = np.random.default_rng(5)
    n_qt, keys, D = 4, 64, 16
    contrib = torch.from_numpy(rng.normal(size=(R, G, n_qt, keys, D)).astype(np.float32))  # dsᵀ·q per tile
    pairs = R * G // n_split

    def block_sum(split):
        acc = torch.zeros(keys, D)
        for i in range(pairs):
            pair = split * pairs + i
            r, g = divmod(pair, G)
            for t in range(n_qt):
                acc = acc + contrib[r, g, t]
        return acc

    partials = [block_sum(s) for s in range(n_split)]
    folded = partials[0]
    for part in partials[1:]:
        folded = folded + part
    unsplit = torch.zeros(keys, D)
    for r in range(R):
        for g in range(G):
            for t in range(n_qt):
                unsplit = unsplit + contrib[r, g, t]
    np.testing.assert_allclose(folded.numpy(), unsplit.numpy(), rtol=1e-6, atol=1e-6 * unsplit.abs().max().item())
    np.testing.assert_allclose(folded.numpy(), contrib.double().sum((0, 1, 2)).numpy(), rtol=1e-5, atol=1e-5)
