"""The numerics of the tensor-core D2 (the G-way decode step's attention) and
K2 (vision window attention with the rope), emulated in torch on the CPU,
against the JAX package's Pallas kernels in interpret mode (products in f32):

- (a) D2: bf16 q and new token; caches bf16 or int8 (converted exactly, K
  scales on S, V scales on P before its bf16 rounding, the new token
  unquantized). Prefix blocks of `tc_chunk_tiles` 64-key tiles (the
  wrapper's chunk length) and one suffix block per rollout row over its live
  suffix and the new token, each block's tiles split between two warpgroups
  (even and odd tiles) whose states merge; per 64-key tile S = q·kᵀ in f32
  with the scale, the bias, the mask floor (a key at NEG_INF gets
  probability 0) and an online max, the running sum on the unrounded P, P
  rounded to bf16 before P·V; then the fold of the chunks and the suffix slot in slot order,
  weights exp(m_s - m) / l, out in bf16. Against
  `time_r1_tpu.ops.decode_attention.shared_prefix_decode_full` with a fully
  masked first chunk, own_len 0, 1 and 199, a prefix that is not a multiple
  of the chunk, N = 56 (G = 7, the 7B rollout), N = 128 and 112 (16
  rollouts a prompt: a row's arithmetic does not depend on the 64-row tile
  the kernel puts it in) and P = 2 prompts: within
  1e-2 of max |JAX| (every row is valid: the new token is always live), as
  `chip_smoke.py` holds the kernel to its plain version (DECODE_TOL);
- (b) K2: the rope in f32, rope(q)·hd^-0.5 and rope(k) rounded to bf16, one
  64-key tile per (window, head), P rounded to bf16 before P·V. Against
  `window_attention_rope` at head dim 80 with a window whose keys are all
  dead (its rows must stay finite; the packed TPU kernel gives them other
  values, and no caller reads them) and dead keys elsewhere, on live rows,
  within the same tolerance;
- (c) on CPU tensors both wrappers run their plain versions and count no
  launch, tensor-core or other."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from time_r1_tpu.ops.decode_attention import shared_prefix_decode_full as jax_decode_full
from time_r1_tpu.ops.vision_attention import window_attention_rope as jax_window
from time_r1_tpu_torch.ops import decode_attention as da
from time_r1_tpu_torch.ops.attention import NEG_INF, rope
from time_r1_tpu_torch.ops.vision_attention import window_attention_rope

torch.set_num_threads(2)

TC_TOL = 1e-2  # max |emulation - JAX| / max |JAX| on valid rows


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tc_block(q, k, v, ks, vs, bias):
    """One D2 block: q rows (n, D) against keys (L, D) in 64-key tiles, with
    per-key scales (or None) and an additive bias, the even tiles in one
    warpgroup and the odd ones in the other: the merged unnormalised (acc,
    m, l)."""
    (o0, m0, l0), (o1, m1, l1) = (_tc_warpgroup(q, k, v, ks, vs, bias, wg) for wg in (0, 1))
    m = torch.maximum(m0, m1)
    a0, a1 = torch.exp(m0 - m), torch.exp(m1 - m)
    return o0 * a0[:, None] + o1 * a1[:, None], m, l0 * a0 + l1 * a1


def _tc_warpgroup(q, k, v, ks, vs, bias, wg):
    """One warpgroup's online softmax over tiles wg, wg + 2, ... ."""
    scale = q.shape[-1] ** -0.5
    m = torch.full((q.shape[0], 1), NEG_INF)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape[0], v.shape[-1])
    for k0 in range(64 * wg, k.shape[0], 128):
        s = (q @ k[k0:k0 + 64].T) * scale
        if ks is not None:
            s = s * ks[k0:k0 + 64]
        s = s + bias[k0:k0 + 64]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m_new), torch.zeros_like(s))  # the mask floor
        l = l * alpha + p.sum(-1, keepdim=True)  # the unrounded f32 P
        if vs is not None:
            p = p * vs[k0:k0 + 64]
        o = o * alpha + _bf16(p) @ v[k0:k0 + 64]
        m = m_new
    return o, m[:, 0], l[:, 0]


def tc_decode_full(q, kp, vp, ks, vs, bias, ko, vo, kso, vso, own_len, kn, vn):
    """The tensor-core D2's arithmetic (csrc/decode_attention.cu): operands
    as f32 tensors in the JAX kernel's head-major layouts, bf16-valued q and
    new token, int8-valued caches where ks is given. (P, Hkv, N, D) bf16 as f32."""
    P, Hkv, N, D = q.shape
    Lp = kp.shape[2]
    R = ko.shape[0] // P
    G = N // R
    ct = da.tc_chunk_tiles(Lp, N, ks is not None)
    chunk = 64 * ct
    out = torch.empty(P, Hkv, N, D)
    for p_ in range(P):
        for h in range(Hkv):
            slots = []  # (acc (N, D), m (N,), l (N,)), slot order: prefix chunks, then the suffix
            for c0 in range(0, Lp, chunk):
                sl = slice(c0, c0 + chunk)
                slots.append(_tc_block(q[p_, h], kp[p_, h, sl], vp[p_, h, sl],
                                       None if ks is None else ks[p_, h, sl],
                                       None if vs is None else vs[p_, h, sl], bias[p_, sl]))
            acc, m, l = torch.zeros(N, D), torch.zeros(N), torch.zeros(N)
            for r in range(R):
                b, rows = p_ * R + r, slice(r * G, (r + 1) * G)
                k = torch.cat([ko[b, h, :own_len], kn[b, h][None]])
                v = torch.cat([vo[b, h, :own_len], vn[b, h][None]])
                one = torch.ones(1)
                sk = None if kso is None else torch.cat([kso[b, h, :own_len], one])
                sv = None if vso is None else torch.cat([vso[b, h, :own_len], one])
                acc[rows], m[rows], l[rows] = _tc_block(q[p_, h, rows], k, v, sk, sv, torch.zeros(own_len + 1))
            slots.append((acc, m, l))
            m_all = torch.stack([s[1] for s in slots])  # (slots, N)
            m_tot = m_all.amax(0)
            w = torch.exp(m_all - m_tot)
            inv = 1.0 / (w * torch.stack([s[2] for s in slots])).sum(0)
            o = torch.zeros(N, D)
            for (a, _, _), ws in zip(slots, w):
                o = o + (ws * inv)[:, None] * a
            out[p_, h] = _bf16(o)
    return out


D2_CASES = [
    # (P, R, H, Hkv, D, Lp, Lo, pad, int8, own_len)
    (1, 8, 16, 2, 128, 384, 200, 300, False, 199),  # pad 300 masks the first 256-key chunk whole;
    (1, 8, 16, 2, 128, 384, 200, 300, False, 1),  # Lp 384 is 1.5 chunks
    (1, 8, 16, 2, 128, 384, 200, 150, False, 0),  # pad 150: two whole tiles, one per warpgroup
    (1, 8, 16, 2, 128, 384, 200, 300, True, 199),
    (1, 8, 16, 2, 128, 384, 200, 300, True, 0),
    (1, 8, 14, 2, 128, 256, 64, 20, False, 1),  # N = 56: G = 7, the 7B rollout's rows
    (1, 8, 14, 2, 128, 640, 64, 20, True, 40),
    (2, 4, 8, 2, 64, 256, 32, 70, False, 17),  # P = 2 prompts, head dim 64
    (2, 4, 8, 2, 64, 256, 32, 70, True, 31),
    (1, 16, 16, 2, 64, 256, 32, 70, False, 9),  # 16 rollouts: N = 128, two 64-row tiles
    (1, 16, 14, 2, 64, 256, 32, 70, True, 31),  # N = 112 at G = 7: the second tile ragged
]


@pytest.mark.parametrize("P,R,H,Hkv,D,Lp,Lo,pad,int8,own_len", D2_CASES)
def test_d2_tc_rounding_stays_within_the_kernels_tolerance(P, R, H, Hkv, D, Lp, Lo, pad, int8, own_len):
    """(a): the emulated tensor-core D2 against JAX's kernel on the same
    bf16-valued activations and the same caches."""
    rng = np.random.default_rng(P * 1000 + Lp + own_len)
    B, G = P * R, H // Hkv
    N = R * G
    q, kn, vn = (_bf16(torch.from_numpy(rng.normal(size=s).astype(np.float32))).numpy()
                 for s in ((P, Hkv, N, D), (B, Hkv, D), (B, Hkv, D)))
    caches, scales = {}, {}
    for n, shape in (("kp", (P, Hkv, Lp, D)), ("vp", (P, Hkv, Lp, D)), ("ko", (B, Hkv, Lo, D)), ("vo", (B, Hkv, Lo, D))):
        if int8:
            caches[n] = rng.integers(-127, 128, size=shape).astype(np.int8)
            scales[n] = rng.uniform(0.005, 0.03, size=shape[:3]).astype(np.float32)
        else:
            caches[n] = _bf16(torch.from_numpy(rng.normal(size=shape).astype(np.float32))).numpy()
            scales[n] = None
    bias = np.broadcast_to(np.where(np.arange(Lp) < pad, NEG_INF, 0.0).astype(np.float32), (P, Lp)).copy()
    bias_own = np.where(np.arange(Lo) < own_len, 0.0, NEG_INF).astype(np.float32)

    def j(x):
        return None if x is None else jnp.asarray(x)

    want = np.asarray(jax_decode_full(
        j(q), j(caches["kp"]), j(caches["vp"]), j(scales["kp"]), j(scales["vp"]), j(bias),
        j(caches["ko"]), j(caches["vo"]), j(scales["ko"]), j(scales["vo"]), j(bias_own), j(kn), j(vn),
        interpret=True)).astype(np.float32)

    def t(x):
        return None if x is None else torch.from_numpy(x).float()

    got = tc_decode_full(t(q), t(caches["kp"]), t(caches["vp"]), t(scales["kp"]), t(scales["vp"]), t(bias),
                         t(caches["ko"]), t(caches["vo"]), t(scales["ko"]), t(scales["vo"]), own_len,
                         t(kn), t(vn)).numpy()
    assert np.isfinite(got).all()
    assert _rel(got, want) <= TC_TOL
    assert np.abs(got - want).max() > 0  # the rounding is there to see


@pytest.mark.parametrize("Lp,N,int8,want", [
    (2048, 64, False, 4),  # the 3B rollout: 8 chunks of 256 keys a kv head
    (2048, 64, True, 4),  # int8 too
    (2048, 56, False, 4),  # the 7B rollout's 56 rows
    (2000, 64, False, 4),  # a partial last tile and chunk
    (100, 64, True, 2),  # a prefix shorter than the chunk: one chunk of its 2 tiles
    (2048, 256, True, 16),  # 256 rows: the partials set the chunk
    (32768, 64, False, 8),  # at most 64 chunks: the fold's slots
])
def test_d2_chunk_length_keeps_partials_at_most_half_the_kv(Lp, N, int8, want):
    """The chunk length rule of the tensor-core D2: at least 4 tiles, a
    prefix block's f32 partials at most half its K/V, at most 64 chunks."""
    ct = da.tc_chunk_tiles(Lp, N, int8)
    assert ct == want
    nchunk = -(-Lp // (64 * ct))
    assert nchunk <= da.TC_MAX_CHUNKS
    if ct < -(-Lp // 64):  # a full chunk: its partials against its K/V
        assert N * 4 <= ct * 64 * 2 * (1 if int8 else 2) / 2


def tc_window_forward(q, k, v, cos, sin, key_bias, win):
    """K2's tensor-core arithmetic on bf16-valued q/k/v (P, nh, hd), f32
    cos/sin (P, hd) and key_bias (P,), windows of `win` <= 64 rows: one key
    tile per (window, head). (P, nh, hd) bf16 as f32."""
    P, nh, hd = q.shape
    n = P // win
    c, s_ = cos.reshape(n, win, 1, hd), sin.reshape(n, win, 1, hd)
    qh = _bf16(rope(q.reshape(n, win, nh, hd), c, s_) * hd**-0.5).transpose(1, 2)  # (n, nh, win, hd)
    kh = _bf16(rope(k.reshape(n, win, nh, hd), c, s_)).transpose(1, 2)
    s = qh @ kh.transpose(-1, -2) + key_bias.reshape(n, 1, 1, win)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = _bf16(p) @ v.reshape(n, win, nh, hd).transpose(1, 2)
    return _bf16(o / p.sum(-1, keepdim=True)).transpose(1, 2).reshape(P, nh, hd)


@pytest.mark.parametrize("nh,seed", [(2, 0), (3, 1)])
def test_k2_tc_rounding_stays_within_the_kernels_tolerance(nh, seed):
    """(b): the emulated tensor-core K2 against JAX's kernel at head dim 80,
    four 64-row windows, the last one dead, and 5% dead keys elsewhere."""
    hd, win = 80, 64
    P = 4 * win
    rng = np.random.default_rng(seed)
    q, k, v = (_bf16(torch.from_numpy(rng.normal(size=(P, nh, hd)).astype(np.float32))).numpy() for _ in range(3))
    theta = rng.uniform(0, 20, size=(P, hd)).astype(np.float32)
    cos, sin = np.cos(theta), np.sin(theta)
    dead = (np.arange(P) >= P - win) | (rng.uniform(size=P) < 0.05)
    bias = np.where(dead, NEG_INF, 0.0).astype(np.float32)

    want = np.asarray(jax_window(*map(jnp.asarray, (q, k, v, cos, sin, bias)), win, interpret=True))
    got = tc_window_forward(*map(torch.from_numpy, (q, k, v, cos, sin, bias)), win).numpy()
    assert np.isfinite(got).all()  # the dead window's rows too
    live = ~dead
    assert _rel(got[live], want[live]) <= TC_TOL
    assert np.abs(got[live] - want[live]).max() > 0


def test_cpu_tensors_run_the_plain_versions_and_count_no_launch():
    """(c): given CPU tensors, D2 (bf16 and int8 caches) and K2 run their
    plain versions in either dtype and count no launch, tensor-core or FMA."""
    rng = np.random.default_rng(3)
    da.shared_prefix_decode_full.launches = da.shared_prefix_decode_full.tc_launches = 0
    window_attention_rope.launches = window_attention_rope.tc_launches = 0
    P, R, Hkv, G, D, Lp, Lo = 1, 2, 2, 4, 64, 128, 8

    def f(*shape, dtype):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        q = f(P, Hkv, R * G, D, dtype=dtype)
        bias = torch.zeros(P, Lp)
        new = (f(P * R, Hkv, D, dtype=dtype), f(P * R, Hkv, D, dtype=dtype))
        kv = (f(P, Hkv, Lp, D, dtype=dtype), f(P, Hkv, Lp, D, dtype=dtype))
        own = (f(P * R, Hkv, Lo, D, dtype=dtype), f(P * R, Hkv, Lo, D, dtype=dtype))
        out = da.shared_prefix_decode_full(q, *kv, None, None, bias, *own, None, None, 3, *new)
        assert out.dtype == dtype and out.shape == q.shape
        kv8 = tuple(torch.from_numpy(rng.integers(-127, 128, size=(P, Hkv, Lp, D)).astype(np.int8)) for _ in range(2))
        own8 = tuple(torch.from_numpy(rng.integers(-127, 128, size=(P * R, Hkv, Lo, D)).astype(np.int8))
                     for _ in range(2))
        sp, so = torch.full((P, Hkv, Lp), 0.01), torch.full((P * R, Hkv, Lo), 0.01)
        out = da.shared_prefix_decode_full(q, *kv8, sp, sp, bias, *own8, so, so, 3, *new)
        assert out.dtype == dtype and torch.isfinite(out.float()).all()
        qv = f(128, 2, 80, dtype=dtype)
        cs = f(128, 80, dtype=torch.float32)
        assert window_attention_rope(qv, qv, qv, cs, cs, torch.zeros(128), 64).dtype == dtype
    assert da.shared_prefix_decode_full.launches == da.shared_prefix_decode_full.tc_launches == 0
    assert window_attention_rope.launches == window_attention_rope.tc_launches == 0
