"""The numerics of the tensor-core attention forwards K1 (flash attention) and
K3 (full-slice vision attention with the rope), emulated in torch on the CPU,
against the JAX package's Pallas kernels in interpret mode (products in f32):

- (a) K1: bf16 q/k/v, S = q·kᵀ in f32 with the scale on S, the key bias and
  the causal mask, 64-key tiles under an online max, P rounded to bf16 before
  P·V (the running sum adds the unrounded f32 P), out stored in bf16, lse =
  m + log max(l, 1e-30). Against `flash_attention` (out) and `_flash_fwd`
  (lse) over left-padded prompts, q_offset, GQA and non-causal cases: within
  1e-2 of max |JAX| on rows that see a real key, as `chip_smoke.py` holds the
  kernel to its plain version (TOL, 2e-2 max abs on outputs of order one);
- (b) K3: the rope in f32, rope(q)·hd^-0.5 and rope(k) rounded to bf16 (the
  kernel ropes them in shared memory before wgmma and does not scale S
  again), then (a)'s softmax without a mask. Against `full_attention_rope` at
  head dim 80 with dead keys, a ragged S and a slice with no live key (whose
  rows must stay finite), within the same tolerance;
- (c) the chunk-pair rope map the K3 kernel walks: rotate_half at hd/2 as 16-byte
  chunks (8 bf16), chunk c paired with chunk (c + hd/16) % (hd/8) and the
  sign of its half, equals the port's `ops/attention.py::rope`;
- and on CPU tensors the K1/K3 wrappers run their plain versions and count
  no launch, tensor-core or other."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from time_r1_tpu.ops.flash_attention import _flash_fwd, _resolve_blocks
from time_r1_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from time_r1_tpu.ops.vision_attention import full_attention_rope as jax_full
from time_r1_tpu_torch.ops.attention import NEG_INF, rope
from time_r1_tpu_torch.ops.flash_attention import flash_attention_fwd
from time_r1_tpu_torch.ops.vision_attention import full_attention_rope

torch.set_num_threads(2)

BK = 64  # the kernels' key tile
TC_TOL = 1e-2  # max |emulation - JAX| / max |JAX| on valid rows


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def tc_softmax_pv(s: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' online softmax over 64-key tiles of f32 scores s (..., Sq,
    Skv) against values v (..., Skv, D): (out in bf16 as f32, lse f32)."""
    m = torch.full((*s.shape[:-1], 1), NEG_INF)
    l = torch.zeros_like(m)
    o = torch.zeros(*s.shape[:-1], v.shape[-1])
    for k0 in range(0, s.shape[-1], BK):
        x = s[..., k0:k0 + BK]
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)  # the unrounded f32 P
        o = o * alpha + _bf16(p) @ v[..., k0:k0 + BK, :]
        m = m_new
    l_safe = l.clamp_min(1e-30)
    return _bf16(o / l_safe), (m + torch.log(l_safe))[..., 0]


def tc_flash_forward(q, k, v, kv_bias, causal, q_offset):
    """K1's tensor-core arithmetic on bf16-valued q (B, Sq, H, D), k/v (B,
    Skv, Hkv, D): (out (B, Sq, H, D), lse (B, H, Sq))."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)  # (B, Hkv, G, Sq, D)
    kt, vt = k.permute(0, 2, 1, 3)[:, :, None], v.permute(0, 2, 1, 3)[:, :, None]  # (B, Hkv, 1, Skv, D)
    s = (qg @ kt.transpose(-1, -2)) * D**-0.5 + kv_bias[:, None, None, None, :]
    if causal:
        hidden = torch.arange(Skv)[None, :] > q_offset + torch.arange(Sq)[:, None]
        s = torch.where(hidden, torch.full_like(s, NEG_INF), s)
    out, lse = tc_softmax_pv(s, vt)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D), lse.reshape(B, H, Sq)


def tc_full_rope_forward(q, k, v, cos, sin, key_bias):
    """K3's tensor-core arithmetic on bf16-valued q/k/v (n, S, nh, hd), f32
    cos/sin (n, S, hd) and key_bias (n, S): out (n, S, nh, hd)."""
    hd = q.shape[-1]
    c, s_ = cos[:, :, None, :], sin[:, :, None, :]
    qh = _bf16(rope(q, c, s_) * hd**-0.5).transpose(1, 2)  # (n, nh, S, hd)
    kh = _bf16(rope(k, c, s_)).transpose(1, 2)
    scores = qh @ kh.transpose(-1, -2) + key_bias[:, None, None, :]
    out, _ = tc_softmax_pv(scores, v.transpose(1, 2))
    return out.transpose(1, 2)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


FLASH_CASES = [
    # (B, Sq, Skv, H, Hkv, D, causal, q_offset, left pad keys per batch entry)
    (2, 128, 128, 4, 2, 64, True, 0, (0, 37)),
    (1, 256, 256, 4, 4, 64, True, 0, (32,)),  # G = 1
    (2, 128, 256, 4, 2, 64, True, 128, (130, 0)),  # a cached prefix: some rows see no key
    (1, 128, 128, 2, 1, 64, False, 0, (16,)),
    (1, 128, 256, 8, 2, 128, True, 128, (70,)),
    (1, 128, 256, 14, 2, 128, True, 128, (40,)),  # G = 7: the 7B's 28 q heads over 4 kv heads
]


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,q_offset,pads", FLASH_CASES)
def test_k1_tc_rounding_stays_within_the_kernels_tolerance(B, Sq, Skv, H, Hkv, D, causal, q_offset, pads):
    """(a): the emulated tensor-core K1 against JAX's kernel on the same
    bf16-valued inputs, out and lse on rows that see a real key."""
    rng = np.random.default_rng(7)
    q, k, v = (_bf16(torch.from_numpy(rng.normal(size=s).astype(np.float32))).numpy()
               for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    bias = np.where(np.arange(Skv)[None] < np.array(pads)[:, None], NEG_INF, 0.0).astype(np.float32)
    jq, jk, jv, jb = map(jnp.asarray, (q, k, v, bias))
    want = np.asarray(jax_flash_attention(jq, jk, jv, jb, causal, None, q_offset))
    bq, bk = _resolve_blocks(jq, jk, q_offset, 0, 0)
    _, want_lse = _flash_fwd(jq, jk, jv, jb, causal, D**-0.5, q_offset, bq, bk)

    out, lse = tc_flash_forward(*map(torch.from_numpy, (q, k, v, bias)), causal, q_offset)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()  # rows that see no key too
    last = q_offset + np.arange(Sq) if causal else np.full(Sq, Skv - 1)
    valid = last[None, :] >= np.array(pads)[:, None]  # (B, Sq)
    got_lse = lse.numpy().transpose(0, 2, 1)[valid]
    assert _rel(out.numpy()[valid], want[valid]) <= TC_TOL
    assert _rel(got_lse, np.asarray(want_lse).transpose(0, 2, 1)[valid]) <= TC_TOL
    assert np.abs(out.numpy()[valid] - want[valid]).max() > 0  # the rounding is there to see
    if not valid.all():  # a row that sees no real key: a uniform average, lse ~ NEG_INF
        assert (lse.numpy().transpose(0, 2, 1)[~valid] < -1e29).all()


@pytest.mark.parametrize("n_slices,S,nh,pads,seed", [
    (3, 100, 2, (0, 17, 100), 0),  # ragged S; the last slice has no live key
    (2, 192, 3, (5, 0), 1),
    (1, 64, 1, (0,), 2),
])
def test_k3_tc_rounding_stays_within_the_kernels_tolerance(n_slices, S, nh, pads, seed):
    """(b): the emulated tensor-core K3 (rope rounded to bf16 in the kernel)
    against JAX's kernel at head dim 80 with dead keys, on live rows."""
    hd = 80
    rng = np.random.default_rng(seed)
    q, k, v = (_bf16(torch.from_numpy(rng.normal(size=(n_slices, S, nh, hd)).astype(np.float32))).numpy()
               for _ in range(3))
    theta = rng.uniform(0, 20, size=(n_slices, S, hd)).astype(np.float32)
    cos, sin = np.cos(theta), np.sin(theta)
    dead = (np.arange(S)[None] >= S - np.array(pads)[:, None]) | (rng.uniform(size=(n_slices, S)) < 0.05)
    bias = np.where(dead, NEG_INF, 0.0).astype(np.float32)

    want = np.asarray(jax_full(*map(jnp.asarray, (q, k, v, cos, sin, bias)), interpret=True))
    got = tc_full_rope_forward(*map(torch.from_numpy, (q, k, v, cos, sin, bias))).numpy()
    assert np.isfinite(got).all()
    live = ~dead
    assert _rel(got[live], want[live]) <= TC_TOL
    assert np.abs(got[live] - want[live]).max() > 0


@pytest.mark.parametrize("hd", [64, 80, 128])
def test_chunk_pair_rope_map_is_rotate_half(hd):
    """(c): chunk c of a row (8 elements) and chunk (c + hd/16) % (hd/8):
    x_c·cos_c − x_partner·sin_c in the first half, x_c·cos_c + x_partner·sin_c
    in the second, equals rope() for every element."""
    rng = np.random.default_rng(hd)
    x = torch.from_numpy(rng.normal(size=(5, hd)).astype(np.float32))
    cos = torch.from_numpy(rng.normal(size=(5, hd)).astype(np.float32))
    sin = torch.from_numpy(rng.normal(size=(5, hd)).astype(np.float32))
    n_chunks, half = hd // 8, hd // 16
    out = torch.empty_like(x)
    for c in range(n_chunks):
        partner = (c + half) % n_chunks
        sign = -1.0 if c < half else 1.0
        cols, pcols = slice(8 * c, 8 * c + 8), slice(8 * partner, 8 * partner + 8)
        out[:, cols] = x[:, cols] * cos[:, cols] + sign * x[:, pcols] * sin[:, cols]
    torch.testing.assert_close(out, rope(x, cos, sin), rtol=0, atol=0)


def test_cpu_tensors_run_the_plain_versions_and_count_no_launch():
    """Given CPU tensors, K1 and K3 run their plain versions in either dtype
    and count no launch, tensor-core or FMA."""
    rng = np.random.default_rng(3)
    flash_attention_fwd.launches = flash_attention_fwd.tc_launches = 0
    full_attention_rope.launches = full_attention_rope.tc_launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.from_numpy(rng.normal(size=(1, 64, 4, 64)).astype(np.float32)).to(dtype)
        k = torch.from_numpy(rng.normal(size=(1, 64, 2, 64)).astype(np.float32)).to(dtype)
        out, lse = flash_attention_fwd(q, k, k, torch.zeros(1, 64))
        assert out.dtype == dtype and lse.dtype == torch.float32
        qv = torch.from_numpy(rng.normal(size=(2, 48, 2, 80)).astype(np.float32)).to(dtype)
        cs = torch.from_numpy(rng.normal(size=(2, 48, 80)).astype(np.float32))
        assert full_attention_rope(qv, qv, qv, cs, cs, torch.zeros(2, 48)).dtype == dtype
    assert flash_attention_fwd.launches == flash_attention_fwd.tc_launches == 0
    assert full_attention_rope.launches == full_attention_rope.tc_launches == 0
