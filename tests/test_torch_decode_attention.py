"""D1 and D2 of the port (`ops/decode_attention.py`) against the JAX
package's Pallas kernels in interpret mode, mirroring
tests/test_decode_attention.py, on CPU tensors (so the wrappers run their
plain versions and launch nothing):

- D1 `shared_prefix_decode_attention` (acc, m, l) and D2
  `shared_prefix_decode_full`, f32 and int8 caches, (P, R) in
  {(1, 8), (2, 4)}, with a fully masked first prefix block and own suffixes of
  length 0 and 17;
- no own suffix: D1 followed by `merge_shared_tail`; and the merge with a
  suffix, against JAX's merge;
- `decode_step_attention`, the decoder's glue around D2 (regrouped q, the
  token-major caches as head-major views), against `mha_shared_prefix`, also
  at a prefix length that fits no block;
- `shared_decode_forward` over int8 caches against JAX's.

Tolerance: 2e-5, the JAX tests' own (f32 sums in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_bridge import CFG, JCFG, jax_params, port_params
from time_r1_tpu.models.qwen25vl.language import shared_decode_forward as jax_shared_decode_forward
from time_r1_tpu.models.qwen25vl.language import suffix_cache_zeros as jax_suffix_cache_zeros
from time_r1_tpu.ops import decode_attention as jda
from time_r1_tpu.ops import quant as jq
from time_r1_tpu_torch.models.qwen25vl import KVCache, shared_decode_forward, suffix_cache_zeros
from time_r1_tpu_torch.models.qwen25vl.language import decode_step_attention
from time_r1_tpu_torch.ops import decode_attention as da
from time_r1_tpu_torch.ops import quant as tq
from time_r1_tpu_torch.ops.attention import mha_shared_prefix

torch.set_num_threads(2)

NEG_INF = -1e30
TOL = dict(atol=2e-5, rtol=2e-5)
H, Hkv, D = 16, 2, 128
G = H // Hkv


def _case(P, R, quant, Lp=384, Lo=128, pad=150, seed=0):
    """Token-major arrays as the port's caches hold them. Lp = 384 gives the
    JAX kernel three 128-key blocks, the first fully masked by the pad."""
    rng = np.random.default_rng(seed)
    B = P * R
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    c = dict(q=f(B, 1, H, D), kn=f(B, 1, Hkv, D), vn=f(B, 1, Hkv, D))
    for n, shape in (("kp", (P, Lp, Hkv, D)), ("vp", (P, Lp, Hkv, D)), ("ko", (B, Lo, Hkv, D)), ("vo", (B, Lo, Hkv, D))):
        x = f(*shape)
        if quant:
            q8, s = jq.quantize_kv(jnp.asarray(x))
            c[n], c[n + "_s"] = np.asarray(q8), np.asarray(s)
        else:
            c[n], c[n + "_s"] = x, None
    c["bias"] = np.broadcast_to(np.where(np.arange(Lp) < pad, NEG_INF, 0.0).astype(np.float32), (P, Lp)).copy()
    c["q_rows"] = c["q"].reshape(P, R, Hkv, G, D).transpose(0, 2, 1, 3, 4).reshape(P, Hkv, R * G, D).copy()
    return c


def _hm_jax(a):
    return None if a is None else jnp.asarray(np.swapaxes(a, 1, 2))


def _hm_torch(a):
    """The port's way in: a head-major view of a token-major array."""
    return None if a is None else torch.from_numpy(np.array(a)).transpose(1, 2)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("P,R", [(1, 8), (2, 4)])
def test_d1_matches_jax(quant, P, R):
    c = _case(P, R, quant)
    want = jda.shared_prefix_decode_attention(
        jnp.asarray(c["q_rows"]), _hm_jax(c["kp"]), _hm_jax(c["vp"]), _hm_jax(c["kp_s"]), _hm_jax(c["vp_s"]),
        jnp.asarray(c["bias"]), interpret=True)
    da.shared_prefix_decode_attention.launches = 0
    got = da.shared_prefix_decode_attention(_t(c["q_rows"]), _hm_torch(c["kp"]), _hm_torch(c["vp"]),
                                            _hm_torch(c["kp_s"]), _hm_torch(c["vp_s"]), _t(c["bias"]))
    assert da.shared_prefix_decode_attention.launches == 0  # CPU tensors never reach the kernel
    for name, a, b in zip(("acc", "m", "l"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("P,R", [(1, 8), (2, 4)])
@pytest.mark.parametrize("own_len", [0, 17])
def test_d2_matches_jax(quant, P, R, own_len):
    c = _case(P, R, quant)
    Lo = c["ko"].shape[1]
    bias_own = np.where(np.arange(Lo) < own_len, 0.0, NEG_INF).astype(np.float32)
    want = jda.shared_prefix_decode_full(
        jnp.asarray(c["q_rows"]), _hm_jax(c["kp"]), _hm_jax(c["vp"]), _hm_jax(c["kp_s"]), _hm_jax(c["vp_s"]),
        jnp.asarray(c["bias"]), _hm_jax(c["ko"]), _hm_jax(c["vo"]), _hm_jax(c["ko_s"]), _hm_jax(c["vo_s"]),
        jnp.asarray(bias_own), jnp.asarray(c["kn"][:, 0]), jnp.asarray(c["vn"][:, 0]), interpret=True)
    da.shared_prefix_decode_full.launches = 0
    got = da.shared_prefix_decode_full(
        _t(c["q_rows"]), _hm_torch(c["kp"]), _hm_torch(c["vp"]), _hm_torch(c["kp_s"]), _hm_torch(c["vp_s"]),
        _t(c["bias"]), _hm_torch(c["ko"]), _hm_torch(c["vo"]), _hm_torch(c["ko_s"]), _hm_torch(c["vo_s"]),
        own_len, _t(c["kn"][:, 0].copy()), _t(c["vn"][:, 0].copy()))
    assert da.shared_prefix_decode_full.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_d1_then_merge_matches_jax(quant):
    """D1's state merged with the per-row suffix (and with none: the first
    decode step's shape) by `merge_shared_tail`, against JAX's merge."""
    P, R = 2, 4
    c = _case(P, R, quant, seed=1)
    Lo = c["ko"].shape[1]
    bias_own = np.where(np.arange(Lo) < 17, 0.0, NEG_INF).astype(np.float32)[None, None, None]
    jstate = jda.shared_prefix_decode_attention(
        jnp.asarray(c["q_rows"]), _hm_jax(c["kp"]), _hm_jax(c["vp"]), _hm_jax(c["kp_s"]), _hm_jax(c["vp_s"]),
        jnp.asarray(c["bias"]), interpret=True)
    tstate = da.shared_prefix_decode_attention(_t(c["q_rows"]), _hm_torch(c["kp"]), _hm_torch(c["vp"]),
                                               _hm_torch(c["kp_s"]), _hm_torch(c["vp_s"]), _t(c["bias"]))
    J = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    for own in (True, False):
        suf = (c["ko"], c["vo"], c["ko_s"], c["vo_s"]) if own else (None,) * 4
        want = jda.merge_shared_tail(*jstate, jnp.asarray(c["q"]), *map(J, suf), jnp.asarray(c["kn"]),
                                     jnp.asarray(c["vn"]), J(bias_own) if own else None)
        got = da.merge_shared_tail(*tstate, _t(c["q"]), *map(_t, suf), _t(c["kn"]), _t(c["vn"]),
                                   _t(bias_own) if own else None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"suffix {own}", **TOL)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("own_len", [0, 17])
def test_decode_step_glue_matches_mha_shared_prefix(quant, own_len):
    """`decode_step_attention` (q regrouped into D2's rows, the caches passed
    as strided head-major views, the output regrouped back) equals the plain
    decode-step attention on the same token-major caches."""
    P, R = 2, 4
    c = _case(P, R, quant, seed=2)
    Lo = c["ko"].shape[1]
    got = decode_step_attention(_t(c["q"]), _t(c["kp"]), _t(c["vp"]), _t(c["kp_s"]), _t(c["vp_s"]),
                                _t(c["ko"]), _t(c["vo"]), _t(c["ko_s"]), _t(c["vo_s"]), own_len,
                                _t(c["kn"]), _t(c["vn"]), _t(c["bias"]))
    bias_own = torch.where(torch.arange(Lo) < own_len, 0.0, NEG_INF).float()[None, None, None]
    want = mha_shared_prefix(_t(c["q"]), _t(c["kp"]), _t(c["vp"]), _t(c["kp_s"]), _t(c["vp_s"]),
                             _t(c["ko"]), _t(c["vo"]), _t(c["ko_s"]), _t(c["vo_s"]), _t(c["kn"]), _t(c["vn"]),
                             _t(c["bias"])[:, None, None, :], bias_own, torch.zeros(1, 1, 1, 1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_shared_decode_forward_int8_matches_jax():
    """Two decode steps of the tiny model over an int8 prefix and an int8
    suffix (made empty by `suffix_cache_zeros(quant=True)`): hidden states,
    the suffix length and the quantized suffix written in place."""
    jp = jax_params()
    tp = port_params(jp)
    rng = np.random.default_rng(3)
    L, hkv, hd = CFG.text.num_hidden_layers, CFG.text.num_key_value_heads, CFG.text.head_dim
    P, R, Lp, max_new = 2, 3, 24, 8
    B = P * R
    pk = rng.normal(size=(L, P, Lp, hkv, hd)).astype(np.float32)
    pv = rng.normal(size=(L, P, Lp, hkv, hd)).astype(np.float32)
    from time_r1_tpu.models.qwen25vl import KVCache as JaxKVCache

    jpre = jq.quantize_kv_cache(JaxKVCache(jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(Lp, jnp.int32)))
    tpre = tq.quantize_kv_cache(KVCache(torch.from_numpy(pk), torch.from_numpy(pv), Lp))
    jsuf = jax_suffix_cache_zeros(JCFG.text, B, max_new, quant=True)
    tsuf = suffix_cache_zeros(CFG.text, B, max_new, device="cpu", quant=True)
    assert tsuf.k.dtype == torch.int8 and tsuf.k_scale.shape == (L, B, max_new, hkv)
    pb = np.where(np.arange(Lp)[None, :] >= np.array([[17], [0]]), 0.0, NEG_INF).astype(np.float32)
    for step in range(2):
        hidden = (rng.normal(size=(B, 1, CFG.text.hidden_size)) * 0.1).astype(np.float32)
        pos = np.full((3, B, 1), 40 + step, np.int64)
        want, jsuf = jax_shared_decode_forward(jp["text"], JCFG.text, jnp.asarray(hidden), jnp.asarray(pos),
                                               jpre, jsuf, jnp.asarray(pb))
        got, tsuf = shared_decode_forward(tp["text"], CFG.text, torch.from_numpy(hidden), torch.from_numpy(pos),
                                          tpre, tsuf, torch.from_numpy(pb))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"step {step}", **TOL)
        assert tsuf.length == int(jsuf.length) == step + 1
        np.testing.assert_allclose(tsuf.k_scale.numpy(), np.asarray(jsuf.k_scale), rtol=1e-5)
        assert np.abs(tsuf.k.numpy().astype(int) - np.asarray(jsuf.k).astype(int)).max() <= 1


@pytest.mark.parametrize("quant", [False, True])
def test_decode_step_glue_at_a_ragged_prefix(quant):
    """A prefix of 200 keys, not a multiple of the JAX kernels' 128-key blocks
    nor of D2's 64-key chunks, with its first chunk fully masked. The port's
    decode step takes D2 on the card at any prefix length; here D2's plain
    version, through the decoder's glue, equals `mha_shared_prefix`."""
    P, R, Lp, own_len = 2, 4, 200, 9
    c = _case(P, R, quant, Lp=Lp, Lo=32, pad=70, seed=4)
    got = decode_step_attention(_t(c["q"]), _t(c["kp"]), _t(c["vp"]), _t(c["kp_s"]), _t(c["vp_s"]),
                                _t(c["ko"]), _t(c["vo"]), _t(c["ko_s"]), _t(c["vo_s"]), own_len,
                                _t(c["kn"]), _t(c["vn"]), _t(c["bias"]))
    bias_own = torch.where(torch.arange(32) < own_len, 0.0, NEG_INF).float()[None, None, None]
    want = mha_shared_prefix(_t(c["q"]), _t(c["kp"]), _t(c["vp"]), _t(c["kp_s"]), _t(c["vp_s"]),
                             _t(c["ko"]), _t(c["vo"]), _t(c["ko_s"]), _t(c["vo_s"]), _t(c["kn"]), _t(c["vn"]),
                             _t(c["bias"])[:, None, None, :], bias_own, torch.zeros(1, 1, 1, 1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
