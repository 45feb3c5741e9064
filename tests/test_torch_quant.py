"""The port's weight-only and KV-cache quantization (`ops/quant.py`) and its
int8 attention (`ops/attention.py`) against the JAX package, on the CPU:

- int8 and int4 `quantize_weight`, `quantize_embedding` and `quantize_kv`:
  values and scales bit-equal to JAX's after the (in, out) → (out, in)
  transpose; the int4 packing round-trips exactly;
- `quantize_text_params` (fused and unfused) equal to JAX's through
  `params_to_jax`, and the fused qkv/gu bit-identical to the unfused
  projections (the pin of tests/test_quant.py);
- `qmatmul`, `embed_lookup`, the quantized tied and untied heads,
  `mha_cached_q8` and `mha_shared_prefix` with int8 scales against JAX;
- `params_from_jax` / `params_to_jax` round trips of quantized trees;
- the cached decoder over an int8 KV cache against JAX's.

Tolerances: quantized values are compared for equality; f32 forwards to 2e-5
(sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_bridge import CFG, JCFG, jax_params, numpy_tree, port_params
from time_r1_tpu.models.qwen25vl import KVCache as JaxKVCache
from time_r1_tpu.models.qwen25vl.language import decoder_forward as jax_decoder_forward
from time_r1_tpu.models.qwen25vl.language import lm_logits as jax_lm_logits
from time_r1_tpu.ops import attention as jattn
from time_r1_tpu.ops import quant as jq
from time_r1_tpu_torch.models.qwen25vl import KVCache, decoder_forward, lm_logits, params_from_jax, params_to_jax
from time_r1_tpu_torch.ops import attention as tattn
from time_r1_tpu_torch.ops import quant as tq

torch.set_num_threads(2)

NEG_INF = -1e30
FWD = dict(atol=2e-5, rtol=2e-5)


def _t(a) -> torch.Tensor:
    """A JAX (.., K, N) weight or (.., 1, N) scale in the port's (.., N, K) / (.., N, 1) layout."""
    return torch.from_numpy(np.array(np.swapaxes(np.asarray(a), -1, -2)))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_weight_bit_equal_to_jax(bits, dtype):
    w = np.random.default_rng(0).normal(size=(96, 40)).astype(np.float32)
    jw = jnp.asarray(w, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = jq.quantize_weight(jw, bits=bits)
    tw = torch.from_numpy(w.T.copy())
    got = tq.quantize_weight(tw.bfloat16() if dtype == "bfloat16" else tw, bits=bits)
    key = "q8" if bits == 8 else "q4"
    assert set(got) == set(want) == {key, "s"}
    assert got[key].dtype == (torch.int8 if bits == 8 else torch.uint8) and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got[key].numpy(), _t(want[key]).numpy())
    np.testing.assert_array_equal(got["s"].numpy(), _t(want["s"]).numpy())
    np.testing.assert_array_equal(tq.dequantize_weight(got, torch.float32).numpy(),
                                  _t(jq.dequantize_weight(want, jnp.float32)).numpy())


def test_int4_pack_round_trip_exact():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(size=(24, 64)).astype(np.float32))
    q4 = tq.quantize_weight(w, bits=4)
    values = torch.clamp(torch.round(w / q4["s"]), -7, 7).to(torch.int8)
    np.testing.assert_array_equal(tq.unpack_q4(q4["q4"]).numpy(), values.numpy())
    np.testing.assert_array_equal(tq.unpack_q4(q4["q4"]).numpy(), _t(jq._unpack_q4(jnp.asarray(_t(q4["q4"]).numpy()))))
    every = torch.arange(-7, 8, dtype=torch.int8).repeat(2)  # every value, packed in both nibbles
    packed = ((every[0::2] + 8).to(torch.uint8) | ((every[1::2] + 8).to(torch.uint8) << 4))
    np.testing.assert_array_equal(tq.unpack_q4(packed).numpy(), every.numpy())


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_embedding_bit_equal_to_jax(bits):
    emb = np.random.default_rng(2).normal(size=(50, 32)).astype(np.float32)
    want = jq.quantize_embedding(jnp.asarray(emb), bits=bits)
    got = tq.quantize_embedding(torch.from_numpy(emb), bits=bits)
    key = "q8" if bits == 8 else "q4"
    np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))  # (V, H) in both packages
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    ids = np.array([[3, 49, 0], [7, 7, 21]])
    np.testing.assert_array_equal(tq.embed_lookup(got, torch.from_numpy(ids), torch.float32).numpy(),
                                  np.asarray(jq.embed_lookup(want, jnp.asarray(ids), jnp.float32)))


def test_quantize_kv_bit_equal_to_jax():
    x = np.random.default_rng(3).normal(size=(2, 3, 7, 2, 16)).astype(np.float32) * 3
    x[0, 0, 0, 0] = 0.0  # an all-zero vector: the 1e-8 floor
    jq8, js = jq.quantize_kv(jnp.asarray(x))
    q8, s = tq.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    cache = tq.quantize_kv_cache(KVCache(torch.from_numpy(x), torch.from_numpy(-x), 5))
    assert cache.length == 5 and cache.k.dtype == torch.int8 and cache.k_scale.shape == x.shape[:-1]
    np.testing.assert_array_equal(cache.v.numpy(), -q8.numpy())


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_text_params_match_jax(bits):
    jp = jax_params()
    tp = port_params(jp)
    want = numpy_tree(jq.quantize_params(jp, bits=bits, fuse=True))
    got = params_to_jax(tq.quantize_params(tp, bits=bits, fuse=True), CFG)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                 jax.tree_util.tree_flatten_with_path(want)[0]):
        assert a.dtype == b.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("bits", [8, 4])
def test_fused_quantization_equals_unfused(bits):
    """Per-row scales make the fused qkv/gu rows exactly the unfused
    projections' rows (tests/test_quant.py's pin, in the port's layout)."""
    tp = port_params(jax_params())
    fused = tq.quantize_text_params(tp["text"], bits=bits, fuse=True)["layers"]
    unfused = tq.quantize_text_params(tp["text"], bits=bits, fuse=False)["layers"]
    key = "q8" if bits == 8 else "q4"
    for f, u in zip(fused, unfused):
        for fk, parts in (("qkv", ("q_w", "k_w", "v_w")), ("gu", ("gate_w", "up_w"))):
            for leaf in (key, "s"):
                assert torch.equal(f[fk][leaf], torch.cat([u[p][leaf] for p in parts]))
        assert torch.equal(f["down_w"][key], u["down_w"][key]) and torch.equal(f["o_w"]["s"], u["o_w"]["s"])
    again = tq.quantize_text_params({**tp["text"], "layers": fused}, bits=bits)  # idempotent
    assert all(a["qkv"] is b["qkv"] for a, b in zip(again["layers"], fused))


@pytest.mark.parametrize("fmt", ["plain", "int8", "int4"])
def test_qmatmul_matches_jax(fmt):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 48)) * 0.1).astype(np.float32)
    jw = jnp.asarray(w) if fmt == "plain" else jq.quantize_weight(jnp.asarray(w), bits=8 if fmt == "int8" else 4)
    tw = _t(w) if fmt == "plain" else {k: _t(v) for k, v in jw.items()}
    want = np.asarray(jq.qmatmul(jnp.asarray(x), jw))
    np.testing.assert_allclose(tq.qmatmul(torch.from_numpy(x), tw).numpy(), want, **FWD)


@pytest.mark.parametrize("tied", [True, False])
def test_quantized_heads_match_jax(tied):
    rng = np.random.default_rng(5)
    hidden = rng.normal(size=(2, 3, 32)).astype(np.float32)
    if tied:
        emb = rng.normal(size=(50, 32)).astype(np.float32)
        want = jq.tied_head_logits(jnp.asarray(hidden), jq.quantize_embedding(jnp.asarray(emb)))
        got = tq.tied_head_logits(torch.from_numpy(hidden), tq.quantize_embedding(torch.from_numpy(emb)))
    else:
        jp = jax_params()
        jtext = jq.quantize_text_params(jp["text"])
        assert "lm_head" in jtext and jq.is_quantized(jtext["lm_head"]["kernel"])
        hidden = rng.normal(size=(2, 3, CFG.text.hidden_size)).astype(np.float32)
        want = jax_lm_logits(jtext, JCFG.text, jnp.asarray(hidden))
        ttext = tq.quantize_text_params(port_params(jp)["text"])
        got = lm_logits(ttext, CFG.text, torch.from_numpy(hidden))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def _q8(x):
    q, s = jq.quantize_kv(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def test_mha_cached_q8_matches_jax():
    rng = np.random.default_rng(6)
    B, S, H, Hkv, D, L = 2, 3, 4, 2, 16, 12
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q, kn, vn = f(B, S, H, D), f(B, S, Hkv, D), f(B, S, Hkv, D)
    (k8, ks), (v8, vs) = _q8(f(B, L, Hkv, D)), _q8(f(B, L, Hkv, D))
    bias_old = np.where(np.arange(L) < 7, 0.0, NEG_INF).astype(np.float32)[None, None, None]
    bias_old = bias_old + np.where(np.arange(L)[None] >= np.array([[2], [0]]), 0.0, NEG_INF)[:, None, None]
    i = np.arange(S)
    bias_new = np.where(i[None, :] <= i[:, None], 0.0, NEG_INF).astype(np.float32)[None, None]
    arrays = (q, k8, v8, ks, vs, kn, vn, bias_old.astype(np.float32), bias_new)
    want = jattn.mha_cached_q8(*map(jnp.asarray, arrays))
    got = tattn.mha_cached_q8(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("with_suffix,S", [(True, 1), (False, 5)])
def test_mha_shared_prefix_int8_matches_jax(with_suffix, S):
    rng = np.random.default_rng(7)
    P, R, H, Hkv, D, Lp, Lo = 2, 3, 4, 2, 16, 24, 8
    B = P * R
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    (kp, kps), (vp, vps) = _q8(f(P, Lp, Hkv, D)), _q8(f(P, Lp, Hkv, D))
    own = (*_q8(f(B, Lo, Hkv, D)), *_q8(f(B, Lo, Hkv, D))) if with_suffix else (None,) * 4
    ko, kos, vo, vos = own
    bias_pref = np.where(np.arange(Lp)[None, :] >= np.array([[3], [0]]), 0.0, NEG_INF).astype(np.float32)
    bias_own = np.where(np.arange(Lo) < 5, 0.0, NEG_INF).astype(np.float32)[None, None, None] if with_suffix else None
    i = np.arange(S)
    bias_new = np.where(i[None, :] <= i[:, None], 0.0, NEG_INF).astype(np.float32)[None, None]
    arrays = (f(B, S, H, D), kp, vp, kps, vps, ko, vo, kos, vos, f(B, S, Hkv, D), f(B, S, Hkv, D),
              bias_pref[:, None, None, :], bias_own, bias_new)
    want = jattn.mha_shared_prefix(*(None if a is None else jnp.asarray(a) for a in arrays))
    got = tattn.mha_shared_prefix(*(None if a is None else torch.from_numpy(a) for a in arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("bits,fuse", [(8, True), (4, True), (8, False)])
def test_quantized_params_round_trip_bit_exact(bits, fuse):
    tree = numpy_tree(jq.quantize_params(jax_params(), bits=bits, fuse=fuse))
    if bits == 4:  # also an int4 row-packed embedding, which carries JAX's `_row4` marker
        tree["text"]["embed_tokens"]["embedding"] = numpy_tree(
            jq.quantize_embedding(jnp.asarray(jax_params()["text"]["embed_tokens"]["embedding"]), bits=4))
    port = params_from_jax(tree, CFG, device="cpu", dtype=torch.float32)
    lp = port["text"]["layers"][0]
    assert set(lp) >= ({"qkv", "qkv_b", "gu"} if fuse else {"q_w", "gate_w"})
    key = "q8" if bits == 8 else "q4"
    assert lp["o_w"][key].shape[0] == CFG.text.hidden_size and lp["o_w"]["s"].shape == (CFG.text.hidden_size, 1)
    back = params_to_jax(port, CFG)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_decoder_over_an_int8_cache_matches_jax():
    """Two cached chunks (S = 2, then S = 1) over an int8 cache: hidden states
    and the quantized chunk written in place, against JAX's scan."""
    jp = jax_params()
    tp = port_params(jp)
    rng = np.random.default_rng(8)
    L, Hkv, hd = CFG.text.num_hidden_layers, CFG.text.num_key_value_heads, CFG.text.head_dim
    B, max_len, L0 = 2, 16, 6
    k = rng.normal(size=(L, B, max_len, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(L, B, max_len, Hkv, hd)).astype(np.float32)
    k[:, :, L0:] = v[:, :, L0:] = 0.0
    jcache = jq.quantize_kv_cache(JaxKVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(L0, jnp.int32)))
    tcache = tq.quantize_kv_cache(KVCache(torch.from_numpy(k), torch.from_numpy(v), L0))
    mask = np.ones((B, max_len), np.int64)
    mask[1, :2] = 0  # a left-padded row
    for S in (2, 1):
        hidden = (rng.normal(size=(B, S, CFG.text.hidden_size)) * 0.1).astype(np.float32)
        pos = np.broadcast_to((tcache.length + np.arange(S))[None, None], (3, B, S)).astype(np.int64)
        want, jcache = jax_decoder_forward(jp["text"], JCFG.text, jnp.asarray(hidden), jnp.asarray(pos),
                                           attention_mask=jnp.asarray(mask), cache=jcache)
        got, tcache = decoder_forward(tp["text"], CFG.text, torch.from_numpy(hidden), torch.from_numpy(pos),
                                      attention_mask=torch.from_numpy(mask), cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
        assert tcache.length == int(jcache.length)
        np.testing.assert_allclose(tcache.k_scale.numpy(), np.asarray(jcache.k_scale), rtol=1e-5)
        # int8 values of the written chunk agree, or sit one apart at a rounding boundary
        assert np.abs(tcache.v.numpy().astype(int) - np.asarray(jcache.v).astype(int)).max() <= 1
