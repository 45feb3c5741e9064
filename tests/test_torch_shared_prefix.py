"""Shared-prefix attention of the port against the JAX package, on CPU
tensors (so the S1/S2 wrappers run their plain versions):

- S1 `flash_attention_shared_prefix`, forward and gradients, against the JAX
  Pallas kernel in interpret mode for R ∈ {1, 2, 4} rows per prompt, with a
  left-padded prompt; the ValueError of JAX's `_sp_blocks`;
- `mha_shared_prefix` (the G-way decode step's attention) with and without a
  suffix (its int8 scales are in tests/test_torch_quant.py);
- `shared_decode_forward`: the decode step (with a suffix) and the loss chunk
  (without), through S1's plain version and through `mha_shared_prefix`,
  with parameter gradients;
- `Engine.generate` at G > 1: greedy tokens equal to the JAX Engine's and to
  the G = 1 tokens of each prompt, also with int8/int4 weights and the int8
  KV cache.

Tolerances: f32 forwards 2e-5 (sums in another order); gradients 5e-4, the
JAX package's own for its kernels' gradients."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_bridge import CFG, JCFG, jax_params, port_params
from test_torch_engine import engines  # noqa: F401  (fixture)
from time_r1_tpu.models.qwen25vl import KVCache as JaxKVCache
from time_r1_tpu.models.qwen25vl.language import shared_decode_forward as jax_shared_decode_forward
from time_r1_tpu.ops.attention import mha_shared_prefix as jax_mha_shared_prefix
from time_r1_tpu.ops.flash_attention import flash_attention_shared_prefix as jax_sp
from time_r1_tpu.sampler import Request as JaxRequest
from time_r1_tpu.sampler import SamplingParams as JaxSamplingParams
from time_r1_tpu_torch.models.qwen25vl import KVCache, shared_decode_forward
from time_r1_tpu_torch.models.qwen25vl.config import TextConfig
from time_r1_tpu_torch.ops.attention import NEG_INF, mha_shared_prefix
from time_r1_tpu_torch.ops.flash_attention import (
    flash_attention_shared_prefix,
    shared_prefix_bwd_dkv,
    shared_prefix_bwd_dq,
    shared_prefix_fwd,
)
from time_r1_tpu_torch.sampler import Request, SamplingParams

torch.set_num_threads(2)

GRAD_TOL = dict(atol=5e-4, rtol=5e-4)


def _sp_inputs(P=2, R=3, Lp=256, Sc=128, H=4, Hkv=2, D=64, n_pad=32, seed=2):
    """tests/test_flash_attention.py::_sp_inputs, as numpy."""
    rng = np.random.default_rng(seed)
    B = P * R
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    prefix_bias = np.zeros((P, Lp), np.float32)
    prefix_bias[0, :n_pad] = NEG_INF  # a left-padded prompt
    return f(B, Sc, H, D), f(P, Lp, Hkv, D), f(P, Lp, Hkv, D), f(B, Sc, Hkv, D), f(B, Sc, Hkv, D), prefix_bias


@pytest.mark.parametrize("R", [1, 2, 4])
def test_sp_forward_and_grads_match_jax(R):
    arrays = _sp_inputs(R=R)
    q, kp, vp, ko, vo, pb = arrays
    g = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)

    def f(q, kp, vp, ko, vo):
        return jnp.sum(jax_sp(q, kp, vp, ko, vo, jnp.asarray(pb)) * g)

    want_out = np.asarray(jax_sp(*map(jnp.asarray, arrays)))
    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays[:5]))

    launches = (shared_prefix_fwd, shared_prefix_bwd_dq, shared_prefix_bwd_dkv)
    for fn in launches:
        fn.launches = 0
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays[:5]]
    out = flash_attention_shared_prefix(*ts, torch.from_numpy(pb))
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ts)
    assert all(fn.launches == 0 for fn in launches)  # CPU tensors never reach a kernel
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=2e-5, rtol=2e-5)
    for name, a, b in zip(("q", "kp", "vp", "ko", "vo"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("Lp,Sc", [(320, 128), (256, 192)])
def test_sp_rejects_what_jax_rejects(Lp, Sc):
    arrays = _sp_inputs(Lp=Lp, Sc=Sc, R=1)
    with pytest.raises(ValueError):
        jax_sp(*map(jnp.asarray, arrays))
    with pytest.raises(ValueError):
        flash_attention_shared_prefix(*map(torch.from_numpy, arrays))


def _decode_attention_inputs(with_suffix: bool, S: int):
    rng = np.random.default_rng(0)
    P, R, H, Hkv, D, Lp, Lo = 2, 3, 4, 2, 16, 24, 8
    B = P * R
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    bias_pref = np.where(np.arange(Lp)[None, :] >= np.array([[3], [0]]), 0.0, NEG_INF).astype(np.float32)
    bias_pref = bias_pref[:, None, None, :]
    bias_own = np.where(np.arange(Lo) < 5, 0.0, NEG_INF).astype(np.float32)[None, None, None, :]
    i = np.arange(S)
    bias_new = np.where(i[None, :] <= i[:, None], 0.0, NEG_INF).astype(np.float32)[None, None]
    own = (f(B, Lo, Hkv, D), f(B, Lo, Hkv, D)) if with_suffix else (None, None)
    return (f(B, S, H, D), f(P, Lp, Hkv, D), f(P, Lp, Hkv, D), *own, f(B, S, Hkv, D), f(B, S, Hkv, D),
            bias_pref, bias_own if with_suffix else None, bias_new)


@pytest.mark.parametrize("with_suffix,S", [(True, 1), (False, 5)])
def test_mha_shared_prefix_matches_jax(with_suffix, S):
    q, kp, vp, ko, vo, kn, vn, bp, bo, bn = _decode_attention_inputs(with_suffix, S)

    def conv(fn, a):
        return None if a is None else fn(a)

    want = jax_mha_shared_prefix(
        *(conv(jnp.asarray, a) for a in (q, kp, vp)), None, None, conv(jnp.asarray, ko), conv(jnp.asarray, vo),
        None, None, *(conv(jnp.asarray, a) for a in (kn, vn, bp, bo, bn)),
    )
    got = mha_shared_prefix(
        *(conv(torch.from_numpy, a) for a in (q, kp, vp)), None, None,
        conv(torch.from_numpy, ko), conv(torch.from_numpy, vo), None, None,
        *(conv(torch.from_numpy, a) for a in (kn, vn, bp, bo, bn)),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def _shared_decode_case(cfg, P, R, Lp, S, with_suffix, seed=3):
    """Random prefix/suffix caches (prompt 0 left-padded by 17) and chunk input."""
    rng = np.random.default_rng(seed)
    L, Hkv, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    B = P * R
    pk = rng.normal(size=(L, P, Lp, Hkv, hd)).astype(np.float32)
    pv = rng.normal(size=(L, P, Lp, Hkv, hd)).astype(np.float32)
    pb = np.where(np.arange(Lp)[None, :] >= np.array([[17], [0]])[:P], 0.0, NEG_INF).astype(np.float32)
    hidden = (rng.normal(size=(B, S, cfg.hidden_size)) * 0.1).astype(np.float32)
    suffix = None
    if with_suffix:
        sk = rng.normal(size=(L, B, 8, Hkv, hd)).astype(np.float32)
        sv = rng.normal(size=(L, B, 8, Hkv, hd)).astype(np.float32)
        suffix = (sk, sv, 3)
    start = 40 if with_suffix else Lp
    pos = np.broadcast_to(start + np.arange(S)[None, None, :], (3, B, S)).astype(np.int64)
    return pk, pv, pb, hidden, pos, suffix


@pytest.mark.parametrize("with_suffix", [True, False])
def test_shared_decode_forward_matches_jax(with_suffix):
    jp = jax_params()
    tp = port_params(jp)
    S = 1 if with_suffix else 6
    pk, pv, pb, hidden, pos, suffix = _shared_decode_case(CFG.text, 2, 2, 24, S, with_suffix)
    jpre = JaxKVCache(jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(24, jnp.int32))
    jsuf = None if suffix is None else JaxKVCache(jnp.asarray(suffix[0]), jnp.asarray(suffix[1]),
                                                  jnp.asarray(suffix[2], jnp.int32))
    want, want_suf = jax_shared_decode_forward(jp["text"], JCFG.text, jnp.asarray(hidden), jnp.asarray(pos),
                                               jpre, jsuf, jnp.asarray(pb))
    tsuf = None if suffix is None else KVCache(torch.from_numpy(suffix[0].copy()),
                                               torch.from_numpy(suffix[1].copy()), suffix[2])
    got, got_suf = shared_decode_forward(tp["text"], CFG.text, torch.from_numpy(hidden), torch.from_numpy(pos),
                                         KVCache(torch.from_numpy(pk), torch.from_numpy(pv), 24), tsuf,
                                         torch.from_numpy(pb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    if with_suffix:
        assert got_suf.length == int(want_suf.length) == 4
        np.testing.assert_allclose(got_suf.k.numpy(), np.asarray(want_suf.k), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got_suf.v.numpy(), np.asarray(want_suf.v), atol=2e-5, rtol=2e-5)
        with pytest.raises(ValueError, match="suffix"):  # S1 is the loss chunk: no suffix cache
            shared_decode_forward(tp["text"], CFG.text, torch.from_numpy(hidden), torch.from_numpy(pos),
                                  KVCache(torch.from_numpy(pk), torch.from_numpy(pv), 24), tsuf,
                                  torch.from_numpy(pb), use_flash=True)
    else:
        assert got_suf is None and want_suf is None


def test_loss_chunk_s1_matches_einsum_path_with_grads():
    """The loss chunk through S1's plain version (use_flash=True) equals the
    `mha_shared_prefix` path, in outputs and in the gradients of the layer
    weights, the input and the prefix K/V (the prefix gradient sums over each
    prompt's R rows), at a head dim of 64 (as in tests/test_shared_prefix.py)."""
    cfg = TextConfig(vocab_size=256, hidden_size=128, intermediate_size=64, num_hidden_layers=2,
                     num_attention_heads=2, num_key_value_heads=1, mrope_section=(8, 12, 12))
    gen = torch.Generator().manual_seed(0)
    H, nq, nkv, inter = 128, 128, 64, 64
    layers = [{
        "input_layernorm": torch.ones(H), "post_attention_layernorm": torch.ones(H),
        "q_w": torch.randn(nq, H, generator=gen) * 0.05, "q_b": torch.zeros(nq),
        "k_w": torch.randn(nkv, H, generator=gen) * 0.05, "k_b": torch.zeros(nkv),
        "v_w": torch.randn(nkv, H, generator=gen) * 0.05, "v_b": torch.zeros(nkv),
        "o_w": torch.randn(H, nq, generator=gen) * 0.05,
        "gate_w": torch.randn(inter, H, generator=gen) * 0.05, "up_w": torch.randn(inter, H, generator=gen) * 0.05,
        "down_w": torch.randn(H, inter, generator=gen) * 0.05,
    } for _ in range(2)]
    pk, pv, pb, hidden, pos, _ = _shared_decode_case(cfg, 2, 2, 128, 128, False)
    results = []
    for use_flash in (False, True):
        leaves = [t.clone().requires_grad_() for lp in layers for t in lp.values()]
        it = iter(leaves)
        p = {"layers": [{k: next(it) for k in lp} for lp in layers], "norm": torch.ones(H)}
        h = torch.from_numpy(hidden).requires_grad_()
        kp, vp = torch.from_numpy(pk).requires_grad_(), torch.from_numpy(pv).requires_grad_()
        out, _ = shared_decode_forward(p, cfg, h, torch.from_numpy(pos), KVCache(kp, vp, 128), None,
                                       torch.from_numpy(pb), use_flash=use_flash)
        loss = (out * out).sum()
        results.append((out.detach(), torch.autograd.grad(loss, [h, kp, vp, *leaves])))
    (o_e, g_e), (o_f, g_f) = results
    np.testing.assert_allclose(o_f.numpy(), o_e.numpy(), atol=3e-5, rtol=3e-5)
    for a, b in zip(g_f, g_e):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def _prompts():
    rng = np.random.default_rng(9)
    return [list(rng.integers(2, 200, n)) for n in (11, 7)]


def test_group_generate_matches_jax_and_single(engines):  # noqa: F811
    jeng, teng, _ = engines
    prompts = _prompts()
    sp = dict(temperature=0.0, max_new_tokens=8, stop_token_ids=CFG.stop_token_ids)
    want = jeng.generate([JaxRequest(input_ids=p) for p in prompts],
                         JaxSamplingParams(num_return_sequences=3, **sp))
    got = teng.generate([Request(input_ids=p) for p in prompts], SamplingParams(num_return_sequences=3, **sp))
    assert got == want
    for i, p in enumerate(prompts):
        single = teng.generate([Request(input_ids=p)], SamplingParams(**sp))[0]
        assert got[3 * i: 3 * i + 3] == [single] * 3


def test_group_generate_with_video_matches_jax(engines):  # noqa: F811
    from test_torch_engine import _video_requests

    jeng, teng, _ = engines
    reqs = _video_requests(two_videos=True)
    sp = dict(temperature=0.0, max_new_tokens=6, stop_token_ids=CFG.stop_token_ids, num_return_sequences=2)
    jreqs = [JaxRequest(input_ids=r.input_ids, patches=r.patches, grid_thw=r.grid_thw,
                        second_per_grid_t=r.second_per_grid_t) for r in reqs]
    assert teng.generate(reqs, SamplingParams(**sp)) == jeng.generate(jreqs, JaxSamplingParams(**sp))


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_group_generate_matches_jax(quant):
    """G = 3 rollouts over int8 or int4 weights and int8 prefix and suffix
    caches: greedy tokens equal to the JAX Engine's."""
    from time_r1_tpu.sampler import Engine as JaxEngine
    from time_r1_tpu_torch.sampler import Engine

    jp = jax_params()
    jeng = JaxEngine(jp, JCFG, dtype=jnp.float32, quantization=quant, kv_cache_quant=True)
    teng = Engine(port_params(jp), CFG, dtype=torch.float32, device="cpu", quantization=quant, kv_cache_quant=True)
    prompts = _prompts()
    sp = dict(temperature=0.0, max_new_tokens=8, stop_token_ids=CFG.stop_token_ids, num_return_sequences=3)
    want = jeng.generate([JaxRequest(input_ids=p) for p in prompts], JaxSamplingParams(**sp))
    assert teng.generate([Request(input_ids=p) for p in prompts], SamplingParams(**sp)) == want
