"""Side-path LoRA (`ops/quant.py::lora_delta`): adapters added as unmerged
scaling·(h @ A.T) @ B.T products at each projection, so that a rollout
samples LoRA-adapted over the trainer's own (int8) tree, against the merged
math and against the JAX package (f32, CPU, tiny config), after
tests/test_lora_side.py and tests/test_paged.py:

- `forward(..., lora_side=)` against `forward` of the merged tree (rtol
  2e-5: the same products associated otherwise) and against JAX's side-path
  forward (the same tolerance), the adapters changing the function;
- `Engine.generate` with side adapters: G-way greedy tokens equal to JAX's
  side-path engine and to an engine over the merged tree, the single-row
  (G = 1) path, clearing the adapters, two adapter sets installed in turn
  (copied into the engine's own tensors in place) each giving its own
  tokens;
- over int8 bases, fused and unfused, with int8 KV: greedy tokens equal to
  JAX's side-path engine over the same int8 tree;
- the grouped layout (`group_side_adapters`, TIMER1_GROUP_SIDE_LORA=1)
  against the per-projection one (rtol 2e-5), and the engine taking it;
- `PagedEngine.set_lora_side`: greedy tokens over bf16 and int8 pages equal
  to the engine over the merged tree and to JAX's paged engine, and clearing.

Every adapter set is perturbed away from B = 0 (+0.03, as the JAX tests do)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_bridge import CFG, JCFG, jax_params, numpy_tree, port_params
from time_r1_tpu.models.qwen25vl import forward as jax_forward
from time_r1_tpu.ops.quant import quantize_params as jax_quantize_params
from time_r1_tpu.rl.lora import LoRAConfig as JaxLoRAConfig
from time_r1_tpu.rl.lora import fused_splits_for as jax_fused_splits_for
from time_r1_tpu.rl.lora import init_lora as jax_init_lora
from time_r1_tpu.rl.lora import lora_layers_tree as jax_lora_layers_tree
from time_r1_tpu.sampler import Engine as JaxEngine
from time_r1_tpu.sampler import Request as JaxRequest
from time_r1_tpu.sampler import SamplingParams as JaxSamplingParams
from time_r1_tpu.sampler.paged import PagedEngine as JaxPagedEngine
from time_r1_tpu_torch.models.qwen25vl import forward, get_rope_index, params_from_jax
from time_r1_tpu_torch.models.qwen25vl.convert import lora_from_jax
from time_r1_tpu_torch.ops.quant import group_side_adapters
from time_r1_tpu_torch.rl.lora import LoRAConfig, lora_layers_tree, merge_lora
from time_r1_tpu_torch.sampler import Engine, PagedEngine, Request, SamplingParams

torch.set_num_threads(2)
LCFG = LoRAConfig(rank=4, alpha=8.0)
JLCFG = JaxLoRAConfig(rank=4, alpha=8.0)


def _lora(jp, seed=7, fused=False):
    """(JAX adapters, the port's) over the decoder, B perturbed by +0.03."""
    jl = jax_init_lora(jp, JLCFG, jax.random.PRNGKey(seed), dtype=jnp.float32,
                       fused_splits=jax_fused_splits_for(JCFG.text) if fused else None)
    jl = jax.tree.map(lambda a: a + 0.03, {k: v for k, v in jl.items() if not k.startswith("visual")})
    return jl, lora_from_jax(numpy_tree(jl), CFG, device="cpu")


@pytest.fixture(scope="module")
def base():
    jp = jax_params()
    jl, tl = _lora(jp)
    return jp, port_params(jp), jl, tl


def _ids_pos():
    rng = np.random.default_rng(3)
    ids = rng.integers(2, 200, (2, 7))
    pos, _ = get_rope_index(CFG, ids, attention_mask=np.ones_like(ids))
    return ids, pos


def _logits(tp, lora_side=None):
    ids, pos = _ids_pos()
    logits, _ = forward(tp, CFG, torch.from_numpy(ids), torch.from_numpy(pos), lora_side=lora_side)
    return logits.numpy()


def _side(tl):
    layers, rest = lora_layers_tree(tl)
    assert not rest
    return layers, LCFG.scaling


def test_side_path_matches_merged_forward_and_jax(base):
    jp, tp, jl, tl = base
    got = _logits(tp, lora_side=_side(tl))
    want = _logits(merge_lora(tp, tl, LCFG))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert np.abs(want - _logits(tp)).max() > 1e-3  # the adapters change the function
    ids, pos = _ids_pos()
    jlogits, _ = jax_forward(jp, JCFG, jnp.asarray(ids), jnp.asarray(pos),
                             lora_side=(jax_lora_layers_tree(jl)[0], JLCFG.scaling))
    np.testing.assert_allclose(got, np.asarray(jlogits), rtol=2e-5, atol=2e-5)


def test_side_and_merge_are_refused_together(base):
    _, tp, _, tl = base
    from time_r1_tpu_torch.models.qwen25vl import decoder_forward

    ids, pos = _ids_pos()
    x = torch.zeros((2, 7, CFG.text.hidden_size))
    with pytest.raises(ValueError, match="not both"):
        decoder_forward(tp["text"], CFG.text, x, torch.from_numpy(pos), lora=_side(tl), lora_side=_side(tl))


def _request(seed, n):
    return Request(input_ids=np.random.default_rng(seed).integers(2, 200, n).tolist())


def _jax_generate(params, jl, req, sp, **kw):
    eng = JaxEngine(params, JCFG, dtype=jnp.float32, **kw)
    eng.set_lora_side(jax_lora_layers_tree(jl)[0], JLCFG.scaling)
    return eng.generate([JaxRequest(input_ids=req.input_ids)], JaxSamplingParams(**sp))


def test_engine_side_path_matches_jax_and_merged(base):
    """Greedy G-way rollouts (the shared-prefix decode) with side adapters:
    equal to JAX's and to an engine over the merged tree; clearing restores
    the base policy."""
    jp, tp, jl, tl = base
    req = _request(0, 9)
    sp = dict(temperature=0.0, max_new_tokens=6, stop_token_ids=CFG.stop_token_ids, num_return_sequences=3, seed=0)
    eng = Engine(tp, CFG, dtype=torch.float32, device="cpu")
    eng.set_lora_side(*_side(tl))
    got = eng.generate([req], SamplingParams(**sp))
    assert got == _jax_generate(jp, jl, req, sp)
    assert got == Engine(merge_lora(tp, tl, LCFG), CFG, dtype=torch.float32, device="cpu").generate(
        [req], SamplingParams(**sp))
    eng.set_lora_side(None)
    assert eng.generate([req], SamplingParams(**sp)) == Engine(tp, CFG, dtype=torch.float32, device="cpu").generate(
        [req], SamplingParams(**sp))


def test_engine_side_path_single_row(base):
    jp, tp, jl, tl = base
    req = _request(1, 5)
    sp = dict(temperature=0.0, max_new_tokens=4, stop_token_ids=CFG.stop_token_ids)
    eng = Engine(tp, CFG, dtype=torch.float32, device="cpu")
    eng.set_lora_side(*_side(tl))
    got = eng.generate([req], SamplingParams(**sp))
    assert got == _jax_generate(jp, jl, req, sp)
    assert got == Engine(merge_lora(tp, tl, LCFG), CFG, dtype=torch.float32, device="cpu").generate(
        [req], SamplingParams(**sp))


def test_two_adapter_sets_in_turn(base):
    """A set installed after a generate is the one the next generate reads:
    each of two sets, in turn on one engine, gives the tokens of a fresh
    engine with that set, and the two differ."""
    jp, tp, _, tl = base
    tl2 = lora_from_jax({k: {n: v * 3.0 for n, v in ab.items()} for k, ab in
                         numpy_tree(_lora(jp, seed=11)[0]).items()}, CFG, device="cpu")
    req = _request(4, 12)
    sp = SamplingParams(temperature=1.0, max_new_tokens=8, stop_token_ids=(), num_return_sequences=2, seed=0)
    eng = Engine(tp, CFG, dtype=torch.float32, device="cpu")
    outs, held = [], []
    for lora in (tl, tl2, tl):
        eng.set_lora_side(*_side(lora))
        held.append(eng.lora_side[0][0]["q_w"]["lora_a"])
        outs.append(eng.generate([req], sp))
    # the engine's own copy, refilled in place by a set of the same layout
    assert held[0] is held[1] is held[2] and held[0] is not _side(tl)[0][0]["q_w"]["lora_a"]
    fresh = []
    for lora in (tl, tl2):
        e = Engine(tp, CFG, dtype=torch.float32, device="cpu")
        e.set_lora_side(*_side(lora))
        fresh.append(e.generate([req], sp))
    assert outs == [fresh[0], fresh[1], fresh[0]] and fresh[0] != fresh[1]


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_engine_side_path_over_int8_base_matches_jax(base, fuse):
    """The trainer's rollout over an int8 base: int8 weights, int8 KV and
    side adapters, greedy tokens equal to JAX's engine on the same int8 tree
    and adapters."""
    jp = base[0]
    jq = jax_quantize_params(jp, bits=8, fuse=fuse)
    tq = params_from_jax(numpy_tree(jq), CFG, device="cpu", dtype=torch.float32)
    jl, tl = _lora(jq, fused=fuse)
    req = _request(2, 8)
    sp = dict(temperature=0.0, max_new_tokens=5, stop_token_ids=CFG.stop_token_ids, num_return_sequences=2, seed=0)
    eng = Engine(tq, CFG, dtype=torch.float32, device="cpu", kv_cache_quant=True)
    eng.set_lora_side(*_side(tl))
    got = eng.generate([req], SamplingParams(**sp))
    assert got == _jax_generate(jq, jl, req, sp, kv_cache_quant=True)
    eng.set_lora_side(None)
    assert got != eng.generate([req], SamplingParams(**sp))


def test_grouped_side_adapters_match_per_projection(base, monkeypatch):
    """q/k/v and gate/up as one A_cat @ B_block-diagonal pair each: the same
    math as the per-projection side products, over both base layouts, and
    the engine's TIMER1_GROUP_SIDE_LORA=1 layout."""
    jp, tp, jl, tl = base
    layers, scaling = _side(tl)
    grouped = group_side_adapters(layers)
    assert set(grouped[0]) == {"qkv_side", "gu_side", "o_w", "down_w"}
    assert grouped[0]["qkv_side"]["lora_b"].shape == (sum(layers[0][c]["lora_b"].shape[0] for c in ("q_w", "k_w", "v_w")),
                                                    3 * LCFG.rank)
    want = _logits(tp, lora_side=(layers, scaling))
    np.testing.assert_allclose(_logits(tp, lora_side=(grouped, scaling)), want, rtol=2e-5, atol=2e-5)
    tq = params_from_jax(numpy_tree(jax_quantize_params(jp, bits=8, fuse=True)), CFG, device="cpu", dtype=torch.float32)
    np.testing.assert_allclose(_logits(tq, lora_side=(grouped, scaling)), _logits(tq, lora_side=(layers, scaling)),
                               rtol=2e-5, atol=2e-5)
    monkeypatch.setenv("TIMER1_GROUP_SIDE_LORA", "1")
    eng = Engine(tp, CFG, dtype=torch.float32, device="cpu")
    eng.set_lora_side(layers, scaling)
    assert "qkv_side" in eng.lora_side[0][0]
    req = _request(0, 9)
    sp = dict(temperature=0.0, max_new_tokens=6, stop_token_ids=CFG.stop_token_ids, num_return_sequences=3, seed=0)
    assert eng.generate([req], SamplingParams(**sp)) == _jax_generate(jp, jl, req, sp)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_pages", "int8_pages"])
def test_paged_side_path_matches_merged_and_jax(base, kv_quant):
    """PagedEngine with side adapters: the admissions' prefill and the paged
    decode steps both add them. Greedy tokens equal to the bucket engine over
    the merged tree (bf16 pages) and to JAX's paged engine (both pools);
    clearing restores the base."""
    jp, tp, jl, tl = base
    rng = np.random.default_rng(3)
    reqs = [Request(input_ids=list(rng.integers(2, 200, int(n)))) for n in (9, 21, 14)]
    sp = dict(temperature=0.0, max_new_tokens=6, stop_token_ids=CFG.stop_token_ids)
    kw = dict(max_slots=2, max_len=128, page_size=16, kv_cache_quant=kv_quant)
    paged = PagedEngine(tp, CFG, dtype=torch.float32, device="cpu", **kw)
    paged.set_lora_side(*_side(tl))
    got = paged.generate(reqs, SamplingParams(**sp))
    jpaged = JaxPagedEngine(jp, JCFG, dtype=jnp.float32, **kw)
    jpaged.set_lora_side(jax_lora_layers_tree(jl)[0], JLCFG.scaling)
    assert got == jpaged.generate([JaxRequest(input_ids=r.input_ids) for r in reqs], JaxSamplingParams(**sp))
    if not kv_quant:
        merged = Engine(merge_lora(tp, tl, LCFG), CFG, dtype=torch.float32, device="cpu")
        assert got == merged.generate(reqs, SamplingParams(**sp))
    paged.set_lora_side(None)
    assert paged.lora_side is None
    base_tokens = paged.generate(reqs, SamplingParams(**sp))
    assert base_tokens != got
    assert base_tokens == PagedEngine(tp, CFG, dtype=torch.float32, device="cpu", **kw).generate(
        reqs, SamplingParams(**sp))
