"""The port's LoRA GRPO trainer (`use_peft`) against the JAX package's, f32 on
the CPU, tiny config, after tests/test_lora_trainer.py:

- two `step_batch` calls of both trainers (`engine.generate` replaced by the
  same fixed completions, the port's adapters set to JAX's), over the f32
  base and over an int8 decode-fused base: rewards, loss, metrics and the
  adapters' update agree, the base stays bit-unchanged, the reference is the
  base itself (`ref_params is params`) and fix_vit leaves no vision adapter.
  Tolerances as in tests/test_torch_trainer.py (loss 2e-5, metrics 2e-4,
  the update after one AdamW step 2e-6 absolute, 2e-3 of lr) over the f32
  base; over the int8 base, whose forward runs in bf16, the metrics 1e-2 and
  each adapter's update within 3e-2 of its largest element, with Adam's eps
  1 so that the first update is about lr · g: the adapter gradients agree to
  1.4e-2 of their scale there (tests/test_torch_lora.py), and with a small
  eps Adam's lr · g / (|g| + eps) would pass that error on whole wherever
  |g| is near eps;
- the refusals: an int4 base (nothing to adapt) and, over an int8 base,
  fix_vit=False (ValueError when the trainer is built; the JAX package fails
  at its first step: ROADMAP §C);
- the weight sync's three routes on an unpatched CPU run: the int8 base's
  side adapters (the engine shares the trainer's tree), a bf16 base with int8
  rollouts (`merge_quantize`, bit-equal to quantizing the merged tree) and a
  bf16 base (the merged tree);
- checkpoints: the merged model (over an int8 base, the base) with
  `lora_adapters.npz` beside it; a resume that restores the adapters and
  their Adam state bit for bit and then steps on exactly as an uninterrupted
  run; a checkpoint of merged weights only becoming the new base with the
  optimizer state skipped; an int8 base without adapters refused."""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_bridge import CFG, JCFG, jax_params, numpy_tree, port_params
from test_torch_trainer import EXAMPLE, Processor, _completions, _config, _request, spread_reward
from time_r1_tpu.ops.quant import quantize_params as jax_quantize_params
from time_r1_tpu.rl import GRPOTrainer as JaxTrainer
from time_r1_tpu.rl import TrainConfig as JaxTrainConfig
from time_r1_tpu.sampler import Request as JaxRequest
from time_r1_tpu.utils.rewards import REWARD_FUNCS_REGISTRY as JAX_REWARDS
from time_r1_tpu_torch.models.qwen25vl import params_from_jax, params_to_jax
from time_r1_tpu_torch.models.qwen25vl.convert import LORA_FILE, load_checkpoint, lora_from_jax, lora_to_jax
from time_r1_tpu_torch.ops.quant import is_quantized, quantize_params
from time_r1_tpu_torch.rl import GRPOTrainer, TrainConfig
from time_r1_tpu_torch.rl.lora import lora_layers_tree, lora_leaves, merge_lora, merge_quantize
from time_r1_tpu_torch.rl.trainer import _copy_tree
from time_r1_tpu_torch.sampler import Request
from time_r1_tpu_torch.utils.rewards import REWARD_FUNCS_REGISTRY

torch.set_num_threads(2)
PEFT = dict(use_peft=True, lora_r=4, lora_alpha=8.0)


def _snapshot(tree):
    return [t.detach().clone() if isinstance(t, torch.Tensor) else t for t in jax.tree.leaves(tree)]


def _trees_equal(a, b) -> bool:
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("base", ["f32", "int8_fused"])
def test_two_steps_match_the_jax_lora_trainer(monkeypatch, base):
    jp = jax_params()
    if base == "int8_fused":
        jp = jax_quantize_params(jp, bits=8, fuse=True)
    ids, patches = _request(np.random.default_rng(3))
    comps = _completions(4)
    # over the int8 base Adam's eps is 1, so that the update is about lr · g
    # and carries the gradients' error in proportion
    eps = dict(adam_epsilon=1e-4 if base == "f32" else 1.0)
    jtr = JaxTrainer(jp, JCFG, Processor(), [JAX_REWARDS["iou"], JAX_REWARDS["format"], spread_reward],
                     config=replace(_config(JaxTrainConfig, **PEFT), **eps), dtype=jnp.float32)
    monkeypatch.setattr(jtr.engine, "generate", lambda reqs, sp: [list(c) for c in comps])
    tp = params_from_jax(numpy_tree(jp), CFG, device="cpu", dtype=torch.float32)
    ttr = GRPOTrainer(tp, CFG, Processor(), [REWARD_FUNCS_REGISTRY["iou"], REWARD_FUNCS_REGISTRY["format"],
                                             spread_reward], config=replace(_config(TrainConfig, **PEFT), **eps),
                      dtype=torch.float32, device="cpu")
    monkeypatch.setattr(ttr.engine, "generate", lambda reqs, sp: [list(c) for c in comps])
    assert ttr.ref_params is ttr.params and "visual" not in ttr.lora
    assert [k for k in jtr.lora if k.startswith("visual")] == []
    jtr.lora = jax.tree.map(lambda a: a + 0.01, jtr.lora)  # B away from 0: a KL to the base, no trivial check
    _copy_tree(lora_from_jax(numpy_tree(jtr.lora), CFG, device="cpu"), ttr.lora)
    before = lora_to_jax(ttr.lora, CFG)
    base_before = _snapshot(ttr.params)

    for _ in range(2):
        want = jtr.step_batch([EXAMPLE], [JaxRequest(ids, patches, (2, 4, 4), 1.0)])
        got = ttr.step_batch([EXAMPLE], [Request(ids, patches, (2, 4, 4), 1.0)])
        assert got["reward"] == pytest.approx(want["reward"], rel=1e-6)
        assert got["loss"] == pytest.approx(want["loss"], rel=2e-5, abs=2e-6)
    jm, tm = jtr.pop_metrics(), ttr.pop_metrics()
    assert set(tm) == set(jm) and tm["kl"] > 0 and tm["grad_norm"] > 0
    mtol = 2e-4 if base == "f32" else 1e-2
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=mtol, atol=mtol / 10, err_msg=k)
    assert ttr.opt_state.count == 1
    after_j, after_t = numpy_tree(jtr.lora), lora_to_jax(ttr.lora, CFG)
    for k in after_j:
        for n in ("lora_a", "lora_b"):
            dt, dj = after_t[k][n] - before[k][n], after_j[k][n] - before[k][n]
            utol = 2e-6 if base == "f32" else 3e-2 * np.abs(dj).max()
            np.testing.assert_allclose(dt, dj, atol=utol, rtol=0, err_msg=f"{k}/{n}")
        assert np.abs(after_t[k]["lora_b"] - before[k]["lora_b"]).max() > 0  # the adapters moved
    assert all(torch.equal(a, b) for a, b in zip(_snapshot(ttr.params), base_before))  # the base is frozen


def _trainer(tp, **kw):
    return GRPOTrainer(tp, CFG, Processor(), [spread_reward], config=_config(TrainConfig, **{**PEFT, **kw}),
                       dtype=torch.float32, device="cpu")


def test_refusals():
    tp = port_params(jax_params())
    with pytest.raises(ValueError, match="no adaptable weights"):
        _trainer(quantize_params(tp, bits=4))
    with pytest.raises(ValueError, match="fix_vit=True"):
        _trainer(quantize_params(tp, bits=8), fix_vit=False)
    tr = _trainer(tp, fix_vit=False)  # a bf16 base trains the ViT's adapters too
    assert len(tr.lora["visual"]["blocks"]) == CFG.vision.depth


def test_merge_quantize_matches_the_two_step_route():
    """Route (b)'s layer-at-a-time merge and quantize is bit-equal to
    quantizing the whole merged tree, ViT adapters included."""
    tp = port_params(jax_params())
    tr = _trainer(tp, fix_vit=False, rollout_quantization="int8")
    for t in lora_leaves(tr.lora):
        t.add_(0.01)
    got = merge_quantize(tp, tr.lora, tr.lora_cfg, bits=8)
    want = quantize_params(merge_lora(tp, tr.lora, tr.lora_cfg), bits=8)
    assert jax.tree.structure(got) == jax.tree.structure(want) and _trees_equal(got, want)


def _cpu_step(tr, seed=5):
    ids, patches = _request(np.random.default_rng(seed))
    return tr.step_batch([EXAMPLE], [Request(ids, patches, (2, 4, 4), 1.0)])


@pytest.mark.parametrize("route", ["int8_base", "bf16_int8_rollouts", "bf16"])
def test_weight_sync_routes(route):
    """An unpatched CPU step_batch per route, and what the engine holds after
    the sync: the trainer's own int8 tree with the adapters as side products;
    an int8 copy of the merged tree; the merged tree."""
    tp = port_params(jax_params())
    if route == "int8_base":
        tp = quantize_params(tp, bits=8)
    tr = _trainer(tp, temperature=1.0, rollout_quantization="int8" if route != "bf16" else "")
    for t in lora_leaves(tr.lora):
        t.add_(0.01)
    info = _cpu_step(tr)
    assert np.isfinite(info["loss"])
    eng = tr.engine
    if route == "int8_base":
        assert eng.params is tr.params and eng.quantization is None and eng.kv_cache_quant
        layers, _ = lora_layers_tree(tr.lora)
        for got, want in zip(lora_leaves(eng.lora_side[0]), lora_leaves(layers)):
            assert torch.equal(got, want.detach()) and got is not want
    elif route == "bf16_int8_rollouts":
        assert eng.lora_side is None and is_quantized(eng.params["text"]["layers"][0]["qkv"])
        assert _trees_equal(eng.params, quantize_params(merge_lora(tp, tr.lora, tr.lora_cfg), bits=8))
    else:
        assert eng.lora_side is None and _trees_equal(eng.params, merge_lora(tp, tr.lora, tr.lora_cfg))


@pytest.mark.parametrize("base", ["bf16", "int8"])
def test_checkpoint_resume_restores_adapters_and_moments(tmp_path, monkeypatch, base):
    """Save after an update with the optimizer state, resume into a fresh
    trainer: adapters and Adam state bit-equal, the base untouched; one more
    step then equals the uninterrupted run's bit for bit."""
    tp0 = port_params(jax_params())
    if base == "int8":
        tp0 = quantize_params(tp0, bits=8)
    comps = _completions(4)

    def trainer():
        tr = _trainer(jax.tree.map(lambda t: t.clone(), tp0), save_only_model=False)
        monkeypatch.setattr(tr.engine, "generate", lambda reqs, sp: [list(c) for c in comps])
        return tr

    first = trainer()
    for _ in range(2):
        _cpu_step(first)
    assert first.opt_state.count == 1
    first.save_checkpoint(str(tmp_path / "ck"))
    assert os.path.exists(tmp_path / "ck" / LORA_FILE)
    saved, _ = load_checkpoint(str(tmp_path / "ck"), dtype=torch.float32, device="cpu")
    assert _trees_equal(saved, first._policy_params())
    if base == "int8":
        assert _trees_equal(saved, first.params) and is_quantized(saved["text"]["layers"][0]["qkv"])

    resumed = trainer()
    resumed.load_checkpoint_state(str(tmp_path / "ck"))
    assert resumed.global_step == 2 and resumed.opt_state.count == 1
    assert _trees_equal(resumed.lora, first.lora) and _trees_equal(resumed.params, tp0)
    assert _trees_equal(resumed.opt_state.tree(), first.opt_state.tree())
    for tr in (first, resumed):
        _cpu_step(tr)
        _cpu_step(tr)
    assert resumed.opt_state.count == first.opt_state.count == 2
    assert _trees_equal(resumed.lora, first.lora) and _trees_equal(resumed.opt_state.tree(), first.opt_state.tree())

    os.remove(tmp_path / "ck" / LORA_FILE)
    fresh = trainer()
    if base == "int8":
        with pytest.raises(ValueError, match=LORA_FILE):
            fresh.load_checkpoint_state(str(tmp_path / "ck"))
        return
    moments = _snapshot(fresh.opt_state.tree())
    fresh.load_checkpoint_state(str(tmp_path / "ck"))  # merged weights only: a new base
    assert _trees_equal(fresh.params, saved)
    assert all(torch.equal(a, b) for a, b in zip(_snapshot(fresh.opt_state.tree()), moments))
