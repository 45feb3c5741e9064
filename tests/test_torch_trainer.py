"""The port's single-device trainer against the JAX package (f32, CPU, tiny
config):

- the optimizer (`rl/optim.py`) against optax's `MultiSteps(chain(
  clip_by_global_norm, adamw), k=2)` over 4 micro-steps with clipping active;
- two `GRPOTrainer.step_batch` calls of both trainers, with `engine.generate`
  replaced by the same fixed completions and a `batch_decode` wrapper over
  tests/tiny_tokenizer.py as the processor: rewards, loss, metrics and the
  parameter update agree;
- an unreplaced CPU run at T = 1.0 that completes and moves the weights;
- int8 rollouts: three CPU `step_batch` calls (one optimizer update between
  the second and third), each rollout sampling from `quantize_params` of the
  live weights; a quantized base without LoRA raises ValueError, as in JAX;
- the options that are not ported raise NotImplementedError.

Tolerances: the optimizer 1e-6 (f32, the same formulas); the trainers'
metrics 2e-4 as in tests/test_torch_grpo.py; the parameter update after one
AdamW step 2e-6 absolute, i.e. 2e-3 of the learning rate. The first Adam step
is lr·g/(|g| + eps), so a gradient element known to 5e-4 moves its update by
at most that share of lr; the trainers run with eps = 1e-4 so that gradients
that are rounding noise (the key bias's is zero in exact arithmetic) move
their weights by less than 1e-8 instead of by up to lr."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_bridge import CFG, JCFG, jax_params, port_params
from test_torch_engine import _video
from tiny_tokenizer import TinyTokenizer
from time_r1_tpu.rl import GRPOTrainer as JaxTrainer
from time_r1_tpu.rl import TrainConfig as JaxTrainConfig
from time_r1_tpu.sampler import Request as JaxRequest
from time_r1_tpu.utils.rewards import REWARD_FUNCS_REGISTRY as JAX_REWARDS
from time_r1_tpu_torch.models.qwen25vl import params_to_jax
from time_r1_tpu_torch.rl import GRPOTrainer, TrainConfig
from time_r1_tpu_torch.rl.optim import AdamWMultiSteps
from time_r1_tpu_torch.sampler import Request
from time_r1_tpu_torch.utils.rewards import REWARD_FUNCS_REGISTRY

torch.set_num_threads(2)


class Processor:
    """The trainer's processor: only `batch_decode` is used."""

    def __init__(self):
        self.tok = TinyTokenizer()

    def batch_decode(self, seqs, skip_special_tokens=True):
        return [self.tok.decode(s, skip_special_tokens=skip_special_tokens) for s in seqs]


def spread_reward(completions, **kwargs):
    """Deterministic, varying across a group: the advantages are never zero."""
    return [10.0 * i for i in range(len(completions))]


def test_optimizer_matches_optax():
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 4)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 3).astype(np.float32) for s in shapes] for _ in range(4)]
    hyper = dict(learning_rate=1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    tx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(**hyper)), every_k_schedule=2)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    opt = AdamWMultiSteps(max_grad_norm=1.0, every_k=2, **hyper)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = opt.init(tp)
    for step, g in enumerate(grads):
        assert sum(float((x ** 2).sum()) for x in g) > 1.0  # the clip is active
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        changed = opt.update(tp, [torch.from_numpy(x) for x in g], tstate)
        assert changed == (step % 2 == 1)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def _request(rng):
    vid, patches = _video(rng, (2, 4, 4))
    ids = list(rng.integers(3, 97, 5)) + vid + list(rng.integers(3, 97, 3))
    return ids, patches


def _completions(G):
    rng = np.random.default_rng(21)
    out = []
    for j in range(G):
        toks = list(rng.integers(3, 97, 2 + 2 * j))
        out.append(toks + [CFG.eos_token_id] if j % 2 == 0 else toks)  # some end in EOS
    return out


EXAMPLE = {"problem": "a person sits down", "solution": (1.0, 2.5), "durations": 4.0}


def _config(cls, **kw):
    return cls(num_generations=4, max_completion_length=8, learning_rate=1e-3, adam_epsilon=1e-4,
               report_to="none", beta=0.04, **kw)


def test_two_steps_match_the_jax_trainer(monkeypatch):
    jp = jax_params()
    jref = jax.tree.map(lambda x: x * 0.9, jp)
    ids, patches = _request(np.random.default_rng(3))
    G = 4
    comps = _completions(G)
    rewards = [JAX_REWARDS["iou"], JAX_REWARDS["format"], spread_reward]
    jtr = JaxTrainer(jp, JCFG, Processor(), rewards, config=_config(JaxTrainConfig), ref_params=jref,
                     dtype=jnp.float32)
    monkeypatch.setattr(jtr.engine, "generate", lambda reqs, sp: [list(c) for c in comps])
    jreq = JaxRequest(ids, patches, (2, 4, 4), 1.0)

    tp = port_params(jp)
    before = params_to_jax(tp, CFG)
    rewards = [REWARD_FUNCS_REGISTRY["iou"], REWARD_FUNCS_REGISTRY["format"], spread_reward]
    ttr = GRPOTrainer(tp, CFG, Processor(), rewards, config=_config(TrainConfig), ref_params=port_params(jref),
                      dtype=torch.float32, device="cpu")
    monkeypatch.setattr(ttr.engine, "generate", lambda reqs, sp: [list(c) for c in comps])
    treq = Request(ids, patches, (2, 4, 4), 1.0)

    for _ in range(2):
        want = jtr.step_batch([EXAMPLE], [jreq])
        got = ttr.step_batch([EXAMPLE], [treq])
        assert got["reward"] == pytest.approx(want["reward"], rel=1e-6)
        assert got["loss"] == pytest.approx(want["loss"], rel=2e-5, abs=2e-6)
    jm, tm = jtr.pop_metrics(), ttr.pop_metrics()
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=2e-4, atol=2e-5, err_msg=k)
    assert tm["kl"] > 0 and tm["grad_norm"] > 0

    after_j = jax.tree.map(np.asarray, jtr.params)
    after_t = params_to_jax(ttr.params, CFG)
    moved = 0
    for (path, a), (_, b), (_, b0) in zip(jax.tree_util.tree_flatten_with_path(after_j)[0],
                                          jax.tree_util.tree_flatten_with_path(after_t)[0],
                                          jax.tree_util.tree_flatten_with_path(before)[0]):
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(b - b0, a - b0, atol=2e-6, rtol=0, err_msg=name)
        moved += int(np.abs(b - b0).max() > 0)
        if "blocks" in name or "patch_embed" in name:  # fix_vit
            assert np.array_equal(b, b0), name
    assert moved > 0


def test_unpatched_cpu_run_completes():
    rng = np.random.default_rng(5)
    ids, patches = _request(rng)
    tp = port_params(jax_params())
    w0 = tp["text"]["layers"][0]["q_w"].detach().clone()
    rewards = [REWARD_FUNCS_REGISTRY["iou"], REWARD_FUNCS_REGISTRY["format"], spread_reward]
    tr = GRPOTrainer(tp, CFG, Processor(), rewards, config=_config(TrainConfig, temperature=1.0),
                     ref_params=port_params(jax_params()), dtype=torch.float32, device="cpu")
    for _ in range(2):
        info = tr.step_batch([EXAMPLE], [Request(ids, patches, (2, 4, 4), 1.0)])
        assert np.isfinite(info["loss"])
    m = tr.pop_metrics()
    assert 1 <= m["completion_length"] <= 8 and np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0
    assert tr.engine.captured_vision is not None  # the loss reused the rollout's ViT pass
    assert set(tr.timers.summary()) >= {"rollout", "rewards_host", "batch_build", "vision_frozen",
                                        "ref_logps", "train_step"}
    assert float((tp["text"]["layers"][0]["q_w"] - w0).abs().max()) > 0


@pytest.mark.parametrize("option", [
    dict(use_peft=True), dict(context_parallel_size=2),
    dict(offload_optimizer=True), dict(shared_prefix_loss=False), dict(gradient_checkpointing=True),
])
def test_unported_options_raise(option):
    tp = port_params(jax_params())
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        GRPOTrainer(tp, CFG, Processor(), [spread_reward], config=TrainConfig(**option), dtype=torch.float32,
                    device="cpu")


def test_prepare_requests_and_mesh_raise():
    tp = port_params(jax_params())
    tr = GRPOTrainer(tp, CFG, Processor(), [spread_reward], dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="A4"):
        tr.prepare_requests([EXAMPLE])
    with pytest.raises(NotImplementedError, match="A13"):
        GRPOTrainer(tp, CFG, Processor(), [spread_reward], dtype=torch.float32, device="cpu", mesh=object())


def test_int8_rollouts_run_and_resync():
    from time_r1_tpu_torch.ops.quant import quantize_params

    rng = np.random.default_rng(7)
    ids, patches = _request(rng)
    tp = port_params(jax_params())
    rewards = [REWARD_FUNCS_REGISTRY["iou"], REWARD_FUNCS_REGISTRY["format"], spread_reward]
    tr = GRPOTrainer(tp, CFG, Processor(), rewards,
                     config=_config(TrainConfig, temperature=1.0, rollout_quantization="int8"),
                     ref_params=port_params(jax_params()), dtype=torch.float32, device="cpu")
    assert tr.engine.quantization == "int8" and tr.engine.kv_cache_quant
    generate, synced = tr.engine.generate, []

    def checked_generate(reqs, sp):
        """The rollout samples from quantize_params of the live weights."""
        want = params_to_jax(quantize_params(tr.params, bits=8), CFG)
        got = params_to_jax(tr.engine.params, CFG)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
        synced.append(float(np.abs(got["text"]["layers"]["self_attn"]["qkv"]["s"]).sum()))
        return generate(reqs, sp)

    tr.engine.generate = checked_generate
    for _ in range(3):  # the third call follows the first optimizer update
        info = tr.step_batch([EXAMPLE], [Request(ids, patches, (2, 4, 4), 1.0)])
        assert np.isfinite(info["loss"])
    assert len(synced) == 3 and synced[2] != synced[0]  # the update reached the rollout weights
    m = tr.pop_metrics()
    assert np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0
    # the loss trains the unquantized tree: the engine's copy is re-made from it
    assert tr.params["text"]["layers"][0]["q_w"].dtype == torch.float32
    assert "weight_sync" in tr.timers.summary()


def test_quantized_base_without_peft_raises():
    from time_r1_tpu_torch.ops.quant import quantize_params

    for fuse in (True, False):
        base = quantize_params(port_params(jax_params()), bits=8, fuse=fuse)
        with pytest.raises(ValueError, match="LoRA"):
            GRPOTrainer(base, CFG, Processor(), [spread_reward], dtype=torch.float32, device="cpu")
