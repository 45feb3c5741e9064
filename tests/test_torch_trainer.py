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
- the host input path on the clip that tests/test_torch_video.py writes with
  OpenCV: `prepare_requests` equal to the JAX trainer's (token ids, grid and
  seconds per grid equal, patches bit-equal in f32 and after the bf16 cast;
  also from an offline-preprocessed `video.npz`), the same requests when
  prepared on worker threads, and `step_batch(examples)` with no requests
  equal to `step_batch(examples, prepare_requests(examples))` on a second
  trainer with the same seed;
- a mesh whose model dim does not divide the kv heads (A13) raises
  NotImplementedError, and context parallelism without a mesh ValueError.

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
from test_torch_video import jax_native_libs, write_clip
from tiny_tokenizer import TinyTokenizer
from time_r1_tpu.models.processor import Qwen25VLProcessor as JaxProcessor
from time_r1_tpu.rl import GRPOTrainer as JaxTrainer
from time_r1_tpu.rl import TrainConfig as JaxTrainConfig
from time_r1_tpu.rl import trainer as jax_trainer_module
from time_r1_tpu.sampler import Request as JaxRequest
from time_r1_tpu.utils.rewards import REWARD_FUNCS_REGISTRY as JAX_REWARDS
from time_r1_tpu.video.pipeline import video_loader as jax_video_loader
from time_r1_tpu_torch.models.processor import Qwen25VLProcessor
from time_r1_tpu_torch.models.qwen25vl import params_to_jax
from time_r1_tpu_torch.rl import GRPOTrainer, TrainConfig
from time_r1_tpu_torch.rl import trainer as trainer_module
from time_r1_tpu_torch.video.pipeline import video_loader
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


def test_context_parallel_needs_a_mesh():
    """JAX's check (trainer.py:322-334): context_parallel_size > 1 without a
    mesh is a ValueError."""
    tp = port_params(jax_params())
    with pytest.raises(ValueError, match="needs a device mesh"):
        GRPOTrainer(tp, CFG, Processor(), [spread_reward], config=TrainConfig(context_parallel_size=2),
                    dtype=torch.float32, device="cpu")


class _ModelParallelMesh:
    """A stand-in for a DeviceMesh of (data 1, model 4)."""

    mesh_dim_names = ("data", "model")

    def size(self, dim):
        return (1, 4)[dim]


def test_prepare_requests_and_mesh_raise():
    """prepare_requests needs a video_loader for an example that has no
    preprocessed video; a model dim that does not divide the kv heads (the
    tiny config's 2) is refused by name (A13: Megatron-style TP would need
    kv-head replication)."""
    tp = port_params(jax_params())
    tr = GRPOTrainer(tp, CFG, Processor(), [spread_reward], config=TrainConfig(report_to="none"),
                     dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="video_loader"):
        tr.prepare_requests([dict(EXAMPLE, video_path="clip.mp4")])
    with pytest.raises(NotImplementedError, match="A13"):
        GRPOTrainer(tp, CFG, Processor(), [spread_reward], dtype=torch.float32, device="cpu",
                    mesh=_ModelParallelMesh())


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


# ---------------------------------------------------------------------------
# the host input path: prepare_requests from video frames

BUDGET = dict(total_pixels=8 * 28 * 28, min_pixels=4 * 28 * 28)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    jax_native_libs()
    return write_clip(tmp_path_factory.mktemp("trainer") / "clip.mp4")


def _examples(clip, tmp_path=None):
    out = [dict(EXAMPLE, video_path=clip),
           dict(EXAMPLE, video_path=clip, problem="a door opens", video_start=0.5, video_end=2.5),
           dict(EXAMPLE, video_path=clip, video_start=1.0, video_end=None)]
    if tmp_path is not None:  # an offline-preprocessed video: video.npz wins over the decode
        frames = np.random.default_rng(9).uniform(0, 255, size=(3, 3, 28, 56)).astype(np.float16)
        np.savez(tmp_path / "video.npz", video=frames, fps=np.float32(1.6))
        out.append(dict(EXAMPLE, video_path="not-decoded.mp4", preprocessed_path=str(tmp_path)))
    return out


def _port_trainer(dtype=torch.float32, tp=None, **kw):
    processor = Qwen25VLProcessor(TinyTokenizer(), pad_token_id=CFG.pad_token_id, eos_token_id=CFG.eos_token_id)
    return GRPOTrainer(tp if tp is not None else port_params(jax_params()), CFG, processor, [spread_reward],
                       config=_config(TrainConfig, **BUDGET, **kw), video_loader=video_loader, dtype=dtype,
                       device="cpu")


def _jax_trainer(dtype):
    processor = JaxProcessor(TinyTokenizer(), pad_token_id=JCFG.pad_token_id, eos_token_id=JCFG.eos_token_id)
    return JaxTrainer(jax_params(), JCFG, processor, [spread_reward], config=_config(JaxTrainConfig, **BUDGET),
                      video_loader=jax_video_loader, dtype=dtype)


def _assert_requests_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g.input_ids) == list(w.input_ids)
        assert tuple(g.grid_thw) == tuple(w.grid_thw) and g.second_per_grid_t == w.second_per_grid_t
        assert isinstance(g.patches, torch.Tensor)
        wp = w.patches if isinstance(w.patches, torch.Tensor) else torch.from_numpy(np.asarray(w.patches))
        assert g.patches.dtype == wp.dtype and g.patches.shape == wp.shape
        assert torch.equal(g.patches, wp)


def test_prompt_templates_match_jax():
    assert trainer_module.SYSTEM_PROMPT == jax_trainer_module.SYSTEM_PROMPT
    assert trainer_module.PROMPT_TEMPLATES == jax_trainer_module.PROMPT_TEMPLATES
    for kind in ("v1", "v2", "v3"):
        for ex in (EXAMPLE, dict(EXAMPLE, video_path="v.mp4", video_start=1.0, video_end=2.0)):
            ex = dict(ex, video_path=ex.get("video_path", "v.mp4"))
            assert trainer_module.make_conversation_video(ex, kind, 100, 10) == \
                jax_trainer_module.make_conversation_video(ex, kind, 100, 10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prepare_requests_matches_jax(clip, tmp_path, dtype):
    """f32: patches bit-equal to JAX's; bf16: bit-equal after the cast (both
    round to nearest even), staged in the trainer's dtype."""
    examples = _examples(clip, tmp_path)
    want = _jax_trainer(getattr(jnp, dtype)).prepare_requests(examples)
    want = [JaxRequest(w.input_ids, torch.from_numpy(np.array(w.patches.astype(jnp.float32))).to(
        getattr(torch, dtype)), w.grid_thw, w.second_per_grid_t) for w in want]
    got = _port_trainer(getattr(torch, dtype)).prepare_requests(examples)
    _assert_requests_equal(got, want)
    assert got[-1].grid_thw == (2, 2, 4) and got[-1].second_per_grid_t == 2 / float(np.float32(1.6))
    assert all(g.patches.dtype == getattr(torch, dtype) for g in got)
    vid = CFG.video_token_id
    assert [g.input_ids.count(vid) for g in got] == [int(np.prod(g.grid_thw)) // 4 for g in got]


def test_prepare_requests_on_worker_threads_equal_serial(clip):
    """Prepared on one prefetch worker, and by 12 concurrent workers (more
    than this host's cores, a short switch interval), the requests equal a
    serial call's."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    tr = _port_trainer()
    examples = _examples(clip)
    serial = tr.prepare_requests(examples)
    with ThreadPoolExecutor(max_workers=1) as ex:
        _assert_requests_equal(ex.submit(tr.prepare_requests, examples).result(timeout=300), serial)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=12) as ex:
            futures = [ex.submit(tr.prepare_requests, [examples[i % 3]]) for i in range(12)]
            for i, f in enumerate(futures):
                _assert_requests_equal(f.result(timeout=300), [serial[i % 3]])
    finally:
        sys.setswitchinterval(interval)


def test_step_batch_prepares_its_own_requests(clip):
    """`step_batch(examples)` runs prepare_requests in host_preproc and gives
    what a second trainer with the same seed gives from requests prepared
    beforehand: the same loss, reward, metrics and updated weights."""
    jp = jax_params()
    examples = _examples(clip)[:1]
    a = _port_trainer(tp=port_params(jp), temperature=1.0)
    b = _port_trainer(tp=port_params(jp), temperature=1.0)
    for _ in range(2):
        got = a.step_batch(examples)
        want = b.step_batch(examples, b.prepare_requests(examples))
        assert got == want and np.isfinite(got["loss"])
    assert a.pop_metrics() == b.pop_metrics()
    assert "host_preproc" in a.timers.summary() and "host_preproc" not in b.timers.summary()
    for x, y in zip(jax.tree.leaves(params_to_jax(a.params, CFG)), jax.tree.leaves(params_to_jax(b.params, CFG))):
        np.testing.assert_array_equal(x, y)
