"""Data parallelism over processes: two gloo ranks
(`test_torch_ring_attention.spawn_ranks`), each with its own rows, against one
process over the concatenated groups (the cases of JAX's
tests/test_multiprocess_dp.py, whose oracle is JAX's `grpo_loss` on the
concatenation):

- one `make_train_step(group=...)` step on each rank's text group, for
  PPO-clip and GRPO: the loss, the metrics and the updated weights against
  JAX's `make_train_step` (optax's clip + AdamW) over the concatenated
  groups, so each rank's loss is its share over the global normalizer (the
  token count, or the row count) and the summed gradients are the whole
  batch's; the ranks' weights bit-equal;
- the loss with each rank's own video, on full rows and on the split batch,
  and with a video on one rank and text on the other, against JAX's loss over
  the union (the port needs no union of videos: each rank runs its own
  forward);
- the metric gather with keys present on one rank only (`m0 == m1`, reward
  1.5, `metrics/reward_timestep_pair` 0.25 from rank 0 only), through a
  `GRPOTrainer` on a `make_mesh` mesh;
- `GRPOTrainer.train()` under data parallelism (the trainer on a mesh
  shards its parameters and optimizer state over the ranks, FSDP: they are
  compared through `gathered_params`), with the optimizer state on
  the device and offloaded, against one process's `train()` over both
  examples (loss, metrics, weights; offload bit-equal to no offload), and a
  dataset of one example over two ranks (each rank's shard repeats it; the
  run neither hangs nor runs out), with the checkpoint written once.

Tolerances: the loss 1e-4 relative (JAX's), the metrics 2e-4, the weights
after one AdamW step 2e-6 absolute at lr 1e-3 and eps 1e-4, as
tests/test_torch_trainer.py.

This module imports no JAX at its top: the ranks import it to run `_worker`.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_ring_attention import spawn_ranks

G = 4


def _text_group(pid, eos):
    rng = np.random.default_rng(100 + pid)
    return {
        "prompt_ids": list(rng.integers(2, 200, 6)),
        "completions": [list(rng.integers(2, 200, int(rng.integers(2, 5)))) + [eos] for _ in range(G)],
        "advantages": rng.normal(size=G).astype(np.float32),
        "patches": None, "grid_thw": None, "second_per_grid_t": 1.0,
    }


def _video_group(pid, cfg):
    grid = (2, 4, 4)
    n_vis = (2 * 4 * 4) // cfg.vision.merge_unit
    rv = np.random.default_rng(200 + pid)
    return {
        "prompt_ids": [5, 6, cfg.vision_start_token_id] + [cfg.video_token_id] * n_vis + [cfg.vision_end_token_id, 7],
        "completions": [list(rv.integers(2, 200, 3)) + [cfg.eos_token_id] for _ in range(G)],
        "advantages": rv.normal(size=G).astype(np.float32),
        "patches": rv.normal(size=(2 * 4 * 4, cfg.vision.patch_input_dim)).astype(np.float32),
        "grid_thw": grid, "second_per_grid_t": 1.0,
    }


def _asym_text_group(eos):
    return {
        "prompt_ids": list(np.random.default_rng(300).integers(2, 200, 7)),
        "completions": [list(np.random.default_rng(301 + i).integers(2, 200, 3)) + [eos] for i in range(G)],
        "advantages": np.random.default_rng(302).normal(size=G).astype(np.float32),
        "patches": None, "grid_thw": None, "second_per_grid_t": 1.0,
    }


EXAMPLES = [{"problem": "a person sits down", "solution": (1.0, 2.5), "durations": 4.0, "i": 0},
            {"problem": "the door opens", "solution": (0.5, 3.0), "durations": 4.0, "i": 1}]


class _Processor:
    """The trainer's processor: only `batch_decode` is used."""

    def __init__(self):
        from tiny_tokenizer import TinyTokenizer

        self.tok = TinyTokenizer()

    def batch_decode(self, seqs, skip_special_tokens=True):
        return [self.tok.decode(s, skip_special_tokens=skip_special_tokens) for s in seqs]


def _spread_reward(completions, **kwargs):
    return [10.0 * i + len(c) for i, c in enumerate(completions)]


def _trainer(params, ref_params, cfg, out_dir, mesh=None, **kw):
    """A GRPOTrainer whose rollouts are fixed completions of each example and
    whose requests are built from the example's index, with no video
    decode."""
    from time_r1_tpu_torch.rl import GRPOTrainer, TrainConfig
    from time_r1_tpu_torch.sampler import Request
    from time_r1_tpu_torch.utils.rewards import REWARD_FUNCS_REGISTRY

    config = TrainConfig(**{**dict(num_generations=G, max_completion_length=8, learning_rate=1e-3,
                                   adam_epsilon=1e-4, report_to="none", beta=0.04, gradient_accumulation_steps=1,
                                   num_train_epochs=1, output_dir=out_dir, save_steps=1000), **kw})
    tr = GRPOTrainer(params, cfg, _Processor(), [REWARD_FUNCS_REGISTRY["iou"], REWARD_FUNCS_REGISTRY["format"],
                                                 _spread_reward], config=config, ref_params=ref_params,
                     mesh=mesh, dtype=torch.float32, device="cpu")

    def request(example):
        rng = np.random.default_rng(10 + example["i"])
        t, h, w = 2, 4, 4
        ids = (list(rng.integers(3, 97, 5)) + [cfg.vision_start_token_id]
               + [cfg.video_token_id] * (t * h * w // cfg.vision.merge_unit) + [cfg.vision_end_token_id]
               + list(rng.integers(3, 97, 3)))
        patches = rng.normal(size=(t * h * w, cfg.vision.patch_input_dim)).astype(np.float32)
        return Request(ids, torch.from_numpy(patches), (t, h, w), 1.0)

    def completions(requests, sp):
        out = []
        for r in requests:
            rng = np.random.default_rng(int(sum(r.input_ids)))
            for j in range(G):
                toks = list(rng.integers(3, 97, 2 + 2 * j))
                out.append(toks + [cfg.eos_token_id] if j % 2 == 0 else toks)
        return out

    tr.prepare_requests = lambda examples: [request(e) for e in examples]
    tr.engine.generate = completions
    return tr


def _leaf_list(params):
    from time_r1_tpu_torch.rl.grpo import _leaves

    return [p.detach().clone() for p in _leaves(params)]


def _worker(rank: int, world: int, workdir: str) -> None:
    import copy

    import torch.distributed as dist

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig
    from time_r1_tpu_torch.parallel import make_mesh, maybe_init_distributed
    from time_r1_tpu_torch.rl import GRPOHyperParams, build_grpo_batch_groups, build_grpo_split_batch, make_train_step
    from time_r1_tpu_torch.rl.grpo import grpo_value_and_grad, trainable_leaves
    from time_r1_tpu_torch.rl.optim import AdamWMultiSteps
    from time_r1_tpu_torch.rl.trainer import TrainConfig
    from time_r1_tpu_torch.utils.rewards import METRIC_FUNCS_REGISTRY, REWARD_FUNCS_REGISTRY

    torch.set_num_threads(1)
    maybe_init_distributed("cpu")
    mesh = make_mesh()
    group = mesh.get_group("data")
    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    cfg = Qwen25VLConfig.tiny_test(payload["vocab"])
    out = {}

    def full(groups):
        return build_grpo_batch_groups(cfg, groups, pad_to=64, dtype=torch.float32, device="cpu")

    for use_grpo in (False, True):
        params = copy.deepcopy(payload["params"])
        hp = GRPOHyperParams(num_generations=G, beta=0.0, use_grpo=use_grpo, fix_vit=True)
        opt = AdamWMultiSteps(1e-3, eps=1e-4, max_grad_norm=1.0)
        step = make_train_step(cfg, hp, opt, group=group)
        state = opt.init(trainable_leaves(params, True))
        _, _, loss, metrics = step(params, state, full([_text_group(rank, cfg.eos_token_id)]))
        out[("step", use_grpo)] = dict(loss=float(loss), metrics={k: float(v) for k, v in metrics.items()},
                                       params=_leaf_list(params))

    hp = GRPOHyperParams(num_generations=G, beta=0.0, use_grpo=False, fix_vit=True)
    params = payload["params"]
    vgroup = _video_group(rank, cfg)
    out["vision_loss"] = float(grpo_value_and_grad(params, cfg, hp, full([vgroup]), group=group)[0])
    split = build_grpo_split_batch(cfg, [vgroup], dtype=torch.float32, device="cpu")
    out["split_vision_loss"] = float(grpo_value_and_grad(params, cfg, hp, split, group=group)[0])
    asym = vgroup if rank == 0 else _asym_text_group(cfg.eos_token_id)
    out["asym_vision_loss"] = float(grpo_value_and_grad(params, cfg, hp, full([asym]), group=group)[0])

    # the metric gather with keys present on one rank only
    from time_r1_tpu_torch.rl import GRPOTrainer

    shim = GRPOTrainer(copy.deepcopy(params), cfg, None, [REWARD_FUNCS_REGISTRY["format"]],
                       metric_funcs=list(METRIC_FUNCS_REGISTRY.values()),
                       config=TrainConfig(beta=0.0, use_grpo=False, report_to="none"), mesh=mesh,
                       dtype=torch.float32, device="cpu")
    shim._log_metric("reward", 1.0 + rank)
    shim._log_metric("rewards/format_reward", 0.5)
    if rank == 0:
        shim._log_metric("metrics/reward_timestep_pair", 0.25)
    out["gathered"] = shim.pop_metrics()

    # train() over each rank's shard: two examples, the optimizer state on the
    # device and offloaded; then one example over the two ranks
    for name, dataset, offload in (("train", EXAMPLES, False), ("train_offload", EXAMPLES, True),
                                   ("train_one", EXAMPLES[:1], False)):
        run_dir = os.path.join(workdir, name)
        tr = _trainer(copy.deepcopy(payload["params"]), payload["ref_params"], cfg, run_dir, mesh=mesh,
                      offload_optimizer=offload)
        logs = []
        tr.train(dataset, log_fn=logs.append)
        out[name] = dict(logs=logs, params=_leaf_list(tr.gathered_params()), steps=tr.global_step,
                         saved=sorted(os.listdir(run_dir)))
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax

    from test_torch_bridge import VOCAB, jax_params, port_params

    jp = jax_params()
    jref = {**jp, "text": jax.tree.map(lambda x: x * 0.9, jp["text"])}
    workdir = tmp_path_factory.mktemp("dp")
    torch.save(dict(vocab=VOCAB, params=port_params(jp), ref_params=port_params(jref)),
               os.path.join(workdir, "payload.pt"))
    return jp, jref, spawn_ranks("test_torch_multiprocess_dp", "_worker", 2, workdir)


def _jax_loss(jp, groups, use_grpo=False):
    import jax.numpy as jnp

    from test_torch_bridge import JCFG
    from time_r1_tpu.rl import GRPOHyperParams, build_grpo_batch_groups
    from time_r1_tpu.rl.grpo import grpo_loss

    batch = build_grpo_batch_groups(JCFG, groups, pad_to=64, dtype=jnp.float32)
    hp = GRPOHyperParams(num_generations=G, beta=0.0, use_grpo=use_grpo, fix_vit=True)
    return grpo_loss(jp, JCFG, hp, batch), batch, hp


@pytest.mark.parametrize("use_grpo", [False, True], ids=["ppo_clip", "grpo"])
def test_two_process_step_matches_one_process(setup, use_grpo):
    import jax
    import optax

    from test_torch_bridge import CFG, JCFG, port_params
    from time_r1_tpu.rl import make_train_step as jax_train_step

    jp, _, results = setup
    (want, wmetrics), batch, hp = _jax_loss(jp, [_text_group(0, CFG.eos_token_id), _text_group(1, CFG.eos_token_id)],
                                            use_grpo)
    r0, r1 = (r[("step", use_grpo)] for r in results)
    assert r0["loss"] == r1["loss"] and r0["metrics"] == r1["metrics"]
    assert r0["loss"] == pytest.approx(float(want), rel=1e-4)
    for k, v in wmetrics.items():
        assert r0["metrics"][k] == pytest.approx(float(v), rel=2e-4, abs=2e-5), k
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3, eps=1e-4))
    new, _, _, jm = jax.jit(jax_train_step(JCFG, hp, opt))(jp, opt.init(jp), batch)
    assert r0["metrics"]["grad_norm"] == pytest.approx(float(jm["grad_norm"]), rel=2e-4)
    from time_r1_tpu_torch.rl.grpo import _leaves

    want_leaves = _leaves(port_params(new))
    for a, b, c in zip(r0["params"], r1["params"], want_leaves):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0, atol=2e-6)


@pytest.mark.parametrize("kind", ["vision_loss", "split_vision_loss", "asym_vision_loss"])
def test_two_process_vision_losses_match_the_union(setup, kind):
    from test_torch_bridge import CFG

    jp, _, results = setup
    groups = [_video_group(0, CFG), _video_group(1, CFG)]
    if kind == "asym_vision_loss":
        groups = [groups[0], _asym_text_group(CFG.eos_token_id)]
    (want, _), _, _ = _jax_loss(jp, groups)
    assert results[0][kind] == pytest.approx(results[1][kind], rel=1e-6)
    assert results[0][kind] == pytest.approx(float(want), rel=1e-4)


def test_metric_gather_with_rank_asymmetric_keys(setup):
    m0, m1 = (r["gathered"] for r in setup[2])
    assert m0 == m1
    assert m0["reward"] == pytest.approx(1.5)
    assert m0["rewards/format_reward"] == pytest.approx(0.5)
    assert m0["metrics/reward_timestep_pair"] == pytest.approx(0.25)  # rank 0 only


@pytest.mark.parametrize("name,n_examples", [("train", 2), ("train_offload", 2), ("train_one", 1)])
def test_train_under_dp_matches_one_process(setup, tmp_path, name, n_examples):
    from test_torch_bridge import CFG, port_params

    jp, jref, results = setup
    r0, r1 = (r[name] for r in results)
    assert r0["steps"] == r1["steps"] == 1
    assert r0["saved"] == ["epoch-1"]  # written once, by rank 0
    for a, b in zip(r0["params"], r1["params"]):
        assert torch.equal(a, b)
    assert r0["logs"] == r1["logs"]
    # one process over the concatenated shards: both examples, or the one
    # example twice (each rank's shard repeats it)
    dataset = EXAMPLES if n_examples == 2 else [EXAMPLES[0], EXAMPLES[0]]
    one = _trainer(port_params(jp), port_params(jref), CFG, str(tmp_path), per_device_train_batch_size=2)
    logs = []
    one.train(dataset, log_fn=logs.append)
    (want,) = logs
    (got,) = r0["logs"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=2e-4, abs=2e-5), k
    for a, b in zip(r0["params"], _leaf_list(one.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-6)
    if name == "train_offload":
        for a, b in zip(r0["params"], results[0]["train"]["params"]):
            assert torch.equal(a, b)  # offload is bit-equal to the device-resident state
