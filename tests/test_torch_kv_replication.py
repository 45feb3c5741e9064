"""Tensor parallelism past the kv heads: each kv head replicated on tp/nkv
model ranks (`parallel/tensor.py`), against the JAX package, whose GSPMD
splits a head across devices there instead.

Two variants of the tiny config, the same `dataclasses.replace` applied to
both packages' `tiny_test(VOCAB)` (`variant`):

- A: one kv head under 4 q heads and 2 vision heads, and a vision MLP width
  of 45, which the model dim does not split (the 3B's 3420 at tp 8 in
  small: gate, up and down stay whole on every rank). Four gloo ranks on a
  2×2 mesh (FSDP × TP, so tp 2 replicates the kv head): one f32 GRPO step
  (`grpo_value_and_grad`, then `make_train_step`, fix_vit off so that the
  vision tower is trained) against JAX's `make_train_step` over
  `shard_params` on a 2×2 mesh of virtual devices (optax's clip + AdamW):
  the loss and every gradient within 1e-5 of JAX's (relative, the gradient's
  norm), the updated tree gathered within 2e-6 absolute (lr 1e-3, eps 1e-4,
  as tests/test_torch_fsdp.py); the replicas of each kv block bit-equal
  after the step; the clip's norm over blocks (`global_sq_sum`) equal to the
  whole tree's; `gather_params` over the blocks equal to the whole tree; a
  `GRPOTrainer` over the mesh saved after one `step_batch` (optimizer state
  offloaded) and resumed into a fresh trainer, whose next step equals the
  uninterrupted run's bit for bit.
- B: 8 q heads over 2 kv heads, 4 vision heads and a vision MLP width of 50,
  at tp 4 (the 3B's layout at tp 4, small). Four gloo ranks on a 1×4 mesh:
  the TP `Engine` at G = 1 and 2, `PagedEngine` over the whole tree and,
  with int8 weights and int8 pages, over a TP `Engine`'s serving tree, and
  `ContinuousEngine`, greedy in f32, against JAX's engines over
  `shard_params` on a 1×4 mesh of virtual devices (as
  `test_torch_tp_engine.py::jax_sharded`): the tokens equal across ranks,
  equal to JAX's and to one process's port engine; the caches and pools
  hold one kv head a rank.

The CLIs over four gloo ranks with torchrun's environment
(`_cli_worker`): `cli.evaluate --tensor_parallel_size 4` on config B, plain
and with `--use_continuous_batching --kv_block_size 128`, its records equal
to one process's `cli.evaluate` over the same f32 weights;
`cli.train --tensor_parallel_size 4` on config B (1×4) and
`--tensor_parallel_size 2` on config A (2×2) from HF checkpoints, every
rank's gathered weights bit-equal and equal to the final checkpoint.

Without processes: the replicated specs and blocks (`shard_leaf`), the
serving tree's fused int8 and int4 leaves (the rank's q rows over its whole
kv head, quantized whole and then cut), and the rule's accepted and refused
(q heads, kv heads, vision heads, tp).

This module imports no JAX at its top: the ranks import it to run their
workers.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from test_torch_multiprocess_dp import EXAMPLES, G, _leaf_list, _trainer, _video_group
from test_torch_ring_attention import spawn_ranks
from test_torch_tp_engine import requests, sampling
from test_torch_tp_paged import MAX_LEN, PAGE, SLOTS, _requests

VOCAB = 256
GRAD_TOL = 1e-5  # loss and each gradient: |port - JAX| / |JAX| (the gradient's norm), f32


def variant(cfg, name: str):
    """Config A or B from either package's tiny config (the module
    docstring)."""
    if name == "A":
        return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_key_value_heads=1),
                                   vision=dataclasses.replace(cfg.vision, intermediate_size=45))
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, hidden_size=128, num_attention_heads=8, num_key_value_heads=2),
        vision=dataclasses.replace(cfg.vision, num_heads=4, intermediate_size=50, out_hidden_size=128))


def port_cfg(name: str):
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig

    return variant(Qwen25VLConfig.tiny_test(VOCAB), name)


def jax_cfg(name: str):
    from time_r1_tpu.models.qwen25vl import Qwen25VLConfig

    return variant(Qwen25VLConfig.tiny_test(VOCAB), name)


def jax_tree(name: str):
    from test_torch_bridge import jax_params, numpy_tree

    return numpy_tree(jax_params(cfg=jax_cfg(name)))


def whole_params(name: str):
    from test_torch_bridge import port_params

    return port_params(jax_tree(name), port_cfg(name))


def _hp(fix_vit=False):
    from time_r1_tpu_torch.rl import GRPOHyperParams

    return GRPOHyperParams(num_generations=G, beta=0.0, fix_vit=fix_vit)


def _tree_like(tree, leaves: list):
    """`leaves` (in `_leaves` order) in the shape of `tree`."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return next(it)

    return walk(tree)


KV = ("k_w", "v_w", "k_b", "v_b")


def _worker_a(rank: int, world: int, workdir: str) -> None:
    """Config A on a 2×2 mesh (the module docstring)."""
    import torch.distributed as dist

    from time_r1_tpu_torch.parallel import kv_replica_group, make_mesh, maybe_init_distributed
    from time_r1_tpu_torch.parallel.sharding import ShardContext, gather_params, global_sq_sum
    from time_r1_tpu_torch.rl import build_grpo_split_batch, make_train_step
    from time_r1_tpu_torch.rl.grpo import _leaves, grpo_value_and_grad, trainable_leaves
    from time_r1_tpu_torch.rl.optim import AdamWMultiSteps

    torch.set_num_threads(1)
    maybe_init_distributed("cpu")
    mesh = make_mesh(2)
    cfg = port_cfg("A")
    params = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)["params"]
    nkv = cfg.text.num_key_value_heads
    shard = dataclasses.replace(ShardContext.build(mesh, params).with_kv_heads(nkv),
                                kv_group=kv_replica_group(mesh, nkv))
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    group = mesh.get_group("data")
    out = {"coords": (d, m), "kv_rows": shard.shard(params)["text"]["layers"][0]["k_w"].shape[0]}
    blocks = shard.shard(params)
    out["gathered"] = _leaf_list(gather_params(blocks, shard))
    specs = _leaves(shard.specs)
    out["sq_sum"] = float(global_sq_sum(_leaves(blocks), specs, shard))

    batch = build_grpo_split_batch(cfg, [_video_group(d, cfg)], dtype=torch.float32, device="cpu")
    loss, _, grads = grpo_value_and_grad(blocks, cfg, _hp(), batch, group=group, shard=shard)
    out["grad_loss"] = float(loss)
    out["grads"] = _leaf_list(gather_params(_tree_like(params, [g.detach() for g in grads]), shard))
    blocks = shard.shard(params)
    opt = AdamWMultiSteps(1e-3, eps=1e-4, max_grad_norm=1.0)
    state = opt.init(trainable_leaves(blocks, False))
    _, _, loss, metrics = make_train_step(cfg, _hp(), opt, group=group, shard=shard)(blocks, state, batch)
    out["step"] = dict(loss=float(loss), metrics={k: float(v) for k, v in metrics.items()},
                       params=_leaf_list(gather_params(blocks, shard)),
                       kv=[{k: lp[k].detach().clone() for k in KV} for lp in blocks["text"]["layers"]])

    kw = dict(gradient_accumulation_steps=1, save_only_model=False, offload_optimizer=True)
    ckpt = os.path.join(workdir, "ckpt")
    whole = _trainer(params, None, cfg, os.path.join(workdir, "whole"), mesh=mesh, beta=0.0, **kw)
    whole.step_batch([EXAMPLES[d]])
    whole.save_checkpoint(ckpt)
    whole.step_batch([EXAMPLES[d]])
    resumed = _trainer(params, None, cfg, os.path.join(workdir, "resumed"), mesh=mesh, beta=0.0, **kw)
    resumed.load_checkpoint_state(ckpt)
    resumed.step_batch([EXAMPLES[d]])
    out["resume"] = dict(whole=_leaf_list(whole.gathered_params()), resumed=_leaf_list(resumed.gathered_params()),
                         first=_leaf_list(params), steps=(whole.global_step, resumed.global_step))
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# (name, engine, request names, G, quantization, int8 KV)
CASES_B = [
    ("engine_g1", "engine", ("text", "video"), 1, None, False),
    ("engine_g2", "engine", ("video",), 2, None, False),
    ("paged", "paged", ("text", "video", "short"), 1, None, False),
    ("paged_int8", "paged_over_engine", ("text", "video", "short"), 1, "int8", True),
    ("continuous", "continuous", ("text", "video", "short"), 1, None, False),
]


def _engine_b(kind, params, cfg, quant, kv, shard):
    """The port's engine of a case of CASES_B, over `shard` or (None) in one process."""
    from time_r1_tpu_torch.sampler import ContinuousEngine, Engine, PagedEngine

    kw = dict(dtype=torch.float32, device="cpu", shard=shard)
    cont = dict(max_slots=SLOTS, max_len=MAX_LEN)
    if kind == "engine":
        return Engine(params, cfg, quantization=quant, kv_cache_quant=kv, **kw)
    if kind == "paged":
        return PagedEngine(params, cfg, page_size=PAGE, **cont, **kw)
    if kind == "continuous":
        return ContinuousEngine(params, cfg, **cont, **kw)
    eng = Engine(params, cfg, quantization=quant, kv_cache_quant=kv, **kw)
    return PagedEngine(eng.params, cfg, page_size=PAGE, kv_cache_quant=kv, **cont, **kw)


def _worker_b(rank: int, world: int, workdir: str) -> None:
    """Config B's engines on a 1×4 mesh (the module docstring)."""
    import torch.distributed as dist

    from time_r1_tpu_torch.models.qwen25vl import KVCache
    from time_r1_tpu_torch.parallel import ShardContext, make_mesh, maybe_init_distributed
    from time_r1_tpu_torch.sampler import Request, SamplingParams
    from time_r1_tpu_torch.sampler.paged import make_pool

    torch.set_num_threads(1)
    maybe_init_distributed("cpu")
    cfg = port_cfg("B")
    params = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)["params"]
    shard = ShardContext.build(make_mesh(model_parallel=4), params)  # the engines take the kv heads from cfg
    out = {}
    for name, kind, names, G_, quant, kv in CASES_B:
        reqs, sp = _requests(cfg, names, Request), sampling(cfg, G_, SamplingParams)
        eng = _engine_b(kind, params, cfg, quant, kv, shard)
        inner = getattr(eng, "_prefill_engine", eng)
        one = _engine_b(kind, params, cfg, quant, kv, None)
        out[name] = dict(tp=eng.generate(reqs, sp), one=one.generate(reqs, sp))
        if kind == "engine":
            out[name]["heads"] = KVCache.zeros(cfg.text, 1, 8, torch.float32, "cpu", shard=inner._text_shard).k.shape[3]
        else:
            out[name]["heads"] = make_pool(cfg, 4, PAGE, SLOTS, 2, device="cpu", shard=inner._text_shard).k.shape[1]
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


EVAL_FLAGS = {"tp4": [], "tp4_paged": ["--use_continuous_batching", "--max_model_len", "1000", "--batch_size", "2",
                                         "--kv_block_size", "128"]}
TRAIN_TP = {"B": 4, "A": 2}


def _cli_worker(rank: int, world: int, workdir: str) -> None:
    """A rank of `cli_runs`: `cli.evaluate` with each of EVAL_FLAGS at tp 4
    from config B's native checkpoint (read in f32; the CLI reads bf16),
    then `cli.train` with each of TRAIN_TP from its HF checkpoint."""
    import json

    import torch.distributed as dist
    from tiny_tokenizer import TinyTokenizer

    from time_r1_tpu_torch.cli import evaluate
    from time_r1_tpu_torch.cli import train as cli
    from time_r1_tpu_torch.models.processor import Qwen25VLProcessor

    torch.set_num_threads(1)
    with open(os.path.join(workdir, "cli.json")) as f:
        job = json.load(f)
    processor = Qwen25VLProcessor(TinyTokenizer(), pad_token_id=job["pad"], eos_token_id=job["eos"])
    Qwen25VLProcessor.from_pretrained = classmethod(lambda cls, path, **kw: processor)
    load = evaluate.load_checkpoint
    evaluate.load_checkpoint = lambda path, dtype=torch.bfloat16, device="cuda": load(path, torch.float32, device)
    out = {tag: evaluate.main(evaluate.get_args(argv), device="cpu") for tag, argv in job["evaluate"].items()}
    for name, argv in job["train"].items():
        tr = cli.main(cli.get_args(argv), device="cpu")
        out[f"train_{name}"] = dict(params=_leaf_list(tr.gathered_params()), steps=tr.global_step, tp=tr.tp,
                                    data=tr.shard.data_rank, first=tr.shard.kv_group is not None)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Two clips, a tvgbench_filter file and training annotations over them,
    config B's native checkpoint and both configs' HF checkpoints; four
    ranks of `_cli_worker`, and one process's `cli.evaluate` records."""
    import json

    from test_torch_video import write_clip
    from tiny_tokenizer import TinyTokenizer
    from time_r1_tpu_torch.cli import evaluate
    from time_r1_tpu_torch.models.processor import Qwen25VLProcessor
    from time_r1_tpu_torch.models.qwen25vl import convert as conv
    from time_r1_tpu_torch.models.qwen25vl.convert import NATIVE_CONFIG, config_to_plain_dict
    from time_r1_tpu_torch.sampler import Engine
    from time_r1_tpu_torch.utils.checkpoint import save_params

    root = tmp_path_factory.mktemp("kv_rep_cli")
    a, b = write_clip(root / "a.mp4", seed=0), write_clip(root / "b.mp4", frames=16, fps=4.0, seed=1)
    ann = [{"video": a, "duration": 3.0, "timestamp": [0.5, 1.5], "sentence": "a door opens", "qid": "tvg_0",
            "video_start": 0.0, "video_end": 2.0, "pred": None},
           {"video": b, "duration": 4.0, "timestamp": [1.0, 3.0], "sentence": "a man sits", "qid": "tvg_1",
            "pred": None}]
    (root / "ann.json").write_text(json.dumps(ann))
    train = [{"video": a, "duration": 3.0, "timestamp": [0.5, 2.0], "sentence": "A person sits down."},
             {"video": b, "duration": 4.0, "timestamp": [1.0, 3.0], "sentence": "the door opens"}]
    (root / "train.json").write_text(json.dumps(train))
    cfg_b, params_b = port_cfg("B"), whole_params("B")
    ckpt = root / "ckpt"
    save_params(str(ckpt), params_b)
    (ckpt / NATIVE_CONFIG).write_text(json.dumps(config_to_plain_dict(cfg_b)))
    pixels = ["--total_pixels", str(8 * 28 * 28), "--min_pixels", str(4 * 28 * 28)]

    def eval_argv(out, *extra):
        return ["--model_base", str(ckpt), "--datasets", "tvgbench_filter", "--split", str(root / "ann.json"),
                "--output_dir", str(out), "--use_r1_thinking_prompt", "--max_new_tokens", "6", "--num_workers", "0",
                *pixels, *extra]

    def train_argv(name):
        hf = root / f"hf_{name}"
        cfg = port_cfg(name)
        conv.save_hf_checkpoint(str(hf), whole_params(name), cfg)
        # the tiny config's pad id 0 reads back as HF's 151643 (out of its vocabulary): give it one in range
        (hf / "config.json").write_text(json.dumps({**conv.config_to_hf_dict(cfg), "pad_token_id": 2}))
        return ["--model_name_or_path", str(hf), "--output_dir", str(root / f"train_{name}"), "--train_data_path",
                str(root / "train.json"), "--reward_funcs", "iou", "format", "--num_generations", "2",
                "--max_completion_length", "4", "--num_train_epochs", "1", "--learning_rate", "1e-3",
                "--save_steps", "1000", "--report_to", "none", "--total_pixels", str(8 * 28 * 28),
                "--video_min_pixels", str(4 * 28 * 28), "--tensor_parallel_size", str(TRAIN_TP[name])]

    job = dict(pad=cfg_b.pad_token_id, eos=cfg_b.eos_token_id,
               evaluate={tag: eval_argv(root / tag, "--tensor_parallel_size", "4", *flags)
                         for tag, flags in EVAL_FLAGS.items()},
               train={name: train_argv(name) for name in TRAIN_TP})
    (root / "cli.json").write_text(json.dumps(job))
    processor = Qwen25VLProcessor(TinyTokenizer(), pad_token_id=cfg_b.pad_token_id, eos_token_id=cfg_b.eos_token_id)
    one = {tag: evaluate.main(evaluate.get_args(eval_argv(root / f"one_{tag}", *flags)),
                              Engine(params_b, cfg_b, dtype=torch.float32, device="cpu"), processor, device="cpu")
           for tag, flags in EVAL_FLAGS.items()}
    return dict(one=one, root=root, ranks=spawn_ranks("test_torch_kv_replication", "_cli_worker", 4, root))


@pytest.mark.parametrize("tag", list(EVAL_FLAGS))
def test_evaluate_at_tp4_equals_one_process(cli_runs, tag):
    import json

    def records(path):
        with open(path) as f:
            return [json.loads(line) for line in f]

    got, want = records(cli_runs["ranks"][0][tag]), records(cli_runs["one"][tag])
    assert [r["qid"] for r in want] == ["tvg_0", "tvg_1"]
    assert got == want


@pytest.mark.parametrize("name", list(TRAIN_TP))
def test_train_cli_past_the_kv_heads(cli_runs, name):
    runs = [r[f"train_{name}"] for r in cli_runs["ranks"]]
    assert all(r["tp"] == TRAIN_TP[name] and r["steps"] > 0 and r["first"] for r in runs)
    for r in runs:  # every rank gathers the same whole tree
        for x, y in zip(r["params"], runs[0]["params"]):
            assert torch.equal(x, y)
    from time_r1_tpu_torch.models.qwen25vl import convert as conv
    from time_r1_tpu_torch.rl.grpo import _leaves

    saved, _ = conv.load_checkpoint(str(cli_runs["root"] / f"train_{name}"), device="cpu")  # written once, whole
    for x, y in zip(_leaves(saved), runs[0]["params"]):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def ranks_a(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("kv_rep_a")
    torch.save(dict(params=whole_params("A")), os.path.join(workdir, "payload.pt"))
    return spawn_ranks("test_torch_kv_replication", "_worker_a", 4, workdir)


@pytest.fixture(scope="module")
def ranks_b(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("kv_rep_b")
    torch.save(dict(params=whole_params("B")), os.path.join(workdir, "payload.pt"))
    return spawn_ranks("test_torch_kv_replication", "_worker_b", 4, workdir)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's loss, gradients and updated tree for config A over
    `shard_params` on a 2×2 mesh of virtual devices, over the union of the
    two data ranks' groups, as the port's leaves."""
    import jax
    import jax.numpy as jnp
    import optax

    from test_torch_bridge import numpy_tree, port_params
    from time_r1_tpu.parallel import make_mesh, shard_params
    from time_r1_tpu.rl import GRPOHyperParams, build_grpo_split_batch, make_train_step
    from time_r1_tpu.rl.grpo import grpo_loss
    from time_r1_tpu_torch.rl.grpo import _leaves

    jcfg, cfg = jax_cfg("A"), port_cfg("A")
    mesh = make_mesh(model_parallel=2, devices=jax.devices()[:4])
    params = shard_params(jax_tree("A"), mesh)
    batch = build_grpo_split_batch(jcfg, [_video_group(d, cfg) for d in range(2)], dtype=jnp.float32)
    hp = GRPOHyperParams(num_generations=G, beta=0.0, fix_vit=False)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3, eps=1e-4))
    with jax.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(lambda p: grpo_loss(p, jcfg, hp, batch)[0]))(params)
        new, _, step_loss, metrics = jax.jit(make_train_step(jcfg, hp, opt))(params, opt.init(params), batch)
        jax.block_until_ready(new)

    def leaves(tree):
        return _leaves(port_params(numpy_tree(tree), cfg))

    return dict(loss=float(loss), grads=leaves(grads), step_loss=float(step_loss),
                metrics={k: float(v) for k, v in metrics.items()}, params=leaves(new))


@pytest.fixture(scope="module")
def jax_engines():
    """JAX's engines over `shard_params` on a 1×4 mesh, config B."""
    import jax
    import jax.numpy as jnp

    from time_r1_tpu.parallel import make_mesh, shard_params
    from time_r1_tpu.sampler import Engine, Request, SamplingParams
    from time_r1_tpu.sampler.continuous import ContinuousEngine
    from time_r1_tpu.sampler.paged import PagedEngine

    jcfg = jax_cfg("B")
    sharded = shard_params(jax_tree("B"), make_mesh(model_parallel=4, devices=jax.devices()[:4]))
    cont = dict(max_slots=SLOTS, max_len=MAX_LEN, dtype=jnp.float32)
    out = {}
    for name, kind, names, G_, quant, kv in CASES_B:
        if kind == "engine":
            eng = Engine(sharded, jcfg, dtype=jnp.float32, quantization=quant, kv_cache_quant=kv)
        elif kind == "paged":
            eng = PagedEngine(sharded, jcfg, page_size=PAGE, **cont)
        elif kind == "continuous":
            eng = ContinuousEngine(sharded, jcfg, **cont)
        else:
            tree = Engine(sharded, jcfg, dtype=jnp.float32, quantization=quant, kv_cache_quant=kv).params
            eng = PagedEngine(tree, jcfg, page_size=PAGE, kv_cache_quant=kv, **cont)
        out[name] = eng.generate(_requests(jcfg, names, Request), sampling(jcfg, G_, SamplingParams))
    return out


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def test_step_loss_and_gradients_match_jax_on_2x2(ranks_a, jax_step):
    for r in ranks_a:
        assert r["grad_loss"] == ranks_a[0]["grad_loss"]
        assert abs(r["grad_loss"] - jax_step["loss"]) <= GRAD_TOL * abs(jax_step["loss"])
        assert len(r["grads"]) == len(jax_step["grads"])
        for i, (got, want) in enumerate(zip(r["grads"], jax_step["grads"])):
            assert got.shape == want.shape, i
            assert _rel(got, want) <= GRAD_TOL, (i, _rel(got, want))


def test_updated_tree_matches_jax_on_2x2(ranks_a, jax_step):
    r0 = ranks_a[0]["step"]
    assert abs(r0["loss"] - jax_step["step_loss"]) <= GRAD_TOL * abs(jax_step["step_loss"])
    for k, v in jax_step["metrics"].items():
        assert r0["metrics"][k] == pytest.approx(v, rel=2e-4, abs=2e-5), k
    for r in ranks_a:
        assert r["step"]["loss"] == r0["loss"] and r["step"]["metrics"] == r0["metrics"]
        for a, b, c in zip(r["step"]["params"], r0["params"], jax_step["params"]):
            assert torch.equal(a, b)
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0, atol=2e-6)


def test_kv_replicas_stay_bit_equal(ranks_a):
    cfg = port_cfg("A")
    by = {r["coords"]: r for r in ranks_a}
    for d in (0, 1):
        a, b = by[(d, 0)], by[(d, 1)]
        assert a["kv_rows"] == b["kv_rows"] == cfg.text.head_dim  # the whole kv head on both model ranks
        for la, lb in zip(a["step"]["kv"], b["step"]["kv"]):
            for k in KV:
                assert torch.equal(la[k], lb[k]), (d, k)
    assert not torch.equal(by[(0, 0)]["step"]["kv"][0]["k_w"], by[(1, 0)]["step"]["kv"][0]["k_w"])  # FSDP halves


def test_gather_and_norm_count_each_replica_once(ranks_a):
    from time_r1_tpu_torch.rl.grpo import _leaves

    whole = _leaves(whole_params("A"))
    want = sum(float(x.double().pow(2).sum()) for x in whole)
    for r in ranks_a:
        assert r["sq_sum"] == pytest.approx(want, rel=1e-6)
        for a, b in zip(r["gathered"], whole):
            assert torch.equal(a, b)


def test_save_and_resume_round_trip(ranks_a):
    for r in ranks_a:
        res = r["resume"]
        assert res["steps"] == (2, 2)
        for a, b in zip(res["whole"], res["resumed"]):
            assert torch.equal(a, b)
        assert max(float((a - b).abs().max()) for a, b in zip(res["whole"], res["first"])) > 0
        for a, b in zip(res["whole"], ranks_a[0]["resume"]["whole"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", [c[0] for c in CASES_B])
def test_engines_at_tp4_match_jax(ranks_b, jax_engines, case):
    runs = [r[case] for r in ranks_b]
    for r in runs:
        assert r["tp"] == runs[0]["tp"]  # the ranks hold the same tokens
        assert r["heads"] == 1  # one kv head a rank: 2 kv heads over 4 ranks
    assert runs[0]["tp"] == jax_engines[case]
    assert runs[0]["tp"] == runs[0]["one"]
    assert all(len(row) > 0 for row in runs[0]["tp"])


def _ctx(params, tp: int, m: int, nkv: int):
    from time_r1_tpu_torch.parallel import ShardContext, param_specs

    return ShardContext(None, None, 1, tp, 0, m, param_specs(params, {"data": 1, "model": tp}, kv_heads=nkv), nkv)


@pytest.mark.parametrize("m", [0, 1, 2, 3])
def test_replicated_blocks_and_specs(m):
    """Rank m of 4 over config B's 2 kv heads: q heads [2m, 2m + 2) and the
    whole kv head m // 2, in k/v weights and biases; every other leaf as the
    rule table cuts it; a context built without the kv heads and given them
    later (`with_kv_heads`) holds the same specs."""
    from time_r1_tpu_torch.parallel import ShardContext, param_specs
    from time_r1_tpu_torch.parallel.sharding import shard_leaf

    cfg = port_cfg("B")
    params = whole_params("B")
    hd = cfg.text.head_dim
    ctx = _ctx(params, 4, m, 2)
    later = ShardContext(None, None, 1, 4, 0, m, param_specs(params, {"data": 1, "model": 4})).with_kv_heads(2)
    assert later.specs == ctx.specs
    spec = ctx.specs["text"]["layers"][0]
    assert spec["k_w"].replicas == spec["v_b"].replicas == 2 and spec["q_w"].replicas == 1
    blocks = ctx.shard(params)
    head = slice((m // 2) * hd, (m // 2 + 1) * hd)
    for lp, got in zip(params["text"]["layers"], blocks["text"]["layers"]):
        for k in KV:
            assert torch.equal(got[k], lp[k][head]), k
        assert torch.equal(got["q_w"], lp["q_w"][2 * m * hd:(2 * m + 2) * hd])
        assert torch.equal(got["o_w"], lp["o_w"][:, 2 * m * hd:(2 * m + 2) * hd])
    w = params["text"]["layers"][0]["k_w"]
    assert torch.equal(shard_leaf(w, spec["k_w"], {"data": 1, "model": 4}, {"data": 0, "model": m}), w[head])
    vis = blocks["visual"]["blocks"][0]
    assert vis["gate_w"].shape[0] == cfg.vision.intermediate_size  # 50 does not split over 4: whole
    assert vis["qkv_w"].shape[0] == 3 * cfg.vision.hidden_size // 4


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [0, 3])
def test_serving_leaves_take_the_whole_kv_head(m, bits):
    """The rank's fused qkv leaf (quantized whole, then cut) equals the whole
    quantized leaf's rows of its q heads and of its replicated kv head, with
    their scales; each block in storage of its own."""
    from time_r1_tpu_torch.ops.quant import quantize_layer
    from time_r1_tpu_torch.parallel import serving_params

    cfg = port_cfg("B")
    params = whole_params("B")
    t = cfg.text
    hd, nh, nkv = t.head_dim, t.num_attention_heads, t.num_key_value_heads
    served = serving_params(params, _ctx(params, 4, m, nkv), bits=bits)
    key = "q8" if bits == 8 else "q4"
    for lp, got in zip(params["text"]["layers"], served["text"]["layers"]):
        whole = quantize_layer(lp, bits=bits, fuse=True)
        q_rows = torch.arange(2 * m * hd, (2 * m + 2) * hd)
        kv_rows = torch.arange((m // 2) * hd, (m // 2 + 1) * hd)
        rows = torch.cat([q_rows, nh * hd + kv_rows, (nh + nkv) * hd + kv_rows])
        for k in (key, "s"):
            assert torch.equal(got["qkv"][k], whole["qkv"][k][rows]), k
            assert got["qkv"][k].untyped_storage().nbytes() == got["qkv"][k].numel() * got["qkv"][k].element_size()
        assert torch.equal(got["qkv_b"], whole["qkv_b"][rows])


RULE_CASES = [
    # (q heads, kv heads, vision heads, tp, accepted, (q local, kv local, kv index of rank 1, r))
    (16, 2, 16, 2, True, (8, 1, 1, 1)),  # the 3B at tp 2: whole kv heads
    (16, 2, 16, 4, True, (4, 1, 0, 2)),  # the 3B at tp 4: each kv head on 2 ranks
    (16, 2, 16, 8, True, (2, 1, 0, 4)),  # the 3B at tp 8: on 4 ranks
    (28, 4, 16, 4, True, (7, 1, 1, 1)),  # the 7B at tp 4
    (28, 4, 16, 8, False, None),  # the 7B at tp 8: 28 q heads do not divide by 8
    (4, 2, 2, 4, False, None),  # the tiny config at tp 4: 2 vision heads
    (12, 4, 12, 6, False, None),  # tp neither divides nor is a multiple of the kv heads
    (8, 2, 4, 4, True, (2, 1, 0, 2)),  # config B
]


@pytest.mark.parametrize("nh,nkv,vh,tp,ok,local", RULE_CASES)
def test_the_rule_accepts_and_refuses(nh, nkv, vh, tp, ok, local):
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig
    from time_r1_tpu_torch.parallel.tensor import check_heads, local_heads

    base = Qwen25VLConfig.tiny_test(VOCAB)
    cfg = dataclasses.replace(base, text=dataclasses.replace(base.text, num_attention_heads=nh,
                                                             num_key_value_heads=nkv),
                              vision=dataclasses.replace(base.vision, num_heads=vh))
    if ok:
        check_heads(cfg, tp)
        assert local_heads(cfg.text, tp, 1) == local
    else:
        with pytest.raises(NotImplementedError, match="A13"):
            check_heads(cfg, tp)
