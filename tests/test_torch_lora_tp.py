"""LoRA over a tensor-parallel mesh (`use_peft` with model > 1): the frozen
base sharded by the rule table, the adapters whole on every rank, each layer
merging the part of them that its blocks need (`parallel/sharding.py::
lora_block`), against the JAX package over `shard_params` on virtual meshes
of the same shapes.

Two settings, each with fix_vit true and false (false: the ViT blocks'
adapters train too), one spawn of gloo ranks each
(`test_torch_ring_attention.spawn_ranks`):

- four ranks on a 2×2 mesh with config A of `test_torch_kv_replication.py`
  (one kv head, replicated at tp 2; a vision MLP of 45, which stays whole
  along "model");
- two ranks on a 1×2 mesh with the plain tiny config.

Each rank takes the loss and the adapter gradients of its data rank's video
group (`rl/grpo.py::lora_value_and_grad`) and one f32 `make_lora_train_step`
step (clip + AdamW at lr 1e-3, eps 1e-4), against JAX's
`make_lora_train_step` and `jax.value_and_grad` of its loss over the union
of the data ranks' groups: the loss and every adapter gradient within
GRAD_TOL of JAX's (relative, the gradient's norm), the updated adapters
within 2e-6 absolute, bit-equal on every rank, and the base untouched. The
adapters of the leaves that stay whole along "model" (config A's vision MLP)
have the gradients of one process's LoRA loss over the union, not tp times
them.

On the 1×2 mesh, through `GRPOTrainer(use_peft=True)`:
- one `step_batch` with int8 rollouts from the real engine: the rolling-out
  rank merges and quantizes one gathered layer at a time, and its tokens
  equal one process's LoRA trainer's in f32; the loss and the adapters agree
  with that trainer's; `gathered_params()` is the base merged with the
  adapters, on every rank;
- a save after one step (optimizer state, `save_only_model` false, the
  adapters once) and a resume into a fresh trainer, whose next step equals
  the uninterrupted run's bit for bit;
- `cli.train --use_peft true --tensor_parallel_size 2` from an HF checkpoint
  over clips: the ranks' merged weights equal each other and the final
  checkpoint.

This module imports no JAX at its top: the ranks import it to run their
workers.
"""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from test_torch_multiprocess_dp import EXAMPLES, G, _leaf_list, _trainer, _video_group
from test_torch_ring_attention import spawn_ranks

VOCAB = 256
GRAD_TOL = 1e-5  # loss and each gradient: |port - JAX| / |JAX| (the gradient's norm), f32
LORA = dict(lora_r=4, lora_alpha=8.0)
SETTINGS = {"A": (2, 2), "plain": (1, 2)}  # config → (data, model)
FIX_VIT = (True, False)


def port_cfg(name: str):
    from test_torch_kv_replication import variant
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig

    cfg = Qwen25VLConfig.tiny_test(VOCAB)
    return variant(cfg, "A") if name == "A" else cfg


def jax_cfg(name: str):
    from test_torch_kv_replication import variant
    from time_r1_tpu.models.qwen25vl import Qwen25VLConfig

    cfg = Qwen25VLConfig.tiny_test(VOCAB)
    return variant(cfg, "A") if name == "A" else cfg


def _hp(fix_vit: bool):
    from time_r1_tpu_torch.rl import GRPOHyperParams

    return GRPOHyperParams(num_generations=G, beta=0.0, fix_vit=fix_vit)


def _lcfg():
    from time_r1_tpu_torch.rl.lora import LoRAConfig

    return LoRAConfig(rank=LORA["lora_r"], alpha=LORA["lora_alpha"])


def jax_setting(name: str):
    """JAX's base tree and, for each fix_vit, its adapters (seeded, B moved off
    0 so the merge is not the identity; fix_vit drops the ViT's)."""
    import jax

    from test_torch_bridge import jax_params
    from time_r1_tpu.rl.lora import LoRAConfig, init_lora

    jp = jax_params(cfg=jax_cfg(name))
    lora = jax.tree.map(lambda a: a + 0.01, init_lora(jp, LoRAConfig(rank=LORA["lora_r"], alpha=LORA["lora_alpha"]),
                                                      jax.random.PRNGKey(7)))
    return jp, {fv: {k: v for k, v in lora.items() if not (fv and k.startswith("visual"))} for fv in FIX_VIT}


def _port_adapters(jlora, cfg):
    from test_torch_bridge import numpy_tree
    from time_r1_tpu_torch.models.qwen25vl.convert import lora_from_jax

    return lora_from_jax(numpy_tree(jlora), cfg, device="cpu")


def _step_cases(params, adapters, cfg, mesh, shard, out) -> None:
    """Loss, gradients and one step for each fix_vit on this rank's blocks."""
    from time_r1_tpu_torch.rl import build_grpo_split_batch
    from time_r1_tpu_torch.rl.grpo import lora_value_and_grad, make_lora_train_step
    from time_r1_tpu_torch.rl.lora import lora_leaves
    from time_r1_tpu_torch.rl.optim import AdamWMultiSteps

    d = mesh.get_local_rank("data")
    group = mesh.get_group("data") if shard.dp > 1 else None
    batch = build_grpo_split_batch(cfg, [_video_group(d, cfg)], dtype=torch.float32, device="cpu")
    for fix_vit in FIX_VIT:
        blocks = shard.shard(params)
        before = _leaf_list(blocks)
        lora = copy.deepcopy(adapters[fix_vit])
        loss, _, grads = lora_value_and_grad(blocks, lora, cfg, _hp(fix_vit), _lcfg(), batch, group=group,
                                             shard=shard)
        lora = copy.deepcopy(adapters[fix_vit])
        opt = AdamWMultiSteps(1e-3, eps=1e-4, max_grad_norm=1.0)
        state = opt.init(lora_leaves(lora))
        step = make_lora_train_step(cfg, _hp(fix_vit), opt, _lcfg(), group=group, shard=shard)
        _, _, step_loss, metrics = step(blocks, lora, state, batch)
        out[("case", fix_vit)] = dict(
            loss=float(loss), grads=[g.detach().clone() for g in grads], step_loss=float(step_loss),
            metrics={k: float(v) for k, v in metrics.items()}, adapters=_leaf_list(lora),
            base_kept=all(torch.equal(a, b) for a, b in zip(_leaf_list(blocks), before)))


def _shard(mesh, params, cfg):
    from time_r1_tpu_torch.parallel import ShardContext, kv_replica_group

    nkv = cfg.text.num_key_value_heads
    return dataclasses.replace(ShardContext.build(mesh, params).with_kv_heads(nkv),
                               kv_group=kv_replica_group(mesh, nkv))


def _worker_a(rank: int, world: int, workdir: str) -> None:
    """Config A on a 2×2 mesh: the step cases."""
    import torch.distributed as dist

    from time_r1_tpu_torch.parallel import make_mesh, maybe_init_distributed

    torch.set_num_threads(1)
    maybe_init_distributed("cpu")
    mesh = make_mesh(2)
    cfg = port_cfg("A")
    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    out = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}
    _step_cases(payload["params"], payload["adapters"], cfg, mesh, _shard(mesh, payload["params"], cfg), out)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def lora_trainer(params, cfg, out_dir, mesh=None, rollouts=None, **kw):
    """A LoRA GRPOTrainer over `_trainer`'s requests; with `rollouts` (a list)
    its real engine rolls out (int8) and each call's completions are kept
    there, else the fixed completions of `_trainer`."""
    tr = _trainer(params, None, cfg, out_dir, mesh=mesh, use_peft=True, **LORA,
                  **({"rollout_quantization": "int8"} if rollouts is not None else {}), **kw)
    if rollouts is not None:
        del tr.engine.generate  # the engine's own generate
        generate = tr.engine.generate

        def recorded(reqs, sp):
            out = generate(reqs, sp)
            rollouts.append(out)
            return out

        tr.engine.generate = recorded
    return tr


def _worker_plain(rank: int, world: int, workdir: str) -> None:
    """The plain tiny config on a 1×2 mesh: the step cases, the trainer's
    int8 step_batch, save and resume, and the CLI."""
    import torch.distributed as dist
    from tiny_tokenizer import TinyTokenizer

    from time_r1_tpu_torch.cli import train as cli
    from time_r1_tpu_torch.parallel import make_mesh, maybe_init_distributed
    from time_r1_tpu_torch.rl.lora import merge_lora

    torch.set_num_threads(1)
    maybe_init_distributed("cpu")
    mesh = make_mesh(2)
    cfg = port_cfg("plain")
    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    params = payload["params"]
    out = {}
    _step_cases(params, payload["adapters"], cfg, mesh, _shard(mesh, params, cfg), out)

    rollouts = []
    tr = lora_trainer(copy.deepcopy(params), cfg, os.path.join(workdir, "int8"), mesh=mesh, rollouts=rollouts)
    info = tr.step_batch([EXAMPLES[0]])
    gathered = tr.gathered_params()
    out["int8"] = dict(loss=info["loss"], rollouts=rollouts, rolls_out=tr._rolls_out, sharded=tr.shard is not None,
                       adapters=_leaf_list(tr.lora), gathered=_leaf_list(gathered),
                       merged=_leaf_list(merge_lora(params, tr.lora, tr.lora_cfg)),
                       ref_is_base=tr.ref_params is tr.params)

    kw = dict(gradient_accumulation_steps=2, save_only_model=False)
    ckpt = os.path.join(workdir, "ckpt")
    whole = lora_trainer(copy.deepcopy(params), cfg, os.path.join(workdir, "whole"), mesh=mesh, **kw)
    whole.step_batch([EXAMPLES[0]])
    whole.save_checkpoint(ckpt)
    whole.step_batch([EXAMPLES[0]])
    resumed = lora_trainer(copy.deepcopy(params), cfg, os.path.join(workdir, "resumed"), mesh=mesh, **kw)
    resumed.load_checkpoint_state(ckpt)
    restored = (resumed.global_step, resumed.opt_state.count, resumed.opt_state.mini_step)
    resumed.step_batch([EXAMPLES[0]])
    out["resume"] = dict(whole=_leaf_list(whole.lora), resumed=_leaf_list(resumed.lora), restored=restored,
                         first=_leaf_list(lora_trainer(params, cfg, "unused").lora),
                         policy=(_leaf_list(whole.gathered_params()), _leaf_list(resumed.gathered_params())),
                         saved=sorted(os.listdir(ckpt)))

    processor = cli.Qwen25VLProcessor(TinyTokenizer(), pad_token_id=cfg.pad_token_id, eos_token_id=cfg.eos_token_id)
    cli.Qwen25VLProcessor.from_pretrained = classmethod(lambda cls, path, **kw: processor)
    run = cli.main(cli.get_args(payload["cli_argv"]), device="cpu")
    out["cli"] = dict(params=_leaf_list(run.gathered_params()), steps=run.global_step, tp=run.tp,
                      lora=run.lora is not None, sharded=run.shard is not None)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def settings():
    return {name: jax_setting(name) for name in SETTINGS}


@pytest.fixture(scope="module")
def ranks_a(tmp_path_factory, settings):
    from test_torch_bridge import numpy_tree, port_params

    jp, jlora = settings["A"]
    cfg = port_cfg("A")
    workdir = tmp_path_factory.mktemp("lora_tp_a")
    torch.save(dict(params=port_params(numpy_tree(jp), cfg),
                    adapters={fv: _port_adapters(jlora[fv], cfg) for fv in FIX_VIT}),
               os.path.join(workdir, "payload.pt"))
    return spawn_ranks("test_torch_lora_tp", "_worker_a", 4, workdir)


@pytest.fixture(scope="module")
def ranks_plain(tmp_path_factory, settings):
    from test_torch_bridge import numpy_tree, port_params
    from test_torch_train_cli import _annotations, _hf_checkpoint
    from test_torch_video import write_clip

    jp, jlora = settings["plain"]
    cfg = port_cfg("plain")
    workdir = tmp_path_factory.mktemp("lora_tp_plain")
    clips = [write_clip(workdir / "a.mp4", seed=0), write_clip(workdir / "b.mp4", seed=1)]
    argv = ["--model_name_or_path", _hf_checkpoint(workdir / "hf"), "--output_dir", str(workdir / "cli_out"),
            "--train_data_path", _annotations(workdir, clips), "--reward_funcs", "iou", "format",
            "--num_generations", "2", "--max_completion_length", "4", "--num_train_epochs", "1",
            "--learning_rate", "1e-3", "--save_steps", "1000", "--report_to", "none",
            "--total_pixels", str(8 * 28 * 28), "--video_min_pixels", str(4 * 28 * 28),
            "--use_peft", "true", "--lora_r", "4", "--lora_alpha", "8", "--tensor_parallel_size", "2"]
    torch.save(dict(params=port_params(numpy_tree(jp), cfg), cli_argv=argv,
                    adapters={fv: _port_adapters(jlora[fv], cfg) for fv in FIX_VIT}),
               os.path.join(workdir, "payload.pt"))
    return workdir, spawn_ranks("test_torch_lora_tp", "_worker_plain", 2, workdir)


def jax_lora_step(name: str, settings, fix_vit: bool) -> dict:
    """JAX's loss, adapter gradients and make_lora_train_step over
    `shard_params` on a virtual mesh of the setting's shape, over the union
    of its data ranks' groups, as the port's adapter leaves."""
    import jax
    import jax.numpy as jnp
    import optax

    from test_torch_bridge import numpy_tree
    from time_r1_tpu.parallel import make_mesh, shard_params
    from time_r1_tpu.rl import GRPOHyperParams, build_grpo_split_batch
    from time_r1_tpu.rl.grpo import grpo_loss, make_lora_train_step
    from time_r1_tpu.rl.lora import LoRAConfig, lora_layers_tree, merge_lora
    from time_r1_tpu_torch.rl.lora import lora_leaves

    jp, jlora = settings[name]
    ad = jlora[fix_vit]
    dp, tp = SETTINGS[name]
    jcfg, cfg = jax_cfg(name), port_cfg(name)
    mesh = make_mesh(model_parallel=tp, devices=jax.devices()[:dp * tp])
    base = shard_params(jp, mesh)
    batch = build_grpo_split_batch(jcfg, [_video_group(d, cfg) for d in range(dp)], dtype=jnp.float32)
    hp = GRPOHyperParams(num_generations=G, beta=0.0, fix_vit=fix_vit)
    lcfg = LoRAConfig(rank=LORA["lora_r"], alpha=LORA["lora_alpha"])
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3, eps=1e-4))

    def loss_fn(a):  # make_lora_train_step's loss
        dec, rest = lora_layers_tree(a)
        p = merge_lora(base, rest, lcfg) if rest else base
        return grpo_loss(p, jcfg, hp, batch, lora=(dec, lcfg.scaling) if dec is not None else None)[0]

    with jax.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(ad)
        new, _, step_loss, metrics = make_lora_train_step(jcfg, hp, opt, lcfg)(base, ad, opt.init(ad), batch)
        jax.block_until_ready(new)

    def leaves(flat):
        return lora_leaves(_port_adapters(numpy_tree(flat), cfg))

    return dict(loss=float(loss), grads=leaves(grads), step_loss=float(step_loss),
                metrics={k: float(v) for k, v in metrics.items()}, adapters=leaves(new))


@pytest.fixture(scope="module")
def jax_steps(settings):
    return {(name, fv): jax_lora_step(name, settings, fv) for name in SETTINGS for fv in FIX_VIT}


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def _ranks(name, ranks_a, ranks_plain):
    return ranks_a if name == "A" else ranks_plain[1]


CASES = [(name, fv) for name in SETTINGS for fv in FIX_VIT]
IDS = [f"{name}_{'fix_vit' if fv else 'vit_trained'}" for name, fv in CASES]


@pytest.mark.parametrize("name,fix_vit", CASES, ids=IDS)
def test_loss_and_adapter_gradients_match_jax(ranks_a, ranks_plain, jax_steps, name, fix_vit):
    want = jax_steps[(name, fix_vit)]
    runs = [r[("case", fix_vit)] for r in _ranks(name, ranks_a, ranks_plain)]
    for r in runs:
        assert r["loss"] == runs[0]["loss"]
        assert abs(r["loss"] - want["loss"]) <= GRAD_TOL * abs(want["loss"])
        assert len(r["grads"]) == len(want["grads"])
        for i, (got, w) in enumerate(zip(r["grads"], want["grads"])):
            assert got.shape == w.shape, i
            assert _rel(got, w) <= GRAD_TOL, (i, _rel(got, w))
            assert torch.equal(got, runs[0]["grads"][i])  # alike on every rank


@pytest.mark.parametrize("name,fix_vit", CASES, ids=IDS)
def test_updated_adapters_match_jax_and_agree_across_ranks(ranks_a, ranks_plain, jax_steps, name, fix_vit):
    want = jax_steps[(name, fix_vit)]
    runs = [r[("case", fix_vit)] for r in _ranks(name, ranks_a, ranks_plain)]
    r0 = runs[0]
    assert abs(r0["step_loss"] - want["step_loss"]) <= GRAD_TOL * abs(want["step_loss"])
    for k, v in want["metrics"].items():
        assert r0["metrics"][k] == pytest.approx(v, rel=2e-4, abs=2e-5), k
    for r in runs:
        assert r["base_kept"]
        assert r["metrics"] == r0["metrics"]
        for a, b, c in zip(r["adapters"], r0["adapters"], want["adapters"]):
            assert torch.equal(a, b)  # bit-equal on every rank
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0, atol=2e-6)
    moved = [float((a - b).abs().max()) for a, b in zip(r0["adapters"], want["adapters"])]
    assert max(moved) <= 2e-6


def _leaf_paths(tree, path: str = "") -> list:
    """The 'a/b/c' path of each leaf, in `lora_leaves` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _leaf_paths(v, f"{path}/{k}" if path else k)]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _leaf_paths(v, f"{path}/{i}")]
    return [path]


def test_whole_leaf_adapters_are_not_summed_over_model(ranks_a, settings):
    """Config A's vision MLP (45 wide) stays whole along "model": its
    adapters' gradients on the 2×2 mesh are one process's over the union
    (a sum over the model group would double them)."""
    from test_torch_bridge import numpy_tree, port_params
    from time_r1_tpu_torch.rl import build_grpo_split_batch
    from time_r1_tpu_torch.rl.grpo import lora_value_and_grad
    from time_r1_tpu_torch.rl.lora import lora_leaves

    cfg = port_cfg("A")
    jp, jlora = settings["A"]
    lora = _port_adapters(jlora[False], cfg)
    batch = build_grpo_split_batch(cfg, [_video_group(d, cfg) for d in range(2)], dtype=torch.float32, device="cpu")
    _, _, grads = lora_value_and_grad(port_params(numpy_tree(jp), cfg), lora, cfg, _hp(False), _lcfg(), batch)
    names = _leaf_paths(lora)
    assert len(names) == len(lora_leaves(lora))
    whole = [i for i, p in enumerate(names)
             if p.startswith("visual/") and p.split("/")[3] in ("gate_w", "up_w", "down_w")]
    assert whole and cfg.vision.intermediate_size % 2
    for r in ranks_a:
        got = r[("case", False)]["grads"]
        for i in whole:
            assert _rel(got[i], grads[i]) <= GRAD_TOL, names[i]


def test_int8_step_batch_matches_one_process(ranks_plain, tmp_path):
    from test_torch_bridge import jax_params, port_params

    cfg = port_cfg("plain")
    runs = [r["int8"] for r in ranks_plain[1]]
    assert [r["rolls_out"] for r in runs] == [True, False] and all(r["sharded"] and r["ref_is_base"] for r in runs)
    assert runs[1]["rollouts"] == []
    rollouts = []
    one = lora_trainer(port_params(jax_params()), cfg, str(tmp_path), rollouts=rollouts)
    info = one.step_batch([EXAMPLES[0]])
    assert runs[0]["rollouts"] == rollouts and any(len(c) > 0 for c in rollouts[0])  # the int8 tokens
    assert runs[0]["loss"] == runs[1]["loss"] == pytest.approx(info["loss"], rel=2e-5, abs=2e-6)
    for r in runs:
        for a, b, c in zip(r["adapters"], runs[0]["adapters"], _leaf_list(one.lora)):
            assert torch.equal(a, b)
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0, atol=2e-6)
        for a, b in zip(r["gathered"], r["merged"]):  # the base merged with the rank's own adapters
            assert torch.equal(a, b)
    for a, b in zip(runs[0]["gathered"], _leaf_list(one._policy_params())):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-6)


def test_lora_save_and_resume_over_tp(ranks_plain):
    from time_r1_tpu_torch.models.qwen25vl.convert import LORA_FILE

    for r in ranks_plain[1]:
        res = r["resume"]
        assert res["restored"] == (1, 0, 1) and LORA_FILE in res["saved"]
        for a, b in zip(res["whole"], res["resumed"]):
            assert torch.equal(a, b)
        for a, b in zip(*res["policy"]):
            assert torch.equal(a, b)
        assert max(float((a - b).abs().max()) for a, b in zip(res["whole"], res["first"])) > 0


def test_cli_trains_lora_at_tp2(ranks_plain):
    from time_r1_tpu_torch.models.qwen25vl import convert as conv
    from time_r1_tpu_torch.rl.grpo import _leaves

    workdir, results = ranks_plain
    c0, c1 = (r["cli"] for r in results)
    assert c0["tp"] == c1["tp"] == 2 and c0["lora"] and c0["sharded"] and c0["steps"] == c1["steps"] == 3
    for a, b in zip(c0["params"], c1["params"]):
        assert torch.equal(a, b)
    out = workdir / "cli_out"
    assert json.loads((out / "trainer_state.json").read_text()) == {"global_step": 3}
    assert (out / conv.LORA_FILE).is_file()
    saved, _ = conv.load_checkpoint(str(out), device="cpu")
    for a, b in zip(_leaves(saved), c0["params"]):
        assert torch.equal(a, b)
