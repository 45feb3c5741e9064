"""Context parallelism inside a tensor-parallel mesh: four gloo ranks
(`test_torch_ring_attention.spawn_ranks`) on a 2×2 mesh, the ring over
"data" (CP 2) at each model coordinate and Megatron-style TP over "model"
(TP 2), the parameters FSDP-sharded over "data" as the trainer keeps them.
Each ring step carries the rank's TP-local q and kv heads.

- `grpo_value_and_grad(cp=..., shard=...)` on one full-row video batch that
  every rank holds, in both layouts (zig-zag with the reference log-probs of
  the ring forward, beta 0.04 and remat; contiguous with the ViT trained),
  f32, against JAX's `grpo_loss(cp=(mesh, "data", layout))` over
  `shard_params` on a 2×2 mesh of virtual devices: the loss at rtol 3e-5 /
  atol 3e-6, the metrics 3e-4, every gradient at rtol 8e-4 / atol 8e-5
  (`test_torch_sequence_parallel.py`'s tolerances); the reference log-probs
  against JAX's single-device `compute_ref_logps` at 2e-5 on the real
  tokens.
- `lora_value_and_grad` and `make_lora_train_step(cp=..., shard=...)` in
  both layouts (zig-zag with fix_vit; contiguous with the ViT's adapters
  too: every adapter cut to the rank's blocks and merged before the loss),
  f32, against JAX's `make_lora_train_step(cp=(mesh, "data", layout))` and
  `value_and_grad` of its merged loss over `shard_params` on the 2×2 mesh of
  virtual devices, at the same tolerances, the updated adapters within 2e-6
  and bit-equal on every rank (`test_torch_lora_cp.check_lora_step_against_jax`).
- `GRPOTrainer(context_parallel_size=2)` on the 2×2 mesh, zig-zag: two
  `step_batch` calls (one update at accumulation 2) against one process's
  full-row trainer (the loss 2e-5, the metrics 2e-4, the weights 2e-6 after
  the update, as `test_torch_context_parallel_trainer.py`), every rank's
  gathered weights bit-equal; the same for a LoRA trainer (every adapter
  merged into the rank's base blocks before the loss, as JAX merges under
  cp), against one process's LoRA trainer on full rows, the adapters
  bit-equal on every rank.
- `cli.train --context_parallel_size 2 --tensor_parallel_size 2` over the
  four ranks from an HF checkpoint over clips: the ranks' weights equal each
  other and the final checkpoint.

This module imports no JAX at its top: the ranks import it to run their
workers.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from test_torch_lora_cp import check_lora_step_against_jax, jax_adapters, lora_step, port_adapters
from test_torch_multiprocess_dp import EXAMPLES, G, _leaf_list, _trainer, _video_group
from test_torch_ring_attention import spawn_ranks

PAD_TO = 512  # the full rows' length: a multiple of both layouts' (2·2·128 zig-zag, 2·128 contiguous)
# (layout, beta, remat, fix_vit)
CASES = [("zigzag", 0.04, "full", True), ("contiguous", 0.0, False, False)]
LORA = dict(use_peft=True, lora_r=4, lora_alpha=8.0)


def _hp(beta, remat, fix_vit):
    from time_r1_tpu_torch.rl import GRPOHyperParams

    return GRPOHyperParams(num_generations=G, beta=beta, fix_vit=fix_vit, gradient_checkpointing=remat)


def _groups(cfg):
    return [_video_group(0, cfg)]


def _steps(tr):
    infos = [tr.step_batch([EXAMPLES[0]]) for _ in range(2)]
    return dict(losses=[i["loss"] for i in infos], metrics=tr.pop_metrics(), params=_leaf_list(tr.gathered_params()),
                lora=None if tr.lora is None else _leaf_list(tr.lora))


def _worker(rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist
    from tiny_tokenizer import TinyTokenizer

    from time_r1_tpu_torch.cli import train as cli
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig
    from time_r1_tpu_torch.parallel import ContextParallel, ShardContext, make_mesh, maybe_init_distributed
    from time_r1_tpu_torch.parallel.sharding import gather_params
    from time_r1_tpu_torch.rl import build_grpo_batch_groups
    from time_r1_tpu_torch.rl.grpo import compute_ref_logps, grpo_value_and_grad, trainable_leaves

    torch.set_num_threads(1)
    maybe_init_distributed("cpu")
    mesh = make_mesh(2)
    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    cfg = Qwen25VLConfig.tiny_test(payload["vocab"])
    params, ref_params = payload["params"], payload["ref_params"]
    shard = ShardContext.build(mesh, params).with_kv_heads(cfg.text.num_key_value_heads)
    out = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}
    for layout, beta, remat, fix_vit in CASES:
        cp = ContextParallel(mesh.get_group("data"), layout)
        hp = _hp(beta, remat, fix_vit)
        batch = build_grpo_batch_groups(cfg, _groups(cfg), pad_to=PAD_TO, dtype=torch.float32, device="cpu")
        out[("lora", layout)] = lora_step(shard.shard(params), payload["adapters"][fix_vit], cfg, batch, cp, fix_vit,
                                          shard)
        blocks = shard.shard(params)
        if beta:
            batch = batch._replace(ref_logps=compute_ref_logps(shard.shard(ref_params), cfg, hp, batch, cp=cp,
                                                               shard=shard))
        loss, metrics, grads = grpo_value_and_grad(blocks, cfg, hp, batch, cp=cp, shard=shard)
        whole = trainable_leaves(gather_params(_grads_tree(blocks, grads, fix_vit), shard), fix_vit)
        out[layout] = dict(loss=float(loss), metrics={k: float(v) for k, v in metrics.items()},
                           grads=[g.clone() for g in whole], ref_logps=batch.ref_logps)

    for name, kw in (("full", {}), ("lora", LORA)):
        tr = _trainer(copy.deepcopy(params), ref_params if not kw else None, cfg, os.path.join(workdir, name),
                      mesh=mesh, context_parallel_size=2, context_parallel_layout="zigzag",
                      gradient_accumulation_steps=2, **kw)
        assert not tr.c.shared_prefix_loss and tr._cp.size == 2 and tr.tp == 2
        out[name] = dict(_steps(tr), rolls_out=tr._rolls_out)

    processor = cli.Qwen25VLProcessor(TinyTokenizer(), pad_token_id=cfg.pad_token_id, eos_token_id=cfg.eos_token_id)
    cli.Qwen25VLProcessor.from_pretrained = classmethod(lambda cls, path, **kw: processor)
    run = cli.main(cli.get_args(payload["cli_argv"]), device="cpu")
    out["cli"] = dict(params=_leaf_list(run.gathered_params()), steps=run.global_step, cp=run._cp.size, tp=run.tp)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _grads_tree(blocks, grads, fix_vit):
    """The trainable leaves' gradients (this rank's blocks) in the shape of
    the tree of blocks, zeros at the frozen leaves, so that the tree can be
    gathered by the params' specs."""
    from test_torch_kv_replication import _tree_like
    from time_r1_tpu_torch.rl.grpo import _leaves, trainable_leaves

    by_leaf = {id(p): g.detach() for p, g in zip(trainable_leaves(blocks, fix_vit), grads)}
    return _tree_like(blocks, [by_leaf.get(id(p), torch.zeros_like(p)) for p in _leaves(blocks)])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax

    from test_torch_bridge import VOCAB, jax_params, port_params
    from test_torch_train_cli import _annotations, _hf_checkpoint
    from test_torch_video import write_clip

    jp = jax_params()
    jref = {**jp, "text": jax.tree.map(lambda x: x * 0.9, jp["text"])}
    workdir = tmp_path_factory.mktemp("cp_tp")
    clips = [write_clip(workdir / "a.mp4", seed=0), write_clip(workdir / "b.mp4", seed=1)]
    argv = ["--model_name_or_path", _hf_checkpoint(workdir / "hf"), "--output_dir", str(workdir / "cli_out"),
            "--train_data_path", _annotations(workdir, clips), "--reward_funcs", "iou", "format",
            "--num_generations", "2", "--max_completion_length", "4", "--num_train_epochs", "1",
            "--learning_rate", "1e-3", "--save_steps", "1000", "--report_to", "none",
            "--total_pixels", str(8 * 28 * 28), "--video_min_pixels", str(4 * 28 * 28),
            "--context_parallel_size", "2", "--tensor_parallel_size", "2"]
    jlora = jax_adapters(jp)
    torch.save(dict(vocab=VOCAB, params=port_params(jp), ref_params=port_params(jref), cli_argv=argv,
                    adapters=port_adapters(jlora)), os.path.join(workdir, "payload.pt"))
    return jp, jref, jlora, workdir, spawn_ranks("test_torch_cp_tp", "_worker", 4, workdir)


@pytest.mark.parametrize("ci", range(len(CASES)), ids=[c[0] for c in CASES])
def test_cp_tp_loss_and_gradients_match_jax(setup, ci):
    import jax
    import jax.numpy as jnp

    from test_torch_bridge import CFG, JCFG, numpy_tree, port_params
    from time_r1_tpu.parallel import make_mesh, shard_params
    from time_r1_tpu.rl import GRPOHyperParams as JaxHyperParams
    from time_r1_tpu.rl import build_grpo_batch_groups as jax_build
    from time_r1_tpu.rl.grpo import compute_ref_logps as jax_ref_logps
    from time_r1_tpu.rl.grpo import grpo_loss as jax_grpo_loss
    from time_r1_tpu_torch.rl.grpo import trainable_leaves

    jp, jref, _, _, results = setup
    layout, beta, remat, fix_vit = CASES[ci]
    runs = [r[layout] for r in results]
    for r in runs[1:]:
        assert r["loss"] == runs[0]["loss"] and r["metrics"] == runs[0]["metrics"]
    got = runs[0]
    jb = jax_build(JCFG, _groups(CFG), dtype=jnp.float32, pad_to=PAD_TO)
    jhp = JaxHyperParams(num_generations=G, beta=beta, fix_vit=fix_vit, gradient_checkpointing=bool(remat))
    if beta:
        jb = jb._replace(ref_logps=jax_ref_logps(jref, JCFG, jhp, jb))
        real = np.asarray(jb.attention_mask)[:, :-1] > 0
        for r in runs:
            np.testing.assert_allclose(r["ref_logps"].numpy()[real], np.asarray(jb.ref_logps)[real], rtol=2e-5,
                                       atol=2e-5)
    mesh = make_mesh(model_parallel=2, devices=jax.devices()[:4])
    with jax.set_mesh(mesh):
        (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jax_grpo_loss(p, JCFG, jhp, jb, cp=(mesh, "data", layout)), has_aux=True))(
                shard_params(jp, mesh))
    np.testing.assert_allclose(got["loss"], float(jloss), rtol=3e-5, atol=3e-6)
    assert set(got["metrics"]) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(got["metrics"][k], float(jmetrics[k]), rtol=3e-4, atol=3e-5, err_msg=k)
    want = trainable_leaves(port_params(numpy_tree(jgrads), CFG), fix_vit)
    assert len(want) == len(got["grads"])
    for i, (g, w) in enumerate(zip(got["grads"], want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=8e-4, atol=8e-5, err_msg=str(i))
    for r in runs[1:]:  # every rank gathers the same whole gradients
        for a, b in zip(r["grads"], got["grads"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("ci", range(len(CASES)), ids=[c[0] for c in CASES])
def test_cp_tp_lora_step_matches_jax(setup, ci):
    jp, _, jlora, _, results = setup
    layout, _, _, fix_vit = CASES[ci]
    check_lora_step_against_jax(jp, jlora[fix_vit], [r[("lora", layout)] for r in results], layout, fix_vit, 2)


@pytest.mark.parametrize("name", ["full", "lora"])
def test_cp_tp_trainer_matches_one_process_full_rows(setup, tmp_path, name):
    from test_torch_bridge import CFG, port_params

    jp, jref, _, _, results = setup
    runs = [r[name] for r in results]
    assert [r["rolls_out"] for r in runs] == [True, False, False, False]
    for r in runs[1:]:
        assert r["losses"] == runs[0]["losses"] and r["metrics"] == runs[0]["metrics"]
        for a, b in zip(r["params"], runs[0]["params"]):
            assert torch.equal(a, b)
        if name == "lora":
            for a, b in zip(r["lora"], runs[0]["lora"]):
                assert torch.equal(a, b)
    kw = LORA if name == "lora" else {}
    one = _trainer(port_params(jp), None if kw else port_params(jref), CFG, str(tmp_path), shared_prefix_loss=False,
                   gradient_accumulation_steps=2, **kw)
    want = _steps(one)
    r0 = runs[0]
    np.testing.assert_allclose(r0["losses"], want["losses"], rtol=2e-5, atol=2e-6)
    assert set(r0["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        assert r0["metrics"][k] == pytest.approx(v, rel=2e-4, abs=2e-5), k
    for a, b in zip(r0["params"], want["params"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-6)
    if name == "lora":
        for a, b in zip(r0["lora"], want["lora"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-6)
    assert max(float((a - b).abs().max()) for a, b in zip(r0["params"], _leaf_list(port_params(jp)))) > 0


def test_cli_trains_with_cp2_tp2(setup):
    from time_r1_tpu_torch.models.qwen25vl import convert as conv
    from time_r1_tpu_torch.rl.grpo import _leaves

    _, _, _, workdir, results = setup
    runs = [r["cli"] for r in results]
    assert all(r["cp"] == 2 and r["tp"] == 2 and r["steps"] == 3 for r in runs)
    for r in runs[1:]:
        for a, b in zip(r["params"], runs[0]["params"]):
            assert torch.equal(a, b)
    out = workdir / "cli_out"
    assert json.loads((out / "trainer_state.json").read_text()) == {"global_step": 3}
    saved, _ = conv.load_checkpoint(str(out), device="cpu")
    for a, b in zip(_leaves(saved), runs[0]["params"]):
        assert torch.equal(a, b)
