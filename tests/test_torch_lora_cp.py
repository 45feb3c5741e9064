"""LoRA under context parallelism (`use_peft` with `context_parallel_size
2`), by JAX's route: every adapter merges into the base before the loss,
inside autograd (`time_r1_tpu/rl/grpo.py:507-510`; the ring decoder takes no
`lora=`, as JAX's asserts), and the adapters' gradients are summed over the
CP group. Two gloo ranks (`test_torch_ring_attention.spawn_ranks`) on a
(data 2, model 1) mesh, f32, both layouts:

- `make_lora_train_step(cp=...)` on one full-row video batch that both ranks
  hold (zig-zag with fix_vit; contiguous with the ViT's adapters too),
  against JAX's `make_lora_train_step(cp=(mesh, "data", layout))` and
  `jax.value_and_grad` of its loss on 2 virtual devices, at
  `test_torch_sequence_parallel.py`'s tolerances (the loss rtol 3e-5 / atol
  3e-6, each gradient rtol 8e-4 / atol 8e-5), the updated adapters within
  2e-6, bit-equal on both ranks;
- `GRPOTrainer(use_peft=True, context_parallel_size=2)`: two `step_batch`
  calls (one update at accumulation 2) against one process's LoRA trainer on
  full rows: the losses 3e-5, the metrics 3e-4, the adapters 2e-6 after the
  update, bit-equal on both ranks.

This module imports no JAX at its top: the ranks import it to run `_worker`.
"""

import copy
import os

import numpy as np
import pytest
import torch

from test_torch_multiprocess_dp import EXAMPLES, G, _leaf_list, _trainer, _video_group
from test_torch_ring_attention import spawn_ranks

PAD_TO = 512
LAYOUTS = [("zigzag", True), ("contiguous", False)]  # (layout, fix_vit)
LORA = dict(use_peft=True, lora_r=4, lora_alpha=8.0)


def _hp(fix_vit):
    from time_r1_tpu_torch.rl import GRPOHyperParams

    return GRPOHyperParams(num_generations=G, beta=0.0, fix_vit=fix_vit)


def _lcfg():
    from time_r1_tpu_torch.rl.lora import LoRAConfig

    return LoRAConfig(rank=LORA["lora_r"], alpha=LORA["lora_alpha"])


def lora_step(base: dict, adapters: dict, cfg, batch, cp, fix_vit: bool, shard=None) -> dict:
    """One rank's `lora_value_and_grad` and `make_lora_train_step` (AdamW at
    lr 1e-3, eps 1e-4, clip 1) under `cp`, over `base` (this rank's blocks
    under `shard`), each from a copy of `adapters`."""
    from time_r1_tpu_torch.rl.grpo import lora_value_and_grad, make_lora_train_step
    from time_r1_tpu_torch.rl.lora import lora_leaves
    from time_r1_tpu_torch.rl.optim import AdamWMultiSteps

    lora = copy.deepcopy(adapters)
    loss, _, grads = lora_value_and_grad(base, lora, cfg, _hp(fix_vit), _lcfg(), batch, cp=cp, shard=shard)
    lora = copy.deepcopy(adapters)
    opt = AdamWMultiSteps(1e-3, eps=1e-4, max_grad_norm=1.0)
    state = opt.init(lora_leaves(lora))
    step = make_lora_train_step(cfg, _hp(fix_vit), opt, _lcfg(), cp=cp, shard=shard)
    _, _, step_loss, metrics = step(base, lora, state, batch)
    return dict(loss=float(loss), grads=[g.detach().clone() for g in grads], step_loss=float(step_loss),
                metrics={k: float(v) for k, v in metrics.items()}, adapters=_leaf_list(lora))


def _worker(rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig
    from time_r1_tpu_torch.parallel import ContextParallel, make_mesh, maybe_init_distributed
    from time_r1_tpu_torch.rl import build_grpo_batch_groups

    torch.set_num_threads(1)
    maybe_init_distributed("cpu")
    mesh = make_mesh()
    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    cfg = Qwen25VLConfig.tiny_test(payload["vocab"])
    params = payload["params"]
    batch = build_grpo_batch_groups(cfg, [_video_group(0, cfg)], pad_to=PAD_TO, dtype=torch.float32, device="cpu")
    out = {}
    for layout, fix_vit in LAYOUTS:
        cp = ContextParallel(mesh.get_group("data"), layout)
        out[("step", layout)] = lora_step(params, payload["adapters"][fix_vit], cfg, batch, cp, fix_vit)
        tr = _trainer(copy.deepcopy(params), None, cfg, os.path.join(workdir, layout), mesh=mesh,
                      context_parallel_size=2, context_parallel_layout=layout, gradient_accumulation_steps=2,
                      fix_vit=fix_vit, **LORA)
        assert tr.shard is None and tr._cp.size == 2 and not tr.c.shared_prefix_loss
        out[("trainer", layout)] = _steps(tr)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _steps(tr):
    infos = [tr.step_batch([EXAMPLES[0]]) for _ in range(2)]
    return dict(losses=[i["loss"] for i in infos], metrics=tr.pop_metrics(), lora=_leaf_list(tr.lora),
                rolls_out=tr._rolls_out)


def jax_adapters(jp: dict) -> dict:
    """JAX's adapters over the tree jp (`init_lora`, r 4, seed 7, every leaf
    moved by 0.01 so that lora_b is not zero), by fix_vit: without the
    ViT's adapters under fix_vit, as JAX's init filters them."""
    import jax

    from time_r1_tpu.rl.lora import LoRAConfig, init_lora

    lora = jax.tree.map(lambda a: a + 0.01, init_lora(jp, LoRAConfig(rank=LORA["lora_r"], alpha=LORA["lora_alpha"]),
                                                      jax.random.PRNGKey(7)))
    return {fv: {k: v for k, v in lora.items() if not (fv and k.startswith("visual"))} for fv in (True, False)}


def port_adapters(jlora: dict) -> dict:
    from test_torch_bridge import CFG, numpy_tree
    from time_r1_tpu_torch.models.qwen25vl.convert import lora_from_jax

    return {fv: lora_from_jax(numpy_tree(a), CFG, device="cpu") for fv, a in jlora.items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from test_torch_bridge import VOCAB, jax_params, port_params

    jp = jax_params()
    jlora = jax_adapters(jp)
    workdir = tmp_path_factory.mktemp("lora_cp")
    torch.save(dict(vocab=VOCAB, params=port_params(jp), adapters=port_adapters(jlora)),
               os.path.join(workdir, "payload.pt"))
    return jp, jlora, spawn_ranks("test_torch_lora_cp", "_worker", 2, workdir)


@pytest.mark.parametrize("layout,fix_vit", LAYOUTS, ids=[lay for lay, _ in LAYOUTS])
def test_lora_cp_step_matches_jax(setup, layout, fix_vit):
    jp, jlora, results = setup
    check_lora_step_against_jax(jp, jlora[fix_vit], [r[("step", layout)] for r in results], layout, fix_vit, 1)


def check_lora_step_against_jax(jp: dict, ad: dict, runs: list, layout: str, fix_vit: bool, model_parallel: int):
    """The ranks' `lora_step` results (`runs`, one a rank) against JAX's
    `make_lora_train_step(cp=(mesh, "data", layout))` and `value_and_grad`
    of its merged loss, over `shard_params` on a (data 2, model
    `model_parallel`) mesh of virtual devices: the loss and metrics, each
    adapter gradient and the updated adapters, alike on every rank."""
    import jax
    import jax.numpy as jnp
    import optax

    from test_torch_bridge import CFG, JCFG, numpy_tree
    from time_r1_tpu.parallel import make_mesh, shard_params
    from time_r1_tpu.rl import GRPOHyperParams, build_grpo_batch_groups
    from time_r1_tpu.rl.grpo import grpo_loss, make_lora_train_step
    from time_r1_tpu.rl.lora import LoRAConfig, merge_lora
    from time_r1_tpu_torch.models.qwen25vl.convert import lora_from_jax
    from time_r1_tpu_torch.rl.lora import lora_leaves

    mesh = make_mesh(model_parallel=model_parallel, devices=jax.devices()[:2 * model_parallel])
    base = shard_params(jp, mesh)
    batch = build_grpo_batch_groups(JCFG, [_video_group(0, CFG)], pad_to=PAD_TO, dtype=jnp.float32)
    hp = GRPOHyperParams(num_generations=G, beta=0.0, fix_vit=fix_vit)
    lcfg = LoRAConfig(rank=LORA["lora_r"], alpha=LORA["lora_alpha"])
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3, eps=1e-4))
    cp = (mesh, "data", layout)
    with jax.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda a: grpo_loss(merge_lora(base, a, lcfg), JCFG, hp, batch, cp=cp)[0]))(ad)
        new, _, step_loss, metrics = make_lora_train_step(JCFG, hp, opt, lcfg, cp=cp)(base, ad, opt.init(ad), batch)
        jax.block_until_ready(new)

    def leaves(flat):
        return lora_leaves(lora_from_jax(numpy_tree(flat), CFG, device="cpu"))

    before = leaves(ad)
    r0 = runs[0]
    np.testing.assert_allclose(r0["loss"], float(loss), rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(r0["step_loss"], float(step_loss), rtol=3e-5, atol=3e-6)
    for k, v in metrics.items():
        np.testing.assert_allclose(r0["metrics"][k], float(v), rtol=3e-4, atol=3e-5, err_msg=k)
    want_grads = leaves(grads)
    assert len(want_grads) == len(r0["grads"]) == len(before)
    for i, (g, w) in enumerate(zip(r0["grads"], want_grads)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=8e-4, atol=8e-5, err_msg=str(i))
    for r in runs:
        assert r["loss"] == r0["loss"] and r["metrics"] == r0["metrics"]
        for a, b, w in zip(r["adapters"], r0["adapters"], leaves(new)):
            assert torch.equal(a, b)
            np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0, atol=2e-6)
    assert max(float((a - b).abs().max()) for a, b in zip(r0["adapters"], before)) > 0


@pytest.mark.parametrize("layout,fix_vit", LAYOUTS, ids=[lay for lay, _ in LAYOUTS])
def test_lora_cp_trainer_matches_one_process(setup, tmp_path, layout, fix_vit):
    from test_torch_bridge import CFG, port_params

    jp, _, results = setup
    runs = [r[("trainer", layout)] for r in results]
    assert [r["rolls_out"] for r in runs] == [True, False]
    assert runs[0]["losses"] == runs[1]["losses"] and runs[0]["metrics"] == runs[1]["metrics"]
    for a, b in zip(runs[0]["lora"], runs[1]["lora"]):
        assert torch.equal(a, b)
    one = _trainer(port_params(jp), None, CFG, str(tmp_path), shared_prefix_loss=False, gradient_accumulation_steps=2,
                   fix_vit=fix_vit, **LORA)
    want = _steps(one)
    np.testing.assert_allclose(runs[0]["losses"], want["losses"], rtol=3e-5, atol=3e-6)
    assert set(runs[0]["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(runs[0]["metrics"][k], v, rtol=3e-4, atol=3e-5, err_msg=k)
    for a, b in zip(runs[0]["lora"], want["lora"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-6)
