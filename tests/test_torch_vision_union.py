"""Sharded steps where only some data ranks have video: a rank whose batch
has none runs the vision tower on a placeholder video whose features enter
nothing (`rl/grpo.py::align_vision`), so the tower's gathers (and, where it
trains, its reduce-scatters) fire on every rank. JAX unions the videos
instead (`time_r1_tpu/rl/trainer.py::_global_vision`); since a video's
features do not depend on the others', the oracle is JAX's single-device
loss over the concatenated groups.

Two spawns of gloo ranks (`test_torch_ring_attention.spawn_ranks`, each
with its own timeout, so a rank that hangs fails the test): 2 ranks on a
2×1 mesh (FSDP) and 4 ranks on 2×2 (FSDP × TP), data rank 0 with a video
group and data rank 1 with a text-only one. For fix_vit true and false,
beta 0.04 (the reference pass runs too, over the reference's blocks):

- `grpo_value_and_grad(shard=...)` with the reference log-probs of
  `compute_ref_logps(shard=...)`: the loss and every gathered gradient
  within GRAD_TOL of JAX's `grpo_loss` over the union (relative, the
  gradient's norm), the reference log-probs 2e-5;
- one `GRPOTrainer.step_batch` (rank 1's example text-only) against one
  process's over both examples: the loss 2e-5, the metrics 2e-4, the
  gathered weights 2e-6 after the update, as
  tests/test_torch_multiprocess_dp.py.

This module imports no JAX at its top: the ranks import it to run `_worker`.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_multiprocess_dp import EXAMPLES, G, _asym_text_group, _leaf_list, _trainer, _video_group
from test_torch_ring_attention import spawn_ranks

GRAD_TOL = 1e-5  # loss and each gradient: |port - JAX| / |JAX| (the gradient's norm), f32
MESHES = {"2x1": (2, 1), "2x2": (2, 2)}  # (data, model)
FIX_VIT = (True, False)
BETA = 0.04
# data rank 1's example is text-only
UNION_EXAMPLES = [EXAMPLES[0], dict(EXAMPLES[1], text_only=True)]


def _groups(cfg):
    return [_video_group(0, cfg), _asym_text_group(cfg.eos_token_id)]


def union_trainer(params, ref_params, cfg, out_dir, mesh=None, **kw):
    """`_trainer`, whose request for a `text_only` example has no video."""
    from time_r1_tpu_torch.sampler import Request

    tr = _trainer(params, ref_params, cfg, out_dir, mesh=mesh, **kw)
    with_video = tr.prepare_requests

    def prepare(examples):
        return [Request(r.input_ids[:5] + r.input_ids[-3:], None, None, 1.0) if e.get("text_only") else r
                for e, r in zip(examples, with_video(examples))]

    tr.prepare_requests = prepare
    return tr


def _worker(rank: int, world: int, workdir: str) -> None:
    import copy

    import torch.distributed as dist

    from test_torch_cp_tp import _grads_tree
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig
    from time_r1_tpu_torch.parallel import ShardContext, make_mesh, maybe_init_distributed
    from time_r1_tpu_torch.parallel.sharding import gather_params
    from time_r1_tpu_torch.rl import GRPOHyperParams, build_grpo_split_batch
    from time_r1_tpu_torch.rl.grpo import compute_ref_logps, grpo_value_and_grad, trainable_leaves

    torch.set_num_threads(1)
    maybe_init_distributed("cpu")
    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    mesh = make_mesh(payload["tp"])
    cfg = Qwen25VLConfig.tiny_test(payload["vocab"])
    params, ref_params = payload["params"], payload["ref_params"]
    shard = ShardContext.build(mesh, params).with_kv_heads(cfg.text.num_key_value_heads)
    d = mesh.get_local_rank("data")
    out = {"coords": (d, mesh.get_local_rank("model"))}
    batch = build_grpo_split_batch(cfg, [_groups(cfg)[d]], dtype=torch.float32, device="cpu")
    assert (batch.vision is None) == (d == 1)
    for fix_vit in FIX_VIT:
        hp = GRPOHyperParams(num_generations=G, beta=BETA, fix_vit=fix_vit)
        blocks = shard.shard(params)
        ref = compute_ref_logps(shard.shard(ref_params), cfg, hp, batch, shard=shard)
        loss, _, grads = grpo_value_and_grad(blocks, cfg, hp, batch._replace(ref_logps=ref),
                                             group=mesh.get_group("data"), shard=shard)
        whole = trainable_leaves(gather_params(_grads_tree(blocks, grads, fix_vit), shard), fix_vit)
        out[("grads", fix_vit)] = dict(loss=float(loss), grads=[g.clone() for g in whole], ref_logps=ref)
        tr = union_trainer(copy.deepcopy(params), ref_params, cfg, os.path.join(workdir, f"tr{fix_vit}"), mesh=mesh,
                           fix_vit=fix_vit, beta=BETA)
        info = tr.step_batch([UNION_EXAMPLES[d]])
        out[("step", fix_vit)] = dict(loss=info["loss"], metrics=tr.pop_metrics(),
                                      params=_leaf_list(tr.gathered_params()))
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def trees():
    import jax

    from test_torch_bridge import jax_params

    jp = jax_params()
    return jp, {**jp, "text": jax.tree.map(lambda x: x * 0.9, jp["text"])}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, trees):
    from test_torch_bridge import VOCAB, port_params

    jp, jref = trees
    out = {}
    for name, (dp, tp) in MESHES.items():
        workdir = tmp_path_factory.mktemp(f"vision_union_{name}")
        torch.save(dict(vocab=VOCAB, tp=tp, params=port_params(jp), ref_params=port_params(jref)),
                   os.path.join(workdir, "payload.pt"))
        out[name] = spawn_ranks("test_torch_vision_union", "_worker", dp * tp, workdir, timeout=240.0)
    return out


@pytest.fixture(scope="module")
def jax_union(trees):
    """JAX's single-device loss, gradients and reference log-probs over the
    concatenated groups, by fix_vit."""
    import jax
    import jax.numpy as jnp

    from test_torch_bridge import CFG, JCFG, numpy_tree, port_params
    from time_r1_tpu.rl import GRPOHyperParams, build_grpo_split_batch
    from time_r1_tpu.rl.grpo import compute_ref_logps, grpo_loss
    from time_r1_tpu_torch.rl.grpo import trainable_leaves

    jp, jref = trees
    out = {}
    for fix_vit in FIX_VIT:
        hp = GRPOHyperParams(num_generations=G, beta=BETA, fix_vit=fix_vit)
        batch = build_grpo_split_batch(JCFG, _groups(CFG), dtype=jnp.float32)
        batch = batch._replace(ref_logps=compute_ref_logps(jref, JCFG, hp, batch))
        loss, grads = jax.jit(jax.value_and_grad(lambda p: grpo_loss(p, JCFG, hp, batch)[0]))(jp)
        out[fix_vit] = dict(loss=float(loss), grads=trainable_leaves(port_params(numpy_tree(grads), CFG), fix_vit),
                            ref_logps=np.asarray(batch.ref_logps), comp_mask=np.asarray(batch.comp_mask))
    return out


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


CASES = [(m, fv) for m in MESHES for fv in FIX_VIT]
IDS = [f"{m}_{'fix_vit' if fv else 'vit_trained'}" for m, fv in CASES]


@pytest.mark.parametrize("mesh,fix_vit", CASES, ids=IDS)
def test_loss_and_gradients_match_jaxs_union(ranks, jax_union, mesh, fix_vit):
    want = jax_union[fix_vit]
    runs = [r[("grads", fix_vit)] for r in ranks[mesh]]
    for r in runs:
        assert r["loss"] == runs[0]["loss"]
        assert abs(r["loss"] - want["loss"]) <= GRAD_TOL * abs(want["loss"])
        assert len(r["grads"]) == len(want["grads"])
        for i, (got, w) in enumerate(zip(r["grads"], want["grads"])):
            assert _rel(got, w) <= GRAD_TOL, (i, _rel(got, w))
            assert torch.equal(got, runs[0]["grads"][i])
    for r in ranks[mesh]:  # each data rank's reference log-probs are its rows' of the union's
        d = r["coords"][0]
        ref, mask = r[("grads", fix_vit)]["ref_logps"].numpy(), want["comp_mask"][d * G:(d + 1) * G] > 0
        Lc = ref.shape[1]
        np.testing.assert_allclose(ref[mask[:, :Lc]], want["ref_logps"][d * G:(d + 1) * G, :Lc][mask[:, :Lc]],
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mesh,fix_vit", CASES, ids=IDS)
def test_step_batch_matches_one_process_over_both_groups(ranks, trees, tmp_path, mesh, fix_vit):
    from test_torch_bridge import CFG, port_params

    jp, jref = trees
    runs = [r[("step", fix_vit)] for r in ranks[mesh]]
    for r in runs[1:]:
        assert r["loss"] == runs[0]["loss"] and r["metrics"] == runs[0]["metrics"]
        for a, b in zip(r["params"], runs[0]["params"]):
            assert torch.equal(a, b)
    one = union_trainer(port_params(jp), port_params(jref), CFG, str(tmp_path), fix_vit=fix_vit, beta=BETA,
                        per_device_train_batch_size=2)
    info = one.step_batch(UNION_EXAMPLES)
    want = one.pop_metrics()
    r0 = runs[0]
    assert r0["loss"] == pytest.approx(info["loss"], rel=2e-5, abs=2e-6)
    assert set(r0["metrics"]) == set(want)
    for k, v in want.items():
        assert r0["metrics"][k] == pytest.approx(v, rel=2e-4, abs=2e-5), k
    for a, b in zip(r0["params"], _leaf_list(one.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-6)
