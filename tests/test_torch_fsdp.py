"""FSDP over two gloo ranks (mesh data 2 × model 1,
`test_torch_ring_attention.spawn_ranks`); `tests/test_torch_tensor_parallel.py`
runs the same cases on a mesh of data 1 × model 2 through `run_mesh_cases`.

Each rank holds its blocks of the tiny config's tree (`ShardContext.shard`)
and its own video group:

- `decoder_forward` (the prompt forward filling its cache), the loss chunk
  of `shared_decode_forward` over that prefix, and the vision tower (with
  and without K2/K3's plain versions) equal one process's over the whole
  tree on the same inputs, 1e-5 relative (f32; the sums run in another
  order);
- one `make_train_step(shard=...)` step (`grpo_value_and_grad` plus the clip
  and AdamW), with remat off and "full" and with fix_vit on and off, against
  JAX's `make_train_step` over `shard_params` on a 2-device mesh of the same
  shape (optax's clip + AdamW, f32) over the union of the ranks' groups:
  the loss 1e-4 relative, the metrics 2e-4, grad_norm 2e-4, the gathered
  weights after the update 2e-6 absolute at lr 1e-3 and eps 1e-4 (the
  tolerances of tests/test_torch_multiprocess_dp.py), the ranks' gathered
  weights bit-equal;
- under remat "full" each decoder layer gathers once in the forward and once
  in the backward's rerun (4 a layer over the prompt forward and the
  completion chunk; the vision blocks and the merger once), half that
  without remat, and no gathered weight is alive after the step;
- with offload the rank's host arena holds exactly its blocks' bytes (mu and
  nu of the blocks whose whole leaf JAX would offload), and its update is
  bit-equal to the device-resident state's;
- `comm.broadcast` gives every rank the first data rank's tensor, in place.

This module imports no JAX at its top: the ranks import it to run `_worker`.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_multiprocess_dp import G, _leaf_list, _video_group
from test_torch_ring_attention import spawn_ranks

STEPS = [(True, False), (True, "full"), (False, False), (False, "full")]  # (fix_vit, remat)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)


def _hp(fix_vit, remat):
    from time_r1_tpu_torch.rl import GRPOHyperParams

    return GRPOHyperParams(num_generations=G, beta=0.0, fix_vit=fix_vit, gradient_checkpointing=remat)


def _forwards(cfg, params, shard, rank_seed: int) -> dict:
    """The three forwards over the rank's blocks and over the whole tree."""
    from time_r1_tpu_torch.models.qwen25vl.language import KVCache, decoder_forward, shared_decode_forward
    from time_r1_tpu_torch.models.qwen25vl.model import VisionInputs
    from time_r1_tpu_torch.models.qwen25vl.vision import prepare_vision_inputs, vision_forward
    from time_r1_tpu_torch.ops.attention import NEG_INF

    blocks = shard.shard(params)
    rng = np.random.default_rng(rank_seed)
    P, Lp, R, Lc, H = 2, 8, 2, 4, cfg.text.hidden_size
    emb = torch.from_numpy(rng.normal(size=(P, Lp, H)).astype(np.float32))
    pos = torch.arange(Lp)[None, None].expand(3, P, Lp).contiguous()
    mask = torch.ones(P, Lp, dtype=torch.long)
    mask[0, :2] = 0
    chunk = torch.from_numpy(rng.normal(size=(P * R, Lc, H)).astype(np.float32))
    cpos = (Lp + torch.arange(Lc))[None, None].expand(3, P * R, Lc).contiguous()
    bias = torch.where(mask > 0, 0.0, NEG_INF).float()
    out = {}
    with torch.no_grad():
        for name, tree, sh in (("whole", params, None), ("sharded", blocks, shard)):
            cache = KVCache.zeros(cfg.text, P, Lp, dtype=torch.float32, device="cpu")
            hid, prefix = decoder_forward(tree["text"], cfg.text, emb, pos, attention_mask=mask, cache=cache,
                                          shard=None if sh is None else sh.at("text"))
            hc, _ = shared_decode_forward(tree["text"], cfg.text, chunk, cpos, prefix, None, bias,
                                          shard=None if sh is None else sh.at("text"))
            out[name] = dict(decoder=hid, shared=hc)
        grid = (2, 4, 4)
        prep = prepare_vision_inputs([grid], cfg.vision)
        patches = torch.from_numpy(rng.normal(size=(32, cfg.vision.patch_input_dim)).astype(np.float32))
        vis = VisionInputs.build(prep, patches)
        for kernel in (False, True):
            for name, tree, sh in (("whole", params, None), ("sharded", blocks, shard)):
                out[name][f"vision_kernel_{kernel}"] = vision_forward(
                    tree["visual"], cfg.vision, vis.patches, vis.perm, vis.pos_hw, vis.key_valid, vis.full_gather,
                    vis.full_inverse, vis.reverse, use_window_kernel=kernel,
                    shard=None if sh is None else sh.at("visual"))
    return out


def run_mesh_cases(rank: int, world: int, workdir: str, tp: int) -> None:
    """Every case on a (world / tp, tp) mesh; writes `rank<r>.pt`."""
    import torch.distributed as dist

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig
    from time_r1_tpu_torch.parallel import fsdp, make_mesh, maybe_init_distributed
    from time_r1_tpu_torch.parallel.comm import broadcast
    from time_r1_tpu_torch.parallel.sharding import ShardContext, gather_params
    from time_r1_tpu_torch.rl import build_grpo_split_batch, make_train_step
    from time_r1_tpu_torch.rl.grpo import trainable_leaves
    from time_r1_tpu_torch.rl.optim import AdamWMultiSteps, offloadable

    torch.set_num_threads(1)
    maybe_init_distributed("cpu")
    mesh = make_mesh(tp)
    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    cfg = Qwen25VLConfig.tiny_test(payload["vocab"])
    params = payload["params"]
    shard = ShardContext.build(mesh, params)
    d = mesh.get_local_rank("data")
    group = mesh.get_group("data") if shard.dp > 1 else None
    out = {"forwards": _forwards(cfg, params, shard, 50 + d)}
    # comm.broadcast: the data group's rank 0 holds the value every rank gets, in place
    x = torch.full((3,), float(d + 1))
    broadcast(x, 0, shard.data_group)
    out["broadcast"] = x
    batch = build_grpo_split_batch(cfg, [_video_group(d, cfg)], dtype=torch.float32, device="cpu")
    L, depth = cfg.text.num_hidden_layers, cfg.vision.depth
    for fix_vit, remat in STEPS:
        blocks = shard.shard(params)
        opt = AdamWMultiSteps(1e-3, eps=1e-4, max_grad_norm=1.0)
        state = opt.init(trainable_leaves(blocks, fix_vit))
        step = make_train_step(cfg, _hp(fix_vit, remat), opt, group=group, shard=shard)
        fsdp.layer_gathers = 0
        _, _, loss, metrics = step(blocks, state, batch)
        gathers = fsdp.layer_gathers
        live = fsdp.live_gathered()
        out[("step", fix_vit, remat)] = dict(
            loss=float(loss), metrics={k: float(v) for k, v in metrics.items()}, gathers=gathers, live=live,
            want_gathers=(4 if remat else 2) * L + depth + 1, params=_leaf_list(gather_params(blocks, shard)))

    # offload: the arena holds the rank's blocks of the leaves JAX offloads
    whole = trainable_leaves(params, True)
    blocks = [shard.shard(params), shard.shard(params)]
    states, opts = [], []
    for offload in (False, True):
        opt = AdamWMultiSteps(1e-3, eps=1e-4, max_grad_norm=1.0)
        leaves = trainable_leaves(blocks[offload], True)
        states.append(opt.init(leaves, offload=offload, numels=[p.numel() for p in whole]))
        opts.append(opt)
        make_train_step(cfg, _hp(True, False), opt, group=group, shard=shard)(blocks[offload], states[-1], batch)
    leaves = trainable_leaves(blocks[1], True)
    want = 2 * sum(b.numel() * b.element_size() for b, w in zip(leaves, whole) if offloadable(w))
    out["offload"] = dict(host_bytes=states[1].host_bytes, want=want,
                          whole=2 * sum(w.numel() * w.element_size() for w in whole if offloadable(w)),
                          equal=all(torch.equal(a, b) for a, b in zip(trainable_leaves(blocks[0], True), leaves)))
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _worker(rank: int, world: int, workdir: str) -> None:
    run_mesh_cases(rank, world, workdir, tp=1)


def spawn_mesh(module: str, workdir) -> list:
    """The tiny tree to a payload file, then 2 ranks of `module._worker`."""
    from test_torch_bridge import VOCAB, jax_params, port_params

    torch.save(dict(vocab=VOCAB, params=port_params(jax_params())), os.path.join(workdir, "payload.pt"))
    return spawn_ranks(module, "_worker", 2, workdir)


def jax_reference(dp: int, tp: int, fix_vit: bool) -> tuple:
    """JAX's make_train_step (optax clip + AdamW) over `shard_params` on a
    (dp, tp) mesh of virtual devices, over the union of the data ranks'
    groups: (loss, metrics, the updated tree as the port's leaves)."""
    import jax
    import jax.numpy as jnp
    import optax

    from test_torch_bridge import CFG, JCFG, jax_params, numpy_tree, port_params
    from time_r1_tpu.parallel import make_mesh, shard_params
    from time_r1_tpu.rl import GRPOHyperParams, build_grpo_split_batch, make_train_step
    from time_r1_tpu_torch.rl.grpo import _leaves

    mesh = make_mesh(model_parallel=tp, devices=jax.devices()[: dp * tp])
    params = shard_params(numpy_tree(jax_params()), mesh)
    batch = build_grpo_split_batch(JCFG, [_video_group(d, CFG) for d in range(dp)], dtype=jnp.float32)
    hp = GRPOHyperParams(num_generations=G, beta=0.0, fix_vit=fix_vit)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3, eps=1e-4))
    with jax.set_mesh(mesh):
        new, _, loss, metrics = jax.jit(make_train_step(JCFG, hp, opt))(params, opt.init(params), batch)
        jax.block_until_ready(loss)
    return float(loss), {k: float(v) for k, v in metrics.items()}, _leaves(port_params(numpy_tree(new)))


def check_step(results, dp: int, tp: int, fix_vit: bool, remat, refs: dict) -> None:
    if fix_vit not in refs:
        refs[fix_vit] = jax_reference(dp, tp, fix_vit)
    loss, metrics, leaves = refs[fix_vit]
    r0, r1 = (r[("step", fix_vit, remat)] for r in results)
    assert r0["loss"] == r1["loss"] and r0["metrics"] == r1["metrics"]
    assert r0["loss"] == pytest.approx(loss, rel=1e-4)
    for k, v in metrics.items():
        tol = dict(rel=2e-4) if k == "grad_norm" else dict(rel=2e-4, abs=2e-5)
        assert r0["metrics"][k] == pytest.approx(v, **tol), k
    for a, b, c in zip(r0["params"], r1["params"], leaves):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0, atol=2e-6)


def check_forwards(results, name: str) -> None:
    for r in results:
        got, want = r["forwards"]["sharded"][name], r["forwards"]["whole"][name]
        assert got.shape == want.shape and torch.isfinite(got).all()
        torch.testing.assert_close(got, want, **FWD_TOL)


def check_gathers(results) -> None:
    for r in results:
        for fix_vit, remat in STEPS:
            st = r[("step", fix_vit, remat)]
            assert st["gathers"] == st["want_gathers"], (fix_vit, remat)
            assert st["live"] == 0


def check_broadcast(results) -> None:
    for r in results:
        assert torch.equal(r["broadcast"], torch.ones(3))


def check_offload(results) -> None:
    for r in results:
        o = r["offload"]
        assert o["host_bytes"] == o["want"] > 0 and o["want"] < o["whole"]
        assert o["equal"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return spawn_mesh("test_torch_fsdp", tmp_path_factory.mktemp("fsdp"))


@pytest.fixture(scope="module")
def refs():
    return {}


@pytest.mark.parametrize("name", ["decoder", "shared", "vision_kernel_False", "vision_kernel_True"])
def test_forwards_match_one_process(results, name):
    check_forwards(results, name)


@pytest.mark.parametrize("fix_vit,remat", STEPS, ids=[f"fix_vit_{f}-remat_{r}" for f, r in STEPS])
def test_step_matches_jax_on_a_mesh(results, refs, fix_vit, remat):
    check_step(results, 2, 1, fix_vit, remat, refs)


def test_remat_gathers_each_layer_twice_and_frees(results):
    check_gathers(results)


def test_offload_arena_holds_the_blocks(results):
    check_offload(results)


def test_broadcast_from_the_first_data_rank(results):
    check_broadcast(results)
