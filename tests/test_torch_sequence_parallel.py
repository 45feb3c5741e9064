"""The port's context parallelism above the ring, against the JAX package on
the CPU (the ranks are gloo processes, `test_torch_ring_attention.spawn_ranks`):

- `sequence_parallel_decoder` over 2 and 4 ranks in both layouts against
  JAX's `sequence_parallel_decoder` on the virtual mesh (2 ranks, contiguous)
  and against JAX's plain `decoder_forward` (the other cases: what JAX's
  tests/test_sequence_parallel.py holds its own to; JAX's shard_map decoder
  compiles for 10-35 s a case on the CPU), on the valid positions, 3e-5;
- its parameter and embedding gradients over 4 ranks (each rank's share
  summed over the ranks) against `jax.grad` of JAX's plain decoder, 2e-4;
- `grpo_value_and_grad(cp=...)` over 2 ranks on full rows with video (the
  vision tower and the merge run whole on each rank) padded to the layout's
  multiple, PPO-clip and GRPO, beta 0 and 0.04 (the reference log-probs from
  `compute_ref_logps(cp=...)`, gathered on every rank) and under remat,
  against JAX's `grpo_loss` and `compute_ref_logps` over the same rows: the
  loss 3e-5, the metrics 3e-4, every gradient 8e-4 (JAX's tolerances for
  its cp loss against its plain one), the reference log-probs 2e-5 at the
  positions of real tokens (a left-pad position attends no key: its value is
  what the merge order makes of that, in JAX's ring as here, and the loss
  masks it).

This module imports no JAX at its top: the ranks import it to run `_worker`.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_ring_attention import spawn_ranks

B, S = 2, 1024  # zig-zag over 4 ranks: 8 half-chunks of 128
SP_CASES = [(2, "contiguous"), (4, "contiguous"), (2, "zigzag"), (4, "zigzag")]
# (name, layout, use_grpo, beta, remat)
GRPO_CASES = [
    ("contiguous_ppo", "contiguous", False, 0.0, False),
    ("zigzag_ppo_kl_remat", "zigzag", False, 0.04, "full"),
    ("zigzag_grpo_kl", "zigzag", True, 0.04, False),
]
G = 3


def _sp_inputs(hidden_size):
    rng = np.random.default_rng(0)
    embeds = rng.normal(size=(B, S, hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None, None, :], (3, B, S)).astype(np.int64)
    mask = np.ones((B, S), np.int64)
    mask[1, S - 64:] = 0  # right padding on one row
    ct = (rng.standard_normal((B, S, hidden_size)) * mask[..., None]).astype(np.float32)
    return embeds, pos, mask, ct


def _worker(rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig
    from time_r1_tpu_torch.parallel import ContextParallel, maybe_init_distributed, sequence_parallel_decoder
    from time_r1_tpu_torch.parallel.comm import all_reduce_sum
    from time_r1_tpu_torch.rl.grpo import GRPOHyperParams, _leaves, compute_ref_logps, grpo_value_and_grad

    torch.set_num_threads(1)
    maybe_init_distributed("cpu")
    groups = {2: dist.new_group([0, 1]), 4: dist.new_group([0, 1, 2, 3])}
    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    cfg = Qwen25VLConfig.tiny_test(payload["vocab"])
    params, ref_params = payload["params"], payload["ref_params"]
    embeds, pos, mask, ct = (torch.from_numpy(a) for a in _sp_inputs(cfg.text.hidden_size))
    out = {}
    for n, layout in SP_CASES:
        if rank < n:
            with torch.no_grad():
                out[("sp", n, layout)] = sequence_parallel_decoder(params["text"], cfg.text, embeds, pos, mask,
                                                                   groups[n], layout=layout)
    leaves = _leaves(params["text"])
    for p in leaves:
        p.requires_grad_(True)
    e = embeds.clone().requires_grad_(True)
    got = sequence_parallel_decoder(params["text"], cfg.text, e, pos, mask, groups[4])
    grads = torch.autograd.grad((got * ct).sum(), leaves + [e], allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves + [e], grads)]
    all_reduce_sum(grads, groups[4])
    out["sp_grads"] = grads
    for p in leaves:
        p.requires_grad_(False)
    if rank < 2:
        for name, layout, use_grpo, beta, remat in GRPO_CASES:
            cp = ContextParallel(groups[2], layout)
            hp = GRPOHyperParams(num_generations=G, beta=beta, use_grpo=use_grpo, fix_vit=True,
                                 gradient_checkpointing=remat)
            batch = payload["batches"][layout]
            if beta:
                batch = batch._replace(ref_logps=compute_ref_logps(ref_params, cfg, hp, batch, cp=cp))
            loss, metrics, grads = grpo_value_and_grad(params, cfg, hp, batch, cp=cp)
            out[name] = dict(loss=loss, metrics=metrics, grads=grads, ref_logps=batch.ref_logps)
    torch.save(out if rank == 0 else {}, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax

    from test_torch_bridge import CFG, VOCAB, jax_params, port_params
    from test_torch_full_row import _groups
    from time_r1_tpu_torch.rl import build_grpo_batch_groups

    jp = jax_params()
    jref = {**jp, "text": jax.tree.map(lambda x: x * 0.9, jp["text"])}
    groups = _groups("video", G=G)
    batches = {layout: build_grpo_batch_groups(CFG, groups, dtype=torch.float32, device="cpu",
                                               pad_multiple=(2 if layout == "zigzag" else 1) * 2 * 128)
               for layout in ("contiguous", "zigzag")}
    workdir = tmp_path_factory.mktemp("sp")
    torch.save(dict(vocab=VOCAB, params=port_params(jp), ref_params=port_params(jref), batches=batches),
               os.path.join(workdir, "payload.pt"))
    results = spawn_ranks("test_torch_sequence_parallel", "_worker", 4, workdir)[0]
    return jp, jref, groups, batches, results


@pytest.mark.parametrize("n,layout", SP_CASES, ids=[f"n{n}_{lay}" for n, lay in SP_CASES])
def test_sp_decoder_matches_jax(setup, n, layout):
    import jax
    import jax.numpy as jnp

    from test_torch_bridge import JCFG
    from time_r1_tpu.models.qwen25vl.language import decoder_forward
    from time_r1_tpu.parallel.ring_attention import sequence_parallel_decoder

    jp, _, _, _, results = setup
    embeds, pos, mask, _ = (jnp.asarray(a) for a in _sp_inputs(JCFG.text.hidden_size))
    if (n, layout) == (2, "contiguous"):
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(n), ("data",))
        want = sequence_parallel_decoder(jp["text"], JCFG.text, embeds, pos, mask, mesh, layout=layout)
    else:
        want, _ = decoder_forward(jp["text"], JCFG.text, embeds, pos, attention_mask=mask)
    valid = np.asarray(mask, bool)
    got = results[("sp", n, layout)].numpy()
    np.testing.assert_allclose(got[valid], np.asarray(want)[valid], rtol=3e-5, atol=3e-5)


def test_sp_decoder_param_grads_match_jax(setup):
    import jax
    import jax.numpy as jnp

    from test_torch_bridge import CFG, JCFG
    from time_r1_tpu.models.qwen25vl.language import decoder_forward
    from time_r1_tpu_torch.models.qwen25vl import params_to_jax

    jp, _, _, _, results = setup
    embeds, pos, mask, ct = (jnp.asarray(a) for a in _sp_inputs(JCFG.text.hidden_size))

    def loss(text, e):
        out, _ = decoder_forward(text, JCFG.text, e, pos, attention_mask=mask)
        return jnp.sum(out * ct)

    g_text, g_e = jax.grad(loss, argnums=(0, 1))(jp["text"], embeds)
    grads = results["sp_grads"]
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(g_e), rtol=2e-4, atol=2e-4, err_msg="embeds")
    # the port's text-leaf order, placed into its tree and bridged to JAX's layout
    from time_r1_tpu_torch.rl.grpo import _leaves

    from test_torch_bridge import port_params

    tp = port_params(jp)
    by_id = {id(t): g for t, g in zip(_leaves(tp["text"]), grads[:-1])}

    def build(x):
        if isinstance(x, dict):
            return {k: build(v) for k, v in x.items()}
        if isinstance(x, list):
            return [build(v) for v in x]
        return by_id.get(id(x), torch.zeros_like(x))

    got = params_to_jax(dict(tp, text=build(tp["text"])), CFG)["text"]
    for (path, want), g in zip(jax.tree_util.tree_flatten_with_path(g_text)[0], jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(want), rtol=2e-4, atol=2e-4,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("ci", range(len(GRPO_CASES)), ids=[c[0] for c in GRPO_CASES])
def test_cp_grpo_loss_matches_jax(setup, ci):
    import jax

    from test_torch_bridge import JCFG, port_params
    from test_torch_grpo import _grad_tree
    from time_r1_tpu.rl import GRPOHyperParams as JaxHyperParams
    from time_r1_tpu.rl import build_grpo_batch_groups as jax_build
    from time_r1_tpu.rl import grpo_loss as jax_grpo_loss
    from time_r1_tpu.rl.grpo import compute_ref_logps as jax_ref_logps

    import jax.numpy as jnp

    jp, jref, groups, batches, results = setup
    name, layout, use_grpo, beta, remat = GRPO_CASES[ci]
    T = batches[layout].input_ids.shape[1]
    jb = jax_build(JCFG, groups, dtype=jnp.float32, pad_to=T)
    jhp = JaxHyperParams(num_generations=G, beta=beta, use_grpo=use_grpo, fix_vit=True)
    got = results[name]
    if beta:
        jb = jb._replace(ref_logps=jax_ref_logps(jref, JCFG, jhp, jb))
        # at the positions of real tokens: a left-pad position attends no key,
        # and its value is whatever the merge order makes of that (the ring's
        # differs from one flash call's in JAX as here; the loss masks it)
        real = np.asarray(jb.attention_mask)[:, :-1] > 0
        np.testing.assert_allclose(got["ref_logps"].numpy()[real], np.asarray(jb.ref_logps)[real], rtol=2e-5,
                                   atol=2e-5)
    (jloss, jmetrics), jgrads = jax.value_and_grad(lambda p: jax_grpo_loss(p, JCFG, jhp, jb), has_aux=True)(jp)
    np.testing.assert_allclose(float(got["loss"]), float(jloss), rtol=3e-5, atol=3e-6)
    assert set(got["metrics"]) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(got["metrics"][k]), float(jmetrics[k]), rtol=3e-4, atol=3e-5, err_msg=k)
    tree = _grad_tree(port_params(jp), got["grads"], fix_vit=True)
    for (path, want), g in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0], jax.tree.leaves(tree)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(want), rtol=8e-4, atol=8e-5,
                                   err_msg=jax.tree_util.keystr(path))
    assert np.abs(np.asarray(tree["visual"]["merger"]["fc1"]["kernel"])).max() > 0  # the replicated merger trains
