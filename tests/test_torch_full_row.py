"""The port's full-row GRPO loss (`GRPOBatch`, `shared_prefix_loss=False`)
against the JAX package on the tiny config (f32, CPU, so every kernel
wrapper runs its plain version):

- `build_grpo_batch_groups` and `build_grpo_batch` give JAX's arrays element
  for element: video groups, text-only groups, a mix of the two (every row
  with a feature offset), `pad_to` and `pad_multiple`;
- `grpo_loss` over full rows and every parameter gradient against
  `jax.value_and_grad` of JAX's, for use_grpo on and off and beta 0 and
  0.04, with the frozen ViT run inline and precomputed, with fix_vit off, and
  under each remat policy; `compute_ref_logps` over full rows;
- the port's split loss against its own full-row loss on the same rollouts
  (as JAX's `tests/test_grpo.py::test_split_batch_loss_matches_full_rows`);
- two `GRPOTrainer.step_batch` calls with `shared_prefix_loss=False` against
  the JAX trainer's;
- LoRA over full rows: the in-layer merged loss and the adapter gradients
  against JAX's.

Tolerances are the JAX package's own for its split-against-full test and
tests/test_torch_grpo.py's: loss 2e-5, metrics 2e-4, gradients rtol 5e-4 /
atol 5e-5 (f32 sums in another order through two decoder layers, the vision
merger and the head); the reference log-probs 2e-5; the trainers as
tests/test_torch_trainer.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_grpo import _mk_groups
from test_torch_bridge import CFG, JCFG, jax_params, port_params
from test_torch_grpo import _grad_tree
from test_torch_lora import JLCFG, LCFG, _jax_loss_and_grads, _port_loss_and_grads, jax_lora, port_lora
from test_torch_trainer import EXAMPLE, Processor, _completions, _config, _request, spread_reward
from time_r1_tpu.rl import GRPOHyperParams as JaxHyperParams
from time_r1_tpu.rl import GRPOTrainer as JaxTrainer
from time_r1_tpu.rl import TrainConfig as JaxTrainConfig
from time_r1_tpu.rl import build_grpo_batch as jax_build_one
from time_r1_tpu.rl import build_grpo_batch_groups as jax_build
from time_r1_tpu.rl import grpo_loss as jax_grpo_loss
from time_r1_tpu.rl.grpo import compute_ref_logps as jax_ref_logps
from time_r1_tpu.sampler import Request as JaxRequest
from time_r1_tpu.utils.rewards import REWARD_FUNCS_REGISTRY as JAX_REWARDS
from time_r1_tpu_torch.models.qwen25vl import params_to_jax
from time_r1_tpu_torch.rl import (
    GRPOBatch,
    GRPOHyperParams,
    GRPOTrainer,
    TrainConfig,
    build_grpo_batch,
    build_grpo_batch_groups,
    build_grpo_split_batch,
    grpo_loss,
)
from time_r1_tpu_torch.rl.grpo import compute_ref_logps, grpo_value_and_grad, precompute_frozen_vision
from time_r1_tpu_torch.sampler import Request
from time_r1_tpu_torch.utils.rewards import REWARD_FUNCS_REGISTRY

torch.set_num_threads(2)

BATCH_FIELDS = ("input_ids", "position_ids", "attention_mask", "completion_mask", "advantages", "feat_offsets")
VISION_FIELDS = ("patches", "perm", "pos_hw", "key_valid", "full_gather", "full_inverse", "reverse")


@pytest.fixture(scope="module")
def params():
    jp = jax_params()
    return jp, port_params(jp)


def _groups(kind: str, G: int = 3):
    if kind == "mixed":  # a video group, then a text-only one
        return _mk_groups(True, G=G, P=1) + _mk_groups(False, G=G, P=2)[1:]
    return _mk_groups(kind == "video", G=G, P=2)


def _batches(groups, **kw):
    jb = jax_build(JCFG, groups, dtype=jnp.float32, **kw)
    tb = build_grpo_batch_groups(CFG, groups, dtype=torch.float32, device="cpu", **kw)
    return jb, tb


def _assert_batches_equal(jb, tb):
    assert isinstance(tb, GRPOBatch)
    for field in BATCH_FIELDS:
        a, b = getattr(jb, field), getattr(tb, field)
        if a is None:
            assert b is None, field
            continue
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=field)
    if jb.vision is None:
        assert tb.vision is None
        return
    for field in VISION_FIELDS:
        np.testing.assert_array_equal(getattr(tb.vision, field).numpy(), np.asarray(getattr(jb.vision, field)),
                                      err_msg=field)


@pytest.mark.parametrize("kind,kw", [
    ("video", {}), ("text", {}), ("mixed", {}), ("video", {"pad_to": 256}), ("mixed", {"pad_multiple": 384}),
], ids=["video", "text", "mixed", "pad_to", "pad_multiple"])
def test_full_batch_equals_jax(kind, kw):
    jb, tb = _batches(_groups(kind), **kw)
    _assert_batches_equal(jb, tb)
    T = tb.input_ids.shape[1]
    assert T == kw.get("pad_to", T) and T % kw.get("pad_multiple", 1) == 0
    if kind == "mixed":
        assert tb.feat_offsets.shape == (6,) and tb.vision is not None  # one offset per row


def test_single_group_builder_equals_jax():
    g = _mk_groups(True, G=3, P=1)[0]
    args = (g["prompt_ids"], g["completions"], g["advantages"], g["patches"], g["grid_thw"], 1.0)
    jb = jax_build_one(JCFG, *args, dtype=jnp.float32)
    tb = build_grpo_batch(CFG, *args, dtype=torch.float32, device="cpu")
    _assert_batches_equal(jb, tb)
    with pytest.raises(ValueError, match="shorter"):
        build_grpo_batch(CFG, *args, pad_to=8, dtype=torch.float32, device="cpu")


def _with_ref(jp, jb, tb, jhp, hp):
    # the reference: the decoder's weights scaled, so that the KL is not zero;
    # the ViT stays the policy's, as it does under fix_vit, where the
    # reference reuses the policy's frozen blocks (`vision_hidden`)
    jref = {**jp, "text": jax.tree.map(lambda x: x * 0.9, jp["text"])}
    jb = jb._replace(ref_logps=jax_ref_logps(jref, JCFG, jhp, jb))
    tb = tb._replace(ref_logps=compute_ref_logps(port_params(jref), CFG, hp, tb))
    return jb, tb


def _check_against_jax(params, groups, beta, use_grpo, fix_vit=True, remat=False, precompute=False):
    jp, tp = params
    G = len(groups[0]["completions"])
    jhp = JaxHyperParams(num_generations=G, beta=beta, use_grpo=use_grpo, fix_vit=fix_vit,
                         gradient_checkpointing=remat)
    hp = GRPOHyperParams(num_generations=G, beta=beta, use_grpo=use_grpo, fix_vit=fix_vit,
                         gradient_checkpointing=remat)
    jb, tb = _batches(groups)
    if precompute:
        tb = precompute_frozen_vision(tp, CFG, tb)
        assert tb.vision_hidden is not None
    if beta:
        jb, tb = _with_ref(jp, jb, tb, jhp, hp)
        np.testing.assert_allclose(tb.ref_logps.numpy(), np.asarray(jb.ref_logps), rtol=2e-5, atol=2e-5)
    (jloss, jmetrics), jgrads = jax.value_and_grad(lambda p: jax_grpo_loss(p, JCFG, jhp, jb), has_aux=True)(jp)
    loss, metrics, grads = grpo_value_and_grad(tp, CFG, hp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5, atol=2e-6)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=2e-4, atol=2e-5, err_msg=k)
    got = _grad_tree(tp, grads, fix_vit=fix_vit)
    for (path, want), (_, g) in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                                     jax.tree_util.tree_flatten_with_path(got)[0]):
        np.testing.assert_allclose(g, np.asarray(want), rtol=5e-4, atol=5e-5, err_msg=jax.tree_util.keystr(path))
    assert all(np.abs(x).max() > 0 for x in jax.tree.leaves(got["text"]["embed_tokens"]))
    return got


@pytest.mark.parametrize("beta", [0.0, 0.04])
@pytest.mark.parametrize("use_grpo", [False, True])
def test_full_row_loss_and_grads_match_jax(params, beta, use_grpo):
    got = _check_against_jax(params, _groups("video"), beta, use_grpo)
    assert all(np.abs(x).max() > 0 for x in jax.tree.leaves(got["visual"]["merger"]))


@pytest.mark.parametrize("beta", [0.0, 0.04])
def test_full_row_loss_with_the_vit_precomputed(params, beta):
    _check_against_jax(params, _groups("video"), beta, False, precompute=True)


def test_full_row_loss_unfrozen_vit_and_mixed_groups(params):
    got = _check_against_jax(params, _groups("mixed"), 0.04, False, fix_vit=False)
    assert np.abs(got["visual"]["blocks"]["attn"]["qkv_w"]).max() > 0  # the whole tower trains


@pytest.mark.parametrize("remat", [True, "full", "dots", "dots_small"])
def test_full_row_remat_policies_match_jax(params, remat):
    _check_against_jax(params, _groups("video"), 0.0, False, remat=remat)


def test_full_row_ref_logps_match_jax(params):
    jp, tp = params
    jhp, hp = JaxHyperParams(num_generations=3), GRPOHyperParams(num_generations=3)
    jb, tb = _batches(_groups("mixed"))
    want = np.asarray(jax_ref_logps(jp, JCFG, jhp, jb))
    got = compute_ref_logps(tp, CFG, hp, tb)
    assert got.shape == (tb.input_ids.shape[0], tb.input_ids.shape[1] - 1) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("with_video", [False, True])
@pytest.mark.parametrize("beta", [0.0, 0.04])
def test_split_loss_equals_full_row_loss(params, with_video, beta):
    _, tp = params
    G = 3
    hp = GRPOHyperParams(num_generations=G, beta=beta, use_grpo=False, fix_vit=with_video)
    groups = _mk_groups(with_video, G=G)
    full = build_grpo_batch_groups(CFG, groups, dtype=torch.float32, device="cpu")
    split = build_grpo_split_batch(CFG, groups, dtype=torch.float32, device="cpu")
    if beta:
        full = full._replace(ref_logps=compute_ref_logps(tp, CFG, hp, full))
        split = split._replace(ref_logps=compute_ref_logps(tp, CFG, hp, split))
    l_f, m_f, g_f = grpo_value_and_grad(tp, CFG, hp, full)
    l_s, m_s, g_s = grpo_value_and_grad(tp, CFG, hp, split)
    np.testing.assert_allclose(float(l_s), float(l_f), rtol=2e-5, atol=2e-6)
    assert set(m_s) == set(m_f)
    for k in m_f:
        np.testing.assert_allclose(float(m_s[k]), float(m_f[k]), rtol=2e-4, atol=2e-5, err_msg=k)
    for i, (a, b) in enumerate(zip(g_s, g_f)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4, atol=5e-5, err_msg=str(i))


@pytest.mark.parametrize("remat", [False, True])
def test_lora_full_row_loss_matches_jax(params, remat):
    """LoRA over full rows: the decoder's adapters merged inside each layer of
    `_hidden_states`, the adapter gradients against JAX's."""
    jp, tp = params
    G = 3
    groups = _groups("video", G)
    jhp = JaxHyperParams(num_generations=G, beta=0.0, fix_vit=True, gradient_checkpointing=remat)
    hp = GRPOHyperParams(num_generations=G, beta=0.0, fix_vit=True, gradient_checkpointing=remat)
    jb, tb = _batches(groups)
    jl = jax_lora(jp)
    jloss, jmetrics, jgrads = _jax_loss_and_grads(jp, jl, jhp, jb)
    loss, metrics, grads = _port_loss_and_grads(tp, port_lora(jl), hp, tb)
    np.testing.assert_allclose(loss, jloss, rtol=2e-5, atol=2e-6)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=2e-4, atol=2e-5, err_msg=k)
    for k in jgrads:
        for n in ("lora_a", "lora_b"):
            np.testing.assert_allclose(grads[k][n], np.asarray(jgrads[k][n]), rtol=5e-4, atol=5e-5,
                                       err_msg=f"{k}/{n}")
            assert np.abs(grads[k][n]).max() > 0, (k, n)
    assert JLCFG.scaling == LCFG.scaling


def test_two_full_row_steps_match_the_jax_trainer(monkeypatch):
    jp = jax_params()
    jref = jax.tree.map(lambda x: x * 0.9, jp)
    ids, patches = _request(np.random.default_rng(3))
    G = 4
    comps = _completions(G)
    jtr = JaxTrainer(jp, JCFG, Processor(), [JAX_REWARDS["iou"], JAX_REWARDS["format"], spread_reward],
                     config=_config(JaxTrainConfig, shared_prefix_loss=False), ref_params=jref, dtype=jnp.float32)
    monkeypatch.setattr(jtr.engine, "generate", lambda reqs, sp: [list(c) for c in comps])
    tp = port_params(jp)
    before = params_to_jax(tp, CFG)
    ttr = GRPOTrainer(tp, CFG, Processor(), [REWARD_FUNCS_REGISTRY["iou"], REWARD_FUNCS_REGISTRY["format"],
                                             spread_reward],
                      config=_config(TrainConfig, shared_prefix_loss=False), ref_params=port_params(jref),
                      dtype=torch.float32, device="cpu")
    monkeypatch.setattr(ttr.engine, "generate", lambda reqs, sp: [list(c) for c in comps])
    built = []
    real_build = build_grpo_batch_groups
    monkeypatch.setattr("time_r1_tpu_torch.rl.trainer.build_grpo_batch_groups",
                        lambda *a, **kw: built.append(1) or real_build(*a, **kw))
    for _ in range(2):
        want = jtr.step_batch([EXAMPLE], [JaxRequest(ids, patches, (2, 4, 4), 1.0)])
        got = ttr.step_batch([EXAMPLE], [Request(ids, patches, (2, 4, 4), 1.0)])
        assert got["reward"] == pytest.approx(want["reward"], rel=1e-6)
        assert got["loss"] == pytest.approx(want["loss"], rel=2e-5, abs=2e-6)
    assert len(built) == 2  # the full-row batch, not the split one
    jm, tm = jtr.pop_metrics(), ttr.pop_metrics()
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=2e-4, atol=2e-5, err_msg=k)
    assert tm["kl"] > 0 and tm["grad_norm"] > 0
    after_j = jax.tree.map(np.asarray, jtr.params)
    after_t = params_to_jax(ttr.params, CFG)
    for (path, a), (_, b), (_, b0) in zip(jax.tree_util.tree_flatten_with_path(after_j)[0],
                                          jax.tree_util.tree_flatten_with_path(after_t)[0],
                                          jax.tree_util.tree_flatten_with_path(before)[0]):
        np.testing.assert_allclose(b - b0, a - b0, atol=2e-6, rtol=0, err_msg=jax.tree_util.keystr(path))
