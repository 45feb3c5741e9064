"""The port's GRPO loss path against the JAX package on the tiny config (f32,
CPU, so every kernel wrapper runs its plain version): the split-batch
builder's arrays, the group advantages, `grpo_loss` with its metrics and
every parameter gradient (with video, beta ∈ {0, 0.04}, PPO-clip and vanilla
GRPO, fix_vit on and off), the choice of the vision kernels by fix_vit, the
frozen-ViT precompute, and the tied head's f32 accumulator in bf16.

Tolerances are the JAX package's own for its split-loss test
(tests/test_grpo.py): loss 2e-5, metrics 2e-4, gradients 5e-4 — f32 sums in
another order through two decoder layers, the vision merger and the head."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_grpo import _mk_groups
from test_torch_bridge import CFG, JCFG, jax_params, port_params
from time_r1_tpu.ops.quant import tied_head_logits as jax_tied_head_logits
from time_r1_tpu.rl import GRPOHyperParams as JaxHyperParams
from time_r1_tpu.rl import compute_group_advantages as jax_advantages
from time_r1_tpu.rl import grpo_loss as jax_grpo_loss
from time_r1_tpu.rl.grpo import compute_ref_logps as jax_ref_logps
from time_r1_tpu.rl.grpo import precompute_frozen_vision as jax_precompute
from time_r1_tpu.rl.rollout import build_grpo_split_batch as jax_build
from time_r1_tpu_torch.models.qwen25vl import params_to_jax
from time_r1_tpu_torch.ops.quant import head_logits
from time_r1_tpu_torch.rl import GRPOHyperParams, build_grpo_split_batch, compute_group_advantages, grpo_loss
from time_r1_tpu_torch.rl.grpo import (
    compute_ref_logps,
    grpo_value_and_grad,
    precompute_frozen_vision,
    trainable_leaves,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    jp = jax_params()
    return jp, port_params(jp)


def _grad_tree(tp: dict, grads: list, fix_vit: bool) -> dict:
    """The port's gradients (one per trainable leaf) in the JAX layout, zeros
    for the frozen leaves."""
    trainable = {id(t): g for t, g in zip(trainable_leaves(tp, fix_vit), grads)}

    def build(x):
        if isinstance(x, dict):
            return {k: build(v) for k, v in x.items()}
        if isinstance(x, list):
            return [build(v) for v in x]
        return trainable.get(id(x), torch.zeros_like(x))

    return params_to_jax(build(tp), CFG)


def _batches(groups, G):
    jb = jax_build(JCFG, groups, dtype=jnp.float32)
    tb = build_grpo_split_batch(CFG, groups, dtype=torch.float32, device="cpu")
    return jb, tb


@pytest.mark.parametrize("with_video", [False, True])
def test_split_batch_equals_jax(with_video):
    jb, tb = _batches(_mk_groups(with_video, G=3, P=2), 3)
    for field in ("prompt_ids", "prompt_pos", "prompt_mask", "comp_ids", "comp_pos", "comp_mask",
                  "advantages", "feat_offsets"):
        a, b = getattr(jb, field), getattr(tb, field)
        if a is None:
            assert b is None, field
            continue
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=field)
    if with_video:
        for field in ("patches", "perm", "pos_hw", "key_valid", "full_gather", "full_inverse", "reverse"):
            np.testing.assert_array_equal(getattr(tb.vision, field).numpy(),
                                          np.asarray(getattr(jb.vision, field)), err_msg=field)
    else:
        assert tb.vision is None and jb.vision is None


def test_group_advantages_equal_jax():
    rewards = np.random.default_rng(4).uniform(size=16).astype(np.float32)
    np.testing.assert_array_equal(compute_group_advantages(rewards, 8), jax_advantages(rewards, 8))


@pytest.mark.parametrize("beta", [0.0, 0.04])
@pytest.mark.parametrize("use_grpo", [False, True])
def test_grpo_loss_and_grads_match_jax(params, beta, use_grpo):
    _check_loss_and_grads(params, beta, use_grpo, fix_vit=True)


@pytest.mark.parametrize("beta", [0.0, 0.04])
def test_grpo_loss_and_grads_match_jax_unfrozen_vit(params, beta):
    """fix_vit=False: the whole tower trains, so the ViT blocks' and the patch
    embed's gradients are compared too (and are not zero)."""
    _check_loss_and_grads(params, beta, False, fix_vit=False)


def _check_loss_and_grads(params, beta, use_grpo, fix_vit):
    jp, tp = params
    G = 3
    groups = _mk_groups(True, G=G, P=2)
    jhp = JaxHyperParams(num_generations=G, beta=beta, use_grpo=use_grpo, fix_vit=fix_vit)
    hp = GRPOHyperParams(num_generations=G, beta=beta, use_grpo=use_grpo, fix_vit=fix_vit)
    jb, tb = _batches(groups, G)
    if beta:
        # the reference model: the same weights scaled, so the KL is not zero
        jref = jax.tree.map(lambda x: x * 0.9, jp)
        tref = port_params(jref)
        jb = jb._replace(ref_logps=jax_ref_logps(jref, JCFG, jhp, jb))
        tb = tb._replace(ref_logps=compute_ref_logps(tref, CFG, hp, tb))
        np.testing.assert_allclose(tb.ref_logps.numpy(), np.asarray(jb.ref_logps), rtol=2e-5, atol=2e-5)

    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jax_grpo_loss(p, JCFG, jhp, jb), has_aux=True)(jp)
    loss, metrics, grads = grpo_value_and_grad(tp, CFG, hp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5, atol=2e-6)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=2e-4, atol=2e-5, err_msg=k)
    got = _grad_tree(tp, grads, fix_vit=fix_vit)
    for (path, want), (_, g) in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                                     jax.tree_util.tree_flatten_with_path(got)[0]):
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, np.asarray(want), rtol=5e-4, atol=5e-5, err_msg=name)
    assert all(np.abs(x).max() > 0 for x in jax.tree.leaves(got["visual"]["merger"]))  # trainable
    vit = (got["visual"]["patch_embed"]["kernel"], got["visual"]["blocks"]["attn"]["qkv_w"])
    assert all((np.abs(x).max() > 0) != fix_vit for x in vit)  # frozen with fix_vit, trained without


@pytest.mark.parametrize("fix_vit", [True, False])
def test_vision_feats_pick_the_kernels_by_fix_vit(params, monkeypatch, fix_vit):
    """`_vision_feats` reaches the blocks with use_window_kernel=fix_vit, as
    JAX's does: the frozen tower runs K2/K3 (here their plain versions, on CPU
    tensors), the differentiated one never calls them. The reference forward
    runs no graph and takes K2/K3 either way."""
    from time_r1_tpu_torch.models.qwen25vl import vision as vision_mod
    from time_r1_tpu_torch.rl.grpo import _vision_feats

    _, tp = params
    calls = []

    def recorder(fn):
        def entry(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return entry

    for name in ("window_attention_rope", "full_attention_rope"):
        monkeypatch.setattr(vision_mod, name, recorder(getattr(vision_mod, name)))
    _, tb = _batches(_mk_groups(True, G=3, P=2), 3)
    feats = _vision_feats(tp, CFG, tb, fix_vit)
    depth, n_full = len(tp["visual"]["blocks"]), len(CFG.vision.fullatt_block_indexes)
    want = ["window_attention_rope"] * (depth - n_full) + ["full_attention_rope"] * n_full if fix_vit else []
    assert sorted(calls) == sorted(want)
    assert torch.isfinite(feats).all()
    calls.clear()
    compute_ref_logps(tp, CFG, GRPOHyperParams(num_generations=3, fix_vit=fix_vit), tb)
    assert len(calls) == depth


def test_precompute_frozen_vision_matches_jax(params):
    jp, tp = params
    jb, tb = _batches(_mk_groups(True, G=3, P=2), 3)
    want = jax_precompute(jp, JCFG, jb).vision_hidden
    pre = precompute_frozen_vision(tp, CFG, tb)
    assert precompute_frozen_vision(tp, CFG, pre) is pre  # idempotent
    assert not pre.vision_hidden.requires_grad
    np.testing.assert_allclose(pre.vision_hidden.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    hp = GRPOHyperParams(num_generations=3, beta=0.0)
    np.testing.assert_allclose(float(grpo_loss(tp, CFG, hp, pre)[0]), float(grpo_loss(tp, CFG, hp, tb)[0]),
                               rtol=1e-6, atol=1e-7)


def test_unported_loss_options_raise(params):
    _, tp = params
    _, tb = _batches(_mk_groups(False, G=3, P=1), 3)
    with pytest.raises(NotImplementedError, match="A9"):
        grpo_loss(tp, CFG, GRPOHyperParams(num_generations=3, gradient_checkpointing=True), tb)
    with pytest.raises(NotImplementedError, match="A7"):
        grpo_loss(tp, CFG, GRPOHyperParams(num_generations=3), tuple(tb))


def test_bf16_head_logits_keep_the_f32_accumulator():
    """In bf16 the head returns the f32 accumulation of the bf16 products, as
    JAX's `preferred_element_type=jnp.float32` does: the two agree to f32
    summation order (1e-5 of the logits' scale), where rounding the logits to
    bf16 would be off by up to 2^-9 of it."""
    rng = np.random.default_rng(0)
    hidden = rng.normal(size=(2, 3, 256)).astype(np.float32)
    table = (rng.normal(size=(512, 256)) * 0.05).astype(np.float32)
    h16, w16 = torch.from_numpy(hidden).bfloat16(), torch.from_numpy(table).bfloat16()
    got = head_logits(h16, w16)
    assert got.dtype == torch.float32
    want = np.asarray(jax_tied_head_logits(jnp.asarray(h16.float().numpy(), jnp.bfloat16),
                                           jnp.asarray(w16.float().numpy(), jnp.bfloat16)))
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
    rounded = got.bfloat16().float().numpy()
    assert np.abs(rounded - want).max() > 1e-4 * scale  # what the old bf16 head lost


def test_bf16_head_grads_keep_the_f32_cotangent():
    """The head's backward consumes the f32 logits' cotangent at f32 precision
    in both products, as `jax.vjp` of JAX's f32-accumulating head does
    (`dot_general(c: f32, w: bf16, preferred_element_type=f32)`): dh and dw
    within one bf16 ulp of their scale. The cotangent's bf16-representable
    part cancels in pairs (duplicated rows of w and h meet opposite values of
    it), so the products carry only its sub-bf16 detail, which a cotangent
    rounded to bf16 before the products would drop."""
    rng = np.random.default_rng(0)
    S, V, Hd = 4, 96, 64
    h = rng.normal(size=(S, Hd)).astype(np.float32)
    w = (rng.normal(size=(V, Hd)) * 0.5).astype(np.float32)
    h[1::2], w[1::2] = h[0::2], w[0::2]
    h16, w16 = torch.from_numpy(h).bfloat16(), torch.from_numpy(w).bfloat16()
    a = torch.from_numpy(rng.normal(size=(S // 2, V // 2)).astype(np.float32)).bfloat16().float().numpy()
    base = np.zeros((S, V), np.float32)
    base[0::2, 0::2], base[0::2, 1::2], base[1::2, 0::2], base[1::2, 1::2] = a, -a, -a, a
    detail = (np.abs(base) * rng.uniform(0.1, 1.0, size=base.shape) * 2**-10).astype(np.float32)
    g = (base + detail).astype(np.float32)
    assert np.array_equal(torch.from_numpy(g).bfloat16().float().numpy(), base)  # bf16 sees only the pairs

    jh = jnp.asarray(h16.float().numpy(), jnp.bfloat16)[None]
    jw = jnp.asarray(w16.float().numpy(), jnp.bfloat16)
    _, vjp = jax.vjp(jax_tied_head_logits, jh, jw)
    want_dh, want_dw = (np.asarray(x, np.float32) for x in vjp(jnp.asarray(g)[None]))
    th, tw = h16[None].clone().requires_grad_(), w16.clone().requires_grad_()
    dh, dw = torch.autograd.grad(head_logits(th, tw), (th, tw), torch.from_numpy(g)[None])
    assert dh.dtype == dw.dtype == torch.bfloat16
    for name, got, want in (("dh", dh.float().numpy(), want_dh), ("dw", dw.float().numpy(), want_dw)):
        scale = np.abs(want).max()
        assert scale > 0, name
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        assert np.abs(got - want).max() <= ulp, (name, np.abs(got - want).max(), ulp)
