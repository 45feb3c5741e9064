"""The port's vision tower against the JAX `vision_forward`, whole and as the
blocks → merger split that the trainer uses (on CPU tensors the K2/K3
wrappers run their plain versions), on padded windows and multi-video
layouts; the differentiable tower (`use_window_kernel=False`, the GRPO loss
with fix_vit off) against JAX's jnp branch, outputs and gradients; plus the
host-side plan and patchify."""

import jax

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_bridge import CFG, JCFG, jax_params, port_params
from time_r1_tpu.models.processor import patchify_video as jax_patchify_video
from time_r1_tpu.models.qwen25vl import prepare_vision_inputs as jax_prepare
from time_r1_tpu.models.qwen25vl.vision import vision_forward as jax_vision_forward
from time_r1_tpu_torch.models.processor import patchify_video
from time_r1_tpu_torch.models.qwen25vl import VisionInputs, params_to_jax, prepare_vision_inputs, vision_forward
from time_r1_tpu_torch.models.qwen25vl.vision import vision_blocks_forward, vision_merge_forward
from time_r1_tpu_torch.ops.vision_attention import full_attention_rope, window_attention_rope

torch.set_num_threads(2)

GRIDS = [[(2, 4, 4)], [(2, 4, 4), (2, 6, 2)]]


@pytest.fixture(scope="module")
def params():
    jp = jax_params()
    return jp, port_params(jp)


@pytest.mark.parametrize("grids", GRIDS)
@pytest.mark.parametrize("split", [True, False])
def test_vision_forward_matches_jax(params, grids, split):
    jp, tp = params
    rng = np.random.default_rng(0)
    n_patches = sum(t * h * w for t, h, w in grids)
    patches = rng.normal(size=(n_patches, CFG.vision.patch_input_dim)).astype(np.float32)
    jprep = jax_prepare(grids, JCFG.vision)
    want = np.asarray(jax_vision_forward(
        jp["visual"], JCFG.vision, jnp.asarray(patches), jnp.asarray(jprep.perm),
        jnp.asarray(jprep.pos_hw), jnp.asarray(jprep.key_valid), jnp.asarray(jprep.full_gather),
        jnp.asarray(jprep.full_inverse), jnp.asarray(jprep.reverse),
    ))
    vis = VisionInputs.build(prepare_vision_inputs(grids, CFG.vision), torch.from_numpy(patches))
    window_attention_rope.launches = full_attention_rope.launches = 0
    if split:
        hidden = vision_blocks_forward(tp["visual"], CFG.vision, vis.patches, vis.perm, vis.pos_hw,
                                       vis.key_valid, vis.full_gather, vis.full_inverse, use_window_kernel=True)
        got = vision_merge_forward(tp["visual"], CFG.vision, hidden, vis.reverse).numpy()
    else:
        got = vision_forward(
            tp["visual"], CFG.vision, vis.patches, vis.perm, vis.pos_hw, vis.key_valid,
            vis.full_gather, vis.full_inverse, vis.reverse, use_window_kernel=True,
        ).numpy()
    assert window_attention_rope.launches == full_attention_rope.launches == 0
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("grids", GRIDS)
def test_unfrozen_vision_forward_and_grads_match_jax(params, grids):
    """use_window_kernel=False: the tower that the loss differentiates when
    fix_vit is off, against JAX's `vision_forward(..., use_window_kernel=False)`
    (rope rounded to the input dtype, then `_block_attention`), in the output
    and in the gradients of every visual parameter (f32 sums in another order:
    the JAX package's own 5e-4 for gradients)."""
    jp, tp = params
    rng = np.random.default_rng(1)
    n_patches = sum(t * h * w for t, h, w in grids)
    patches = rng.normal(size=(n_patches, CFG.vision.patch_input_dim)).astype(np.float32)
    jprep = jax_prepare(grids, JCFG.vision)
    jargs = [jnp.asarray(a) for a in (patches, jprep.perm, jprep.pos_hw, jprep.key_valid, jprep.full_gather,
                                      jprep.full_inverse, jprep.reverse)]
    n_out = int(jprep.reverse.shape[0])
    weight = rng.normal(size=(n_out, CFG.vision.out_hidden_size)).astype(np.float32)

    def jloss(visual):
        out = jax_vision_forward(visual, JCFG.vision, *jargs, use_window_kernel=False)
        return jnp.sum(out * weight), out

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp["visual"])
    vis = VisionInputs.build(prepare_vision_inputs(grids, CFG.vision), torch.from_numpy(patches))
    visual = jax.tree.map(lambda t: t.clone().requires_grad_(), tp["visual"])
    leaves = jax.tree.leaves(visual)
    window_attention_rope.launches = full_attention_rope.launches = 0
    got = vision_forward(visual, CFG.vision, vis.patches, vis.perm, vis.pos_hw, vis.key_valid,
                         vis.full_gather, vis.full_inverse, vis.reverse, use_window_kernel=False)
    grads = torch.autograd.grad((got * torch.from_numpy(weight)).sum(), leaves)
    assert window_attention_rope.launches == full_attention_rope.launches == 0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    gvisual = jax.tree.unflatten(jax.tree.structure(visual), list(grads))
    converted = params_to_jax({"visual": gvisual, "text": tp["text"]}, CFG)["visual"]
    assert np.abs(converted["patch_embed"]["kernel"]).max() > 0  # the embed and the blocks train
    assert np.abs(converted["blocks"]["attn"]["qkv_w"]).max() > 0
    for (path, w), (_, g) in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                                 jax.tree_util.tree_flatten_with_path(converted)[0]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=5e-4, atol=5e-5, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("grids,pad_to", [
    ([(2, 4, 4)], None),
    ([(2, 4, 4), (2, 6, 2)], 256),
    ([(16, 16, 28), (12, 20, 24)], 16384),  # the serving shapes of chip_smoke.py
    ([(3, 10, 14)], None),
])
def test_prepare_vision_inputs_equals_jax(grids, pad_to):
    from time_r1_tpu.models.qwen25vl import Qwen25VLConfig as JaxConfig
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig

    a = jax_prepare(grids, JaxConfig().vision, pad_patches_to=pad_to)
    b = prepare_vision_inputs(grids, Qwen25VLConfig().vision, pad_patches_to=pad_to)
    for field in ("perm", "pos_hw", "key_valid", "full_gather", "full_inverse", "reverse", "unit_valid"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field
    assert (a.n_patches, a.n_units) == (b.n_patches, b.n_units)


@pytest.mark.parametrize("T,H,W", [(4, 56, 84), (3, 28, 56)])
def test_patchify_equals_jax(T, H, W):
    frames = np.random.default_rng(4).integers(0, 256, size=(T, 3, H, W)).astype(np.float32)
    got, grid = patchify_video(frames)
    want, want_grid = jax_patchify_video(frames)
    assert grid == tuple(want_grid)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
