"""The port's LoRA (`rl/lora.py`, the bridge and npz of `convert.py`, the
in-layer merge of the loss) against the JAX package's on the tiny config, in
f32 on the CPU.

- init_lora's tree over bf16-layout, int8 and decode-fused int8 bases, an
  int4 base giving nothing; merge_lora at B = 0 (the identity, other leaves
  shared) and with B perturbed against JAX's merge_lora, and the gradient
  through the merge against JAX's (both 1e-6: one r-term sum per element);
- lora_from_jax / lora_to_jax round trips, and `lora_adapters.npz` written by
  each package and read by the other: bit-equal;
- the GRPO loss with the decoder's adapters merged inside each layer
  (`grpo_loss(..., lora=)`) against `jax.value_and_grad` of JAX's, over the
  f32 base (loss rtol 2e-5, adapter gradients rtol 5e-4 / atol 5e-5, the
  split-loss tolerances of tests/test_torch_grpo.py), with and without
  remat, and under "dots"; remat against none on the port alone (loss 1e-6,
  gradients 5e-5); over int8 bases, fused and unfused, where the forward
  runs in bf16 (the int8 embedding's rows come out bf16, in both packages):
  the loss at rtol 2e-5 as above, the reference log-probs within 1e-2 and
  each adapter gradient within 3e-2 of its largest element (1.4e-2 read
  here: bf16 activations summed in other orders through two layers and the
  head; JAX's own fused-against-unfused check allows 2e-2 for the same);
- the quantized head's backward (the int8 base's loss reaches the hidden
  states through it) against JAX's.

Every adapter set is perturbed away from B = 0 (+0.01, as the JAX tests do),
so that no comparison holds trivially."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_grpo import _mk_groups
from test_torch_bridge import CFG, JCFG, jax_params, numpy_tree, port_params
from time_r1_tpu.ops.quant import quantize_params as jax_quantize_params
from time_r1_tpu.rl import GRPOHyperParams as JaxHyperParams
from time_r1_tpu.rl import grpo_loss as jax_grpo_loss
from time_r1_tpu.rl.lora import LoRAConfig as JaxLoRAConfig
from time_r1_tpu.rl.lora import fused_splits_for as jax_fused_splits_for
from time_r1_tpu.rl.lora import init_lora as jax_init_lora
from time_r1_tpu.rl.lora import lora_layers_tree as jax_lora_layers_tree
from time_r1_tpu.rl.lora import merge_lora as jax_merge_lora
from time_r1_tpu.rl.rollout import build_grpo_split_batch as jax_build
from time_r1_tpu_torch.models.qwen25vl import params_from_jax, params_to_jax
from time_r1_tpu_torch.models.qwen25vl.convert import load_lora_npz, lora_from_jax, lora_to_jax, save_lora_npz
from time_r1_tpu_torch.ops.quant import head_logits, quantize_params, quantize_weight
from time_r1_tpu_torch.rl import GRPOHyperParams, build_grpo_split_batch, grpo_loss
from time_r1_tpu_torch.rl.grpo import Adapters
from time_r1_tpu_torch.rl.lora import (
    LoRAConfig,
    fused_splits_for,
    init_lora,
    lora_layers_tree,
    lora_leaves,
    merge_lora,
)

torch.set_num_threads(2)
LCFG = LoRAConfig(rank=4, alpha=8.0)
JLCFG = JaxLoRAConfig(rank=4, alpha=8.0)


def jax_lora(params, fused=False, vision=False):
    """JAX's adapters over `params`, B perturbed (+0.01 on every factor)."""
    lora = jax_init_lora(params, JLCFG, jax.random.PRNGKey(7), dtype=jnp.float32,
                         fused_splits=jax_fused_splits_for(JCFG.text) if fused else None)
    if not vision:
        lora = {k: v for k, v in lora.items() if not k.startswith("visual")}
    return jax.tree.map(lambda a: a + 0.01, lora)


def port_lora(jlora):
    return lora_from_jax(numpy_tree(jlora), CFG, device="cpu")


@pytest.fixture(scope="module")
def params():
    jp = jax_params()
    return jp, port_params(jp)


def test_init_lora_layout(params):
    """Per layer lora_a (r, in) ~ N(0, 0.02) and lora_b (out, r) = 0, in the
    targets' order, with JAX's names and shapes (transposed) over the bf16,
    int8 and fused int8 layouts; an int4 base has nothing to adapt."""
    jp, tp = params
    mine = init_lora(tp, LCFG, seed=3)
    want = lora_to_jax(port_lora(jax_init_lora(jp, JLCFG, jax.random.PRNGKey(7))), CFG)
    got = lora_to_jax(mine, CFG)
    assert sorted(got) == sorted(want) and all(got[k][n].shape == want[k][n].shape for k in want for n in want[k])
    assert list(mine["text"]["layers"][0]) == ["q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w"]
    assert list(mine["visual"]["blocks"][0]) == ["gate_w", "up_w", "down_w"]
    a = torch.cat([x.flatten() for x in lora_leaves(mine)[0::2]])
    assert all(float(b.abs().max()) == 0 for b in lora_leaves(mine)[1::2])
    assert abs(float(a.std()) - 0.02) < 2e-3
    for fuse in (False, True):
        q = quantize_params(tp, bits=8, fuse=fuse)
        ql = init_lora(q, LCFG, seed=3, fused_splits=fused_splits_for(CFG.text) if fuse else None)
        assert sorted(lora_to_jax(ql, CFG)) == sorted(want)
        for x, y in zip(lora_leaves(ql), lora_leaves(mine)):
            assert x.shape == y.shape
        torch.testing.assert_close(lora_leaves(ql)[0], lora_leaves(mine)[0], rtol=0, atol=0)  # same seed, same draws
    assert list(init_lora(quantize_params(tp, bits=4), LCFG, seed=3)) == ["visual"]  # the tower stays bf16


def test_merge_identity_at_init_and_against_jax(params):
    jp, tp = params
    lora = init_lora(tp, LCFG, seed=1)
    merged = merge_lora(tp, lora, LCFG)
    for lp, mp in zip(tp["text"]["layers"], merged["text"]["layers"]):
        assert torch.equal(mp["q_w"], lp["q_w"])  # B = 0: the identity
        assert mp["q_b"] is lp["q_b"] and mp["input_layernorm"] is lp["input_layernorm"]
    assert merged["text"]["embed_tokens"] is tp["text"]["embed_tokens"]

    jl = jax_lora(jp, vision=True)
    got = params_to_jax(merge_lora(tp, port_lora(jl), LCFG), CFG)
    want = jax_merge_lora(jp, jl, JLCFG)
    for (path, w), (_, g) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                 jax.tree_util.tree_flatten_with_path(got)[0]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6, err_msg=jax.tree_util.keystr(path))
    assert not np.array_equal(got["text"]["layers"]["self_attn"]["q_w"], np.asarray(jp["text"]["layers"]["self_attn"]["q_w"]))


def test_merge_over_a_fused_bf16_base_concatenates_in_quantize_order(params):
    """A fused bf16 base (qkv, gu) merges the per-projection deltas along
    the output axis in q, k, v and gate, up order: equal to fusing the merged
    unfused layers."""
    jp, tp = params
    lora = port_lora(jax_lora(jp))
    fused_layers = [dict({k: v for k, v in lp.items() if k not in ("q_w", "k_w", "v_w", "gate_w", "up_w")},
                         qkv=torch.cat([lp["q_w"], lp["k_w"], lp["v_w"]]), gu=torch.cat([lp["gate_w"], lp["up_w"]]))
                    for lp in tp["text"]["layers"]]
    fused = {"visual": tp["visual"], "text": dict(tp["text"], layers=fused_layers)}
    got = merge_lora(fused, lora, LCFG)["text"]["layers"]
    want = merge_lora(tp, lora, LCFG)["text"]["layers"]
    for g, w in zip(got, want):
        torch.testing.assert_close(g["qkv"], torch.cat([w["q_w"], w["k_w"], w["v_w"]]), rtol=0, atol=0)
        torch.testing.assert_close(g["gu"], torch.cat([w["gate_w"], w["up_w"]]), rtol=0, atol=0)
    with pytest.raises(ValueError, match="quantized base"):
        merge_lora(quantize_params(tp, bits=8), lora, LCFG)


def test_gradients_flow_through_the_merge(params):
    """d/dB of sum(merged q_w²) at B = 0 is nonzero, and equals JAX's."""
    jp, tp = params
    jl = jax_init_lora(jp, JaxLoRAConfig(rank=2, targets=("q_w",)), jax.random.PRNGKey(1))
    jg = jax.grad(lambda ad: jnp.sum(jax_merge_lora(jp, ad, JaxLoRAConfig(rank=2, targets=("q_w",)))
                                     ["text"]["layers"]["self_attn"]["q_w"] ** 2))(jl)
    tl = port_lora(jl)
    leaves = lora_leaves(tl)
    for x in leaves:
        x.requires_grad_(True)
    merged = merge_lora(tp, tl, LoRAConfig(rank=2, targets=("q_w",)))
    loss = sum((lp["q_w"] ** 2).sum() for lp in merged["text"]["layers"])
    grads = torch.autograd.grad(loss, leaves)
    got = lora_to_jax(_with(tl, grads), CFG)
    for k in jg:
        np.testing.assert_allclose(got[k]["lora_b"], np.asarray(jg[k]["lora_b"]), rtol=1e-6, atol=1e-6)
        assert np.abs(got[k]["lora_b"]).max() > 0
        np.testing.assert_array_equal(got[k]["lora_a"], 0.0)


def _with(tree, values):
    """A tree of the structure of `tree` holding `values` in leaf order."""
    it = iter(values)

    def build(x):
        if isinstance(x, dict):
            return {k: build(v) for k, v in x.items()}
        if isinstance(x, list):
            return [build(v) for v in x]
        return next(it)

    return build(tree)


@pytest.mark.parametrize("vision", [False, True])
def test_bridge_round_trips_bit_equal(params, vision):
    jp, _ = params
    jl = numpy_tree(jax_lora(jp, vision=vision))
    back = lora_to_jax(lora_from_jax(jl, CFG, device="cpu"), CFG)
    assert sorted(back) == sorted(jl)
    for k in jl:
        for n in ("lora_a", "lora_b"):
            assert back[k][n].dtype == np.float32 and np.array_equal(back[k][n], jl[k][n]), (k, n)
    tl = port_lora(jl)
    again = lora_from_jax(lora_to_jax(tl, CFG), CFG, device="cpu")
    for a, b in zip(lora_leaves(tl), lora_leaves(again)):
        assert torch.equal(a, b)


def test_npz_crosses_both_ways(params, tmp_path):
    """The port's `lora_adapters.npz` read as the JAX trainer reads it, and
    the JAX trainer's (`np.savez` of its flat dict) read by the port."""
    jp, _ = params
    jl = jax_lora(jp, vision=True)
    tl = port_lora(jl)
    save_lora_npz(str(tmp_path / "port.npz"), tl, CFG)
    with np.load(tmp_path / "port.npz") as z:  # the JAX trainer's reader
        read = {}
        for key in z.files:
            p, n = key.split("::")
            read.setdefault(p, {})[n] = np.asarray(jnp.asarray(z[key], jnp.float32))
    np.savez(tmp_path / "jax.npz", **{f"{p}::{n}": np.asarray(v) for p, ab in jl.items() for n, v in ab.items()})
    from_jax = load_lora_npz(str(tmp_path / "jax.npz"))
    for k, ab in jl.items():
        for n, v in ab.items():
            assert np.array_equal(read[k][n], np.asarray(v)), (k, n)
            assert np.array_equal(from_jax[k][n], np.asarray(v)), (k, n)


def _loss_inputs(beta=0.0):
    G = 3
    groups = _mk_groups(True, G=G, P=2)
    jhp = JaxHyperParams(num_generations=G, beta=beta, fix_vit=True, gradient_checkpointing=True)
    jb = jax_build(JCFG, groups, dtype=jnp.float32)
    tb = build_grpo_split_batch(CFG, groups, dtype=torch.float32, device="cpu")
    return G, jhp, jb, tb


def _port_loss_and_grads(tbase, tl, hp, tb):
    leaves = lora_leaves(tl)
    for x in leaves:
        x.requires_grad_(True)
    dec, rest = lora_layers_tree(tl)
    assert not rest
    loss, metrics = grpo_loss(tbase, CFG, hp, tb, lora=Adapters(dec, LCFG.scaling))
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), metrics, lora_to_jax(_with(tl, grads), CFG)


def _jax_loss_and_grads(jbase, jl, jhp, jb):
    def loss_fn(ad):
        return jax_grpo_loss(jbase, JCFG, jhp, jb, lora=(jax_lora_layers_tree(ad)[0], JLCFG.scaling))

    (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(jl)
    return float(loss), metrics, grads


@pytest.mark.parametrize("remat", [False, True, "dots"])
def test_in_layer_merged_loss_matches_jax(params, remat):
    jp, tp = params
    G, jhp, jb, tb = _loss_inputs(beta=0.0)
    jl = jax_lora(jp)
    jloss, jmetrics, jgrads = _jax_loss_and_grads(jp, jl, jhp, jb)
    hp = GRPOHyperParams(num_generations=G, beta=0.0, fix_vit=True, gradient_checkpointing=remat)
    loss, metrics, grads = _port_loss_and_grads(tp, port_lora(jl), hp, tb)
    np.testing.assert_allclose(loss, jloss, rtol=2e-5, atol=2e-6)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=2e-4, atol=2e-5, err_msg=k)
    for k in jgrads:
        for n in ("lora_a", "lora_b"):
            np.testing.assert_allclose(grads[k][n], np.asarray(jgrads[k][n]), rtol=5e-4, atol=5e-5,
                                       err_msg=f"{k}/{n}")
            assert np.abs(grads[k][n]).max() > 0, (k, n)


def test_remat_gives_the_loss_and_gradients_of_no_remat(params):
    jp, tp = params
    G, _, _, tb = _loss_inputs(beta=0.0)
    jl = jax_lora(jp)
    out = {}
    for remat in (False, "full", "dots", "dots_small"):
        hp = GRPOHyperParams(num_generations=G, beta=0.0, fix_vit=True, gradient_checkpointing=remat)
        out[remat] = _port_loss_and_grads(tp, port_lora(jl), hp, tb)
    loss0, _, g0 = out[False]
    for remat in ("full", "dots", "dots_small"):
        loss, _, g = out[remat]
        np.testing.assert_allclose(loss, loss0, rtol=1e-6, atol=1e-7, err_msg=str(remat))
        for k in g0:
            for n in ("lora_a", "lora_b"):
                np.testing.assert_allclose(g[k][n], g0[k][n], rtol=5e-5, atol=5e-6, err_msg=f"{remat} {k}/{n}")


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_int8_base_loss_matches_jax(params, fuse):
    """The 7B single-card layout's loss over an int8 base (the embedding and
    the head int8 too), the adapters merged over each layer's dequantized
    bf16 weights; KL against the unmerged int8 base, as the trainer runs it."""
    jp, _ = params
    G, jhp, jb, tb = _loss_inputs(beta=0.04)
    jq = jax_quantize_params(jp, bits=8, fuse=fuse)
    tq = params_from_jax(numpy_tree(jq), CFG, device="cpu", dtype=torch.float32)
    jl = jax_lora(jq, fused=fuse)
    from time_r1_tpu.rl.grpo import compute_ref_logps as jax_ref_logps
    from time_r1_tpu_torch.rl.grpo import compute_ref_logps

    jb = jb._replace(ref_logps=jax_ref_logps(jq, JCFG, jhp, jb))
    hp = GRPOHyperParams(num_generations=G, beta=0.04, fix_vit=True, gradient_checkpointing=True)
    tb = tb._replace(ref_logps=compute_ref_logps(tq, CFG, hp, tb))
    np.testing.assert_allclose(tb.ref_logps.numpy(), np.asarray(jb.ref_logps), rtol=0, atol=1e-2)
    jloss, _, jgrads = _jax_loss_and_grads(jq, jl, jhp, jb)
    loss, _, grads = _port_loss_and_grads(tq, port_lora(jl), hp, tb)
    np.testing.assert_allclose(loss, jloss, rtol=2e-5, atol=2e-6)
    for k in jgrads:
        for n in ("lora_a", "lora_b"):
            want = np.asarray(jgrads[k][n])
            scale = np.abs(want).max()
            assert scale > 0 and np.abs(grads[k][n] - want).max() <= 3e-2 * scale, (k, n)


def test_quantized_head_backward_matches_jax():
    """The int8 head (row scales on the f32 logits): hidden's gradient keeps
    the f32 cotangent, as JAX's transpose of its f32-accumulating einsum."""
    from time_r1_tpu.ops.quant import tied_head_logits as jax_tied_head_logits

    rng = np.random.default_rng(0)
    emb = rng.normal(size=(256, 64)).astype(np.float32)
    h = rng.normal(size=(2, 5, 64)).astype(np.float32)
    g = rng.normal(size=(2, 5, 256)).astype(np.float32)
    w = quantize_weight(torch.from_numpy(emb), bits=8)
    from time_r1_tpu.ops.quant import quantize_embedding as jax_quantize_embedding

    jw = jax_quantize_embedding(jnp.asarray(emb), bits=8)
    np.testing.assert_array_equal(w["q8"].numpy(), np.asarray(jw["q8"]))
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 1e-5), (torch.bfloat16, jnp.bfloat16, 1e-2)):
        ht = torch.from_numpy(h).to(dtype).requires_grad_(True)
        y = head_logits(ht, w)
        (dh,) = torch.autograd.grad(y, ht, torch.from_numpy(g))
        jy, vjp = jax.vjp(lambda x: jax_tied_head_logits(x, jw), jnp.asarray(h, jdtype))
        (jdh,) = vjp(jnp.asarray(g))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=tol, atol=tol)
        assert dh.dtype == dtype
        np.testing.assert_allclose(dh.float().numpy(), np.asarray(jdh, np.float32), rtol=tol, atol=tol)
