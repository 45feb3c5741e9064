"""The continuous-batching engines and int4 weights over a tensor-parallel
mesh (`PagedEngine(shard=...)`, `ContinuousEngine(shard=...)`,
`Engine(shard=..., quantization="int4")`: the eval's
`--tensor_parallel_size --use_continuous_batching [--quantization]`) over
two gloo ranks (mesh data 1 × model 2, `test_torch_ring_attention.spawn_ranks`)
against the JAX package's engines over `shard_params` on a 1×2 mesh of
virtual devices, as `test_torch_tp_engine.py` holds the TP `Engine`: the
tiny config in f32, greedy, the tokens equal. Every JAX engine here runs
over the sharded tree: the paged and slot engines take it as JAX's
`cli/evaluate.py:216-251` hands them `engine.params`.

The cases: `PagedEngine` over the whole tree (bf16 route, cut by the TP
`Engine` inside), `PagedEngine` with int8 weights and int8 pages over a TP
`Engine`'s serving tree (the eval's route), `ContinuousEngine`, and the TP
`Engine` over int4 weights at G = 1 and at G = 3 (the shared-prefix
decode); three requests over two slots, so that a slot retires and another
request is admitted. Both ranks' tokens equal each other, JAX's and one
process's port engine on the whole tree; the pool and the slot caches hold
the rank's kv heads; the decode is eager.

Without processes: the rank's int4 serving leaves equal the matching rows
(column-parallel) or packed bytes (row-parallel, every scale whole) of the
whole tree's quantized leaf, each block in storage of its own; the model
ranks' int4 products add up to the whole layer's; an engine keeps a
`ServingTree` as it is and refuses one cut for another rank or other bits.

This module imports no JAX at its top: the ranks import it to run `_worker`.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_ring_attention import spawn_ranks
from test_torch_tp_engine import _ctx, requests, sampling

SLOTS, MAX_LEN, PAGE = 2, 64, 16
# (name, engine, request names, G, quantization, int8 KV)
CASES = [
    ("paged", "paged", ("text", "video", "short"), 1, None, False),
    ("paged_int8", "paged_over_engine", ("text", "video", "short"), 1, "int8", True),
    ("continuous", "continuous", ("text", "video", "short"), 1, None, False),
    ("int4_g1", "engine", ("text", "video"), 1, "int4", False),
    ("int4_g3", "engine", ("video",), 3, "int4", False),
]


def _requests(cfg, names, request_cls):
    """test_torch_tp_engine's text and video requests, and a shorter text."""
    out = requests(cfg, [n for n in names if n != "short"], request_cls)
    if "short" in names:
        rng = np.random.default_rng(3)
        out.append(request_cls(input_ids=[int(t) for t in rng.integers(2, 200, 5)]))
    return out


def _engines(kind, params, cfg, quant, kv, shard, mods):
    """The port's engine of a case (`mods`: the port's sampler and dtype), over
    `shard` or, with shard None, in one process."""
    Engine, PagedEngine, ContinuousEngine, dtype = mods
    kw = dict(dtype=dtype, device="cpu", shard=shard)
    cont = dict(max_slots=SLOTS, max_len=MAX_LEN)
    if kind == "engine":
        return Engine(params, cfg, quantization=quant, kv_cache_quant=kv, **kw)
    if kind == "paged":
        return PagedEngine(params, cfg, page_size=PAGE, quantization=quant, kv_cache_quant=kv, **cont, **kw)
    if kind == "continuous":
        return ContinuousEngine(params, cfg, quantization=quant, **cont, **kw)
    eng = Engine(params, cfg, quantization=quant, kv_cache_quant=kv, **kw)  # the eval's route: the engine's tree
    return PagedEngine(eng.params, cfg, page_size=PAGE, kv_cache_quant=kv, **cont, **kw)


def _worker(rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig
    from time_r1_tpu_torch.parallel import ShardContext, make_mesh, maybe_init_distributed
    from time_r1_tpu_torch.sampler import ContinuousEngine, Engine, PagedEngine, Request, SamplingParams
    from time_r1_tpu_torch.sampler.paged import make_pool

    torch.set_num_threads(1)
    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    cfg = Qwen25VLConfig.tiny_test(payload["vocab"])
    params = payload["params"]
    maybe_init_distributed("cpu")
    shard = ShardContext.build(make_mesh(model_parallel=2), params)
    mods = (Engine, PagedEngine, ContinuousEngine, torch.float32)
    out = {}
    for name, kind, names, G, quant, kv in CASES:
        reqs, sp = _requests(cfg, names, Request), sampling(cfg, G, SamplingParams)
        eng = _engines(kind, params, cfg, quant, kv, shard, mods)
        inner = getattr(eng, "_prefill_engine", eng)
        out[name] = dict(tp=eng.generate(reqs, sp),
                         one=_engines(kind, params, cfg, quant, kv, None, mods).generate(reqs, sp),
                         capture=inner.capture)
        if kind != "engine":
            out[name]["pool_heads"] = make_pool(cfg, 4, PAGE, SLOTS, 2, device="cpu",
                                                shard=inner._text_shard).k.shape[1]
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from test_torch_bridge import VOCAB, jax_params, port_params

    workdir = tmp_path_factory.mktemp("tp_paged")
    torch.save(dict(vocab=VOCAB, params=port_params(jax_params())), os.path.join(workdir, "payload.pt"))
    return spawn_ranks("test_torch_tp_paged", "_worker", 2, workdir)


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's engines over shard_params on a 1×2 mesh of virtual devices."""
    import jax
    import jax.numpy as jnp

    from test_torch_bridge import JCFG, jax_params, numpy_tree
    from time_r1_tpu.parallel import make_mesh, shard_params
    from time_r1_tpu.sampler import Engine, Request, SamplingParams
    from time_r1_tpu.sampler.continuous import ContinuousEngine
    from time_r1_tpu.sampler.paged import PagedEngine

    mesh = make_mesh(model_parallel=2, devices=jax.devices()[:2])
    sharded = shard_params(numpy_tree(jax_params()), mesh)
    cont = dict(max_slots=SLOTS, max_len=MAX_LEN, dtype=jnp.float32)
    out = {}
    for name, kind, names, G, quant, kv in CASES:
        if kind == "engine":
            eng = Engine(sharded, JCFG, dtype=jnp.float32, quantization=quant, kv_cache_quant=kv)
        elif kind == "paged":
            eng = PagedEngine(sharded, JCFG, page_size=PAGE, **cont)
        elif kind == "continuous":
            eng = ContinuousEngine(sharded, JCFG, **cont)
        else:  # JAX's cli/evaluate.py:212-230: the paged engine over the bucket engine's tree
            tree = Engine(sharded, JCFG, dtype=jnp.float32, quantization=quant, kv_cache_quant=kv).params
            eng = PagedEngine(tree, JCFG, page_size=PAGE, kv_cache_quant=kv, **cont)
        out[name] = eng.generate(_requests(JCFG, names, Request), sampling(JCFG, G, SamplingParams))
    return out


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_tp_engines_match_jax(ranks, jax_sharded, case):
    from test_torch_bridge import CFG

    r0, r1 = ranks[0][case], ranks[1][case]
    assert r0["tp"] == r1["tp"]  # the ranks hold the same tokens
    assert r0["tp"] == jax_sharded[case]
    assert r0["tp"] == r0["one"]
    assert all(len(row) > 0 for row in r0["tp"])
    assert r0["capture"] is False and r1["capture"] is False  # a mesh's decode is eager
    if "pool_heads" in r0:
        assert r0["pool_heads"] == r1["pool_heads"] == CFG.text.num_key_value_heads // 2


def _int4_served(m: int):
    from test_torch_bridge import jax_params, port_params
    from time_r1_tpu_torch.parallel import serving_params

    params = port_params(jax_params())
    return params, serving_params(params, _ctx(params, 2, m), bits=4)


@pytest.mark.parametrize("m", [0, 1])
def test_sharded_int4_leaf_is_the_whole_leafs_rows(m):
    """A rank's fused int4 leaf equals the matching rows of the whole tree's
    quantized leaf, scales included (column-parallel); a row-parallel leaf
    is the whole quantized leaf's packed bytes of its input columns, with
    every scale whole. Each block is in storage of its own; the embedding
    and the head stay int8, as on one card."""
    from test_torch_bridge import CFG
    from time_r1_tpu_torch.ops.quant import quantize_layer, quantize_text_params

    params, served = _int4_served(m)
    t = CFG.text
    hd, nh, nkv, inter = t.head_dim, t.num_attention_heads, t.num_key_value_heads, t.intermediate_size
    assert served.bits == 4 and (served.tp, served.model_rank) == (2, m)
    for lp, got in zip(params["text"]["layers"], served["text"]["layers"]):
        whole = quantize_layer(lp, bits=4, fuse=True)
        q_rows = torch.arange(m * nh // 2 * hd, (m + 1) * nh // 2 * hd)
        kv_rows = torch.arange(m * nkv // 2 * hd, (m + 1) * nkv // 2 * hd)
        rows = torch.cat([q_rows, nh * hd + kv_rows, (nh + nkv) * hd + kv_rows])
        for key in ("q4", "s"):
            assert torch.equal(got["qkv"][key], whole["qkv"][key][rows])
        i_rows = torch.arange(m * inter // 2, (m + 1) * inter // 2)
        for key in ("q4", "s"):
            assert torch.equal(got["gu"][key], whole["gu"][key][torch.cat([i_rows, inter + i_rows])])
        for name, width in (("o_w", nh * hd), ("down_w", inter)):
            cols = slice(m * width // 4, (m + 1) * width // 4)  # two k a byte
            assert torch.equal(got[name]["q4"], whole[name]["q4"][:, cols])
            assert torch.equal(got[name]["s"], whole[name]["s"])  # a max over the whole input: never split
            assert got[name]["q4"].untyped_storage().nbytes() == got[name]["q4"].numel()
    want = quantize_text_params(dict(params["text"], layers=[]), bits=4)
    for k in ("embed_tokens", "lm_head"):
        assert "q8" in served["text"][k]
        assert all(torch.equal(served["text"][k][x], want[k][x]) for x in ("q8", "s"))


def test_sharded_int4_products_add_up():
    """Each model rank's int4 attention output and MLP (the plain products on
    the CPU, Q1's route on the card) sum to the whole quantized layer's, and
    the ranks' q | k | v products are the whole one's heads."""
    from test_torch_bridge import CFG
    from time_r1_tpu_torch.ops.quant import attn_out_proj, attn_qkv_proj, mlp_proj, quantize_layer

    t = CFG.text
    nh, nkv, hd = t.num_attention_heads, t.num_key_value_heads, t.head_dim
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.normal(size=(2, 3, t.hidden_size)).astype(np.float32))
    a = torch.from_numpy(rng.normal(size=(2, 3, nh * hd)).astype(np.float32))
    params, _ = _int4_served(0)
    whole = quantize_layer(params["text"]["layers"][0], bits=4)
    parts = [_int4_served(m)[1]["text"]["layers"][0] for m in (0, 1)]
    np.testing.assert_allclose((mlp_proj(h, parts[0]) + mlp_proj(h, parts[1])).numpy(), mlp_proj(h, whole).numpy(),
                               rtol=1e-5, atol=1e-5)
    halves = a.chunk(2, dim=-1)
    got = attn_out_proj(halves[0], parts[0]) + attn_out_proj(halves[1], parts[1])
    np.testing.assert_allclose(got.numpy(), attn_out_proj(a, whole).numpy(), rtol=1e-5, atol=1e-5)
    q, k, v = attn_qkv_proj(h, whole, nh, nkv, hd)
    for m, lp in enumerate(parts):
        qm, km, vm = attn_qkv_proj(h, lp, nh // 2, nkv // 2, hd)
        for got_m, want in ((qm, q), (km, k), (vm, v)):
            n = got_m.shape[2]
            assert torch.equal(got_m, want[:, :, m * n:(m + 1) * n])


def test_an_engine_keeps_a_serving_tree():
    """`Engine(serving tree, shard=...)` keeps the tree's tensors (the paged
    and slot engines over a TP engine's `params`); a tree cut for another
    model rank or at other bits is refused."""
    from test_torch_bridge import CFG
    from time_r1_tpu_torch.sampler import Engine

    params, served = _int4_served(1)
    eng = Engine(served, CFG, dtype=torch.float32, device="cpu", quantization="int4", shard=_ctx(params, 2, 1))
    assert eng.params is served
    assert Engine(served, CFG, dtype=torch.float32, device="cpu", shard=_ctx(params, 2, 1)).params is served
    with pytest.raises(ValueError, match="model rank 1 of 2 handed to model rank 0"):
        Engine(served, CFG, dtype=torch.float32, device="cpu", shard=_ctx(params, 2, 0))
    with pytest.raises(ValueError, match="4-bit weights where 8 bits"):
        Engine(served, CFG, dtype=torch.float32, device="cpu", quantization="int8", shard=_ctx(params, 2, 1))
