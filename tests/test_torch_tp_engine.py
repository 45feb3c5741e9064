"""The tensor-parallel `Engine` (`Engine(..., shard=ShardContext)`, the eval's
--tensor_parallel_size) over two gloo ranks (mesh data 1 × model 2,
`test_torch_ring_attention.spawn_ranks`) against the JAX package's `Engine`
over `shard_params` on a 1×2 mesh of virtual devices, as JAX's
tests/test_tp_eval.py holds it: the tiny config in f32, greedy, the tokens
equal. The cases: a text and a video request together, the video at G = 3
(the shared-prefix decode at the rank's heads), and int8 weights with the
int8 KV cache (quantized whole, then split). Both ranks' tokens equal each
other and one process's port `Engine` on the whole tree; `last_token_logits`
(the prob-based MCQ scoring) equals one process's within 1e-5, and
`set_params` cuts a new tree's shards. The mesh's decode is eager.

Without processes: the rank's serving tree (`sharding.serving_params`) holds
the rule table's blocks, each in storage of its own, and its fused int8 leaves equal the matching rows of
the whole tree's quantized leaf, the row-parallel ones its columns with every
scale whole; `mlp_proj` runs a shard's int8 MLP and the model rank's partial
sums add up to the whole MLP; FSDP shards are refused by name (A13; int4
shards: `test_torch_tp_paged.py`).

This module imports no JAX at its top: the ranks import it to run `_worker`.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_ring_attention import spawn_ranks

MAX_NEW = 6
# (name, requests, G, quantization, int8 KV)
CASES = [
    ("text_video", ("text", "video"), 1, None, False),
    ("video_g3", ("video",), 3, None, False),
    ("int8", ("text", "video"), 1, "int8", True),
]


def _raw_requests(cfg) -> dict:
    """tests/test_tp_eval.py's two requests, as plain data."""
    rng = np.random.default_rng(0)
    text = dict(ids=[int(t) for t in rng.integers(2, 200, 11)])
    ids = ([int(t) for t in rng.integers(2, 200, 4)] + [cfg.vision_start_token_id] + [cfg.video_token_id] * 8
           + [cfg.vision_end_token_id] + [int(t) for t in rng.integers(2, 200, 3)])
    video = dict(ids=ids, patches=rng.normal(size=(2 * 4 * 4, cfg.vision.patch_input_dim)).astype(np.float32),
                 grid=(2, 4, 4))
    return {"text": text, "video": video}


def requests(cfg, names, request_cls):
    raw = _raw_requests(cfg)
    out = []
    for n in names:
        r = raw[n]
        if "patches" in r:
            out.append(request_cls(input_ids=r["ids"], patches=r["patches"], grid_thw=r["grid"], second_per_grid_t=1.0))
        else:
            out.append(request_cls(input_ids=r["ids"]))
    return out


def sampling(cfg, G: int, cls):
    return cls(temperature=0.0, max_new_tokens=MAX_NEW, stop_token_ids=cfg.stop_token_ids, num_return_sequences=G)


def _worker(rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig
    from time_r1_tpu_torch.parallel import ShardContext, make_mesh, maybe_init_distributed
    from time_r1_tpu_torch.sampler import Engine, Request, SamplingParams

    torch.set_num_threads(1)
    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    cfg = Qwen25VLConfig.tiny_test(payload["vocab"])
    params = payload["params"]
    maybe_init_distributed("cpu")
    mesh = make_mesh(model_parallel=2)
    shard = ShardContext.build(mesh, params)
    out = {}
    for name, names, G, quant, kv in CASES:
        reqs = requests(cfg, names, Request)
        sp = sampling(cfg, G, SamplingParams)
        eng = Engine(params, cfg, dtype=torch.float32, device="cpu", quantization=quant, kv_cache_quant=kv,
                     shard=shard)
        one = Engine(params, cfg, dtype=torch.float32, device="cpu", quantization=quant, kv_cache_quant=kv)
        out[name] = dict(tp=eng.generate(reqs, sp), one=one.generate(reqs, sp), capture=eng.capture)
    # the rank's cache holds its kv heads; last_token_logits; set_params over a new tree
    eng = Engine(params, cfg, dtype=torch.float32, device="cpu", shard=shard)
    reqs = requests(cfg, ("text", "video"), Request)
    out["logits"] = dict(tp=eng.last_token_logits(reqs),
                         one=Engine(params, cfg, dtype=torch.float32, device="cpu").last_token_logits(reqs))
    out["local_q_rows"] = eng.params["text"]["layers"][0]["q_w"].shape[0]
    scaled = {"visual": params["visual"], "text": dict(params["text"], layers=[
        {k: (v * 0.5 if k.endswith("_w") else v) for k, v in lp.items()} for lp in params["text"]["layers"]])}
    eng.set_params(scaled)
    out["set_params"] = dict(tp=eng.generate(reqs, sampling(cfg, 1, SamplingParams)),
                             one=Engine(scaled, cfg, dtype=torch.float32, device="cpu").generate(
                                 reqs, sampling(cfg, 1, SamplingParams)))
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from test_torch_bridge import VOCAB, jax_params, port_params

    workdir = tmp_path_factory.mktemp("tp_engine")
    torch.save(dict(vocab=VOCAB, params=port_params(jax_params())), os.path.join(workdir, "payload.pt"))
    return spawn_ranks("test_torch_tp_engine", "_worker", 2, workdir)


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's Engine over shard_params on a 1×2 mesh of virtual devices."""
    import jax
    import jax.numpy as jnp

    from test_torch_bridge import JCFG, jax_params, numpy_tree
    from time_r1_tpu.parallel import make_mesh, shard_params
    from time_r1_tpu.sampler import Engine, Request, SamplingParams

    mesh = make_mesh(model_parallel=2, devices=jax.devices()[:2])
    sharded = shard_params(numpy_tree(jax_params()), mesh)
    out = {}
    for name, names, G, quant, kv in CASES:
        eng = Engine(sharded, JCFG, dtype=jnp.float32, quantization=quant, kv_cache_quant=kv)
        out[name] = eng.generate(requests(JCFG, names, Request), sampling(JCFG, G, SamplingParams))
    return out


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_tp_engine_matches_jax(ranks, jax_sharded, case):
    r0, r1 = ranks[0][case], ranks[1][case]
    assert r0["tp"] == r1["tp"]  # the ranks hold the same tokens
    assert r0["tp"] == jax_sharded[case]
    assert r0["tp"] == r0["one"]
    assert all(len(row) > 0 for row in r0["tp"])
    assert r0["capture"] is False  # a mesh's decode is eager


def test_tp_engine_last_token_logits_and_set_params(ranks):
    from test_torch_bridge import CFG

    for r in ranks:
        np.testing.assert_allclose(r["logits"]["tp"], r["logits"]["one"], rtol=1e-5, atol=1e-5)
        assert r["local_q_rows"] == CFG.text.num_attention_heads // 2 * CFG.text.head_dim
        assert r["set_params"]["tp"] == r["set_params"]["one"]
    assert ranks[0]["set_params"]["tp"] == ranks[1]["set_params"]["tp"]


def _ctx(params, tp: int, m: int):
    from time_r1_tpu_torch.parallel import ShardContext, param_specs

    return ShardContext(None, None, 1, tp, 0, m, param_specs(params, {"data": 1, "model": tp}))


@pytest.mark.parametrize("m", [0, 1])
def test_serving_tree_holds_the_rule_tables_blocks(m):
    from test_torch_bridge import jax_params, port_params
    from time_r1_tpu_torch.parallel import serving_params

    params = port_params(jax_params())
    ctx = _ctx(params, 2, m)
    blocks = ctx.shard(params)
    served = serving_params(params, ctx)
    for got, want in zip(served["text"]["layers"], blocks["text"]["layers"]):
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(got[k], want[k]), k
            if k.endswith(("_w", "_b")):  # a block of its own: a view would keep the whole leaf alive
                assert got[k].untyped_storage().nbytes() == got[k].numel() * got[k].element_size(), k
    for k in ("embed_tokens", "norm", "lm_head"):  # whole on every model rank
        assert torch.equal(served["text"][k], params["text"][k])
    for a, b in zip(served["visual"]["blocks"], blocks["visual"]["blocks"]):
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("m", [0, 1])
def test_sharded_int8_leaf_is_the_whole_leafs_rows(m):
    """A rank's fused int8 leaf equals the matching rows of the whole tree's
    quantized leaf, scales included (column-parallel); a row-parallel leaf
    is the whole quantized leaf's columns with every scale whole."""
    from test_torch_bridge import CFG, jax_params, port_params
    from time_r1_tpu_torch.ops.quant import quantize_embedding, quantize_layer
    from time_r1_tpu_torch.parallel import serving_params

    params = port_params(jax_params())
    served = serving_params(params, _ctx(params, 2, m), bits=8)
    t = CFG.text
    hd, nh, nkv, inter = t.head_dim, t.num_attention_heads, t.num_key_value_heads, t.intermediate_size
    for lp, got in zip(params["text"]["layers"], served["text"]["layers"]):
        whole = quantize_layer(lp, bits=8, fuse=True)
        q_rows = torch.arange(m * nh // 2 * hd, (m + 1) * nh // 2 * hd)
        kv_rows = torch.arange(m * nkv // 2 * hd, (m + 1) * nkv // 2 * hd)
        rows = torch.cat([q_rows, nh * hd + kv_rows, (nh + nkv) * hd + kv_rows])
        for key in ("q8", "s"):
            assert torch.equal(got["qkv"][key], whole["qkv"][key][rows])
        assert torch.equal(got["qkv_b"], whole["qkv_b"][rows])
        i_rows = torch.arange(m * inter // 2, (m + 1) * inter // 2)
        for key in ("q8", "s"):
            assert torch.equal(got["gu"][key], whole["gu"][key][torch.cat([i_rows, inter + i_rows])])
        for name, width in (("o_w", nh * hd), ("down_w", inter)):
            cols = slice(m * width // 2, (m + 1) * width // 2)
            assert torch.equal(got[name]["q8"], whole[name]["q8"][:, cols])
            assert torch.equal(got[name]["s"], whole[name]["s"])  # a max over the whole input: never split
    whole_emb = quantize_embedding(params["text"]["embed_tokens"])  # whole on every model rank
    assert all(torch.equal(served["text"]["embed_tokens"][k], whole_emb[k]) for k in ("q8", "s"))


def test_sharded_int8_mlp_partial_sums_add_up():
    """`mlp_proj` over each model rank's int8 shard (the plain products on
    the CPU, Q2's route on the card) sums to the whole quantized MLP."""
    from test_torch_bridge import CFG, jax_params, port_params
    from time_r1_tpu_torch.ops.quant import mlp_proj, quantize_layer
    from time_r1_tpu_torch.parallel import serving_params

    params = port_params(jax_params())
    lp = params["text"]["layers"][0]
    h = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 3, CFG.text.hidden_size)).astype(np.float32))
    want = mlp_proj(h, quantize_layer(lp, bits=8))
    parts = [mlp_proj(h, serving_params(params, _ctx(params, 2, m), bits=8)["text"]["layers"][0]) for m in (0, 1)]
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_unported_serving_shards_are_refused():
    from test_torch_bridge import jax_params, port_params
    from time_r1_tpu_torch.parallel import ShardContext, param_specs, serving_params

    params = port_params(jax_params())
    fsdp = ShardContext(None, None, 2, 1, 0, 0, param_specs(params, {"data": 2, "model": 1}))
    with pytest.raises(NotImplementedError, match="A13"):
        serving_params(params, fsdp)


def test_tp_group_index_needs_its_cards():
    """JAX's `cli/evaluate.py:201-205` refusal: group gi of tp ranks needs
    the cards [gi·tp, (gi+1)·tp); group 0 may share one card."""
    from time_r1_tpu_torch.parallel.mesh import card_group_check

    card_group_check(0, 2, 1, "tp 2 group 0")
    card_group_check(2, 2, 4, "tp 2 group 1")
    with pytest.raises(ValueError, match=r"needs devices \[2, 4\) but only 1 exist"):
        card_group_check(2, 2, 1, "tensor_parallel_size=2 group 1")
