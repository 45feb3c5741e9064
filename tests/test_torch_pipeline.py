"""Pipeline parallelism (`time_r1_tpu_torch/parallel/pipeline.py`) over gloo
ranks (`test_torch_ring_attention.spawn_ranks`) against the JAX package's
`time_r1_tpu/parallel/pipeline.py` on its virtual devices, the tiny config
(2 decoder layers: a layer a stage) in f32:

- `PPEngine` at 2 stages against JAX's `PPEngine`, greedy tokens equal (as
  tests/test_pp_generate.py): three text requests; a video request at G = 2
  (expanded to rows, the vision tower on stage 0); int8 weights over pure PP
  (each stage quantizes its own layers); and TP×PP 2×2 over 4 ranks against
  JAX's (stage, model) PPEngine. Every rank's tokens equal, and equal one
  process's port `Engine` on the whole tree.
- TP×PP with quantization raises JAX's ValueError, a stage count that does
  not divide the layers ValueError, a pipeline mesh over the wrong number of
  ranks ValueError.
- `pp_decoder_layers` at n_micro 1 and 2 over 2 stages, and at n_micro 2
  over 2×2, against JAX's within 1e-5 (the hidden state before the final
  norm, as tests/test_pipeline.py holds it after the norm), the same on
  every rank.

This module imports no JAX at its top: the ranks import it to run `_worker`.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_ring_attention import spawn_ranks
from test_torch_tp_engine import requests as tp_requests

MAX_NEW = 6
PP_TOL = dict(rtol=1e-5, atol=1e-5)
# (name, world, tp, G, quantization); the requests are `_requests(name)`
CASES = [
    ("text", 2, 1, 1, ""),
    ("video_g2", 2, 1, 2, ""),
    ("int8", 2, 1, 1, "int8"),
    ("tp2x2", 4, 2, 1, ""),
]
# (name, world, tp, n_micro, S)
FORWARDS = [("fwd_micro1", 2, 1, 1, 12), ("fwd_micro2", 2, 1, 2, 12), ("fwd_2x2", 4, 2, 2, 24)]


def _requests(cfg, name, request_cls):
    """tests/test_pp_generate.py's requests of each case."""
    if name == "video_g2":
        return tp_requests(cfg, ("video",), request_cls)
    seed, lengths = {"text": (0, (9, 21, 14)), "int8": (9, (10, 6)), "tp2x2": (5, (11, 7))}[name]
    rng = np.random.default_rng(seed)
    return [request_cls(input_ids=[int(t) for t in rng.integers(2, 200, n)]) for n in lengths]


def _sampling(cfg, G, cls):
    return cls(temperature=0.0, max_new_tokens=MAX_NEW, stop_token_ids=cfg.stop_token_ids, num_return_sequences=G)


def _forward_inputs(cfg, S: int):
    """tests/test_pipeline.py's inputs: B 4, one row left-padded (S 12) or
    right-padded (S 24)."""
    rng = np.random.default_rng(0 if S == 12 else 23)
    B = 4
    embeds = rng.normal(size=(B, S, cfg.hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None, None, :], (3, B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    if S == 12:
        mask[1, :3] = 0
    else:
        mask[1, S - 5:] = 0
    return embeds, pos, mask


def _worker(rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig
    from time_r1_tpu_torch.parallel import make_pp_mesh, maybe_init_distributed
    from time_r1_tpu_torch.parallel.pipeline import PPEngine, pp_decoder_layers
    from time_r1_tpu_torch.sampler import Engine, Request, SamplingParams

    torch.set_num_threads(1)
    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    cfg = Qwen25VLConfig.tiny_test(payload["vocab"])
    params = payload["params"]
    maybe_init_distributed("cpu")
    out = {}
    for name, w, tp, G, quant in CASES:
        if w != world:
            continue
        reqs, sp = _requests(cfg, name, Request), _sampling(cfg, G, SamplingParams)
        eng = PPEngine(params, cfg, n_stages=world // tp, dtype=torch.float32, tp=tp, quantization=quant,
                       device="cpu")
        one = Engine(params, cfg, dtype=torch.float32, device="cpu", quantization=quant or None)
        out[name] = dict(pp=eng.generate(reqs, sp), one=one.generate(reqs, sp),
                         layers=len(eng.stage_params["layers"]), holds_rest=eng.params is not None)
    for name, w, tp, n_micro, S in FORWARDS:
        if w != world:
            continue
        embeds, pos, mask = (torch.from_numpy(np.ascontiguousarray(a)) for a in _forward_inputs(cfg.text, S))
        mesh = make_pp_mesh(world // tp, tp)
        out[name] = pp_decoder_layers(params["text"]["layers"], cfg.text, embeds, pos.long(), mask.long(), mesh,
                                      n_micro)
    if world == 2:
        errors = {}
        for what, fn in (
            ("tp_quant", lambda: PPEngine(params, cfg, n_stages=2, tp=2, quantization="int8", device="cpu")),
            ("stages", lambda: PPEngine(params, cfg, n_stages=3, device="cpu")),
            ("mesh", lambda: make_pp_mesh(2, 2)),
        ):
            try:
                fn()
            except ValueError as e:
                errors[what] = str(e)
        out["errors"] = errors
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def cli_worker(rank: int, world: int, workdir: str) -> None:
    """A rank of tests/test_torch_eval_cli.py's mesh runs: `cli.evaluate`
    with each flag set of `cli.json` and `cli.demo --pipeline_parallel_size
    2`, from a port checkpoint read in f32 (the CLI reads bf16; the patch
    is the test's), the tiny tokenizer for `from_pretrained`."""
    import json

    import torch.distributed as dist
    from tiny_tokenizer import TinyTokenizer

    from time_r1_tpu_torch.cli import demo, evaluate
    from time_r1_tpu_torch.models.processor import Qwen25VLProcessor

    torch.set_num_threads(1)
    with open(os.path.join(workdir, "cli.json")) as f:
        job = json.load(f)
    processor = Qwen25VLProcessor(TinyTokenizer(), pad_token_id=job["pad"], eos_token_id=job["eos"])
    Qwen25VLProcessor.from_pretrained = classmethod(lambda cls, path, **kw: processor)
    load = evaluate.load_checkpoint

    def load_f32(path, dtype=torch.bfloat16, device="cuda"):
        return load(path, dtype=torch.float32, device=device)

    evaluate.load_checkpoint = demo.load_checkpoint = load_f32
    out = {tag: evaluate.main(evaluate.get_args(argv), device="cpu") for tag, argv in job["evaluate"].items()}
    out["demo"] = demo.main(demo.get_args(job["demo"]), device="cpu")
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _spawn(tmp_path_factory, world: int) -> list:
    from test_torch_bridge import VOCAB, jax_params, port_params

    workdir = tmp_path_factory.mktemp(f"pipeline{world}")
    torch.save(dict(vocab=VOCAB, params=port_params(jax_params())), os.path.join(workdir, "payload.pt"))
    return spawn_ranks("test_torch_pipeline", "_worker", world, workdir)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return _spawn(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _spawn(tmp_path_factory, 4)


def _ranks(ranks2, ranks4, world):
    return ranks2 if world == 2 else ranks4


@pytest.mark.parametrize("name,world,tp,G,quant", CASES, ids=[c[0] for c in CASES])
def test_pp_engine_matches_jax(ranks2, ranks4, name, world, tp, G, quant):
    import jax.numpy as jnp

    from test_torch_bridge import JCFG, jax_params, numpy_tree
    from time_r1_tpu.parallel.pipeline import PPEngine
    from time_r1_tpu.sampler import Request, SamplingParams

    ranks = _ranks(ranks2, ranks4, world)
    eng = PPEngine(numpy_tree(jax_params()), JCFG, n_stages=world // tp, dtype=jnp.float32, tp=tp,
                   quantization=quant)
    want = eng.generate(_requests(JCFG, name, Request), _sampling(JCFG, G, SamplingParams))
    for r in ranks:
        assert r[name]["pp"] == want
        assert r[name]["one"] == want
        assert r[name]["layers"] == JCFG.text.num_hidden_layers // (world // tp)
    assert [r[name]["holds_rest"] for r in ranks] == [i < tp for i in range(world)]  # stage 0 only


@pytest.mark.parametrize("name,world,tp,n_micro,S", FORWARDS, ids=[f[0] for f in FORWARDS])
def test_pp_decoder_layers_match_jax(ranks2, ranks4, name, world, tp, n_micro, S):
    import jax.numpy as jnp

    from test_torch_bridge import JCFG, jax_params
    from time_r1_tpu.parallel.pipeline import make_pp_mesh, pp_decoder_layers

    embeds, pos, mask = _forward_inputs(JCFG.text, S)
    want = pp_decoder_layers(jax_params()["text"]["layers"], JCFG.text, jnp.asarray(embeds), jnp.asarray(pos),
                             jnp.asarray(mask), make_pp_mesh(world // tp, tp), n_micro=n_micro)
    valid = mask.astype(bool)
    for r in _ranks(ranks2, ranks4, world):
        np.testing.assert_allclose(r[name].numpy()[valid], np.asarray(want)[valid], **PP_TOL)


def test_pp_refusals(ranks2):
    for r in ranks2:
        assert "TP×PP with --quantization" in r["errors"]["tp_quant"]
        assert "pipeline_parallel_size=3 does not divide the 2 decoder layers" in r["errors"]["stages"]
        assert "needs 4 ranks, the group has 2" in r["errors"]["mesh"]


def test_pp_tp_above_the_kv_heads_keeps_jaxs_assertion():
    """TP×PP with a tp the kv heads do not divide (the tiny config's 2 at tp
    4): JAX asserts `num_key_value_heads % tp == 0`
    (`time_r1_tpu/parallel/pipeline.py:460-463`), no kv-head replication
    inside a stage; the port raises ValueError on the same condition, before
    any group or mesh is made."""
    from test_torch_bridge import CFG, JCFG, jax_params, numpy_tree, port_params
    from time_r1_tpu.parallel.pipeline import PPEngine as JaxPPEngine
    from time_r1_tpu_torch.parallel.pipeline import PPEngine

    with pytest.raises(ValueError, match=r"num_key_value_heads % tp == 0"):
        PPEngine(port_params(jax_params()), CFG, n_stages=1, tp=4, device="cpu")
    with pytest.raises(AssertionError):
        JaxPPEngine(numpy_tree(jax_params()), JCFG, n_stages=1, tp=4)
