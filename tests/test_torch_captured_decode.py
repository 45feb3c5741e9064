"""The decode as one device program (`sampler/graph.py`, the device-length
steps of `models/qwen25vl/language.py`, D2's device `own_len`), on the CPU
with the tiny config. Both packages are imported here only.

- A one-token step that reads the cache's length from the device
  (`KVCache.with_device_length`) equals the host-int step bit for bit, in
  `decoder_forward` and `shared_decode_forward`, over bf16 and int8 caches at
  lengths 0, 1 and 127.
- D2's plain version with a device `own_len` equals the JAX kernel in
  interpret mode at suffix lengths 0, 1 and 199 (tolerance 2e-5, as
  tests/test_torch_decode_attention.py).
- Greedy tokens of `Engine.generate` at G = 1 and G = 4 and of `PagedEngine`
  equal the JAX package's at host-check segments of 1, 3 and 16 steps: with
  rows that all stop within a few steps of a 40-token budget (the steps run
  after that write the pad id), with the repetition penalty and with an int8
  KV cache; `decode_steps` follows the segment rule.
- `StepGraph`'s launch accounting: a replay adds the change the capture
  recorded, once, and a failed capture raises instead of running eagerly.
"""

import math
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_bridge import CFG, JCFG, jax_params, port_params
from test_torch_decode_attention import TOL, _case, _hm_jax, _hm_torch, _t
from time_r1_tpu.ops import decode_attention as jda
from time_r1_tpu.sampler import Engine as JaxEngine
from time_r1_tpu.sampler import Request as JaxRequest
from time_r1_tpu.sampler import SamplingParams as JaxSamplingParams
from time_r1_tpu.sampler import paged as jpaged
from time_r1_tpu_torch.models.qwen25vl import KVCache, shared_decode_forward
from time_r1_tpu_torch.models.qwen25vl.language import decoder_forward
from time_r1_tpu_torch.ops import decode_attention as da
from time_r1_tpu_torch.ops import quant as tq
from time_r1_tpu_torch.sampler import Engine, PagedEngine, Request, SamplingParams
from time_r1_tpu_torch.sampler import engine as engine_mod
from time_r1_tpu_torch.sampler import graph as graph_mod

torch.set_num_threads(2)

NEG_INF = -1e30
SEGMENTS = (1, 3, 16)


@pytest.fixture(scope="module")
def params():
    jp = jax_params()
    return jp, port_params(jp)


# ---------------------------------------------------------------------------
# one-token steps at a device length


def _cache(shape, L: int, kind: str, rng) -> KVCache:
    k = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    if kind == "int8":
        return tq.quantize_kv_cache(KVCache(k, v, L))
    return KVCache(k.to(torch.bfloat16), v.to(torch.bfloat16), L)


def _clone(c: KVCache) -> KVCache:
    copy = lambda x: None if x is None else x.clone()  # noqa: E731
    return KVCache(copy(c.k), copy(c.v), c.length, copy(c.k_scale), copy(c.v_scale))


def _assert_same_buffers(a: KVCache, b: KVCache) -> None:
    for x, y in ((a.k, b.k), (a.v, b.v), (a.k_scale, b.k_scale), (a.v_scale, b.v_scale)):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("L", [0, 1, 127])
def test_decoder_step_at_device_length_equals_host_step(params, kind, L):
    """decoder_forward at S = 1 over a (2, 128)-slot cache: the bias, the
    padding gather and the K/V write at the device length give the host-int
    step's hidden states and cache bit for bit; the device length advances
    in place."""
    _, tp = params
    t = CFG.text
    rng = np.random.default_rng(L)
    B, max_len = 2, 128
    cache = _cache((t.num_hidden_layers, B, max_len, t.num_key_value_heads, t.head_dim), L, kind, rng)
    hidden = torch.from_numpy((rng.normal(size=(B, 1, t.hidden_size)) * 0.1).astype(np.float32))
    pos = torch.full((3, B, 1), L + 5, dtype=torch.long)
    mask = torch.ones((B, max_len), dtype=torch.long)
    mask[1, :min(L, 3)] = 0  # row 1 left-padded

    host_cache = _clone(cache)
    want, want_cache = decoder_forward(tp["text"], t, hidden, pos, attention_mask=mask, cache=host_cache)
    dev_cache = _clone(cache).with_device_length()
    got, got_cache = decoder_forward(tp["text"], t, hidden, pos, attention_mask=mask, cache=dev_cache)
    assert torch.equal(got, want)
    _assert_same_buffers(got_cache, want_cache)
    assert want_cache.length == L + 1
    assert got_cache is dev_cache and dev_cache.dev_length.tolist() == [L + 1] and dev_cache.length == L


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("L", [0, 1, 127])
def test_shared_step_at_device_length_equals_host_step(params, kind, L):
    """shared_decode_forward's one-token step (P = 2 prompts of R = 2 rows, a
    left-padded prefix of 24, a 128-slot suffix): the own bias and the
    suffix writes at the device length give the host-int step's result bit
    for bit."""
    _, tp = params
    t = CFG.text
    rng = np.random.default_rng(10 + L)
    P, R, Lp, Lo = 2, 2, 24, 128
    kv = (t.num_hidden_layers, t.num_key_value_heads, t.head_dim)
    prefix = _cache((kv[0], P, Lp, *kv[1:]), Lp, kind, rng)
    suffix = _cache((kv[0], P * R, Lo, *kv[1:]), L, kind, rng)
    bias = torch.from_numpy(np.where(np.arange(Lp)[None, :] >= np.array([[5], [0]]), 0.0, NEG_INF)
                            .astype(np.float32))
    hidden = torch.from_numpy((rng.normal(size=(P * R, 1, t.hidden_size)) * 0.1).astype(np.float32))
    pos = torch.full((3, P * R, 1), 30 + L, dtype=torch.long)

    want, want_suf = shared_decode_forward(tp["text"], t, hidden, pos, prefix, _clone(suffix), bias)
    dev_suffix = _clone(suffix).with_device_length()
    got, got_suf = shared_decode_forward(tp["text"], t, hidden, pos, prefix, dev_suffix, bias)
    assert torch.equal(got, want)
    _assert_same_buffers(got_suf, want_suf)
    assert want_suf.length == L + 1 and dev_suffix.dev_length.tolist() == [L + 1]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("own_len", [0, 1, 199])
def test_d2_plain_with_device_own_len_matches_jax(quant, own_len):
    """D2's plain version with own_len a (1,) int32 tensor, as the decode
    loop hands it over, against the JAX kernel in interpret mode."""
    P, R = 2, 4
    c = _case(P, R, quant, Lo=256, seed=4)
    Lo = c["ko"].shape[1]
    bias_own = np.where(np.arange(Lo) < own_len, 0.0, NEG_INF).astype(np.float32)
    want = jda.shared_prefix_decode_full(
        jnp.asarray(c["q_rows"]), _hm_jax(c["kp"]), _hm_jax(c["vp"]), _hm_jax(c["kp_s"]), _hm_jax(c["vp_s"]),
        jnp.asarray(c["bias"]), _hm_jax(c["ko"]), _hm_jax(c["vo"]), _hm_jax(c["ko_s"]), _hm_jax(c["vo_s"]),
        jnp.asarray(bias_own), jnp.asarray(c["kn"][:, 0]), jnp.asarray(c["vn"][:, 0]), interpret=True)
    da.shared_prefix_decode_full.launches = 0
    got = da.shared_prefix_decode_full(
        _t(c["q_rows"]), _hm_torch(c["kp"]), _hm_torch(c["vp"]), _hm_torch(c["kp_s"]), _hm_torch(c["vp_s"]),
        _t(c["bias"]), _hm_torch(c["ko"]), _hm_torch(c["vo"]), _hm_torch(c["ko_s"]), _hm_torch(c["vo_s"]),
        torch.tensor([own_len], dtype=torch.int32), _t(c["kn"][:, 0].copy()), _t(c["vn"][:, 0].copy()))
    assert da.shared_prefix_decode_full.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the loops against the JAX package, at several host-check segments


def _prompts():
    rng = np.random.default_rng(21)
    return [list(rng.integers(2, 200, n)) for n in (9, 14)]


_JAX_CACHE: dict = {}


def _jax_engine(jp, kv_quant: bool):
    key = ("engine", kv_quant)
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = JaxEngine(jp, JCFG, dtype=jnp.float32, kv_cache_quant=kv_quant)
    return _JAX_CACHE[key]


def _early_stop_ids(jp, G: int) -> tuple:
    """Stop ids that end every row within a few steps: the token each row
    generates third, greedy, with no stop id."""
    key = ("stops", G)
    if key not in _JAX_CACHE:
        sp = JaxSamplingParams(max_new_tokens=4, stop_token_ids=(), num_return_sequences=G)
        rows = _jax_engine(jp, False).generate([JaxRequest(input_ids=p) for p in _prompts()], sp)
        _JAX_CACHE[key] = tuple(sorted({r[2] for r in rows}))
    return _JAX_CACHE[key]


# name: (G, int8 KV, SamplingParams fields; stop ids None: the early-stop ids)
ENGINE_CASES = {
    "G1": (1, False, dict(max_new_tokens=10)),
    "G4": (4, False, dict(max_new_tokens=10)),
    "G1 early stop": (1, False, dict(max_new_tokens=40, stop_token_ids=None)),
    "G4 early stop": (4, False, dict(max_new_tokens=40, stop_token_ids=None)),
    "G1 repetition penalty": (1, False, dict(max_new_tokens=12, repetition_penalty=1.3)),
    "G4 repetition penalty, int8 KV": (4, True, dict(max_new_tokens=12, repetition_penalty=1.3)),
}


def _engine_case(jp, name: str):
    G, kv_quant, fields = ENGINE_CASES[name]
    sp = dict(temperature=0.0, stop_token_ids=CFG.stop_token_ids, num_return_sequences=G)
    sp.update(fields)
    if sp["stop_token_ids"] is None:
        sp["stop_token_ids"] = _early_stop_ids(jp, G)
    key = ("tokens", name)
    if key not in _JAX_CACHE:
        jreqs = [JaxRequest(input_ids=p) for p in _prompts()]
        _JAX_CACHE[key] = _jax_engine(jp, kv_quant).generate(jreqs, JaxSamplingParams(**sp))
    return kv_quant, sp, _JAX_CACHE[key]


def _segment_steps(rows, sp: dict, segment: int) -> int:
    """The steps the loop runs: the host reads the done flags before each
    segment, so it stops at the first boundary at or after the step that
    leaves every row done (JAX's count), and never past max_new_tokens - 1."""
    max_new, stops = sp["max_new_tokens"], set(sp["stop_token_ids"])
    ends = [next((i for i, t in enumerate(r) if t in stops), None) for r in rows]
    jax_steps = max_new - 1 if None in ends else max(ends)
    return min(segment * math.ceil(jax_steps / segment), max_new - 1)


@pytest.mark.parametrize("segment", SEGMENTS)
@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engine_tokens_match_jax_at_every_segment(params, name, segment, monkeypatch):
    jp, tp = params
    kv_quant, sp, want = _engine_case(jp, name)
    monkeypatch.setattr(engine_mod, "DECODE_SEGMENT", segment)
    eng = Engine(tp, CFG, dtype=torch.float32, device="cpu", kv_cache_quant=kv_quant)
    got = eng.generate([Request(input_ids=p) for p in _prompts()], SamplingParams(**sp))
    assert got == want
    assert eng.timings["decode_steps"] == _segment_steps(got, sp, segment)
    if "early stop" in name:  # every row ended within 5 of 40 steps: the rest wrote pad
        assert max(len(r) for r in got) <= 5


@pytest.mark.parametrize("G", [1, 3])
def test_sampled_tokens_do_not_depend_on_the_segment(params, G, monkeypatch):
    """At T = 1.0 the loop draws once per step from its generator, whatever
    the segment: 1, 3 and 16 steps between host checks give the same
    tokens."""
    _, tp = params
    sp = SamplingParams(temperature=1.0, max_new_tokens=12, stop_token_ids=(), num_return_sequences=G, seed=3)
    out = []
    for segment in SEGMENTS:
        monkeypatch.setattr(engine_mod, "DECODE_SEGMENT", segment)
        eng = Engine(tp, CFG, dtype=torch.float32, device="cpu")
        out.append(eng.generate([Request(input_ids=p) for p in _prompts()], sp))
    assert out[0] == out[1] == out[2] and all(len(r) == 12 for r in out[0])


def test_decode_loop_refuses_a_suffix_too_short(params):
    """D2 cannot check its device own_len against the suffix: the loop
    checks, once, that the suffix holds max_new_tokens positions."""
    _, tp = params
    t = CFG.text
    prefix = KVCache(torch.zeros(t.num_hidden_layers, 1, 8, t.num_key_value_heads, t.head_dim),
                     torch.zeros(t.num_hidden_layers, 1, 8, t.num_key_value_heads, t.head_dim), 8)
    suffix = replace(prefix, length=0)
    with pytest.raises(ValueError, match="suffix cache of 8 positions"):
        engine_mod.decode_loop_shared(tp, CFG, prefix, suffix, torch.zeros(1, t.vocab_size),
                                      torch.zeros(1, dtype=torch.long), torch.zeros(1, 8),
                                      SamplingParams(max_new_tokens=9), None)


# (name, SamplingParams fields): stop ids None are the early-stop ids
PAGED_CASES = {
    "mixed lengths": dict(max_new_tokens=7),
    "early stop": dict(max_new_tokens=40, stop_token_ids=None),
}


@pytest.mark.parametrize("segment", SEGMENTS)
@pytest.mark.parametrize("name", list(PAGED_CASES))
def test_paged_tokens_match_jax_at_every_segment(params, name, segment):
    """Three prompts through two slots (slots and pages recycle), pages of
    16: the port's PagedEngine at segments 1, 3 and 16 against the JAX
    package's PagedEngine (at its default segment; its tokens do not depend
    on it)."""
    jp, tp = params
    sp = dict(temperature=0.0, stop_token_ids=CFG.stop_token_ids)
    sp.update(PAGED_CASES[name])
    if sp["stop_token_ids"] is None:
        sp["stop_token_ids"] = _early_stop_ids(jp, 1)
    reqs = [Request(input_ids=p) for p in _prompts() + [list(range(3, 20))]]
    key = ("paged", name)
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = jpaged.PagedEngine(jp, JCFG, dtype=jnp.float32, max_slots=2, max_len=128,
                                             page_size=16).generate(
            [JaxRequest(input_ids=r.input_ids) for r in reqs], JaxSamplingParams(**sp))
    eng = PagedEngine(tp, CFG, dtype=torch.float32, device="cpu", max_slots=2, max_len=128, page_size=16,
                      segment=segment)
    got = eng.generate(reqs, SamplingParams(**sp))
    assert got == _JAX_CACHE[key]
    assert eng.timings["decode_steps"] == segment * eng.timings["segments"]


# ---------------------------------------------------------------------------
# launch accounting under replay


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph on the CPU: capture runs nothing
    on a device, and a replay calls no Python, as on the card."""

    fail = False

    def __init__(self):
        self.replays = 0

    def register_generator_state(self, gen):
        raise AssertionError("no generator was given")

    def capture_begin(self, capture_error_mode="global"):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")

    def capture_end(self):
        pass

    def replay(self):
        self.replays += 1


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(graph_mod.StepGraph, "_on_side_stream", lambda self, fn: fn())
    d2 = da.shared_prefix_decode_full
    saved = (d2.launches, d2.tc_launches)
    yield d2
    d2.launches, d2.tc_launches = saved


def test_launch_counters_cover_every_wrapper():
    """Every kernel wrapper of `ops/` that counts launches is in the
    accounting, with each of its counters."""
    from time_r1_tpu_torch.ops import (decode_attention, flash_attention, fused_mlp, int4_matmul,
                                       paged_attention, vision_attention)

    found = set()
    for mod in (decode_attention, flash_attention, fused_mlp, int4_matmul, paged_attention, vision_attention):
        for obj in vars(mod).values():
            if callable(obj) and getattr(obj, "__module__", None) == mod.__name__:
                for attr in ("launches", "tc_launches"):
                    if hasattr(obj, attr):
                        found.add((obj, attr))
    assert found == set(graph_mod.launch_counters())


@pytest.mark.parametrize("steps", [1, 2, 5])
def test_replay_adds_the_recorded_change_once(fake_card, steps):
    """A step that launches D2 36 times on the tensor cores: the eager first
    step counts them as it runs, the capture's count is taken back, and each
    replay adds it once."""
    d2 = fake_card
    calls = []

    def step():
        calls.append(1)
        d2.launches += 36
        d2.tc_launches += 36

    d2.launches = d2.tc_launches = 0
    g = graph_mod.StepGraph(step, torch.device("cuda"))
    g.run(steps)
    assert d2.launches == d2.tc_launches == 36 * steps
    assert len(calls) == min(steps, 2)  # the warm-up, then the capture
    assert g.replays == steps - 1 == (0 if g.graph is None else g.graph.replays)
    g.close()
    assert g.graph is None


def test_a_failed_capture_raises_and_never_runs_eagerly(fake_card, monkeypatch):
    d2 = fake_card
    calls = []

    def step():
        calls.append(1)
        d2.launches += 36

    monkeypatch.setattr(_FakeGraph, "fail", True)
    d2.launches = 0
    g = graph_mod.StepGraph(step, torch.device("cuda"))
    with pytest.raises(RuntimeError, match="capturing the decode step as a CUDA graph failed"):
        g.run(3)
    assert len(calls) == 1 and d2.launches == 36 and g.replays == 0


def test_the_cpu_runs_every_step_eagerly():
    calls = []
    g = graph_mod.StepGraph(lambda: calls.append(1), torch.device("cpu"))
    g.run(4)
    assert len(calls) == 4 and g.graph is None and g.replays == 0 and g.steps == 4
