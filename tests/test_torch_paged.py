"""The port's paged pool and PagedEngine (f32, CPU) against the JAX package's
(`time_r1_tpu/sampler/paged.py`) and the port's bucket Engine: the page
allocator, `write_prompt` bit for bit, the decode step's scatter into the
pool, and equal greedy tokens for mixed-length text, video, int8 KV pages,
int8 weights and the chunked-prefill interleave."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_bridge import CFG, JCFG, jax_params, port_params
from time_r1_tpu.sampler import Engine as JaxEngine
from time_r1_tpu.sampler import Request as JaxRequest
from time_r1_tpu.sampler import SamplingParams as JaxSamplingParams
from time_r1_tpu.sampler import paged as jpaged
from time_r1_tpu_torch.sampler import Engine, PagedEngine, Request, SamplingParams
from time_r1_tpu_torch.sampler import paged

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    jp = jax_params()
    return jp, port_params(jp)


def _jax_requests(reqs):
    return [JaxRequest(input_ids=r.input_ids, patches=r.patches, grid_thw=r.grid_thw,
                       second_per_grid_t=r.second_per_grid_t) for r in reqs]


def _text_requests(lengths, seed):
    rng = np.random.default_rng(seed)
    return [Request(input_ids=list(rng.integers(2, 200, int(n)))) for n in lengths]


def _video_request(seed=1):
    """tests/test_paged.py's video request: grid (2, 4, 4), 8 video tokens."""
    rng = np.random.default_rng(seed)
    n_vis = 2 * 2 * 2
    ids = (list(rng.integers(2, 200, 6)) + [CFG.vision_start_token_id] + [CFG.video_token_id] * n_vis
           + [CFG.vision_end_token_id] + list(rng.integers(2, 200, 4)))
    patches = rng.normal(size=(2 * 4 * 4, CFG.vision.patch_input_dim)).astype(np.float32)
    return Request(input_ids=ids, patches=patches, grid_thw=(2, 4, 4), second_per_grid_t=1.0)


def _three_way(params, reqs, sp, paged_kw=None, engine_kw=None):
    """(port PagedEngine, JAX PagedEngine, port Engine) greedy tokens."""
    jp, tp = params
    paged_kw = dict(max_slots=2, max_len=128, page_size=16, **(paged_kw or {}))
    got = PagedEngine(tp, CFG, dtype=torch.float32, device="cpu", **paged_kw).generate(reqs, SamplingParams(**sp))
    want_jax = jpaged.PagedEngine(jp, JCFG, dtype=jnp.float32, **paged_kw).generate(
        _jax_requests(reqs), JaxSamplingParams(**sp))
    want_engine = Engine(tp, CFG, dtype=torch.float32, device="cpu", **(engine_kw or {})).generate(
        reqs, SamplingParams(**sp))
    return got, want_jax, want_engine


def test_allocator_reserves_scratch_page_and_recycles():
    a = paged.PageAllocator(4)
    got = a.alloc(3)
    assert 0 not in got and sorted(got) == [1, 2, 3]
    with pytest.raises(MemoryError):
        a.alloc(1)
    a.release([2])
    assert a.alloc(1) == [2]


def _pools(kv_quant, dtype_t, dtype_j, n_pages=12, P=16, slots=3, max_pages=4):
    return (paged.make_pool(CFG, n_pages, P, slots, max_pages, dtype_t, kv_quant=kv_quant, device="cpu"),
            jpaged.make_pool(JCFG, n_pages, P, slots, max_pages, dtype_j, kv_quant=kv_quant))


def _pool_arrays(pool):
    """Copies of every buffer of a pool (either package's) as f32/int numpy arrays."""
    out = []
    for x in (pool.k, pool.v, pool.page_table, pool.lengths, pool.k_scale, pool.v_scale):
        if x is None:
            continue
        if isinstance(x, torch.Tensor):
            out.append((x.float() if x.is_floating_point() else x).numpy().copy())
        else:
            out.append(np.array(x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x))
    return out


# (slot, prompt length, prompt pages, full table row): slot 2's prompt fills its page exactly
LAYOUT = [(0, 20, [3, 5], [3, 5, 7, 0]), (2, 16, [9], [9, 2, 0, 0])]


def _write_both(tpool, jpool, rng, jax_write=jpaged.write_prompt):
    """The same two f32 prompts into both pools (LAYOUT); returns JAX's pool."""
    t = CFG.text
    for slot, length, pages, row in LAYOUT:
        shape = (t.num_hidden_layers, len(pages) * 16, t.num_key_value_heads, t.head_dim)
        k, v = rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)
        k[:, length:] = v[:, length:] = 0.0  # the right padding of the last prompt page
        paged.write_prompt(tpool, slot, pages, np.array(row, np.int32), torch.from_numpy(k), torch.from_numpy(v),
                           length)
        jpool = jax_write(jpool, jnp.int32(slot), jnp.asarray(pages, jnp.int32), jnp.asarray(row, jnp.int32),
                                    jnp.asarray(k), jnp.asarray(v), jnp.int32(length))
    return jpool


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_write_prompt_is_bit_equal_to_jax(kv_quant):
    """Pages, scales, page table and lengths after two admissions, bit for
    bit: a bf16 pool, and an int8 pool quantized at write time. JAX's
    function runs op by op: under jit, XLA turns quantize_kv's division by
    127 into a product with its reciprocal, which moves some scales by one
    ulp (the decode test below runs the jitted form)."""
    tpool, jpool = _pools(kv_quant, torch.bfloat16, jnp.bfloat16)
    jpool = _write_both(tpool, jpool, np.random.default_rng(0), jpaged.write_prompt.__wrapped__)
    for a, b in zip(_pool_arrays(tpool), _pool_arrays(jpool)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert tpool.lengths.tolist() == [20, 0, 16]


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32", "int8"])
def test_decode_segment_writes_the_cells_jax_writes(params, kv_quant):
    """Two decode steps over a pool holding two prompts and a dead slot whose
    stale table row points at slot 0's pages: the same tokens, steps and done
    flags as JAX's `paged_decode_segment`, and the same cells written. Slot 2
    has one step of budget, so its second step goes to scratch page 0, as the
    dead slot's do; page 0 takes colliding writes and is not compared."""
    jp, tp = params
    tpool, jpool = _pools(kv_quant, torch.float32, jnp.float32)
    jpool = _write_both(tpool, jpool, np.random.default_rng(1))
    tpool.page_table[1] = tpool.page_table[0]
    jpool = jpool._replace(page_table=jpool.page_table.at[1].set(jpool.page_table[0]))
    before, jbefore = _pool_arrays(tpool), _pool_arrays(jpool)
    sp = dict(temperature=0.0, max_new_tokens=8, stop_token_ids=(255,))
    last, start, active, max_steps = [5, 9, 7], [20, 0, 16], [True, False, True], [4, 0, 1]
    toks, last_t, steps_t, done_t = paged.paged_decode_segment(
        tp, tpool, CFG, 2, SamplingParams(**sp), torch.tensor(last), torch.tensor(start), torch.zeros(3, dtype=torch.long),
        torch.tensor(active), torch.tensor(max_steps), None)
    jpool, jtoks, jlast, jsteps, jdone = jpaged.paged_decode_segment(
        jp, jpool, JCFG, 2, JaxSamplingParams(**sp), jnp.asarray(last, jnp.int32), jnp.asarray(start, jnp.int32),
        jnp.zeros(3, jnp.int32), jnp.asarray(active), jnp.asarray(max_steps, jnp.int32), jnp.zeros(2, jnp.uint32))
    assert toks.tolist() == np.asarray(jtoks).tolist()
    assert (last_t.tolist(), steps_t.tolist(), done_t.tolist()) == (
        np.asarray(jlast).tolist(), np.asarray(jsteps).tolist(), np.asarray(jdone).tolist())
    assert steps_t.tolist() == [2, 0, 1] and tpool.lengths.tolist() == [22, 0, 17]
    for a, b, a0, b0 in zip(_pool_arrays(tpool), _pool_arrays(jpool), before, jbefore):
        if a.ndim >= 4:  # pages (L, Hkv, n_pages, P[, hd]) and scales: page 0 is the scratch sink
            a, b, a0, b0 = a[:, :, 1:], b[:, :, 1:], a0[:, :, 1:], b0[:, :, 1:]
            # the cells written: slot 0 at page 5 offsets 4 and 5, slot 2 at page 2 offset 0
            want = np.zeros(a.shape[:4], bool)
            want[:, :, 4, 4:6] = want[:, :, 1, 0] = True
            for x, x0 in ((a, a0), (b, b0)):
                np.testing.assert_array_equal((x != x0).reshape(*a.shape[:4], -1).any(-1), want)
        # int8 values can sit one apart where the f32 K/V of the two packages
        # straddle a rounding boundary
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1.0 if a.dtype == np.int8 else 1e-5)


def test_paged_matches_jax_and_bucket_greedy(params):
    """Five heterogeneous prompts through two slots (recycling slots and
    pages), page size 16 (tests/test_paged.py:21)."""
    reqs = _text_requests((9, 33, 17, 25, 12), seed=0)
    sp = dict(temperature=0.0, max_new_tokens=6, stop_token_ids=CFG.stop_token_ids)
    got, want_jax, want_engine = _three_way(params, reqs, sp)
    assert got == want_jax == want_engine


def test_paged_with_video(params):
    sp = dict(temperature=0.0, max_new_tokens=5, stop_token_ids=CFG.stop_token_ids)
    got, want_jax, want_engine = _three_way(params, [_video_request()], sp)
    assert got == want_jax == want_engine and len(got[0]) >= 1


def test_paged_int8_kv_matches_jax_and_bucket_int8_kv(params):
    """int8 pages with per-(token, head) scales: the JAX int8-KV PagedEngine
    and the port's bucket Engine over its int8 KV cache."""
    reqs = _text_requests((9, 33, 17, 25), seed=2)
    sp = dict(temperature=0.0, max_new_tokens=6, stop_token_ids=CFG.stop_token_ids)
    got, want_jax, want_engine = _three_way(params, reqs, sp, dict(kv_cache_quant=True), dict(kv_cache_quant=True))
    assert got == want_jax == want_engine


def test_paged_int8_weights_match_jax_and_bucket(params):
    reqs = _text_requests((9, 33, 17), seed=3) + [_video_request(4)]
    sp = dict(temperature=0.0, max_new_tokens=6, stop_token_ids=CFG.stop_token_ids)
    got, want_jax, want_engine = _three_way(params, reqs, sp, dict(quantization="int8"),
                                            dict(quantization="int8"))
    assert got == want_jax == want_engine


def test_chunked_prefill_interleaves_decode(params):
    """A 600-token prompt behind two short ones, prefilled in 256-token
    chunks (tests/test_paged.py:88): with the interleave on, resident slots
    decode between its chunks (the engine's counter sees at least one segment
    inside an admission), and the tokens equal the interleave-off engine's
    and the bucket Engine's."""
    _, tp = params
    rng = np.random.default_rng(4)
    reqs = [Request(input_ids=list(rng.integers(2, 200, 12))) for _ in range(2)]
    reqs.append(Request(input_ids=list(rng.integers(2, 200, 600))))
    bucket = Engine(tp, CFG, dtype=torch.float32, device="cpu")
    # a stop token early in row 1's continuation but not early in the others':
    # row 1 retires first, so a slot is resident when the long prompt arrives
    raw = bucket.generate(reqs, SamplingParams(temperature=0.0, max_new_tokens=24, stop_token_ids=(10_000,)))
    stop_tok = next(t for t in raw[1][3:10] if t not in raw[0][:20] and t not in raw[2][:20])
    sp = SamplingParams(temperature=0.0, max_new_tokens=24, stop_token_ids=(stop_tok,), seed=0)
    want = bucket.generate(reqs, sp)
    assert len(want[1]) < 12 <= len(want[0])

    out = {}
    for interleave in (False, True):
        eng = PagedEngine(tp, CFG, max_slots=2, max_len=1024, page_size=16, dtype=torch.float32,
                          prefill_chunk_tokens=256, segment=4, interleave_decode=interleave, device="cpu")
        out[interleave] = (eng.generate(reqs, sp), dict(eng.timings))
    assert out[False][0] == want and out[True][0] == want
    assert out[False][1]["interleaved_segments"] == 0
    assert out[True][1]["interleaved_segments"] >= 1, out[True][1]
    tm = out[True][1]
    assert tm["decode_steps"] == 4 * tm["segments"]
    # the 600-token prompt is one admission of bucket 1024: four 256-token chunks
    assert (1, 1024, False) in tm["admissions"]


def test_side_path_lora_is_not_ported(params):
    eng = PagedEngine(params[1], CFG, max_slots=2, max_len=128, page_size=16, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        eng.set_lora_side({}, 1.0)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paged.make_pool(CFG, 4, 16, 2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedEngine(port_params(jax_params()), CFG)
