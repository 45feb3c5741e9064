"""The port's Engine (f32, CPU) against the JAX Engine (f32): equal greedy
tokens for text and video requests, with repetition penalty and with small
prefill chunks; last-position logits; the decode position convention; and
the sampling modes on their own."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_bridge import CFG, JCFG, jax_params, port_params
from time_r1_tpu.sampler import Engine as JaxEngine
from time_r1_tpu.sampler import Request as JaxRequest
from time_r1_tpu.sampler import SamplingParams as JaxSamplingParams
from time_r1_tpu_torch.models.qwen25vl import forward, get_rope_index
from time_r1_tpu_torch.sampler import Engine, Request, SamplingParams
from time_r1_tpu_torch.sampler.engine import sample_tokens

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def engines():
    jp = jax_params()
    tp = port_params(jp)
    return JaxEngine(jp, JCFG, dtype=jnp.float32), Engine(tp, CFG, dtype=torch.float32, device="cpu"), tp


def _video(rng, grid):
    t, h, w = grid
    n_vis = t * h * w // CFG.vision.merge_unit
    ids = ([CFG.vision_start_token_id] + [CFG.video_token_id] * n_vis + [CFG.vision_end_token_id])
    patches = rng.normal(size=(t * h * w, CFG.vision.patch_input_dim)).astype(np.float32)
    return ids, patches


def _both(reqs):
    """The same requests for both engines."""
    jax_reqs = [JaxRequest(input_ids=r.input_ids, patches=r.patches, grid_thw=r.grid_thw,
                           second_per_grid_t=r.second_per_grid_t) for r in reqs]
    return jax_reqs, reqs


def _generate_both(engines, reqs, **sp):
    jeng, teng, _ = engines
    jreqs, treqs = _both(reqs)
    want = jeng.generate(jreqs, JaxSamplingParams(**sp))
    got = teng.generate(treqs, SamplingParams(**sp))
    return got, want


def _text_requests():
    rng = np.random.default_rng(11)
    return [Request(input_ids=list(rng.integers(2, 200, n))) for n in (9, 14, 5)]


def _video_requests(two_videos: bool):
    """The video request of tests/test_engine.py:64-80, and a two-video batch."""
    rng = np.random.default_rng(5)
    vid, patches = _video(rng, (2, 4, 4))
    reqs = [Request(input_ids=list(rng.integers(2, 200, 4)) + vid + list(rng.integers(2, 200, 3)),
                    patches=patches, grid_thw=(2, 4, 4), second_per_grid_t=1.0)]
    if two_videos:
        vid2, patches2 = _video(rng, (2, 6, 2))
        reqs.append(Request(input_ids=list(rng.integers(2, 200, 7)) + vid2 + list(rng.integers(2, 200, 2)),
                            patches=patches2, grid_thw=(2, 6, 2), second_per_grid_t=0.5))
    return reqs


def test_greedy_text_prompts_match_jax(engines):
    got, want = _generate_both(engines, _text_requests(), temperature=0.0, max_new_tokens=8,
                               stop_token_ids=CFG.stop_token_ids)
    assert got == want


@pytest.mark.parametrize("two_videos", [False, True])
def test_greedy_video_requests_match_jax(engines, two_videos):
    got, want = _generate_both(engines, _video_requests(two_videos), temperature=0.0,
                               max_new_tokens=6, stop_token_ids=CFG.stop_token_ids)
    assert got == want and all(len(g) >= 1 for g in got)


def test_repetition_penalty_matches_jax(engines):
    got, want = _generate_both(engines, _text_requests()[:2], temperature=0.0, max_new_tokens=10,
                               stop_token_ids=(), repetition_penalty=1.3)
    assert got == want


def test_small_prefill_chunks_match_jax(engines):
    jeng, _, tp = engines
    reqs = _video_requests(True)
    reqs[0] = replace(reqs[0], input_ids=list(range(2, 150)) + reqs[0].input_ids)
    sp = dict(temperature=0.0, max_new_tokens=5, stop_token_ids=CFG.stop_token_ids)
    want = jeng.generate(_both(reqs)[0], JaxSamplingParams(**sp))
    chunked = Engine(tp, CFG, dtype=torch.float32, prefill_chunk_tokens=128, device="cpu")
    assert chunked.generate(reqs, SamplingParams(**sp)) == want


def test_last_token_logits_match_jax(engines):
    jeng, teng, _ = engines
    reqs = _video_requests(True) + _text_requests()[:1]
    jreqs, treqs = _both(reqs)
    np.testing.assert_allclose(teng.last_token_logits(treqs), jeng.last_token_logits(jreqs),
                               rtol=1e-4, atol=1e-4)


def test_top_k_one_is_greedy(engines):
    _, teng, _ = engines
    reqs = _text_requests()
    greedy = teng.generate(reqs, SamplingParams(temperature=0.0, max_new_tokens=6, stop_token_ids=()))
    top1 = teng.generate(reqs, SamplingParams(temperature=1.0, top_k=1, max_new_tokens=6,
                                              stop_token_ids=(), seed=7))
    assert top1 == greedy


def test_decode_positions_match_full_forward(engines):
    """Feeding generated token t at rope position start_pos + t through the
    cached forward reproduces the no-cache forward's logits at that row."""
    _, teng, tp = engines
    rng = np.random.default_rng(21)
    prompt = list(rng.integers(2, 200, 9))
    cont = [11, 23, 35]
    ids_full = np.asarray([prompt + cont], np.int64)
    pos_full, _ = get_rope_index(CFG, ids_full, attention_mask=np.ones_like(ids_full))
    logits_full, _ = forward(tp, CFG, torch.from_numpy(ids_full), torch.from_numpy(pos_full))
    ids, mask, pos, start, vis, S, max_len = teng._pack([Request(input_ids=prompt)], extra_len=len(cont))
    fl, cache, mask_t = teng._prefill(ids, mask, pos, vis, S, max_len)
    np.testing.assert_allclose(fl[0].numpy(), logits_full[0, len(prompt) - 1].numpy(), rtol=2e-5, atol=2e-5)
    for t, tok in enumerate(cont):
        pos3 = torch.full((3, 1, 1), int(start[0]) + t)
        lg, cache = forward(tp, CFG, torch.tensor([[tok]]), pos3, attention_mask=mask_t, cache=cache)
        np.testing.assert_allclose(lg[0, -1].numpy(), logits_full[0, len(prompt) + t].numpy(),
                                   rtol=3e-5, atol=3e-5, err_msg=f"decode step {t}")


def test_sample_tokens_distribution():
    """Temperature sampling draws from softmax(logits / T); a zero-probability
    token is never drawn; top-k / top-p keep only the allowed tokens."""
    p = torch.tensor([[0.5, 0.25, 0.125, 0.125, 0.0]])
    logits = torch.where(p > 0, p.clamp_min(1e-30).log(), torch.tensor(float("-inf"))).repeat(4000, 1)
    gen = torch.Generator().manual_seed(0)
    draws = sample_tokens(logits, gen, SamplingParams(temperature=1.0))
    freq = torch.bincount(draws, minlength=5).double() / len(draws)
    assert freq[4] == 0
    np.testing.assert_allclose(freq[:4].numpy(), [0.5, 0.25, 0.125, 0.125], atol=0.03)
    top2 = sample_tokens(logits, gen, SamplingParams(temperature=1.0, top_k=2))
    assert set(top2.tolist()) == {0, 1}
    top_p = sample_tokens(logits, gen, SamplingParams(temperature=1.0, top_p=0.6))
    assert set(top_p.tolist()) == {0, 1}
    flat = sample_tokens(logits, gen, SamplingParams(temperature=100.0))
    assert torch.bincount(flat, minlength=5)[4] == 0


def test_unported_options_raise(engines):
    """Quantized serving is ported; an unknown `quantization` name fails as
    the JAX Engine's dict lookup does, with a KeyError."""
    jeng, teng, tp = engines
    with pytest.raises(KeyError):
        JaxEngine(jeng.params, JCFG, dtype=jnp.float32, quantization="int3")
    with pytest.raises(KeyError):
        Engine(tp, CFG, device="cpu", quantization="int3")


@pytest.fixture(scope="module")
def quantized_engines():
    """Both packages' engines over the same weights, quantized by each
    (bit-equal values and scales), with the int8 KV cache."""
    jp = jax_params()
    tp = port_params(jp)
    out = {}
    for quant in ("int8", "int4"):
        out[quant] = (
            JaxEngine(jp, JCFG, dtype=jnp.float32, quantization=quant, kv_cache_quant=True),
            Engine(tp, CFG, dtype=torch.float32, device="cpu", quantization=quant, kv_cache_quant=True),
        )
    return out


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_greedy_matches_jax(quantized_engines, quant):
    jeng, teng = quantized_engines[quant]
    assert teng.params["text"]["layers"][0]["gu"]["q8" if quant == "int8" else "q4"] is not None
    reqs = _text_requests() + _video_requests(False)
    sp = dict(temperature=0.0, max_new_tokens=8, stop_token_ids=CFG.stop_token_ids)
    want = jeng.generate(_both(reqs)[0], JaxSamplingParams(**sp))
    assert teng.generate(reqs, SamplingParams(**sp)) == want
