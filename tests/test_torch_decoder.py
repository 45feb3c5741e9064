"""The port's decoder against the JAX `decoder_forward`: hidden states and
logits without a cache and through cached chunks, with the flash branch forced
(its plain version on CPU) and not; chunked prefill against the unchunked
forward (mirroring tests/test_chunked_prefill.py); M-RoPE positions."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_bridge import CFG, JCFG, jax_params, port_params
from time_r1_tpu.models.qwen25vl import KVCache as JaxKVCache
from time_r1_tpu.models.qwen25vl import get_rope_index as jax_get_rope_index
from time_r1_tpu.models.qwen25vl.language import decoder_forward as jax_decoder_forward
from time_r1_tpu.models.qwen25vl.language import lm_logits as jax_lm_logits
from time_r1_tpu.models.qwen25vl.language import mrope_cos_sin as jax_mrope_cos_sin
from time_r1_tpu_torch.models.qwen25vl import (
    KVCache,
    decoder_forward,
    get_rope_index,
    lm_logits,
    mrope_cos_sin,
)
from time_r1_tpu_torch.ops.flash_attention import flash_attention_fwd
from time_r1_tpu_torch.sampler import Engine, Request, SamplingParams

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def params():
    jp = jax_params()
    return jp, port_params(jp)


def _batch(B=2, S=24, pads=(0, 5), seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(B, S, CFG.text.hidden_size)).astype(np.float32)
    mask = np.ones((B, S), np.int64)
    for b, p in enumerate(pads):
        mask[b, :p] = 0
    pos, _ = jax_get_rope_index(JCFG, np.ones((B, S), np.int64), attention_mask=mask)
    return hidden, mask, pos


def test_mrope_cos_sin_matches_jax():
    pos = np.random.default_rng(1).integers(0, 300, size=(3, 2, 17)).astype(np.int32)
    jc, js = jax_mrope_cos_sin(JCFG.text, jnp.asarray(pos))
    tc, ts = mrope_cos_sin(CFG.text, torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


@pytest.mark.parametrize("use_flash,sliding", [(None, False), (True, False), (None, True)])
def test_decoder_no_cache_matches_jax(params, use_flash, sliding):
    jp, tp = params
    jcfg, cfg = JCFG.text, CFG.text
    if sliding:
        jcfg = replace(jcfg, use_sliding_window=True, sliding_window=6, max_window_layers=1)
        cfg = replace(cfg, use_sliding_window=True, sliding_window=6, max_window_layers=1)
    hidden, mask, pos = _batch()
    jh, _ = jax_decoder_forward(jp["text"], jcfg, jnp.asarray(hidden), jnp.asarray(pos),
                                attention_mask=jnp.asarray(mask))
    th, _ = decoder_forward(tp["text"], cfg, torch.from_numpy(hidden), torch.from_numpy(pos),
                            attention_mask=torch.from_numpy(mask), use_flash=use_flash)
    valid = mask.astype(bool)
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid], **TOL)
    jl = np.asarray(jax_lm_logits(jp["text"], jcfg, jh))
    tl = lm_logits(tp["text"], cfg, th).numpy()
    np.testing.assert_allclose(tl[valid], jl[valid], **TOL)


@pytest.mark.parametrize("use_flash", [None, True])
def test_decoder_cached_chunks_match_jax(params, use_flash):
    """Two prefill chunks then one decode step through the static cache: the
    hidden states of every call and the written cache agree with JAX."""
    jp, tp = params
    B, S1, S2, max_len = 2, 32, 16, 64
    hidden, mask_p, pos = _batch(B, S1 + S2 + 1, pads=(0, 7), seed=3)
    mask = np.ones((B, max_len), np.int64)
    mask[:, : S1 + S2 + 1] = mask_p
    jcache = JaxKVCache.zeros(JCFG.text, B, max_len, dtype=jnp.float32)
    tcache = KVCache.zeros(CFG.text, B, max_len, dtype=torch.float32, device="cpu")
    flash_attention_fwd.launches = 0
    for c0, c1 in ((0, S1), (S1, S1 + S2), (S1 + S2, S1 + S2 + 1)):
        jh, jcache = jax_decoder_forward(
            jp["text"], JCFG.text, jnp.asarray(hidden[:, c0:c1]), jnp.asarray(pos[:, :, c0:c1]),
            attention_mask=jnp.asarray(mask), cache=jcache,
        )
        th, tcache = decoder_forward(
            tp["text"], CFG.text, torch.from_numpy(hidden[:, c0:c1]), torch.from_numpy(pos[:, :, c0:c1]),
            attention_mask=torch.from_numpy(mask), cache=tcache,
            use_flash=use_flash if c1 - c0 > 1 else None,
        )
        assert tcache.length == int(jcache.length) == c1
        valid = mask[:, c0:c1].astype(bool)
        np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid], **TOL)
    assert flash_attention_fwd.launches == 0
    written = mask[:, : S1 + S2 + 1].astype(bool)
    for a, b in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        np.testing.assert_allclose(a.numpy()[:, :, : S1 + S2 + 1][:, written],
                                   np.asarray(b)[:, :, : S1 + S2 + 1][:, written], **TOL)


def test_cached_prefill_equals_no_cache_forward(params):
    """Prefill in three chunks through the cache (flash branch forced) ==
    one no-cache forward over the whole prompt."""
    _, tp = params
    hidden, mask, pos = _batch(2, 48, pads=(3, 11), seed=4)
    h_full, _ = decoder_forward(tp["text"], CFG.text, torch.from_numpy(hidden), torch.from_numpy(pos),
                                attention_mask=torch.from_numpy(mask))
    cache = KVCache.zeros(CFG.text, 2, 48, dtype=torch.float32, device="cpu")
    parts = []
    for c0, c1 in ((0, 16), (16, 32), (32, 48)):
        h, cache = decoder_forward(tp["text"], CFG.text, torch.from_numpy(hidden[:, c0:c1]),
                                   torch.from_numpy(pos[:, :, c0:c1]), attention_mask=torch.from_numpy(mask),
                                   cache=cache, use_flash=True)
        parts.append(h)
    valid = mask.astype(bool)
    np.testing.assert_allclose(torch.cat(parts, 1).numpy()[valid], h_full.numpy()[valid], **TOL)


def test_lm_logits_tied_head_matches_jax(params):
    jp, tp = params
    h = np.random.default_rng(5).normal(size=(2, 3, CFG.text.hidden_size)).astype(np.float32)
    jcfg = replace(JCFG.text, tie_word_embeddings=True)
    cfg = replace(CFG.text, tie_word_embeddings=True)
    want = np.asarray(jax_lm_logits(jp["text"], jcfg, jnp.asarray(h)))
    got = lm_logits(tp["text"], cfg, torch.from_numpy(h))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_get_rope_index_equals_jax():
    rng = np.random.default_rng(6)
    grids = np.array([[2, 4, 4], [4, 4, 2]], np.int64)
    n1, n2 = 2 * 2 * 2, 4 * 2 * 1

    def video(n):
        return [CFG.vision_start_token_id] + [CFG.video_token_id] * n + [CFG.vision_end_token_id]

    row0 = list(rng.integers(2, 200, 5)) + video(n1) + list(rng.integers(2, 200, 3))
    row1 = list(rng.integers(2, 200, 2)) + video(n2) + list(rng.integers(2, 200, 7))
    S = max(len(row0), len(row1))
    ids = np.zeros((2, S), np.int64)
    mask = np.zeros((2, S), np.int64)
    for i, r in enumerate((row0, row1)):
        ids[i, S - len(r):], mask[i, S - len(r):] = r, 1
    spg = [0.5, 1.5]  # fractional: the vLLM float semantics
    a, da = jax_get_rope_index(JCFG, ids, video_grid_thw=grids, second_per_grid_ts=spg, attention_mask=mask)
    b, db = get_rope_index(CFG, ids, video_grid_thw=grids, second_per_grid_ts=spg, attention_mask=mask)
    assert np.array_equal(a, b) and np.array_equal(da, db)


def test_chunked_prefill_equals_single_shot(params):
    """Mirror of tests/test_chunked_prefill.py on the port: splitting the
    prompt into 64-token prefill chunks reproduces single-shot generation,
    with vision features landing in the right chunk rows."""
    _, tp = params
    rng = np.random.default_rng(2)
    n_vis = 2 * 2 * 2
    reqs = [
        Request(input_ids=list(rng.integers(2, 200, 150))),
        Request(
            input_ids=(list(rng.integers(2, 200, 100)) + [CFG.vision_start_token_id]
                       + [CFG.video_token_id] * n_vis + [CFG.vision_end_token_id]
                       + list(rng.integers(2, 200, 40))),
            patches=rng.normal(size=(2 * 4 * 4, CFG.vision.patch_input_dim)).astype(np.float32),
            grid_thw=(2, 4, 4),
        ),
    ]
    sp = SamplingParams(temperature=0.0, max_new_tokens=5, stop_token_ids=CFG.stop_token_ids)
    single = Engine(tp, CFG, dtype=torch.float32, prefill_chunk_tokens=8192, device="cpu")
    chunked = Engine(tp, CFG, dtype=torch.float32, prefill_chunk_tokens=64, device="cpu")
    assert single.generate(reqs, sp) == chunked.generate(reqs, sp)
    np.testing.assert_allclose(single.last_token_logits(reqs), chunked.last_token_logits(reqs), **TOL)
