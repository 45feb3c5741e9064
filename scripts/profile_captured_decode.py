#!/usr/bin/env python3
"""Where a captured decode step's device time goes, at full size on the card:
Qwen2.5-VL-3B in bf16 with seeded random weights, 16 steady decode steps
(steps 32-47, one host-check segment) of four decodes, each captured, under
torch.profiler (`chip_smoke.settled_window`):

- the G-way rollout (phase 5's request, G = 8, bf16: D2);
- the same over int8 weights and int8 KV (phase 6's rollout: D2, Q2);
- serving at G = 1 (phase 4's two video requests);
- PagedEngine over four text prompts in four slots (phase 7 (a)'s step: P1).

For each: the device span, busy time and idle share, the device time by
kernel name (the top names and the sum of the rest), and by kind: cuBLAS's
products (`nvjet*`, `*gemm*`, `*gemv*`), the port's hand-written kernels
(`t1::`, and Q1's and Q2's kernels by name) and the rest, PyTorch's own
kernels (elementwise, copies, reductions, indexing). Needs a CUDA device and
nvcc; exits 2 without a card.

    python3 scripts/profile_captured_decode.py
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")  # as chip_smoke.py's main

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from chip_smoke import log, settled_window, text_request, video_request  # noqa: E402


HAND_WRITTEN = ("t1::", "fused_mlp_tc", "int4_mm_tc")


def kind(name: str) -> str:
    low = name.lower()
    if low.startswith("nvjet") or "gemm" in low or "gemv" in low:
        return "cublas"
    return "hand-written" if any(h in name for h in HAND_WRITTEN) else "pytorch"


def profile(tag: str, run) -> dict:
    """run() once to warm up, then inside 16-step windows until two agree
    (`settled_window`)."""
    run()
    win, _ = settled_window(run, first=32, count=16)
    st = win.stats()
    by = {}
    for name, a, b in win.events:
        n, us = by.get(name, (0, 0.0))
        by[name] = (n + 1, us + b - a)
    ranked = sorted(by.items(), key=lambda kv: -kv[1][1])
    top = [(name[:90], n // 16, round(us / 16e3, 4)) for name, (n, us) in ranked[:14]]
    rest = sum(us for _, (_, us) in ranked[14:]) / 16e3
    log(f"[{tag}] a step: span {st['span_ms'] / 16:.3f} ms, busy {st['busy_ms'] / 16:.3f} ms, idle share "
        f"{st['idle_share']:.4f}, {st['device_events'] / 16:.0f} device events")
    for name, n, ms in top:
        log(f"[{tag}]   {ms:.4f} ms a step in {n} launches: {name}")
    log(f"[{tag}]   {rest:.4f} ms a step in the other {len(ranked) - 14} kernel names")
    kinds = {}
    for name, (n, us) in by.items():
        k = kinds.setdefault(kind(name), [0, 0.0])
        k[0] += n / 16
        k[1] += us / 16e3
    log(f"[{tag}] by kind, a step (launches, ms): "
        f"{ {k: (round(n), round(ms, 4)) for k, (n, ms) in sorted(kinds.items())} }")
    return dict(step=st, top=top, rest_ms=rest, kinds=kinds)


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.sampler import Engine, PagedEngine, SamplingParams

    card = chip_smoke.card_line()
    t0 = time.perf_counter()
    chip_smoke.phase_build()
    cfg = Qwen25VLConfig.qwen25vl_3b()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    videos = [video_request(cfg, rng, 32, 224, 392), video_request(cfg, rng, 24, 280, 336)]
    rollout = SamplingParams(temperature=1.0, max_new_tokens=64, stop_token_ids=(), num_return_sequences=8, seed=0)
    out = {}
    with torch.no_grad():
        eng = Engine(params, cfg, dtype=torch.bfloat16, device="cuda")
        out["rollout bf16"] = profile("rollout bf16", lambda: eng.generate(videos[:1], rollout))
        out["serving G = 1"] = profile("serving G = 1", lambda: eng.generate(
            videos, SamplingParams(max_new_tokens=64, stop_token_ids=())))
        del eng
        gc.collect()
        eng = Engine(params, cfg, dtype=torch.bfloat16, device="cuda", quantization="int8", kv_cache_quant=True)
        out["rollout int8"] = profile("rollout int8", lambda: eng.generate(videos[:1], rollout))
        del eng
        gc.collect()
        paged = PagedEngine(params, cfg, max_slots=4, max_len=4096, page_size=128, prefill_chunk_tokens=1024,
                            dtype=torch.bfloat16, device="cuda")
        trng = np.random.default_rng(0)
        texts = [text_request(cfg, trng, n) for n in (200, 450, 900, 1800)]
        out["paged (a)"] = profile("paged (a)", lambda: paged.generate(
            texts, SamplingParams(max_new_tokens=64, stop_token_ids=())))
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
