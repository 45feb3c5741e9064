#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`time_r1_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check raises and the exit code is non-zero):
1. build every kernel under time_r1_tpu_torch/csrc (one nvcc each, in parallel);
2. hold each kernel against its plain PyTorch version on the card, at the
   serving path's shapes, in bf16 and f32, and time kernel, plain version and
   one library call (`scaled_dot_product_attention`, a yardstick the port never
   calls);
3. end-to-end agreement at reduced depth: Qwen2.5-VL-3B widths with 2 decoder
   layers and 2 vision blocks, one 8-frame video request in f32, card
   (kernels) against CPU (plain versions);
4. the serving path at full size: Qwen2.5-VL-3B in bf16 with seeded random
   weights, two video requests, greedy decode of 128 tokens, with every
   kernel's launch count read around that one generate() call.

The last three lines are the card's name and power limit (nvidia-smi), the
kernels JSON line and the result JSON line. Without a CUDA device, or without
the package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # max |kernel - plain| on valid rows
LOGIT_TOL = 2e-3  # phase 3: f32 last-position logits, card vs CPU


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of fn() over `iters` launches (CUDA events, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1
def phase_build() -> None:
    from time_r1_tpu_torch import kernels

    t0 = time.perf_counter()
    logs = kernels.build()
    log(f"[build] {len(logs)} sources rebuilt in {time.perf_counter() - t0:.1f} s")
    for stem, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {stem}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2
def serving_grids():
    return [(16, 16, 28), (12, 20, 24)]  # 32 frames 224x392, 24 frames 280x336


def check_kernel(name, kernel, plain, library, make_inputs, valid, flops, nbytes, timed=True):
    """Kernel vs plain version in bf16 and f32 on the same inputs (the plain
    version computes in f32 on the kernel's inputs); times in bf16."""
    import torch

    def upcast(a):
        return a.float() if isinstance(a, torch.Tensor) and a.is_floating_point() else a

    entry = {"name": name}
    for dtype in (torch.bfloat16, torch.float32):
        args = make_inputs(dtype)
        got = kernel(*args)
        want = plain(*[upcast(a) for a in args])
        torch.cuda.synchronize()
        err = (got.float() - want.float())[valid].abs().max().item()
        key = str(dtype).split(".")[-1]
        if not np.isfinite(err) or err > TOL[key]:
            raise AssertionError(f"{name} {key}: max |kernel - plain| = {err} > {TOL[key]}")
        entry["max_abs_err" if dtype is torch.bfloat16 else "max_abs_err_f32"] = err
        log(f"[kernels] {name} {key}: max |kernel - plain| on valid rows = {err:.3e} (tol {TOL[key]})")
        if dtype is torch.bfloat16 and timed:
            entry["ms"] = entry["kernel_ms"] = cuda_ms(lambda: kernel(*args))
            entry["plain_ms"] = cuda_ms(lambda: plain(*args), iters=3)
            lib = library(*args)
            entry["library_ms"] = cuda_ms(lib)
            entry["bound_ms"], entry["bound_by"] = bound(flops, nbytes)
    entry["tol"], entry["tol_f32"] = TOL["bfloat16"], TOL["float32"]
    return entry


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, prepare_vision_inputs
    from time_r1_tpu_torch.models.qwen25vl.vision import vision_rope_tables
    from time_r1_tpu_torch.ops.attention import NEG_INF
    from time_r1_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_plain
    from time_r1_tpu_torch.ops.vision_attention import (
        full_attention_rope,
        full_attention_rope_plain,
        window_attention_rope,
        window_attention_rope_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    # K1 at the prefill shape of phase 4: two left-padded prompts in a
    # 2048-token bucket, a 2176-slot cache (128 decode slots)
    B, Sq, Skv, H, Hkv, D = 2, 2048, 2176, 16, 2, 128
    pads = torch.tensor([134, 486], device=dev)
    kv_bias = torch.where(torch.arange(Skv, device=dev)[None] < pads[:, None], NEG_INF, 0.0).float()
    for q_offset in (0, 128):
        rows = q_offset + torch.arange(Sq, device=dev)
        valid = (rows[None, :] >= pads[:, None])  # (B, Sq): rows that see a real key
        allowed = ((torch.arange(Skv, device=dev)[None, :] <= rows[:, None])[None]
                   & (kv_bias[:, None, :] == 0) & valid[:, :, None])
        pairs = allowed.sum().item()
        live_q = valid.sum().item()  # q read, out and lse written
        live_kv = allowed.any(1).sum().item()  # (b, key) read by some valid row

        def inputs(dtype, q_offset=q_offset):
            q, k, v = randn(B, Sq, H, D, dtype=dtype), randn(B, Skv, Hkv, D, dtype=dtype), randn(B, Skv, Hkv, D, dtype=dtype)
            return q, k, v, kv_bias, True, None, q_offset

        def library(q, k, v, kv_bias, causal, scale, q_offset, allowed=allowed):
            mask = torch.where(allowed | ~valid[:, :, None], 0.0, NEG_INF).to(q.dtype)[:, None]
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

        nbytes = (2 * live_q * H * D + 2 * live_kv * Hkv * D) * 2 + B * Skv * 4 + live_q * H * 4
        entry = check_kernel(
            "flash_attention", lambda *a: flash_attention_fwd(*a)[0],
            lambda *a: flash_attention_plain(*a)[0], library, inputs, valid,
            flops=4.0 * pairs * H * D, nbytes=nbytes, timed=q_offset == 0,
        )
        if q_offset == 0:  # the main path's shape: the entry that is timed
            results["flash_attention"] = entry
        else:  # the second chunk of a chunked prefill: checked, not timed
            results["flash_attention"][f"q_offset_{q_offset}"] = {
                k: entry[k] for k in ("max_abs_err", "max_abs_err_f32")
            }

    # K2 and K3 on the padded-window layout of the two phase-4 videos
    vcfg = Qwen25VLConfig.qwen25vl_3b().vision
    prep = prepare_vision_inputs(serving_grids(), vcfg)
    nh, hd = vcfg.num_heads, vcfg.head_dim
    win = vcfg.window_patches**2 * vcfg.merge_unit
    key_valid = torch.from_numpy(prep.key_valid).to(dev)
    cos, sin = vision_rope_tables(vcfg, torch.from_numpy(prep.pos_hw).to(dev))
    key_bias = torch.where(key_valid, 0.0, NEG_INF).float()
    P = key_valid.shape[0]
    per_win = key_valid.reshape(-1, win).sum(1).double()
    # Bytes over live rows only, as the FLOPs count live (query, key) pairs:
    # q/k/v read and out written in bf16, cos/sin read in f32, and the bias
    # of every row read once. Dead rows are never keys and their outputs are dropped.
    live = key_valid.sum().item()
    vbytes = 4 * live * nh * hd * 2 + 2 * live * hd * 4 + P * 4

    def win_inputs(dtype):
        return (randn(P, nh, hd, dtype=dtype), randn(P, nh, hd, dtype=dtype), randn(P, nh, hd, dtype=dtype),
                cos, sin, key_bias, win)

    def win_library(q, k, v, cos, sin, key_bias, win):
        qt, kt, vt = (t.reshape(-1, win, nh, hd).transpose(1, 2) for t in (q, k, v))
        mask = key_bias.reshape(-1, 1, 1, win).to(q.dtype)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    results["window_attention_rope"] = check_kernel(
        "window_attention_rope", window_attention_rope, window_attention_rope_plain, win_library,
        win_inputs, key_valid, flops=4.0 * (per_win**2).sum().item() * nh * hd, nbytes=vbytes,
    )

    n_slices, S = prep.full_gather.shape
    fg = torch.from_numpy(prep.full_gather).to(dev).long()
    pad = fg < 0
    fgs = fg.clamp_min(0).reshape(-1)
    full_bias = (key_bias[fgs].reshape(n_slices, S) + torch.where(pad, NEG_INF, 0.0)).contiguous()
    cos_f, sin_f = cos[fgs].reshape(n_slices, S, hd), sin[fgs].reshape(n_slices, S, hd)
    per_slice = (full_bias == 0).sum(1).double()
    live_f = (full_bias == 0).sum().item()  # live rows; -1 sentinels and dead patches excluded
    fbytes = 4 * live_f * nh * hd * 2 + 2 * live_f * hd * 4 + n_slices * S * 4

    def full_inputs(dtype):
        shape = (n_slices, S, nh, hd)
        return randn(*shape, dtype=dtype), randn(*shape, dtype=dtype), randn(*shape, dtype=dtype), cos_f, sin_f, full_bias

    def full_library(q, k, v, cos, sin, bias):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = bias[:, None, None, :].to(q.dtype)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    results["full_attention_rope"] = check_kernel(
        "full_attention_rope", full_attention_rope, full_attention_rope_plain, full_library,
        full_inputs, full_bias == 0, flops=4.0 * (per_slice**2).sum().item() * nh * hd, nbytes=fbytes,
    )
    return results


# ---------------------------------------------------------------------------
# phases 3 and 4
def video_request(cfg, rng, frames: int, height: int, width: int, n_text: int = 120):
    from time_r1_tpu_torch.models.processor import patchify_video
    from time_r1_tpu_torch.sampler import Request

    pixels = rng.integers(0, 256, size=(frames, 3, height, width), dtype=np.uint8)
    patches, grid = patchify_video(pixels.astype(np.float32))
    n_vis = grid[0] * grid[1] * grid[2] // cfg.vision.merge_unit
    text = rng.integers(0, min(cfg.vision_start_token_id, cfg.text.vocab_size), size=n_text).tolist()
    ids = (text[: n_text // 2] + [cfg.vision_start_token_id] + [cfg.video_token_id] * n_vis
           + [cfg.vision_end_token_id] + text[n_text // 2:])
    return Request(input_ids=ids, patches=patches, grid_thw=grid, second_per_grid_t=1.0)


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def phase_reduced_depth() -> None:
    import torch

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.sampler import Engine, SamplingParams

    base = Qwen25VLConfig.qwen25vl_3b()
    cfg = replace(
        base,
        vision=replace(base.vision, depth=2, fullatt_block_indexes=(1,)),
        text=replace(base.text, num_hidden_layers=2),
    )
    torch.set_num_threads(os.cpu_count() or 1)
    params_cpu = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    params_gpu = to_device(params_cpu, torch.device("cuda"))
    req = video_request(cfg, np.random.default_rng(1), frames=8, height=224, width=392)
    sp = SamplingParams(max_new_tokens=8, stop_token_ids=())
    out = {}
    for device, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        eng = Engine(params, cfg, dtype=torch.float32, device=device)
        t0 = time.perf_counter()
        logits = eng.last_token_logits([req])
        tokens = eng.generate([req], sp)[0]
        out[device] = (logits, tokens)
        log(f"[reduced] {device}: {time.perf_counter() - t0:.1f} s, tokens {tokens}")
    (lg, tg), (lc, tc) = out["cuda"], out["cpu"]
    err = float(np.abs(lg - lc).max())
    log(f"[reduced] last-position logits: max |card - cpu| = {err:.3e} (tol {LOGIT_TOL}), "
        f"|logits| max {np.abs(lc).max():.3f}")
    if not np.isfinite(lg).all() or err > LOGIT_TOL:
        raise AssertionError(f"reduced-depth logits disagree: {err}")
    if tg != tc:
        raise AssertionError(f"greedy tokens differ: card {tg} cpu {tc}")


def kernel_wrappers():
    from time_r1_tpu_torch.ops.flash_attention import flash_attention_fwd
    from time_r1_tpu_torch.ops.vision_attention import full_attention_rope, window_attention_rope

    return {
        "flash_attention": flash_attention_fwd,
        "window_attention_rope": window_attention_rope,
        "full_attention_rope": full_attention_rope,
    }


def phase_full_size() -> dict:
    import torch

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.sampler import Engine, SamplingParams

    cfg = Qwen25VLConfig.qwen25vl_3b()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[full] init_params 3B bf16 on the card: {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    reqs = [video_request(cfg, rng, 32, 224, 392), video_request(cfg, rng, 24, 280, 336)]
    log(f"[full] prompts: {[len(r.input_ids) for r in reqs]} tokens, grids {[r.grid_thw for r in reqs]}")
    eng = Engine(params, cfg, dtype=torch.bfloat16, device="cuda")
    eng.generate(reqs, SamplingParams(max_new_tokens=2, stop_token_ids=()))  # warm-up

    sp = SamplingParams(max_new_tokens=128)
    wrappers = kernel_wrappers()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = eng.generate(reqs, sp)
    total = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    tm = eng.timings
    n_gen = sum(len(o) for o in out)
    log(f"[full] launches on the main path: {launches}")
    log(f"[full] vision {tm['vision_s'] * 1e3:.1f} ms, prefill {tm['prefill_s'] * 1e3:.1f} ms, "
        f"decode {tm['decode_s'] * 1e3 / max(tm['decode_steps'], 1):.2f} ms/step over {tm['decode_steps']} steps, "
        f"{n_gen} tokens generated, {n_gen / tm['decode_s']:.1f} tok/s in decode, "
        f"{total:.2f} s for the generate() call, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if not all(len(o) >= 1 for o in out):
        raise AssertionError("a request produced no tokens")
    logits = eng.last_token_logits(reqs)
    if logits.shape != (2, cfg.text.vocab_size) or not np.isfinite(logits).all():
        raise AssertionError(f"bad last-position logits: shape {logits.shape}")
    log(f"[full] last-position logits finite; argmax {logits.argmax(-1).tolist()}, "
        f"first generated {[o[0] for o in out]}")
    return launches


# ---------------------------------------------------------------------------
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import time_r1_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e})", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    card = card_line()
    log(f"[env] {card}")

    phase_build()
    checks = phase_kernels()
    phase_reduced_depth()
    launches = phase_full_size()

    replaces = {
        "flash_attention": "time_r1_tpu/ops/flash_attention.py:135",
        "window_attention_rope": "time_r1_tpu/ops/vision_attention.py:140",
        "full_attention_rope": "time_r1_tpu/ops/vision_attention.py:233",
    }
    sources = {
        "flash_attention": "time_r1_tpu_torch/csrc/flash_attention.cu",
        "window_attention_rope": "time_r1_tpu_torch/csrc/vision_attention.cu",
        "full_attention_rope": "time_r1_tpu_torch/csrc/vision_attention.cu",
    }
    kernels = []
    for name, entry in checks.items():
        kernels.append({
            **entry,
            "route": "cuda",
            "source": sources[name],
            "replaces": replaces[name],
            "launches": launches[name],
        })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
