#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`time_r1_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check raises and the exit code is non-zero):
1. build every kernel under time_r1_tpu_torch/csrc (one nvcc each, in parallel);
2. hold each kernel against its plain PyTorch version on the card, at the
   serving and training paths' shapes, in bf16 and f32, and time kernel, plain
   version and one library call (`scaled_dot_product_attention`, a yardstick
   the port never calls): K1-K3 (serving), B1, B2, S1, S2 (training), D1, D2,
   Q1, Q2 (quantized rollouts: caches in bf16/f32 and int8, a fully masked
   first prefix chunk, suffix lengths 0 and 199, Q1 at the 3B products at M
   = 1, 8, 16, 200, 256, the 7B products at M = 8 and a ragged shape, bf16
   on the tensor cores but for the ragged shape, Q2 at M = 1, 4, 7, 8, 16, 128 at the 3B widths, M = 7, 8 at
   the 7B widths and M = 3 at hid 256, inter 272, every case with its two
   phases apart and in bf16 also end to end), P1, P2 (continuous-batching decode: 4 slots of lengths 0,
   327, 1689, 2041 over a shuffled page table, page size 16, full slots, a
   dead slot with a stale table row, head dim 64), and the bf16 head's
   backward against the f32 cotangent. K1-K3, B1, B2, S1, S2 and D2 in bf16
   run the tensor-core kernels; besides the serving shapes K1 is checked (out and
   lse) at phase 5's B = 1 prompt forward (timed), head dims 64 and 80, G 1,
   non-causal, ragged Sq 200 over Skv 328 and all-masked rows, and K3 at S
   100 with a slice whose keys are all masked, S 2048, nh 1 and head dims 64
   and 128, every value finite; besides the training shapes B1/B2 are checked
   at q_offset 64, ragged Sq 200 over Skv 328, head dim 64, G 1, non-causal
   and a block of all-masked rows, and S1/S2 at P = 2 prompts of R = 4 rows,
   Lp 640 with Sc 384, Lp = Sc = 128, head dim 64, G 1 and a prompt whose
   bias masks every prefix key; K2 at head dims 64 and 128 and with fully
   dead windows; D2 at suffix lengths 0, 1 and 199 over bf16 and int8
   caches at the rollout's shape, the 7B rollout's N = 56 rows over 4 kv
   heads, 16 rollouts a prompt (N = 128, and 112 over 4 kv heads), head dim
   64, two prompts, Lp 1000 and 2000 and a fully masked first chunk; two B2 launches, two prefix dK/dV launches, two D2,
   two Q1 and two Q2 launches must each give bit-equal results, the wrappers of
   K1-K3, B1, B2, S1, S2 and D2 refuse f16 and head dim 96 (K1-K3, B1, B2,
   S1, S2 a misaligned q, K2 windows of 128 rows), Q1's f16 x, a w4 of the
   wrong width, f64 scales, a non-contiguous x and a misaligned bf16 x, and
   Q2's inter % 16 != 0, M > 128 and a hid beyond its shared memory;
3. end-to-end agreement at reduced depth: Qwen2.5-VL-3B widths with 2 decoder
   layers and 2 vision blocks, one 8-frame video request in f32, card
   (kernels) against CPU (plain versions);
3b. the same for one GRPO loss step (G = 4 fixed completions, fixed
   advantages, beta = 0.04 against a reference copy): loss, metrics and every
   gradient, card against CPU, with fix_vit and with fix_vit=False (the whole
   tower trains; K2/K3 must not launch inside the differentiated call); in
   f32 K1-K3, B1, B2, S1 and S2 run the FMA kernels only (in phases 3, 3c
   and 3d K1-K3 as well, and D2 in 3c);
3c. the quantized G-way decode at reduced depth, int8 weights and int8 KV,
   then int4 weights: 16 teacher-forced steps, card (D2, Q2, Q1) against CPU
   (plain paths) on every step's logits, Q1 on its FMA kernel only;
3d. continuous batching at reduced depth (f32, one 8-frame video and four
   text requests through 2 slots): equal greedy tokens card against CPU for
   PagedEngine (P1), PagedEngine with int8 KV pages (P2) and
   ContinuousEngine, and paged against the bucket Engine on the card;
4. the serving path at full size: Qwen2.5-VL-3B in bf16 with seeded random
   weights, two video requests, greedy decode of 128 tokens, with K1-K3's
   launch counts read around that one generate() call (exactly 36 K1, 28 K2
   and 4 K3 launches, all on the tensor cores);
5. the training path at full size: `GRPOTrainer` over the same model and a
   reference copy, one 32-frame video request, the default TrainConfig (G = 8,
   200 new tokens at T = 1.0, gradient accumulation 2), two `step_batch` calls
   (one optimizer update), with every kernel's launch count read around each;
   the G-way rollout decode runs D2 (36 launches per step, D1 none); each
   call runs exactly 108 K1 launches (rollout prefill, ref_logps, the loss),
   28 K2, 4 K3, 36 B1 and 72 B2 (prompt and own chunk), 72 S1 (ref_logps and
   the loss), 36 + 36 S2 (dq, prefix dK/dV) and 36 D2 a decode step, all on
   the tensor cores;
6. quantized rollouts at full size, once phase 5's model is freed: two
   `step_batch` calls with rollout_quantization="int8" (D2 and Q2 36 launches
   per decode step, D2 on the tensor cores over the int8 caches), then one
   `Engine(quantization="int4", kv_cache_quant=True).generate` at G = 8, 200
   tokens (Q1 144 and D2 36 per step, all on the tensor cores);
7. continuous-batching serving at full size, once phase 6's model is freed:
   12 requests (phase 4's two videos, ten text prompts of 200-1800 tokens),
   128 greedy tokens each, through 4 slots with 1024-token prefill chunks:
   PagedEngine (P1 on every decode step), PagedEngine with int8 weights and
   int8 KV pages (P2, Q2) and ContinuousEngine, every launch count checked.

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


SPIN_CYCLES_PER_S = 2.0e9  # about the H100's SM clock; a longer spin than needed costs only time


def cuda_ms(fn, iters: int = 10, queued: bool = True) -> float:
    """Mean device time of fn() over `iters` launches (CUDA events, after a
    warm-up). Queued: the launches wait behind a GPU spin that outlasts the
    host's time to issue them, so the events time the device work back to back
    and not the Python that issues it (a 20 us kernel behind a 100 us wrapper).
    queued=False times the calls as a caller issues them, host gaps included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(int(min(2.0 * iters * (time.perf_counter() - t0), 1.0) * SPIN_CYCLES_PER_S))
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
    import ctypes

    from time_r1_tpu_torch import kernels

    t0 = time.perf_counter()
    logs = kernels.build()
    log(f"[build] {len(logs)} sources rebuilt in {time.perf_counter() - t0:.1f} s")
    for stem, text in logs.items():
        func = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                func = line.split("'")[1]
            elif "registers" in line or "spill" in line or "wgmma" in line:
                log(f"[build] {stem} {func}: {line.strip()}")
    smem = kernels.bind("flash_attention_bwd", "t1_flash_bwd_tc_smem_bytes", [ctypes.c_int])
    log(f"[build] flash_attention_bwd tensor-core blocks (B1, B2, S2): dynamic shared memory "
        f"{smem(64)} bytes at head dim 64, {smem(128)} at 128")
    smem = kernels.bind("shared_prefix_attention", "t1_sp_fwd_tc_smem_bytes", [ctypes.c_int])
    log(f"[build] shared_prefix_attention tensor-core S1 blocks: dynamic shared memory "
        f"{smem(64)} bytes at head dim 64, {smem(128)} at 128")
    for stem, symbol, what in (("flash_attention", "t1_flash_attention_fwd_tc_smem_bytes", "K1"),
                               ("vision_attention", "t1_window_attention_rope_fwd_tc_smem_bytes",
                                "K2 (a window, its cos/sin staged once)"),
                               ("vision_attention", "t1_full_attention_rope_fwd_tc_smem_bytes", "K3 (with the rope)")):
        smem = kernels.bind(stem, symbol, [ctypes.c_int])
        log(f"[build] {stem} tensor-core {what} blocks: dynamic shared memory "
            f"{smem(64)} bytes at head dim 64, {smem(80)} at 80, {smem(128)} at 128")
    smem = kernels.bind("fused_mlp", "t1_fused_mlp_smem_bytes", [ctypes.c_int, ctypes.c_int])
    log(f"[build] fused_mlp Q2 blocks: dynamic shared memory {smem(8, 2048)} / {smem(8, 3584)} bytes at hid "
        f"2048 / 3584 and M <= 8, {smem(16, 2048)} / {smem(16, 3584)} above")
    smem = kernels.bind("decode_attention", "t1_decode_full_tc_smem_bytes", [ctypes.c_int, ctypes.c_int])
    log(f"[build] decode_attention tensor-core D2 blocks: dynamic shared memory {smem(0, 64)} / {smem(0, 128)} "
        f"bytes at head dim 64 / 128 over bf16 caches, {smem(1, 64)} / {smem(1, 128)} over int8")
    smem = kernels.bind("paged_attention", "t1_paged_tc_smem_bytes", [ctypes.c_int] * 4)
    log(f"[build] paged_attention tensor-core P1 / P2 blocks at 32 chunks of 1-4 tiles: dynamic shared memory "
        f"{[smem(0, 128, ct, 32) for ct in (1, 2, 4)]} / {[smem(1, 128, ct, 32) for ct in (1, 2, 4)]} bytes at "
        f"head dim 128, {[smem(0, 64, ct, 32) for ct in (1, 2, 4)]} / {[smem(1, 64, ct, 32) for ct in (1, 2, 4)]} "
        f"at 64")
    smem = kernels.bind("int4_matmul", "t1_int4_matmul_tc_smem", [ctypes.c_int, ctypes.c_int])
    for M in (8, 16):
        shapes = [f"K {K}: {smem(M, K) >> 20} x {'whole-row' if K <= 4096 else 'segment'} stages, "
                  f"{smem(M, K) & 0xFFFFF} bytes" for K in (2048, 3584, 11008, 18944)]
        log(f"[build] int4_matmul tensor-core Q1 blocks at M {'<= 8' if M == 8 else '> 8'}: {'; '.join(shapes)}")


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
            entry["tflops"] = flops / entry["ms"] / 1e9
            entry["bound_share"] = entry["bound_ms"] / entry["ms"]
            log(f"[kernels] {name}: {entry['ms']:.4f} ms (plain {entry['plain_ms']:.3f}, bound "
                f"{entry['bound_ms']:.4f} by {entry['bound_by']}, {entry['tflops']:.1f} TFLOP/s, "
                f"{100 * entry['bound_share']:.1f}% of the bound, library {entry['library_ms']:.4f})")
    entry["tol"], entry["tol_f32"] = TOL["bfloat16"], TOL["float32"]
    return entry


def phase_kernels() -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = serving_attention_kernels(gen)
    fwd_tc_edge_cases(gen, results["flash_attention"], results["full_attention_rope"])
    results.update(phase_train_kernels())
    results.update(phase_decode_quant_kernels())
    results.update(phase_paged_kernels())
    return results


def serving_attention_kernels(gen) -> dict:
    """K1, K2 and K3 against their plain versions at the serving path's
    shapes (phase 4), in bf16 (the tensor-core kernels) and f32 (FMA); times
    in bf16."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops.attention import NEG_INF
    from time_r1_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_plain
    from time_r1_tpu_torch.ops.vision_attention import full_attention_rope, full_attention_rope_plain

    dev = torch.device("cuda")
    results = {}

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    # K1 at the prefill shape of phase 4: two left-padded prompts in a
    # 2048-token bucket, a 2176-slot cache (128 decode slots)
    B, Sq, Skv, H, Hkv, D = 2, 2048, 2176, 16, 2, 128
    for q_offset in (0, 128):
        kv_bias, valid, allowed, flops, nbytes = k1_work(B, Sq, Skv, H, Hkv, D, True, q_offset, (134, 486))

        def inputs(dtype, q_offset=q_offset, kv_bias=kv_bias):
            q, k, v = randn(B, Sq, H, D, dtype=dtype), randn(B, Skv, Hkv, D, dtype=dtype), randn(B, Skv, Hkv, D, dtype=dtype)
            return q, k, v, kv_bias, True, None, q_offset

        entry = check_kernel(
            "flash_attention", lambda *a: flash_attention_fwd(*a)[0],
            lambda *a: flash_attention_plain(*a)[0], k1_library(valid, allowed), inputs, valid,
            flops=flops, nbytes=nbytes, timed=q_offset == 0,
        )
        if q_offset == 0:  # the main path's shape: the entry that is timed
            results["flash_attention"] = entry
        else:  # the second chunk of a chunked prefill: checked, not timed
            results["flash_attention"][f"q_offset_{q_offset}"] = {
                k: entry[k] for k in ("max_abs_err", "max_abs_err_f32")
            }

    # K2 and K3 on the padded-window layout of the two phase-4 videos
    results.update(window_kernel(gen))
    vcfg, prep, _, cos, sin, key_bias = serving_vision_inputs()
    nh, hd = vcfg.num_heads, vcfg.head_dim
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


def serving_vision_inputs():
    """The two phase-4 videos' padded-window layout on the card: (vision
    config, prepared inputs, key_valid (P,), cos, sin (P, hd), key_bias (P,))."""
    import torch

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, prepare_vision_inputs
    from time_r1_tpu_torch.models.qwen25vl.vision import vision_rope_tables
    from time_r1_tpu_torch.ops.attention import NEG_INF

    dev = torch.device("cuda")
    vcfg = Qwen25VLConfig.qwen25vl_3b().vision
    prep = prepare_vision_inputs(serving_grids(), vcfg)
    key_valid = torch.from_numpy(prep.key_valid).to(dev)
    cos, sin = vision_rope_tables(vcfg, torch.from_numpy(prep.pos_hw).to(dev))
    return vcfg, prep, key_valid, cos, sin, torch.where(key_valid, 0.0, NEG_INF).float()


def window_kernel(gen) -> dict:
    """K2 against its plain version at the serving path's shape (phase 4's
    two videos: 236 windows of 64 rows, 16 heads of 80), in bf16 (the
    tensor-core kernel) and f32 (FMA), timed in bf16; then K2_TC_CASES and
    the refusals."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops.vision_attention import window_attention_rope, window_attention_rope_plain

    dev = torch.device("cuda")
    vcfg, _, key_valid, cos, sin, key_bias = serving_vision_inputs()
    nh, hd = vcfg.num_heads, vcfg.head_dim
    win = vcfg.window_patches**2 * vcfg.merge_unit
    P = key_valid.shape[0]
    per_win = key_valid.reshape(-1, win).sum(1).double()
    # Bytes over live rows only, as the FLOPs count live (query, key) pairs:
    # q/k/v read and out written in bf16, cos/sin read in f32, and the bias
    # of every row read once. Dead rows are never keys and their outputs are dropped.
    live = key_valid.sum().item()
    vbytes = 4 * live * nh * hd * 2 + 2 * live * hd * 4 + P * 4

    def win_inputs(dtype):
        return tuple(torch.randn(P, nh, hd, generator=gen, device=dev).to(dtype) for _ in range(3)) + (
            cos, sin, key_bias, win)

    def win_library(q, k, v, cos, sin, key_bias, win):
        qt, kt, vt = (t.reshape(-1, win, nh, hd).transpose(1, 2) for t in (q, k, v))
        mask = key_bias.reshape(-1, 1, 1, win).to(q.dtype)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    entry = check_kernel(
        "window_attention_rope", window_attention_rope, window_attention_rope_plain, win_library,
        win_inputs, key_valid, flops=4.0 * (per_win**2).sum().item() * nh * hd, nbytes=vbytes,
    )
    k2_tc_edge_cases(gen, entry)
    return {"window_attention_rope": entry}


# K2 edge cases (bf16, tensor-core kernel): (windows of 64 rows, nh, hd, the
# windows whose keys are all dead); besides, 5% of the other keys are dead
# patches. A dead window's rows must stay finite.
K2_TC_CASES = {
    "head_dim_64": (8, 4, 64, (3,)),
    "head_dim_128": (8, 4, 128, ()),
    "dead_windows": (6, 16, 80, (0, 5)),
}


def k2_tc_edge_cases(gen, entry: dict) -> None:
    """bf16 K2 (the tensor-core kernel) at K2_TC_CASES against its plain
    version (f32 on the same inputs) at TOL, max abs error on live rows,
    every value finite; every launch on the tensor cores; then the wrapper
    must refuse f16, head dim 96, a misaligned q and windows of 128 rows."""
    import torch

    from time_r1_tpu_torch.ops.attention import NEG_INF
    from time_r1_tpu_torch.ops.vision_attention import window_attention_rope, window_attention_rope_plain

    dev = torch.device("cuda")
    tol = TOL["bfloat16"]
    entry["cases"] = {}
    n0, tc0 = window_attention_rope.launches, window_attention_rope.tc_launches
    for case, (n, nh, hd, dead_windows) in K2_TC_CASES.items():
        P = 64 * n
        q, k, v = (torch.randn(P, nh, hd, generator=gen, device=dev).bfloat16() for _ in range(3))
        theta = torch.rand(P, hd, generator=gen, device=dev) * 20.0
        dead = torch.rand(P, generator=gen, device=dev) < 0.05
        for w in dead_windows:
            dead[64 * w:64 * (w + 1)] = True
        bias = torch.where(dead, NEG_INF, 0.0).float()
        args = (q, k, v, theta.cos(), theta.sin(), bias, 64)
        out = window_attention_rope(*args)
        want = window_attention_rope_plain(q.float(), k.float(), v.float(), *args[3:])
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"window_attention_rope {case}: non-finite values")
        err = (out.float() - want)[~dead].abs().max().item()
        entry["cases"][case] = err
        log(f"[kernels] window_attention_rope {case}: max |kernel - plain| on live rows = {err:.3e}, every value "
            f"finite (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"window_attention_rope {case}: max |kernel - plain| = {err} > {tol}")
    runs = window_attention_rope.launches - n0
    if window_attention_rope.tc_launches - tc0 != runs:
        raise AssertionError(f"K2 bf16: {runs} launches, {window_attention_rope.tc_launches - tc0} on the tensor cores")
    vq = torch.randn(128, 4, 80, generator=gen, device=dev).bfloat16()
    cs, vb = torch.rand(128, 80, device=dev), torch.zeros(128, device=dev)
    v96 = torch.randn(128, 4, 96, generator=gen, device=dev).bfloat16()
    c96 = torch.rand(128, 96, device=dev)
    refused = {
        "float16": lambda: window_attention_rope(vq.half(), vq.half(), vq.half(), cs, cs, vb, 64),
        "head dim 96": lambda: window_attention_rope(v96, v96, v96, c96, c96, vb, 64),
        "q 2 bytes off 16-byte alignment": lambda: window_attention_rope(misaligned(vq), vq, vq, cs, cs, vb, 64),
        "windows of 128 rows": lambda: window_attention_rope(vq, vq, vq, cs, cs, vb, 128),
    }
    for what, call in refused.items():
        try:
            call()
        except ValueError as e:
            log(f"[kernels] window_attention_rope refuses {what}: {e}")
        else:
            raise AssertionError(f"window_attention_rope took {what}")


def k1_work(B, Sq, Skv, H, Hkv, D, causal, q_offset, pads):
    """K1's inputs and work at one shape with left pad keys per batch entry:
    (kv_bias (B, Skv), valid (B, Sq): rows that see a real key, allowed (B,
    Sq, Skv): the (row, key) pairs of valid rows, the FLOPs of those pairs,
    the bytes: live q read, out and lse written, each (entry, key) that a
    valid row reads once, the bias)."""
    import torch

    from time_r1_tpu_torch.ops.attention import NEG_INF

    dev = torch.device("cuda")
    keys = torch.arange(Skv, device=dev)
    pad = torch.tensor(pads, device=dev)
    kv_bias = torch.where(keys[None] < pad[:, None], NEG_INF, 0.0).float()
    last = q_offset + torch.arange(Sq, device=dev) if causal else torch.full((Sq,), Skv - 1, device=dev)
    valid = last[None, :] >= pad[:, None]
    allowed = (keys[None, :] <= last[:, None])[None] & (kv_bias[:, None, :] == 0) & valid[:, :, None]
    live_q = valid.sum().item()
    live_kv = allowed.any(1).sum().item()
    nbytes = (2 * live_q * H * D + 2 * live_kv * Hkv * D) * 2 + B * Skv * 4 + live_q * H * 4
    return kv_bias, valid, allowed, 4.0 * allowed.sum().item() * H * D, nbytes


def k1_library(valid, allowed):
    """The yardstick for K1: one SDPA call with the same mask (rows that see
    no key attend to every key)."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops.attention import NEG_INF

    def library(q, k, v, kv_bias, causal, scale, q_offset):
        mask = torch.where(allowed | ~valid[:, :, None], 0.0, NEG_INF).to(q.dtype)[:, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

    return library


# K1 edge cases (bf16, tensor-core kernel): (B, Sq, Skv, H, Hkv, D, causal,
# q_offset, left pad keys per batch entry). The first two are phase 4's
# prefill at both chunk offsets; `train_B1` is phase 5's prompt forward
# (timed: the K1 row's B = 1 time); a batch entry padded over all its keys
# has no row that sees a real key.
K1_EDGE_CASES = {
    "serving_q_offset_0": (2, 2048, 2176, 16, 2, 128, True, 0, (134, 486)),
    "serving_q_offset_128": (2, 2048, 2176, 16, 2, 128, True, 128, (134, 486)),
    "train_B1": (1, 2048, 2176, 16, 2, 128, True, 0, (134,)),
    "head_dim_64": (2, 256, 256, 8, 2, 64, True, 0, (20, 0)),
    "head_dim_80": (2, 256, 320, 8, 2, 80, True, 64, (0, 30)),
    "G1": (2, 192, 192, 4, 4, 128, True, 0, (0, 50)),
    "non_causal": (2, 256, 300, 16, 2, 128, False, 0, (10, 0)),
    "ragged_Sq200_Skv328": (2, 200, 328, 16, 2, 128, True, 128, (37, 0)),
    "all_masked_rows": (2, 256, 256, 16, 2, 128, True, 0, (150, 256)),
}

# K3 edge cases (bf16, tensor-core kernel): (n_slices, S, nh, hd, pad keys at
# the end of each slice); besides, 5% of the other keys are dead patches. A
# slice padded over its whole length has no live key: its rows must stay
# finite. JAX's kernel caps S at 1536 (a VMEM limit); the port's does not.
K3_EDGE_CASES = {
    "S100_ragged_dead_slice": (3, 100, 16, 80, (0, 17, 100)),
    "S2048": (1, 2048, 16, 80, (300,)),
    "nh1": (4, 480, 1, 80, (0, 0, 55, 200)),
    "head_dim_64": (2, 256, 4, 64, (0, 40)),
    "head_dim_128": (2, 256, 4, 128, (0, 40)),
}


def misaligned(t):
    """A contiguous copy of t that starts 2 bytes off 16-byte alignment."""
    import torch

    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def fwd_tc_edge_cases(gen, k1_entry: dict, k3_entry: dict) -> None:
    """bf16 K1 and K3 (the tensor-core kernels) against their plain versions
    (f32 on the same inputs) at TOL, max abs error on valid rows, for K1's out
    and lse; every value of every row must be finite. K1's B = 1 shape is
    timed. Then both wrappers must refuse f16, head dim 96 and a misaligned q."""
    import torch

    from time_r1_tpu_torch.ops import flash_attention as fa
    from time_r1_tpu_torch.ops.attention import NEG_INF
    from time_r1_tpu_torch.ops.vision_attention import full_attention_rope, full_attention_rope_plain

    dev = torch.device("cuda")
    tol = TOL["bfloat16"]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    def hold(entry, label, case, pairs, D):
        """(kernel, plain, valid-row mask) triples: the worst max abs error on
        valid rows, also over the tail columns 64..79 at D = 80."""
        errs, tail = [], None
        for got, want, valid in pairs:
            if not torch.isfinite(got).all():
                raise AssertionError(f"{label} {case}: non-finite values")
            diff = (got.float() - want.float()).abs()
            errs.append(diff[valid].max().item())
            if D == 80 and got.dim() == 4:
                tail = diff[valid][..., 64:].max().item()
        err = max(errs)
        entry["cases"][case] = err
        entry["max_abs_err_cases"] = max(entry.get("max_abs_err_cases", 0.0), err)
        extra = "" if tail is None else f" (columns 64-79: {tail:.3e})"
        log(f"[kernels] {label} {case}: max |kernel - plain| on valid rows = {errs}{extra}, every value finite "
            f"(tol {tol})")
        if not err <= tol:
            raise AssertionError(f"{label} {case}: max |kernel - plain| = {err} > {tol}")

    k1_entry["cases"], k3_entry["cases"] = {}, {}
    for case, (B, Sq, Skv, H, Hkv, D, causal, q_offset, pads) in K1_EDGE_CASES.items():
        bias, valid, allowed, flops, nbytes = k1_work(B, Sq, Skv, H, Hkv, D, causal, q_offset, pads)
        q, k, v = randn(B, Sq, H, D), randn(B, Skv, Hkv, D), randn(B, Skv, Hkv, D)
        args = (q, k, v, bias, causal, None, q_offset)
        out, lse = fa.flash_attention_fwd(*args)
        want, want_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), *args[3:])
        torch.cuda.synchronize()
        hold(k1_entry, "flash_attention", case, [(out, want, valid), (lse, want_lse, valid[:, None, :].expand(B, H, Sq))], D)
        if case == "train_B1":
            ms = cuda_ms(lambda: fa.flash_attention_fwd(*args))
            bound_ms, bound_by = bound(flops, nbytes)
            k1_entry["b1"] = dict(shape=[B, Sq, Skv, H, Hkv, D], pad=pads[0], ms=ms, bound_ms=bound_ms,
                                  bound_by=bound_by, tflops=flops / ms / 1e9, bound_share=bound_ms / ms,
                                  library_ms=cuda_ms(k1_library(valid, allowed)(*args)))
            log(f"[kernels] flash_attention at B = 1 (phase 5's prompt forward): {ms:.4f} ms, bound "
                f"{bound_ms:.4f} by {bound_by}, {flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the "
                f"bound, library {k1_entry['b1']['library_ms']:.4f} ms")

    for case, (n, S, nh, hd, pads) in K3_EDGE_CASES.items():
        q, k, v = randn(n, S, nh, hd), randn(n, S, nh, hd), randn(n, S, nh, hd)
        theta = torch.rand(n, S, hd, generator=gen, device=dev) * 20.0
        cos, sin = theta.cos(), theta.sin()
        keys = torch.arange(S, device=dev)
        dead = (keys[None] >= S - torch.tensor(pads, device=dev)[:, None]) | (
            torch.rand(n, S, generator=gen, device=dev) < 0.05)
        bias = torch.where(dead, NEG_INF, 0.0).float()
        out = full_attention_rope(q, k, v, cos, sin, bias)
        want = full_attention_rope_plain(q.float(), k.float(), v.float(), cos, sin, bias)
        torch.cuda.synchronize()
        hold(k3_entry, "full_attention_rope", case, [(out, want, ~dead)], hd)

    # what the kernels do not take raises in the wrapper, never falls back
    B, S, H, Hkv, D = 1, 256, 16, 2, 128
    q, k, v = randn(B, S, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
    bias = torch.zeros(B, S, device=dev)
    vq, vk, vv = randn(2, 64, 4, 80), randn(2, 64, 4, 80), randn(2, 64, 4, 80)
    cs, vb = torch.rand(2, 64, 80, device=dev), torch.zeros(2, 64, device=dev)
    d96 = [randn(1, S, H, 96), randn(1, S, Hkv, 96), randn(1, S, Hkv, 96)]
    v96 = [randn(2, 64, 4, 96) for _ in range(3)]
    refused = {
        "flash_attention": {
            "float16": lambda: fa.flash_attention_fwd(q.half(), k.half(), v.half(), bias),
            "head dim 96": lambda: fa.flash_attention_fwd(*d96, bias),
            "q 2 bytes off 16-byte alignment": lambda: fa.flash_attention_fwd(misaligned(q), k, v, bias),
        },
        "full_attention_rope": {
            "float16": lambda: full_attention_rope(vq.half(), vk.half(), vv.half(), cs, cs, vb),
            "head dim 96": lambda: full_attention_rope(*v96, torch.rand(2, 64, 96, device=dev),
                                                       torch.rand(2, 64, 96, device=dev), vb),
            "q 2 bytes off 16-byte alignment": lambda: full_attention_rope(misaligned(vq), vk, vv, cs, cs, vb),
        },
    }
    for name, calls in refused.items():
        for what, call in calls.items():
            try:
                call()
            except ValueError as e:
                log(f"[kernels] {name} refuses {what}: {e}")
            else:
                raise AssertionError(f"{name} took {what}")


# Gradient tolerances, as max |kernel - plain| / max |plain| over the output.
# f32: the kernels sum dK/dV over up to 64 (row, head) pairs x 2048 query rows,
# and dq over 2304 keys, in another order than the plain einsums; bf16: dq is
# stored in bf16 (relative spacing 2^-8), and the forward outputs likewise.
GRAD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}


def phase_train_kernels() -> dict:
    """B1, B2, S1 and S2 against their plain versions at the training step's
    shapes (the prompt forward of phase 5: one 2048-token prompt with 134 left
    pad keys; the split-loss chunk: 8 rows of 256 completion tokens over that
    prefix), in bf16 and f32; times in bf16."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops.attention import NEG_INF
    from time_r1_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    H, Hkv, D, pad = 16, 2, 128, 134
    G = H // Hkv

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    def errors(got, want) -> tuple[float, float]:
        """(max |kernel - plain|, max over outputs of max |kernel - plain| / max |plain|)."""
        got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
        diffs, rels = [], []
        for a, b in zip(got, want):
            diff, scale = (a.float() - b.float()).abs().max().item(), b.float().abs().max().item()
            log(f"[kernels]   max |kernel - plain| {diff:.3e}, max |plain| {scale:.3e}, "
                f"max |kernel| {a.float().abs().max().item():.3e}")
            diffs.append(diff)
            rels.append(diff / max(scale, 1e-30))
        return max(diffs), max(rels)

    def check(name, kernel, plain, inputs, flops, nbytes, library):
        entry = {"name": name}
        for dtype in (torch.bfloat16, torch.float32):
            args = inputs(dtype)
            up = [a.float() if isinstance(a, torch.Tensor) and a.is_floating_point() else a for a in args]
            diff, err = errors(kernel(*args), plain(*up))
            torch.cuda.synchronize()
            key = str(dtype).split(".")[-1]
            if not np.isfinite(err) or err > GRAD_TOL[key]:
                raise AssertionError(f"{name} {key}: max |kernel - plain| / max |plain| = {err} > {GRAD_TOL[key]}")
            suffix = "" if dtype is torch.bfloat16 else "_f32"
            entry["max_abs_err" + suffix], entry["max_rel_err" + suffix] = diff, err
            log(f"[kernels] {name} {key}: max |kernel - plain| = {diff:.3e}, / max |plain| = {err:.3e} "
                f"(tol {GRAD_TOL[key]})")
            if dtype is torch.bfloat16:
                entry["ms"] = entry["kernel_ms"] = cuda_ms(lambda: kernel(*args))
                entry["plain_ms"] = cuda_ms(lambda: plain(*args), iters=3)
                entry["library_ms"] = library(*args) if library else None
                entry["bound_ms"], entry["bound_by"] = bound(flops, nbytes)
                entry["tflops"] = flops / entry["ms"] / 1e9
                entry["bound_share"] = entry["bound_ms"] / entry["ms"]
        entry["tol"], entry["tol_f32"] = GRAD_TOL["bfloat16"], GRAD_TOL["float32"]
        entry["tol_is"] = "on max_rel_err: max |kernel - plain| / max |plain| per output"
        log(f"[kernels] {name}: {entry['ms']:.3f} ms (plain {entry['plain_ms']:.3f}, bound "
            f"{entry['bound_ms']:.4f} by {entry['bound_by']}, {entry['tflops']:.1f} TFLOP/s, "
            f"{100 * entry['bound_share']:.1f}% of the bound, library {entry['library_ms']})")
        return entry

    def sdpa_times(q, k, v, mask):
        """(forward ms, forward + backward ms) of one SDPA call: the yardstick."""
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        g = torch.randn(qt.shape, generator=gen, device=dev).to(q.dtype)

        def fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

        def fwd_bwd():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True).backward(g)

        return cuda_ms(fwd), cuda_ms(fwd_bwd)

    def grad_inputs(q, k, v, bias, do, valid_rows):
        """lse and delta from the plain forward (f32), dO zero on rows that see no key."""
        do = do * valid_rows[:, :, None, None]
        out, lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), bias, True, None, 0)
        return do, lse, (do.float() * out.float()).sum(-1)

    results = {}
    # ---- B1, B2 at the prompt forward: q (1, 2048, 16, 128), k/v (1, 2048, 2, 128)
    S = 2048
    bias = torch.where(torch.arange(S, device=dev)[None] < pad, NEG_INF, 0.0).float()
    rows = torch.arange(S, device=dev)
    valid = (rows >= pad)[None].float()
    live = S - pad
    pairs = live * (live + 1) // 2  # per head: valid row i sees keys [pad, i]
    base = dict(q=randn(1, S, H, D), k=randn(1, S, Hkv, D), v=randn(1, S, Hkv, D), do=randn(1, S, H, D))

    def prompt_inputs(dtype):
        q, k, v = (base[n].to(dtype) for n in ("q", "k", "v"))
        do, lse, delta = grad_inputs(q, k, v, bias, base["do"], valid)
        return q, k, v, bias, do.to(dtype), lse, delta

    mask = torch.where((rows[None, :] <= rows[:, None]) & (rows[None, :] >= pad), 0.0, NEG_INF)
    mask = mask.to(torch.bfloat16)[None, None]
    t_fwd, t_fb = sdpa_times(*(base[n].to(torch.bfloat16) for n in ("q", "k", "v")), mask)
    io_rows = live * H * D * 2 * 2  # q and dO read (bf16)
    io_keys = live * Hkv * D * 2 * 2  # k and v read
    stats = live * H * 4 * 2  # lse and delta
    results["flash_bwd_dq"] = check(
        "flash_bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_plain, prompt_inputs,
        flops=6.0 * D * pairs * H, nbytes=io_rows + io_keys + stats + S * 4 + live * H * D * 2,
        library=lambda *a: t_fb - t_fwd,
    )
    results["flash_bwd_dq"]["library_is"] = "SDPA forward+backward minus forward: the whole of B1 + B2"
    results["flash_bwd_dkv"] = check(
        "flash_bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, prompt_inputs,
        flops=8.0 * D * pairs * H, nbytes=io_rows + io_keys + stats + S * 4 + 2 * live * Hkv * D * 4,
        library=None,
    )
    results["flash_bwd_dkv"]["library_is"] = "in flash_bwd_dq's row (one SDPA backward covers B1 + B2)"
    results["flash_bwd_dkv"]["grid_blocks"] = (S // 64) * Hkv * fa.bwd_dkv_split(G, S, Hkv, 1)

    # ---- B2 at the own chunk of the split loss: q (8, 256, 16, 128), zero bias
    R, Sc = 8, 256
    own = dict(q=randn(R, Sc, H, D), k=randn(R, Sc, Hkv, D), v=randn(R, Sc, Hkv, D), do=randn(R, Sc, H, D))
    zero = torch.zeros(R, Sc, device=dev)

    def own_inputs(dtype):
        q, k, v = (own[n].to(dtype) for n in ("q", "k", "v"))
        do, lse, delta = grad_inputs(q, k, v, zero, own["do"], torch.ones(R, Sc, device=dev))
        return q, k, v, zero, do.to(dtype), lse, delta

    for dtype in (torch.bfloat16, torch.float32):
        args = own_inputs(dtype)
        diff, err = errors(fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv_plain(*[a.float() for a in args]))
        key = str(dtype).split(".")[-1]
        log(f"[kernels] flash_bwd_dkv own chunk {key}: max |kernel - plain| = {diff:.3e}, "
            f"/ max |plain| = {err:.3e} (tol {GRAD_TOL[key]})")
        if not np.isfinite(err) or err > GRAD_TOL[key]:
            raise AssertionError(f"flash_bwd_dkv own chunk {key}: {err}")
        if dtype is torch.bfloat16:
            results["flash_bwd_dkv"]["own_chunk_ms"] = cuda_ms(lambda: fa.flash_bwd_dkv(*args))
            log(f"[kernels] flash_bwd_dkv own chunk: {results['flash_bwd_dkv']['own_chunk_ms']:.4f} ms")
    bwd_edge_cases(gen, results["flash_bwd_dq"], results["flash_bwd_dkv"])

    # ---- S1, S2 at the split-loss chunk: q (8, 256, 16, 128), prefix (1, 2048, 2, 128)
    P, Lp = 1, 2048
    pbias = torch.where(torch.arange(Lp, device=dev)[None] < pad, NEG_INF, 0.0).float()
    sp = dict(q=own["q"], kp=randn(P, Lp, Hkv, D), vp=randn(P, Lp, Hkv, D), ko=own["k"], vo=own["v"], do=own["do"])

    def sp_fwd_inputs(dtype):
        return tuple(sp[n].to(dtype) for n in ("q", "kp", "vp", "ko", "vo")) + (pbias,)

    def sp_bwd_parts(dtype):
        q, kp, vp, ko, vo, pb = sp_fwd_inputs(dtype)
        out, lse = fa.shared_prefix_plain(q.float(), kp.float(), vp.float(), ko.float(), vo.float(), pb)
        delta = (sp["do"].to(dtype).float() * out).sum(-1)
        return q, kp, vp, ko, vo, pb, sp["do"].to(dtype), lse, delta

    def sp_bwd(q, kp, vp, ko, vo, pb, do, lse, delta):
        return (fa.shared_prefix_bwd_dq(q, kp, vp, ko, vo, pb, do, lse, delta),
                *fa.shared_prefix_bwd_dkv(q, kp, vp, pb, do, lse, delta))

    def sp_bwd_plain(q, kp, vp, ko, vo, pb, do, lse, delta):
        return (fa.shared_prefix_bwd_dq_plain(q, kp, vp, ko, vo, pb, do, lse, delta),
                *fa.shared_prefix_bwd_dkv_plain(q, kp, vp, pb, do, lse, delta))

    live_p = Lp - pad
    own_pairs = Sc * (Sc + 1) // 2
    pre_pairs = Sc * live_p
    rows_io = R * Sc * H * D * 2
    keys_io = (live_p * Hkv * D * 2) * 2 + (R * Sc * Hkv * D * 2) * 2
    cat_k = torch.cat([sp["kp"].expand(R, -1, -1, -1), sp["ko"]], 1).to(torch.bfloat16)
    cat_v = torch.cat([sp["vp"].expand(R, -1, -1, -1), sp["vo"]], 1).to(torch.bfloat16)
    i = torch.arange(Sc, device=dev)
    cat_mask = torch.cat([pbias.expand(Sc, -1), torch.where(i[None, :] <= i[:, None], 0.0, NEG_INF)], 1)
    cat_mask = cat_mask.to(torch.bfloat16)[None, None]
    s_fwd, s_fb = sdpa_times(sp["q"].to(torch.bfloat16), cat_k, cat_v, cat_mask)
    results["shared_prefix_fwd"] = check(
        "shared_prefix_fwd", lambda *a: fa.shared_prefix_fwd(*a)[0], lambda *a: fa.shared_prefix_plain(*a)[0],
        sp_fwd_inputs, flops=4.0 * D * (pre_pairs + own_pairs) * R * H,
        nbytes=2 * rows_io + keys_io + Lp * 4 + R * Sc * H * 4, library=lambda *a: s_fwd,
    )
    results["shared_prefix_fwd"]["library_is"] = "SDPA over [prefix repeated 8x | own chunk] with the mask"
    bwd = check(
        "shared_prefix_bwd", sp_bwd, sp_bwd_plain, sp_bwd_parts,
        flops=6.0 * D * (pre_pairs + own_pairs) * R * H + 8.0 * D * pre_pairs * R * H,
        nbytes=2 * (2 * rows_io + keys_io + R * Sc * H * 8) + rows_io + 2 * live_p * Hkv * D * 4,
        library=lambda *a: s_fb - s_fwd,
    )
    bwd["library_is"] = ("SDPA forward+backward minus forward over [prefix repeated | own chunk]:"
                         " also covers the own-chunk dK/dV that B2 computes")
    a = sp_bwd_parts(torch.bfloat16)
    bwd["ms_dq"] = cuda_ms(lambda: fa.shared_prefix_bwd_dq(*a))
    bwd["ms_dkv_prefix"] = cuda_ms(lambda: fa.shared_prefix_bwd_dkv(a[0], a[1], a[2], a[5], *a[6:]))
    # dq: S, dP and dS·K over both sources; the prefix dK/dV: S, dP, Pᵀ·dO and dSᵀ·Q over the prefix
    for part, ms, flops in (("dq", bwd["ms_dq"], 6.0 * D * (pre_pairs + own_pairs) * R * H),
                            ("dkv_prefix", bwd["ms_dkv_prefix"], 8.0 * D * pre_pairs * R * H)):
        bwd[f"tflops_{part}"] = flops / ms / 1e9
        bwd[f"bound_share_{part}"] = flops / PEAK_BF16_FLOPS * 1e3 / ms
    n_split = fa.bwd_dkv_split(G, Lp, Hkv, P, R)
    bwd["n_split_dkv_prefix"] = n_split
    bwd["grid_blocks_dkv_prefix"] = (Lp // 64) * Hkv * P * n_split
    log(f"[kernels] shared_prefix_bwd: dq {bwd['ms_dq']:.4f} ms ({bwd['tflops_dq']:.1f} TFLOP/s), prefix dK/dV "
        f"{bwd['ms_dkv_prefix']:.4f} ms with the fold ({bwd['tflops_dkv_prefix']:.1f} TFLOP/s; n_split {n_split}, "
        f"{bwd['grid_blocks_dkv_prefix']} blocks)")
    results["shared_prefix_bwd"] = bwd
    sp_edge_cases(gen, results["shared_prefix_fwd"], bwd)
    head_backward_check(gen)
    return results


# B1/B2 edge cases (bf16, tensor-core kernels): (B, Sq, Skv, H, Hkv, D,
# causal, q_offset, left pad keys per batch entry). Rows that see no key get a
# zero cotangent, as the training step gives them.
BWD_EDGE_CASES = {
    "q_offset_64": (1, 256, 320, 16, 2, 128, True, 64, (0,)),
    "ragged_Sq200_Skv328": (2, 200, 328, 16, 2, 128, True, 128, (37, 0)),
    "head_dim_64": (2, 256, 256, 8, 2, 64, True, 0, (20, 0)),
    "G1": (2, 192, 192, 4, 4, 128, True, 0, (0, 50)),
    "non_causal": (2, 256, 300, 16, 2, 128, False, 0, (10, 0)),
    "all_masked_rows": (2, 256, 256, 16, 2, 128, True, 0, (150, 256)),
}


def bwd_edge_cases(gen, dq_entry: dict, dkv_entry: dict) -> None:
    """B1 and B2 in bf16 against their plain versions (f32 on the same
    inputs) at the edges the main path and ring attention reach, at
    GRAD_TOL; then two B2 launches at the prompt shape must be bit-equal."""
    import torch

    from time_r1_tpu_torch.ops import flash_attention as fa
    from time_r1_tpu_torch.ops.attention import NEG_INF

    dev = torch.device("cuda")
    tol = GRAD_TOL["bfloat16"]
    dq_entry["cases"], dkv_entry["cases"] = {}, {}
    for case, (B, Sq, Skv, H, Hkv, D, causal, q_offset, pads) in BWD_EDGE_CASES.items():
        keys = torch.arange(Skv, device=dev)
        pad = torch.tensor(pads, device=dev)
        bias = torch.where(keys[None] < pad[:, None], NEG_INF, 0.0).float()
        last = q_offset + torch.arange(Sq, device=dev) if causal else torch.full((Sq,), Skv - 1, device=dev)
        valid = (last[None] >= pad[:, None]).float()  # (B, Sq): rows that see a key
        q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                   for shape in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
        do = (torch.randn(B, Sq, H, D, generator=gen, device=dev) * valid[:, :, None, None]).bfloat16()
        out, lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), bias, causal, None, q_offset)
        delta = (do.float() * out).sum(-1)
        args = (q, k, v, bias, do, lse, delta, causal, None, q_offset)
        up = (q.float(), k.float(), v.float(), bias, do.float(), lse, delta, causal, None, q_offset)
        check_case(dq_entry, "flash_bwd_dq", case, [(fa.flash_bwd_dq(*args), fa.flash_bwd_dq_plain(*up))], tol)
        check_case(dkv_entry, "flash_bwd_dkv", case, list(zip(fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv_plain(*up))), tol)
    # bit-equality across launches at the prompt shape (n_split = 8: folded partials)
    S, H, Hkv, D = 2048, 16, 2, 128
    q, do = (torch.randn(1, S, H, D, generator=gen, device=dev).bfloat16() for _ in range(2))
    k, v = (torch.randn(1, S, Hkv, D, generator=gen, device=dev).bfloat16() for _ in range(2))
    bias = torch.where(torch.arange(S, device=dev)[None] < 134, NEG_INF, 0.0).float()
    out, lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), bias, True, None, 0)
    args = (q, k, v, bias, do, lse, (do.float() * out).sum(-1))
    first, second = fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv(*args)
    equal = all(torch.equal(a, b) for a, b in zip(first, second))
    dkv_entry["bit_equal_across_launches"] = equal
    log(f"[kernels] flash_bwd_dkv: two launches bit-equal: {equal} (n_split "
        f"{fa.bwd_dkv_split(H // Hkv, S, Hkv, 1)})")
    if not equal:
        raise AssertionError("flash_bwd_dkv: two launches on the same inputs differ")
    # what the kernels do not take raises in the wrapper, never falls back
    refused = {
        "float16": (q.half(), k.half(), v.half(), bias, do.half(), *args[5:]),
        "head dim 96": (q[..., :96].contiguous(), k[..., :96].contiguous(), v[..., :96].contiguous(), bias,
                        do[..., :96].contiguous(), *args[5:]),
        "q 2 bytes off 16-byte alignment": (q.flatten()[1: 1 + (S - 1) * H * D].view(1, S - 1, H, D), k, v,
                                             bias, do[:, 1:].contiguous(), lse[..., 1:].contiguous(),
                                             args[6][:, 1:]),
    }
    for what, bad in refused.items():
        for fn in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
            try:
                fn(*bad)
            except ValueError as e:
                log(f"[kernels] {fn.__name__} refuses {what}: {e}")
            else:
                raise AssertionError(f"{fn.__name__} took {what}")


# S1/S2 edge cases (bf16, tensor-core kernels): (P, R, Lp, Sc, H, Hkv, D,
# left pad keys per prompt). Every shape is a multiple of 128, as `_sp_blocks`
# requires of the split loss. A prompt whose bias masks every prefix key still
# sees its own causal chunk.
SP_EDGE_CASES = {
    "P2_R4": (2, 4, 256, 128, 16, 2, 128, (0, 37)),
    "Lp640_Sc384": (1, 2, 640, 384, 16, 2, 128, (100,)),
    "Lp128_Sc128": (1, 2, 128, 128, 16, 2, 128, (0,)),
    "head_dim_64": (1, 2, 256, 128, 8, 2, 64, (5,)),
    "G1": (1, 3, 256, 128, 4, 4, 128, (20,)),
    "prefix_all_masked": (2, 2, 256, 128, 16, 2, 128, (256, 0)),
}


def sp_edge_cases(gen, fwd_entry: dict, bwd_entry: dict) -> None:
    """S1 and S2 in bf16 against their plain versions (f32 on the same
    inputs) at GRAD_TOL, at the shapes the split loss can reach beyond the
    main one; then two prefix dK/dV launches at the split-loss shape must be
    bit-equal, and the wrappers must refuse f16, head dim 96 and a misaligned q."""
    import torch

    from time_r1_tpu_torch.ops import flash_attention as fa
    from time_r1_tpu_torch.ops.attention import NEG_INF

    dev = torch.device("cuda")
    tol = GRAD_TOL["bfloat16"]
    fwd_entry["cases"], bwd_entry["cases"] = {}, {}

    def inputs(P, R, Lp, Sc, H, Hkv, D, pads):
        B = P * R
        shapes = ((B, Sc, H, D), (P, Lp, Hkv, D), (P, Lp, Hkv, D), (B, Sc, Hkv, D), (B, Sc, Hkv, D))
        q, kp, vp, ko, vo = (torch.randn(s, generator=gen, device=dev).bfloat16() for s in shapes)
        pb = torch.where(torch.arange(Lp, device=dev)[None] < torch.tensor(pads, device=dev)[:, None], NEG_INF, 0.0)
        do = torch.randn(B, Sc, H, D, generator=gen, device=dev).bfloat16()
        out, lse = fa.shared_prefix_plain(q.float(), kp.float(), vp.float(), ko.float(), vo.float(), pb.float())
        return (q, kp, vp, ko, vo, pb.float()), do, lse, (do.float() * out).sum(-1)

    for case, shape in SP_EDGE_CASES.items():
        fwd, do, lse, delta = inputs(*shape)
        up = tuple(t.float() for t in fwd)
        out, got_lse = fa.shared_prefix_fwd(*fwd)
        want, want_lse = fa.shared_prefix_plain(*up)
        check_case(fwd_entry, "shared_prefix_fwd", case, [(out, want), (got_lse, want_lse)], tol)
        (q, kp, vp, _, _, pb), (uq, ukp, uvp, _, _, _) = fwd, up
        got = (fa.shared_prefix_bwd_dq(*fwd, do, lse, delta), *fa.shared_prefix_bwd_dkv(q, kp, vp, pb, do, lse, delta))
        want = (fa.shared_prefix_bwd_dq_plain(*up, do.float(), lse, delta),
                *fa.shared_prefix_bwd_dkv_plain(uq, ukp, uvp, pb, do.float(), lse, delta))
        check_case(bwd_entry, "shared_prefix_bwd", case, list(zip(got, want)), tol)
    # bit-equality across launches at the split-loss shape (n_split = 8: folded partials)
    fwd, do, lse, delta = inputs(1, 8, 2048, 256, 16, 2, 128, (134,))
    q, kp, vp, ko, vo, pb = fwd
    args = (q, kp, vp, pb, do, lse, delta)
    first, second = fa.shared_prefix_bwd_dkv(*args), fa.shared_prefix_bwd_dkv(*args)
    equal = all(torch.equal(a, b) for a, b in zip(first, second))
    bwd_entry["bit_equal_across_launches"] = equal
    log(f"[kernels] shared_prefix_bwd_dkv: two launches bit-equal: {equal} (n_split {fa.bwd_dkv_split(8, 2048, 2, 1, 8)})")
    if not equal:
        raise AssertionError("shared_prefix_bwd_dkv: two launches on the same inputs differ")
    # what the kernels do not take raises in the wrapper, never falls back
    d96 = [t[..., :96].contiguous() for t in (q, kp, vp, ko, vo, do)]
    skew = q.flatten()[1: 1 + q.numel() - q[:, :1].numel()].view(8, 255, 16, 128)  # 2 bytes off 16
    refused = {
        "float16": ((q.half(), kp.half(), vp.half(), ko.half(), vo.half(), pb), do.half()),
        "head dim 96": ((*d96[:5], pb), d96[5]),
        "q 2 bytes off 16-byte alignment": ((skew, kp, vp, ko[:, 1:].contiguous(), vo[:, 1:].contiguous(), pb),
                                            do[:, 1:].contiguous()),
    }
    for what, (f, d) in refused.items():
        sc = f[0].shape[1]
        l, dl = lse[..., -sc:].contiguous(), delta[:, -sc:].contiguous()
        calls = {
            "shared_prefix_fwd": lambda: fa.shared_prefix_fwd(*f),
            "shared_prefix_bwd_dq": lambda: fa.shared_prefix_bwd_dq(*f, d, l, dl),
            "shared_prefix_bwd_dkv": lambda: fa.shared_prefix_bwd_dkv(f[0], f[1], f[2], f[5], d, l, dl),
        }
        for name, call in calls.items():
            try:
                call()
            except ValueError as e:
                log(f"[kernels] {name} refuses {what}: {e}")
            else:
                raise AssertionError(f"{name} took {what}")


def head_backward_check(gen) -> None:
    """The bf16 head's backward on the card against the product of the
    unrounded f32 cotangent (the JAX package's transpose keeps it in f32),
    taken in f64 and rounded to bf16: within one bf16 ulp of each output's
    scale. The cotangent has detail below bf16's spacing."""
    import torch

    from time_r1_tpu_torch.ops.quant import head_logits

    dev = torch.device("cuda")
    S, V, Hd = 64, 4096, 2048
    h = torch.randn(S, Hd, generator=gen, device=dev).bfloat16()
    w = (torch.randn(V, Hd, generator=gen, device=dev) * 0.05).bfloat16()
    base = torch.randn(S, V, generator=gen, device=dev).bfloat16().float()
    g = base + base.abs() * torch.rand(S, V, generator=gen, device=dev) * 2**-10
    hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
    dh, dw = torch.autograd.grad(head_logits(hh, ww), (hh, ww), g)
    want_dh = (g.double() @ w.double()).to(torch.bfloat16)
    want_dw = (g.double().t() @ h.double()).to(torch.bfloat16)
    for name, got, want in (("dh", dh, want_dh), ("dw", dw, want_dw)):
        scale = want.float().abs().max().item()
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        err = (got.float() - want.float()).abs().max().item()
        log(f"[kernels] bf16 head backward {name}: max |card - f32-cotangent product| = {err:.3e}, "
            f"one bf16 ulp of the scale {scale:.3e} = {ulp:.3e}")
        if not err <= ulp:
            raise AssertionError(f"bf16 head backward {name}: {err} > {ulp}")


# D1/D2 tolerances, as max |kernel - plain| / max |plain|: D1's (acc, m, l) are
# f32 sums over 1914 live keys of the same f32 operands in another order; D2's
# output is stored in the activation dtype (bf16 spacing 2^-8).
DECODE_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# Q1: the kernel scales the f32 sum and casts once; the plain version (the JAX
# package's reference) rounds the product to bf16 before the bf16 scale, so in
# bf16 the two differ by up to two bf16 roundings. Q2: both round x and the
# activation to bf16; the sums over 2048 and 11008 run in another order, which
# can move an activation across a bf16 rounding boundary.
QUANT_TOL = {"bfloat16": 1e-2, "float32": 1e-4}


def check_case(entry: dict, label: str, case: str, pairs, tol: float) -> None:
    """Hold one case's (kernel, plain) output pairs against each other: the
    absolute error and the relative one (max |kernel - plain| / max |plain|,
    the worst output), which the tolerance reads. The case's relative error
    goes to entry["cases"], the worst of both over the cases to
    entry["max_abs_err"] and entry["max_rel_err"]."""
    diffs = [(got.float() - want.float()).abs().max().item() for got, want in pairs]
    rels = [d / max(want.float().abs().max().item(), 1e-30) for d, (_, want) in zip(diffs, pairs)]
    if not np.isfinite(diffs + rels).all():
        raise AssertionError(f"{label} {case}: non-finite error {diffs}")
    abs_err, rel = max(diffs), max(rels)
    entry["cases"][case] = rel
    entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0), abs_err)
    entry["max_rel_err"] = max(entry.get("max_rel_err", 0.0), rel)
    log(f"[kernels] {label} {case}: max |kernel - plain| = {abs_err:.3e}, / max |plain| = {rel:.3e} (tol {tol})")
    if rel > tol:
        raise AssertionError(f"{label} {case}: max |kernel - plain| / max |plain| = {rel} > {tol}")


def decode_base(gen, P, R, H, Hkv, D, Lp, Lo, pad) -> dict:
    """f32 operands of a G-way decode step in the port's token-major layouts:
    q (B, 1, H, D), the prefix (P, Lp, Hkv, D) with `pad` left-pad keys in
    its (P, Lp) bias, the suffix (B, Lo, Hkv, D), the new token (B, Hkv, D)."""
    import torch

    from time_r1_tpu_torch.ops.attention import NEG_INF

    dev = torch.device("cuda")
    B = P * R

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    base = dict(q=randn(B, 1, H, D), kp=randn(P, Lp, Hkv, D), vp=randn(P, Lp, Hkv, D),
                ko=randn(B, Lo, Hkv, D), vo=randn(B, Lo, Hkv, D), kn=randn(B, Hkv, D), vn=randn(B, Hkv, D))
    base["bias"] = torch.where(torch.arange(Lp, device=dev)[None] < pad, NEG_INF, 0.0).float().expand(P, Lp).contiguous()
    base["P"], base["R"] = P, R
    return base


def decode_views(base: dict, dtype, int8: bool, lp: int | None = None) -> dict:
    """The decode path's layouts of `base`: q regrouped (P, Hkv, N, D);
    token-major caches handed over as head-major views; scales (..., Hkv)
    likewise. lp keeps the first lp prefix keys."""
    from time_r1_tpu_torch.ops.quant import quantize_kv

    P, R = base["P"], base["R"]
    _, _, H, D = base["q"].shape
    Hkv = base["kn"].shape[1]
    G = H // Hkv
    lp = base["kp"].shape[1] if lp is None else lp
    q = base["q"].to(dtype).reshape(P, R, Hkv, G, D).transpose(1, 2).reshape(P, Hkv, R * G, D)
    out = {"q": q, "kn": base["kn"].to(dtype), "vn": base["vn"].to(dtype), "bias": base["bias"][:, :lp].contiguous()}
    for n in ("kp", "vp", "ko", "vo"):
        src = base[n][:, :lp] if n in ("kp", "vp") else base[n]
        if int8:
            x8, s = quantize_kv(src)
            out[n], out[n + "_s"] = x8.transpose(1, 2), s.transpose(1, 2)
        else:
            out[n], out[n + "_s"] = src.to(dtype).transpose(1, 2), None
    return out


def d1_args(x):
    return x["q"], x["kp"], x["vp"], x["kp_s"], x["vp_s"], x["bias"]


def d2_args(x, own_len):
    return (x["q"], x["kp"], x["vp"], x["kp_s"], x["vp_s"], x["bias"], x["ko"], x["vo"], x["ko_s"], x["vo_s"],
            own_len, x["kn"], x["vn"])


# bf16 D2 edge cases (the tensor-core kernel): (P, R, H, Hkv, D, Lp, Lo, left
# pad keys), each over bf16 and int8 caches at suffix lengths 0, 1 and 199,
# two launches at 199 bit-equal. The 7B rollout's G = 7 (N = 56 rows, Hkv 4)
# runs on no other phase; R = 16 rollouts a prompt (N = 128 and, at G = 7,
# 112) take the prefix blocks' loop over 64-row tiles and the fold's over
# its row blocks; a pad of 300 masks the first chunk (256 keys) whole, 134
# the first two of its tiles (one per warpgroup); Lp 1000 ends in a partial
# tile and chunk.
D2_TC_CASES = {
    "7B rollout (N 56, Hkv 4)": (1, 8, 28, 4, 128, 2048, 256, 134),
    "16 rollouts (N 128)": (1, 16, 16, 2, 128, 2048, 256, 134),
    "7B, 16 rollouts (N 112, Hkv 4)": (1, 16, 28, 4, 128, 2048, 256, 134),
    "head dim 64": (1, 8, 16, 2, 64, 2048, 256, 134),
    "P 2 prompts of R 4": (2, 4, 16, 2, 128, 640, 256, 40),
    "pad 300, Lp 1000": (1, 8, 16, 2, 128, 1000, 256, 300),
}


def d2_tc_edge_cases(gen, d2: dict, phase2: dict) -> None:
    """bf16 D2 (the tensor-core kernel) at D2_TC_CASES against its plain
    version within DECODE_TOL; two launches at suffix 199 of each case and
    of phase 2's shape must be bit-equal; the wrapper must refuse f16 and
    head dim 96, and run on the tensor cores only."""
    import torch

    from time_r1_tpu_torch.ops import decode_attention as da

    tol = DECODE_TOL["bfloat16"]
    tc0 = da.shared_prefix_decode_full.tc_launches
    n0 = da.shared_prefix_decode_full.launches
    for case, (P, R, H, Hkv, D, Lp, Lo, pad) in D2_TC_CASES.items():
        base = decode_base(gen, P, R, H, Hkv, D, Lp, Lo, pad)
        for int8 in (False, True):
            x = decode_views(base, torch.bfloat16, int8)
            for own_len in (0, 1, 199):
                got = da.shared_prefix_decode_full(*d2_args(x, own_len))
                want = da.shared_prefix_decode_full_plain(*d2_args(x, own_len))
                label = f"{case}, {'int8' if int8 else 'bf16'} caches, suffix {own_len}"
                check_case(d2, "D2", label, [(got, want)], tol)
                if own_len == 199:
                    again = da.shared_prefix_decode_full(*d2_args(x, own_len))
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError(f"D2 {label}: two launches differ")
                    log(f"[kernels] D2 {label}: two launches bit-equal")
    for int8 in (False, True):
        args = d2_args(decode_views(phase2, torch.bfloat16, int8), 199)
        a, b = da.shared_prefix_decode_full(*args), da.shared_prefix_decode_full(*args)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"D2 ({'int8' if int8 else 'bf16'} caches): two launches differ")
        log(f"[kernels] D2 {'int8' if int8 else 'bf16'} caches: two launches bit-equal")
    runs = da.shared_prefix_decode_full.launches - n0
    if da.shared_prefix_decode_full.tc_launches - tc0 != runs:
        raise AssertionError(f"D2 bf16: {runs} launches, {da.shared_prefix_decode_full.tc_launches - tc0} on the "
                             f"tensor cores")
    x = decode_views(phase2, torch.float16, False)
    b96 = decode_base(gen, 1, 2, 4, 2, 96, 256, 16, 0)
    refused = {"float16": lambda: da.shared_prefix_decode_full(*d2_args(x, 10)),
               "head dim 96": lambda: da.shared_prefix_decode_full(*d2_args(decode_views(b96, torch.bfloat16, False),
                                                                            10))}
    for what, call in refused.items():
        try:
            call()
        except ValueError as e:
            log(f"[kernels] shared_prefix_decode_full refuses {what}: {e}")
        else:
            raise AssertionError(f"shared_prefix_decode_full took {what}")


def phase_decode_quant_kernels() -> dict:
    """D1, D2, Q1 and Q2 against their plain versions at the quantized
    rollout's shapes; times in bf16."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = decode_kernels(gen)
    out.update(quant_kernels(gen))
    return out


def decode_kernels(gen) -> dict:
    """D1 and D2 against their plain versions at the G-way rollout's shapes
    (one 2048-token prompt with 134 left-pad keys, G = 8 rows, the suffix
    cache of 256 slots), in bf16 and f32 activations, with caches in the
    activation dtype and in int8, and D2's tensor-core edge cases; times in
    bf16."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops import decode_attention as da

    dev = torch.device("cuda")
    H, Hkv, D, pad, P, R, Lp, Lo = 16, 2, 128, 134, 1, 8, 2048, 256
    G, B = H // Hkv, P * R
    N = R * G
    base = decode_base(gen, P, R, H, Hkv, D, Lp, Lo, pad)
    bias = base["bias"]

    def decode_inputs(dtype, int8: bool, lp: int = Lp):
        return decode_views(base, dtype, int8, lp)

    d1 = {"name": "shared_prefix_decode_attention", "cases": {}}
    d2 = {"name": "shared_prefix_decode_full", "cases": {}}
    for dtype in (torch.bfloat16, torch.float32):
        key = str(dtype).split(".")[-1]
        for int8 in (False, True):
            x = decode_inputs(dtype, int8)
            case = f"{key}, {'int8' if int8 else key} caches"
            got, want = da.shared_prefix_decode_attention(*d1_args(x)), da.shared_prefix_decode_attention_plain(*d1_args(x))
            check_case(d1, "D1 (acc, m, l)", case, list(zip(got, want)), DECODE_TOL["float32"])
            for own_len in (0, 1, 199):
                got = da.shared_prefix_decode_full(*d2_args(x, own_len))
                want = da.shared_prefix_decode_full_plain(*d2_args(x, own_len))
                check_case(d2, "D2", f"{case}, suffix {own_len}", [(got, want)], DECODE_TOL[key])
    # a prefix of 2000 keys, which fits no TPU block and ends in a partial
    # 64-key tile: the decode step takes D2 at any prefix length
    for int8 in (False, True):
        x = decode_inputs(torch.bfloat16, int8, lp=2000)
        case = f"bfloat16, {'int8' if int8 else 'bfloat16'} caches, Lp 2000"
        got, want = da.shared_prefix_decode_attention(*d1_args(x)), da.shared_prefix_decode_attention_plain(*d1_args(x))
        check_case(d1, "D1 (acc, m, l)", case, list(zip(got, want)), DECODE_TOL["float32"])
        got, want = da.shared_prefix_decode_full(*d2_args(x, 199)), da.shared_prefix_decode_full_plain(*d2_args(x, 199))
        check_case(d2, "D2", f"{case}, suffix 199", [(got, want)], DECODE_TOL["bfloat16"])
    d2_tc_edge_cases(torch.Generator(device=dev).manual_seed(8), d2, base)
    d1["tol"] = d1["tol_f32"] = DECODE_TOL["float32"]
    d2["tol"], d2["tol_f32"] = DECODE_TOL["bfloat16"], DECODE_TOL["float32"]

    # times: bf16 activations, bf16 and int8 caches, suffix length 199 (the
    # step in the middle of a 200-token rollout)
    live, own = Lp - pad, 199
    cat_k = torch.cat([base["kp"].expand(B, -1, -1, -1), base["ko"][:, :own], base["kn"][:, None]], 1)
    cat_v = torch.cat([base["vp"].expand(B, -1, -1, -1), base["vo"][:, :own], base["vn"][:, None]], 1)
    cat_mask = torch.cat([bias.expand(B, -1), torch.zeros(B, own + 1, device=dev)], 1)[:, None, None, :]
    qt = base["q"].transpose(1, 2).to(torch.bfloat16)
    kt, vt = cat_k.transpose(1, 2).to(torch.bfloat16), cat_v.transpose(1, 2).to(torch.bfloat16)
    mk = cat_mask.to(torch.bfloat16)
    sdpa_full = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mk, enable_gqa=True), 50)
    kpt, vpt = (base[n].transpose(1, 2).to(torch.bfloat16) for n in ("kp", "vp"))
    qp = base["q"].to(torch.bfloat16).reshape(P, R, H, D).transpose(1, 2)
    mp = bias[:, None, None, :].to(torch.bfloat16)
    sdpa_prefix = cuda_ms(lambda: F.scaled_dot_product_attention(qp, kpt, vpt, attn_mask=mp, enable_gqa=True), 50)
    for int8 in (False, True):
        x = decode_inputs(torch.bfloat16, int8)
        kv_bytes = 1 if int8 else 2
        scale_bytes = 2 * 4 if int8 else 0
        io_q = P * Hkv * N * D * 2
        d1_bytes = (P * Hkv * live * (2 * D * kv_bytes + scale_bytes) + io_q + Lp * P * 4
                    + P * Hkv * N * (D + 2) * 4)
        d2_bytes = (P * Hkv * live * (2 * D * kv_bytes + scale_bytes) + B * Hkv * own * (2 * D * kv_bytes + scale_bytes)
                    + 2 * B * Hkv * D * 2 + 2 * io_q + Lp * P * 4)
        suffix = " int8" if int8 else ""
        for e, fn, plain, args, flops, nbytes, lib in (
            (d1, da.shared_prefix_decode_attention, da.shared_prefix_decode_attention_plain, d1_args(x),
             4.0 * D * N * live * P * Hkv, d1_bytes, sdpa_prefix),
            (d2, da.shared_prefix_decode_full, da.shared_prefix_decode_full_plain, d2_args(x, own),
             4.0 * D * (N * live * P * Hkv + B * H * (own + 1)), d2_bytes, sdpa_full),
        ):
            ms, plain_ms = cuda_ms(lambda: fn(*args), 50), cuda_ms(lambda: plain(*args), 10)
            call = cuda_ms(lambda: fn(*args), 50, queued=False)
            b_ms, b_by = bound(flops, nbytes)
            if int8:
                e.update(ms_int8=ms, call_ms_int8=call, plain_ms_int8=plain_ms, bound_ms_int8=b_ms, bound_by_int8=b_by)
            else:
                e.update(ms=ms, kernel_ms=ms, call_ms=call, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib)
            log(f"[kernels] {e['name']}{suffix}: {ms:.4f} ms on the device, {call:.4f} ms per call from Python "
                f"(plain {plain_ms:.3f}, bound {b_ms:.5f} by {b_by}, library {lib:.4f})")
    d1["library_is"] = "SDPA of the 64 query rows over the prefix, bf16"
    d2["library_is"] = "SDPA over [prefix repeated per row | live suffix | new token] with the mask, bf16"
    for e in (d1, d2):
        e["tol_is"] = "on max_rel_err and each of `cases`: max |kernel - plain| / max |plain|"
    return {d1["name"]: d1, d2["name"]: d2}


def quant_kernels(gen) -> dict:
    """Q1 (`q1_kernel`), then Q2 (`q2_kernel`)."""
    q1 = q1_kernel(gen)
    q2 = q2_kernel(gen)
    return {q1["name"]: q1, q2["name"]: q2}


# Q1's checks: the int4 decode products (N, K) of Qwen2.5-VL 3B at M = 1, 8,
# 16, 200 and 256 rows (the JAX package's threshold) and of 7B at M = 8, and
# a ragged shape outside the tensor-core rule (N % 16, K % 128), in bf16 and
# f32; times at 3B M = 1, 8 and 200 and at 7B M = 8, bf16.
Q1_SHAPES = {
    "3B": {"qkv": (2560, 2048), "o": (2048, 2048), "gu": (22016, 2048), "down": (2048, 11008)},
    "7B": {"qkv": (4608, 3584), "o": (3584, 3584), "gu": (37888, 3584), "down": (3584, 18944)},
}
Q1_CASES = ([(M, "3B", name) for M in (1, 8, 16, 200, 256) for name in Q1_SHAPES["3B"]]
            + [(8, "7B", name) for name in Q1_SHAPES["7B"]])
Q1_RAGGED = (3, 300, 1000)  # M, N, K
Q1_TIMED = [(M, "3B") for M in (8, 1, 200)] + [(8, "7B")]
Q1_BIT_EQUAL = [(8, "3B", "gu"), (16, "3B", "down"), (200, "3B", "qkv"), (8, "7B", "down")]


def q1_kernel(gen) -> dict:
    """Q1 against its plain version at `Q1_CASES` and the ragged shape, in
    bf16 (the tensor-core kernel, the ragged shape the FMA kernel) and f32
    (the FMA kernel), each launch's route read from `.tc_launches`; two bf16
    launches bit-equal; the refusals; device times at `Q1_TIMED` beside the
    bound, the library and PyTorch's sum over the same bytes."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_plain
    from time_r1_tpu_torch.ops.quant import dequantize_weight, quantize_weight

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    weights = {}

    def weight(N, K):
        if (N, K) not in weights:
            weights[(N, K)] = quantize_weight(randn(N, K) * 0.02, bits=4)
        return weights[(N, K)]

    def routed(x, w, tensor_cores: bool, label: str):
        n0, tc0 = int4_matmul.launches, int4_matmul.tc_launches
        y = int4_matmul(x, w["q4"], w["s"])
        if int4_matmul.launches - n0 != 1 or int4_matmul.tc_launches - tc0 != int(tensor_cores):
            raise AssertionError(f"Q1 {label}: {int4_matmul.launches - n0} launches, "
                                 f"{int4_matmul.tc_launches - tc0} on the tensor cores; want 1, {int(tensor_cores)}")
        return y

    q1 = {"name": "int4_matmul", "cases": {}, "per_product": {}}
    ragged = (Q1_RAGGED[0], "ragged", None)
    for M, model, name in Q1_CASES + [ragged]:
        N, K = Q1_SHAPES[model][name] if model != "ragged" else Q1_RAGGED[1:]
        w = weight(N, K)
        xf = randn(M, K)
        for dtype in (torch.bfloat16, torch.float32):
            key = str(dtype).split(".")[-1]
            case = f"{model}{' ' + name if name else ''} M={M} ({N}, {K}) {key}"
            x = xf.to(dtype)
            got = routed(x, w, dtype is torch.bfloat16 and model != "ragged", case)
            check_case(q1, "Q1", case, [(got, int4_matmul_plain(x, w["q4"], w["s"]))], QUANT_TOL[key])
    for M, model, name in Q1_BIT_EQUAL:
        N, K = Q1_SHAPES[model][name]
        w = weight(N, K)
        x = randn(M, K).to(torch.bfloat16)
        if not torch.equal(int4_matmul(x, w["q4"], w["s"]), int4_matmul(x, w["q4"], w["s"])):
            raise AssertionError(f"Q1 {model} {name} M={M}: two launches differ")
        log(f"[kernels] Q1 {model} {name} M={M}: two launches bit-equal")
    w = weight(2048, 2048)
    x = randn(8, 2048).to(torch.bfloat16)
    bad = {
        "float16 x": (x.half(), w["q4"], w["s"]),
        "w4 of the wrong width": (x, w["q4"][:, :-16].contiguous(), w["s"]),
        "float64 scales": (x, w["q4"], w["s"].double()),
        "a non-contiguous x": (randn(2048, 8).to(torch.bfloat16).t(), w["q4"], w["s"]),
        "a misaligned bf16 x": (randn(8 * 2048 + 1).to(torch.bfloat16)[1:].view(8, 2048), w["q4"], w["s"]),
    }
    refused = []
    for what, args in bad.items():
        before = int4_matmul.launches
        try:
            int4_matmul(*args)
        except ValueError as e:
            refused.append(what)
            log(f"[kernels] Q1 refuses {what}: {e}")
        else:
            raise AssertionError(f"Q1 took {what}")
        if int4_matmul.launches != before:
            raise AssertionError("Q1 counted a refused launch")
    torch.cuda.synchronize()
    q1["refused"] = refused

    for M, model in Q1_TIMED:
        sums = {k: 0.0 for k in ("ms", "library_ms", "bound_ms", "read_yardstick_ms")}
        for name, (N, K) in Q1_SHAPES[model].items():
            w = weight(N, K)
            x = randn(M, K).to(torch.bfloat16)
            wd = dequantize_weight(w, torch.bfloat16)
            t = dict(ms=cuda_ms(lambda: int4_matmul(x, w["q4"], w["s"]), 50),
                     library_ms=cuda_ms(lambda: F.linear(x, wd), 50),
                     # one PyTorch reduction over the same packed bytes: the card's streaming rate as PyTorch sees it
                     read_yardstick_ms=cuda_ms(lambda: w["q4"].view(torch.float32).sum(), 50))
            if (M, model) == (8, "3B"):
                t["call_ms"] = cuda_ms(lambda: int4_matmul(x, w["q4"], w["s"]), 50, queued=False)
                t["plain_ms"] = cuda_ms(lambda: int4_matmul_plain(x, w["q4"], w["s"]), 10)
            del wd
            weight_bytes = N * K // 2
            t["bound_ms"], t["bound_by"] = bound(2.0 * M * N * K, weight_bytes + N * 4 + M * K * 2 + M * N * 2)
            t["weight_gbps"] = weight_bytes / t["ms"] / 1e6
            t["bound_share"] = t["bound_ms"] / t["ms"]
            q1["per_product"][f"{model} M={M} {name}"] = t
            for k in sums:
                sums[k] += t[k]
            log(f"[kernels] int4_matmul {model} {name} ({N}, {K}) M={M}: {t['ms']:.4f} ms on the device "
                f"({t['weight_gbps']:.0f} GB/s of int4 weights, {100 * t['bound_share']:.1f}% of the bound "
                f"{t['bound_ms']:.5f} by {t['bound_by']}), library {t['library_ms']:.4f}, PyTorch's sum over the "
                f"bytes {t['read_yardstick_ms']:.4f}"
                + (f", {t['call_ms']:.4f} per call from Python, plain {t['plain_ms']:.3f}" if "call_ms" in t else ""))
        log(f"[kernels] int4_matmul {model} M={M}, a layer's four products: {sums['ms']:.4f} ms (bound "
            f"{sums['bound_ms']:.5f}, {100 * sums['bound_ms'] / sums['ms']:.1f}%; library {sums['library_ms']:.4f}; "
            f"PyTorch's sums {sums['read_yardstick_ms']:.4f})")
        if (M, model) == (8, "3B"):
            q1.update(sums)
            q1["bound_by"] = "/".join(sorted({q1["per_product"][f"3B M=8 {n}"]["bound_by"] for n in Q1_SHAPES["3B"]}))
            for k in ("call_ms", "plain_ms"):
                q1[k] = sum(q1["per_product"][f"3B M=8 {n}"][k] for n in Q1_SHAPES["3B"])
        else:
            q1[f"layer_{model}_M{M}"] = sums
    q1["kernel_ms"] = q1["ms"]
    q1["times_are"] = "sums over one 3B layer's four products (qkv, o, gu, down) at M = 8, bf16 (tensor cores)"
    q1["library_is"] = "F.linear in bf16 over weights dequantized before timing (4x the weight bytes)"
    q1["tol"], q1["tol_f32"] = QUANT_TOL["bfloat16"], QUANT_TOL["float32"]
    q1["tol_is"] = "on max_rel_err and each of `cases`: max |kernel - plain| / max |plain|"
    return q1


# Q2's checks, (hid, inter, M): the 3B widths at the decode's M and past one
# 16-row pass, the 7B widths, and a shape only the port takes (inter 272 is
# no multiple of 64: a ragged last 64-deep block in phase B).
Q2_CASES = [(2048, 11008, M) for M in (1, 4, 7, 8, 16, 128)] + [(3584, 18944, 7), (3584, 18944, 8), (256, 272, 3)]


# Q2 is held with its two phases apart (`q2_phases_apart`) in every case, and
# in bf16 also end to end at QUANT_TOL. In f32 the end-to-end error is
# logged, not held: the function rounds each activation, an f32 sum over hid
# products, to bf16, so two right implementations that sum in other orders
# (the kernel and cuBLAS under the plain version) round some activations to
# neighbouring bf16 values (1 to 4 in 10^4 here, at every M); one step of
# a large activation moves an output by a few 1e-4 of the largest, past
# QUANT_TOL's 1e-4, and how many such flips a case has depends on its data.
Q2_FLIP_SHARE = 1e-3  # the most activations allowed one bf16 step off the plain version's


def q2_phases_apart(y, act, x, gu_q8, gu_s, down_q8, down_s) -> dict:
    """Q2's two phases held apart: phase A's bf16 activation against the
    plain version's f32 activation (each element within one bf16 step of it,
    plus the worst-case error of an f32 sum of hid products in any order,
    hid·2^-24·Σ|terms|, carried through silu(g)·u; at most Q2_FLIP_SHARE of
    them not the nearest bf16), and phase B's output against the plain down
    product over the kernel's own activation (QUANT_TOL: sums in another
    order, and in bf16 the output's rounding)."""
    import torch
    import torch.nn.functional as F

    hid, inter = x.shape[1], down_q8.shape[1]
    xb = x.to(torch.bfloat16).float()
    wg, wu = gu_q8[:inter].float(), gu_q8[inter:].float()
    sg, su = gu_s[:inter].reshape(-1), gu_s[inter:].reshape(-1)
    g, u = (xb @ wg.t()) * sg, (xb @ wu.t()) * su
    pre = F.silu(g) * u
    near = pre.to(torch.bfloat16).float()
    # the bf16 spacing at each value: the next bf16 after |near| (bits + 1), less |near|
    step = (near.abs().to(torch.bfloat16).view(torch.int16) + 1).view(torch.bfloat16).float() - near.abs()
    eps = hid * 2.0**-24
    bg, bu = eps * (xb.abs() @ wg.abs().t()) * sg, eps * (xb.abs() @ wu.abs().t()) * su
    slack = 1.1 * u.abs() * bg + F.silu(g).abs() * bu  # |silu'| <= 1.1
    got = act.float()
    off = got != near
    outside = ((got - pre).abs() >= step + slack).sum().item()
    share = off.float().mean().item()
    want = ((got @ down_q8.float().t()) * down_s.reshape(-1)).to(y.dtype)
    rel = (y.float() - want.float()).abs().max().item() / want.float().abs().max().item()
    key = str(y.dtype).split(".")[-1]
    out = dict(activation_off_share=share, activation_outside=outside, down_rel_err=rel)
    if outside or share > Q2_FLIP_SHARE or not rel <= QUANT_TOL[key]:
        raise AssertionError(f"Q2 phases apart: {out} (share <= {Q2_FLIP_SHARE}, rel <= {QUANT_TOL[key]})")
    return out


def q2_kernel(gen) -> dict:
    """Q2 against its plain version at `Q2_CASES` in bf16 and f32, two
    launches bit-equal (one and two 8-row tiles a pass), the refusals
    (inter % 16, M > 128, hid beyond the block's shared memory) before any
    launch; device times at the 3B rollout shape (M = 8, bf16) and at 7B."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops.fused_mlp import _launch as fused_mlp_launch
    from time_r1_tpu_torch.ops.fused_mlp import fused_mlp_int8, fused_mlp_int8_plain
    from time_r1_tpu_torch.ops.quant import dequantize_weight, quantize_weight

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    weights = {}

    def mlp(hid, inter):
        if (hid, inter) not in weights:
            weights[(hid, inter)] = (quantize_weight(randn(2 * inter, hid) * 0.02),
                                     quantize_weight(randn(hid, inter) * 0.02))
        return weights[(hid, inter)]

    q2 = {"name": "fused_mlp_int8", "cases": {}, "phases_apart": {}, "end_to_end_f32": {}}
    for hid, inter, M in Q2_CASES:
        gu, dn = mlp(hid, inter)
        xf = randn(M, hid)
        for dtype in (torch.bfloat16, torch.float32):
            key = str(dtype).split(".")[-1]
            case = f"M={M} hid={hid} inter={inter} {key}"
            args = (xf.to(dtype), gu["q8"], gu["s"], dn["q8"], dn["s"])
            y, act = fused_mlp_launch(*args)
            q2["phases_apart"][case] = q2_phases_apart(y, act, *args)
            want = fused_mlp_int8_plain(*args)
            if dtype is torch.float32:  # logged, not held: see Q2_FLIP_SHARE
                rel = (y - want).abs().max().item() / want.abs().max().item()
                q2["end_to_end_f32"][case] = rel
                log(f"[kernels] Q2 {case}: max |kernel - plain| / max |plain| = {rel:.3e} (activation rounding "
                    f"flips; held with its phases apart)")
            else:
                check_case(q2, "Q2", case, [(y, want)], QUANT_TOL[key])
    gu, dn = mlp(2048, 11008)
    for M in (8, 16):
        args = (randn(M, 2048).to(torch.bfloat16), gu["q8"], gu["s"], dn["q8"], dn["s"])
        first, second = fused_mlp_int8(*args), fused_mlp_int8(*args)
        if not torch.equal(first, second):
            raise AssertionError(f"Q2 M={M}: two launches differ")
        log(f"[kernels] Q2 M={M}: two launches bit-equal")
    refused = []
    for M, hid, inter in ((8, 2048, 11000), (129, 2048, 11008), (16, 4736, 1024)):
        g2, d2 = (gu, dn) if (hid, inter) == (2048, 11008) else (
            {"q8": torch.zeros((2 * inter, hid), dtype=torch.int8, device=dev),
             "s": torch.ones((2 * inter, 1), device=dev)},
            {"q8": torch.zeros((hid, inter), dtype=torch.int8, device=dev), "s": torch.ones((hid, 1), device=dev)})
        before = fused_mlp_int8.launches
        try:
            fused_mlp_int8(randn(M, hid).to(torch.bfloat16), g2["q8"], g2["s"], d2["q8"], d2["s"])
        except ValueError as e:
            refused.append(f"M={M} hid={hid} inter={inter}")
            log(f"[kernels] Q2 refuses M={M} hid={hid} inter={inter}: {e}")
        else:
            raise AssertionError(f"Q2 took M={M} hid={hid} inter={inter}")
        if fused_mlp_int8.launches != before:
            raise AssertionError("Q2 counted a refused launch")
    torch.cuda.synchronize()
    q2["refused"] = refused

    def timings(hid, inter, M=8):
        gu, dn = mlp(hid, inter)
        args = (randn(M, hid).to(torch.bfloat16), gu["q8"], gu["s"], dn["q8"], dn["s"])
        gud, dnd = dequantize_weight(gu, torch.bfloat16), dequantize_weight(dn, torch.bfloat16)

        def library():
            g, u = F.linear(args[0], gud).chunk(2, dim=-1)
            return F.linear(F.silu(g) * u, dnd)

        t = dict(ms=cuda_ms(lambda: fused_mlp_int8(*args), 50),
                 call_ms=cuda_ms(lambda: fused_mlp_int8(*args), 50, queued=False),
                 plain_ms=cuda_ms(lambda: fused_mlp_int8_plain(*args), 10),
                 library_ms=cuda_ms(library, 50))
        weight_bytes = 3 * inter * hid
        t["bound_ms"], t["bound_by"] = bound(2.0 * M * hid * 3 * inter,
                                             weight_bytes + (2 * inter + hid) * 4 + 2 * M * hid * 2)
        t["weight_gbps"] = weight_bytes / t["ms"] / 1e6
        t["bound_share"] = t["bound_ms"] / t["ms"]
        log(f"[kernels] fused_mlp_int8 hid={hid} inter={inter} M={M}: {t['ms']:.4f} ms on the device "
            f"({t['weight_gbps']:.0f} GB/s of int8 weights, {100 * t['bound_share']:.1f}% of the bound), "
            f"{t['call_ms']:.4f} ms per call from Python (plain {t['plain_ms']:.3f}, bound {t['bound_ms']:.5f} by "
            f"{t['bound_by']}, library {t['library_ms']:.4f})")
        return t

    q2.update(timings(2048, 11008))
    q2["kernel_ms"] = q2["ms"]
    q2["at_7b"] = timings(3584, 18944)
    q2["library_is"] = "two F.linear in bf16 over weights dequantized before timing, silu between (2x the bytes)"
    q2["tol"], q2["tol_f32"] = QUANT_TOL["bfloat16"], QUANT_TOL["float32"]
    q2["tol_is"] = ("on max_rel_err and each of `cases` (bf16): max |kernel - plain| / max |plain|; every case "
                    "in bf16 and f32 with its phases apart (`phases_apart`, tol on down_rel_err)")
    return q2


# P1/P2 tolerances, as max |kernel - plain| / max |plain| per output: both sides
# sum the same f32 products of the same (bf16 or f32) operands, in another
# order, over up to 4096 keys.
PAGED_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def paged_case(gen, dev, lengths, P: int, max_pages: int, n_pages: int, stale_from: int | None = None,
               G: int = 8, D: int = 128, nkv: int = 2) -> dict:
    """One paged-attention input set: q (S, nkv, G, D), pages (nkv, n_pages,
    P, D) in f32 (cast per dtype by the caller), int8 pages and scales from
    them, and a page table whose live entries are a shuffle of pages 1.. (page
    0 is the engine's scratch sink; dead entries point at it). stale_from:
    slot 0 (length 0) takes that slot's table row, as a retired slot's stale
    row points at pages another slot owns."""
    import torch

    from time_r1_tpu_torch.ops.quant import quantize_kv

    S = len(lengths)
    need = [-(-n // P) for n in lengths]
    perm = (torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(P + sum(lengths))) + 1).tolist()
    assert sum(need) <= len(perm), "the pool holds every live page"
    table = torch.zeros((S, max_pages), dtype=torch.int32)
    at = 0
    for s, n in enumerate(need):
        table[s, :n] = torch.tensor(perm[at:at + n], dtype=torch.int32)
        at += n
    if stale_from is not None:
        table[0] = table[stale_from]
    kp = torch.randn((nkv, n_pages, P, D), generator=gen, device=dev)
    vp = torch.randn((nkv, n_pages, P, D), generator=gen, device=dev)
    k8, ks = quantize_kv(kp)
    v8, vs = quantize_kv(vp)
    return dict(q=torch.randn((S, nkv, G, D), generator=gen, device=dev), kp=kp, vp=vp, k8=k8, v8=v8, ks=ks, vs=vs,
                table=table.to(dev), lengths=torch.tensor(lengths, dtype=torch.int32, device=dev), P=P)


def phase_paged_kernels() -> dict:
    """P1 and P2 against their plain versions: the phase-7 decode step's shape
    (4 slots, 2 kv heads, G = 8, hd 128, P = 128, 32-page table rows over a
    128-page pool, lengths 0, 327, 1689, 2041), then P = 16 with lengths 0, 37,
    300, every slot at its full 32·128 keys, a dead slot whose stale row
    points at another slot's pages, head dim 64 with G = 12 (more rows than
    the f32 route's 8 warps) and the 7B's G = 7 over 4 kv heads; q and pages
    in bf16 and f32 (P2: int8 pages, q in bf16 and f32). bf16 runs the
    tensor-core kernel (each launch's route read from `.tc_launches`; two
    launches bit-equal), f32 the FMA kernels only. An empty slot must end at
    exactly m = -1e30, l = 0, acc = 0. Times at the main shape in bf16."""
    import torch
    import torch.nn.functional as F

    from time_r1_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = {
        "main": paged_case(gen, dev, (0, 327, 1689, 2041), 128, 32, 128),
        "P16": paged_case(gen, dev, (0, 37, 300), 16, 32, 128),
        "full": paged_case(gen, dev, (4096,) * 4, 128, 32, 129),
        "dead slot": paged_case(gen, dev, (0, 327, 1689, 2041), 128, 32, 128, stale_from=3),
        "hd 64, G 12": paged_case(gen, dev, (5, 0, 200), 32, 8, 32, G=12, D=64),
        "7B (Hkv 4, G 7)": paged_case(gen, dev, (0, 327, 1689, 2041), 128, 32, 128, G=7, nkv=4),
    }
    p1 = {"name": "paged_prefix_attention", "cases": {}}
    p2 = {"name": "paged_prefix_attention_q8", "cases": {}}

    def p1_args(c, dtype):
        return c["q"].to(dtype), c["kp"].to(dtype), c["vp"].to(dtype), c["table"], c["lengths"], c["P"]

    def p2_args(c, dtype):
        return c["q"].to(dtype), c["k8"], c["v8"], c["ks"], c["vs"], c["table"], c["lengths"], c["P"]

    def upcast(args):
        return [a.float() if isinstance(a, torch.Tensor) and a.is_floating_point() else a for a in args]

    for label, c in cases.items():
        live = c["lengths"] > 0
        for dtype in (torch.bfloat16, torch.float32):
            key = str(dtype).split(".")[-1]
            for e, fn, plain, args in ((p1, pa.paged_prefix_attention, pa.paged_prefix_attention_plain, p1_args(c, dtype)),
                                       (p2, pa.paged_prefix_attention_q8, pa.paged_prefix_attention_q8_plain,
                                        p2_args(c, dtype))):
                n0, tc0 = fn.launches, fn.tc_launches
                (acc, m, l), (acc_w, m_w, l_w) = fn(*args), plain(*upcast(args))
                torch.cuda.synchronize()
                tc = dtype is torch.bfloat16  # bf16 on the tensor cores, f32 on the FMA kernels, every launch
                if (fn.launches - n0, fn.tc_launches - tc0) != (1, int(tc)):
                    raise AssertionError(f"{e['name']} {label} {key}: {fn.launches - n0} launches, "
                                         f"{fn.tc_launches - tc0} on the tensor cores")
                if tc:
                    again = fn(*args)
                    torch.cuda.synchronize()
                    if not all(torch.equal(x, y) for x, y in zip((acc, m, l), again)):
                        raise AssertionError(f"{e['name']} {label} {key}: two launches differ")
                # m over the live slots: an empty slot's -1e30 would swamp the scale
                check_case(e, e["name"], f"{label}, {key}", [(acc, acc_w), (m[live], m_w[live]), (l, l_w)],
                           PAGED_TOL[key])
                dead = ~live
                if not (torch.all(m[dead] == pa.NEG_INF) and torch.all(l[dead] == 0) and torch.all(acc[dead] == 0)):
                    raise AssertionError(f"{e['name']} {label} {key}: an empty slot is not at m = -1e30, l = 0, acc = 0")
    log("[kernels] P1/P2 bf16: every case on the tensor cores, two launches bit-equal; f32 on the FMA kernels")
    for e in (p1, p2):
        e["tol"], e["tol_f32"] = PAGED_TOL["bfloat16"], PAGED_TOL["float32"]
        e["tol_is"] = "on max_rel_err and each of `cases`: max |kernel - plain| / max |plain| per output (m over live slots)"

    # times at the main shape, bf16 q (and pages for P1)
    c = cases["main"]
    S, nkv, G, D = c["q"].shape
    lens = c["lengths"].tolist()
    live_keys = sum(lens)
    view = c["table"].shape[1] * c["P"]
    idx = c["table"].long()
    qt = c["q"].to(torch.bfloat16).reshape(S, nkv * G, 1, D)
    # the library yardstick: one SDPA over the pre-gathered contiguous view,
    # GQA expanded to 16 heads, with a length mask (gathered before timing)
    kt = c["kp"].to(torch.bfloat16)[:, idx].reshape(nkv, S, view, D).transpose(0, 1).repeat_interleave(G, dim=1)
    vt = c["vp"].to(torch.bfloat16)[:, idx].reshape(nkv, S, view, D).transpose(0, 1).repeat_interleave(G, dim=1)
    mask = torch.where(torch.arange(view, device=dev)[None] < c["lengths"][:, None], 0.0, -1e4)
    mask = mask.to(torch.bfloat16)[:, None, None, :]
    sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), 50)
    out_bytes = S * nkv * G * (D + 2) * 4
    small = S * nkv * G * D * 2 + c["table"].numel() * 4 + S * 4 + out_bytes
    for e, fn, plain, args, kv_bytes in (
        (p1, pa.paged_prefix_attention, pa.paged_prefix_attention_plain, p1_args(c, torch.bfloat16),
         live_keys * nkv * D * 2 * 2),
        (p2, pa.paged_prefix_attention_q8, pa.paged_prefix_attention_q8_plain, p2_args(c, torch.bfloat16),
         live_keys * nkv * (D * 1 * 2 + 4 * 2)),
    ):
        ms, plain_ms = cuda_ms(lambda: fn(*args), 50), cuda_ms(lambda: plain(*args), 10)
        call = cuda_ms(lambda: fn(*args), 50, queued=False)
        b_ms, b_by = bound(4.0 * live_keys * nkv * G * D, kv_bytes + small)
        e.update(ms=ms, kernel_ms=ms, call_ms=call, plain_ms=plain_ms, library_ms=sdpa, bound_ms=b_ms, bound_by=b_by,
                 live_kv_bytes=kv_bytes)
        log(f"[kernels] {e['name']}: {ms:.4f} ms on the device, {call:.4f} ms per call from Python "
            f"(plain {plain_ms:.3f}, bound {b_ms:.5f} by {b_by}, library {sdpa:.4f})")
    p1["library_is"] = ("SDPA of the 16 query heads over the pre-gathered (4, 16, 4096, 128) bf16 view, GQA expanded, "
                        "length mask")
    p2["library_is"] = "P1's row: the same SDPA over the view dequantized to bf16 before timing"
    return {p1["name"]: p1, p2["name"]: p2}


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


def to_device(tree, device, scale: float = 1.0):
    """A copy of a parameter tree on `device`, optionally scaled."""
    if isinstance(tree, dict):
        return {k: to_device(v, device, scale) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device, scale) for v in tree]
    return (tree.detach() * scale).to(device) if scale != 1.0 else tree.detach().to(device, copy=True)


def phase_reduced_depth() -> None:
    import torch

    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.sampler import Engine, SamplingParams

    cfg = reduced_config()
    torch.set_num_threads(os.cpu_count() or 1)
    params_cpu = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    params_gpu = to_device(params_cpu, torch.device("cuda"))
    req = video_request(cfg, np.random.default_rng(1), frames=8, height=224, width=392)
    sp = SamplingParams(max_new_tokens=8, stop_token_ids=())
    out = {}
    for device, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        eng = Engine(params, cfg, dtype=torch.float32, device=device)
        t0 = time.perf_counter()
        reset_launches()
        logits = eng.last_token_logits([req])
        tokens = eng.generate([req], sp)[0]
        if device == "cuda":  # f32: K1 and K3 take the exact FMA kernels
            check_tc_route("reduced", read_launches(), {n: None for n in FWD_TC}, tensor_cores=False)
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


def reduced_config():
    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig

    base = Qwen25VLConfig.qwen25vl_3b()
    return replace(
        base,
        vision=replace(base.vision, depth=2, fullatt_block_indexes=(1,)),
        text=replace(base.text, num_hidden_layers=2),
    )


# Phase 3b tolerance, max |card - cpu| / max |cpu| per gradient leaf (and for
# the loss and metrics): f32 on both sides, with sums in other orders in the
# attention kernels (up to 896 keys), in cuBLAS against the CPU's GEMMs over
# reductions 2048-11008 wide, and in the 151936-way log-softmax.
TRAIN_TOL = 1e-3


def phase_reduced_train() -> None:
    """One GRPO loss step at reduced depth, card (kernels) against CPU (plain),
    with the frozen ViT (fix_vit, the default) and with the whole tower
    trained (fix_vit=False: the differentiated tower runs off K2/K3, which
    have no backward; the reference forward still takes them)."""
    import torch

    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.rl import GRPOHyperParams, build_grpo_split_batch
    from time_r1_tpu_torch.rl.grpo import compute_ref_logps, grpo_value_and_grad, precompute_frozen_vision

    cfg = reduced_config()
    params_cpu = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    # the reference model: the same weights scaled, so that the KL term is not zero
    ref_cpu = to_device(params_cpu, torch.device("cpu"), scale=0.98)
    req = video_request(cfg, np.random.default_rng(1), frames=8, height=224, width=392)
    rng = np.random.default_rng(2)
    eos = cfg.eos_token_id
    comps = [rng.integers(0, 151000, n).tolist() + ([eos] if i % 2 == 0 else []) for i, n in enumerate((20, 57, 101, 127))]
    group = {"prompt_ids": req.input_ids, "completions": comps,
             "advantages": np.array([1.0, -0.5, 0.25, -0.75], np.float32),
             "patches": req.patches, "grid_thw": req.grid_thw, "second_per_grid_t": 1.0}
    for fix_vit in (True, False):
        tag = "train-reduced" if fix_vit else "train-reduced fix_vit=False"
        hp = GRPOHyperParams(num_generations=4, beta=0.04, fix_vit=fix_vit)
        out = {}
        for device in ("cuda", "cpu"):
            dev = torch.device(device)
            params = to_device(params_cpu, dev)
            ref = ref_cpu if device == "cpu" else to_device(ref_cpu, dev)
            t0 = time.perf_counter()
            reset_launches()
            batch = build_grpo_split_batch(cfg, [group], dtype=torch.float32, device=dev)
            if fix_vit:
                batch = precompute_frozen_vision(params, cfg, batch)
            batch = batch._replace(ref_logps=compute_ref_logps(ref, cfg, hp, batch))
            before = read_launches()
            loss, metrics, grads = grpo_value_and_grad(params, cfg, hp, batch)
            after = read_launches()
            if device == "cuda":  # f32: B1, B2, S1, S2 take the exact FMA kernels, never the tensor cores
                attention = [n for n in TC_KERNELS if n not in DECODE_KERNELS + PAGED_KERNELS + ("int4_matmul",)]
                check_tc_route(tag, after, {n: None for n in attention}, tensor_cores=False)
                vit = {n: (before[n], after[n]) for n in ("window_attention_rope", "full_attention_rope")}
                log(f"[{tag}] K2/K3 launches before / after the differentiated call: {vit}")
                if any(a != b or b <= 0 for b, a in vit.values()):  # the frozen blocks (or ref) ran them
                    raise AssertionError(f"{tag}: K2/K3 launches moved inside the loss or never ran: {vit}")
            out[device] = (float(loss), {k: float(v) for k, v in metrics.items()}, [g.cpu() for g in grads])
            log(f"[{tag}] {device}: {time.perf_counter() - t0:.1f} s, prompt {len(req.input_ids)} tokens, "
                f"Lp {batch.prompt_ids.shape[1]}, Lc {batch.comp_ids.shape[1]}, loss {float(loss):.6f}, "
                f"metrics {out[device][1]}")
        (lg, mg, gg), (lc, mc, gc) = out["cuda"], out["cpu"]
        worst = 0.0
        for g, c in zip(gg, gc):
            scale = c.abs().max().item()
            if scale > 0:
                worst = max(worst, (g - c).abs().max().item() / scale)
        live = sum(int(c.abs().max().item() > 0) for c in gc)
        loss_err = abs(lg - lc) / max(abs(lc), 1e-30)
        metric_err = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6) for k in mc)
        log(f"[{tag}] card vs cpu: loss {loss_err:.3e}, metrics {metric_err:.3e}, worst gradient leaf "
            f"{worst:.3e} of {len(gc)} ({live} non-zero; max |Δ| / max |g|, tol {TRAIN_TOL})")
        if not (np.isfinite(lg) and loss_err <= TRAIN_TOL and metric_err <= TRAIN_TOL and worst <= TRAIN_TOL):
            raise AssertionError(f"{tag}: card and CPU disagree")


def kernel_wrappers():
    """Every kernel wrapper of the port, by the name its phase-2 entry has
    (S2's two kernels count apart)."""
    from time_r1_tpu_torch.ops import decode_attention as da
    from time_r1_tpu_torch.ops import flash_attention as fa
    from time_r1_tpu_torch.ops.fused_mlp import fused_mlp_int8
    from time_r1_tpu_torch.ops.int4_matmul import int4_matmul
    from time_r1_tpu_torch.ops.paged_attention import paged_prefix_attention, paged_prefix_attention_q8
    from time_r1_tpu_torch.ops.vision_attention import full_attention_rope, window_attention_rope

    return {
        "flash_attention": fa.flash_attention_fwd,
        "window_attention_rope": window_attention_rope,
        "full_attention_rope": full_attention_rope,
        "flash_bwd_dq": fa.flash_bwd_dq,
        "flash_bwd_dkv": fa.flash_bwd_dkv,
        "shared_prefix_fwd": fa.shared_prefix_fwd,
        "shared_prefix_bwd": fa.shared_prefix_bwd_dq,
        "shared_prefix_bwd_dkv": fa.shared_prefix_bwd_dkv,
        "shared_prefix_decode_attention": da.shared_prefix_decode_attention,
        "shared_prefix_decode_full": da.shared_prefix_decode_full,
        "int4_matmul": int4_matmul,
        "fused_mlp_int8": fused_mlp_int8,
        "paged_prefix_attention": paged_prefix_attention,
        "paged_prefix_attention_q8": paged_prefix_attention_q8,
    }


# wrappers that also count tensor-core launches (bf16); the rest of their
# launches ran the f32 FMA kernels
TC_KERNELS = ("flash_attention", "window_attention_rope", "full_attention_rope", "flash_bwd_dq", "flash_bwd_dkv",
              "shared_prefix_fwd", "shared_prefix_bwd", "shared_prefix_bwd_dkv", "shared_prefix_decode_full",
              "int4_matmul", "paged_prefix_attention", "paged_prefix_attention_q8")
FWD_TC = ("flash_attention", "window_attention_rope", "full_attention_rope")  # K1-K3: every serving and rollout path


def reset_launches() -> None:
    for name, fn in kernel_wrappers().items():
        fn.launches = 0
        if name in TC_KERNELS:
            fn.tc_launches = 0


def read_launches() -> dict:
    """Every wrapper's launches; for those of TC_KERNELS also `<name>_tc`,
    their tensor-core launches (the rest ran the FMA kernels)."""
    wrappers = kernel_wrappers()
    out = {name: fn.launches for name, fn in wrappers.items()}
    out.update({f"{name}_tc": wrappers[name].tc_launches for name in TC_KERNELS})
    return out


def check_tc_route(tag: str, launches: dict, want: dict, tensor_cores: bool) -> None:
    """Each kernel `name` of `want` (of TC_KERNELS) ran `want[name]` launches
    (None: at least one), all on the tensor-core kernels (bf16) or all on the
    f32 FMA kernels."""
    for name in want:
        n, tc = launches[name], launches[f"{name}_tc"]
        fma = n - tc
        log(f"[{tag}] {name}: {tc} tensor-core launches, {fma} FMA launches")
        if (want[name] is not None and n != want[name]) or n <= 0 or (fma if tensor_cores else tc) != 0:
            raise AssertionError(f"{tag}: {name} ran {tc} tensor-core and {fma} FMA launches, want "
                                 f"{want[name]} {'tensor-core' if tensor_cores else 'FMA'} launches only")


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
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = eng.generate(reqs, sp)
    total = time.perf_counter() - t0
    launches = {k: v for k, v in read_launches().items() if k in SERVING_KEYS}
    check_tc_route("full", launches, vision_tc_launches(cfg) | {"flash_attention": cfg.text.num_hidden_layers},
                   tensor_cores=True)
    tm = eng.timings
    n_gen = sum(len(o) for o in out)
    log(f"[full] launches on the main path: {launches}")
    log(f"[full] vision {tm['vision_s'] * 1e3:.1f} ms, prefill {tm['prefill_s'] * 1e3:.1f} ms, "
        f"decode {tm['decode_s'] * 1e3 / max(tm['decode_steps'], 1):.2f} ms/step over {tm['decode_steps']} steps, "
        f"{n_gen} tokens generated, {n_gen / tm['decode_s']:.1f} tok/s in decode, "
        f"{total:.2f} s for the generate() call, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    for name in SERVING_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if not all(len(o) >= 1 for o in out):
        raise AssertionError("a request produced no tokens")
    logits = eng.last_token_logits(reqs)
    if logits.shape != (2, cfg.text.vocab_size) or not np.isfinite(logits).all():
        raise AssertionError(f"bad last-position logits: shape {logits.shape}")
    log(f"[full] last-position logits finite; argmax {logits.argmax(-1).tolist()}, "
        f"first generated {[o[0] for o in out]}")
    return launches


SERVING_KERNELS = ("flash_attention", "window_attention_rope", "full_attention_rope")
SERVING_KEYS = SERVING_KERNELS + tuple(f"{n}_tc" for n in FWD_TC)  # phase 4's launch counts
TRAIN_KERNELS = SERVING_KERNELS + ("flash_bwd_dq", "flash_bwd_dkv", "shared_prefix_fwd", "shared_prefix_bwd",
                                   "shared_prefix_bwd_dkv", "shared_prefix_decode_full")
DECODE_KERNELS = ("shared_prefix_decode_attention", "shared_prefix_decode_full")  # per layer per G-way step
PAGED_KERNELS = ("paged_prefix_attention", "paged_prefix_attention_q8")  # per layer per paged decode step


def check_step_launches(tag: str, launches: dict, steps: int, layers: int, per_layer: dict) -> None:
    """Kernels that run on every decode step: exactly per_layer[name] x layers
    x steps launches; kernels at 0 per layer must not run."""
    for name, n in per_layer.items():
        if launches[name] != n * layers * steps:
            raise AssertionError(f"{tag}: {name} launched {launches[name]} times, want {n} x {layers} x {steps}")


def vision_tc_launches(cfg) -> dict:
    """K2 and K3 launches of one vision-tower forward: one per window block
    and one per full-attention block."""
    n_full = len(cfg.vision.fullatt_block_indexes)
    return {"window_attention_rope": cfg.vision.depth - n_full, "full_attention_rope": n_full}


def step_batch_tc_launches(cfg, decode_steps: int) -> dict:
    """The tensor-core launches of one bf16 `step_batch`, per layer: K1 in
    the rollout prefill, ref_logps and the loss's prompt forward; B1 once; B2
    for the prompt and the own chunk; S1 in ref_logps and in the loss; S2's
    dq and prefix dK/dV once; D2 once per decode step. K2 and K3 in the
    rollout's vision tower."""
    layers = cfg.text.num_hidden_layers
    return vision_tc_launches(cfg) | {
        "flash_attention": 3 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": 2 * layers,
        "shared_prefix_fwd": 2 * layers, "shared_prefix_bwd": layers, "shared_prefix_bwd_dkv": layers,
        "shared_prefix_decode_full": layers * decode_steps}


def token_parity_reward(completions, **kwargs):
    """A stand-in reward that varies across the rows of a group (the share of
    odd token ids), so that the advantages are not zero: with random weights
    the timestamp and format rewards are 0 for every row."""
    out = []
    for text in completions:
        ids = [int(t) for t in text.split()]
        out.append(sum(t % 2 for t in ids) / max(len(ids), 1))
    return out


class IdsProcessor:
    """The trainer's processor stand-in: a completion decodes to its token ids
    as text (no tokenizer is in the repository)."""

    def batch_decode(self, seqs, skip_special_tokens=True):
        return [" ".join(str(int(t)) for t in s) for s in seqs]


def phase_train_full_size() -> dict:
    import torch

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.rl import GRPOTrainer, TrainConfig
    from time_r1_tpu_torch.rl.grpo import trainable_leaves
    from time_r1_tpu_torch.utils.profiling import PhaseTimers
    from time_r1_tpu_torch.utils.rewards import REWARD_FUNCS_REGISTRY

    cfg = Qwen25VLConfig.qwen25vl_3b()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    ref = to_device(params, torch.device("cuda"))
    torch.cuda.synchronize()
    log(f"[train] init_params 3B bf16 and its reference copy on the card: {time.perf_counter() - t0:.1f} s")
    req = video_request(cfg, np.random.default_rng(0), 32, 224, 392)  # phase 4's first request
    config = TrainConfig(report_to="none")
    rewards = [REWARD_FUNCS_REGISTRY["iou"], REWARD_FUNCS_REGISTRY["format"], token_parity_reward]
    trainer = GRPOTrainer(params, cfg, IdsProcessor(), rewards, config=config, ref_params=ref,
                          dtype=torch.bfloat16, device="cuda")
    example = {"problem": "a person opens a door", "solution": (2.0, 9.5), "durations": 32.0}
    before = [p.detach().cpu() for p in trainable_leaves(params, config.fix_vit)]
    per_call = []
    for call in (1, 2):
        trainer.timers = PhaseTimers(sync=True)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        info = trainer.step_batch([example], [req])
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = read_launches()
        metrics = trainer.pop_metrics()
        tm = trainer.engine.timings
        phases = {k: round(v["total_s"] * 1e3, 1) for k, v in trainer.timers.summary().items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        per_call.append(launches)
        log(f"[train] step_batch {call}: {total:.2f} s; phases (ms, synced) {phases}; rollout vision "
            f"{tm['vision_s'] * 1e3:.1f} ms, prefill {tm['prefill_s'] * 1e3:.1f} ms, decode "
            f"{tm['decode_s'] * 1e3 / max(tm['decode_steps'], 1):.2f} ms/step over {tm['decode_steps']} steps; "
            f"peak {peak:.2f} GiB allocated")
        log(f"[train] step_batch {call}: launches {launches}")
        log(f"[train] step_batch {call}: loss {info['loss']:.6f}, reward {info['reward']:.4f}, metrics {metrics}")
        if not (np.isfinite(info["loss"]) and np.isfinite(metrics["grad_norm"]) and metrics["grad_norm"] > 0):
            raise AssertionError(f"step_batch {call}: loss {info['loss']} or grad_norm {metrics['grad_norm']}")
        for name in TRAIN_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f"step_batch {call}: {name} was not launched")
        check_step_launches(f"step_batch {call}", launches, tm["decode_steps"], cfg.text.num_hidden_layers,
                            {"shared_prefix_decode_full": 1, "shared_prefix_decode_attention": 0,
                             "int4_matmul": 0, "fused_mlp_int8": 0})
        check_tc_route(f"train step_batch {call}", launches, step_batch_tc_launches(cfg, tm["decode_steps"]),
                       tensor_cores=True)
    changed = total_elems = 0
    for p, b in zip(trainable_leaves(params, config.fix_vit), before):
        changed += int((p.detach().cpu() != b).sum())
        total_elems += b.numel()
    log(f"[train] after one optimizer update (two micro-steps, lr {config.learning_rate}): {changed} of "
        f"{total_elems} trainable bf16 elements changed")
    return per_call[-1]


def phase_quant_full_size() -> dict:
    """Phase 6: quantized rollouts at full size, after phase 5 freed its model.
    Two `step_batch` calls with rollout_quantization="int8" (int8 weights, int8
    KV: D2 and Q2 on every decode step), then one int4 G = 8 `generate` (Q1 for
    the four projections of every layer, D2 over the int8 KV). Launch counts
    read around each call."""
    import gc

    import torch

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.rl import GRPOTrainer, TrainConfig
    from time_r1_tpu_torch.sampler import Engine, SamplingParams
    from time_r1_tpu_torch.utils.profiling import PhaseTimers
    from time_r1_tpu_torch.utils.rewards import REWARD_FUNCS_REGISTRY

    gc.collect()
    torch.cuda.empty_cache()
    cfg = Qwen25VLConfig.qwen25vl_3b()
    L = cfg.text.num_hidden_layers
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    ref = to_device(params, torch.device("cuda"))
    req = video_request(cfg, np.random.default_rng(0), 32, 224, 392)  # phase 4's first request
    config = TrainConfig(report_to="none", rollout_quantization="int8")
    rewards = [REWARD_FUNCS_REGISTRY["iou"], REWARD_FUNCS_REGISTRY["format"], token_parity_reward]
    t0 = time.perf_counter()
    trainer = GRPOTrainer(params, cfg, IdsProcessor(), rewards, config=config, ref_params=ref,
                          dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"[quant] GRPOTrainer(rollout_quantization='int8') built (one int8 quantization pass) in "
        f"{time.perf_counter() - t0:.2f} s")
    example = {"problem": "a person opens a door", "solution": (2.0, 9.5), "durations": 32.0}
    out = {}
    for call in (1, 2):
        trainer.timers = PhaseTimers(sync=True)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        info = trainer.step_batch([example], [req])
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = read_launches()
        metrics = trainer.pop_metrics()
        tm = trainer.engine.timings
        phases = {k: round(v["total_s"] * 1e3, 1) for k, v in trainer.timers.summary().items()}
        log(f"[quant] int8 step_batch {call}: {total:.2f} s; phases (ms, synced) {phases}; rollout vision "
            f"{tm['vision_s'] * 1e3:.1f} ms, prefill {tm['prefill_s'] * 1e3:.1f} ms, decode "
            f"{tm['decode_s'] * 1e3 / max(tm['decode_steps'], 1):.2f} ms/step over {tm['decode_steps']} steps; "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
        log(f"[quant] int8 step_batch {call}: launches {launches}")
        log(f"[quant] int8 step_batch {call}: loss {info['loss']:.6f}, reward {info['reward']:.4f}, "
            f"grad_norm {metrics['grad_norm']:.4f}")
        if not (np.isfinite(info["loss"]) and np.isfinite(metrics["grad_norm"]) and metrics["grad_norm"] > 0):
            raise AssertionError(f"int8 step_batch {call}: loss {info['loss']} or grad_norm {metrics['grad_norm']}")
        check_step_launches(f"int8 step_batch {call}", launches, tm["decode_steps"], L,
                            {"shared_prefix_decode_full": 1, "shared_prefix_decode_attention": 0,
                             "fused_mlp_int8": 1, "int4_matmul": 0})
        check_tc_route(f"int8 step_batch {call}", launches, step_batch_tc_launches(cfg, tm["decode_steps"]),
                       tensor_cores=True)
        out = {k: launches[k] for k in ("shared_prefix_decode_attention", "shared_prefix_decode_full",
                                        "fused_mlp_int8")}
    del trainer, ref
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    eng = Engine(params, cfg, dtype=torch.bfloat16, device="cuda", quantization="int4", kv_cache_quant=True)
    del params
    torch.cuda.synchronize()
    log(f"[quant] Engine(quantization='int4', kv_cache_quant=True) built in {time.perf_counter() - t0:.2f} s")
    sp = SamplingParams(temperature=1.0, max_new_tokens=200, num_return_sequences=8, stop_token_ids=(), seed=0)
    eng.generate([req], SamplingParams(max_new_tokens=2, num_return_sequences=8, stop_token_ids=()))  # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    rows = eng.generate([req], sp)
    total = time.perf_counter() - t0
    launches = read_launches()
    tm = eng.timings
    log(f"[quant] int4 generate (G = 8, 200 tokens): {total:.2f} s; vision {tm['vision_s'] * 1e3:.1f} ms, prefill "
        f"{tm['prefill_s'] * 1e3:.1f} ms, decode {tm['decode_s'] * 1e3 / max(tm['decode_steps'], 1):.2f} ms/step "
        f"over {tm['decode_steps']} steps; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    log(f"[quant] int4 generate: launches {launches}")
    check_step_launches("int4 generate", launches, tm["decode_steps"], L,
                        {"int4_matmul": 4, "shared_prefix_decode_full": 1, "shared_prefix_decode_attention": 0,
                         "fused_mlp_int8": 0})
    check_tc_route("int4 generate", launches, vision_tc_launches(cfg) | {
        "flash_attention": L, "shared_prefix_decode_full": L * tm["decode_steps"],
        "int4_matmul": 4 * L * tm["decode_steps"]}, tensor_cores=True)
    if len(rows) != 8 or not all(len(r) == 200 for r in rows):
        raise AssertionError(f"int4 generate: rows of {[len(r) for r in rows]} tokens")
    out["int4_matmul"], out["int4_matmul_tc"] = launches["int4_matmul"], launches["int4_matmul_tc"]
    return out


# Phase 3c tolerances (the reasons in `phase_reduced_quant`): int8 carries Q2's
# bf16 roundings; int4 has none, and read 4.4e-4 on an H100, so 3e-3 leaves
# room for the int8-KV boundary flips and still sees a fault in the suffix.
QUANT_LOGIT_TOL = {"int8": 1e-2, "int4": 3e-3}


def teacher_forced_logits(eng, cfg, req, tokens: np.ndarray) -> list:
    """The G-way decode of `generate` with fixed tokens (G, steps): the
    prefill's last-position logits, then one per step, as numpy (G, V)."""
    import torch

    from time_r1_tpu_torch.models.qwen25vl import forward_shared_decode, suffix_cache_zeros
    from time_r1_tpu_torch.ops.attention import NEG_INF

    G, steps = tokens.shape
    dev = eng.device
    with torch.no_grad():
        ids, mask, pos_ids, start, vis, S, _ = eng._pack([req], extra_len=0)
        first, prefix, _ = eng._prefill(ids, mask, pos_ids, vis, S, S)
        prefix = eng._maybe_quant_cache(prefix)
        bias = torch.where(torch.from_numpy(mask[:, :S] > 0).to(dev), 0.0, NEG_INF).float()
        suffix = suffix_cache_zeros(cfg.text, G, 128, dtype=eng.dtype, device=dev, quant=eng.kv_cache_quant)
        out = [first.float().cpu().numpy()]
        tok = torch.from_numpy(tokens).to(dev)
        for t in range(steps):
            pos3 = torch.full((3, G, 1), int(start[0]) + t, dtype=torch.long, device=dev)
            lg, suffix = forward_shared_decode(eng.params, cfg, tok[:, t:t + 1], pos3, prefix, suffix, bias)
            out.append(lg[:, -1].float().cpu().numpy())
    return out


def phase_reduced_quant() -> dict:
    """Phase 3c: the quantized G-way decode at reduced depth (3B widths, 2
    layers, 2 ViT blocks, f32 activations, int8 KV), int8 then int4 weights,
    16 teacher-forced steps of fixed tokens for G = 4 rows: the card (D2 with
    Q2 at int8, Q1 at int4) against the CPU (plain paths) on every step's
    logits. Tolerance, on max |card - cpu| / max |cpu| per step: at int8, Q2
    rounds x and the activation to bf16 where the CPU's unfused MLP stays f32
    (about 2^-9 of each value); in both runs the f32 K/V of card and CPU, equal
    to about 1e-6, can quantize to int8 values one apart where they sit at a
    rounding boundary."""
    import torch

    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.sampler import Engine

    cfg = reduced_config()
    params_cpu = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    params_gpu = to_device(params_cpu, torch.device("cuda"))
    req = video_request(cfg, np.random.default_rng(1), frames=8, height=224, width=392)
    G, steps = 4, 16
    tokens = np.random.default_rng(4).integers(0, 151000, size=(G, steps))
    errs = {}
    for quant in ("int8", "int4"):
        out = {}
        for device, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            eng = Engine(params, cfg, dtype=torch.float32, device=device, quantization=quant, kv_cache_quant=True)
            reset_launches()
            t0 = time.perf_counter()
            out[device] = teacher_forced_logits(eng, cfg, req, tokens)
            launches = read_launches()
            log(f"[reduced-quant] {quant} {device}: {time.perf_counter() - t0:.1f} s, launches "
                f"{ {k: v for k, v in launches.items() if v} }")
            if device == "cuda":
                check_step_launches(f"reduced {quant}", launches, steps, cfg.text.num_hidden_layers,
                                    {"shared_prefix_decode_full": 1,
                                     "fused_mlp_int8": int(quant == "int8"), "int4_matmul": 4 * (quant == "int4")})
                fma_only = FWD_TC + DECODE_KERNELS[1:] + (("int4_matmul",) if quant == "int4" else ())
                check_tc_route(f"reduced {quant}", launches, {n: None for n in fma_only}, tensor_cores=False)
        per_step = [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(out["cuda"], out["cpu"])]
        errs[quant] = max(per_step)
        finite = all(np.isfinite(a).all() for a in out["cuda"])
        log(f"[reduced-quant] {quant}: max |card - cpu| / max |cpu| per step {['%.2e' % e for e in per_step]}, "
            f"worst {errs[quant]:.3e} (tol {QUANT_LOGIT_TOL[quant]}); |logits| max {np.abs(out['cpu'][-1]).max():.3f}")
        if not finite or errs[quant] > QUANT_LOGIT_TOL[quant]:
            raise AssertionError(f"reduced-depth {quant} decode: card and CPU disagree ({errs[quant]})")
    return errs


def text_request(cfg, rng, n: int):
    """n prompt ids below the vision specials, drawn from rng."""
    from time_r1_tpu_torch.sampler import Request

    vocab = min(cfg.vision_start_token_id, cfg.text.vocab_size)
    return Request(input_ids=rng.integers(2, vocab, n).tolist())


def phase_reduced_serving() -> dict:
    """Phase 3d: continuous batching at reduced depth (3B widths, 2 layers, 2
    ViT blocks, f32), one 8-frame video request and four text requests
    through two slots (slots and pages recycle; 256-token prefill chunks, so
    the video's prompt streams in while a resident slot decodes). Greedy
    tokens must be equal, card against CPU, for PagedEngine (f32 pool, P1),
    PagedEngine with int8 KV pages (P2) and ContinuousEngine; on the card,
    the paged tokens must equal the bucket Engine's, and the int8-KV paged
    tokens the bucket Engine's over its int8 KV cache."""
    import torch

    from time_r1_tpu_torch.models.qwen25vl import init_params
    from time_r1_tpu_torch.sampler import ContinuousEngine, Engine, PagedEngine, SamplingParams

    cfg = reduced_config()
    L = cfg.text.num_hidden_layers
    params_cpu = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    params_gpu = to_device(params_cpu, torch.device("cuda"))
    rng = np.random.default_rng(2)
    reqs = [video_request(cfg, np.random.default_rng(1), frames=8, height=224, width=392)]
    reqs += [text_request(cfg, rng, n) for n in (37, 150, 290, 460)]
    sp = SamplingParams(max_new_tokens=8, stop_token_ids=())
    kw = dict(max_slots=2, max_len=1024, segment=4, prefill_chunk_tokens=256, dtype=torch.float32)
    engines = {
        "paged": lambda p, d: PagedEngine(p, cfg, page_size=128, device=d, **kw),
        "paged int8 KV": lambda p, d: PagedEngine(p, cfg, page_size=128, kv_cache_quant=True, device=d, **kw),
        "continuous": lambda p, d: ContinuousEngine(p, cfg, device=d, **kw),
    }
    kernel = {"paged": "paged_prefix_attention", "paged int8 KV": "paged_prefix_attention_q8", "continuous": None}
    out = {}
    for name, make in engines.items():
        got = {}
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            eng = make(params, dev)
            reset_launches()
            t0 = time.perf_counter()
            got[dev] = eng.generate(reqs, sp)
            launches = {k: v for k, v in read_launches().items() if v}
            tm = eng.timings
            log(f"[serving-reduced] {name} {dev}: {time.perf_counter() - t0:.1f} s, {tm['segments']} segments "
                f"({tm['interleaved_segments']} inside admissions), launches {launches}")
            if dev == "cuda":  # f32: K1-K3 and P1/P2 on the FMA kernels only
                paged = {kernel[name]: L * tm["decode_steps"]} if kernel[name] else {}
                check_tc_route(f"serving-reduced {name}", read_launches(), {n: None for n in FWD_TC} | paged,
                               tensor_cores=False)
                for k in ("paged_prefix_attention", "paged_prefix_attention_q8"):
                    want = L * tm["decode_steps"] if k == kernel[name] else 0
                    if launches.get(k, 0) != want:
                        raise AssertionError(f"reduced {name}: {k} launched {launches.get(k, 0)} times, want {want}")
        log(f"[serving-reduced] {name}: tokens {got['cuda']}")
        if got["cuda"] != got["cpu"]:
            raise AssertionError(f"reduced {name}: greedy tokens differ, card {got['cuda']} cpu {got['cpu']}")
        out[name] = got["cuda"]
    for name, quant in (("paged", False), ("paged int8 KV", True)):
        bucket = Engine(params_gpu, cfg, dtype=torch.float32, device="cuda", kv_cache_quant=quant).generate(reqs, sp)
        if bucket != out[name]:
            raise AssertionError(f"reduced {name}: the bucket Engine gives {bucket}, paged {out[name]}")
    log("[serving-reduced] card == cpu for the three engines; paged == bucket Engine (f32 and int8 KV)")
    return out


LENGTH_MIX = (200, 450, 900, 1800)  # scripts/bench_serving.py:38


def stream_requests(cfg):
    """Phase 7's stream: phase 4's two video requests, then ten text requests
    whose lengths cycle through LENGTH_MIX, shuffled and drawn from seed 0 as
    scripts/bench_serving.py's build_requests does."""
    rng = np.random.default_rng(0)
    reqs = [video_request(cfg, rng, 32, 224, 392), video_request(cfg, rng, 24, 280, 336)]
    trng = np.random.default_rng(0)
    lens = [LENGTH_MIX[i % len(LENGTH_MIX)] for i in range(10)]
    trng.shuffle(lens)
    return reqs + [text_request(cfg, trng, int(n)) for n in lens]


def phase_serving_full_size() -> dict:
    """Phase 7: continuous-batching serving at full size, after phase 6 freed
    its model. Qwen2.5-VL-3B in bf16 with seeded random weights; 12 requests
    (stream_requests), greedy, 128 new tokens with no stop ids; 4 slots,
    max_len 4096, pages of 128, segments of 16, 1024-token prefill chunks.
    (a) PagedEngine with a bf16 pool (P1); (b) PagedEngine with int8
    weights and int8 KV pages, scripts/bench_serving.py's default (P2, Q2);
    (c) ContinuousEngine over the same stream. Launch counts are checked
    exactly: P1/P2 36 x 16 x segments, K1 36 x the prefill chunks of the
    admissions, K2/K3 28/4 per admission that holds a video, Q2 36 per step
    in (b), D1/D2 and the training kernels 0."""
    import gc

    import torch

    from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, init_params
    from time_r1_tpu_torch.sampler import ContinuousEngine, PagedEngine, SamplingParams

    gc.collect()
    torch.cuda.empty_cache()
    cfg = Qwen25VLConfig.qwen25vl_3b()
    L = cfg.text.num_hidden_layers
    n_full = len(cfg.vision.fullatt_block_indexes)
    n_window = cfg.vision.depth - n_full
    chunk = 1024
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    reqs = stream_requests(cfg)
    log(f"[serve] init_params bf16: {time.perf_counter() - t0:.1f} s; prompts {[len(r.input_ids) for r in reqs]} "
        f"tokens")
    sp = SamplingParams(max_new_tokens=128, stop_token_ids=())
    kw = dict(max_slots=4, max_len=4096, segment=16, prefill_chunk_tokens=chunk, dtype=torch.bfloat16, device="cuda")
    runs = (
        ("a", "PagedEngine, bf16 pool", lambda: PagedEngine(params, cfg, page_size=128, **kw)),
        ("b", "PagedEngine, int8 weights + int8 KV pages",
         lambda: PagedEngine(params, cfg, page_size=128, quantization="int8", kv_cache_quant=True, **kw)),
        ("c", "ContinuousEngine, bf16", lambda: ContinuousEngine(params, cfg, **kw)),
    )
    tokens, result = {}, {}
    for tag, what, make in runs:
        eng = make()
        eng.generate([reqs[-1]], replace(sp, max_new_tokens=2))  # warm-up: one short text request
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        out = eng.generate(reqs, sp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        tm = eng.timings
        n_gen = sum(len(o) for o in out)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[serve] ({tag}) {what}: {wall:.2f} s wall, {n_gen} tokens, {n_gen / wall:.1f} tok/s; prefill "
            f"{tm['prefill_s']:.2f} s (vision {tm['vision_s']:.2f} s), decode {tm['decode_s']:.2f} s = "
            f"{tm['decode_s'] * 1e3 / tm['decode_steps']:.2f} ms/step over {tm['decode_steps']} steps, "
            f"{tm['segments']} segments ({tm['interleaved_segments']} inside admissions), peak {peak:.2f} GiB")
        log(f"[serve] ({tag}) admissions (rows, bucket, video) {tm['admissions']}")
        log(f"[serve] ({tag}) launches {launches}")
        if not all(len(o) == sp.max_new_tokens for o in out):
            raise AssertionError(f"({tag}): rows of {[len(o) for o in out]} tokens, want {sp.max_new_tokens} each")
        chunks = sum(-(-S // chunk) for _, S, _ in tm["admissions"])
        videos = sum(v for _, _, v in tm["admissions"])
        steps = L * tm["decode_steps"]
        want = {name: 0 for name in launches}
        want.update(flash_attention=L * chunks, window_attention_rope=n_window * videos,
                    full_attention_rope=n_full * videos)
        if tag == "a":
            want["paged_prefix_attention"] = steps
        if tag == "b":
            want["paged_prefix_attention_q8"] = steps
            want["fused_mlp_int8"] = steps
        tc = FWD_TC + {"a": PAGED_KERNELS[:1], "b": PAGED_KERNELS[1:], "c": ()}[tag]
        want.update({f"{n}_tc": want[n] for n in tc})  # bf16: every K1-K3 and P1/P2 launch on the tensor cores
        bad = {k: (launches[k], want[k]) for k in want if launches[k] != want[k]}
        if bad:
            raise AssertionError(f"({tag}): launches (got, want) {bad}")
        check_tc_route(f"serve ({tag})", launches, {n: want[n] for n in tc}, tensor_cores=True)
        if tag in ("a", "b") and tm["interleaved_segments"] < 1:
            raise AssertionError(f"({tag}): no segment ran inside an admission")
        tokens[tag] = out
        result[tag] = dict(launches=launches, wall_s=wall, tok_s=n_gen / wall, prefill_s=tm["prefill_s"],
                           vision_s=tm["vision_s"], decode_ms_per_step=tm["decode_s"] * 1e3 / tm["decode_steps"],
                           segments=tm["segments"], interleaved_segments=tm["interleaved_segments"], peak_gib=peak)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    same = sum(a == c for a, c in zip(tokens["a"], tokens["c"]))
    prefix = [next((i for i, (x, y) in enumerate(zip(a, c)) if x != y), len(a)) for a, c in zip(tokens["a"], tokens["c"])]
    log(f"[serve] rows whose tokens agree, (a) paged vs (c) continuous: {same} of {len(reqs)}; tokens before the "
        f"first difference, per row: {prefix} (for information: bf16 rounds at other places in the two attention "
        f"routes)")
    result["a_vs_c"] = dict(rows_equal=same, common_prefix=prefix)
    log(f"[serve] summary {json.dumps(result)}")
    return result


# ---------------------------------------------------------------------------
def main() -> int:
    # the training phase holds ~60 GB of live tensors of many sizes
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
    phase_reduced_train()
    phase_reduced_quant()
    phase_reduced_serving()
    launches = phase_full_size()  # K1-K3: the serving path
    train_launches = phase_train_full_size()  # B1, B2, S1, S2 (and D1/D2 in the rollout): the training path
    launches.update({k: v for k, v in train_launches.items() if k not in SERVING_KEYS})
    quant_launches = phase_quant_full_size()  # D1, D2, Q2 (int8 step_batch), Q1 (int4 generate)
    serve = phase_serving_full_size()  # P1 (a), P2 (b): continuous-batching serving
    for tag, name in zip("ab", PAGED_KERNELS):
        quant_launches[name] = serve[tag]["launches"][name]
        quant_launches[f"{name}_tc"] = serve[tag]["launches"][f"{name}_tc"]

    jax_fa = "time_r1_tpu/ops/flash_attention.py"
    replaces = {
        "flash_attention": f"{jax_fa}:135",
        "window_attention_rope": "time_r1_tpu/ops/vision_attention.py:140",
        "full_attention_rope": "time_r1_tpu/ops/vision_attention.py:233",
        "flash_bwd_dq": f"{jax_fa}:325",
        "flash_bwd_dkv": f"{jax_fa}:368",
        "shared_prefix_fwd": f"{jax_fa}:575",
        "shared_prefix_bwd": f"{jax_fa}:739",
        "shared_prefix_decode_attention": "time_r1_tpu/ops/decode_attention.py:171",
        "shared_prefix_decode_full": "time_r1_tpu/ops/decode_attention.py:403",
        "int4_matmul": "time_r1_tpu/ops/int4_matmul.py:128",
        "fused_mlp_int8": "time_r1_tpu/ops/fused_mlp.py:85",
        "paged_prefix_attention": "time_r1_tpu/ops/paged_attention.py:163",
        "paged_prefix_attention_q8": "time_r1_tpu/ops/paged_attention.py:311",
    }
    csrc = "time_r1_tpu_torch/csrc"
    sources = {
        "flash_attention": f"{csrc}/flash_attention.cu",
        "window_attention_rope": f"{csrc}/vision_attention.cu",
        "full_attention_rope": f"{csrc}/vision_attention.cu",
        "flash_bwd_dq": f"{csrc}/flash_attention_bwd.cu",
        "flash_bwd_dkv": f"{csrc}/flash_attention_bwd.cu",
        "shared_prefix_fwd": f"{csrc}/shared_prefix_attention.cu",
        "shared_prefix_bwd": f"{csrc}/shared_prefix_attention.cu",
        "shared_prefix_decode_attention": f"{csrc}/decode_attention.cu",
        "shared_prefix_decode_full": f"{csrc}/decode_attention.cu",
        "int4_matmul": f"{csrc}/int4_matmul.cu",
        "fused_mlp_int8": f"{csrc}/fused_mlp.cu",
        "paged_prefix_attention": f"{csrc}/paged_attention.cu",
        "paged_prefix_attention_q8": f"{csrc}/paged_attention.cu",
    }
    kernels = []
    for name, entry in checks.items():
        kernels.append({
            **entry,
            "route": "cuda",
            "source": sources[name],
            "replaces": replaces[name],
            "launches": quant_launches.get(name, launches[name]),
        })
    # K1, K3 (phase 4), B1, B2, S1, S2, D2 (phase 5), Q1 (phase 6's int4 generate), P1, P2 (phase 7 (a),
    # (b)): their tensor-core launches (all of them: no FMA launch there)
    for k in kernels:
        if k["name"] in TC_KERNELS:
            k["tc_launches"] = quant_launches.get(f"{k['name']}_tc", launches[f"{k['name']}_tc"])
    # S2 is two kernels (dq at :739, the prefix dK/dV at :769): its entry gives both counts
    s2 = next(k for k in kernels if k["name"] == "shared_prefix_bwd")
    s2["launches_dkv_prefix"] = launches["shared_prefix_bwd_dkv"]
    s2["tc_launches_dkv_prefix"] = launches["shared_prefix_bwd_dkv_tc"]
    s2["replaces_dkv_prefix"] = f"{jax_fa}:769"
    # D2 runs on both G-way paths: `launches` is the int8 step_batch's (phase
    # 6), this the bf16 step_batch's (phase 5). D1 runs on no path since D2
    # folds its prefix chunks itself: 0 launches, checked in phases 5 and 6.
    for k in kernels:
        if k["name"] in DECODE_KERNELS:
            k["launches_bf16_step_batch"] = launches[k["name"]]
        if k["name"] == "shared_prefix_decode_attention":
            k["on_main_path"] = False
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
