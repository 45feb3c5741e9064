#!/usr/bin/env python3
"""Quick check of P1/P2, the paged decode attention (`csrc/paged_attention.cu`),
on one card: a build, then `chip_smoke.py`'s phase-2 P1/P2 checks alone.

    python3 scripts/check_paged_tc.py

It prints the card, the build's ptxas report (registers, spill) and the
tensor-core blocks' shared memory; P1 and P2 against their plain versions at
phase 2's cases in bf16 (the tensor-core kernel) and f32 (the FMA kernels),
with each launch's route, bit-equal repeats and exact empty slots; device
times (CUDA events behind a GPU spin) and per-call times at the main shape
beside the bound and the library; the tensor-core kernel's device time at 1,
2 and 4 tiles a chunk (`launch_tc`), and the CUDA kernels of one bf16 and one
f32 call by `torch.profiler`. Needs a CUDA device and nvcc; exits 2 without
one.
"""

import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def chunk_sweep() -> dict:
    """The tensor-core kernel at the main shape (phase 2's first case), bf16
    q, at 1, 2 and 4 64-key tiles a chunk: device ms behind a spin."""
    from time_r1_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    c = chip_smoke.paged_case(torch.Generator(device=dev).manual_seed(5), dev, (0, 327, 1689, 2041), 128, 32, 128)
    q = c["q"].to(torch.bfloat16)
    p1 = (q, c["kp"].to(torch.bfloat16), c["vp"].to(torch.bfloat16), None, None, c["table"], c["lengths"], c["P"])
    p2 = (q, c["k8"], c["v8"], c["ks"], c["vs"], c["table"], c["lengths"], c["P"])
    out = {}
    for name, args in (("paged_prefix_attention", p1), ("paged_prefix_attention_q8", p2)):
        ref = pa.launch_tc(name, *args, ctiles=pa.tc_chunk_tiles(32 * 128))
        for ct in (1, 2, 4):
            got = pa.launch_tc(name, *args, ctiles=ct)
            torch.cuda.synchronize()
            err = max((x - y).abs().max().item() / max(y.abs().max().item(), 1e-30)
                      for x, y in zip((got[0], got[2]), (ref[0], ref[2])))
            ms = chip_smoke.cuda_ms(lambda: pa.launch_tc(name, *args, ctiles=ct), 200)
            out[f"{name} CT {ct}"] = ms
            chip_smoke.log(f"[sweep] {name} CT {ct}: {ms:.4f} ms on the device; against the rule's CT "
                           f"{err:.2e} (acc, l)")
    return out


def cuda_launches_per_call() -> dict:
    """The CUDA kernels of one P1 call in bf16 and one in f32, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from time_r1_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    c = chip_smoke.paged_case(torch.Generator(device=dev).manual_seed(5), dev, (0, 327, 1689, 2041), 128, 32, 128)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = (c["q"].to(dtype), c["kp"].to(dtype), c["vp"].to(dtype), c["table"], c["lengths"], c["P"])
        pa.paged_prefix_attention(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pa.paged_prefix_attention(*args)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        out[str(dtype)] = names
        chip_smoke.log(f"[profile] one {dtype} P1 call: {len(names)} CUDA kernels {names}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    t0 = time.perf_counter()
    chip_smoke.phase_build()
    result = chip_smoke.phase_paged_kernels()
    result["sweep"] = chunk_sweep()
    result["cuda_kernels_per_call"] = cuda_launches_per_call()
    print(json.dumps(result), flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
