#!/usr/bin/env python3
"""Where Q1's time goes (`csrc/int4_matmul.cu`, the bf16 tensor-core route):
the kernel, its stream alone (copies and waits, no products) and its
products alone (over stale stages, no copies), from a timing build with
-DT1_Q1_PROFILE_PARTS, per product of Qwen2.5-VL 3B and 7B at M = 8, bf16;
and the CUDA launches of one Q1 call on each route, counted by
`torch.profiler`.

    python3 scripts/profile_int4_matmul_tc.py

Each part is one launch of the same grid. Device times are CUDA events
behind a GPU spin (`chip_smoke.cuda_ms`); rates count the packed int4 weight
bytes once. PyTorch's sum over the same bytes is the card's streaming rate
as PyTorch sees it. Needs a CUDA device and nvcc; exits 2 without one.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from time_r1_tpu_torch import kernels  # noqa: E402
from time_r1_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_plain  # noqa: E402
from time_r1_tpu_torch.ops.quant import quantize_weight  # noqa: E402

# (name, Params::parts bits): the kernel (a timing build's), the stream alone, the products alone
PARTS = [("timing_build", 3), ("stream", 1), ("products", 2)]


def build_parts():
    """int4_matmul.cu's timing build: its t1_int4_matmul_tc_part."""
    d = kernels.BUILD / "q1_parts"
    d.mkdir(parents=True, exist_ok=True)
    lib = d / "libint4_matmul.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DT1_Q1_PROFILE_PARTS", "-o", str(lib),
                    str(kernels.CSRC / "int4_matmul.cu")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).t1_int4_matmul_tc_part
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cuda_launches(fn, calls: int = 4) -> tuple[list[str], float]:
    """The CUDA kernels `calls` calls of fn launch (torch.profiler): their
    names, and launches a call (the tracer can miss the first kernel it sees,
    so a count a call is rounded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(set(names)), len(names) / calls


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    part = build_parts()
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for model, shapes in chip_smoke.Q1_SHAPES.items():
        for name, (N, K) in shapes.items():
            w = quantize_weight(torch.randn((N, K), generator=gen, device="cuda") * 0.02, bits=4)
            x = torch.randn((8, K), generator=gen, device="cuda").to(torch.bfloat16)
            y = torch.empty((8, N), dtype=torch.bfloat16, device="cuda")

            def launch(parts: int):
                kernels.check(part(parts, kernels.ptr(x), kernels.ptr(w["q4"]), kernels.ptr(w["s"]), kernels.ptr(y),
                                   8, K, N, kernels.stream(x)), "Q1 part")

            launch(3)
            want = int4_matmul_plain(x, w["q4"], w["s"])
            rel = (y.float() - want.float()).abs().max().item() / want.float().abs().max().item()
            if not rel <= chip_smoke.QUANT_TOL["bfloat16"]:
                raise AssertionError(f"timing build: max |build - plain| / max |plain| = {rel}")
            t = {"kernel": chip_smoke.cuda_ms(lambda: int4_matmul(x, w["q4"], w["s"]), 50), "rel_err": rel,
                 "read_yardstick": chip_smoke.cuda_ms(lambda: w["q4"].view(torch.float32).sum(), 50)}
            for pname, bits in PARTS:
                t[pname] = chip_smoke.cuda_ms(lambda: launch(bits), 50)
            nbytes = N * K // 2
            for k in ("kernel", "read_yardstick", "stream", "products"):
                t[f"{k}_gbps"] = nbytes / t[k] / 1e6
            print(f"{model} {name} ({N}, {K}) M 8: kernel {t['kernel']:.4f} ms ({t['kernel_gbps']:.0f} GB/s; "
                  f"PyTorch's sum over the bytes {t['read_yardstick']:.4f} ms, {t['read_yardstick_gbps']:.0f} GB/s), "
                  f"timing build {t['timing_build']:.4f}, stream alone {t['stream']:.4f} ({t['stream_gbps']:.0f} "
                  f"GB/s), products alone {t['products']:.4f}", flush=True)
            out[f"{model} {name}"] = t
    w = quantize_weight(torch.randn((2048, 11008), generator=gen, device="cuda") * 0.02, bits=4)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((8, 11008), generator=gen, device="cuda").to(dtype)
        names, per_call = cuda_launches(lambda: int4_matmul(x, w["q4"], w["s"]))
        print(f"one Q1 call, 3B down, M 8, {dtype}: {per_call} CUDA launches ({names})", flush=True)
        out[f"cuda_launches_{str(dtype).split('.')[-1]}"] = {"per_call": per_call, "kernels": names}
        if dtype is torch.bfloat16 and (round(per_call) != 1 or len(names) != 1):
            raise AssertionError(f"the bf16 route ran {per_call} CUDA launches a call ({names}), want 1")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
