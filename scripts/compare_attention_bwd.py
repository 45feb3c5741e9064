#!/usr/bin/env python3
"""Compare the bf16 tensor-core flash backward (B1 dq, B2 dK/dV) of another
checkout with this tree's, on the same card and the same inputs.

    python3 scripts/compare_attention_bwd.py OTHER_CHECKOUT

OTHER_CHECKOUT is the root of another checkout of this repository (for
example the parent commit unpacked with `git archive` into a gitignored
directory). Its `time_r1_tpu_torch/csrc/flash_attention_bwd.cu` is built with
this tree's nvcc flags; both builds then run at the training step's two B2
shapes (the 2048-token prompt with 134 pad keys, the 8 x 256 own chunk).
Prints whether dq, dk and dv are bit-equal, then the device time of each
kernel in the order other, this, this, other (CUDA events behind a GPU
spin), with the card's name and power limit. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from time_r1_tpu_torch import kernels  # noqa: E402
from time_r1_tpu_torch.ops import flash_attention as fa  # noqa: E402
from time_r1_tpu_torch.ops.attention import NEG_INF  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DQ_ARGS = [_P] * 8 + [_I] * 7 + [_F, _I, _P]
DKV_ARGS = [_P] * 11 + [_I] * 8 + [_F, _I, _P]
SHAPES = ((1, 2048, 16, 2, 128, 134), (8, 256, 16, 2, 128, 0))  # B, S, H, Hkv, D, pad keys


def device_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))  # the launches queue behind a spin: the events time the device
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bind(lib: ctypes.CDLL, symbol: str, argtypes: list):
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other_src = Path(sys.argv[1]) / "time_r1_tpu_torch" / "csrc" / "flash_attention_bwd.cu"
    kernels.build()
    other_so = kernels.BUILD / "libother_flash_attention_bwd.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(other_so), str(other_src)], check=True,
                   capture_output=True)
    other = ctypes.CDLL(str(other_so))
    builds = {
        "other": (bind(other, "t1_flash_bwd_dq_tc", DQ_ARGS), bind(other, "t1_flash_bwd_dkv_tc", DKV_ARGS)),
        "this": (kernels.bind("flash_attention_bwd", "t1_flash_bwd_dq_tc", DQ_ARGS),
                 kernels.bind("flash_attention_bwd", "t1_flash_bwd_dkv_tc", DKV_ARGS)),
    }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for B, S, H, Hkv, D, pad in SHAPES:
        q, do = (torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16() for _ in range(2))
        k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev).bfloat16() for _ in range(2))
        bias = torch.where(torch.arange(S, device=dev)[None] < pad, NEG_INF, 0.0).float().expand(B, S).contiguous()
        out, lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), bias, True, None, 0)
        delta_t = (do.float() * out).sum(-1).transpose(1, 2).contiguous()  # (B, H, S), as the wrappers pass it
        n_split = fa.bwd_dkv_split(H // Hkv, S, Hkv, B)
        ins = [kernels.ptr(t) for t in (q, k, v, bias, do, lse, delta_t)]
        tail = [B, S, S, H, Hkv, D, 1, D**-0.5, 0, stream]
        results, calls = {}, {}
        for name, (dq_fn, dkv_fn) in builds.items():
            dq = torch.empty_like(q)
            dk, dv = (torch.empty(k.shape, dtype=torch.float32, device=dev) for _ in range(2))
            parts = torch.empty((2, n_split, *k.shape), dtype=torch.float32, device=dev)
            outs = [kernels.ptr(t) for t in (dk, dv, parts[0], parts[1])]
            calls[name] = (lambda f=dq_fn, o=kernels.ptr(dq): kernels.check(f(*ins, o, *tail), "dq"),
                           lambda f=dkv_fn, o=outs: kernels.check(f(*ins, *o, n_split, *tail), "dkv"),
                           (dq, dk, dv, parts))
            calls[name][0]()
            calls[name][1]()
            results[name] = (dq, dk, dv)
        torch.cuda.synchronize()
        equal = [torch.equal(a, b) for a, b in zip(results["other"], results["this"])]
        print(f"B={B} S={S} H={H} Hkv={Hkv} D={D} pad={pad} n_split={n_split}: bit-equal dq {equal[0]}, "
              f"dk {equal[1]}, dv {equal[2]}")
        times = [f"{name} B1 {device_ms(calls[name][0]):.4f} ms, B2 {device_ms(calls[name][1]):.4f} ms"
                 for name in ("other", "this", "this", "other")]
        print("  " + " | ".join(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
