#!/usr/bin/env python3
"""Quick check of the bf16 shared-prefix kernels (S1 forward, S2 dq and
prefix dK/dV) on one card: a build, then each kernel against its plain
version at seven shapes, and the device times at the split-loss shape.

    python3 scripts/check_shared_prefix_tc.py

For each shape (P prompts, R rows per prompt, prefix Lp, chunk Sc, H, Hkv,
D, left pad keys per prompt) it prints max |kernel - plain| / max |plain| of
the output, dq, dk and dv (and the lse's max abs error), whether two prefix
dK/dV launches are bit-equal and the dK/dV split; at the split-loss shape
also the device times (CUDA events behind a GPU spin) and the f32 FMA S1.
About 40 s of command time, most of it the build: a short first call for a
new kernel before the whole of `chip_smoke.py`. Needs a CUDA device and nvcc.
"""

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from time_r1_tpu_torch import kernels  # noqa: E402
from time_r1_tpu_torch.ops import flash_attention as fa  # noqa: E402
from time_r1_tpu_torch.ops.attention import NEG_INF  # noqa: E402

SHAPES = [  # P, R, Lp, Sc, H, Hkv, D, pads; the first is the split loss's
    (1, 8, 2048, 256, 16, 2, 128, (134,)),
    (2, 4, 256, 128, 16, 2, 128, (0, 37)),
    (1, 2, 640, 384, 16, 2, 128, (100,)),
    (1, 2, 128, 128, 16, 2, 128, (0,)),
    (1, 2, 256, 128, 8, 2, 64, (5,)),
    (1, 3, 256, 128, 4, 4, 128, (20,)),
    (2, 2, 256, 128, 16, 2, 128, (256, 0)),
]


def device_ms(fn, iters=20):
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


def rel(a, b):
    return (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)


def check(gen, P, R, Lp, Sc, H, Hkv, D, pads, timed=False):
    dev = torch.device("cuda")
    B = P * R

    def r(*s):
        return torch.randn(s, generator=gen, device=dev)

    q, kp, vp, ko, vo, do = r(B, Sc, H, D), r(P, Lp, Hkv, D), r(P, Lp, Hkv, D), r(B, Sc, Hkv, D), r(B, Sc, Hkv, D), r(B, Sc, H, D)
    pb = torch.where(torch.arange(Lp, device=dev)[None] < torch.tensor(pads, device=dev)[:, None], NEG_INF, 0.0).float()
    bf = [t.bfloat16() for t in (q, kp, vp, ko, vo)]
    up = [t.float() for t in bf]
    out, lse = fa.shared_prefix_fwd(*bf, pb)
    want_out, want_lse = fa.shared_prefix_plain(*up, pb)
    dob = do.bfloat16()
    delta = (dob.float() * want_out).sum(-1)
    dq = fa.shared_prefix_bwd_dq(*bf, pb, dob, want_lse, delta)
    want_dq = fa.shared_prefix_bwd_dq_plain(*up, pb, dob.float(), want_lse, delta)
    dk, dv = fa.shared_prefix_bwd_dkv(bf[0], bf[1], bf[2], pb, dob, want_lse, delta)
    want_dk, want_dv = fa.shared_prefix_bwd_dkv_plain(up[0], up[1], up[2], pb, dob.float(), want_lse, delta)
    dk2, dv2 = fa.shared_prefix_bwd_dkv(bf[0], bf[1], bf[2], pb, dob, want_lse, delta)
    torch.cuda.synchronize()
    equal = torch.equal(dk, dk2) and torch.equal(dv, dv2)
    print(f"P{P} R{R} Lp{Lp} Sc{Sc} H{H} Hkv{Hkv} D{D} pads{pads}: out {rel(out, want_out):.2e} "
          f"lse {(lse - want_lse).abs().max().item():.2e} dq {rel(dq, want_dq):.2e} dk {rel(dk, want_dk):.2e} "
          f"dv {rel(dv, want_dv):.2e} bit-equal {equal} split {fa.bwd_dkv_split(H // Hkv, Lp, Hkv, P, R)}", flush=True)
    if timed:
        s1 = device_ms(lambda: fa.shared_prefix_fwd(*bf, pb))
        s2_dq = device_ms(lambda: fa.shared_prefix_bwd_dq(*bf, pb, dob, want_lse, delta))
        s2_dkv = device_ms(lambda: fa.shared_prefix_bwd_dkv(bf[0], bf[1], bf[2], pb, dob, want_lse, delta))
        print(f"  S1 {s1:.4f} ms, dq {s2_dq:.4f} ms, dkv {s2_dkv:.4f} ms", flush=True)
        out32, _ = fa.shared_prefix_fwd(*up, pb)
        print(f"  f32 S1 rel {rel(out32, want_out):.2e}; f32 S1 {device_ms(lambda: fa.shared_prefix_fwd(*up, pb), 3):.3f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    t0 = time.time()
    kernels.build()
    print(f"build {time.time() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for i, shape in enumerate(SHAPES):
        check(gen, *shape, timed=i == 0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
