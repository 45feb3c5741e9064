#!/usr/bin/env python3
"""Where Q2's time goes (`csrc/fused_mlp.cu`): the kernel, its phase A (gate
and up, activation stored) alone and its phase B (down) alone, from a timing
build with -DT1_Q2_PROFILE_PARTS, at the 3B and 7B widths, M = 8, bf16.

    python3 scripts/profile_fused_mlp_tc.py

Each part is one cooperative launch of the same grid; the parts alone skip
the grid barrier, so A + B against the kernel shows what the barrier and the
phase switch cost. Device times are CUDA events behind a GPU spin
(`chip_smoke.cuda_ms`); rates count each phase's int8 weight bytes once.
Needs a CUDA device and nvcc; exits 2 without one.
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
from time_r1_tpu_torch.ops.fused_mlp import fused_mlp_int8, fused_mlp_int8_plain  # noqa: E402
from time_r1_tpu_torch.ops.quant import quantize_weight  # noqa: E402


# (name, Params::parts bits): the kernel (a timing build's), each phase alone
PARTS = [("timing_build", 3), ("phase_a", 1), ("phase_b", 2)]


def build_parts():
    """fused_mlp.cu's timing build: its t1_fused_mlp_int8_part."""
    d = kernels.BUILD / "q2_parts"
    d.mkdir(parents=True, exist_ok=True)
    lib = d / "libfused_mlp.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DT1_Q2_PROFILE_PARTS", "-o", str(lib),
                    str(kernels.CSRC / "fused_mlp.cu")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).t1_fused_mlp_int8_part
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    part = build_parts()
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for hid, inter in ((2048, 11008), (3584, 18944)):
        gu = quantize_weight(torch.randn((2 * inter, hid), generator=gen, device="cuda") * 0.02)
        dn = quantize_weight(torch.randn((hid, inter), generator=gen, device="cuda") * 0.02)
        x = torch.randn((8, hid), generator=gen, device="cuda").to(torch.bfloat16)
        y = torch.empty_like(x)
        act = torch.zeros((8, -(-inter // 64) * 64), dtype=torch.bfloat16, device="cuda")

        def launch(parts: int):
            kernels.check(part(parts, 1, kernels.ptr(x), kernels.ptr(gu["q8"]), kernels.ptr(gu["s"]),
                               kernels.ptr(dn["q8"]), kernels.ptr(dn["s"]), kernels.ptr(y), kernels.ptr(act), 8,
                               hid, inter, kernels.stream(x)), "Q2 part")

        launch(3)
        want = fused_mlp_int8_plain(x, gu["q8"], gu["s"], dn["q8"], dn["s"])
        rel = (y.float() - want.float()).abs().max().item() / want.float().abs().max().item()
        if not rel <= chip_smoke.QUANT_TOL["bfloat16"]:
            raise AssertionError(f"timing build: max |build - plain| / max |plain| = {rel}")
        t = {"kernel": chip_smoke.cuda_ms(lambda: fused_mlp_int8(x, gu["q8"], gu["s"], dn["q8"], dn["s"]), 50),
             "rel_err": rel,
             # a read of the same int8 bytes by one PyTorch reduction, the card's streaming rate as PyTorch sees it
             "read_yardstick": chip_smoke.cuda_ms(lambda: (gu["q8"].view(torch.float32).sum(),
                                                           dn["q8"].view(torch.float32).sum()), 50)}
        for name, bits in PARTS:
            t[name] = chip_smoke.cuda_ms(lambda: launch(bits), 50)
        bytes_a, bytes_b = 2 * inter * hid, inter * hid
        t["phase_a_gbps"] = bytes_a / t["phase_a"] / 1e6
        t["phase_b_gbps"] = bytes_b / t["phase_b"] / 1e6
        t["kernel_gbps"] = (bytes_a + bytes_b) / t["kernel"] / 1e6
        t["read_yardstick_gbps"] = (bytes_a + bytes_b) / t["read_yardstick"] / 1e6
        print(f"hid {hid} inter {inter} M 8: kernel {t['kernel']:.4f} ms ({t['kernel_gbps']:.0f} GB/s; two sums "
              f"over the weights {t['read_yardstick']:.4f} ms, {t['read_yardstick_gbps']:.0f} GB/s), timing build "
              f"{t['timing_build']:.4f}, phase A alone {t['phase_a']:.4f} ({t['phase_a_gbps']:.0f} GB/s), phase B "
              f"alone {t['phase_b']:.4f} ({t['phase_b_gbps']:.0f} GB/s)", flush=True)
        out[f"{hid}x{inter}"] = t
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
