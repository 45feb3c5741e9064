#!/usr/bin/env python3
"""Where the bf16 K3's time goes: the rope inside the tensor-core kernel.

    python3 scripts/profile_k3_rope.py

Builds three variants of `csrc/vision_attention.cu` from edited copies of
`csrc/attention_fwd_tc.cuh` (into `time_r1_tpu_torch/_build/k3_variants/`,
never loaded by the port) and times, at phase 2's K3 shape (the two serving
videos' slices: q/k/v (28, 576, 16, 80) bf16, their rope tables and key
bias), with CUDA events behind a GPU spin, twice in turns:
- K3 as built (two 64-row query tiles a block share each roped K tile);
- `QT1`: one query tile a block;
- `QT2_no_k_rope` / `QT1_no_k_rope`: the same without roping the K tiles
  (their cos/sin still staged; the output is wrong, only the time counts);
- the same attention with no rope at all: K1's non-causal head-dim-80
  kernel on the same q/k/v and bias.
Needs a CUDA device and nvcc; exits 2 without one.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from time_r1_tpu_torch import kernels  # noqa: E402
from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, prepare_vision_inputs  # noqa: E402
from time_r1_tpu_torch.models.qwen25vl.vision import vision_rope_tables  # noqa: E402
from time_r1_tpu_torch.ops.attention import NEG_INF  # noqa: E402
from time_r1_tpu_torch.ops.flash_attention import flash_attention_fwd  # noqa: E402
from time_r1_tpu_torch.ops.vision_attention import full_attention_rope  # noqa: E402

QT1 = ("constexpr int fwd_qt() { return ROPE ? 2 : 1; }", "constexpr int fwd_qt() { return 1; }")
NO_K_ROPE = ("      rope_tile(sK, 1.f);\n", "")
VARIANTS = {"QT1": [QT1], "QT2_no_k_rope": [NO_K_ROPE], "QT1_no_k_rope": [QT1, NO_K_ROPE]}
ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]


def build_variants() -> dict:
    header = (kernels.CSRC / "attention_fwd_tc.cuh").read_text()
    jobs = []
    for name, edits in VARIANTS.items():
        d = kernels.BUILD / "k3_variants" / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(kernels.CSRC, d)
        text = header
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: attention_fwd_tc.cuh no longer holds {old!r}")
            text = text.replace(old, new)
        (d / "attention_fwd_tc.cuh").write_text(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "vision_attention.cu")]
        jobs.append((name, d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, d, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        fn = ctypes.CDLL(str(d / "lib.so")).t1_full_attention_rope_fwd_tc
        fn.argtypes, fn.restype = ARGS, ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    kernels.build()
    libs = build_variants()
    dev = torch.device("cuda")
    vcfg = Qwen25VLConfig.qwen25vl_3b().vision
    prep = prepare_vision_inputs(chip_smoke.serving_grids(), vcfg)
    nh, hd = vcfg.num_heads, vcfg.head_dim
    cos, sin = vision_rope_tables(vcfg, torch.from_numpy(prep.pos_hw).to(dev))
    key_bias = torch.where(torch.from_numpy(prep.key_valid).to(dev), 0.0, NEG_INF).float()
    fg = torch.from_numpy(prep.full_gather).to(dev).long()
    n, S = fg.shape
    fgs = fg.clamp_min(0).reshape(-1)
    bias = (key_bias[fgs].reshape(n, S) + torch.where(fg < 0, NEG_INF, 0.0)).contiguous()
    cos_f, sin_f = cos[fgs].reshape(n, S, hd), sin[fgs].reshape(n, S, hd)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(n, S, nh, hd, generator=gen, device=dev).bfloat16() for _ in range(3))
    out = torch.empty_like(q)
    print(f"q/k/v ({n}, {S}, {nh}, {hd}) bf16", flush=True)

    def variant(fn):
        def run():
            kernels.check(fn(*(kernels.ptr(t) for t in (q, k, v, cos_f, sin_f, bias, out)), n, S, nh, hd,
                             float(hd**-0.5), kernels.stream(q)), "variant")
        return run

    calls = {"K3 as built (QT 2)": lambda: full_attention_rope(q, k, v, cos_f, sin_f, bias)}
    calls.update({f"K3 {name}": variant(fn) for name, fn in libs.items()})
    calls["no rope at all (K1's D = 80 kernel, non-causal)"] = lambda: flash_attention_fwd(q, k, v, bias, False)
    for rep in (1, 2):
        for label, fn in calls.items():
            print(f"round {rep}: {label}: {chip_smoke.cuda_ms(fn, iters=20):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
