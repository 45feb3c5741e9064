#!/usr/bin/env python3
"""Where the time of the bf16 D2 (G-way decode attention) and K2 (vision
window attention) goes, on one card.

    python3 scripts/profile_decode_window_tc.py [--parent DIR]

Times with CUDA events behind a GPU spin (`chip_smoke.cuda_ms`), twice in
turns, and prints one line each:
- D2 at phase 2's shape (q (1, 2, 64, 128) bf16 over a 2048-key prefix with
  134 pad keys, suffix 199 of 256, bf16 and int8 caches): the wrapper, then
  at 1, 2, 4 and 8 64-key tiles a prefix block the whole kernel, its prefix
  blocks alone, its suffix blocks alone and its fold alone, against one SDPA
  call over the same keys; and the wrapper at 16 rollouts a prompt (N =
  128 rows, two 64-row tiles a prefix block). The parts come from a timing
  build of `csrc/decode_attention.cu` with -DT1_D2_PROFILE_PARTS (into
  `time_r1_tpu_torch/_build/d2_parts/`, never loaded by the port);
- K2 at phase 2's shape (the two serving videos' windows: q/k/v (15104, 16,
  80) bf16, cos/sin, key bias) against K3's tensor-core entry called with
  one 64-row window per slice (S = 64: cos/sin staged once per (window,
  head), where K2 stages them once per window), against SDPA over the
  windows.
With --parent DIR (another checkout, e.g. the parent commit unpacked with
`git archive`), K3 as DIR builds it runs beside this tree's at phase 2's
shape (q/k/v (28, 576, 16, 80)): their outputs must be bit-equal, and the
two are timed in turns (parent, this tree, this tree, parent).
Needs a CUDA device and nvcc; exits 2 without one.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from time_r1_tpu_torch import kernels  # noqa: E402
from time_r1_tpu_torch.models.qwen25vl import Qwen25VLConfig, prepare_vision_inputs  # noqa: E402
from time_r1_tpu_torch.models.qwen25vl.vision import vision_rope_tables  # noqa: E402
from time_r1_tpu_torch.ops import decode_attention as da  # noqa: E402
from time_r1_tpu_torch.ops.attention import NEG_INF  # noqa: E402
from time_r1_tpu_torch.ops.vision_attention import full_attention_rope, window_attention_rope  # noqa: E402


def build_parts():
    """decode_attention.cu's timing build: its t1_decode_full_tc_part."""
    d = kernels.BUILD / "d2_parts"
    d.mkdir(parents=True, exist_ok=True)
    lib = d / "libdecode_attention.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DT1_D2_PROFILE_PARTS", "-o", str(lib),
                    str(kernels.CSRC / "decode_attention.cu")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).t1_decode_full_tc_part
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def launch_part(fn, args, ctiles: int, parts: int):
    """The tensor-core D2's prefix blocks (parts 1), suffix blocks (2) or
    fold (4) alone, on the wrapper's operands."""
    prm, out = da.full_tc_params(*args, ctiles=ctiles)
    q, k_pref = args[0], args[1]
    kernels.check(fn(parts, int(k_pref.dtype == torch.int8), q.shape[-1], ctypes.addressof(prm), kernels.stream(q)),
                  "D2 part")
    return out


def d2_calls(gen) -> dict:
    P, R, H, Hkv, D, Lp, Lo, pad, own = 1, 8, 16, 2, 128, 2048, 256, 134, 199
    base = chip_smoke.decode_base(gen, P, R, H, Hkv, D, Lp, Lo, pad)
    parts_fn = build_parts()
    calls = {}
    for int8 in (False, True):
        x = chip_smoke.decode_views(base, torch.bfloat16, int8)
        args = chip_smoke.d2_args(x, own)
        label = "int8" if int8 else "bf16"
        picked = da.tc_chunk_tiles(Lp, R * H // Hkv, int8)
        calls[f"D2 {label} caches, wrapper ({picked} tiles a chunk)"] = lambda a=args: da.shared_prefix_decode_full(*a)
        for ct in (1, 2, 4, 8):
            calls[f"D2 {label} caches, {ct} tiles a chunk: whole"] = lambda a=args, ct=ct: da.launch_full_tc(*a, ct)
            for parts, what in ((1, "prefix blocks"), (2, "suffix blocks"), (4, "fold")):
                calls[f"D2 {label} caches, {ct} tiles a chunk: {what}"] = (
                    lambda a=args, ct=ct, parts=parts: launch_part(parts_fn, a, ct, parts))
    k = torch.cat([base["kp"].expand(P * R, -1, -1, -1), base["ko"][:, :own], base["kn"][:, None]], 1)
    v = torch.cat([base["vp"].expand(P * R, -1, -1, -1), base["vo"][:, :own], base["vn"][:, None]], 1)
    mask = torch.cat([base["bias"].expand(P * R, -1), torch.zeros(P * R, own + 1, device="cuda")], 1)
    qt, kt, vt = (t.transpose(1, 2).bfloat16() for t in (base["q"], k, v))
    mk = mask[:, None, None, :].bfloat16()
    calls["SDPA over [prefix | suffix | new token]"] = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mk, enable_gqa=True)
    wide = chip_smoke.decode_views(chip_smoke.decode_base(gen, P, 2 * R, H, Hkv, D, Lp, Lo, pad), torch.bfloat16, False)
    calls["D2 bf16 caches, 16 rollouts (N = 128: two 64-row tiles)"] = (
        lambda a=chip_smoke.d2_args(wide, own): da.shared_prefix_decode_full(*a))
    return calls


def k2_calls(gen) -> dict:
    vcfg = Qwen25VLConfig.qwen25vl_3b().vision
    prep = prepare_vision_inputs(chip_smoke.serving_grids(), vcfg)
    nh, hd = vcfg.num_heads, vcfg.head_dim
    win = vcfg.window_patches**2 * vcfg.merge_unit
    dev = torch.device("cuda")
    cos, sin = vision_rope_tables(vcfg, torch.from_numpy(prep.pos_hw).to(dev))
    key_bias = torch.where(torch.from_numpy(prep.key_valid).to(dev), 0.0, NEG_INF).float()
    P = key_bias.shape[0]
    q, k, v = (torch.randn(P, nh, hd, generator=gen, device=dev).bfloat16() for _ in range(3))
    n = P // win
    qs, ks, vs = (t.view(n, win, nh, hd) for t in (q, k, v))
    cs, ss, bs = cos.view(n, win, hd), sin.view(n, win, hd), key_bias.view(n, win)
    print(f"K2: q/k/v ({P}, {nh}, {hd}) bf16, {n} windows of {win}", flush=True)
    qt, kt, vt = (t.transpose(1, 2) for t in (qs, ks, vs))
    mask = bs[:, None, None, :].bfloat16()
    return {
        "K2": lambda: window_attention_rope(q, k, v, cos, sin, key_bias, win),
        "K3's tensor-core entry at S = 64 (one window a slice)": lambda: full_attention_rope(qs, ks, vs, cs, ss, bs),
        "SDPA over the windows": lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
    }


def k3_against(parent: Path) -> None:
    """K3 of another checkout against this tree's at phase 2's shape:
    bit-equal outputs, times in turns."""
    out_dir = kernels.BUILD / "parent_k3"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libvision_attention.so"
    src = parent / "time_r1_tpu_torch" / "csrc" / "vision_attention.cu"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib_path), str(src)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib_path)).t1_full_attention_rope_fwd_tc
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    vcfg, prep, _, cos, sin, key_bias = chip_smoke.serving_vision_inputs()
    nh, hd = vcfg.num_heads, vcfg.head_dim
    fg = torch.from_numpy(prep.full_gather).cuda().long()
    n, S = fg.shape
    fgs = fg.clamp_min(0).reshape(-1)
    bias = (key_bias[fgs].reshape(n, S) + torch.where(fg < 0, NEG_INF, 0.0)).contiguous()
    cos_f, sin_f = cos[fgs].reshape(n, S, hd).contiguous(), sin[fgs].reshape(n, S, hd).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(n, S, nh, hd, generator=gen, device="cuda").bfloat16() for _ in range(3))
    out = torch.empty_like(q)

    def parent_k3():
        kernels.check(fn(*(kernels.ptr(t) for t in (q, k, v, cos_f, sin_f, bias, out)), n, S, nh, hd,
                         float(hd**-0.5), kernels.stream(q)), "parent K3")
        return out

    mine = full_attention_rope(q, k, v, cos_f, sin_f, bias)
    theirs = parent_k3()
    torch.cuda.synchronize()
    print(f"K3 ({n}, {S}, {nh}, {hd}): this tree's output bit-equal to {parent}'s: {torch.equal(mine, theirs)}",
          flush=True)
    if not torch.equal(mine, theirs):
        raise AssertionError("K3 differs from the parent's")
    for label, call in (("parent", parent_k3), ("this tree", lambda: full_attention_rope(q, k, v, cos_f, sin_f, bias)),
                        ("this tree", lambda: full_attention_rope(q, k, v, cos_f, sin_f, bias)),
                        ("parent", parent_k3)):
        print(f"K3 {label}: {chip_smoke.cuda_ms(call, iters=50):.5f} ms", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="another checkout whose K3 runs beside this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    kernels.build()
    if args.parent is not None:
        k3_against(args.parent)
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = d2_calls(gen)
    calls.update(k2_calls(gen))
    for rep in (1, 2):
        for label, fn in calls.items():
            print(f"round {rep}: {label}: {chip_smoke.cuda_ms(fn, iters=50):.5f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
