"""Q2, the fused int8 SwiGLU MLP: the wrapper of `csrc/fused_mlp.cu` and its
plain version.

It replaces the Pallas `fused_mlp_int8` of `time_r1_tpu/ops/fused_mlp.py`
(pallas_call at :85). The port's layout is (out, in): gu (2·inter, hid) int8
with the gate rows first, down (hid, inter) int8, scales (rows, 1) f32
(`ops/quant.py`). `ops/quant.py::mlp_proj` routes CUDA tensors of the decode
step here. Given CUDA tensors the wrapper launches the kernel (or raises) and
adds one to `.launches`; given CPU tensors it runs the plain version.

The kernel is one cooperative launch that streams gu and down once through
a shared-memory ring and multiplies on the tensor cores: phase A gives each
block a contiguous range of 8-column units of `inter` (gate and up rows) and
writes the bf16 activation to an (M, inter rounded up to 64) bf16 scratch;
after one grid barrier, phase B gives each block a range of 16-row units of
down, each output one fixed-order sum (`unit_ranges` mirrors the partition).
f32 and bf16 x share the kernel. Its grid barrier lives in the kernel's
library, one per device: launches must not overlap (the port issues them
on one stream).

Like the TPU kernel, both versions round x and the activation silu(g)·u to
bf16 whatever x's dtype, and sum in f32. The unfused path (`qmatmul` three
times) does neither, so at f32 activations the fused MLP differs from it by
those two roundings (about 2^-9 of each value).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import kernels

_P = ctypes.c_void_p
_I = ctypes.c_int

GATE_UNIT = 8  # csrc/fused_mlp.cu: inter columns of a phase A unit (8 gate + 8 up rows)
DOWN_UNIT = 16  # csrc/fused_mlp.cu: rows of down (outputs) of a phase B unit
MAX_M = 128


def unit_ranges(n_units: int, grid: int) -> list[tuple[int, int]]:
    """Block b's units [b·n/G, (b+1)·n/G), as csrc/fused_mlp.cu's `unit_begin`."""
    return [(b * n_units // grid, (b + 1) * n_units // grid) for b in range(grid)]


def work_partition(inter: int, hid: int, grid: int):
    """The kernel's blocks' work at a grid of `grid` blocks: per block, its
    range of `inter` columns (phase A) and of output rows (phase B)."""
    cols = [(GATE_UNIT * a, GATE_UNIT * b) for a, b in unit_ranges(inter // GATE_UNIT, grid)]
    rows = [(DOWN_UNIT * a, DOWN_UNIT * b) for a, b in unit_ranges(hid // DOWN_UNIT, grid)]
    return cols, rows


def check_shape(M: int, hid: int, inter: int) -> None:
    """Raise on a shape the kernel does not take (before any launch; the
    kernel also refuses hid beyond its shared memory: 7552 at M <= 8, 4480
    above)."""
    name = "fused_mlp_int8"
    kernels.require(1 <= M <= MAX_M, name, f"M={M}: the kernel takes 1..{MAX_M} rows")
    kernels.require(hid % 128 == 0 and inter % 16 == 0, name,
                    f"hid={hid} inter={inter}: hid must be a multiple of 128, inter of 16")


def fused_mlp_eligible(mlp: dict) -> bool:
    """The fused int8 layout (gu and down int8). Unlike the JAX package's rule,
    no shape test: the TPU kernel's 512/384/256/128 inter blocks do not bind
    this kernel, and a shape it cannot take raises in the wrapper rather than
    falling back to the unfused products on the card."""
    return all(isinstance(mlp.get(k), dict) and "q8" in mlp[k] for k in ("gu", "down_w"))


def fused_mlp_int8_plain(x, gu_q8, gu_s, down_q8, down_s) -> torch.Tensor:
    """x (M, hid) → (M, hid) in x's dtype, computed in f32 on bf16-rounded x
    and activation, as the kernels do."""
    xb = x.to(torch.bfloat16).float()
    inter = down_q8.shape[1]
    g = (xb @ gu_q8[:inter].float().t()) * gu_s[:inter].reshape(-1)
    u = (xb @ gu_q8[inter:].float().t()) * gu_s[inter:].reshape(-1)
    a = (F.silu(g) * u).to(torch.bfloat16).float()
    return ((a @ down_q8.float().t()) * down_s.reshape(-1)).to(x.dtype)


def fused_mlp_int8(x, gu_q8, gu_s, down_q8, down_s) -> torch.Tensor:
    """(M, hid) in x's dtype. CUDA tensors launch Q2; CPU tensors run the plain
    version."""
    if not x.is_cuda:
        return fused_mlp_int8_plain(x, gu_q8, gu_s, down_q8, down_s)
    return _launch(x, gu_q8, gu_s, down_q8, down_s)[0]


def _launch(x, gu_q8, gu_s, down_q8, down_s) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of Q2 on CUDA tensors: y and the kernel's bf16 activation
    (M, inter), which `chip_smoke.q2_phases_apart` reads to hold the two
    phases apart."""
    name = "fused_mlp_int8"
    M, hid = x.shape
    inter = down_q8.shape[1]
    check_shape(M, hid, inter)
    kernels.require(x.dtype in kernels.DTYPE_CODE, name, f"dtype {x.dtype}")
    kernels.require(gu_q8.dtype == torch.int8 and gu_q8.shape == (2 * inter, hid), name, "gu must be (2·inter, hid) int8")
    kernels.require(down_q8.dtype == torch.int8 and down_q8.shape == (hid, inter), name, "down must be (hid, inter) int8")
    kernels.require(gu_s.dtype == torch.float32 and gu_s.numel() == 2 * inter
                    and down_s.dtype == torch.float32 and down_s.numel() == hid, name, "scales must be float32 per row")
    kernels.require(all(t.is_cuda and t.is_contiguous() for t in (x, gu_q8, gu_s, down_q8, down_s)), name,
                    "operands must be contiguous CUDA tensors")
    kernels.require(gu_q8.data_ptr() % 16 == 0 and down_q8.data_ptr() % 16 == 0, name, "weights must be 16-byte aligned")
    y = torch.empty_like(x)
    act = torch.empty((M, -(-inter // 64) * 64), dtype=torch.bfloat16, device=x.device)
    fn = kernels.bind("fused_mlp", "t1_fused_mlp_int8", [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P])
    rc = fn(kernels.DTYPE_CODE[x.dtype], kernels.ptr(x), kernels.ptr(gu_q8), kernels.ptr(gu_s),
            kernels.ptr(down_q8), kernels.ptr(down_s), kernels.ptr(y), kernels.ptr(act), M, hid, inter,
            kernels.stream(x))
    kernels.check(rc, name)
    fused_mlp_int8.launches += 1
    return y, act[:, :inter]


fused_mlp_int8.launches = 0
