"""Q1, the int4 dequant-matmul: the wrapper of `csrc/int4_matmul.cu` and its
plain version.

It replaces the Pallas `int4_matmul` of `time_r1_tpu/ops/int4_matmul.py`
(pallas_call at :128), which the JAX package runs for every int4 projection
with M <= 256 rows on the TPU (`time_r1_tpu/ops/quant.py:86-95`); the port
routes CUDA tensors there in `ops/quant.py::qmatmul`. The weight keeps the
port's (N, K/2) packed layout (`ops/quant.py`). Given CUDA tensors the
wrapper launches a kernel (or raises) and adds one to `.launches`; given CPU
tensors it runs the plain version, which is the JAX package's
`int4_matmul_reference`: unpack, a dense product in x's dtype, the scale
applied in x's dtype. The kernels apply the scale to the f32 sum and cast
once, so in bf16 the two differ by the rounding of the product (a bf16 ulp).

Two kernels, by one written rule (`check_args`): bf16 x with N % 16 == 0 and
K % 128 == 0 (every Qwen2.5-VL 3B and 7B product on one card and at the
tensor-parallel widths, but the 3B's down product at tp 4 and 8, K 2752 and
1376, which takes the FMA kernel) takes the tensor-core
kernel, one launch that streams 16-row units of the weight through a
shared-memory ring and multiplies on the tensor cores, each output one
fixed-order sum in one block (`work_partition` mirrors the blocks' units);
it also adds one to `.tc_launches`. f32 x, and bf16 shapes outside the rule,
take the exact FMA kernel, which splits K over blocks (`k_splits`) and sums
the f32 partials in a second launch.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import kernels

_P = ctypes.c_void_p
_I = ctypes.c_int

NT, KT = 128, 512  # csrc/int4_matmul.cu, FMA kernel: output columns per block, k per staged tile
SM_COUNT = 132  # H100 SXM: splits of K fill about two blocks per SM
UNIT = 16  # csrc/int4_matmul.cu, tensor-core kernel: weight rows (outputs) of a unit
TC_K = 128  # its k-block: K must be a multiple
WHOLE_MAX = 2048  # row bytes up to which its stage is a unit's whole rows


def int4_matmul_plain(x: torch.Tensor, w4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ unpack(w4 (N, K/2)).T * scale (N, 1) → (M, N) in x's dtype."""
    from .quant import unpack_q4

    y = F.linear(x, unpack_q4(w4).to(x.dtype))
    return y * scale.reshape(-1).to(x.dtype)


def k_splits(M: int, K: int, N: int) -> tuple[int, int]:
    """FMA kernel: (k per split, splits): enough blocks along K that the grid
    holds about two blocks per SM, each split a whole number of staged tiles."""
    col_blocks = -(-N // NT)
    want = max(1, -(-2 * SM_COUNT // col_blocks))
    per = -(-K // want)
    per = -(-per // KT) * KT
    return per, -(-K // per)


def unit_ranges(n_units: int, grid: int) -> list[tuple[int, int]]:
    """Block b's units [b·n/G, (b+1)·n/G), as csrc/int4_matmul.cu's `unit_begin`."""
    return [(b * n_units // grid, (b + 1) * n_units // grid) for b in range(grid)]


def work_partition(N: int, sms: int = SM_COUNT) -> list[tuple[int, int]]:
    """Tensor-core kernel: each block's range of output rows, at a grid of
    one block per SM (at most one per unit)."""
    n_units = N // UNIT
    return [(UNIT * a, UNIT * b) for a, b in unit_ranges(n_units, min(n_units, sms))]


def stage_row_bytes(M: int, K: int) -> int:
    """Tensor-core kernel: the bytes of each weight row in one stage (all of
    K/2 up to WHOLE_MAX; else segments of 2048 bytes at M <= 8, 1024 above)."""
    return K // 2 if K // 2 <= WHOLE_MAX else (2048 if M <= 8 else 1024)


def check_args(x: torch.Tensor, w4: torch.Tensor, scale: torch.Tensor) -> bool:
    """Raise on arguments no Q1 kernel takes; True where the tensor-core
    kernel takes them (bf16 x, N % 16 == 0, K % 128 == 0), False for the FMA
    kernel."""
    name = "int4_matmul"
    kernels.require(x.dim() == 2 and x.dtype in kernels.DTYPE_CODE, name, f"x must be 2-D float32 or bfloat16, "
                    f"not {x.dtype} {tuple(x.shape)}")
    M, K = x.shape
    N = w4.shape[0]
    kernels.require(w4.dtype == torch.uint8 and w4.shape == (N, K // 2) and K % 2 == 0, name, "w4 must be (N, K/2) uint8")
    kernels.require(scale.dtype == torch.float32 and scale.numel() == N, name, "scale must be N float32")
    kernels.require(M >= 1 and N >= 1, name, "empty product")
    kernels.require(all(t.is_contiguous() for t in (x, w4, scale)), name, "operands must be contiguous")
    return x.dtype == torch.bfloat16 and K % TC_K == 0 and N % UNIT == 0


def int4_matmul(x: torch.Tensor, w4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(M, N) in x's dtype. CUDA tensors launch Q1; CPU tensors run the plain version."""
    if not x.is_cuda:
        return int4_matmul_plain(x, w4, scale)
    return _launch(x, w4, scale)


def _launch(x: torch.Tensor, w4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    name = "int4_matmul"
    tc = check_args(x, w4, scale)
    kernels.require(all(t.is_cuda for t in (x, w4, scale)), name, "operands must be CUDA tensors")
    M, K = x.shape
    N = w4.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if tc:
        kernels.require(x.data_ptr() % 16 == 0 and w4.data_ptr() % 16 == 0, name,
                        "bf16 x and w4 must be 16-byte aligned")
        fn = kernels.bind("int4_matmul", "t1_int4_matmul_tc", [_P, _P, _P, _P, _I, _I, _I, _P])
        rc = fn(kernels.ptr(x), kernels.ptr(w4), kernels.ptr(scale), kernels.ptr(y), M, K, N, kernels.stream(x))
    else:
        per, splits = k_splits(M, K, N)
        kernels.require(N <= 65535 * NT and splits <= 65535, name, "grid too large")
        part = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if splits > 1 else None
        vec = int((K // 2) % 16 == 0 and w4.data_ptr() % 16 == 0)
        fn = kernels.bind("int4_matmul", "t1_int4_matmul", [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
        rc = fn(kernels.DTYPE_CODE[x.dtype], kernels.ptr(x), kernels.ptr(w4), kernels.ptr(scale), kernels.ptr(y),
                kernels.ptr(part) if part is not None else None, M, K, N, per, splits, vec, kernels.stream(x))
    kernels.check(rc, name)
    int4_matmul.launches += 1
    int4_matmul.tc_launches += tc
    return y


int4_matmul.launches = 0
int4_matmul.tc_launches = 0
