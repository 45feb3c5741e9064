"""Q1, the int4 dequant-matmul: the wrapper of `csrc/int4_matmul.cu` and its
plain version.

It replaces the Pallas `int4_matmul` of `time_r1_tpu/ops/int4_matmul.py`
(pallas_call at :128), which the JAX package runs for every int4 projection
with M <= 256 rows on the TPU (`time_r1_tpu/ops/quant.py:86-95`); the port
routes CUDA tensors there in `ops/quant.py::qmatmul`. The weight keeps the
port's (N, K/2) packed layout (`ops/quant.py`). Given CUDA tensors the
wrapper launches the kernel (or raises) and adds one to `.launches`; given CPU
tensors it runs the plain version, which is the JAX package's
`int4_matmul_reference`: unpack, a dense product in x's dtype, the scale
applied in x's dtype. The kernel applies the scale to the f32 sum and casts
once, so in bf16 the two differ by the rounding of the product (a bf16 ulp).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import kernels

_P = ctypes.c_void_p
_I = ctypes.c_int

NT, KT = 128, 512  # csrc/int4_matmul.cu: output columns per block, k per staged tile
SM_COUNT = 132  # H100 SXM: splits of K fill about two blocks per SM


def int4_matmul_plain(x: torch.Tensor, w4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ unpack(w4 (N, K/2)).T * scale (N, 1) → (M, N) in x's dtype."""
    from .quant import unpack_q4

    y = F.linear(x, unpack_q4(w4).to(x.dtype))
    return y * scale.reshape(-1).to(x.dtype)


def k_splits(M: int, K: int, N: int) -> tuple[int, int]:
    """(k per split, splits): enough blocks along K that the grid holds about
    two blocks per SM, each split a whole number of staged tiles."""
    col_blocks = -(-N // NT)
    want = max(1, -(-2 * SM_COUNT // col_blocks))
    per = -(-K // want)
    per = -(-per // KT) * KT
    return per, -(-K // per)


def int4_matmul(x: torch.Tensor, w4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(M, N) in x's dtype. CUDA tensors launch Q1; CPU tensors run the plain version."""
    if not x.is_cuda:
        return int4_matmul_plain(x, w4, scale)
    name = "int4_matmul"
    M, K = x.shape
    N = w4.shape[0]
    kernels.require(x.dtype in kernels.DTYPE_CODE, name, f"dtype {x.dtype}")
    kernels.require(w4.dtype == torch.uint8 and w4.shape == (N, K // 2) and K % 2 == 0, name, "w4 must be (N, K/2) uint8")
    kernels.require(scale.dtype == torch.float32 and scale.numel() == N, name, "scale must be N float32")
    kernels.require(all(t.is_cuda and t.is_contiguous() for t in (x, w4, scale)), name,
                    "operands must be contiguous CUDA tensors")
    per, splits = k_splits(M, K, N)
    kernels.require(N <= 65535 * NT and splits <= 65535, name, "grid too large")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    part = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if splits > 1 else None
    vec = int((K // 2) % 16 == 0 and w4.data_ptr() % 16 == 0)
    fn = kernels.bind("int4_matmul", "t1_int4_matmul", [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    rc = fn(kernels.DTYPE_CODE[x.dtype], kernels.ptr(x), kernels.ptr(w4), kernels.ptr(scale), kernels.ptr(y),
            kernels.ptr(part) if part is not None else None, M, K, N, per, splits, vec, kernels.stream(x))
    kernels.check(rc, name)
    int4_matmul.launches += 1
    return y


int4_matmul.launches = 0
