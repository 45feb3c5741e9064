"""Rope + attention for the vision tower (K2, K3): the wrappers of
`csrc/vision_attention.cu` and their plain versions.

Replaces the Pallas kernels of `time_r1_tpu/ops/vision_attention.py`:
`window_attention_rope` (:102, pallas_call at :140) and `full_attention_rope`
(:204, pallas_call at :233). Both apply the 2D rope to q and k inside the
kernel, scale q by hd**-0.5 after the rope in f32, and add a key-validity
bias. Given CUDA tensors a wrapper launches its kernel (or raises); given CPU
tensors it runs its plain version. In bf16 both launch a tensor-core kernel
(q and k roped in f32 and rounded to bf16 in shared memory, q with the scale)
and add one to their `.tc_launches` as well: K2 one block per window (its
cos/sin staged once for every head), K3 `csrc/attention_fwd_tc.cuh` with its
rope flag. In f32 both run the exact FMA tiles of `csrc/attention_tile.cuh`.

The TPU kernel's tiling knobs (`block_windows`, `sub_blocks`) and the slice
cap `FULL_KERNEL_MAX_SLICE` describe the TPU's matrix unit and VMEM; the CUDA
kernels take any number of windows and any slice length.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .attention import rope


def _sdpa_rope(q, k, v, cos, sin, key_bias):
    """(n, S, nh, hd) blocks, cos/sin (n, S, hd), key_bias (n, S) → (n, S, nh, hd)."""
    hd = q.shape[-1]
    c, s = cos.float()[:, :, None, :], sin.float()[:, :, None, :]
    qr = rope(q, c, s) * hd**-0.5
    kr = rope(k, c, s)
    logits = torch.einsum("nqhd,nkhd->nhqk", qr, kr) + key_bias.float()[:, None, None, :]
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("nhqk,nkhd->nqhd", probs, v.float()).to(v.dtype)


def window_attention_rope_plain(q, k, v, cos, sin, key_bias, win_patches: int) -> torch.Tensor:
    """q/k/v (P, nh, hd) pre-rope, cos/sin (P, hd), key_bias (P,) → (P, nh, hd)."""
    P, nh, hd = q.shape
    n = P // win_patches

    def w(x):
        return x.reshape(n, win_patches, *x.shape[1:])

    return _sdpa_rope(w(q), w(k), w(v), w(cos), w(sin), w(key_bias)).reshape(P, nh, hd)


def full_attention_rope_plain(q, k, v, cos, sin, key_bias) -> torch.Tensor:
    """q/k/v (n_slices, S, nh, hd) pre-rope, cos/sin (n_slices, S, hd),
    key_bias (n_slices, S) → (n_slices, S, nh, hd)."""
    return _sdpa_rope(q, k, v, cos, sin, key_bias)


def _check(name, q, k, v, cos, sin, key_bias, rows_shape):
    kernels.require(q.dtype in kernels.DTYPE_CODE, name, f"dtype {q.dtype}")
    kernels.require(k.dtype == q.dtype and v.dtype == q.dtype, name, "q/k/v dtypes differ")
    kernels.require(k.shape == q.shape and v.shape == q.shape, name, "q/k/v shapes differ")
    kernels.require(all(t.dtype == torch.float32 for t in (cos, sin, key_bias)),
                    name, "cos/sin/key_bias must be float32")
    kernels.require(all(t.is_cuda and t.is_contiguous() for t in (q, k, v, cos, sin, key_bias)),
                    name, "operands must be contiguous CUDA tensors")
    hd = q.shape[-1]
    kernels.require(cos.shape == rows_shape + (hd,) and sin.shape == cos.shape, name, "cos/sin shape")
    kernels.require(key_bias.shape == rows_shape, name, "key_bias shape")
    kernels.require(hd in kernels.ATTN_HEAD_DIMS, name, f"head dim {hd}")
    kernels.require(not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))),
                    name, "the kernel has no backward: run the frozen tower under torch.no_grad()")


def window_attention_rope(q, k, v, cos, sin, key_bias, win_patches: int) -> torch.Tensor:
    """Rope + attention inside each window of `win_patches` consecutive rows
    of the padded-window layout. CUDA tensors launch K2 (bf16: the
    tensor-core kernel, whose 16-byte copies need q, k, v, cos and sin on 16
    bytes and windows of at most 64 rows)."""
    if not q.is_cuda:
        return window_attention_rope_plain(q, k, v, cos, sin, key_bias, win_patches)
    name = "window_attention_rope"
    P, nh, hd = q.shape
    _check(name, q, k, v, cos, sin, key_bias, (P,))
    kernels.require(win_patches > 0 and P % win_patches == 0 and P // win_patches <= 2**31 - 1, name,
                    "window count")
    tc = q.dtype == torch.bfloat16
    if tc:
        kernels.require(win_patches <= 64, name, f"windows of {win_patches} rows (at most 64)")
        kernels.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v, cos, sin)), name,
                        "operands must be 16-byte aligned")
    out = torch.empty_like(q)
    fn = kernels.bind("vision_attention", "t1_window_attention_rope_fwd_tc" if tc else "t1_window_attention_rope_fwd",
                      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(kernels.ptr(q), kernels.ptr(k), kernels.ptr(v), kernels.ptr(cos), kernels.ptr(sin),
            kernels.ptr(key_bias), kernels.ptr(out), P, nh, hd, win_patches, float(hd**-0.5), kernels.stream(q))
    kernels.check(rc, name)
    window_attention_rope.launches += 1
    window_attention_rope.tc_launches += int(tc)
    return out


window_attention_rope.launches = 0
window_attention_rope.tc_launches = 0


def full_attention_rope(q, k, v, cos, sin, key_bias) -> torch.Tensor:
    """Rope + attention over whole (sample, t)-slices. CUDA tensors launch K3
    (bf16: the tensor-core kernel, whose 16-byte copies need q, k, v, cos and
    sin on 16 bytes)."""
    if not q.is_cuda:
        return full_attention_rope_plain(q, k, v, cos, sin, key_bias)
    name = "full_attention_rope"
    n_slices, S, nh, hd = q.shape
    _check(name, q, k, v, cos, sin, key_bias, (n_slices, S))
    kernels.require(0 < n_slices <= 65535 and 0 < S and nh <= 65535, name, "slice count")
    tc = q.dtype == torch.bfloat16
    if tc:
        kernels.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v, cos, sin)), name,
                        "operands must be 16-byte aligned")
    out = torch.empty_like(q)
    fn = kernels.bind("vision_attention", "t1_full_attention_rope_fwd_tc" if tc else "t1_full_attention_rope_fwd",
                      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(
        kernels.ptr(q), kernels.ptr(k), kernels.ptr(v), kernels.ptr(cos), kernels.ptr(sin),
        kernels.ptr(key_bias), kernels.ptr(out), n_slices, S, nh, hd, float(hd**-0.5), kernels.stream(q),
    )
    kernels.check(rc, name)
    full_attention_rope.launches += 1
    full_attention_rope.tc_launches += int(tc)
    return out


full_attention_rope.launches = 0
full_attention_rope.tc_launches = 0
