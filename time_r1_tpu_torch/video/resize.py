"""Bicubic antialiased resize of decoded frames (torchvision-resize semantics).

The upstream code resizes decoded frames with torchvision's antialiased
bicubic (vision_process.py:398-403). That operation is a separable
convolution with the cubic kernel of A = -0.5 (the PIL/torch-antialias
filter), its support widened by the scale factor when downsampling. The tap
weights depend only on (in_size, out_size), so they are precomputed on the
host, as dense (out, in) matrices (`resize_weights`) or in banded form
(`resize_taps`), and every path computes

    out = clip(round(W_h @ img @ W_wᵀ))

in float32 with one final rounding:
- `resize_frames_host`: the native banded kernel (`native/resize.cpp`, built
  with g++ at first use; a failed build raises);
- `resize_frames_plain`: the same banded sums in numpy, its plain version;
- `resize_frames_device`: two f32 matmuls in torch on the card, TF32 off
  whatever the caller set.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import numpy as np
import torch

from ..device import resolve_device
from . import build


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return np.where(
        ax <= 1.0,
        (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2.0, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
    )


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 antialiased bicubic weight matrix
    (PIL/torchvision-antialias semantics: support 2·max(scale, 1), taps at
    pixel centers, weights normalized to 1). Read-only: the cache hands the
    same array to every caller."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    w = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        taps = np.arange(lo, hi)
        k = _cubic((taps + 0.5 - center) / filterscale)
        s = k.sum()
        if s != 0:
            k = k / s
        w[i, lo:hi] = k
    w = w.astype(np.float32)
    w.setflags(write=False)
    return w


@functools.lru_cache(maxsize=64)
def resize_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Banded form of resize_weights: (starts (out,) int32, taps (out, K) f32)
    where K is the maximum support width. Row i of the dense matrix is zero
    outside [starts[i], starts[i]+K); taps holds exactly those values (zero-
    padded from the dense row), so banded evaluation computes the identical
    sum with ~2·support terms instead of in_size. Read-only, as above."""
    w = resize_weights(in_size, out_size)
    nz = w != 0.0
    starts = nz.argmax(axis=1).astype(np.int64)
    K = int(nz.sum(axis=1).max())
    # keep the window in-bounds; shifted-in entries are zeros of the dense row
    starts = np.minimum(starts, in_size - K)
    taps = np.stack([w[i, s: s + K] for i, s in enumerate(starts)])
    starts, taps = starts.astype(np.int32), np.ascontiguousarray(taps, np.float32)
    starts.setflags(write=False)
    taps.setflags(write=False)
    return starts, taps


def _resize_axis_host(x: np.ndarray, starts: np.ndarray, taps: np.ndarray, axis: int) -> np.ndarray:
    """Resize one axis of float32 `x` via the banded taps: K gather + FMA
    passes (K ≈ 2·support ≈ 8) instead of a dense in_size-wide contraction;
    the skipped entries are exact zeros, so the sum is the same."""
    out = None
    shape = [1] * x.ndim
    shape[axis] = -1
    for k in range(taps.shape[1]):
        seg = np.take(x, starts + k, axis=axis)
        seg *= taps[:, k].reshape(shape)
        out = seg if out is None else out + seg
    return out


def _check_frames(frames: np.ndarray) -> None:
    if frames.dtype != np.uint8 or frames.ndim != 4:
        raise ValueError(f"frames must be (T, H, W, C) uint8, got {frames.dtype} {frames.shape}")


def resize_frames_plain(frames: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """The plain version of `resize_frames_host`: the same banded float32
    passes (H, then W) in numpy, one round-half-even and clip."""
    _check_frames(frames)
    T, H, W, C = frames.shape
    if (H, W) == (out_h, out_w):
        return frames
    sh, th = resize_taps(H, out_h)
    sw, tw = resize_taps(W, out_w)
    x = frames.astype(np.float32)
    x = _resize_axis_host(x, sh, th, axis=1)
    x = _resize_axis_host(x, sw, tw, axis=2)
    return np.clip(np.round(x), 0, 255).astype(np.uint8)


_RESIZE_LIB = None
_RESIZE_LOCK = threading.Lock()


def _native_lib() -> ctypes.CDLL:
    """The banded-resize and patchify library (`native/resize.cpp`).
    -march=native widens the banded loops to the host's vector ISA (the build
    runs on the host that uses it); -ffp-contract=off forbids FMA contraction
    so that (v*rescale - mean)/std and the banded sums round exactly like the
    numpy plain versions."""
    global _RESIZE_LIB
    with _RESIZE_LOCK:
        if _RESIZE_LIB is not None:
            return _RESIZE_LIB
        lib = build.load("timer1_resize", "resize.cpp", ["-O3", "-march=native", "-ffp-contract=off"])
        i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
        u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
        lib.t1_resize_frames.restype = ctypes.c_int
        lib.t1_resize_frames.argtypes = [
            u8p, i64, i64, i64, i64, u8p, i64, i64, i32p, f32p, i64, i32p, f32p, i64,
        ]
        lib.t1_patchify.restype = ctypes.c_int
        lib.t1_patchify.argtypes = [
            f32p, i64, i64, i64, i64, f32p, i64, i64, i64, f32p, f32p,
            ctypes.c_float, ctypes.c_int,
        ]
        _RESIZE_LIB = lib
        return lib


def resize_frames_host(frames: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(T, H, W, C) uint8 → (T, out_h, out_w, C) uint8 on the host, float32
    single-rounding semantics (torchvision antialias=True), by the native
    banded kernel (`native/resize.cpp`)."""
    _check_frames(frames)
    T, H, W, C = frames.shape
    if (H, W) == (out_h, out_w):
        return frames
    sh, th = resize_taps(H, out_h)
    sw, tw = resize_taps(W, out_w)
    lib = _native_lib()
    frames = np.ascontiguousarray(frames)
    out = np.empty((T, out_h, out_w, C), np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.t1_resize_frames(
        frames.ctypes.data_as(u8p), T, H, W, C,
        out.ctypes.data_as(u8p), out_h, out_w,
        sh.ctypes.data_as(i32p), th.ctypes.data_as(f32p), th.shape[1],
        sw.ctypes.data_as(i32p), tw.ctypes.data_as(f32p), tw.shape[1],
    )
    if rc != 0:
        raise RuntimeError(f"t1_resize_frames failed (code {rc})")
    return out


_TF32_LOCK = threading.Lock()


@contextlib.contextmanager
def _full_f32_matmul():
    """TF32 off for the matmuls inside, whatever the caller set, then the
    caller's setting back. TF32 rounds the f32 operands to 10 bits of
    mantissa: on an H100 it moved 2.1% of a 360x640 → 196x392 clip's pixels
    by one gray level, twenty times the bound that f32 keeps
    (chip_smoke.py phase 8). The flag is process-wide: the lock keeps two
    resizes on different threads from restoring it under each other."""
    with _TF32_LOCK:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def resize_frames_device(frames, out_h: int, out_w: int, device="cuda") -> torch.Tensor:
    """(T, H, W, C) uint8 frames (numpy or tensor) → (T, out_h, out_w, C)
    uint8 tensor on `device`: W_h @ img @ W_wᵀ as two f32 matmuls (H first,
    then W), round half to even, clip."""
    device = resolve_device(device)
    x = torch.as_tensor(frames).to(device)
    if x.dtype != torch.uint8 or x.dim() != 4:
        raise ValueError(f"frames must be (T, H, W, C) uint8, got {x.dtype} {tuple(x.shape)}")
    T, H, W, C = x.shape
    if (H, W) == (out_h, out_w):
        return x
    wh = torch.tensor(resize_weights(H, out_h), device=device)
    ww = torch.tensor(resize_weights(W, out_w), device=device)
    with _full_f32_matmul():
        y = torch.matmul(wh, x.float().reshape(T, H, W * C))  # (T, out_h, W·C)
        # W innermost, so the second product is one GEMM over every (t, row, c)
        y = y.reshape(T * out_h, W, C).transpose(1, 2).reshape(T * out_h * C, W)
        y = torch.matmul(y, ww.t())  # (T·out_h·C, out_w)
    y = y.round_().clamp_(0, 255).to(torch.uint8)
    return y.reshape(T, out_h, C, out_w).permute(0, 1, 3, 2).contiguous()
