"""ctypes bindings for the native FFmpeg decoder (`native/decoder.cpp`).

The API mirrors the slice of decord.VideoReader that the upstream code uses
(vision_process.py:249-334): `len(vr)`, `vr.get_avg_fps()`,
`vr.get_batch(indices)` → (T, H, W, C) uint8 RGB.

The shared library is built on first use with g++ against the system FFmpeg
development libraries (`pkg-config`), into `time_r1_tpu_torch/_build/`
(`video/build.py`); a failed build raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import numpy as np

from . import build

_LOCK = threading.Lock()
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = build.load("timer1_video", "decoder.cpp", ["-O2"],
                         lambda: build.pkg_config("libavformat", "libavcodec", "libavutil", "libswscale"))
        lib.vd_open.restype = ctypes.c_void_p
        lib.vd_open.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vd_get_batch.restype = ctypes.c_int
        lib.vd_get_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.vd_get_batch_tolerant.restype = ctypes.c_int
        lib.vd_get_batch_tolerant.argtypes = lib.vd_get_batch.argtypes
        lib.vd_close.restype = None
        lib.vd_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


class VideoReader:
    """decord.VideoReader-compatible surface over the native decoder. One
    reader is one demuxer and decoder: use it from one thread at a time."""

    def __init__(self, path: str):
        self._h = None
        if path.startswith("file://"):
            path = path[7:]
        self._lib = _lib()
        n = ctypes.c_int64()
        fps = ctypes.c_double()
        h = ctypes.c_int()
        w = ctypes.c_int()
        self._h = self._lib.vd_open(path.encode(), ctypes.byref(n), ctypes.byref(fps), ctypes.byref(h),
                                    ctypes.byref(w))
        if not self._h:
            raise IOError(f"cannot open video: {path}")
        self._n = int(n.value)
        self._fps = float(fps.value)
        self.height = int(h.value)
        self.width = int(w.value)

    def __len__(self) -> int:
        return self._n

    def get_avg_fps(self) -> float:
        return self._fps

    def get_batch(self, indices: Sequence[int], tolerant: bool = False) -> np.ndarray:
        """Decode frames at `indices` → (T, H, W, 3) uint8 RGB.

        Indices are clamped to the real frame count; indices past EOF reuse
        the last decoded frame (decord-like tolerance for imprecise counts).

        tolerant=True selects the fallback decode (the upstream decord →
        torchvision per-video fallback, vision_process.py:362-368): corrupt
        frames are skipped by the native decoder and backfilled here from the
        nearest good frame, so partially corrupt videos degrade instead of
        failing."""
        if not self._h:
            raise IOError("the video reader is closed")
        idx = np.asarray(sorted(set(int(i) for i in indices)), np.int64)
        idx = np.unique(np.clip(idx, 0, max(self._n - 1, 0)))
        out = np.zeros((len(idx), self.height, self.width, 3), np.uint8)
        fn = self._lib.vd_get_batch_tolerant if tolerant else self._lib.vd_get_batch
        ret = fn(
            self._h,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if ret < 0:
            raise IOError(f"decode failed (code {ret})")
        if ret == 1:
            # some requested frames were missed (past EOF, or dropped by the
            # tolerant decoder): backfill each from the previous good frame
            # (leading gaps from the first good one)
            decoded = np.where(out.reshape(len(idx), -1).any(axis=1))[0]
            if len(decoded) == 0:
                raise IOError("no frames decoded")
            first = decoded[0]
            good = first
            for i in range(len(idx)):
                if out[i].any():
                    good = i
                else:
                    out[i] = out[good if i > first else first]
        # map back to the (possibly duplicated, clamped) requested order
        lookup = {int(v): i for i, v in enumerate(idx)}
        req = np.clip(np.asarray([int(i) for i in indices], np.int64), 0, max(self._n - 1, 0))
        return out[[lookup[int(i)] for i in req]]

    def close(self) -> None:
        if self._h:
            self._lib.vd_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
