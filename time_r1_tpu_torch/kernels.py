"""Build and bind the port's hand-written CUDA kernels.

Every `csrc/*.cu` compiles with its own `nvcc` call (all started together)
into `_build/lib<name>.so`, a shared library with a plain C interface that is
loaded with ctypes. Nothing is built when this module is imported: the build
runs at the first launch (or when `build()` is called), and again whenever a
source under `csrc/` is newer than its library. Importing needs neither
`nvcc` nor a card, so the CPU tests import every module of the port.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()` (or a negative code for arguments it does not take);
`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ATTN_HEAD_DIMS = (64, 80, 128)  # head dims of K1-K3 (csrc/attention_tile.cuh, attention_fwd_tc.cuh)

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build where the CUDA toolkit is")
    return found


def _stale(src: Path) -> bool:
    so = BUILD / f"lib{src.stem}.so"
    if not so.exists():
        return True
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    return newest > so.stat().st_mtime


def build() -> dict[str, str]:
    """Compile every stale `csrc/*.cu`, one nvcc process each, in parallel.
    Returns the compiler output (ptxas register/spill report) per source."""
    BUILD.mkdir(exist_ok=True)
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        if not _stale(src):
            continue
        tmp = BUILD / f"lib{src.stem}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, tmp, proc))
    logs, failed = {}, []
    for src, tmp, proc in jobs:
        out, _ = proc.communicate()
        logs[src.stem] = out
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, BUILD / f"lib{src.stem}.so")  # atomic: readers never see half a file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def bind(stem: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function `symbol` of `lib<stem>.so`, built first if needed."""
    lib = _libs.get(stem)
    if lib is None:
        if _stale(CSRC / f"{stem}.cu"):
            build()
        lib = ctypes.CDLL(str(BUILD / f"lib{stem}.so"))
        _libs[stem] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    if rc < 0:
        raise ValueError(f"{name}: the kernel does not take these arguments (code {rc})")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")
