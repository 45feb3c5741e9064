"""Build and load the port's host libraries (`video/native/*.cpp`) with g++.

Nothing is built when a module is imported: each library compiles at its
first use into `time_r1_tpu_torch/_build/`, and again whenever its source is
newer. The build runs under a lock (a `threading.Lock` within the process and
an `fcntl` lock on a file beside the libraries across processes, such as
parallel test workers), writes a temporary file and moves it into place with
`os.replace`, so no reader ever loads half a library. A failed build raises
with the compiler's message: nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

NATIVE = Path(__file__).resolve().parent / "native"
BUILD = Path(__file__).resolve().parents[1] / "_build"

_LOCK = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def pkg_config(*packages: str) -> list[str]:
    """Compiler and linker flags of system libraries, from pkg-config."""
    out = subprocess.run(["pkg-config", "--cflags", "--libs", *packages], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"pkg-config {' '.join(packages)} failed:\n{out.stderr}")
    return out.stdout.split()


def load(name: str, source: str, flags: Sequence[str], libs=lambda: []) -> ctypes.CDLL:
    """`_build/lib<name>.so` built from `native/<source>` with g++ `flags`
    (and the link flags `libs()`, asked for only when a build is due)."""
    with _LOCK:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = NATIVE / source
        so = BUILD / f"lib{name}.so"
        BUILD.mkdir(exist_ok=True)
        with open(BUILD / f"lib{name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes or the process dies
            if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
                tmp = BUILD / f"lib{name}.{os.getpid()}.tmp"
                cmd = ["g++", *flags, "-fPIC", "-shared", "-std=c++17", str(src), "-o", str(tmp), *libs()]
                out = subprocess.run(cmd, capture_output=True, text=True)
                if out.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"building {source} failed:\n{' '.join(cmd)}\n{out.stderr}")
                os.replace(tmp, so)  # atomic: readers never see half a file
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib
