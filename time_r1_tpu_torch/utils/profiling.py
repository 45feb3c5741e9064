"""Per-phase wall-clock timers (port of `time_r1_tpu/utils/profiling.py`).

PyTorch returns from a CUDA call once the work is enqueued, so by default a
phase measures the host's dispatch time and the device's cost lands wherever
the host next waits. With `sync=True` (or TIMER1_SYNC_TIMERS=1) each phase
boundary calls `torch.cuda.synchronize()`: phase times become device costs,
at the price of the overlap between host and device. `trace(log_dir)` wraps
a region in a `torch.profiler` window (the counterpart of JAX's
`xla_trace`).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class PhaseTimers:
    """Accumulating wall-clock timers keyed by phase name."""

    def __init__(self, sync: Optional[bool] = None):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        if sync is None:
            sync = os.environ.get("TIMER1_SYNC_TIMERS", "") == "1"
        self.sync = sync

    def _drain(self) -> None:
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def phase(self, name: str):
        self._drain()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._drain()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "mean_ms": round(self.totals[k] / max(self.counts[k], 1) * 1e3, 3),
            }
            for k in self.totals
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the wrapped region with `torch.profiler` (CPU activity, and
    CUDA activity where a card is present) and write its Chrome trace,
    viewable in Perfetto, under `log_dir`; does nothing when log_dir is empty
    or None."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


GLOBAL_TIMERS = PhaseTimers()
