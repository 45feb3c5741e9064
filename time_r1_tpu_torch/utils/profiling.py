"""Per-phase wall-clock timers (port of `time_r1_tpu/utils/profiling.py`).

PyTorch returns from a CUDA call once the work is enqueued, so by default a
phase measures the host's dispatch time and the device's cost lands wherever
the host next waits. With `sync=True` (or TIMER1_SYNC_TIMERS=1) each phase
boundary calls `torch.cuda.synchronize()`: phase times become device costs,
at the price of the overlap between host and device.
"""

from __future__ import annotations

import contextlib
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
