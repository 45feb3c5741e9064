"""`chip_smoke.StepWindow`'s cut of a decode loop's steps, and
`chip_smoke.settled_window`'s choice of a window, on the CPU.

The window runs torch.profiler on the card, which loses device records, most
often those nearest the moment it starts or stops. Here a stand-in profiler
records the kernels a CPU `StepGraph` "launches" (one name each) and loses
the first and last few of them, or some inside; the window must still count
exactly its own steps' kernels, cut out by its two marker kernels, and
`settled_window` must read only a window that lost nothing.
"""

from __future__ import annotations

import types

import pytest
import torch

import chip_smoke
from time_r1_tpu_torch.sampler import graph

STEP_KERNELS = ("qkv", "decode_full_tc", "mlp")


class Device:
    """A clock and the kernels launched while the stand-in profiler runs."""

    def __init__(self):
        self.clock, self.recording, self.log = 0, False, []

    def launch(self, name: str) -> None:
        self.clock += 1
        if self.recording:
            self.log.append((name, self.clock, self.clock + 0.5))


def lossy_profiler(device: Device, lose_first: int, lose_last: int, inside=None):
    """Loses the first `lose_first` and last `lose_last` records of every
    session, and the records at `inside(session)`'s positions."""
    sessions = []
    class Profile:
        def __init__(self, activities):
            pass

        def start(self):
            device.recording = True
            device.log = []
            sessions.append(self)

        def stop(self):
            device.recording = False

        def events(self):
            gone = set(inside(len(sessions) - 1)) if inside else set()
            kept = [e for i, e in enumerate(device.log[lose_first:len(device.log) - lose_last]) if i not in gone]
            return [types.SimpleNamespace(name=n, time_range=types.SimpleNamespace(start=a, end=b),
                                          device_type=types.SimpleNamespace(name="CUDA")) for n, a, b in kept]

    return Profile


@pytest.fixture
def device(monkeypatch):
    dev = Device()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: dev.launch("at::cuda::spin_kernel(long)"))
    return dev


def decode(device: Device, steps: int, kernels=STEP_KERNELS) -> None:
    """A decode loop as the engines run it: segments of 16 steps, a host
    check (one device op) before each."""
    g = graph.StepGraph(lambda: [device.launch(k) for k in kernels], torch.device("cpu"), capture=False)
    for done in range(0, steps, 16):
        device.launch("host_check")
        g.run(min(16, steps - done))


# the profiler starts at least one step (3 kernels) before the window and
# stops two steps (6 kernels) after it
@pytest.mark.parametrize("lose_first,lose_last", [(0, 0), (1, 1), (3, 6)])
@pytest.mark.parametrize("first,count,steps", [(32, 16, 64), (3, 1, 24)])
def test_window_counts_its_own_steps(device, monkeypatch, lose_first, lose_last, first, count, steps):
    monkeypatch.setattr(torch.profiler, "profile", lossy_profiler(device, lose_first, lose_last))
    with chip_smoke.StepWindow(first=first, count=count) as win:
        decode(device, steps)
    assert {k: win.kernels(k) for k in STEP_KERNELS} == {k: count for k in STEP_KERNELS}
    assert win.kernels("host_check") == 0 and win.kernels("spin_kernel") == 0
    assert len(win.events) == count * len(STEP_KERNELS)
    assert not device.recording


def test_window_refuses_a_lost_marker(device, monkeypatch):
    """A loop that ends at the window's last step leaves no margin after the
    second marker: when the profiler loses it, the window says so."""
    monkeypatch.setattr(torch.profiler, "profile", lossy_profiler(device, 0, 1))
    with pytest.raises(chip_smoke.WindowLost, match="1 of the window's 2 marker kernels"):
        with chip_smoke.StepWindow(first=32, count=16):
            decode(device, 48)


def test_window_refuses_a_short_decode(device, monkeypatch):
    monkeypatch.setattr(torch.profiler, "profile", lossy_profiler(device, 0, 0))
    with pytest.raises(AssertionError, match="never reached step 48"):
        with chip_smoke.StepWindow(first=32, count=16):
            decode(device, 40)
    assert not device.recording


def test_window_restores_the_loop(device, monkeypatch):
    monkeypatch.setattr(torch.profiler, "profile", lossy_profiler(device, 0, 0))
    run = graph.StepGraph.run
    with chip_smoke.StepWindow(first=32, count=16):
        decode(device, 64)
    assert graph.StepGraph.run is run


# record positions in a session from step 30: 2 margin steps (6 records),
# the host check before step 32, the start marker (index 7), then the
# window's 48 records
LOSSES = {
    "none": [[], [], [], []],
    "inside, then none": [[20], [], [], []],
    "a marker, then none": [[7], [], [], []],
    "inside twice, then none": [[20], [30, 31], [], []],
}


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_settled_window_reads_a_window_that_lost_nothing(device, monkeypatch, case):
    losses = LOSSES[case]
    monkeypatch.setattr(torch.profiler, "profile", lossy_profiler(device, 0, 0, lambda k: losses[k]))
    win, seen = chip_smoke.settled_window(lambda: decode(device, 64), first=32, count=16)
    assert {k: win.kernels(k) for k in STEP_KERNELS} == {k: 16 for k in STEP_KERNELS}
    assert seen[-2:] == [48, 48] and len(seen) == 2 + sum(bool(lost) for lost in losses)
    assert seen[:-2] == [None if 7 in lost else 48 - len(lost) for lost in losses if lost]


def test_settled_window_refuses_windows_that_never_agree(device, monkeypatch):
    monkeypatch.setattr(torch.profiler, "profile", lossy_profiler(device, 0, 0, lambda k: range(10, 11 + k)))
    with pytest.raises(AssertionError, match=r"no two of 4 profiler windows .* \[47, 46, 45, 44\]"):
        chip_smoke.settled_window(lambda: decode(device, 64), first=32, count=16)


def test_settled_window_keeps_a_kernel_missing_from_every_run(device, monkeypatch):
    """A decode that never launches D2 agrees with itself: the window is
    settled, and its count of D2 is 0."""
    monkeypatch.setattr(torch.profiler, "profile", lossy_profiler(device, 0, 0))
    win, seen = chip_smoke.settled_window(lambda: decode(device, 64, ("qkv", "mlp")), first=32, count=16)
    assert win.kernels("decode_full_tc") == 0 and seen == [32, 32]
