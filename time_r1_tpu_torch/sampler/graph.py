"""One decode step as a captured CUDA graph, replayed step after step.

The JAX package's decode is one compiled device program: `lax.while_loop`
in `time_r1_tpu/sampler/engine.py` (`_run_decode_loop`) and a `lax.scan`
segment in `time_r1_tpu/sampler/paged.py` (`paged_decode_segment`). The
port's loops keep the same state on the device (lengths, step counter, done
flags, tokens) and write a step as a function that reads and writes only
tensors allocated before it runs, in place. `StepGraph` runs that function:

- on the CPU, or with `capture=False`, eagerly, each call (the CPU path, and
  the eager loop that `chip_smoke.py` holds replay against);
- on the card, the first step eagerly on a side stream. It builds and binds
  every kernel library and allocates every buffer a wrapper caches per
  device (D2's and P1/P2's tickets and workspaces; Q1's and Q2's first-launch
  set-up), outside any capture: a buffer first allocated during capture would
  belong to the graph's private pool and be freed with it while the
  wrapper's cache still pointed at it. The second step is captured on that
  stream (not run), with the sampling generator registered, and replayed for
  it and every later step.

The host issues one graph launch a step and reads back only where its loop
does, once per segment. A graph lives as long as its `StepGraph`: the loops
make one per `generate()` call, since the pointers a step reads (a call's
prefix and suffix caches, a quantized engine's weights re-made by each
`set_params`) are not stable across calls.

A wrapper's `.launches` / `.tc_launches` count the calls of the wrapper, and a
replay calls none. The capture takes back every counter's change while it
traced the step, and each replay adds that change again, so the counts stay
those of the kernels the card ran.

A failed capture raises with CUDA's message: nothing falls back to the
eager loop.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

_side_streams: dict = {}  # per device: the stream that warms up and captures the steps


def launch_counters() -> list:
    """(wrapper, attribute) for every launch counter of the port's kernel
    wrappers."""
    from ..ops import decode_attention, flash_attention, fused_mlp, int4_matmul, paged_attention, vision_attention

    wrappers = [
        flash_attention.flash_attention_fwd, flash_attention.flash_bwd_dq, flash_attention.flash_bwd_dkv,
        flash_attention.shared_prefix_fwd, flash_attention.shared_prefix_bwd_dq,
        flash_attention.shared_prefix_bwd_dkv, vision_attention.window_attention_rope,
        vision_attention.full_attention_rope, decode_attention.shared_prefix_decode_attention,
        decode_attention.shared_prefix_decode_full, int4_matmul.int4_matmul, fused_mlp.fused_mlp_int8,
        paged_attention.paged_prefix_attention, paged_attention.paged_prefix_attention_q8,
    ]
    return [(fn, attr) for fn in wrappers for attr in ("launches", "tc_launches") if hasattr(fn, attr)]


def read_counters() -> list[int]:
    return [getattr(fn, attr) for fn, attr in launch_counters()]


def add_counters(delta: list[int]) -> None:
    for (fn, attr), d in zip(launch_counters(), delta):
        setattr(fn, attr, getattr(fn, attr) + d)


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


class StepGraph:
    """Runs `step`, a function of no arguments that reads and writes only
    tensors allocated before the first call, once per step: eagerly, or on
    the card as one captured CUDA graph replayed (see the module docstring).
    `steps` counts the steps run, `replays` those that were replays."""

    def __init__(self, step: Callable[[], None], device: torch.device,
                 generator: Optional[torch.Generator] = None, capture: bool = True):
        self.step = step
        self.device = device
        self.generator = generator
        self.capture = capture and device.type == "cuda"
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.delta: list[int] = []
        self.steps = 0
        self.replays = 0

    def run(self, n: int) -> None:
        """n steps, in stream order on the current stream."""
        for _ in range(n):
            if not self.capture:
                self.step()
            elif self.steps == 0:
                self._on_side_stream(self.step)
            else:
                if self.graph is None:
                    self._capture()
                self.graph.replay()
                add_counters(self.delta)
                self.replays += 1
            self.steps += 1

    def _on_side_stream(self, fn: Callable[[], None]) -> None:
        main = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn()
        main.wait_stream(side)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None and self.generator.device.type == "cuda":
            graph.register_generator_state(self.generator)
        before = read_counters()

        def capture():
            # thread_local: another thread's CUDA calls (a prefetch worker
            # staging the next batch) neither fail nor break this capture
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.step()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the step's own error is the one to raise
                raise
            graph.capture_end()

        try:
            self._on_side_stream(capture)
        except RuntimeError as e:
            raise RuntimeError(f"capturing the decode step as a CUDA graph failed: {e}") from e
        self.delta = [a - b for a, b in zip(read_counters(), before)]
        add_counters([-d for d in self.delta])
        self.graph = graph

    def close(self) -> None:
        """Drop the graph and its private memory pool."""
        self.graph = None
