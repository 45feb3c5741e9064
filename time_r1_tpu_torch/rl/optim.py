"""The trainer's optimizer: optax's `MultiSteps(chain(clip_by_global_norm,
adamw), every_k)` (`time_r1_tpu/rl/trainer.py:386-405`) with optax's formulas,
written out for lists of torch tensors.

- clip: the updates are scaled by max_norm / g_norm where g_norm ≥ max_norm
  (no epsilon, unlike `torch.nn.utils.clip_grad_norm_`);
- AdamW: bias-corrected moments, eps outside the square root, decoupled
  weight decay, the step scaled by −lr; the moments are kept in each
  parameter's dtype, as optax keeps them;
- MultiSteps: the micro-step gradients are averaged (a running mean, in the
  parameter dtype) and the inner chain runs on the k-th micro-step; the
  updates in between are zero;
- the learning rate: a float, or a schedule (optax's `linear_schedule` and
  `join_schedules`, computed in f32 as optax computes them) read at the
  count of updates applied so far, so update n (1-based) takes schedule(n-1)
  and only applied updates advance it; the rate is rounded to the
  parameter's dtype before the product, as optax rounds a rate or a
  schedule's value.

Parameters are updated in place, so whatever else holds them (the rollout
engine) sees the new weights without a copy.

Offload (`AdamWMultiSteps.init(params, offload=True)`, the trainer's
`offload_optimizer`): the moments and the accumulation live in host memory
between steps and stream through the device a leaf at a time, bit-equal to
the device-resident update.

Sharded (FSDP/TP, `parallel/sharding.py`): `params`, the gradients and the
state are this rank's blocks, and `sq_sum` gives the clip the whole leaves'
Σ g² (`sharding.global_sq_sum`); accumulation is per block, and under
offload the arenas hold the rank's blocks only (JAX's sharded
`pinned_host` state, `time_r1_tpu/rl/trainer.py:418-430`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

Schedule = Callable[[int], float]


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule (transition_begin 0): init + (end - init) · t/T,
    held at end from t = T, in f32 as optax computes it; T <= 0 holds init."""
    if transition_steps <= 0:
        return lambda count: float(np.float32(init_value))

    def schedule(count: int) -> float:
        t = np.float32(min(max(int(count), 0), transition_steps))
        frac = np.float32(1) - t / np.float32(transition_steps)
        return float(np.float32(init_value - end_value) * frac + np.float32(end_value))

    return schedule


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: from each boundary on, the next schedule, handed
    the count since that boundary."""

    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = fn(count - boundary)
        return out

    return schedule


def offloadable(leaf: torch.Tensor, numel: Optional[int] = None) -> bool:
    """The JAX package's `_offloadable` rule (`time_r1_tpu/rl/grpo.py:404-409`):
    under offload a state leaf with a dimension and at least 1024 elements
    lives in host memory; smaller ones stay on the device. `numel`: the whole
    leaf's elements when `leaf` is a rank's block of it (JAX decides on the
    global array)."""
    return leaf.dim() >= 1 and (leaf.numel() if numel is None else numel) >= 1024


class HostArena:
    """One host allocation for a list of tensors, with a view of each in the
    order given (`views`). The views are laid out by element size, largest
    first, so none needs padding: `nbytes` is the sum of the tensors' bytes.
    With `pin` the allocation is page-locked by cudaHostRegister, which locks
    exactly its pages (PyTorch's pinned allocator would round each block up to
    a power of two); a failure raises. The arena starts zeroed."""

    def __init__(self, like: Sequence[torch.Tensor], pin: bool):
        self._registered = None
        sizes = [t.numel() * t.element_size() for t in like]
        self.nbytes = sum(sizes)
        self.buffer = torch.empty(self.nbytes, dtype=torch.uint8)
        if pin and self.nbytes:
            rt = torch.cuda.cudart()
            err = rt.cudaHostRegister(self.buffer.data_ptr(), self.nbytes, 0)
            if err != rt.cudaError.success:
                raise RuntimeError(f"cudaHostRegister of {self.nbytes} bytes of optimizer state failed: {err}")
            self._registered = self.buffer.data_ptr()
        self.buffer.zero_()
        self.views: list = [None] * len(like)
        offset = 0
        for i in sorted(range(len(like)), key=lambda i: -like[i].element_size()):
            self.views[i] = self.buffer[offset:offset + sizes[i]].view(like[i].dtype).view(like[i].shape)
            offset += sizes[i]

    def __del__(self):
        if self._registered is not None:
            torch.cuda.cudart().cudaHostUnregister(self._registered)
            self._registered = None


@dataclass
class OptState:
    count: int = 0  # inner (AdamW) steps taken
    mini_step: int = 0  # micro-steps accumulated since the last update
    mu: list = field(default_factory=list)
    nu: list = field(default_factory=list)
    acc: Optional[list] = None  # running mean of the micro-step gradients (k > 1)
    # per leaf, whether its mu, nu and acc are views of the host arenas
    # ("mu", "nu", "acc") rather than device tensors (all False without offload)
    offloaded: list = field(default_factory=list)
    arenas: dict = field(default_factory=dict)
    acc_stale: bool = False  # the host acc still holds the last window's sum; it reads as zeros
    pending: object = None  # a CUDA event: the last update's copies into host memory have landed

    @property
    def host_bytes(self) -> int:
        return sum(a.nbytes for a in self.arenas.values())

    def wait(self) -> None:
        """Block until the last update's copies into host memory have landed,
        so that the host leaves may be read."""
        if self.pending is not None:
            self.pending.synchronize()
            self.pending = None

    def tree(self) -> dict:
        """The state as a tree of tensors (the counts as 0-d int64), for a
        checkpoint; `load_tree` takes it back. Offloaded leaves are the host
        arenas' views, read and restored in place."""
        self.wait()
        if self.acc_stale:
            for a, host in zip(self.acc, self.offloaded):
                if host:
                    a.zero_()
            self.acc_stale = False
        tree = {"count": torch.tensor(self.count), "mini_step": torch.tensor(self.mini_step),
                "mu": self.mu, "nu": self.nu}
        if self.acc is not None:
            tree["acc"] = self.acc
        return tree

    def load_tree(self, tree: dict) -> None:
        """Take the counts back from `tree` (its tensors are this state's own,
        restored in place)."""
        self.count, self.mini_step = int(tree["count"]), int(tree["mini_step"])


class _Staging:
    """Device staging for host-resident leaves: two slots, each a byte buffer
    per tree as large as the largest leaf. On the card the copies in run on
    one side stream and the copies out on another, so that leaf i+1 comes in
    and leaf i-1 goes out while leaf i is updated on the caller's stream;
    events order each slot's reuse. On the CPU the copies are plain and in
    order."""

    def __init__(self, device: torch.device, nbytes: int, names: Sequence[str]):
        self.cuda = device.type == "cuda"
        self.slots = [{n: torch.empty(nbytes, dtype=torch.uint8, device=device) for n in names} for _ in range(2)]
        self.free = [None, None]  # per slot: an event after which it may be refilled
        if self.cuda:
            self.compute = torch.cuda.current_stream(device)
            self.h2d, self.d2h = torch.cuda.Stream(device), torch.cuda.Stream(device)
            # the slots' memory was last used on the compute stream, and the
            # host leaves were last written by the previous update's copies out,
            # which the compute stream waited for
            self.h2d.wait_stream(self.compute)
            self.d2h.wait_stream(self.compute)
        self.h2d_bytes = self.d2h_bytes = 0

    def _view(self, slot: int, name: str, like: torch.Tensor) -> torch.Tensor:
        n = like.numel() * like.element_size()
        return self.slots[slot][name][:n].view(like.dtype).view(like.shape)

    def load(self, slot: int, sources: dict):
        """Fill `slot` from host tensors (None: zeros); returns its views and
        the event after which they hold the values."""
        views = {n: self._view(slot, n, like) for n, (like, _) in sources.items()}
        if not self.cuda:
            for n, (_, src) in sources.items():
                if src is None:
                    views[n].zero_()
                else:
                    views[n].copy_(src)
                    self.h2d_bytes += src.numel() * src.element_size()
            return views, None
        with torch.cuda.stream(self.h2d):
            if self.free[slot] is not None:
                self.h2d.wait_event(self.free[slot])
            for n, (_, src) in sources.items():
                if src is None:
                    views[n].zero_()
                else:
                    views[n].copy_(src, non_blocking=True)
                    self.h2d_bytes += src.numel() * src.element_size()
            return views, self.h2d.record_event()

    def store(self, slot: int, views: dict, targets: dict) -> None:
        """Copy the slot's views named in `targets` back into host tensors,
        after the compute stream's work so far."""
        if not self.cuda:
            for n, dst in targets.items():
                dst.copy_(views[n])
                self.d2h_bytes += dst.numel() * dst.element_size()
            return
        done = self.compute.record_event()
        if not targets:
            self.free[slot] = done
            return
        self.d2h.wait_event(done)
        with torch.cuda.stream(self.d2h):
            for n, dst in targets.items():
                dst.copy_(views[n], non_blocking=True)
                self.d2h_bytes += dst.numel() * dst.element_size()
            self.free[slot] = self.d2h.record_event()

    def run(self, idx: Sequence[int], loads: dict, compute: Callable, stores: dict) -> None:
        """For each leaf i of `idx`: stage loads[name][i] (a host leaf, or
        None for zeros), call compute(i, views), and copy the views named in
        `stores` back to stores[name][i]. The next leaf's copies in are queued
        before this leaf's compute."""
        def sources(i):
            return {n: (like[i], None if host is None else host[i]) for n, (like, host) in loads.items()}

        if not idx:
            return
        pending = self.load(0, sources(idx[0]))
        for j, i in enumerate(idx):
            slot = j % 2
            views, ready = pending
            if j + 1 < len(idx):
                pending = self.load(1 - slot, sources(idx[j + 1]))
            if ready is not None:
                self.compute.wait_event(ready)
            compute(i, views)
            self.store(slot, views, {n: host[i] for n, host in stores.items()})

    def finish(self):
        """The compute stream waits for every copy out; returns an event after
        them (None on the CPU)."""
        if not self.cuda:
            return None
        for ev in self.free:
            if ev is not None:
                self.compute.wait_event(ev)
        return self.compute.record_event()


class AdamWMultiSteps:
    """clip_by_global_norm(max_grad_norm) → adamw(...), applied every k
    micro-steps to the mean of their gradients.

    `learning_rate` is a float or a schedule. A schedule reads the count of
    updates since `schedule_start`, an update count of the state (the
    trainer's `train()` starts its schedule at the count it holds, so that a
    restored state keeps its moments and Adam's count while the schedule
    starts over, as JAX's does). `lrs` holds the rate of every applied
    update.

    `init(params, offload=True)` keeps every `offloadable` leaf of mu, nu and
    acc in host memory (one `HostArena` per tree, page-locked when the
    parameters are on the card), the JAX trainer's `offload_optimizer`. Its
    update streams them through the device a leaf at a time (`_Staging`:
    at most two leaves of each tree on the device) with the same per-element
    arithmetic, so its results are bit-equal to the device-resident update.
    On the k-th micro-step the host accumulation is folded into `grads` in
    place (the caller's gradient tensors change), the clip's norm is taken
    over them, and only mu and nu stream; on the micro-steps in between acc
    streams in and out once (on the first of a window it only goes out: it
    reads as zeros). `last_stream` holds the last update's bytes copied in
    and out."""

    def __init__(self, learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, max_grad_norm: float = 1.0, every_k: int = 1,
                 schedule_start: int = 0, sq_sum: Optional[Callable] = None):
        self.sq_sum = sq_sum  # grads -> Σ g² over the whole leaves (sharded), else the local sum
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.weight_decay, self.max_grad_norm, self.every_k = weight_decay, max_grad_norm, every_k
        self.schedule_start = schedule_start
        self.lrs: list[float] = []
        self.last_stream = {"h2d_bytes": 0, "d2h_bytes": 0}

    def lr_at(self, count: int) -> float:
        """The rate of the update taken when `count` updates were applied."""
        return self.lr(count - self.schedule_start) if callable(self.lr) else self.lr

    def init(self, params: list[torch.Tensor], offload: bool = False,
             numels: Optional[Sequence[int]] = None) -> OptState:
        """The state of `params`; `numels`: each one's whole leaf's elements
        when they are a rank's blocks (the offload rule reads those)."""
        trees = ("mu", "nu", "acc") if self.every_k > 1 else ("mu", "nu")
        numels = [None] * len(params) if numels is None else numels
        host = [offload and offloadable(p, n) for p, n in zip(params, numels)]
        pin = any(p.is_cuda for p in params)
        state = OptState(offloaded=host)
        for name in trees:
            views = iter(())
            if any(host):
                arena = HostArena([p for p, h in zip(params, host) if h], pin=pin)
                views = iter(arena.views)
                state.arenas[name] = arena
            setattr(state, name, [next(views) if h else torch.zeros_like(p, memory_format=torch.contiguous_format)
                                  for p, h in zip(params, host)])
        return state

    def _adam_leaf(self, p, g, m, v, g_norm, scale, bc1, bc2, lr, rates) -> None:
        g = g.to(p.dtype)
        if scale is not None:
            g = g / g_norm * scale
        m.copy_((1 - self.b1) * g + self.b1 * m)
        v.copy_((1 - self.b2) * (g * g) + self.b2 * v)
        u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
        u = u + self.weight_decay * p
        if u.dtype not in rates:
            rates[u.dtype] = float(torch.tensor(-lr, dtype=u.dtype))
        p.add_(rates[u.dtype] * u)

    def _begin_update(self, grads, state: OptState) -> tuple:
        sq = self.sq_sum(grads) if self.sq_sum is not None else sum(g.float().pow(2).sum() for g in grads)
        g_norm = float(torch.sqrt(sq))
        scale = None if g_norm < self.max_grad_norm else self.max_grad_norm
        lr = self.lr_at(state.count)
        self.lrs.append(lr)
        state.count += 1
        return g_norm, scale, 1.0 - self.b1 ** state.count, 1.0 - self.b2 ** state.count, lr

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor], state: OptState) -> bool:
        """One micro-step: fold `grads` in and, on the k-th, update `params`
        and `state` in place, the offloaded leaves streamed (see the class).
        Returns whether the parameters changed."""
        device = params[0].device
        host = [i for i, h in enumerate(state.offloaded) if h]
        local = [i for i, h in enumerate(state.offloaded) if not h]
        largest = max((params[i].numel() * params[i].element_size() for i in host), default=0)
        grads = list(grads)
        moved = {"h2d_bytes": 0, "d2h_bytes": 0}

        def stream(names, loads, compute, stores):
            """`compute` over the host leaves through their own staging; the
            event after its copies out (None when no leaf is on the host)."""
            if not host:
                return None
            stage = _Staging(device, largest, names)
            stage.run(host, loads, compute, stores)
            moved["h2d_bytes"] += stage.h2d_bytes
            moved["d2h_bytes"] += stage.d2h_bytes
            return stage.finish()

        if state.acc is not None:
            n = state.mini_step
            last = (n + 1) % self.every_k == 0
            state.mini_step = (n + 1) % self.every_k
            for i in local:
                a = state.acc[i]
                a.copy_((grads[i].to(a.dtype) + n * a) / (n + 1))

            def fold(i, views):
                a = views["acc"]
                folded = (grads[i].to(a.dtype) + n * a) / (n + 1)
                if not last:
                    a.copy_(folded)
                elif folded.dtype == grads[i].dtype:
                    grads[i].copy_(folded)
                else:
                    grads[i] = folded

            # the first micro-step of a window reads the accumulation as zeros
            state.pending = stream(("acc",), {"acc": (params, None if n == 0 else state.acc)}, fold,
                                   {} if last else {"acc": state.acc})
            if not last:
                state.acc_stale = False
                self.last_stream = moved
                return False
            for i in local:
                grads[i] = state.acc[i]
        g_norm, scale, bc1, bc2, lr = self._begin_update(grads, state)
        rates = {}
        for i in local:
            self._adam_leaf(params[i], grads[i], state.mu[i], state.nu[i], g_norm, scale, bc1, bc2, lr, rates)

        def adam(i, views):
            self._adam_leaf(params[i], grads[i], views["mu"], views["nu"], g_norm, scale, bc1, bc2, lr, rates)

        state.pending = stream(("mu", "nu"), {"mu": (params, state.mu), "nu": (params, state.nu)}, adam,
                               {"mu": state.mu, "nu": state.nu})
        if state.acc is not None:
            for i in local:
                state.acc[i].zero_()
            state.acc_stale = True  # not read again before the next window's first micro-step overwrites it
        self.last_stream = moved
        return True
