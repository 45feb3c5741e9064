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


@dataclass
class OptState:
    count: int = 0  # inner (AdamW) steps taken
    mini_step: int = 0  # micro-steps accumulated since the last update
    mu: list = field(default_factory=list)
    nu: list = field(default_factory=list)
    acc: Optional[list] = None  # running mean of the micro-step gradients (k > 1)

    def tree(self) -> dict:
        """The state as a tree of tensors (the counts as 0-d int64), for a
        checkpoint; `load_tree` takes it back."""
        tree = {"count": torch.tensor(self.count), "mini_step": torch.tensor(self.mini_step),
                "mu": self.mu, "nu": self.nu}
        if self.acc is not None:
            tree["acc"] = self.acc
        return tree

    def load_tree(self, tree: dict) -> None:
        """Take the counts back from `tree` (its tensors are this state's own,
        restored in place)."""
        self.count, self.mini_step = int(tree["count"]), int(tree["mini_step"])


class AdamWMultiSteps:
    """clip_by_global_norm(max_grad_norm) → adamw(...), applied every k
    micro-steps to the mean of their gradients.

    `learning_rate` is a float or a schedule. A schedule reads the count of
    updates since `schedule_start`, an update count of the state (the
    trainer's `train()` starts its schedule at the count it holds, so that a
    restored state keeps its moments and Adam's count while the schedule
    starts over, as JAX's does). `lrs` holds the rate of every applied
    update."""

    def __init__(self, learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, max_grad_norm: float = 1.0, every_k: int = 1,
                 schedule_start: int = 0):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.weight_decay, self.max_grad_norm, self.every_k = weight_decay, max_grad_norm, every_k
        self.schedule_start = schedule_start
        self.lrs: list[float] = []

    def lr_at(self, count: int) -> float:
        """The rate of the update taken when `count` updates were applied."""
        return self.lr(count - self.schedule_start) if callable(self.lr) else self.lr

    def init(self, params: list[torch.Tensor]) -> OptState:
        zeros = [torch.zeros_like(p, memory_format=torch.contiguous_format) for p in params]
        return OptState(
            mu=zeros,
            nu=[torch.zeros_like(p) for p in params],
            acc=[torch.zeros_like(p) for p in params] if self.every_k > 1 else None,
        )

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor], state: OptState) -> bool:
        """One micro-step: fold `grads` in and, on the k-th, update `params`
        and `state` in place. Returns whether the parameters changed."""
        if state.acc is not None:
            n = state.mini_step
            for a, g in zip(state.acc, grads):
                a.copy_((g.to(a.dtype) + n * a) / (n + 1))
            state.mini_step = (n + 1) % self.every_k
            if state.mini_step != 0:
                return False
            grads = state.acc
        g_norm = float(torch.sqrt(sum(g.float().pow(2).sum() for g in grads)))
        scale = None if g_norm < self.max_grad_norm else self.max_grad_norm
        lr = self.lr_at(state.count)
        self.lrs.append(lr)
        rates = {}  # -lr rounded to each update dtype, as optax rounds it
        state.count += 1
        bc1 = 1.0 - self.b1 ** state.count
        bc2 = 1.0 - self.b2 ** state.count
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
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
        if state.acc is not None:
            for a in state.acc:
                a.zero_()
        return True
