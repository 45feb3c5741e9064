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
  updates in between are zero.

Parameters are updated in place, so whatever else holds them (the rollout
engine) sees the new weights without a copy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass
class OptState:
    count: int = 0  # inner (AdamW) steps taken
    mini_step: int = 0  # micro-steps accumulated since the last update
    mu: list = field(default_factory=list)
    nu: list = field(default_factory=list)
    acc: Optional[list] = None  # running mean of the micro-step gradients (k > 1)


class AdamWMultiSteps:
    """clip_by_global_norm(max_grad_norm) → adamw(...), applied every k
    micro-steps to the mean of their gradients."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, max_grad_norm: float = 1.0, every_k: int = 1):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.weight_decay, self.max_grad_norm, self.every_k = weight_decay, max_grad_norm, every_k

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
            p.add_(-self.lr * u)
        if state.acc is not None:
            for a in state.acc:
                a.zero_()
        return True
