"""First-order updates to optax 0.2.6's formulas, in place on torch
tensors (counterpart of `optax.adadelta` and `optax.sgd` as
h2o3_tpu/models/deeplearning.py:311-326 builds them).

- `Adadelta`: `optax.adadelta(learning_rate=1, rho, eps)` chains
  `add_decayed_weights(0)`, `scale_by_adadelta(rho, eps)`
  (optax/_src/transform.py:534) and `scale_by_learning_rate(1)`. Per
  step: e_g <- (1 - rho) g² + rho e_g first; the update is
  sqrt(e_x + eps) / sqrt(e_g + eps) · g with the PREVIOUS e_x; then
  e_x <- (1 - rho) u² + rho e_x; the parameter moves by -u.
- `SGD`: `optax.sgd(lr_schedule, momentum)` chains `trace(momentum)`
  (g + momentum · trace, when momentum > 0) and `scale_by_schedule(-lr)`,
  which calls the schedule with the step count BEFORE incrementing it.
  The schedule is DeepLearning's rate / (1 + rate_annealing · step ·
  batch), in float32 as JAX computes it from the int32 count.

Every update is a fixed sequence of `torch._foreach_*` ops (one launch a
op for all tensors on the card), each rounding once as the reference's
elementwise ops do, with no host sync: a CUDA graph can capture a step.
The state (moments, trace, step count) lives on the parameters' device.
"""

from __future__ import annotations

from typing import List

import torch


class Adadelta:
    def __init__(self, params: List[torch.Tensor], rho: float = 0.9,
                 eps: float = 1e-6):
        self.rho, self.eps = float(rho), float(eps)
        self.e_g = [torch.zeros_like(p) for p in params]
        self.e_x = [torch.zeros_like(p) for p in params]

    def state(self) -> List[torch.Tensor]:
        return self.e_g + self.e_x

    def step(self, params: List[torch.Tensor],
             grads: List[torch.Tensor]) -> None:
        """One update of `params` in place from `grads`."""
        rho, eps = self.rho, self.eps
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1.0 - rho)
        torch._foreach_mul_(self.e_g, rho)
        torch._foreach_add_(self.e_g, g2)
        num = torch._foreach_add(self.e_x, eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(self.e_g, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(num, den)
        upd = torch._foreach_mul(num, grads)
        u2 = torch._foreach_mul(upd, upd)
        torch._foreach_mul_(u2, 1.0 - rho)
        torch._foreach_mul_(self.e_x, rho)
        torch._foreach_add_(self.e_x, u2)
        torch._foreach_sub_(params, upd)


class SGD:
    """Plain (momentum 0) or trace-momentum SGD under DeepLearning's
    annealed rate."""

    def __init__(self, params: List[torch.Tensor], rate: float,
                 rate_annealing: float, batch: int, momentum: float = 0.0):
        dev = params[0].device
        f32 = dict(dtype=torch.float32, device=dev)
        self.rate = torch.tensor(float(rate), **f32)
        self.anneal = torch.tensor(float(rate_annealing), **f32)
        self.batch = torch.tensor(float(batch), **f32)
        self.momentum = float(momentum)
        self.count = torch.zeros((), **f32)
        self.trace = ([torch.zeros_like(p) for p in params]
                      if self.momentum > 0 else [])

    def state(self) -> List[torch.Tensor]:
        return [self.count] + self.trace

    def learning_rate(self) -> torch.Tensor:
        """rate / (1 + anneal · count · batch) at the current count."""
        return self.rate / (1.0 + self.anneal * self.count * self.batch)

    def step(self, params: List[torch.Tensor],
             grads: List[torch.Tensor]) -> None:
        if self.momentum > 0:
            torch._foreach_mul_(self.trace, self.momentum)
            torch._foreach_add_(self.trace, grads)
            grads = self.trace
        upd = torch._foreach_mul(grads, -self.learning_rate())
        torch._foreach_add_(params, upd)
        self.count.add_(1.0)
