"""Adam with f32 moments, equal to ``optax.adam`` (the JAX trainer's optimizer).

Port of the f32 path of the JAX package's ``ops/optim.py``
(``optax.adam(learning_rate)``, train/trainer.py:157-161 there):

    mu = b1 mu + (1 - b1) g          nu = b2 nu + (1 - b2) g^2
    p -= lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

The update runs in place on the parameter tensors (PyTorch's ``_foreach``
kernels over the whole list): the port keeps one copy of the parameters and
moments where the JAX package returns new arrays. The bias corrections are
computed in double, optax's in f32: they differ by ~1e-5 relative.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch


@dataclasses.dataclass
class AdamState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class Adam:
    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamState) -> AdamState:
        """One Adam step on ``params`` in place; returns the new state."""
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(state.nu, 1.0 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(params, state.mu, denom,
                                value=-self.lr / (1.0 - b1 ** count))
        return AdamState(count, state.mu, state.nu)
