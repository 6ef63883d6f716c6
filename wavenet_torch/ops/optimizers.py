"""Optimizer factory with the reference's hyperparameter quirks.

Counterpart of ``wavenet_tpu/ops/optimizers.py`` (optax there):

  * adam    -> eps 1e-4 added OUTSIDE the square root. ``torch.optim.Adam``
               computes optax's ``adam`` update, mu_hat / (sqrt(nu_hat) +
               eps) with the same bias corrections, so it is used as is.
  * sgd     -> ``torch.optim.SGD`` with momentum: its buffer
               ``m = momentum * m + g`` is optax's ``trace``.
  * rmsprop -> decay 0.9, eps 1e-5 INSIDE the square root, initial scale
               0, then the learning rate, then optax's momentum trace.
               ``torch.optim.RMSprop`` puts eps outside the root and
               applies the learning rate after the momentum, so it does
               not match; ``RMSPropInSqrt`` below does.

Each factory takes (learning_rate, momentum) and returns a function that
builds the optimizer for a list of parameters.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


class RMSPropInSqrt(torch.optim.Optimizer):
    """optax.rmsprop(lr, decay, eps, momentum, eps_in_sqrt=True):
    nu = decay * nu + (1 - decay) * g^2;  u = -lr * g / sqrt(nu + eps);
    m = u + momentum * m;  p += m."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-5, momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, decay = group["lr"], group["decay"]
            eps, momentum = group["eps"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    state["trace"] = torch.zeros_like(p)
                nu, trace = state["nu"], state["trace"]
                nu.mul_(decay).addcmul_(g, g, value=1.0 - decay)
                u = g * torch.rsqrt(nu + eps) * (-lr)
                trace.mul_(momentum).add_(u)
                p.add_(trace)
        return loss


def create_adam_optimizer(learning_rate: float,
                          momentum: float | None = None) -> OptimizerFactory:
    del momentum  # the reference's adam path ignores momentum too
    return lambda params: torch.optim.Adam(params, lr=learning_rate,
                                           eps=1e-4)


def create_sgd_optimizer(learning_rate: float,
                         momentum: float) -> OptimizerFactory:
    return lambda params: torch.optim.SGD(params, lr=learning_rate,
                                          momentum=momentum)


def create_rmsprop_optimizer(learning_rate: float,
                             momentum: float) -> OptimizerFactory:
    return lambda params: RMSPropInSqrt(params, lr=learning_rate, decay=0.9,
                                        eps=1e-5, momentum=momentum)


optimizer_factory = {
    "adam": create_adam_optimizer,
    "sgd": create_sgd_optimizer,
    "rmsprop": create_rmsprop_optimizer,
}
