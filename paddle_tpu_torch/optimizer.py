"""Optimizers over named parameters (reference ``paddle_tpu/
optimizer.py`` ``SGD`` and ``Momentum``).

An optimizer takes ``{reference name: parameter}`` (for a ResNet,
``model.reference_parameters()``) and keeps its accumulators under the
reference's scope names: the velocity of parameter ``p`` is
``p_velocity_acc_0`` and the learning rate ``learning_rate_0``, so a
reference scope's optimizer state loads by name
(``io.params_from_jax``). :meth:`step` applies the update ops of
``ops/optimizer_ops.py`` in place to every parameter that has a
gradient."""

import torch

from .ops import optimizer_ops

__all__ = ["SGD", "Momentum"]

LR_NAME = "learning_rate_0"


class _Optimizer:
    def __init__(self, params, learning_rate):
        self.params = dict(params)
        self.learning_rate = float(learning_rate)

    def accumulators(self):
        """{reference scope name: accumulator tensor}."""
        return {}

    def zero_grad(self):
        for p in self.params.values():
            p.grad = None

    def step(self):
        for name, p in self.params.items():
            if p.grad is not None:
                self._update(name, p, p.grad)

    def _update(self, name, param, grad):
        raise NotImplementedError


class SGD(_Optimizer):
    """``param <- param - lr * grad``."""

    def _update(self, name, param, grad):
        optimizer_ops.sgd(param, grad, self.learning_rate)


class Momentum(_Optimizer):
    """Heavy-ball momentum, or Nesterov's with ``use_nesterov``; the
    velocities start at 0."""

    def __init__(self, params, learning_rate, momentum=0.9,
                 use_nesterov=False):
        super().__init__(params, learning_rate)
        self.momentum = momentum
        self.use_nesterov = use_nesterov
        self.velocities = {name: torch.zeros_like(p)
                           for name, p in self.params.items()}

    def accumulators(self):
        return {n + "_velocity_acc_0": v for n, v in self.velocities.items()}

    def _update(self, name, param, grad):
        optimizer_ops.momentum(param, grad, self.velocities[name],
                               self.learning_rate, self.momentum,
                               self.use_nesterov)
