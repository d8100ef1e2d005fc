"""Optimizers over named parameters (reference ``paddle_tpu/
optimizer.py`` ``SGD``, ``Momentum`` and ``Adam``).

An optimizer takes ``{reference name: parameter}`` (for a ResNet,
``model.reference_parameters()``) and keeps its accumulators under the
reference's scope names: the velocity of parameter ``p`` is
``p_velocity_acc_0`` and the learning rate ``learning_rate_0``, so a
reference scope's optimizer state loads by name
(``io.params_from_jax``); Adam's are ``p_moment1_acc_0``,
``p_moment2_acc_0``, ``p_beta1_pow_acc_0`` and ``p_beta2_pow_acc_0``.
An optimizer trains its parameters: it turns their ``requires_grad`` on.
:meth:`step` applies the update ops of ``ops/optimizer_ops.py`` in place
to every parameter that has a gradient."""

import torch

from .ops import optimizer_ops

__all__ = ["SGD", "Momentum", "Adam"]

LR_NAME = "learning_rate_0"


class _Optimizer:
    def __init__(self, params, learning_rate):
        self.params = dict(params)
        self.learning_rate = float(learning_rate)
        for p in self.params.values():
            p.requires_grad_(True)

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


class Adam(_Optimizer):
    """Adam with bias correction through per-parameter beta powers ([1]
    tensors starting at beta1 and beta2, reference ``Adam``); the moments
    start at 0."""

    def __init__(self, params, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        super().__init__(params, learning_rate)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.slots = {}
        for name, p in self.params.items():
            pow1 = torch.full((1,), beta1, dtype=p.dtype, device=p.device)
            pow2 = torch.full((1,), beta2, dtype=p.dtype, device=p.device)
            self.slots[name] = (torch.zeros_like(p), torch.zeros_like(p),
                                pow1, pow2)

    def accumulators(self):
        out = {}
        for name, slots in self.slots.items():
            for kind, t in zip(("moment1", "moment2", "beta1_pow",
                                "beta2_pow"), slots):
                out["%s_%s_acc_0" % (name, kind)] = t
        return out

    def _update(self, name, param, grad):
        optimizer_ops.adam(param, grad, *self.slots[name],
                           self.learning_rate, self.beta1, self.beta2,
                           self.epsilon)
