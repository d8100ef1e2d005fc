"""Optimizer update ops (reference ``paddle_tpu/ops/optimizer_ops.py``
``sgd``, ``momentum`` and ``adam``, dense form), as IN-PLACE updates of
the parameter and its accumulators: the reference's functional update
with its buffers donated, without the copy. Adam's lazy-rows branch is
for sparse embedding gradients, which no ported model produces."""

import torch

__all__ = ["sgd", "momentum", "adam"]


@torch.no_grad()
def sgd(param, grad, lr):
    """``param <- param - lr * grad``."""
    param.sub_(lr * grad)


@torch.no_grad()
def momentum(param, grad, velocity, lr, mu=0.9, use_nesterov=False):
    """``v <- mu * v + grad``; then ``param <- param - lr * v``, or with
    ``use_nesterov`` ``param <- param - (grad + mu * v) * lr``."""
    velocity.mul_(mu).add_(grad)
    if use_nesterov:
        param.sub_((grad + mu * velocity) * lr)
    else:
        param.sub_(lr * velocity)


@torch.no_grad()
def adam(param, grad, moment1, moment2, beta1_pow, beta2_pow, lr,
         beta1=0.9, beta2=0.999, epsilon=1e-8):
    """``lr_t = lr * sqrt(1 - beta2_pow) / (1 - beta1_pow)`` from the beta
    powers BEFORE they advance; ``m <- beta1 * m + (1 - beta1) * grad``,
    ``v <- beta2 * v + (1 - beta2) * grad^2``, ``param <- param - lr_t *
    m / (sqrt(v) + epsilon)``; then the [1]-shaped powers are multiplied
    by beta1 and beta2. The operations in the reference's order, in the
    parameter's dtype; lr_t stays a [1] tensor on the device."""
    lr_t = lr * torch.sqrt(1.0 - beta2_pow) / (1.0 - beta1_pow)
    moment1.mul_(beta1).add_((1.0 - beta1) * grad)
    moment2.mul_(beta2).add_((1.0 - beta2) * torch.square(grad))
    param.sub_(lr_t * moment1 / (torch.sqrt(moment2) + epsilon))
    beta1_pow.mul_(beta1)
    beta2_pow.mul_(beta2)
