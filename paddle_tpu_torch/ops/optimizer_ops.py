"""Optimizer update ops (reference ``paddle_tpu/ops/optimizer_ops.py``
``sgd`` and ``momentum``, dense form), as IN-PLACE updates of the
parameter and its velocity: the reference's functional update with its
buffers donated, without the copy."""

import torch

__all__ = ["sgd", "momentum"]


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
