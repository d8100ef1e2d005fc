"""Optimizer update ops (reference ``paddle_tpu/ops/optimizer_ops.py``
``sgd``, ``momentum`` and ``adam``, dense form), as IN-PLACE updates of
the parameter and its accumulators: the reference's functional update
with its buffers donated, without the copy. Adam's lazy-rows branch is
for sparse embedding gradients, which no ported model produces.

The program ops of the same names are registered here. Each writes in
place when the executor allows it and its outputs name its inputs (as
``minimize`` appends them), and otherwise returns new tensors, the
reference's functional form, with the same arithmetic."""

import torch

from ..core.registry import register_op

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


def _lr(ctx):
    return ctx.input("LearningRate").reshape(())


def _dense(ctx):
    if ctx.has_input("Rows"):
        raise NotImplementedError(
            "sparse (SelectedRows) gradients are not ported yet: ROADMAP "
            "Queue A, \"Distribution and the input pipeline\"")
    return ctx.input("Param"), ctx.input("Grad")


@register_op("sgd")
def _sgd(ctx):
    p, g = _dense(ctx)
    if ctx.in_place("ParamOut", "Param"):
        sgd(p, g, _lr(ctx))
        return {"ParamOut": p}
    return {"ParamOut": p - _lr(ctx) * g}


@register_op("momentum")
def _momentum(ctx):
    p, g = _dense(ctx)
    v = ctx.input("Velocity")
    mu = ctx.attr("mu", 0.9)
    nesterov = ctx.attr("use_nesterov", False)
    lr = _lr(ctx)
    if ctx.in_place("ParamOut", "Param") and \
            ctx.in_place("VelocityOut", "Velocity"):
        momentum(p, g, v, lr, mu, nesterov)
        return {"ParamOut": p, "VelocityOut": v}
    v_new = mu * v + g
    if nesterov:
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return {"ParamOut": p_new, "VelocityOut": v_new}


@register_op("adam")
def _adam(ctx):
    p, g = _dense(ctx)
    m, v = ctx.input("Moment1"), ctx.input("Moment2")
    b1p, b2p = ctx.input("Beta1Pow"), ctx.input("Beta2Pow")
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr = _lr(ctx)
    if all(ctx.in_place(o, i) for o, i in (
            ("ParamOut", "Param"), ("Moment1Out", "Moment1"),
            ("Moment2Out", "Moment2"), ("Beta1PowOut", "Beta1Pow"),
            ("Beta2PowOut", "Beta2Pow"))):
        adam(p, g, m, v, b1p, b2p, lr, b1, b2, eps)
        return {"ParamOut": p, "Moment1Out": m, "Moment2Out": v,
                "Beta1PowOut": b1p, "Beta2PowOut": b2p}
    lr_t = lr * torch.sqrt(1.0 - b2p.reshape(())) / (1.0 - b1p.reshape(()))
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * torch.square(g)
    p_new = p - lr_t * m_new / (torch.sqrt(v_new) + eps)
    return {"ParamOut": p_new, "Moment1Out": m_new, "Moment2Out": v_new,
            "Beta1PowOut": b1p * b1, "Beta2PowOut": b2p * b2}
