"""Optimizer update ops (reference ``paddle_tpu/ops/optimizer_ops.py``:
``sgd``, ``momentum``, ``adam``, ``adamax``, ``adagrad``,
``decayed_adagrad``, ``adadelta``, ``rmsprop``, ``proximal_gd``,
``proximal_adagrad`` and ``ftrl``), as IN-PLACE updates of
the parameter and its accumulators: the reference's functional update
with its buffers donated, without the copy.

The program ops of the same names are registered here. Each writes in
place when the executor allows it and its outputs name its inputs (as
``minimize`` appends them), and otherwise returns new tensors, the
reference's functional form, with the same arithmetic in the same
order: each in-place step rounds as the functional expression it
replaces.

A ``Rows`` input makes the ``Grad`` a sparse (SelectedRows) gradient of
an embedding table (``ops/sparse_ops.py``): sgd, momentum, adagrad and
adam merge its duplicate rows, drop the rows out of range (the
reference's scatter ``mode="drop"``: filtered here) and update the rows
that remain, each once (lazily: the other rows' moments do not
advance). Under a strategy a row-sharded table's Param holds one block
of rows: its rows are its global rows less the block's first
(``DistRun.row_base``), and the other blocks' rows are dropped. The
other update rules have no sparse form and refuse a ``Rows`` input."""

import torch

from ..core.registry import register_op

__all__ = ["sgd", "momentum", "adam", "adamax", "adagrad",
           "decayed_adagrad", "adadelta", "rmsprop", "proximal_gd",
           "proximal_adagrad", "ftrl"]


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
            "%s has no sparse (SelectedRows) update rule: use "
            "SGD/Momentum/Adagrad/Adam for sparse embeddings" % ctx.op.type)
    return ctx.input("Param"), ctx.input("Grad")


def _sparse_rows(ctx):
    """The sparse gradient as (rows, values) of the Param's own rows:
    merged, with the rows out of range dropped; None for a dense one."""
    if not ctx.has_input("Rows"):
        return None
    from .sparse_ops import merge_duplicate_rows
    p = ctx.input("Param")
    n = p.shape[0]
    dist = getattr(ctx.trace, "dist", None)
    base = dist.row_base.get(ctx.op.inputs["Param"][0], 0) \
        if dist is not None else 0
    rows = ctx.input("Rows").to(torch.long) - base
    rows = torch.where((rows >= 0) & (rows < n), rows,
                       torch.full_like(rows, n))
    rows, vals = merge_duplicate_rows(rows, ctx.input("Grad"), n)
    keep = rows < n
    return rows[keep].to(torch.long), vals[keep]


def _rows_target(ctx, out_slot, in_slot):
    """The tensor a sparse update writes: the input itself where the op
    may write in place, else a copy."""
    t = ctx.input(in_slot)
    return t if ctx.in_place(out_slot, in_slot) else t.clone()


def _sparse_update(ctx, rows, upd, slots=()):
    """``Param[rows] -= upd`` and each (out, in, values) of ``slots``
    set at ``rows``; returns the outputs."""
    p = _rows_target(ctx, "ParamOut", "Param")
    p.index_add_(0, rows, -upd.to(p.dtype))
    out = {"ParamOut": p}
    for o, i, vals in slots:
        t = _rows_target(ctx, o, i)
        t.index_copy_(0, rows, vals.to(t.dtype))
        out[o] = t
    return out


@register_op("sgd")
def _sgd(ctx):
    sparse = _sparse_rows(ctx)
    if sparse is not None:
        rows, vals = sparse
        return _sparse_update(ctx, rows, _lr(ctx) * vals)
    p, g = _dense(ctx)
    if ctx.in_place("ParamOut", "Param"):
        sgd(p, g, _lr(ctx))
        return {"ParamOut": p}
    return {"ParamOut": p - _lr(ctx) * g}


@register_op("momentum")
def _momentum(ctx):
    v = ctx.input("Velocity")
    mu = ctx.attr("mu", 0.9)
    nesterov = ctx.attr("use_nesterov", False)
    lr = _lr(ctx)
    sparse = _sparse_rows(ctx)
    if sparse is not None:
        # lazy sparse momentum: only touched rows advance their velocity
        rows, vals = sparse
        v_rows = mu * v[rows] + vals
        upd = (vals + mu * v_rows) * lr if nesterov else lr * v_rows
        return _sparse_update(ctx, rows, upd,
                              [("VelocityOut", "Velocity", v_rows)])
    p, g = _dense(ctx)
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
    m, v = ctx.input("Moment1"), ctx.input("Moment2")
    b1p, b2p = ctx.input("Beta1Pow"), ctx.input("Beta2Pow")
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr = _lr(ctx)
    sparse = _sparse_rows(ctx)
    if sparse is not None:
        # lazy adam: moments advance only for touched rows
        rows, vals = sparse
        lr_t = lr * torch.sqrt(1.0 - b2p.reshape(())) \
            / (1.0 - b1p.reshape(()))
        m_rows = b1 * m[rows] + (1.0 - b1) * vals
        v_rows = b2 * v[rows] + (1.0 - b2) * torch.square(vals)
        upd = lr_t * m_rows / (torch.sqrt(v_rows) + eps)
        out = _sparse_update(ctx, rows, upd,
                             [("Moment1Out", "Moment1", m_rows),
                              ("Moment2Out", "Moment2", v_rows)])
        for o, i, beta in (("Beta1PowOut", "Beta1Pow", b1),
                           ("Beta2PowOut", "Beta2Pow", b2)):
            t = ctx.input(i)
            out[o] = t.mul_(beta) if ctx.in_place(o, i) else t * beta
        return out
    p, g = _dense(ctx)
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


def _all_in_place(ctx, pairs):
    return all(ctx.in_place(o, i) for o, i in pairs)


def _functional_or_in_place(ctx, fn, pairs, args, **kw):
    """Run ``fn`` (an update written in place) on the op's tensors where
    every output of ``pairs`` may be written into its input, else on
    clones of them (the reference's functional form); returns the
    outputs."""
    inplace = _all_in_place(ctx, pairs)
    tensors = [ctx.input(i) if inplace else ctx.input(i).clone()
               for _, i in pairs]
    fn(*tensors, *args, **kw)
    return dict(zip((o for o, _ in pairs), tensors))


@torch.no_grad()
def adamax(param, moment, inf_norm, beta1_pow, grad, lr, beta1=0.9,
           beta2=0.999, epsilon=1e-8):
    """``m <- beta1 * m + (1 - beta1) * grad``, ``u <- max(beta2 * u,
    |grad|)``, ``param <- param - (lr / (1 - beta1_pow)) * (m / (u +
    epsilon))``, then ``beta1_pow *= beta1``."""
    moment.mul_(beta1).add_((1.0 - beta1) * grad)
    torch.maximum(inf_norm.mul_(beta2), torch.abs(grad), out=inf_norm)
    param.sub_((lr / (1.0 - beta1_pow)) * (moment / (inf_norm + epsilon)))
    beta1_pow.mul_(beta1)


@torch.no_grad()
def adagrad(param, moment, grad, lr, epsilon=1e-6):
    """``m <- m + grad^2``, ``param <- param - lr * grad / (sqrt(m) +
    epsilon)``."""
    moment.add_(torch.square(grad))
    param.sub_(lr * grad / (torch.sqrt(moment) + epsilon))


@torch.no_grad()
def decayed_adagrad(param, moment, grad, lr, decay=0.95, epsilon=1e-6):
    """``m <- decay * m + (1 - decay) * grad^2``, then as adagrad."""
    moment.mul_(decay).add_((1.0 - decay) * torch.square(grad))
    param.sub_(lr * grad / (torch.sqrt(moment) + epsilon))


@torch.no_grad()
def adadelta(param, avg_sq_grad, avg_sq_update, grad, rho=0.95,
             epsilon=1e-6):
    """``g2 <- rho * g2 + (1 - rho) * grad^2``, ``update = -sqrt((u2 +
    eps) / (g2 + eps)) * grad``, ``u2 <- rho * u2 + (1 - rho) *
    update^2``, ``param <- param + update`` (no learning rate)."""
    avg_sq_grad.mul_(rho).add_((1.0 - rho) * torch.square(grad))
    update = -torch.sqrt((avg_sq_update + epsilon) /
                         (avg_sq_grad + epsilon)) * grad
    avg_sq_update.mul_(rho).add_((1.0 - rho) * torch.square(update))
    param.add_(update)


@torch.no_grad()
def rmsprop(param, mean_square, moment, grad, lr, decay=0.9, momentum=0.0,
            epsilon=1e-10):
    """``ms <- decay * ms + (1 - decay) * grad^2``, ``mom <- momentum *
    mom + lr * grad / sqrt(ms + epsilon)``, ``param <- param - mom``."""
    mean_square.mul_(decay).add_((1.0 - decay) * torch.square(grad))
    moment.mul_(momentum).add_(lr * grad / torch.sqrt(mean_square + epsilon))
    param.sub_(moment)


def _shrink(prox, t1, t2):
    """``sign(prox) * max(|prox| - t1, 0) / (1 + t2)``."""
    return torch.sign(prox) * torch.clamp(torch.abs(prox) - t1, min=0.0) \
        / (1.0 + t2)


@torch.no_grad()
def proximal_gd(param, grad, lr, l1=0.0, l2=0.0):
    """``prox = param - lr * grad``, then the L1 shrink by ``lr * l1``
    and the L2 scale ``1 / (1 + lr * l2)``."""
    prox = param - lr * grad
    param.copy_(_shrink(prox, lr * l1, lr * l2))


@torch.no_grad()
def proximal_adagrad(param, moment, grad, lr, l1=0.0, l2=0.0):
    """``m <- m + grad^2``, ``lr_t = lr / sqrt(m)``, then as proximal_gd
    with ``lr_t``."""
    moment.add_(torch.square(grad))
    lr_t = lr / torch.sqrt(moment)
    param.copy_(_shrink(param - lr_t * grad, lr_t * l1, lr_t * l2))


@torch.no_grad()
def ftrl(param, sq_accum, lin_accum, grad, lr, l1=0.0, l2=0.0,
         lr_power=-0.5):
    """FTRL-proximal: ``n' = n + grad^2``, ``sigma = (n'^-p - n^-p) /
    lr``, ``z <- z + grad - sigma * param``, ``param <- (sign(z) * l1 -
    z) / (l2 + n'^-p / lr)`` where ``|z| > l1``, else 0; ``n <- n'``."""
    new_accum = sq_accum + torch.square(grad)
    if lr_power == -0.5:
        pw_new, pw_old = torch.sqrt(new_accum), torch.sqrt(sq_accum)
    else:
        pw_new = torch.pow(new_accum, -lr_power)
        pw_old = torch.pow(sq_accum, -lr_power)
    sigma = (pw_new - pw_old) / lr
    lin_accum.add_(grad).sub_(sigma * param)
    x = l2 + pw_new / lr
    pre_shrink = (torch.sign(lin_accum) * l1 - lin_accum) / x
    param.copy_(torch.where(torch.abs(lin_accum) > l1, pre_shrink,
                            torch.zeros_like(pre_shrink)))
    sq_accum.copy_(new_accum)


@register_op("adamax")
def _adamax(ctx):
    _dense(ctx)
    return _functional_or_in_place(
        ctx, adamax, (("ParamOut", "Param"), ("MomentOut", "Moment"),
                      ("InfNormOut", "InfNorm"), ("Beta1PowOut", "Beta1Pow")),
        (ctx.input("Grad"), _lr(ctx), ctx.attr("beta1", 0.9),
         ctx.attr("beta2", 0.999), ctx.attr("epsilon", 1e-8)))


@register_op("adagrad")
def _adagrad(ctx):
    sparse = _sparse_rows(ctx)
    if sparse is not None:
        rows, vals = sparse
        eps = ctx.attr("epsilon", 1e-6)
        m_rows = ctx.input("Moment")[rows] + torch.square(vals)
        upd = _lr(ctx) * vals / (torch.sqrt(m_rows) + eps)
        return _sparse_update(ctx, rows, upd,
                              [("MomentOut", "Moment", m_rows)])
    _dense(ctx)
    return _functional_or_in_place(
        ctx, adagrad, (("ParamOut", "Param"), ("MomentOut", "Moment")),
        (ctx.input("Grad"), _lr(ctx), ctx.attr("epsilon", 1e-6)))


@register_op("decayed_adagrad")
def _decayed_adagrad(ctx):
    _dense(ctx)
    return _functional_or_in_place(
        ctx, decayed_adagrad, (("ParamOut", "Param"), ("MomentOut", "Moment")),
        (ctx.input("Grad"), _lr(ctx), ctx.attr("decay", 0.95),
         ctx.attr("epsilon", 1e-6)))


@register_op("adadelta")
def _adadelta(ctx):
    _dense(ctx)
    return _functional_or_in_place(
        ctx, adadelta, (("ParamOut", "Param"),
                        ("AvgSquaredGradOut", "AvgSquaredGrad"),
                        ("AvgSquaredUpdateOut", "AvgSquaredUpdate")),
        (ctx.input("Grad"), ctx.attr("rho", 0.95),
         ctx.attr("epsilon", 1e-6)))


@register_op("rmsprop")
def _rmsprop(ctx):
    _dense(ctx)
    return _functional_or_in_place(
        ctx, rmsprop, (("ParamOut", "Param"), ("MeanSquareOut", "MeanSquare"),
                       ("MomentOut", "Moment")),
        (ctx.input("Grad"), _lr(ctx), ctx.attr("decay", 0.9),
         ctx.attr("momentum", 0.0), ctx.attr("epsilon", 1e-10)))


@register_op("proximal_gd")
def _proximal_gd(ctx):
    _dense(ctx)
    return _functional_or_in_place(
        ctx, proximal_gd, (("ParamOut", "Param"),),
        (ctx.input("Grad"), _lr(ctx), ctx.attr("l1", 0.0),
         ctx.attr("l2", 0.0)))


@register_op("proximal_adagrad")
def _proximal_adagrad(ctx):
    _dense(ctx)
    return _functional_or_in_place(
        ctx, proximal_adagrad, (("ParamOut", "Param"),
                                ("MomentOut", "Moment")),
        (ctx.input("Grad"), _lr(ctx), ctx.attr("l1", 0.0),
         ctx.attr("l2", 0.0)))


@register_op("ftrl")
def _ftrl(ctx):
    _dense(ctx)
    return _functional_or_in_place(
        ctx, ftrl, (("ParamOut", "Param"),
                    ("SquaredAccumOut", "SquaredAccumulator"),
                    ("LinearAccumOut", "LinearAccumulator")),
        (ctx.input("Grad"), _lr(ctx), ctx.attr("l1", 0.0),
         ctx.attr("l2", 0.0), ctx.attr("lr_power", -0.5)))
