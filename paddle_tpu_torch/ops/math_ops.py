"""Math ops of the ResNet and LM programs (reference ``paddle_tpu/ops/
math_ops.py``): ``elementwise_add``, ``elementwise_mul`` and
``elementwise_div`` with the reference's broadcast rule, ``matmul``,
``reduce_sum``, and ``sum``, which the backward appends to fold the
gradients of a variable read by several ops. ``mul`` is in ``nn_ops.py``
and ``mean`` in ``loss_ops.py``, beside their compute."""

import torch

from ..core.registry import register_op


def _broadcast_y(x, y, axis):
    """Reference elementwise broadcast: align Y's dims to X starting at
    ``axis`` (elementwise_op.h semantics). axis=-1 → trailing alignment."""
    if x.dim() == y.dim():
        return y
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    shape = [1] * x.dim()
    for i, d in enumerate(y.shape):
        shape[axis + i] = d
    return y.reshape(shape)


def _register_elementwise(name, fn):
    @register_op("elementwise_" + name)
    def _compute(ctx, fn=fn):
        x = ctx.input("X")
        y = _broadcast_y(x, ctx.input("Y"), ctx.attr("axis", -1))
        return {"Out": fn(x, y)}


_register_elementwise("add", torch.add)
_register_elementwise("mul", torch.mul)
_register_elementwise("div", torch.div)


@register_op("matmul")
def _matmul(ctx):
    """Reference ``matmul``: the last two axes of X and Y swapped when
    ``transpose_X`` / ``transpose_Y`` (a 1-D operand is left as it is),
    ``torch.matmul``'s broadcast batch product, times ``alpha`` (rounded
    to the product's dtype first, as JAX's weak typing rounds it)."""
    x, y = ctx.input("X"), ctx.input("Y")
    if ctx.attr("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * torch.tensor(alpha, dtype=out.dtype)
    return {"Out": out}


@register_op("reduce_sum")
def _reduce_sum(ctx):
    """Reference ``reduce_sum``: over ``dim`` (an int or a list), or
    every axis when ``reduce_all`` or ``dim`` is None, keeping the
    reduced axes as 1 when ``keep_dim``. Integer sums keep the input's
    dtype (bool sums are int32), as ``jnp.sum`` with 64-bit types off."""
    x = ctx.input("X")
    dim = ctx.attr("dim")
    if ctx.attr("reduce_all", False) or dim is None:
        axes = tuple(range(x.dim()))
    else:
        axes = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
    out = x.sum(dim=axes, keepdim=ctx.attr("keep_dim", False)) if axes \
        else x.clone()
    if not x.is_floating_point():
        out = out.to(torch.int32 if x.dtype == torch.bool else x.dtype)
    return {"Out": out}


@register_op("sum")
def _sum(ctx):
    xs = ctx.inputs("X")
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}
