"""Math ops (reference ``paddle_tpu/ops/math_ops.py``): the elementwise
ops with the reference's broadcast rule, ``matmul``, ``scale``,
``minus``, the reductions, ``clip`` and ``clip_by_norm``, the norms and
distances, ``cos_sim``, ``bilinear_tensor_product``, ``pow``, and the
logical and comparison ops, which return bool as the reference's do;
``sum``, which the backward appends to fold the gradients of a variable
read by several ops. ``mul`` is in ``nn_ops.py`` and ``mean`` in
``loss_ops.py``, beside their compute.

The constants follow ``activation_ops.py``: a float32 tensor meets a
Python float, another float dtype a 0-d tensor of its dtype, and a
division by a constant divides by a 0-d tensor. ``reduce_max`` and
``reduce_min`` are ``amax``/``amin``, which share the gradient evenly
among tied maxima as ``jnp.max`` does; ``elementwise_max``/``_min`` are
``torch.maximum``/``minimum``, half the gradient to each side at a tie
as ``jnp.maximum``. Sums run in torch's order, not XLA's: the reductions
agree with the reference to a few ulp of their magnitude."""

import torch

from ..core.registry import register_op
from .activation_ops import _t, abs_, clip, const

__all__ = ["clip_by_norm"]


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
_register_elementwise("sub", torch.sub)
_register_elementwise("mul", torch.mul)
_register_elementwise("div", torch.div)
_register_elementwise("max", torch.maximum)
_register_elementwise("min", torch.minimum)
_register_elementwise("pow", torch.pow)


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


@register_op("scale")
def _scale(ctx):
    """``x * scale + bias``."""
    x = ctx.input("X")
    return {"Out": x * const(ctx.attr("scale", 1.0), x) +
            const(ctx.attr("bias", 0.0), x)}


@register_op("sum")
def _sum(ctx):
    xs = ctx.inputs("X")
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("minus")
def _minus(ctx):
    return {"Out": ctx.input("X") - ctx.input("Y")}


def _axes(ctx, x):
    """The reduced axes: every axis when ``reduce_all`` or ``dim`` is
    None, else ``dim`` (an int or a list), made non-negative."""
    dim = ctx.attr("dim")
    if ctx.attr("reduce_all", False) or dim is None:
        return tuple(range(x.dim()))
    dims = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
    return tuple(sorted(d % x.dim() for d in dims)) if x.dim() else ()


def _prod(x, axes, keep):
    """``jnp.prod`` over several axes: torch's ``prod`` takes one, so the
    reduced axes go last and are flattened into one."""
    if not axes:
        return x.clone()
    rest = [d for d in range(x.dim()) if d not in axes]
    moved = x.permute(rest + list(axes)).reshape(
        [x.shape[d] for d in rest] + [-1])
    out = moved.prod(dim=-1)
    if keep:
        out = out.reshape([1 if d in axes else x.shape[d]
                           for d in range(x.dim())])
    return out


def _register_reduce(name, fn):
    @register_op("reduce_" + name)
    def _compute(ctx, fn=fn):
        x = ctx.input("X")
        return {"Out": fn(x, _axes(ctx, x), ctx.attr("keep_dim", False))}


def _reduce_sum(x, axes, keep):
    """Integer sums keep the input's dtype (bool sums are int32), as
    ``jnp.sum`` with 64-bit types off."""
    out = x.sum(dim=axes, keepdim=keep) if axes else x.clone()
    if not x.is_floating_point():
        out = out.to(torch.int32 if x.dtype == torch.bool else x.dtype)
    return out


def _reduce_mean(x, axes, keep):
    """An integer mean is float32, as ``jnp.mean``'s."""
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return x.mean(dim=axes, keepdim=keep) if axes else x.clone()


_register_reduce("sum", _reduce_sum)
_register_reduce("mean", _reduce_mean)
_register_reduce("max", lambda x, axes, keep:
                 x.amax(dim=axes, keepdim=keep) if axes else x.clone())
_register_reduce("min", lambda x, axes, keep:
                 x.amin(dim=axes, keepdim=keep) if axes else x.clone())
_register_reduce("prod", _prod)


@register_op("clip")
def _clip(ctx):
    return {"Out": clip(ctx.input("X"), ctx.attr("min"), ctx.attr("max"))}


def clip_by_norm(x, max_norm):
    """``x * (max_norm / max(norm, 1e-12))`` where the L2 norm of all of
    x exceeds ``max_norm``, else x (the factor 1)."""
    norm = torch.sqrt(torch.sum(x * x))
    scale = torch.where(norm > max_norm,
                        _t(max_norm, norm) / torch.maximum(
                            norm, _t(1e-12, norm)),
                        _t(1.0, norm)).to(x.dtype)
    return x * scale


@register_op("clip_by_norm")
def _clip_by_norm(ctx):
    return {"Out": clip_by_norm(ctx.input("X"), ctx.attr("max_norm"))}


@register_op("sign")
def _sign(ctx):
    return {"Out": torch.sign(ctx.input("X"))}


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx):
    x = ctx.input("X")
    return {"Out": torch.sum(x * x)}


@register_op("squared_l2_distance")
def _squared_l2_distance(ctx):
    """Row-wise squared distance of X [N, ...] to Y (N rows, or one row
    broadcast), and the difference itself (``sub_result``)."""
    x, y = ctx.input("X"), ctx.input("Y")
    diff = x - y.reshape((-1,) + tuple(y.shape[1:]))
    sub = diff.reshape(diff.shape[0], -1)
    return {"sub_result": diff,
            "Out": torch.sum(sub * sub, dim=1, keepdim=True)}


@register_op("l1_norm")
def _l1_norm(ctx):
    return {"Out": torch.sum(abs_(ctx.input("X")))}


@register_op("cos_sim")
def _cos_sim(ctx):
    """Cosine similarity over the last axis, ``x.y / (|x| |y| +
    1e-12)``, with the two norms."""
    x, y = ctx.input("X"), ctx.input("Y")
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    out = torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn + 1e-12)
    return {"Out": out, "XNorm": xn, "YNorm": yn}


@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ctx):
    """``out[b, k] = x[b] @ W[k] @ y[b]`` (+ bias [k])."""
    x, y, w = ctx.input("X"), ctx.input("Y"), ctx.input("Weight")
    out = torch.einsum("bi,kij,bj->bk", x, w, y)
    if ctx.has_input("Bias"):
        out = out + ctx.input("Bias")
    return {"Out": out}


@register_op("pow")
def _pow(ctx):
    """``jnp.power(x, factor)``: an integer tensor to an int factor stays
    an integer, to a float factor becomes float32, as in the
    reference."""
    x, factor = ctx.input("X"), ctx.attr("factor", 1.0)
    return {"Out": torch.pow(x, const(factor, x)
                             if isinstance(factor, float) else factor)}


def _register_logical(name, fn, binary=True):
    @register_op("logical_" + name)
    def _compute(ctx, fn=fn, binary=binary):
        x = ctx.input("X")
        if binary:
            return {"Out": fn(x, ctx.input("Y"))}
        return {"Out": fn(x)}


_register_logical("and", torch.logical_and)
_register_logical("or", torch.logical_or)
_register_logical("xor", torch.logical_xor)
_register_logical("not", torch.logical_not, binary=False)


def _register_compare(name, fn):
    @register_op(name)
    def _compute(ctx, fn=fn):
        return {"Out": fn(ctx.input("X"), ctx.input("Y"))}


_register_compare("less_than", torch.lt)
_register_compare("less_equal", torch.le)
_register_compare("greater_than", torch.gt)
_register_compare("greater_equal", torch.ge)
_register_compare("equal", torch.eq)
_register_compare("not_equal", torch.ne)

