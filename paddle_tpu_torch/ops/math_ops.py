"""Math ops of the ResNet program (reference ``paddle_tpu/ops/
math_ops.py``): ``elementwise_add`` with the reference's broadcast rule,
and ``sum``, which the backward appends to fold the gradients of a
variable read by several ops. ``mul`` is in ``nn_ops.py`` and ``mean``
in ``loss_ops.py``, beside their compute."""

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


@register_op("elementwise_add")
def _elementwise_add(ctx):
    x = ctx.input("X")
    y = _broadcast_y(x, ctx.input("Y"), ctx.attr("axis", -1))
    return {"Out": x + y}


@register_op("sum")
def _sum(ctx):
    xs = ctx.inputs("X")
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}
