"""Activation ops (reference ``paddle_tpu/ops/activation_ops.py``): one
``_register`` table of unary ops on ``X``, each keeping the input's
dtype, plus ``softmax`` and ``prelu``.

Each compute is the reference's expression in torch ops, written so that
autograd takes the reference's gradient where a kink or a tie decides
it: ``clip`` is ``minimum(maximum(x, lo), hi)`` as ``jnp.clip`` (half the
gradient to each side at a bound), ``softplus`` is ``logaddexp(x, 0)``
(its gradient ``sigmoid(x)``, one half at 0), ``jnp.where`` becomes
``torch.where`` (the unselected branch takes no gradient), and ``abs``
takes JAX's gradient at 0 (1, where torch's is 0). A constant
meets a float32 tensor as a Python float, which torch rounds to float32
as JAX's weak typing does; another float dtype takes it as a 0-d tensor
of its own dtype (``const``), and a division by a constant divides by a
0-d tensor on the tensor's device (torch turns a division by a Python
scalar into a multiplication by its reciprocal on the card).

``exp``, ``log``, ``tanh`` and the other transcendentals are torch's,
which differ from XLA's float32 approximations in the last bits: the
tests state a tolerance of a few ulp for each.
"""

import torch

from ..core.registry import register_op
from .nn_ops import gelu

__all__ = ["const", "clip", "abs_"]


def const(v, like):
    """``v`` as a constant of ``like``'s float dtype: the Python float
    for float32 (torch rounds it once, as JAX's weak type does), a 0-d
    tensor of ``like``'s dtype and device otherwise. For an integer
    tensor the Python float, which promotes it to float32 in both
    packages."""
    if like.dtype == torch.float32 or not like.is_floating_point():
        return v
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _t(v, like):
    """``v`` as a 0-d tensor of ``like``'s dtype on its device: a
    divisor, or an operand whose dtype must not promote ``like``."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def clip(x, lo=None, hi=None):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, each bound a 0-d
    tensor of x's dtype (the reference's weak-typed scalar)."""
    if lo is not None:
        x = torch.maximum(x, _t(lo, x))
    if hi is not None:
        x = torch.minimum(x, _t(hi, x))
    return x


class _Abs(torch.autograd.Function):
    """``|x|`` with JAX's gradient: ``g`` where ``x >= 0`` (at 0 too),
    else ``-g`` (torch's is 0 at 0)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs_(x):
    """``jnp.abs``: torch's ``abs``, and where a gradient is taken, the
    reference's gradient at 0 (:class:`_Abs`)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Abs.apply(x)
    return torch.abs(x)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _where(cond, a, b):
    """``jnp.where`` with a Python number for either branch."""
    if not isinstance(a, torch.Tensor):
        a = _t(a, b)
    if not isinstance(b, torch.Tensor):
        b = _t(b, a)
    return torch.where(cond, a, b)


def _register(name, fn):
    @register_op(name)
    def _compute(ctx, fn=fn):
        return {"Out": fn(ctx.input("X"), ctx)}


def _softshrink(x, c):
    lam = c.attr("lambda", 0.5)
    return _where(x > lam, x - const(lam, x),
                  _where(x < -lam, x + const(lam, x), 0.0))


def _soft_relu(x, c):
    t = c.attr("threshold", 40.0)
    return torch.log(1.0 + torch.exp(clip(x, -t, t)))


_register("sigmoid", lambda x, c: torch.sigmoid(x))
_register("logsigmoid", lambda x, c: -_softplus(-x))
_register("exp", lambda x, c: torch.exp(x))
_register("tanh", lambda x, c: torch.tanh(x))
_register("tanh_shrink", lambda x, c: x - torch.tanh(x))
_register("softshrink", _softshrink)
_register("sqrt", lambda x, c: torch.sqrt(x))
_register("abs", lambda x, c: abs_(x))
_register("ceil", lambda x, c: torch.ceil(x))
_register("floor", lambda x, c: torch.floor(x))
# half to even, as jnp.round
_register("round", lambda x, c: torch.round(x))
_register("reciprocal", lambda x, c: torch.reciprocal(x))
_register("log", lambda x, c: torch.log(x))
_register("square", lambda x, c: x * x)
_register("softplus", lambda x, c: _softplus(x))
_register("softsign", lambda x, c: x / (1.0 + abs_(x)))
_register("brelu", lambda x, c: clip(x, c.attr("t_min", 0.0),
                                     c.attr("t_max", 24.0)))
_register("leaky_relu", lambda x, c: torch.where(
    x >= 0, x, x * const(c.attr("alpha", 0.02), x)))
_register("soft_relu", _soft_relu)
_register("elu", lambda x, c: torch.where(
    x >= 0, x, const(c.attr("alpha", 1.0), x) * (torch.exp(x) - 1.0)))
_register("relu6", lambda x, c: clip(x, 0.0, c.attr("threshold", 6.0)))
_register("stanh", lambda x, c: const(c.attr("scale_b", 1.7159), x) *
          torch.tanh(const(c.attr("scale_a", 2.0 / 3.0), x) * x))
_register("hard_shrink", lambda x, c: _where(
    torch.abs(x) > c.attr("threshold", 0.5), x, 0.0))
_register("thresholded_relu", lambda x, c: _where(
    x > c.attr("threshold", 1.0), x, 0.0))
_register("hard_sigmoid", lambda x, c: clip(
    const(c.attr("slope", 0.2), x) * x + const(c.attr("offset", 0.5), x),
    0.0, 1.0))
_register("swish", lambda x, c: x * torch.sigmoid(
    const(c.attr("beta", 1.0), x) * x))
_register("silu", lambda x, c: x * torch.sigmoid(x))


@register_op("relu")
def _relu(ctx):
    return {"Out": torch.relu(ctx.input("X"))}


@register_op("softmax")
def _softmax(ctx):
    return {"Out": torch.softmax(ctx.input("X"), dim=-1)}


@register_op("gelu")
def _gelu(ctx):
    """``jax.nn.gelu``'s default, the tanh approximation, as the
    ``nn.Module`` LM computes it (``nn_ops.gelu``, ``F.gelu(approximate=
    "tanh")``): within 2 ulp of XLA's float32 expression of the same
    formula (``tests/test_torch_program_lm.py``)."""
    return {"Out": gelu(ctx.input("X"))}


@register_op("prelu")
def _prelu(ctx):
    """``x`` where ``x >= 0``, else ``alpha * x``, alpha broadcast as
    numpy broadcasts it ([1], [C, 1, 1] or x's trailing shape)."""
    x, alpha = ctx.input("X"), ctx.input("Alpha")
    return {"Out": torch.where(x >= 0, x, alpha * x)}
