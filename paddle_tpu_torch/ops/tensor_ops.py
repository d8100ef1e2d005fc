"""Tensor plumbing ops of the ResNet program (reference
``paddle_tpu/ops/tensor_ops.py`` ``top_k``, ``reshape``,
``fill_constant`` and ``fill_like``)."""

import torch

from ..core.framework import torch_dtype
from ..core.registry import register_op


@register_op("reshape")
def _reshape(ctx):
    return {"Out": ctx.input("X").reshape(list(ctx.attr("shape")))}


@register_op("top_k")
def _top_k(ctx):
    """The k largest entries of each row and their int32 indices."""
    vals, idx = torch.topk(ctx.input("X"), ctx.attr("k", 1), dim=-1)
    return {"Out": vals, "Indices": idx.to(torch.int32)}


@register_op("fill_constant", skip_eval_shape=True)
def _fill_constant(ctx):
    """A tensor of ``shape`` filled with ``value``, on the run's device
    (the op has no input to take it from)."""
    return {"Out": torch.full(tuple(ctx.attr("shape")),
                              ctx.attr("value", 0.0),
                              dtype=torch_dtype(ctx.attr("dtype", "float32")),
                              device=ctx.trace.device)}


@register_op("fill_like")
def _fill_like(ctx):
    return {"Out": torch.full_like(ctx.input("X"), ctx.attr("value", 0.0))}
