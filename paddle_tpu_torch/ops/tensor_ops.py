"""Tensor plumbing ops of the ResNet and LM programs and of the cached
generation programs (reference ``paddle_tpu/ops/tensor_ops.py``
``top_k``, ``reshape``, ``transpose``, ``gather``, ``slice``,
``arg_max``, ``fill_constant``, ``fill_like`` and ``lookup_table``)."""

import torch

from ..core.framework import torch_dtype
from ..core.registry import register_op
from .nn_ops import argmax, gather


@register_op("reshape")
def _reshape(ctx):
    return {"Out": ctx.input("X").reshape(list(ctx.attr("shape")))}


@register_op("transpose")
def _transpose(ctx):
    return {"Out": ctx.input("X").permute(*ctx.attr("axis"))}


@register_op("gather")
def _gather(ctx):
    """Rows ``Index`` (flattened) of X along axis 0."""
    return {"Out": gather(ctx.input("X"), ctx.input("Index"))}


@register_op("slice")
def _slice(ctx):
    x = ctx.input("Input")
    index = [slice(None)] * x.dim()
    for ax, st, en in zip(ctx.attr("axes"), ctx.attr("starts"),
                          ctx.attr("ends")):
        index[ax] = slice(st, en)
    return {"Out": x[tuple(index)]}


@register_op("arg_max")
def _arg_max(ctx):
    """The first maximum's index along ``axis``, int32 as the
    reference's."""
    return {"Out": argmax(ctx.input("X"), ctx.attr("axis", -1)).to(
        torch.int32)}


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


@register_op("lookup_table")
def _lookup_table(ctx):
    """Embedding lookup (reference ``lookup_table``): the rows of W at
    the flattened ids, zero at ``padding_idx``; a trailing ids axis of 1
    is squeezed unless ``keep_dims``. Its gradient is a dense scatter-add
    into W (``index_select``'s backward), as the reference's vjp of
    ``take``."""
    w, ids = ctx.input("W"), ctx.input("Ids")
    flat = ids.reshape(-1)
    emb = w.index_select(0, flat)
    pad = ctx.attr("padding_idx")
    if pad is not None:
        emb = torch.where((flat == pad)[:, None],
                          torch.zeros((), dtype=emb.dtype), emb)
    shape = tuple(ids.shape)
    if not ctx.attr("keep_dims", False) and shape and shape[-1] == 1:
        shape = shape[:-1]
    return {"Out": emb.reshape(shape + (w.shape[1],))}
