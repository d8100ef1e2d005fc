"""Nested (2-level) sequence ops over padded batches (reference
``paddle_tpu/ops/nested_ops.py``). A nested batch is ``(data[B, S, T,
...], seq_len[B], sub_len[B, S])``: B outer sequences of up to S
sub-sequences of up to T elements; ``seq_len`` counts the valid
sub-sequences, ``sub_len`` the valid elements of each (0 where the
sub-sequence is padding). Masks give the reference's ragged semantics;
indices are clamped on the device, and a window or a selection past
either end is masked out, not clamped into a duplicate."""

import torch

from ..core.registry import register_op
from .sequence_ops import _finfo_min, _trail, pool_masked, take_time


def _inner_mask(sub_len, t, dtype=torch.float32):
    """[B, S, T] mask from sub_len [B, S]."""
    cols = torch.arange(t, device=sub_len.device)
    return (cols[None, None, :] < sub_len[:, :, None]).to(dtype)


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


@register_op("nested_sequence_mask")
def _nested_sequence_mask(ctx):
    seq_len = ctx.input("SeqLen").reshape(-1)
    sub_len = ctx.input("SubLen")
    s, t = ctx.attr("max_sub"), ctx.attr("maxlen")
    outer = (torch.arange(s, device=seq_len.device)[None, :]
             < seq_len[:, None]).to(torch.float32)
    return {"Outer": outer,
            "Inner": _inner_mask(sub_len, t) * outer[:, :, None]}


@register_op("nested_sequence_pool")
def _nested_sequence_pool(ctx):
    """Pool the innermost level: [B, S, T, ...] -> [B, S, ...]; an empty
    sub-sequence pools to 0 under max, first and last."""
    x = ctx.input("X")
    sub_len = ctx.input("SubLen")
    pool = ctx.attr("pool_type", "average").lower()
    m = _trail(_inner_mask(sub_len, x.shape[2], x.dtype), x.ndim - 3)
    nonempty = _trail(sub_len > 0, x.ndim - 3).to(x.dtype)
    if pool == "max":
        out = torch.amax(torch.where(m > 0, x, _finfo_min(x)), dim=2)
        return {"Out": out * (torch.sum(m, dim=2) > 0).to(x.dtype)}
    out = pool_masked(x, m, pool, 2)
    if out is not None:
        return {"Out": out}
    if pool == "first":
        return {"Out": x[:, :, 0] * nonempty}
    if pool == "last":
        idx = torch.clamp(sub_len - 1, min=0)
        return {"Out": take_time(x, idx[:, :, None], axis=2)[:, :, 0]
                * nonempty}
    raise ValueError("unknown pool_type %r" % pool)


@register_op("sub_seq")
def _sub_seq(ctx):
    """out[b] = x[b, off[b]:off[b] + size[b]] left-packed into [B,
    max_size, ...], the new length ``size``."""
    x = ctx.input("X")
    off = ctx.input("Offset").reshape(-1)
    size = ctx.input("Size").reshape(-1)
    max_size = ctx.attr("max_size")
    t = x.shape[1]
    cols = torch.arange(max_size, device=x.device)[None, :]
    pos = off[:, None] + cols
    valid = (cols < size[:, None]) & (pos >= 0) & (pos < t)
    out = take_time(x, torch.clamp(pos, 0, t - 1))
    return {"Out": torch.where(_trail(valid, x.ndim - 2), out, _zero(x)),
            "OutLen": size.to(torch.int32)}


@register_op("sub_nested_seq")
def _sub_nested_seq(ctx):
    """Sub-sequences selected by per-sequence indices: x [B, S, T, ...],
    selected [B, K] -> [B, K, T, ...]; a negative index gives an empty
    sub-sequence."""
    x = ctx.input("X")
    sub_len = ctx.input("SubLen")
    sel = ctx.input("Selected")
    valid = sel >= 0
    idx = torch.clamp(sel, 0, x.shape[1] - 1).long()
    out = take_time(x, idx)
    new_sub = torch.where(valid, torch.gather(sub_len, 1, idx),
                          torch.zeros((), dtype=sub_len.dtype,
                                      device=sub_len.device))
    return {"Out": torch.where(_trail(valid, x.ndim - 2), out, _zero(x)),
            "OutSubLen": new_sub.to(torch.int32)}
