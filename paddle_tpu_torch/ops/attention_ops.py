"""Multi-head attention over packed [B, T, H*D] tensors (reference
``paddle_tpu/ops/attention_ops.py`` ``multihead_attention``): the flash
branch, where queries and keys have one length, and the dense branch
otherwise. Both are differentiable: the flash branch through
``flash_attention``'s autograd Function (kernel B2 forward, the
reference's chunked recompute backward), the dense one through torch's
autograd. With ``ring_axis`` naming an axis of the current strategy's
mesh, queries and keys of one length take ring attention over that axis
(``parallel/ring_attention.py``). Under a strategy the executor runs the
op through :func:`sharded_attention`: B2 per shard, on this rank's rows
of the batch and its share of the heads on the model axis (the
reference's flash kernel under ``shard_map``: dp shards B, tp shards H,
T stays local).

The program op ``multihead_attention`` (the reference's slots ``Q``,
``K``, ``V``, optional ``KeyLength``, ``Out``; attributes ``num_heads``,
``causal``, ``ring_axis``) is registered here. Under the executor a
differentiated op runs ``flash_attention`` with autograd recording, and
its ``vjp_grad`` takes the gradient through the autograd Function's
backward, the reference's chunked recompute: the forward is not run
again at the gradient."""

import torch

from ..core.registry import register_op
from .. import parallel
from ..parallel import spmd
from .flash_attention import flash_attention

__all__ = ["multihead_attention", "sharded_attention"]


def multihead_attention(q, k, v, num_heads, causal=False, key_length=None,
                        ring_axis=None):
    """q [B, Tq, H*D], k/v [B, Tk, H*D]; ``key_length`` [B] masks keys at
    or past each row's length (and, when Tq == Tk, zeroes the padded
    query rows). ``ring_axis``: an axis of the current strategy's mesh
    to split T over (ring attention, without the key mask, as the
    reference's). Returns [B, Tq, H*D]."""
    b, tq, dm = q.shape
    tk = k.shape[1]
    hd = dm // num_heads
    qh = q.reshape(b, tq, num_heads, hd)
    kh = k.reshape(b, tk, num_heads, hd)
    vh = v.reshape(b, tk, num_heads, hd)
    strategy = parallel.current_strategy()
    if ring_axis and strategy is not None and tq == tk and \
            ring_axis in strategy.mesh.axis_names:
        out = parallel.ring_attention(qh, kh, vh, strategy.mesh,
                                      axis_name=ring_axis, causal=causal)
        return out.reshape(b, tq, dm)
    if tq == tk:
        seg = None
        if key_length is not None:
            klen = key_length.reshape(-1).to(q.device)
            seg = (torch.arange(tk, device=q.device)[None, :]
                   < klen[:, None]).to(torch.int32)
        out = flash_attention(qh.transpose(1, 2).contiguous(),
                              kh.transpose(1, 2).contiguous(),
                              vh.transpose(1, 2).contiguous(),
                              causal=causal, segment_ids=seg)
        return out.transpose(1, 2).reshape(b, tq, dm)

    # f32 scores whatever the inputs' dtype (preferred_element_type there)
    s = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) \
        * (hd ** -0.5)
    neg = torch.finfo(torch.float32).min
    if causal:
        mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None, None], s, neg)
    if key_length is not None:
        klen = key_length.reshape(-1).to(q.device)
        kmask = torch.arange(tk, device=q.device)[None, :] < klen[:, None]
        s = torch.where(kmask[:, None, None, :], s, neg)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vh)
    return out.reshape(b, tq, dm)


def sharded_attention(q, k, v, op, strategy, key_length=None,
                      rows_sharded=True):
    """The ``multihead_attention`` op on one rank under ``strategy``: q,
    k, v [b, T, H*D] are this rank's rows of the batch (``rows_sharded``)
    or the whole batch. With a model axis whose size divides the heads,
    B2 runs per shard on this rank's heads ([b, H/tp, T, D]) and the
    heads are gathered (counted in ``sharded_attention.per_shard``); a
    ring axis of the mesh takes ring attention; otherwise the op runs as
    it is on the local rows."""
    nh = op.attrs["num_heads"]
    causal = op.attrs.get("causal", False)
    ring_axis = op.attrs.get("ring_axis")
    mesh = strategy.mesh
    if ring_axis and ring_axis in mesh.axis_names and \
            q.shape[1] == k.shape[1]:
        group = strategy.mesh.group(strategy.data_axis)
        regather = rows_sharded and ring_axis == strategy.data_axis
        if regather:
            # the ring splits T over the ranks that hold the rows: all
            # the rows first
            q, k, v = (spmd.GatherRows.apply(t, group, 0)
                       for t in (q, k, v))
        out = multihead_attention(q, k, v, nh, causal, key_length,
                                  ring_axis=ring_axis)
        return spmd.SliceRows.apply(out, group, 0) if regather else out
    maxis = strategy.model_axis
    tp = mesh.size(maxis)
    if maxis is None or nh % tp or q.shape[1] != k.shape[1]:
        return multihead_attention(q, k, v, nh, causal, key_length)
    group = mesh.group(maxis)
    q, k, v = (spmd.SliceShared.apply(t, group, 2) for t in (q, k, v))
    sharded_attention.per_shard += 1
    out = multihead_attention(q, k, v, nh // tp, causal, key_length)
    return spmd.GatherShared.apply(out, group, 2)


sharded_attention.per_shard = 0


@register_op("multihead_attention")
def _multihead_attention(ctx):
    """Q, K, V [B, T, H*D] packed; ``KeyLength`` [B] masks padded keys;
    ``ring_axis`` takes ring attention over that axis of the current
    strategy's mesh. A CUDA tensor with Tq == Tk takes kernel B2, a CPU
    one its plain version. On ``meta`` tensors (shape inference) the
    output's shape and dtype are q's."""
    q = ctx.input("Q")
    if q.device.type == "meta":
        return {"Out": torch.empty_like(q)}
    return {"Out": multihead_attention(
        q, ctx.input("K"), ctx.input("V"), ctx.attr("num_heads"),
        causal=ctx.attr("causal", False),
        key_length=ctx.input("KeyLength"),
        ring_axis=ctx.attr("ring_axis"))}
