"""Multi-head attention over packed [B, T, H*D] tensors (reference
``paddle_tpu/ops/attention_ops.py`` ``multihead_attention``): the flash
branch, where queries and keys have one length, and the dense branch
otherwise. Both are differentiable: the flash branch through
``flash_attention``'s autograd Function (kernel B2 forward, the
reference's chunked recompute backward), the dense one through torch's
autograd. Ring attention and the per-shard flash path are not ported yet
(ROADMAP Queue A, "Distribution and the input pipeline").

The program op ``multihead_attention`` (the reference's slots ``Q``,
``K``, ``V``, optional ``KeyLength``, ``Out``; attributes ``num_heads``,
``causal``, ``ring_axis``) is registered here. Under the executor a
differentiated op runs ``flash_attention`` with autograd recording, and
its ``vjp_grad`` takes the gradient through the autograd Function's
backward, the reference's chunked recompute: the forward is not run
again at the gradient."""

import torch

from ..core.registry import register_op
from .flash_attention import flash_attention

__all__ = ["multihead_attention"]


def multihead_attention(q, k, v, num_heads, causal=False, key_length=None):
    """q [B, Tq, H*D], k/v [B, Tk, H*D]; ``key_length`` [B] masks keys at
    or past each row's length (and, when Tq == Tk, zeroes the padded
    query rows). Returns [B, Tq, H*D]."""
    b, tq, dm = q.shape
    tk = k.shape[1]
    hd = dm // num_heads
    qh = q.reshape(b, tq, num_heads, hd)
    kh = k.reshape(b, tk, num_heads, hd)
    vh = v.reshape(b, tk, num_heads, hd)
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


@register_op("multihead_attention")
def _multihead_attention(ctx):
    """Q, K, V [B, T, H*D] packed; ``KeyLength`` [B] masks padded keys.
    A CUDA tensor with Tq == Tk takes kernel B2, a CPU one its plain
    version. On ``meta`` tensors (shape inference) the output's shape
    and dtype are q's."""
    if ctx.attr("ring_axis"):
        raise NotImplementedError(
            "ring_axis (ring attention over a mesh) is not ported yet: "
            "ROADMAP Queue A, \"Distribution and the input pipeline\"")
    q = ctx.input("Q")
    if q.device.type == "meta":
        return {"Out": torch.empty_like(q)}
    return {"Out": multihead_attention(
        q, ctx.input("K"), ctx.input("V"), ctx.attr("num_heads"),
        causal=ctx.attr("causal", False),
        key_length=ctx.input("KeyLength"))}
