"""Multi-head attention over packed [B, T, H*D] tensors (reference
``paddle_tpu/ops/attention_ops.py`` ``multihead_attention``): the flash
branch, where queries and keys have one length, and the dense branch
otherwise. Ring attention and the sharded path are not ported yet."""

import torch

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

    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * (hd ** -0.5)
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
