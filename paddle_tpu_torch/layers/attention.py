"""Transformer layers with a KV cache, as ``nn.Module``s (reference
``paddle_tpu/layers/attention.py``: ``multi_head_attention_cached``
dense branch, ``transformer_encoder_layer``,
``positional_encoding_window``). Weights keep the reference's [in, out]
layout; the models' loaders map the reference's parameter names onto
these modules."""

import torch
from torch import nn

from ..ops.attention_ops import multihead_attention
from ..ops.generation_ops import (kv_cache_append, kv_cache_write_slot,
                                  multihead_attention_decode)
from ..ops.nn_ops import fc, gather, gelu, layer_norm, mul

__all__ = ["MultiHeadAttentionCached", "TransformerEncoderLayer",
           "PositionalEncodingWindow"]


def _weight(*shape, device):
    return nn.Parameter(torch.zeros(*shape, device=device),
                        requires_grad=False)


class MultiHeadAttentionCached(nn.Module):
    """q/k/v/o projections with K/V routed through one layer's
    [slots, cache_len, d_model] cache tensors.

    * ``prefill`` — x is one prompt [1, P, D]: its K/V rows are written
      into cache slot ``slot`` at positions [0, P) and attention runs
      causally within the prompt (``key_length`` masks right-padding).
    * ``decode`` — x is one token per slot [S, 1, D]: K/V rows are
      written at per-slot positions ``pos`` and each query attends its
      slot's cache rows [0, pos], its own row included."""

    def __init__(self, d_model, num_heads, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.wq = _weight(d_model, d_model, device=device)
        self.wk = _weight(d_model, d_model, device=device)
        self.wv = _weight(d_model, d_model, device=device)
        self.wo = _weight(d_model, d_model, device=device)

    def _qkv(self, x):
        return mul(x, self.wq), mul(x, self.wk), mul(x, self.wv)

    def prefill(self, x, cache_k, cache_v, slot, key_length):
        q, k, v = self._qkv(x)
        kv_cache_write_slot(cache_k, k, slot)
        kv_cache_write_slot(cache_v, v, slot)
        ctx = multihead_attention(q, k, v, self.num_heads, causal=True,
                                  key_length=key_length)
        return mul(ctx, self.wo)

    def decode(self, x, cache_k, cache_v, pos):
        q, k, v = self._qkv(x)
        kv_cache_append(cache_k, k, pos)
        kv_cache_append(cache_v, v, pos)
        ctx = multihead_attention_decode(q, cache_k, cache_v, pos,
                                         self.num_heads)
        return mul(ctx, self.wo)


class TransformerEncoderLayer(nn.Module):
    """Pre-norm block: x + MHA(LN(x)); x + FFN(LN(x)), FFN = fc + gelu,
    fc. ``mode`` picks the cached attention's prefill or decode."""

    def __init__(self, d_model, num_heads, d_ff, device=None):
        super().__init__()
        self.ln1_w = _weight(d_model, device=device)
        self.ln1_b = _weight(d_model, device=device)
        self.attn = MultiHeadAttentionCached(d_model, num_heads, device)
        self.ln2_w = _weight(d_model, device=device)
        self.ln2_b = _weight(d_model, device=device)
        self.ffn1_w = _weight(d_model, d_ff, device=device)
        self.ffn1_b = _weight(d_ff, device=device)
        self.ffn2_w = _weight(d_ff, d_model, device=device)
        self.ffn2_b = _weight(d_model, device=device)

    def forward(self, x, cache_k, cache_v, mode, slot=None, pos=None,
                key_length=None):
        h = layer_norm(x, self.ln1_w, self.ln1_b)
        if mode == "prefill":
            att = self.attn.prefill(h, cache_k, cache_v, slot, key_length)
        elif mode == "decode":
            att = self.attn.decode(h, cache_k, cache_v, pos)
        else:
            raise ValueError("mode must be 'prefill' or 'decode', got %r"
                             % (mode,))
        x = x + att
        h = layer_norm(x, self.ln2_w, self.ln2_b)
        ff = fc(h, self.ffn1_w, self.ffn1_b, act=gelu)
        return x + fc(ff, self.ffn2_w, self.ffn2_b)


class PositionalEncodingWindow(nn.Module):
    """A window of the learned [max_len, D] position table: rows
    [0, P) added to a prompt [1, P, D] (``pos=None``), or row pos[s]
    added to each slot's token [S, 1, D]."""

    def __init__(self, max_len, d_model, device=None):
        super().__init__()
        self.max_len = max_len
        self.table = _weight(max_len, d_model, device=device)

    def forward(self, x, pos=None):
        if pos is None:
            t = x.shape[1]
            if t > self.max_len:
                raise ValueError("prefill window %d exceeds the position "
                                 "table length %d" % (t, self.max_len))
            return x + self.table[:t]
        rows = gather(self.table, pos.to(device=x.device, dtype=torch.long))
        return x + rows.reshape(-1, 1, x.shape[2])
