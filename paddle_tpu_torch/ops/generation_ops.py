"""KV-cache ops of autoregressive decode, dense layout (reference
``paddle_tpu/ops/generation_ops.py``). The reference updates its caches
functionally under buffer donation; here the same updates are in-place
writes into the cache tensors, so a step never copies a cache. The
paged ops are not ported yet."""

import torch

from .flash_attention import decode_attention

__all__ = ["kv_cache_write_slot", "kv_cache_append",
           "multihead_attention_decode"]


def kv_cache_write_slot(cache, new, slot):
    """cache [S, C, D], new [1, T, D] (T <= C), slot int: rows [0, T) of
    that slot are overwritten, in place. An out-of-range slot clamps,
    as ``dynamic_update_slice`` does."""
    slot = min(max(int(slot), 0), cache.shape[0] - 1)
    cache[slot, :new.shape[1]] = new[0].to(cache.dtype)
    return cache


def kv_cache_append(cache, new, pos):
    """cache [S, C, D], new [S, 1, D], pos [S] int tensor: row pos[s] of
    every slot s is overwritten by new[s], in place. Positions past the
    cache clamp to its last row, as ``dynamic_update_slice`` does."""
    s, c, _ = cache.shape
    rows = pos.to(device=cache.device, dtype=torch.long).clamp(0, c - 1)
    cache[torch.arange(s, device=cache.device), rows] = \
        new[:, 0].to(cache.dtype)
    return cache


def multihead_attention_decode(q, cache_k, cache_v, pos, num_heads):
    """q [S, 1, H*D], caches [S, C, H*D], pos [S] int (the row each
    slot's new token was just written to). Each slot's query attends
    cache rows [0, pos[s]], its own row included. Returns [S, 1, H*D]."""
    s, _, dm = q.shape
    length = (pos.to(q.device) + 1).to(torch.int32)
    out = decode_attention(q.reshape(s, dm), cache_k, cache_v, length,
                           num_heads)
    return out.reshape(s, 1, dm)
