"""KV-cache ops of autoregressive decode (reference
``paddle_tpu/ops/generation_ops.py``). The reference updates its caches
functionally under buffer donation; here the same updates are in-place
writes into the cache tensors, so a step never copies a cache.

Dense layout: per-layer [S, C, D] caches, one slot per sequence.

Paged layout (``generation_paged_kv``): per-layer K/V storage is one
pool of blocks; logical position p of a sequence lives at pool row
``table[p // BS] * BS + p % BS`` of its block table. Every paged op here
takes the pool as its **storage of NB + 1 blocks**, [NB + 1, BS, D]: the
first NB are the pool the tables address, the last is a sink. Where the
reference drops a write (window padding, a dead table entry >= NB, which
is how the host marks inactive and pool-starved slots), the port writes
the row into the sink instead. So the ops compute every index on the
device and never read a mask back to the host, and no live row is ever
written twice. The sink is never read: attention sees the first NB
blocks, and block ids are clipped into them.

The rows a write lands on depend only on positions and tables, so the
model computes them once per admission or decode step
(:func:`paged_window_rows`, :func:`paged_append_rows`) and every layer
writes its K and V through :func:`kv_cache_write_rows`;
:func:`kv_cache_write_paged` and :func:`kv_cache_append_paged` are the
reference's ops composed of the two.
"""

import torch

from .flash_attention import decode_attention, decode_attention_paged

__all__ = ["kv_cache_write_slot", "kv_cache_append",
           "multihead_attention_decode", "kv_cache_write_paged",
           "kv_cache_append_paged", "kv_block_copy", "kv_cache_write_rows",
           "paged_window_rows", "paged_append_rows",
           "multihead_attention_decode_paged",
           "multihead_attention_prefill_paged"]


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


def _storage_rows(blk, pos, live, num_blocks, block_size):
    """Rows of the flattened [NB + 1, BS] storage: blk * BS + pos % BS
    where ``live`` and blk is in [0, NB), the sink block elsewhere."""
    live = live & (blk >= 0) & (blk < num_blocks)
    return torch.where(live, blk, num_blocks) * block_size + pos % block_size


def paged_window_rows(table, hist, length, t, num_blocks, block_size):
    """Storage rows of a t-row prompt window's writes: window row
    i < ``length`` at logical position hist + i through ``table`` [MB];
    padding rows and dead entries go to the sink. One admission's rows
    serve every layer's K and V write."""
    mb = table.shape[0]
    idx = torch.arange(t, device=table.device)
    pos = int(hist) + idx
    blk = table[(pos // block_size).clamp(0, mb - 1)]
    return _storage_rows(blk, pos, idx < int(length), num_blocks,
                         block_size)


def paged_append_rows(pos, table, num_blocks, block_size):
    """Storage rows of a decode step's writes: slot s's row at pos[s]
    through its table row ``table[s]`` ([S, MB]); dead entries (>= NB,
    how the host marks inactive and pool-starved slots) go to the sink.
    One step's rows serve every layer's K and V write."""
    s, mb = table.shape
    pos = pos.to(device=table.device, dtype=torch.long)
    blk = table[torch.arange(s, device=table.device),
                (pos // block_size).clamp(0, mb - 1)]
    return _storage_rows(blk, pos, torch.ones_like(pos, dtype=torch.bool),
                         num_blocks, block_size)


def kv_cache_write_rows(pool, new, rows):
    """new [N, D] into the storage rows ``rows`` [N] of the pool
    [NB + 1, BS, D], in place (``index_copy_``). Rows are distinct
    except in the sink, whose content nothing reads."""
    pool.view(-1, pool.shape[2]).index_copy_(0, rows, new.to(pool.dtype))
    return pool


def kv_cache_write_paged(pool, new, table, hist, length):
    """Prefill a token window through a block table, in place: pool
    [NB + 1, BS, D] storage, new [1, T, D], table [MB] int, hist and
    length ints. Window row i < length lands at logical position
    hist + i; rows at or past ``length`` are dropped (into the sink)."""
    rows = paged_window_rows(table.to(pool.device), hist, length,
                             new.shape[1], pool.shape[0] - 1, pool.shape[1])
    return kv_cache_write_rows(pool, new[0], rows)


def kv_cache_append_paged(pool, new, pos, table):
    """Decode: one row per slot through its own table row, in place:
    pool [NB + 1, BS, D] storage, new [S, 1, D], pos [S] int, table
    [S, MB] int. A dead table entry (>= NB) drops the write (into the
    sink), so a slot never writes a block it does not own."""
    rows = paged_append_rows(pos, table.to(pool.device),
                             pool.shape[0] - 1, pool.shape[1])
    return kv_cache_write_rows(pool, new[:, 0], rows)


def kv_block_copy(pool, src, dst):
    """Copy-on-write: block ``dst`` of the pool [NB + 1, BS, D] storage
    becomes a copy of block ``src``, in place, on the device. Ids clamp
    into [0, NB), as ``dynamic_slice`` does."""
    nb = pool.shape[0] - 1
    src = min(max(int(src), 0), nb - 1)
    dst = min(max(int(dst), 0), nb - 1)
    pool[dst].copy_(pool[src])
    return pool


def multihead_attention_decode_paged(q, cache_k, cache_v, pos, table,
                                     num_heads):
    """q [S, 1, H*D], pools [NB + 1, BS, H*D] storage, pos [S] int (the
    row each slot's new token was just written to), table [S, MB] int.
    Each slot's query attends its table-gathered rows [0, pos[s]]: the
    paged twin of :func:`multihead_attention_decode`, through kernel B5.
    Returns [S, 1, H*D]."""
    s, _, dm = q.shape
    length = (pos.to(q.device) + 1).to(torch.int32)
    tbl = table.to(device=q.device, dtype=torch.int32).contiguous()
    out = decode_attention_paged(q.reshape(s, dm), cache_k[:-1],
                                 cache_v[:-1], length, tbl, num_heads)
    return out.reshape(s, 1, dm)


def multihead_attention_prefill_paged(q, cache_k, cache_v, table, hist,
                                      num_heads):
    """q [1, P, H*D] (a prompt window whose K/V rows were just written
    through the table), pools [NB + 1, BS, H*D] storage, table [MB] int,
    hist int. Window row i (logical position hist + i) attends the
    table-gathered rows [0, hist + i]: the cached prefix plus the window,
    causally. Padding rows compute values no real row reads. Plain
    torch, as the reference computes it in XLA: it runs once per
    admission. The gathered rows of bfloat16 pools are upcast to
    float32 before the products, as ``jnp.einsum`` promotes them.
    Returns [1, P, H*D]."""
    _, p, dm = q.shape
    nb, bs = cache_k.shape[0] - 1, cache_k.shape[1]
    hd = dm // num_heads
    tbl = table.to(device=q.device, dtype=torch.long).clamp(0, nb - 1)
    c = tbl.shape[0] * bs
    qh = q.reshape(p, num_heads, hd).transpose(0, 1)            # [H, P, hd]
    kh = cache_k[tbl].float().reshape(c, num_heads, hd).transpose(0, 1)
    vh = cache_v[tbl].float().reshape(c, num_heads, hd).transpose(0, 1)
    s = torch.matmul(qh, kh.transpose(1, 2)) * (hd ** -0.5)
    cols = torch.arange(c, device=q.device)
    rows = int(hist) + torch.arange(p, device=q.device)
    s = torch.where(cols[None, None, :] <= rows[None, :, None], s, -1e30)
    prob = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(prob, vh).transpose(0, 1).reshape(1, p, dm)
