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

The reference's op types (``kv_cache_write_slot``, ``kv_cache_append``,
``kv_cache_write_paged``, ``kv_cache_append_paged``, ``kv_block_copy``
and the three attentions) are registered here over these functions, with
its slots and attributes, for the cached generation programs of
``models.transformer.transformer_lm_session``. Their indices (slot,
positions, hist, lengths, block ids) may be tensors on the cache's
device, as the programs feed them, or ints, as the ``nn.Module`` route
passes them; a tensor index is never read back to the host. A program's
pools are declared [NB, BS, D], as the reference declares them; the
session materializes the storage of NB + 1 blocks under those names.
A cache op's ``Out`` names its ``Cache``: the executor lets it write in
place (the reference's donated buffer); where it may not (under
``nonfinite_guard``, which must be able to keep the old state), the op
writes into a copy.
"""

import torch

from ..core.registry import register_op
from .flash_attention import decode_attention, decode_attention_paged

__all__ = ["kv_cache_write_slot", "kv_cache_append",
           "multihead_attention_decode", "kv_cache_write_paged",
           "kv_cache_append_paged", "kv_block_copy", "kv_cache_write_rows",
           "paged_window_rows", "paged_append_rows",
           "multihead_attention_decode_paged",
           "multihead_attention_prefill_paged",
           "multihead_attention_verify_paged", "VERIFY_TAG"]

# the attribute of a Program whose paged prefill attention is the
# speculative verify's (``multihead_attention_verify_paged``): set by
# ``transformer_lm_session`` on its verify program, read by the
# ``multihead_attention_prefill_paged`` op, ignored by serialization
VERIFY_TAG = "_verify_as_decode"


def _index(value, device):
    """An index argument as a 0-d int64 tensor on ``device`` (a tensor's
    first element, never read back to the host), or as an int."""
    if isinstance(value, torch.Tensor):
        return value.reshape(-1)[0].to(device=device, dtype=torch.long)
    return int(value)


def _block_id(value, device, count):
    """An index argument (an int, or a tensor of one on ``device``) as a
    [1] int64 tensor on ``device``, clamped into [0, count)."""
    return torch.as_tensor(value, device=device).reshape(-1)[:1].to(
        torch.long).clamp(0, count - 1)


def kv_cache_write_slot(cache, new, slot):
    """cache [S, C, D], new [1, T, D] (T <= C), slot an int or a tensor
    of one: rows [0, T) of that slot are overwritten, in place. An
    out-of-range slot clamps, as ``dynamic_update_slice`` does."""
    cache.narrow(1, 0, new.shape[1]).index_copy_(
        0, _block_id(slot, cache.device, cache.shape[0]),
        new.to(cache.dtype))
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
    padding rows and dead entries go to the sink. ``hist`` and
    ``length`` are ints or tensors of one. One admission's rows serve
    every layer's K and V write."""
    mb = table.shape[0]
    idx = torch.arange(t, device=table.device)
    pos = _index(hist, table.device) + idx
    blk = table[(pos // block_size).clamp(0, mb - 1)]
    return _storage_rows(blk, pos, idx < _index(length, table.device),
                         num_blocks, block_size)


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
    becomes a copy of block ``src``, in place, on the device. Ids (ints
    or tensors of one) clamp into [0, NB), as ``dynamic_slice`` does."""
    nb = pool.shape[0] - 1
    pool.index_copy_(0, _block_id(dst, pool.device, nb),
                     pool.index_select(0, _block_id(src, pool.device, nb)))
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
    rows = _index(hist, q.device) + torch.arange(p, device=q.device)
    s = torch.where(cols[None, None, :] <= rows[None, :, None], s, -1e30)
    prob = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(prob, vh).transpose(0, 1).reshape(1, p, dm)


def multihead_attention_verify_paged(q, cache_k, cache_v, table, hist,
                                     num_heads):
    """The speculative verify's attention: q [1, W, H*D], a window whose
    K/V rows were just written through ``table`` [MB] from logical
    position ``hist`` (an int or a tensor of one). Row i attends rows
    [0, hist + i] as the decode step at that position does: W queries of
    :func:`multihead_attention_decode_paged` (kernel B5), where the
    reference runs its prefill attention. The same function, and row for
    row the decode step's arithmetic, so a speculative stream is the
    plain one. Returns [1, W, H*D]."""
    _, w, dm = q.shape
    pos = _index(hist, q.device) + torch.arange(w, device=q.device)
    out = multihead_attention_decode_paged(
        q.reshape(w, 1, dm), cache_k, cache_v, pos,
        table.reshape(1, -1).expand(w, -1), num_heads)
    return out.reshape(1, w, dm)


# -- the reference's op types ------------------------------------------------

def _meta(t):
    return t.device.type == "meta"


def _cache(ctx):
    """The op's cache tensor to write: the input itself where the
    executor lets ``Out`` be written in place, else a copy of it."""
    cache = ctx.input("Cache")
    return cache if ctx.in_place("Out", "Cache") or _meta(cache) \
        else cache.clone()


@register_op("kv_cache_write_slot")
def _kv_cache_write_slot(ctx):
    """Cache [S, C, D], New [1, T, D], Slot [1] -> Out (= Cache)."""
    cache = _cache(ctx)
    if not _meta(cache):
        kv_cache_write_slot(cache, ctx.input("New"), ctx.input("Slot"))
    return {"Out": cache}


@register_op("kv_cache_append")
def _kv_cache_append(ctx):
    """Cache [S, C, D], New [S, 1, D], Pos [S] -> Out (= Cache)."""
    cache = _cache(ctx)
    if not _meta(cache):
        kv_cache_append(cache, ctx.input("New"), ctx.input("Pos"))
    return {"Out": cache}


@register_op("kv_cache_write_paged")
def _kv_cache_write_paged(ctx):
    """Cache: the pool storage, New [1, T, D], Table [MB], Hist [1], Len
    [1] -> Out (= Cache)."""
    cache = _cache(ctx)
    if not _meta(cache):
        kv_cache_write_paged(cache, ctx.input("New"), ctx.input("Table"),
                             ctx.input("Hist"), ctx.input("Len"))
    return {"Out": cache}


@register_op("kv_cache_append_paged")
def _kv_cache_append_paged(ctx):
    """Cache: the pool storage, New [S, 1, D], Pos [S], Table [S, MB] ->
    Out (= Cache)."""
    cache = _cache(ctx)
    if not _meta(cache):
        kv_cache_append_paged(cache, ctx.input("New"), ctx.input("Pos"),
                              ctx.input("Table"))
    return {"Out": cache}


@register_op("kv_block_copy")
def _kv_block_copy(ctx):
    """Cache: the pool storage, Src [1], Dst [1] -> Out (= Cache)."""
    cache = _cache(ctx)
    if not _meta(cache):
        kv_block_copy(cache, ctx.input("Src"), ctx.input("Dst"))
    return {"Out": cache}


@register_op("multihead_attention_decode")
def _multihead_attention_decode(ctx):
    """Q [S, 1, H*D], CacheK/CacheV [S, C, H*D], Pos [S] -> Out [S, 1,
    H*D], through kernel B4 on the card."""
    q = ctx.input("Q")
    if _meta(q):
        return {"Out": torch.empty_like(q)}
    return {"Out": multihead_attention_decode(
        q, ctx.input("CacheK"), ctx.input("CacheV"), ctx.input("Pos"),
        ctx.attr("num_heads"))}


@register_op("multihead_attention_decode_paged")
def _multihead_attention_decode_paged(ctx):
    """Q [S, 1, H*D], CacheK/CacheV the pool storages, Pos [S], Table
    [S, MB] -> Out [S, 1, H*D], through kernel B5 on the card."""
    q = ctx.input("Q")
    if _meta(q):
        return {"Out": torch.empty_like(q)}
    return {"Out": multihead_attention_decode_paged(
        q, ctx.input("CacheK"), ctx.input("CacheV"), ctx.input("Pos"),
        ctx.input("Table"), ctx.attr("num_heads"))}


@register_op("multihead_attention_prefill_paged")
def _multihead_attention_prefill_paged(ctx):
    """Q [1, P, H*D], CacheK/CacheV the pool storages, Table [MB], Hist
    [1], Len [1] -> Out [1, P, H*D]: the plain prefill attention, or in
    a program tagged ``VERIFY_TAG`` (the speculative verify) the W
    decode queries of :func:`multihead_attention_verify_paged`."""
    q = ctx.input("Q")
    if _meta(q):
        return {"Out": torch.empty_like(q)}
    fn = multihead_attention_prefill_paged
    if getattr(getattr(ctx.block, "program", None), VERIFY_TAG, False):
        fn = multihead_attention_verify_paged
    return {"Out": fn(q, ctx.input("CacheK"), ctx.input("CacheV"),
                      ctx.input("Table"), ctx.input("Hist"),
                      ctx.attr("num_heads"))}
