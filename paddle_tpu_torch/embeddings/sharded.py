"""Row-sharded embedding tables (reference
``paddle_tpu/embeddings/sharded.py``): the parameter server's sparse
lookup rebuilt as collectives on the data axis.

* **Storage** — a distributed table of logical shape ``[vocab, dim]`` is
  one ``[padded_vocab, dim]`` array in mod-interleaved (shard-major)
  layout: storage row ``s*rps + k`` holds logical row ``k*n + s`` (``n``
  shards, ``rps = padded_vocab / n`` rows a shard). Row-sharded over the
  data axis (``DistStrategy.state_sharding``'s ``dist_rows``), shard
  ``s`` holds exactly the rows with ``id % n == s``: the parameter
  server's hash placement as a layout. ``padded_vocab`` rounds the vocab
  up to a multiple of :data:`PAD_MULTIPLE`, so one shape serves any
  power-of-two shard count (a resize permutes rows: ``checkpoint.py``).
* **Lookup** — a two-hop exchange over ``all_to_all_single`` on the data
  axis's process group: each rank buckets its ids by owning shard
  (:func:`_bucketize`), sends the buckets (hop 1, the ids), gathers the
  rows from its own block and sends them back (hop 2, the rows). A
  bucket holds as many ids as the rank has, so the exchange has static
  shapes and no skew overflows it. With ``embedding_wire_dtype="int8"``
  the rows cross as int8 with one f32 scale a row (the reference's
  ``amax / 127.0`` as XLA compiles it, ``amax * f32(1/127)``; then
  ``rint`` and a clip to ±127): the reference's numbers, bitwise.
* **Gradient** — the reverse route: each output row's gradient travels to
  its owner, is merged there (``merge_duplicate_rows``) and comes out as
  (Rows, Values) in global shard-major rows, which the sparse updates
  apply to the owner's block. No step makes a gradient the size of the
  table.

With no strategy, one shard, or ``embedding_shard_rows`` off, the table
has the identity layout and the lookup is a gather: no collectives. With
``embedding_a2a`` off but sharding on, each rank gathers the whole table
from the blocks and takes its rows (the reference's GSPMD gather mode),
and the gradients' rows are gathered to every rank, whose update keeps
its own. The three metric families count only while ``telemetry`` is
armed, on each rank its own share.
"""

import numpy as np
import torch

from ..core.registry import register_op
from ..observability import metrics as _metrics
from ..parallel import spmd

__all__ = ["PAD_MULTIPLE", "padded_vocab", "to_shard_major", "to_logical",
           "register_table", "dist_tables", "active_shards",
           "a2a_step_bytes", "quantize_rows"]

# Vocab padding granularity: every power-of-two shard count up to 64
# divides it, so one [padded_vocab, dim] shape survives any resize of a
# power-of-two mesh (resharding permutes rows, it never changes shapes).
PAD_MULTIPLE = 64

_LOOKUP_ROWS = _metrics.REGISTRY.counter(
    "paddle_embedding_lookup_rows_total",
    "Embedding rows looked up through distributed tables (ids per "
    "step, duplicates included)")
_A2A_BYTES = _metrics.REGISTRY.counter(
    "paddle_embedding_a2a_bytes_total",
    "Bytes exchanged over the embedding all_to_all, by payload: "
    "direction=ids (index hops) / direction=rows (row payload hops), "
    "forward and backward both counted",
    labelnames=("direction",))
_UNIQUE_RATIO = _metrics.REGISTRY.gauge(
    "paddle_embedding_unique_ratio",
    "Unique/total ids of the last distributed-lookup batch (duplicate "
    "merge leverage: low ratio = merge_duplicate_rows saves work)")


def padded_vocab(vocab):
    """Vocab rounded up to a multiple of :data:`PAD_MULTIPLE`."""
    v = int(vocab)
    return -(-v // PAD_MULTIPLE) * PAD_MULTIPLE


def to_shard_major(table, num_shards):
    """Logical row order -> mod-interleaved storage order (host numpy):
    storage row ``s*rps + k`` receives logical row ``k*n + s``; one shard
    is the identity."""
    n = int(num_shards)
    t = np.asarray(table)
    if n <= 1:
        return t
    if t.shape[0] % n:
        raise ValueError("table rows %d not divisible by %d shards"
                         % (t.shape[0], n))
    return np.ascontiguousarray(
        t.reshape((t.shape[0] // n, n) + t.shape[1:])
        .swapaxes(0, 1).reshape(t.shape))


def to_logical(table, num_shards):
    """Inverse of :func:`to_shard_major`."""
    n = int(num_shards)
    t = np.asarray(table)
    if n <= 1:
        return t
    if t.shape[0] % n:
        raise ValueError("table rows %d not divisible by %d shards"
                         % (t.shape[0], n))
    return np.ascontiguousarray(
        t.reshape((n, t.shape[0] // n) + t.shape[1:])
        .swapaxes(0, 1).reshape(t.shape))


def register_table(program, name, vocab, padded, dim, slot_of=None):
    """Record a distributed table (or one of its optimizer slots) on its
    program: the registry that placement, the executor's cache key and
    the checkpoint reshard read."""
    tables = getattr(program, "_dist_embeddings", None)
    if tables is None:
        tables = {}
        program._dist_embeddings = tables
    tables[name] = {"vocab": int(vocab), "padded": int(padded),
                    "dim": int(dim), "slot_of": slot_of}


def dist_tables(program):
    """The program's distributed-table registry (or None)."""
    return getattr(program, "_dist_embeddings", None)


def active_shards(strategy, padded):
    """(num_shards, mesh, axis) of the mod layout under ``strategy``:
    1/None/None whenever row sharding cannot apply (no strategy,
    ``embedding_shard_rows`` off, no data axis, or a shard count that
    does not divide the padded vocab). Layout, placement and the ops all
    derive from this one rule."""
    if strategy is None:
        return 1, None, None
    from .. import config as _config
    if not _config.get_flag("embedding_shard_rows"):
        return 1, None, None
    axis = strategy.data_axis
    if axis is None:
        return 1, None, None
    n = strategy.data_shards()
    if n <= 1 or int(padded) % n:
        return 1, None, None
    return n, strategy.mesh, axis


def a2a_step_bytes(total_ids, dim, n, itemsize=4, index_itemsize=4):
    """Per-step exchange volume of one two-hop route, summed over ranks:
    the index hop moves ``n * total_ids`` indices, the payload hop
    ``n * total_ids`` rows (a bucket holds a rank's id count, and each of
    the n ranks sends n buckets)."""
    return n * total_ids * index_itemsize, \
        n * total_ids * dim * itemsize


def quantize_rows(rows):
    """The int8 wire of the row hop: (int8 rows, f32 scale [..., 1]),
    symmetric per row: the reference writes ``scale = amax / 127.0`` (1
    for an all-zero row), which XLA compiles into ``amax * f32(1/127)``
    (a division by a constant becomes a product), so the port computes
    that product; then ``q = clip(rint(rows / scale), -127, 127)``."""
    amax = rows.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0.0, amax * (1.0 / 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(rows / scale), -127.0, 127.0)
    return q.to(torch.int8), scale


def _bucketize(flat, local_rows, n, sentinel):
    """Static-shape id bucketing: ids stably sorted by owning shard,
    shard s's at ``bucket[s, :counts[s]]`` (the rest ``sentinel``).
    Returns (bucket [n, m], order [m], idx [n, m], valid [n, m]); the
    same (order, idx, valid) put the replies or gradients back."""
    m = flat.shape[0]
    owner = flat % n
    order = torch.argsort(owner, stable=True)
    sorted_local = local_rows[order]
    counts = torch.bincount(owner, minlength=n)
    offs = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    col = torch.arange(m, device=flat.device)
    idx = offs[:, None] + col[None, :]
    valid = col[None, :] < counts[:, None]
    bucket = torch.where(valid, sorted_local[idx.clamp(0, max(m - 1, 0))],
                         torch.full_like(idx, sentinel))
    return bucket, order, idx, valid


def _local_rows(flat, n, rps, pad):
    """Each id's row in its owner's block; padding ids go to the
    out-of-range sentinel ``rps`` (their output is zeroed, their
    gradient dropped)."""
    local = flat // n
    if pad is not None:
        local = torch.where(flat == pad, torch.full_like(local, rps), local)
    return local


def _a2a_lookup(w_loc, flat, local, n, rps, group, wire):
    m, dim = flat.shape[0], w_loc.shape[1]
    bucket, order, idx, valid = _bucketize(flat, local, n, rps)
    recv = spmd.all_to_all(bucket, group)                  # [n, m]
    rows = torch.where((recv < rps)[..., None],
                       w_loc[recv.clamp(0, rps - 1)],
                       torch.zeros((), dtype=w_loc.dtype,
                                   device=w_loc.device))
    if wire == "int8":
        q, scale = quantize_rows(rows)
        back = spmd.all_to_all(q, group).to(w_loc.dtype) \
            * spmd.all_to_all(scale, group)
    else:
        back = spmd.all_to_all(rows, group)                # [n, m, D]
    out_sorted = w_loc.new_zeros((m + 1, dim))
    out_sorted[torch.where(valid, idx, torch.full_like(idx, m))
               .reshape(-1)] = back.reshape(-1, dim)
    out = w_loc.new_zeros((m, dim))
    out[order] = out_sorted[:m]
    return out


def _a2a_grad(g, flat, local, n, rps, vp, group, shard):
    from ..ops.sparse_ops import merge_duplicate_rows
    m, dim = flat.shape[0], g.shape[1]
    bucket, order, idx, valid = _bucketize(flat, local, n, rps)
    g_sorted = g[order]
    bvals = torch.where(valid[..., None],
                        g_sorted[idx.clamp(0, max(m - 1, 0))],
                        torch.zeros((), dtype=g.dtype, device=g.device))
    rrows = spmd.all_to_all(bucket, group)                 # [n, m]
    rvals = spmd.all_to_all(bvals, group)                  # [n, m, D]
    grows = torch.where(rrows < rps, rrows + shard * rps,
                        torch.full_like(rrows, vp)).reshape(-1)
    return merge_duplicate_rows(grows.to(torch.int32),
                                rvals.reshape(-1, dim), vp)


def _mode(vp, w_rows=None):
    """(n, group, shard, local block, a2a, telemetry, wire) of this run:
    with no strategy set (one process, build-time shapes) no flag is
    read. The table is a local block when it is row-sharded (``w_rows``,
    its rows here, is ``vp / n``; a table whose gradient is sparse always
    is, as the executor places it)."""
    from .. import parallel
    strat = parallel.current_strategy()
    if strat is None:
        return 1, None, 0, False, False, False, None
    from .. import config as _config
    n, mesh, axis = active_shards(strat, vp)
    group = strat.mesh.group(strat.data_axis)
    local = n > 1 and (w_rows is None or w_rows == vp // n)
    use_a2a = local and bool(_config.get_flag("embedding_a2a"))
    wire = _config.get_flag("embedding_wire_dtype") if use_a2a else None
    return (n, group, strat.data_coord(), local, use_a2a,
            bool(_config.get_flag("telemetry")),
            str(wire) if wire else None)


def exchanges_grads(vp):
    """Whether ``lookup_table_dist_grad`` sends its rows to their owners
    itself (the a2a route); otherwise every rank's rows go to every rank
    (``parallel/spmd.py``)."""
    return _mode(vp)[4]


def _tel_lookup(flat, total, dim, n, use_a2a, wire):
    _LOOKUP_ROWS.inc(float(total))
    if total:
        uniq = int(torch.unique(flat).numel())
        _UNIQUE_RATIO.set(float(uniq) / float(total))
    if use_a2a:
        ids_b, rows_b = a2a_step_bytes(total, dim, n,
                                       itemsize=1 if wire == "int8" else 4)
        if wire == "int8":
            rows_b += n * total * 4     # the f32 scales of the row hop
        _A2A_BYTES.labels(direction="ids").inc(float(ids_b))
        _A2A_BYTES.labels(direction="rows").inc(float(rows_b))


@register_op("lookup_table_dist")
def _lookup_table_dist_op(ctx):
    """Distributed embedding lookup on a mod-interleaved table."""
    w, ids = ctx.input("W"), ctx.input("Ids")
    vp = int(ctx.attr("padded_vocab"))
    pad = ctx.attr("padding_idx")
    squeeze = (not ctx.attr("keep_dims", False) and ids.dim()
               and ids.shape[-1] == 1)
    ishape = tuple(ids.shape[:-1] if squeeze else ids.shape)
    dim = w.shape[1]
    if w.device.type == "meta":
        return {"Out": w.new_empty(ishape + (dim,))}
    flat = ids.reshape(-1).to(torch.long)
    n, group, shard, local, use_a2a, telemetry, wire = _mode(vp,
                                                             w.shape[0])
    rps = vp // n
    lrows = _local_rows(flat, n, rps, pad)
    if use_a2a:
        out = _a2a_lookup(w, flat, lrows, n, rps, group, wire)
    else:
        # the identity layout (one shard), or a gather through the mod
        # layout from the whole table (gathered from the blocks)
        table = spmd.all_gather(w, group, 0) if local else w
        srow = ((flat % n) * rps + lrows).clamp(0, vp - 1)
        out = table[srow]
        if pad is not None:
            out = torch.where((flat == pad)[:, None],
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device), out)
    if telemetry:
        _tel_lookup(flat, int(flat.shape[0]), dim, n, use_a2a, wire)
    return {"Out": out.reshape(ishape + (dim,))}


@register_op("lookup_table_dist_grad")
def _lookup_table_dist_grad_op(ctx):
    """d(lookup_table_dist)/dW as (Rows, Values) in global shard-major
    rows, never a dense [padded_vocab, dim] gradient. On the a2a route
    each shard merges the gradients it received (its own rows; the
    others' are the out-of-range ``padded_vocab``)."""
    og, ids = ctx.input("OutGrad"), ctx.input("Ids")
    vp = int(ctx.attr("padded_vocab"))
    pad = ctx.attr("padding_idx")
    flat = ids.reshape(-1).to(torch.long)
    dim = og.shape[-1]
    g = og.reshape(flat.shape[0], dim)
    n, group, shard, local, use_a2a, telemetry, _ = _mode(vp)
    rps = vp // n
    lrows = _local_rows(flat, n, rps, pad)
    if use_a2a:
        rows, vals = _a2a_grad(g, flat, lrows, n, rps, vp, group, shard)
        if telemetry:
            ids_b, rows_b = a2a_step_bytes(int(flat.shape[0]), dim, n)
            _A2A_BYTES.labels(direction="ids").inc(float(ids_b))
            _A2A_BYTES.labels(direction="rows").inc(float(rows_b))
    else:
        rows = torch.where(lrows >= rps, torch.full_like(lrows, vp),
                           (flat % n) * rps + lrows).to(torch.int32)
        vals = g
    return {"Rows": rows, "Values": vals}
