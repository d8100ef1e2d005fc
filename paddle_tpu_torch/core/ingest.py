"""Narrow-wire ingest: packed single-copy feeds and widening on the card
(reference ``paddle_tpu/core/ingest.py``).

Two levers cut what a batch costs on its way to the card:

* **Packing**: all feed arrays of one batch are laid out in ONE
  contiguous uint8 block (64-byte-aligned slots) and cross host to
  device in one copy (``reader/staging.py``). The block is shaped
  ``(shards, shard_nbytes)``, as the reference lays it out. The executor
  unpacks it on the card by slicing the buffer and viewing each slot as
  its wire dtype (``unpack``: ``Tensor.view(dtype)``, no copy), and
  drops the buffer once unpacked (the reference donates it).
* **Widening**: feeds travel in their wire dtype (uint8 images, int32
  ids) and are cast and normalized to the model dtype on the card
  (``widen``), before the first op reads them.

The layout code (``plan_layout``, ``pack_feed``, ``explode_sparse``) is
numpy only and the reference's, so a block packed by either package is
byte-for-byte the other's. The wire keeps the reference's demotion of
64-bit types (``_canon_array``: int64 crosses as int32), which the
port's ``framework.convert_dtype`` applies as the reference's does
without jax x64.
"""

import collections

import numpy as np
import torch

from .framework import convert_dtype, torch_dtype

__all__ = ["FeedSlot", "PackedBatch", "PACKED_FEED", "SparseTriple",
           "plan_layout", "pack_feed", "unpack", "widen", "canon_norm",
           "explode_sparse"]

# Reserved feed name the executor binds a PackedBatch's buffer to.
PACKED_FEED = "@PACKED_FEED@"

# Host copy / slot alignment: every slot base is cache-line aligned
# inside the staging block (the arena aligns the block base), so the
# staging copies run at full host bandwidth and every slot's offset is a
# multiple of every wire dtype's size (``Tensor.view(dtype)`` needs it).
_ALIGN = 64

# One packed slot, all static: name, wire dtype (str), rows per shard,
# per-sample trailing shape, byte offset/extent within one shard row.
# ``kind`` is "dense" or "sparse"; sparse slots carry a ragged (ids,
# offsets, values) triple in one byte range with ``aux = (cap,
# n_offsets, index_dtype)`` (cap = the pow-2 nnz bucket the ids/values
# are padded to).
FeedSlot = collections.namedtuple(
    "FeedSlot", ["name", "dtype", "rows", "sample_shape", "offset",
                 "nbytes", "kind", "aux"],
    defaults=("dense", None))

# A ragged sparse feed: CSR-style ids [nnz] / offsets [batch+1] /
# values [nnz]. As a feed-dict value under key ``name`` it packs as ONE
# slot of the single-copy wire and unpacks as the three feeds ``name``,
# ``name@offsets``, ``name@values``.
SparseTriple = collections.namedtuple(
    "SparseTriple", ["ids", "offsets", "values"])

# nnz bucket floor for sparse slots: pad to the next power of two, at
# least this, so the packed layout is closed.
_SPARSE_MIN_CAP = 64


def _sparse_cap(nnz):
    cap = _SPARSE_MIN_CAP
    while cap < nnz:
        cap *= 2
    return cap


def _pad_tail(arr, cap):
    if arr.shape[0] == cap:
        return arr
    out = np.zeros((cap,) + arr.shape[1:], arr.dtype)
    out[:arr.shape[0]] = arr
    return out


def _canon_triple(v):
    """Canonicalize a SparseTriple for the wire: ids/offsets in the
    index wire width, 1-D; values in their own canon dtype."""
    ids = _canon_array(v.ids).reshape(-1)
    offs = _canon_array(v.offsets).reshape(-1)
    vals = _canon_array(v.values).reshape(-1)
    if ids.shape[0] != vals.shape[0]:
        raise ValueError("sparse triple ids/values length mismatch "
                         "(%d vs %d)" % (ids.shape[0], vals.shape[0]))
    return ids, offs, vals


def explode_sparse(feed):
    """Replace each SparseTriple value with its three named arrays
    (ids padded to the pow-2 cap, so the per-array path sees the same
    closed shape set as the packed wire). Feeds without triples pass
    through as they are."""
    if not any(isinstance(v, SparseTriple) for v in feed.values()):
        return feed
    out = {}
    for name, v in feed.items():
        if isinstance(v, SparseTriple):
            ids, offs, vals = _canon_triple(v)
            cap = _sparse_cap(ids.shape[0])
            out[name] = _pad_tail(ids, cap)
            out[name + "@offsets"] = offs
            out[name + "@values"] = _pad_tail(vals, cap)
        else:
            out[name] = v
    return out


class PackedBatch:
    """One batch as a single (shards, shard_nbytes) uint8 buffer.

    ``buffer`` starts as a host array (numpy, or a view of a staging
    block) and is replaced by the staged device tensor once copied;
    ``event`` is the CUDA event recorded on the staging stream after
    that copy (None on the CPU), which the executor's stream waits on
    before the step reads the buffer; ``transfer_done`` is set by the
    staging thread once the copy completed, which is what makes
    recycling the staging block safe. The executor consumes a device
    buffer: it drops it once unpacked (the reference donates it), and a
    second run of the same batch raises."""

    __slots__ = ("buffer", "layout", "shards", "shard_nbytes",
                 "batch_size", "transfer_done", "event")

    def __init__(self, buffer, layout, shards, shard_nbytes, batch_size):
        self.buffer = buffer
        self.layout = layout
        self.shards = shards
        self.shard_nbytes = shard_nbytes
        self.batch_size = batch_size
        self.transfer_done = False
        self.event = None

    def signature(self):
        """Hashable layout key."""
        return (self.layout, self.shards, self.shard_nbytes)

    @property
    def nbytes(self):
        return self.shards * self.shard_nbytes


def _canon_array(value):
    """Host-canonicalize one feed array for the wire: the 64-bit
    demotion (int64 -> int32 etc., ``framework.convert_dtype``) applied
    BEFORE the copy, so ids and labels cross at 4 bytes instead of 8."""
    arr = np.asarray(value)
    dt = convert_dtype(arr.dtype)
    if np.dtype(dt) != arr.dtype:
        arr = arr.astype(dt)
    return np.ascontiguousarray(arr)


def _align(n):
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def plan_layout(feed, shards=1):
    """(arrays, layout, shard_nbytes, batch) for a packable feed dict,
    or None when the batch can't be packed (the caller takes the
    per-array path): empty arrays, mismatched leading dims, a batch
    the shard count doesn't divide, or a sparse triple under more than
    one shard."""
    if not feed:
        return None
    arrays, batch = {}, None
    for name in sorted(feed):
        value = feed[name]
        if isinstance(value, SparseTriple):
            if shards != 1:
                return None
            ids, offs, vals = _canon_triple(value)
            if offs.shape[0] < 2:
                return None
            b = offs.shape[0] - 1
            if batch is None:
                batch = b
            elif b != batch:
                return None
            arrays[name] = (ids, offs, vals)
            continue
        arr = _canon_array(value)
        if arr.ndim == 0 or arr.nbytes == 0:
            return None
        if batch is None:
            batch = arr.shape[0]
        elif arr.shape[0] != batch:
            return None
        arrays[name] = arr
    if not batch or batch % shards:
        return None
    rows = batch // shards
    layout, off = [], 0
    for name, arr in arrays.items():
        if isinstance(arr, tuple):
            ids, offs, vals = arr
            cap = _sparse_cap(ids.shape[0])
            nb = (offs.nbytes + cap * ids.itemsize
                  + cap * vals.itemsize)
            layout.append(FeedSlot(
                name, np.dtype(vals.dtype).name, batch, (), off, nb,
                kind="sparse",
                aux=(cap, offs.shape[0], np.dtype(ids.dtype).name)))
            off = _align(off + nb)
            continue
        if arr.nbytes % shards:
            return None
        nb = arr.nbytes // shards
        layout.append(FeedSlot(name, np.dtype(arr.dtype).name, rows,
                               tuple(arr.shape[1:]), off, nb))
        off = _align(off + nb)
    return arrays, tuple(layout), _align(off), batch


def pack_feed(feed, shards=1, alloc=None):
    """Pack ``feed`` into one host block; returns (PackedBatch, handle)
    or None. ``alloc(nbytes) -> (uint8 view, handle) | (None, None)``
    supplies staging memory (the arena); numpy otherwise."""
    plan = plan_layout(feed, shards)
    if plan is None:
        return None
    arrays, layout, shard_nbytes, batch = plan
    total = shards * shard_nbytes
    buf, handle = (None, None)
    if alloc is not None:
        buf, handle = alloc(total)
    if buf is None:
        buf, handle = np.empty(total, np.uint8), None
    buf2d = buf.reshape(shards, shard_nbytes)
    rows = batch // shards
    for slot in layout:
        arr = arrays[slot.name]
        if slot.kind == "sparse":  # shards == 1 (plan enforces)
            ids, offs, vals = arr
            cap = slot.aux[0]
            seg = buf2d[0, slot.offset:slot.offset + slot.nbytes]
            o_nb = offs.nbytes
            i_nb = cap * ids.itemsize
            seg[:o_nb].view(offs.dtype)[:] = offs
            seg[o_nb:o_nb + i_nb].view(ids.dtype)[:] = \
                _pad_tail(ids, cap)
            seg[o_nb + i_nb:o_nb + i_nb + cap * vals.itemsize] \
                .view(vals.dtype)[:] = _pad_tail(vals, cap)
            continue
        for s in range(shards):
            dst = buf2d[s, slot.offset:slot.offset + slot.nbytes] \
                .view(arr.dtype).reshape((rows,) + slot.sample_shape)
            np.copyto(dst, arr[s * rows:(s + 1) * rows])
    return PackedBatch(buf2d, layout, shards, shard_nbytes, batch), handle


def _view(seg, dt):
    """A 1-D uint8 (or [shards, n] uint8) tensor seen as ``dt``: the
    bytes reinterpreted, no copy (the reference's
    ``bitcast_convert_type``; both little-endian)."""
    td = torch_dtype(dt)
    return seg if td == torch.uint8 else seg.view(td)


def unpack(buf, layout):
    """Inverse of ``pack_feed`` on a (shards, shard_nbytes) uint8
    tensor: each slot sliced out of the buffer and viewed as its wire
    dtype, {name: tensor} on the buffer's device. Dense slots of one
    shard and every sparse part are views of the buffer; several shards
    are gathered into one batch (a copy)."""
    if isinstance(buf, np.ndarray):
        buf = torch.from_numpy(buf)
    shards = buf.shape[0]
    out = {}
    for slot in layout:
        seg = buf[:, slot.offset:slot.offset + slot.nbytes]
        if slot.kind == "sparse":
            cap, n_off, idt_name = slot.aux
            isz = np.dtype(convert_dtype(idt_name)).itemsize
            flat = seg.reshape(-1)  # shards == 1 on the sparse wire
            o_nb, i_nb = n_off * isz, cap * isz
            vsz = np.dtype(convert_dtype(slot.dtype)).itemsize
            out[slot.name + "@offsets"] = _view(flat[:o_nb], idt_name)
            out[slot.name] = _view(flat[o_nb:o_nb + i_nb], idt_name)
            out[slot.name + "@values"] = _view(
                flat[o_nb + i_nb:o_nb + i_nb + cap * vsz], slot.dtype)
            continue
        out[slot.name] = _view(seg, slot.dtype).reshape(
            (shards * slot.rows,) + tuple(slot.sample_shape))
    return out


def canon_norm(v):
    """Hashable form of a scale/mean/std attr."""
    if v is None:
        return None
    arr = np.asarray(v, np.float32)
    if arr.ndim == 0:
        return float(arr)
    return tuple(float(x) for x in arr.reshape(-1))


# the vector normalize attrs on their devices, made once:
# {(values, dtype, device): tensor}
_ATTRS = {}


def widen(x, target_dtype, scale=None, mean=None, std=None):
    """The ingest prologue for one feed on its device: cast the wire
    tensor to the model dtype, then the normalize chain ``(x * scale -
    mean) / std`` (each stage optional), each stage one rounding in the
    model dtype, as the reference's ``widen`` computes it. A length-C
    vector attr broadcasts over the channel axis (axis 1 of NCHW);
    scalars broadcast everywhere."""
    td = torch_dtype(target_dtype)
    x = x.to(td)

    def _b(v):
        v = canon_norm(v)
        if not isinstance(v, tuple):
            # a float32 value as a Python scalar: the op rounds once in
            # the tensor's dtype, and no copy to the card is made
            return v
        key = (v, td, x.device)
        t = _ATTRS.get(key)
        if t is None:
            t = _ATTRS[key] = torch.tensor(v, dtype=torch.float32) \
                .to(td).to(x.device)
        if t.ndim == 1 and x.ndim >= 2 and t.shape[0] == x.shape[1]:
            return t.reshape((1, -1) + (1,) * (x.ndim - 2))
        return t

    if scale is not None:
        x = x * _b(scale)
    if mean is not None:
        x = x - _b(mean)
    if std is not None:
        x = x / _b(std)
    return x
