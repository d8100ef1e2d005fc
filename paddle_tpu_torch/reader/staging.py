"""Arena-staged input pipeline: host batch assembly -> card, overlapped
(reference ``paddle_tpu/reader/staging.py``).

The analog of the reference's async double-buffer DataProvider
(``paddle/gserver/dataproviders/DataProvider.h:375``) and its pinned
staging buffers (``paddle/memory/memory.cc`` pinned path): a background
thread

1. pulls batches from the reader (through an optional ``DataFeeder``),
2. copies each array (or, with ``packed_feeds``, the whole batch packed
   into one block, ``core/ingest.py``) into a 64-byte-aligned block of
   the staging arena: one page-locked host tensor, registered once per
   arena, carved by buddy bookkeeping (``_Arena``),
3. issues the host-to-device copy from that block on a CUDA stream of
   its own (``copy_(..., non_blocking=True)``), records an event after
   it and waits for the event before it queues the batch (the
   reference's ``block_until_ready`` on the staging thread),

so host batch assembly and the copies overlap the step the consumer is
running. The consumer's stream waits on the event before the step reads
the batch, and each staged tensor is marked as used by that stream
(``record_stream``), so the caching allocator does not hand its memory
to a later batch while the step still reads it. Arena blocks are
recycled ``free_lag`` batches behind the consumer, and only after their
copy's event completed. With ``device_put=False`` the arena is not used
at all: the consumer would hold live views into arena memory, so plain
(background-threaded) numpy copies are the staging path.

On a CUDA device a staging arena that cannot be made, or whose block is
not page-locked (a copy from pageable memory is not asynchronous), is an
error, and so is an arena too small for a batch. On the CPU the
reference's fallbacks are kept: plain numpy staging when the arena
cannot be made or is exhausted; ``arena_active`` reports which path is
in use.
"""

import collections
import itertools
import queue as _queue
import threading
import time

import numpy as np
import torch

from .. import config as _config
from ..core import ingest as _ingest
from ..core.framework import convert_dtype
from ..observability import metrics as _metrics
from ..observability import tracing as _tracing
from ..place import resolve_device

__all__ = ["StagedReader"]

_END = object()

# Input-pipeline telemetry (recording gated by the "telemetry" flag),
# under the reference's names and help text. Gauges are labeled per
# reader instance so concurrent StagedReaders don't clobber each other;
# the counters and the histogram are additive and global.
_QUEUE_DEPTH = _metrics.REGISTRY.gauge(
    "paddle_staging_queue_depth",
    "Staged batches queued ahead of the consumer, per reader",
    labelnames=("reader",))
_STAGED_TOTAL = _metrics.REGISTRY.counter(
    "paddle_staging_batches_total", "Batches staged (all readers)")
_STAGE_SECONDS = _metrics.REGISTRY.histogram(
    "paddle_staging_stage_seconds",
    "Per-batch staging time: reader pull + feeder + arena copy + "
    "device_put dispatch")
_ARENA_IN_USE = _metrics.REGISTRY.gauge(
    "paddle_staging_arena_in_use_bytes",
    "Buddy-arena bytes currently allocated to in-flight batches, "
    "per reader",
    labelnames=("reader",))
_ARENA_PEAK = _metrics.REGISTRY.gauge(
    "paddle_staging_arena_peak_bytes",
    "Buddy-arena high-water mark, per reader",
    labelnames=("reader",))
# Narrow-wire accounting: what actually crossed host to device vs what
# the legacy widened path would have moved, and how many copies it took.
_WIRE_BYTES = _metrics.REGISTRY.counter(
    "paddle_staging_wire_bytes_total",
    "Bytes actually transferred host->device by staging")
_LEGACY_BYTES = _metrics.REGISTRY.counter(
    "paddle_staging_legacy_bytes_total",
    "Bytes the pre-wire path (widened dtypes, per-array device_put) "
    "would have transferred for the same batches")
_TRANSFERS = _metrics.REGISTRY.counter(
    "paddle_staging_h2d_transfers_total",
    "device_put dispatches issued by staging (packed path: one per "
    "batch per mesh shard)")
_SPARSE_SLOTS = _metrics.REGISTRY.counter(
    "paddle_staging_sparse_slots_total",
    "Ragged (ids, offsets, values) sparse slots carried on the packed "
    "wire — batches that would otherwise fall back to per-array H2D")
_READER_IDS = itertools.count(1)

# the smallest block: 64 bytes, the slot alignment
_MIN_ORDER = 6


def _order_for(size):
    order = _MIN_ORDER
    while (1 << order) < size:
        order += 1
    return order


class _Arena:
    """A buddy arena over one host tensor of ``capacity_bytes`` rounded
    down to a power of two: page-locked when ``pin`` (allocated once,
    so registered with CUDA once per arena), blocks of 2**k >= 64
    bytes, each 64-byte aligned, split on allocation and merged with
    their buddies when freed; ``in_use`` and ``peak`` count block bytes.
    The bookkeeping is ``native/buddy_allocator.cc``'s, in Python."""

    def __init__(self, capacity_bytes, pin):
        max_order = _order_for(capacity_bytes)
        if (1 << max_order) > capacity_bytes:
            max_order -= 1
        self.block = torch.empty(1 << max_order, dtype=torch.uint8,
                                 pin_memory=pin)
        self.pinned = bool(pin) and self.block.is_pinned()
        self._host = self.block.numpy()
        self._max_order = max_order
        self._free = [set() for _ in range(max_order + 1)]
        self._free[max_order].add(0)
        self._allocated = {}  # offset -> order
        self._lock = threading.Lock()
        self._in_use = 0
        self._peak = 0

    def alloc_array(self, shape, dtype, nbytes):
        """(numpy view of the block, offset), or (None, None) when the
        arena has no free block large enough."""
        want = _order_for(max(int(nbytes), 1))
        with self._lock:
            o = want
            while o <= self._max_order and not self._free[o]:
                o += 1
            if o > self._max_order:
                return None, None
            off = min(self._free[o])
            self._free[o].discard(off)
            while o > want:
                o -= 1
                self._free[o].add(off + (1 << o))  # right buddy freed
            self._allocated[off] = want
            self._in_use += 1 << want
            self._peak = max(self._peak, self._in_use)
        arr = self._host[off:off + nbytes].view(dtype).reshape(shape)
        return arr, off

    def tensor(self, off, nbytes):
        """The block's bytes [off, off + nbytes) as a uint8 tensor (a
        view: page-locked when the arena is)."""
        return self.block[off:off + nbytes]

    def free(self, off):
        with self._lock:
            o = self._allocated.pop(off, None)
            if o is None:
                return
            self._in_use -= 1 << o
            while o < self._max_order:
                buddy = off ^ (1 << o)
                if buddy not in self._free[o]:
                    break
                self._free[o].discard(buddy)
                off = min(off, buddy)
                o += 1
            self._free[o].add(off)

    def in_use(self):
        return self._in_use

    def peak(self):
        return self._peak

    def destroy(self):
        self._host = None
        self.block = None


class StagedReader:
    """Drop-in reader: ``staged()`` yields ready-to-run feeds.

    reader: yields batches (lists of samples if ``feeder`` given, else
    feed dicts of numpy arrays).
    feeder: optional DataFeeder applied on the staging thread.
    depth: queue depth (batches staged ahead of the consumer).
    capacity_mb: arena size. On the CPU a batch set larger than this
    falls back to plain numpy staging for the overflowing arrays; on a
    CUDA device it raises.
    device_put: copy each batch to ``device`` on the staging thread (the
    copy done before the consumer sees the feed).
    pack: pack each batch into ONE contiguous block and issue ONE copy
    (core/ingest.py); the executor unpacks it on the card. None
    (default) follows the ``packed_feeds`` config flag. Unpackable
    batches (ragged leading dims) fall back per batch to the per-array
    path.
    device: where batches are copied to: CUDA when None (which raises
    without a GPU), ``"cpu"`` on the CPU. A CUDA device needs the
    page-locked arena: without it the reader raises.
    strategy: a ``parallel.DistStrategy``: a packed batch is packed in
    ``data_shards()`` rows (each one shard's rows of every slot) and this
    rank copies only its own row to its device, on the reader's stream
    (``DistStrategy.scatter_packed``; a batch packed for another shard
    count that the data axis does not divide is copied whole, which is
    logged once). The per-array path copies whole arrays, whose rows the
    executor takes.
    """

    def __init__(self, reader, feeder=None, depth=2, capacity_mb=256,
                 device_put=True, free_lag=2, pack=None, strategy=None,
                 program=None, device=None):
        self.reader = reader
        self.strategy = strategy
        self.feeder = feeder
        self.depth = max(1, int(depth))
        self.device_put = device_put
        self.free_lag = max(0, int(free_lag))
        self.pack = pack
        self.program = program  # for feed-var dtype lookups (telemetry)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.packed_batches = 0
        # recent (stage_start, stage_end) windows; bounded — only the
        # overlap test and debugging read these
        self.records = collections.deque(maxlen=1024)
        self.staged_batches = 0
        self.arena_active = False
        self._tel_label = "r%d" % next(_READER_IDS)
        self._arena = None
        self._stream = None
        self._active = None    # (thread, stop, queue) of a live fill
        # The arena only serves the device_put path: each block is read
        # once by the copy and recycled after it completed. Without
        # device_put the consumer would hold live views INTO arena
        # memory, making any recycle a silent corruption.
        if device_put:
            cuda = self.device.type == "cuda"
            try:
                self._arena = _Arena(int(capacity_mb) * (1 << 20), pin=cuda)
            except Exception as e:
                if cuda:
                    raise RuntimeError(
                        "StagedReader on %s needs a pinned staging arena "
                        "(a copy from pageable memory is synchronous): "
                        "%r" % (self.device, e)) from e
                self._arena = None
            if cuda and not self._arena.pinned:
                raise RuntimeError(
                    "StagedReader on %s needs a pinned staging arena (a "
                    "copy from pageable memory is synchronous): its "
                    "block is not page-locked" % self.device)
            self.arena_active = self._arena is not None
            if cuda:
                self._stream = torch.cuda.Stream(self.device)

    # -- stats ----------------------------------------------------------
    def stats(self):
        s = {"staged_batches": self.staged_batches,
             "packed_batches": self.packed_batches,
             "arena_active": self.arena_active}
        if self._arena is not None:
            s["arena_peak_bytes"] = self._arena.peak()
            s["arena_in_use_bytes"] = self._arena.in_use()
        return s

    def packing_enabled(self):
        return self.device_put and (
            self.pack if self.pack is not None
            else bool(_config.get_flag("packed_feeds")))

    # -- staging thread --------------------------------------------------
    def _legacy_nbytes(self, name, arr):
        """What the pre-wire path would have moved for this array: the
        wider of its original width and the var's model dtype (a uint8
        wire image would have crossed as f32; an int64 label crossed as
        int64 before the host canon to int32)."""
        nbytes = arr.nbytes
        var = self._feed_var(name)
        if var is not None:
            try:
                tgt = np.dtype(convert_dtype(var.dtype))
                nbytes = max(nbytes, arr.size * tgt.itemsize)
            except TypeError:
                pass  # bf16 target: keep original width
        return nbytes

    def _feed_var(self, name):
        from ..core.framework import Variable
        if self.feeder is not None:
            for kind, var, len_var in self.feeder.feed_specs:
                for v in (var, len_var):
                    if isinstance(v, Variable) and v.name == name:
                        return v
        if self.program is not None:
            return self.program.global_block().var_or_none(name)
        return None

    def _alloc(self, shape, dtype, nbytes):
        """An arena block for ``nbytes``: (numpy view, offset), or (None,
        None) off the arena. An exhausted arena raises on a CUDA
        device."""
        if self._arena is None:
            return None, None
        arr, off = self._arena.alloc_array(shape, dtype, nbytes)
        if arr is None and self._stream is not None:
            raise MemoryError(
                "staging arena of %d bytes exhausted by a %d-byte block: "
                "raise capacity_mb" % (self._arena.block.numel(), nbytes))
        return arr, off

    def _copy(self, off, nbytes):
        """One host-to-device copy of arena bytes [off, off + nbytes):
        a new uint8 tensor on the device. On a CUDA device the copy is
        issued on the reader's stream from the page-locked block."""
        src = self._arena.tensor(off, nbytes)
        dst = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
        dst.copy_(src, non_blocking=self._stream is not None)
        return dst

    def _to_device(self, arr):
        """A host array off the arena (the CPU's fallback) on the
        device."""
        return torch.from_numpy(np.array(arr, copy=True)).to(self.device)

    def _stage_packed(self, feed):
        """Fused single-copy path: one arena block, one copy. Returns
        (PackedBatch, offsets, event) or None to fall back."""
        shards = self.strategy.data_shards() \
            if self.strategy is not None else 1
        packed = _ingest.pack_feed(
            feed, shards=shards,
            alloc=lambda n: self._alloc((n,), np.uint8, n))
        if packed is None:
            return None
        pb, off = packed
        rows, start = pb.buffer, None
        if self.strategy is not None:
            # this rank's rows of the block: one contiguous range of it
            rows, start = self.strategy.scatter_packed(pb.buffer)
        telemetry = _config.get_flag("telemetry")
        if telemetry:
            _LEGACY_BYTES.inc(sum(
                self._legacy_nbytes(n, np.asarray(v))
                for n, v in feed.items()
                if not isinstance(v, _ingest.SparseTriple)))
            n_sparse = sum(1 for s in pb.layout if s.kind == "sparse")
            if n_sparse:
                _SPARSE_SLOTS.inc(n_sparse)
        event = None
        nbytes = rows.shape[0] * pb.shard_nbytes
        if off is not None:
            dst = self._copy(off + (start or 0) * pb.shard_nbytes, nbytes)
            event = self._record()
        else:
            dst = self._to_device(rows.reshape(-1))
        pb.buffer = dst.view(rows.shape[0], pb.shard_nbytes)
        pb.shard_start = start
        pb.event = event
        # the transfer-completion barrier ON the staging thread: the
        # block may be recycled from here on
        self._wait(event)
        pb.transfer_done = True
        if telemetry:
            _WIRE_BYTES.inc(nbytes)
            _TRANSFERS.inc()
        self.packed_batches += 1
        return pb, ([off] if off is not None else []), event

    def _record(self):
        if self._stream is None:
            return None
        event = torch.cuda.Event()
        event.record(self._stream)
        return event

    @staticmethod
    def _wait(event):
        if event is not None:
            event.synchronize()

    def _stage_feed(self, feed):
        """Copy arrays into arena blocks and on to the device; returns
        (staged_feed, offsets, event)."""
        if isinstance(feed, _ingest.PackedBatch):
            return feed, [], None  # reader yielded a pre-packed batch
        if self.packing_enabled():
            out = self._stage_packed(feed)
            if out is not None:
                return out
        # per-array fallback: ragged sparse triples become their three
        # cap-padded named arrays (core/ingest.explode_sparse)
        feed = _ingest.explode_sparse(feed)
        telemetry = _config.get_flag("telemetry")
        staged, offs = {}, []
        for name, value in feed.items():
            arr = np.asarray(value)
            dst, off = (self._alloc(arr.shape, arr.dtype, arr.nbytes)
                        if arr.nbytes > 0 else (None, None))
            if dst is None:
                dst = np.array(arr, copy=True)  # fallback staging
            else:
                np.copyto(dst, arr)
                offs.append(off)
            if self.device_put:
                if off is not None:
                    dst = self._copy(off, arr.nbytes).view(
                        _torch_dtype(arr.dtype)).reshape(arr.shape)
                else:
                    dst = self._to_device(dst)
                if telemetry:
                    _WIRE_BYTES.inc(arr.nbytes)
                    _LEGACY_BYTES.inc(self._legacy_nbytes(name, arr))
                    _TRANSFERS.inc()
            staged[name] = dst
        event = self._record() if self.device_put else None
        self._wait(event)
        return staged, offs, event

    def _fill(self, q, stop):
        try:
            if self._stream is not None:
                # a new thread's current device is device 0 and its
                # current stream the default one: the copies must run on
                # the reader's stream, on the reader's device
                torch.cuda.set_device(self.device)
            it = iter(self.reader())
            while not stop.is_set():
                t0 = time.perf_counter()  # window includes reader pull
                try:
                    batch = next(it)
                except StopIteration:
                    break
                with _tracing.span("stageBatch"):
                    feed = self.feeder.feed(batch) if self.feeder \
                        else batch
                    if self._stream is not None:
                        with torch.cuda.stream(self._stream):
                            item = self._stage_feed(feed)
                    else:
                        item = self._stage_feed(feed)
                t1 = time.perf_counter()
                self.records.append((t0, t1))
                self.staged_batches += 1
                if _config.get_flag("telemetry"):
                    _STAGED_TOTAL.inc()
                    _STAGE_SECONDS.observe(t1 - t0)
                    self._update_gauges(q)
                q.put(item)
        except Exception as e:  # surface in the consumer
            q.put(e)
        finally:
            q.put(_END)

    def _update_gauges(self, q):
        _QUEUE_DEPTH.labels(reader=self._tel_label).set(q.qsize())
        if self._arena is not None:
            _ARENA_IN_USE.labels(reader=self._tel_label).set(
                self._arena.in_use())
            _ARENA_PEAK.labels(reader=self._tel_label).set(
                self._arena.peak())

    def _hand_over(self, staged, event):
        """The consumer's side of a staged dict of device tensors: its
        stream waits on the copies' event, and each tensor is marked as
        used by that stream. A PackedBatch carries its event to the
        executor, which does the same for its buffer."""
        if event is None or isinstance(staged, _ingest.PackedBatch):
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for v in staged.values():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                v.record_stream(stream)

    # -- consumer --------------------------------------------------------
    def __call__(self):
        q = _queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        t = threading.Thread(target=self._fill, args=(q, stop),
                             daemon=True)
        self._active = (t, stop, q)
        t.start()
        pending = collections.deque()  # offsets awaiting recycle
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, Exception):
                    raise item
                staged, offs, event = item
                if _config.get_flag("telemetry"):
                    self._update_gauges(q)
                # recycle arena blocks free_lag batches behind, and only
                # once the batch's own copy has completed (offs is empty
                # when the arena is off)
                pending.append((offs, event))
                while len(pending) > self.free_lag + 1:
                    old_offs, old_event = pending.popleft()
                    self._release(old_offs, old_event)
                self._hand_over(staged, event)
                yield staged
        finally:
            self._shutdown(t, stop, q, pending)

    def _release(self, offs, event):
        if offs:
            self._wait(event)
            for off in offs:
                self._arena.free(off)

    def _shutdown(self, t, stop, q, pending):
        """Stop + JOIN the fill thread, then recycle every arena block.
        The join makes a later close() (arena destroy) safe: no producer
        can be mid-copy into arena memory afterwards, and each copy it
        issued completed before it queued the batch."""
        stop.set()
        # drain so a producer blocked on q.put can observe stop and exit
        while t.is_alive():
            try:
                item = q.get_nowait()
                if isinstance(item, tuple):
                    pending.append((item[1], item[2]))
            except _queue.Empty:
                pass
            t.join(timeout=0.05)
        try:
            while True:
                item = q.get_nowait()
                if isinstance(item, tuple):
                    pending.append((item[1], item[2]))
        except _queue.Empty:
            pass
        self._active = None
        if self._arena is not None:
            for offs, event in pending:
                try:
                    self._release(offs, event)
                except Exception:
                    for off in offs:
                        self._arena.free(off)

    def close(self):
        if self._active is not None:
            # consumer abandoned the generator mid-pass (exception /
            # interrupt): shut the producer down before freeing memory
            t, stop, q = self._active
            self._shutdown(t, stop, q, collections.deque())
        if self._stream is not None:
            # a suspended generator frame may still hold batches in its
            # local pending deque: every copy on the reader's stream
            # finishes before the arena goes
            self._stream.synchronize()
        if self._arena is not None:
            self._arena.destroy()
            self._arena = None
            self.arena_active = False


def _torch_dtype(dt):
    """The torch dtype of a numpy dtype as it is (no 64-bit demotion: the
    per-array path copies arrays in their own width)."""
    return getattr(torch, np.dtype(dt).name)
