"""The port's input pipeline against the reference's, on the CPU: the
reader decorators (``paddle_tpu_torch/reader``), ``DataFeeder``, the
staging arena's buddy bookkeeping (against ``native/buddy_allocator.cc``
as the reference loads it), ``StagedReader`` on ``device="cpu"`` (the
batches in order, one copy counted per packed batch, the recycle lag,
shutdown mid-pass and on an exception, the metric families), its
refusal to run on a CUDA device without a pinned arena (through a stub:
this box has no card), and ``poison_feed`` of a packed batch.
"""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import data_feeder as ref_df
from paddle_tpu import reader as ref_reader
from paddle_tpu.core import ingest as ref_ingest
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu.reader import staging as ref_staging  # noqa: F401
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import data_feeder as port_df
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import reader as port_reader
from paddle_tpu_torch import core as pc
from paddle_tpu_torch.core import ingest
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.reader import staging
from paddle_tpu_torch.reader.staging import StagedReader
from paddle_tpu_torch.resilience import faults

STAGING_FAMILIES = sorted(
    "paddle_staging_%s" % n for n in (
        "queue_depth", "batches_total", "stage_seconds",
        "arena_in_use_bytes", "arena_peak_bytes", "wire_bytes_total",
        "legacy_bytes_total", "h2d_transfers_total", "sparse_slots_total"))


@pytest.fixture(autouse=True)
def _restore():
    yield
    faults.disarm()
    ref_faults.disarm()
    port_config.set_flags(packed_feeds=False, telemetry=False)
    ptpu.config.set_flags(packed_feeds=False, telemetry=False)


def _samples(n=23):
    return lambda: iter([(i, i * 0.5) for i in range(n)])


def _drain(make, *args, **kw):
    return list(make(*args, **kw)())


@pytest.mark.parametrize("name,args,kw", [
    ("shuffle", (_samples(), 5), dict(seed=3)),
    ("shuffle", (_samples(), 100), dict(seed=9)),
    ("buffered", (_samples(), 4), {}),
    ("chain", (_samples(3), _samples(4)), {}),
    ("compose", (_samples(5), _samples(5)), {}),
    ("map_readers", (lambda a, b: (a[0] + b[0],), _samples(6),
                     _samples(6)), {}),
    ("batch", (_samples(), 4), {}),
    ("batch", (_samples(), 4), dict(drop_last=False)),
    ("xmap_readers", (lambda s: (s[0] * 2,), _samples(), 3, 4),
     dict(order=True)),
    ("firstn", (_samples(), 7), {}),
    ("cache", (_samples(),), {}),
])
def test_reader_decorators_equal_the_reference(name, args, kw):
    got = _drain(getattr(port_reader, name), *args, **kw)
    want = _drain(getattr(ref_reader, name), *args, **kw)
    assert got == want and got


def test_unordered_xmap_and_errors_as_the_reference():
    got = _drain(port_reader.xmap_readers, lambda s: s[0], _samples(), 3, 4)
    assert sorted(got) == list(range(23))
    with pytest.raises(RuntimeError, match="different lengths"):
        _drain(port_reader.compose, _samples(3), _samples(4))

    def broken():
        yield 1
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        _drain(port_reader.buffered, broken, 2)
    cached = port_reader.cache(_samples(3))
    assert list(cached()) == list(cached()) == list(_samples(3)())


def _feeder_cases(pkg, layers, fw):
    main = fw.Program()
    with fw.program_guard(main, fw.Program()):
        img = layers.data("img", shape=[2, 3], wire_dtype="uint8")
        lbl = layers.data("lbl", shape=[1], dtype="int64")
        x = layers.data("x", shape=[4])
        seq = layers.data("seq", shape=[3])
    rs = np.random.RandomState(4)
    batch = [(rs.randint(0, 256, (2, 3)), int(rs.randint(0, 9)),
              rs.randn(4).astype(np.float32),
              rs.randn(int(rs.randint(1, 6)), 3).astype(np.float32),
              [(int(rs.randint(0, 50)), float(rs.randn()))
               for _ in range(int(rs.randint(1, 4)))],
              [[1, 2], [3], [4, 5, 6]][:int(rs.randint(1, 4))],
              [[(1, 0.5)], [(2, 1.0), (3, 2.0)]])
             for _ in range(5)]
    feeder = pkg.DataFeeder(
        [img, lbl, x, (seq, "seq_len"),
         {"kind": "sparse", "name": "sp_ids", "values": "sp_vals",
          "depth": 0},
         {"kind": "nested", "name": "nest", "len": "nest_len",
          "sublen": "nest_sub"},
         {"kind": "sparse", "name": "sq_ids", "values": "sq_vals",
          "depth": 1, "len": "sq_len"}],
        seq_buckets=(4, 8))
    return feeder.feed(batch)


def test_data_feeder_equals_the_reference():
    got = _feeder_cases(port_df, port_layers, pc)
    want = _feeder_cases(ref_df, ptpu.layers, ptpu)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name])
    assert got["img"].dtype == np.uint8      # the wire dtype
    assert got["lbl"].dtype == np.int32      # int64 demoted
    assert got["seq"].shape[1] == 8          # bucketed


def test_pad_batch_and_buckets_equal_the_reference():
    seqs = [np.arange(n).reshape(n, 1) for n in (3, 1, 5)]
    for kw in ({}, dict(maxlen=4), dict(pad_value=-1, dtype="float32")):
        got = port_df.pad_batch(seqs, **kw)
        want = ref_df.pad_batch(seqs, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for n in (1, 4, 5, 100):
        assert port_df.bucket_batch_by_length(n, (4, 16)) == \
            ref_df.bucket_batch_by_length(n, (4, 16))


def _native_arena():
    try:
        from paddle_tpu import native
        return native.arena_lib()
    except Exception:
        return None


def test_arena_bookkeeping_equals_the_native_buddy_allocator():
    import ctypes
    lib = _native_arena()
    if lib is None:
        pytest.skip("the reference's native arena did not build here")
    cap = 1 << 16
    handle = lib.ptarena_create(ctypes.c_size_t(cap))
    arena = staging._Arena(cap, pin=False)
    rs = np.random.RandomState(0)
    live, base = [], None
    try:
        for _ in range(200):
            if live and rs.rand() < 0.45:
                ptr, off = live.pop(int(rs.randint(len(live))))
                assert lib.ptarena_free(handle, ctypes.c_void_p(ptr)) == 0
                arena.free(off)
            else:
                n = int(rs.randint(1, 5000))
                ptr = lib.ptarena_alloc(handle, ctypes.c_size_t(n))
                arr, off = arena.alloc_array((n,), np.uint8, n)
                assert (ptr is None or ptr == 0) == (arr is None)
                if arr is None:
                    continue
                base = ptr - off if base is None else base
                assert ptr - base == off and off % 64 == 0
                live.append((ptr, off))
            assert lib.ptarena_in_use(handle) == arena.in_use()
            assert lib.ptarena_peak(handle) == arena.peak()
        for ptr, off in live:
            lib.ptarena_free(handle, ctypes.c_void_p(ptr))
            arena.free(off)
        assert arena.in_use() == 0
        # everything merged back: the whole block is one buddy again
        assert arena.alloc_array((cap,), np.uint8, cap)[1] == 0
    finally:
        lib.ptarena_destroy(handle)


def _feed_reader(n, batch=4, seed=0, log=None):
    def reader():
        rs = np.random.RandomState(seed)
        for i in range(n):
            if log is not None:
                log.append(i)
            yield {"x": rs.randn(batch, 3).astype("float32"),
                   "img": rs.randint(0, 256, (batch, 2, 2)).astype("uint8"),
                   "y": rs.randint(0, 9, (batch, 1)).astype("int64")}
    return reader


def _unpacked(feed):
    if isinstance(feed, ingest.PackedBatch):
        return {k: v.numpy() for k, v in
                ingest.unpack(feed.buffer, feed.layout).items()}
    return {k: np.asarray(v) for k, v in feed.items()}


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("free_lag", [0, 2])
def test_staged_batches_arrive_in_order_and_intact(pack, free_lag):
    src = list(_feed_reader(7)())
    sr = StagedReader(_feed_reader(7), depth=2, capacity_mb=1,
                      free_lag=free_lag, pack=pack, device="cpu")
    assert sr.arena_active and not sr._arena.pinned
    got = []
    for feed in sr():
        assert isinstance(feed, ingest.PackedBatch) == pack
        got.append(_unpacked(feed))   # read before the block recycles
    stats = sr.stats()
    sr.close()
    assert len(got) == 7 and stats["staged_batches"] == 7
    assert stats["packed_batches"] == (7 if pack else 0)
    assert stats["arena_in_use_bytes"] == 0 and stats["arena_peak_bytes"] > 0
    for g, w in zip(got, src):
        for name in w:
            want = w[name].astype(np.int32) if pack and name == "y" \
                else w[name]
            np.testing.assert_array_equal(g[name], want)
    assert sr._arena is None and not sr.arena_active


def test_one_copy_per_packed_batch_and_the_wire_counters():
    port_config.set_flags(packed_feeds=True, telemetry=True)
    t0 = staging._TRANSFERS.value
    w0 = staging._WIRE_BYTES.value
    l0 = staging._LEGACY_BYTES.value
    b0 = staging._STAGED_TOTAL.value
    main = pc.Program()
    with pc.program_guard(main, pc.Program()):
        port_layers.data("img", shape=[2, 2], wire_dtype="uint8")
    sr = StagedReader(_feed_reader(5), depth=2, program=main, device="cpu")
    feeds = list(sr())
    sr.close()
    assert all(isinstance(f, ingest.PackedBatch) and f.transfer_done
               for f in feeds)
    assert staging._TRANSFERS.value - t0 == 5
    assert staging._STAGED_TOTAL.value - b0 == 5
    assert staging._WIRE_BYTES.value - w0 == sum(f.nbytes for f in feeds)
    # uint8 images counted at f32 width, int64 labels at int64
    per = 4 * 3 * 4 + 4 * 2 * 2 * 4 + 4 * 8
    assert staging._LEGACY_BYTES.value - l0 == 5 * per
    assert all(isinstance(f.buffer, torch.Tensor) for f in feeds)


def test_per_array_staging_when_flag_off_and_for_ragged_batches():
    sr = StagedReader(_feed_reader(3), depth=2, device="cpu")
    assert not sr.packing_enabled()
    feeds = list(sr())
    sr.close()
    assert all(isinstance(f, dict) for f in feeds)
    assert all(isinstance(v, torch.Tensor) for f in feeds
               for v in f.values())

    def ragged():
        rs = np.random.RandomState(0)
        yield {"x": rs.randn(4, 3).astype("float32"),
               "y": rs.randn(5, 1).astype("float32")}

    sr = StagedReader(ragged, depth=1, pack=True, device="cpu")
    feeds = list(sr())
    sr.close()
    assert len(feeds) == 1 and isinstance(feeds[0], dict)
    assert sr.packed_batches == 0
    # without device_put: no arena, plain numpy staging
    sr = StagedReader(_feed_reader(2), device_put=False, device="cpu")
    assert not sr.arena_active
    feeds = list(sr())
    sr.close()
    assert all(isinstance(v, np.ndarray) for v in feeds[0].values())


def test_the_recycle_lag_holds_free_lag_blocks_behind():
    sr = StagedReader(_feed_reader(6), depth=1, capacity_mb=1, free_lag=2,
                      pack=True, device="cpu")
    in_use = []
    for _ in sr():
        in_use.append(sr._arena.in_use())
    sr.close()
    # the consumer holds the free_lag + 1 newest batches' blocks, the
    # filler at most depth + 1 more
    block = 1 << staging._order_for(
        ingest.pack_feed(next(_feed_reader(1)()))[0].nbytes)
    assert max(in_use) <= 5 * block and min(in_use[2:]) >= 3 * block


def _live_fill_threads():
    return [t for t in threading.enumerate()
            if t.is_alive() and getattr(t, "_target", None) is not None
            and getattr(t._target, "__name__", "") == "_fill"]


def test_shutdown_mid_pass_and_on_an_exception():
    log = []

    def slow():
        for b in _feed_reader(50, log=log)():
            time.sleep(0.002)
            yield b

    sr = StagedReader(slow, depth=2, capacity_mb=1, pack=True,
                      device="cpu")
    gen = sr()
    next(gen)
    gen.close()          # the Trainer.train finally path
    assert sr._active is None and not _live_fill_threads()
    assert sr._arena.in_use() == 0
    sr.close()
    assert len(log) < 50

    def failing():
        yield from _feed_reader(2)()
        raise ValueError("reader broke")

    sr = StagedReader(failing, depth=2, pack=True, device="cpu")
    with pytest.raises(ValueError, match="reader broke"):
        for _ in sr():
            pass
    assert sr._active is None and not _live_fill_threads()
    sr.close()
    # abandoned without closing the generator: close() stops the filler
    sr = StagedReader(slow, depth=1, pack=True, device="cpu")
    gen = sr()
    next(gen)
    sr.close()
    assert sr._active is None and not _live_fill_threads()


def test_staging_families_equal_the_reference():
    ours = metrics.REGISTRY.families()
    theirs = ref_metrics.REGISTRY.families()
    mine = sorted(n for n in ours if n.startswith("paddle_staging_"))
    assert mine == STAGING_FAMILIES
    for name in mine:
        assert (ours[name].kind, ours[name].help, ours[name].labelnames) \
            == (theirs[name].kind, theirs[name].help,
                theirs[name].labelnames), name


class _UnpinnedArena:
    pinned = False

    def __init__(self, capacity, pin):
        assert pin  # a CUDA device asks for page-locked memory


def test_a_cuda_reader_without_a_pinned_arena_raises(monkeypatch):
    monkeypatch.setattr(staging, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(staging, "_Arena", _UnpinnedArena)
    with pytest.raises(RuntimeError, match="needs a pinned staging arena"):
        StagedReader(_feed_reader(1))

    def no_arena(capacity, pin):
        raise MemoryError("no page-locked memory")

    monkeypatch.setattr(staging, "_Arena", no_arena)
    with pytest.raises(RuntimeError, match="needs a pinned staging arena"):
        StagedReader(_feed_reader(1))


def test_a_strategy_is_refused():
    with pytest.raises(NotImplementedError, match="Distribution"):
        StagedReader(_feed_reader(1), strategy=object(), device="cpu")


def test_poison_feed_of_a_packed_batch_equals_the_reference():
    feed = {"x": np.ones((4, 3), np.float32),
            "ids": np.arange(8, dtype=np.int32).reshape(4, 2),
            "z": np.ones((4, 2), np.float32)}
    out = []
    for mod, pack in ((faults, ingest.pack_feed),
                      (ref_faults, ref_ingest.pack_feed)):
        # from zeros: the padding between slots compares too
        pb = pack(feed, alloc=lambda n: (np.zeros(n, np.uint8), None))[0]
        mod.arm("nan_loss", at=2)
        assert mod.poison_feed(pb, 1) is pb
        out.append(mod.poison_feed(pb, 2))
        mod.disarm()
        assert out[-1] is not pb and out[-1].transfer_done
    got, want = out
    assert got.buffer.numpy().tobytes() == \
        np.asarray(want.buffer).tobytes()
    vals = ingest.unpack(got.buffer, got.layout)
    assert torch.isnan(vals["x"]).all() and not torch.isnan(vals["z"]).any()
    # a batch without a float slot passes through
    pb = ingest.pack_feed({"ids": feed["ids"]})[0]
    faults.arm("nan_loss", at=0)
    assert faults.poison_feed(pb, 0) is pb
