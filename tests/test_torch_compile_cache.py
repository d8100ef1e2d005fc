"""The persistent compile cache and the executor's step cache on the CPU:
the port's counterparts of the reference's ``tests/test_deploy.py``
``TestPersistentCompileCache``, ``TestCompileCacheBound``,
``test_poisoned_cache_dir_survives_process_boundary`` and
``TestExecutorPrime``, and the executor's telemetry.

A fresh ``Executor`` in the same process stands in for the process
boundary: its in-memory table is empty, so the cache dir is all that
stands between it and a rebuild (an export). Each run of a forward
program under ``compile_cache_dir`` loads its entry's ExportedProgram
from the dir, or exports and stores it, and executes it; its fetches
are bitwise those of the program run op by op.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu.core import compile_cache as ref_cc
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.core import compile_cache as cc
from paddle_tpu_torch.core import executor as port_exe
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.resilience import faults

FEED = np.random.RandomState(1).randn(4, 6).astype("float32")


@pytest.fixture(autouse=True)
def _cache_flags():
    yield
    port_config.set_flags(compile_cache_dir=None, compile_cache_max_bytes=0,
                          telemetry=False)
    faults.disarm()


def _counter(name):
    return metrics.REGISTRY.counter(name).value


def _build(in_dim=6, out_dim=3):
    main, startup = pc.Program(), pc.Program()
    with pc.unique_name.guard(), pc.program_guard(main, startup):
        x = layers.data("x", shape=[in_dim])
        h = layers.fc(x, 8, act="relu")
        out = layers.fc(h, out_dim, act="softmax")
    return main, startup, out


def _run_once(feed, cache_dir, exports=None):
    """One step by a fresh executor on seed-7 weights: the flag is armed
    around the main program only, so the startup program adds no entry.
    ``exports`` (a list) gains the number of exports the run made."""
    main, startup, out = _build(feed.shape[1])
    exe, scope = pc.Executor(device="cpu"), pc.Scope()
    port_config.set_flags(compile_cache_dir=None)
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(7)
    for n in sorted(scope.var_names()):
        cur = scope.find_var(n)
        scope.set_var(n, torch.from_numpy(
            rs.standard_normal(tuple(cur.shape)).astype(np.float32)))
    port_config.set_flags(compile_cache_dir=cache_dir)
    real, made = port_exe._export, []

    def counting(*a, **k):
        made.append(1)
        return real(*a, **k)
    port_exe._export = counting
    try:
        got, = exe.run(main, feed={"x": feed}, fetch_list=[out],
                       scope=scope)
    finally:
        port_exe._export = real
    if exports is not None:
        exports.append(len(made))
    return got


def _files(cache_dir, suffix):
    return [os.path.join(cache_dir, f) for f in os.listdir(cache_dir)
            if f.startswith("entry_") and f.endswith(suffix)]


class TestPersistentCompileCache:
    def test_store_then_fresh_executor_deserializes(self, tmp_path):
        cache_dir = str(tmp_path / "cc")
        h0, m0 = (_counter("paddle_deploy_cache_hits_total"),
                  _counter("paddle_deploy_cache_misses_total"))
        exports = []
        first = _run_once(FEED, cache_dir, exports)
        assert _counter("paddle_deploy_cache_misses_total") == m0 + 1
        bins = _files(cache_dir, ".bin")
        assert len(bins) == 1      # one entry, with its manifest
        assert os.path.exists(bins[0][:-4] + ".json")
        second = _run_once(FEED, cache_dir, exports)
        assert _counter("paddle_deploy_cache_hits_total") == h0 + 1
        assert exports == [1, 0]   # the fresh executor exported nothing
        np.testing.assert_array_equal(first, second)
        port_config.set_flags(compile_cache_dir=None)
        assert np.array_equal(_run_once(FEED, None), first)

    def test_corrupt_entry_quarantined_and_recompiled(self, tmp_path):
        cache_dir = str(tmp_path / "cc")
        first = _run_once(FEED, cache_dir)
        path = _files(cache_dir, ".bin")[0]
        blob = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(blob[: len(blob) // 2])    # a truncated write
        q0 = _counter("paddle_deploy_cache_quarantined_total")
        exports = []
        np.testing.assert_array_equal(first,
                                      _run_once(FEED, cache_dir, exports))
        assert exports == [1]
        assert _counter("paddle_deploy_cache_quarantined_total") == q0 + 1
        assert any(f.startswith("corrupt_") for f in os.listdir(cache_dir))
        # the rebuild re-published a good entry: the next run hits
        h0 = _counter("paddle_deploy_cache_hits_total")
        _run_once(FEED, cache_dir)
        assert _counter("paddle_deploy_cache_hits_total") == h0 + 1

    def test_torn_manifest_quarantined(self, tmp_path):
        cache_dir = str(tmp_path / "cc")
        first = _run_once(FEED, cache_dir)
        with open(_files(cache_dir, ".json")[0], "w") as f:
            f.write('{"sha256": "tor')            # torn mid-write
        q0 = _counter("paddle_deploy_cache_quarantined_total")
        np.testing.assert_array_equal(first, _run_once(FEED, cache_dir))
        assert _counter("paddle_deploy_cache_quarantined_total") == q0 + 1

    def test_env_skew_is_miss_not_quarantine(self, tmp_path):
        cache_dir = str(tmp_path / "cc")
        _run_once(FEED, cache_dir)
        meta_path = _files(cache_dir, ".json")[0]
        meta = json.load(open(meta_path))
        meta["env"]["torch"] = "0.0.0-somebody-elses"
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        q0 = _counter("paddle_deploy_cache_quarantined_total")
        h0 = _counter("paddle_deploy_cache_hits_total")
        _run_once(FEED, cache_dir)
        # skew: no hit, no quarantine; the entry stays for its writer
        assert _counter("paddle_deploy_cache_hits_total") == h0
        assert _counter("paddle_deploy_cache_quarantined_total") == q0
        assert os.path.exists(meta_path)

    def test_cache_corrupt_fault_site(self, tmp_path):
        cache_dir = str(tmp_path / "cc")
        first = _run_once(FEED, cache_dir)
        faults.arm("cache_corrupt")
        q0 = _counter("paddle_deploy_cache_quarantined_total")
        np.testing.assert_array_equal(first, _run_once(FEED, cache_dir))
        assert _counter("paddle_deploy_cache_quarantined_total") == q0 + 1

    def test_flag_off_means_no_disk_access(self, tmp_path, monkeypatch):
        def refuse(*a, **k):
            raise AssertionError("the compile cache touched the disk")
        monkeypatch.setattr(cc.PersistentCompileCache, "load", refuse)
        monkeypatch.setattr(cc.PersistentCompileCache, "store", refuse)
        _run_once(FEED, None)
        assert cc.active_cache() is None
        assert not os.listdir(str(tmp_path))

    def test_different_shape_is_different_entry(self, tmp_path):
        cache_dir = str(tmp_path / "cc")
        _run_once(np.zeros((4, 6), "float32"), cache_dir)
        _run_once(np.zeros((8, 6), "float32"), cache_dir)
        assert len(_files(cache_dir, ".bin")) == 2

    def test_the_environment_covers_the_kernels_and_numerics(self):
        env = cc.env_fingerprint(torch.device("cpu"))
        assert env["runtime"] == "torch" and env["platform"] == "cpu"
        assert env["torch"] == torch.__version__
        assert len(env["kernels"]) == 64
        assert set(env) >= {"cuda", "device_kind", "capability",
                            "n_devices", "tf32", "deterministic"}
        # the names follow the reference's manifest
        assert {"platform", "device_kind", "n_devices"} <= \
            set(ref_cc.env_fingerprint())

    def test_a_training_program_stores_nothing(self, tmp_path):
        cache_dir = str(tmp_path / "cc")
        main, startup, out = _build()
        with pc.program_guard(main, startup):
            label = layers.data("label", shape=[1], dtype="int64")
            loss = layers.mean(layers.softmax_with_cross_entropy(out,
                                                                 label))
            port_opt.SGD(0.1).minimize(loss, startup)
        exe, scope = pc.Executor(device="cpu"), pc.Scope()
        exe.run(startup, scope=scope)
        port_config.set_flags(compile_cache_dir=cache_dir)
        feed = {"x": FEED, "label": np.array([[0], [1], [2], [0]])}
        losses = [exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0] for _ in range(2)]
        assert losses[1] < losses[0]
        assert not os.path.exists(cache_dir) or \
            not _files(cache_dir, ".bin")


class TestCompileCacheBound:
    """``compile_cache_max_bytes``: mtime-LRU eviction on the store path.
    Serialization is stubbed to raw bytes so entry sizes (and so the
    eviction order) are exact; load() runs the real verify path."""

    def _prep(self, monkeypatch):
        monkeypatch.setattr(cc, "serialize_compiled", lambda b: b)
        monkeypatch.setattr(cc, "deserialize_compiled", lambda b: b)

    def _digests(self, cache_dir):
        return {f[len("entry_"):-len(".bin")]
                for f in os.listdir(cache_dir) if f.endswith(".bin")}

    def test_capped_dir_keeps_hottest_entries(self, tmp_path, monkeypatch):
        self._prep(monkeypatch)
        cache_dir = str(tmp_path / "cc")
        blob = b"x" * 1000
        # a cap of about two entries (blob + a ~600-byte manifest each)
        cache = cc.PersistentCompileCache(cache_dir, max_bytes=3400)
        now = time.time()
        for i, age in ((1, 300), (2, 200)):
            assert cache.store("d%d" % i, blob)
            for p in (cache._bin("d%d" % i), cache._meta("d%d" % i)):
                os.utime(p, (now - age, now - age))
        # a hit touches d1's mtime: the least recently used is now d2
        assert cache.load("d1") == blob
        e0 = _counter("paddle_deploy_cache_evictions_total")
        assert cache.store("d3", blob)
        assert self._digests(cache_dir) == {"d1", "d3"}
        assert _counter("paddle_deploy_cache_evictions_total") == e0 + 1
        # manifests went with their blobs: no orphan halves
        assert not os.path.exists(cache._meta("d2"))

    def test_never_evicts_the_entry_just_published(self, tmp_path,
                                                   monkeypatch):
        self._prep(monkeypatch)
        cache_dir = str(tmp_path / "cc")
        cache = cc.PersistentCompileCache(cache_dir, max_bytes=10)
        assert cache.store("a", b"y" * 500)
        assert cache.store("b", b"y" * 500)
        assert self._digests(cache_dir) == {"b"}
        assert cache.load("b") == b"y" * 500

    def test_unbounded_by_default(self, tmp_path, monkeypatch):
        self._prep(monkeypatch)
        assert port_config.get_flag("compile_cache_max_bytes") == 0
        cache_dir = str(tmp_path / "cc")
        cache = cc.PersistentCompileCache(cache_dir)
        e0 = _counter("paddle_deploy_cache_evictions_total")
        for i in range(4):
            assert cache.store("u%d" % i, b"z" * 2000)
        assert len(self._digests(cache_dir)) == 4
        assert _counter("paddle_deploy_cache_evictions_total") == e0

    def test_active_cache_refreshes_cap_from_flag(self, tmp_path):
        port_config.set_flags(compile_cache_dir=str(tmp_path / "cc"),
                              compile_cache_max_bytes=12345)
        assert cc.active_cache().max_bytes == 12345
        port_config.set_flags(compile_cache_max_bytes=0)
        assert cc.active_cache().max_bytes == 0


def test_poisoned_cache_dir_survives_a_fresh_executor(tmp_path):
    """Warm the cache with one executor, bit-flip the entry on disk, and
    a fresh executor quarantines it and serves the same result through a
    rebuild, never a crash."""
    cache_dir = str(tmp_path / "cc")
    cold = _run_once(FEED, cache_dir)
    h0 = _counter("paddle_deploy_cache_hits_total")
    np.testing.assert_array_equal(_run_once(FEED, cache_dir), cold)
    assert _counter("paddle_deploy_cache_hits_total") == h0 + 1
    for path in _files(cache_dir, ".bin"):
        blob = open(path, "rb").read()
        with open(path, "wb") as fh:      # bit-flip every 64th byte
            fh.write(bytes(b ^ 0xFF if i % 64 == 0 else b
                           for i, b in enumerate(blob)))
    q0 = _counter("paddle_deploy_cache_quarantined_total")
    np.testing.assert_array_equal(_run_once(FEED, cache_dir), cold)
    assert _counter("paddle_deploy_cache_quarantined_total") == q0 + 1


class TestExecutorPrime:
    def _setup(self):
        main, startup, out = _build()
        exe, scope = pc.Executor(device="cpu"), pc.Scope()
        exe.run(startup, scope=scope)
        return main, out, exe, scope

    def test_cache_digest_stable_across_executors(self):
        main, out, exe, scope = self._setup()
        feed = {"x": np.zeros((4, 6), "float32")}
        d1 = exe.cache_digest(main, feed=feed, fetch_list=[out.name],
                              scope=scope)
        d2 = pc.Executor(device="cpu").cache_digest(
            main, feed=feed, fetch_list=[out.name], scope=scope)
        assert d1 == d2
        # a rebuilt program of the same code: the same digest
        main2, _, out2 = _build()
        assert pc.Executor(device="cpu").cache_digest(
            main2, feed=feed, fetch_list=[out2.name], scope=scope) == d1
        # another shape, another flag, another program: another digest
        assert exe.cache_digest(
            main, feed={"x": np.zeros((8, 6), "float32")},
            fetch_list=[out.name], scope=scope) != d1
        port_config.set_flags(nonfinite_guard=True)
        try:
            assert exe.cache_digest(main, feed=feed, fetch_list=[out.name],
                                    scope=scope) != d1
        finally:
            port_config.set_flags(nonfinite_guard=False)
        main3, _, out3 = _build(out_dim=4)
        assert exe.cache_digest(main3, feed=feed, fetch_list=[out3.name],
                                scope=scope) != d1

    def test_prime_aot_digest_mismatch_raises(self):
        main, out, exe, scope = self._setup()
        feed = {"x": np.zeros((4, 6), "float32")}
        ep = exe.lower(main, feed=feed, fetch_list=[out.name], scope=scope)
        with pytest.raises(ValueError, match="digest"):
            exe.prime_aot(main, feed, [out.name], scope, ep,
                          expect_digest="0" * 64)

    def test_primed_program_runs_and_a_misfit_falls_back(self):
        """A primed program executes the entry's runs; once the scope's
        state no longer fits its inputs (a bias of another shape) the
        entry drops it for good and runs op by op."""
        main, out, exe, scope = self._setup()
        feed = {"x": FEED}
        want, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
        ep = exe.lower(main, feed=feed, fetch_list=[out], scope=scope)
        entry = exe.prime_aot(main, feed, [out], scope, ep)
        assert entry.aot is ep
        got, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
        np.testing.assert_array_equal(got, want)
        # a bias of one entry broadcasts: the program runs op by op
        name = "fc_1.w_1"
        scope.set_var(name, scope.find_var(name)[:1].clone())
        got, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
        assert got.shape == want.shape
        assert entry.aot is None and entry.aot_failed


def test_telemetry_counts_the_cache_and_the_exported_step():
    """Under ``telemetry`` an entry is exported at its second run (the
    startup, run once, is not): the cache counters, the export's seconds
    and the graph's operations and bytes, with the reference's family
    names and help."""
    main, startup, out = _build()
    exe, scope = pc.Executor(device="cpu"), pc.Scope()
    exe.run(startup, scope=scope)
    h0 = _counter("paddle_executor_cache_hits_total")
    m0 = _counter("paddle_executor_cache_misses_total")
    port_config.set_flags(telemetry=True)
    once = pc.Executor(device="cpu")
    once.run(startup, scope=pc.Scope())
    for _ in range(2):
        exe.run(main, feed={"x": FEED}, fetch_list=[out], scope=scope)
    port_config.set_flags(telemetry=False)
    assert [e.aot for e in once._cache.values()] == [None]
    # the startup's entry and main's: two misses, then main's hit
    assert _counter("paddle_executor_cache_misses_total") == m0 + 2
    assert _counter("paddle_executor_cache_hits_total") == h0 + 1
    entry = [e for e in exe._cache.values() if e.aot is not None][0]
    dump = metrics.REGISTRY.dump()

    def sample(name):
        return [s["value"] for s in dump[name]["samples"]
                if s["labels"].get("key") == entry.key_id][0]
    assert sample("paddle_executor_trace_seconds") > 0
    # two products of [4, 6] x [6, 8] and [4, 8] x [8, 3]
    assert sample("paddle_executor_step_flops") == 2 * 4 * (6 * 8 + 8 * 3)
    assert sample("paddle_executor_step_bytes") > 4 * FEED.size
    theirs = ref_metrics.REGISTRY.dump()
    for name in ("paddle_executor_cache_hits_total",
                 "paddle_executor_cache_misses_total",
                 "paddle_executor_trace_seconds",
                 "paddle_executor_compile_seconds",
                 "paddle_executor_step_flops",
                 "paddle_executor_step_bytes"):
        assert (dump[name]["type"], dump[name]["help"]) == \
            (theirs[name]["type"], theirs[name]["help"]), name


def test_the_key_is_the_references_less_what_the_port_lacks():
    """The step cache's key holds the reference's parts (uid, version,
    feed signature, fetches, donation, the strategy's uid,
    check_nan_inf, amp, matmul precision, nonfinite_guard, ingest specs,
    the embedding flags of a program with a distributed table, the int8
    tag) less one: the ``flash_attention`` flag, which the port does not
    carry (a CUDA tensor always takes the kernels). Each trace-time flag
    the port has, and a strategy, makes a new entry."""
    from paddle_tpu_torch import parallel as port_parallel
    with pytest.raises(KeyError):
        port_config.set_flags(flash_attention=True)
    main, startup, out = _build()
    exe, scope = pc.Executor(device="cpu"), pc.Scope()
    exe.run(startup, scope=scope)
    keys = set(exe._cache)
    for flags in ({}, {"check_nan_inf": True}, {"nonfinite_guard": True},
                  {"amp": "bfloat16"}):
        port_config.set_flags(**flags)
        try:
            exe.run(main, feed={"x": FEED}, fetch_list=[out], scope=scope)
        finally:
            port_config.set_flags(check_nan_inf=False, nonfinite_guard=False,
                                  amp=None)
    new = [k for k in exe._cache if k not in keys]
    assert len(new) == 4 and {len(k) for k in new} == {13}
    # the reference's key: the same parts, with flash (8) between them
    ref_main, ref_startup = ptpu.Program(), ptpu.Program()
    with ptpu.unique_name.guard(), ptpu.program_guard(ref_main, ref_startup):
        x = ptpu.layers.data("x", shape=[6])
        ref_out = ptpu.layers.fc(x, 3)
    rexe = ptpu.Executor()
    with ptpu.scope_guard(ptpu.Scope()):
        rexe.run(ref_startup)
        rexe.run(ref_main, feed={"x": FEED}, fetch_list=[ref_out])
    ref_key = [k for k in rexe._cache if k[0] == ref_main._uid][0]
    assert len(ref_key) == 14
    assert ref_key[8] is False          # flash_attention, off by default
    # donation, no strategy, check_nan_inf, amp, nonfinite_guard, the
    # ingest specs, no embedding key and no int8 tag
    plain = [k for k in new
             if k[6] is False and k[7] is None and k[9] is False][0]
    assert [plain[i] for i in (4, 5, 6, 7, 9, 10, 11, 12)] == \
        [ref_key[i] for i in (4, 5, 6, 7, 10, 11, 12, 13)]
    # a strategy keys its own entry, by its uid
    strat = port_parallel.DataParallel(n_devices=1)
    sexe = pc.Executor(device="cpu", strategy=strat)
    sexe.run(main, feed={"x": FEED}, fetch_list=[out], scope=scope)
    assert [k[5] for k in sexe._cache] == [strat._uid]
