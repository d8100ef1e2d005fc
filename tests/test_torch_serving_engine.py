"""The port's ``ServingEngine`` and ``MicroBatcher`` against the
reference's, on the same artifact, on the CPU.

Each scenario runs the same script on both packages (the reference's
engine on its virtual CPU devices, the port's with ``device="cpu"``) and
compares what a client and an operator see: outputs, errors, counter
deltas of the ``paddle_serving_*`` and ``paddle_deploy_*`` families,
breaker states and weight versions. Covered: bucket padding and the
overflow path, round-robin over 2 replicas, deadlines, breakers with
failover and the background probe under the fault sites, the timed path
(one long-lived worker a replica, reused; a wedged one fails fast),
``close``, the micro-batcher (coalescing, tenant sheds, the overload
fault site, backpressure, ``drain`` and per-request outputs), hot weight
swaps (lands, signature mismatch, bad artifact, canary failure, watch
rollback, an f32 push to an int8 engine), a reference artifact with a
``compiled/`` index (counted fallbacks, served, nothing unpickled), the
merged file, and the families' names, help text and labels.
"""

import os
import pickle
import threading
import time
import types

import numpy as np
import pytest

import paddle_tpu as ptpu
from paddle_tpu import io as ref_io
from paddle_tpu import layers as ref_layers
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu.serving import batcher as ref_batcher
from paddle_tpu.serving import engine as ref_engine
from paddle_tpu.serving import resilience as ref_sres
from paddle_tpu.utils import merge_model as ref_merge
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch.observability import health
from paddle_tpu_torch.observability import metrics as port_metrics
from paddle_tpu_torch.resilience import faults as port_faults
from paddle_tpu_torch.serving import batcher as port_batcher
from paddle_tpu_torch.serving import deploy as port_deploy
from paddle_tpu_torch.serving import engine as port_engine
from paddle_tpu_torch.serving import resilience as port_sres
from paddle_tpu_torch.utils import merge_model as port_merge
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

IN, OUT = 16, 10

REF = types.SimpleNamespace(
    name="ref", engine=ref_engine, batcher=ref_batcher, sres=ref_sres,
    metrics=ref_metrics, faults=ref_faults, config=ptpu.config, kw={})
PORT = types.SimpleNamespace(
    name="port", engine=port_engine, batcher=port_batcher, sres=port_sres,
    metrics=port_metrics, faults=port_faults, config=port_config,
    kw={"device": "cpu"})
BOTH = [REF, PORT]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for pkg in BOTH:
        pkg.faults.disarm()
        pkg.config.set_flags(serving_quant_compute=False)


def _export(d, seed, quantize=None, out_dim=OUT):
    """An fc net exported by the reference from weights drawn from
    ``seed``: (dir, the float32 weights by name)."""
    with ptpu.unique_name.guard():
        main, startup = ptpu.Program(), ptpu.Program()
        startup.random_seed = 5
        with ptpu.program_guard(main, startup):
            x = ref_layers.data("x", shape=[IN])
            h = ref_layers.fc(x, 32, act="relu")
            out = ref_layers.fc(h, out_dim, act="softmax")
    scope = ptpu.Scope()
    with ptpu.scope_guard(scope):
        ptpu.Executor().run(startup)
        rs = np.random.RandomState(seed)
        for n in sorted(scope.var_names()):
            cur = np.asarray(scope.find_var(n))
            scope.set_var(n, rs.standard_normal(cur.shape)
                          .astype(np.float32) * np.float32(0.3))
        ref_io.save_inference_model(d, ["x"], [out], ptpu.Executor(),
                                    main_program=main, quantize=quantize)
    return d


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """Artifacts: f32 seed 0 and seed 1, int8 seed 0, another width, and
    a feed."""
    root = tmp_path_factory.mktemp("artifacts")
    return types.SimpleNamespace(
        f32=_export(str(root / "f32"), 0),
        f32b=_export(str(root / "f32b"), 1),
        int8=_export(str(root / "int8"), 0, quantize="int8"),
        wide=_export(str(root / "wide"), 0, out_dim=OUT + 2),
        feed=np.random.RandomState(3).randn(24, IN).astype(np.float32))


def _val(pkg, name, **labels):
    fam = pkg.metrics.REGISTRY._families[name]
    child = fam.labels(**labels) if labels else fam
    if hasattr(child, "count") and not hasattr(child, "value"):
        return child.count
    return child.value


def _hist_count(pkg, name, **labels):
    fam = pkg.metrics.REGISTRY._families[name]
    return (fam.labels(**labels) if labels else fam._default()).count


def _delta(pkg, names, fn):
    keys = [(n, {}) if isinstance(n, str) else n for n in names]
    before = [_val(pkg, n, **lab) for n, lab in keys]
    out = fn()
    after = [_val(pkg, n, **lab) for n, lab in keys]
    return out, [b - a for a, b in zip(before, after)]


def _engine(pkg, d, **kw):
    return pkg.engine.ServingEngine(d, **dict(pkg.kw, **kw))


def _close(a, b, rel=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-30)


# -- families -----------------------------------------------------------

FAMILIES = sorted(
    ["paddle_serving_%s" % n for n in (
        "requests_total", "batches_total", "batch_occupancy",
        "batch_seconds", "bucket_compiles_total", "bucket_overflow_total",
        "request_seconds", "queue_depth")] +
    ["paddle_deploy_%s" % n for n in (
        "aot_loads_total", "aot_fallbacks_total", "swap_total",
        "swap_rolled_back_total", "cold_start_seconds",
        "swap_blackout_seconds")])


@pytest.mark.parametrize("name", FAMILIES)
def test_family_as_the_reference(name):
    ours = port_metrics.REGISTRY.families()[name]
    theirs = ref_metrics.REGISTRY.families()[name]
    assert (ours.kind, ours.help, ours.labelnames) == \
        (theirs.kind, theirs.help, theirs.labelnames)


# -- buckets, overflow, replicas -----------------------------------------

def _padding_script(pkg, art):
    eng = _engine(pkg, art.f32, buckets=(4, 8), warmup=False)
    names = ["paddle_serving_requests_total",
             "paddle_serving_bucket_overflow_total",
             ("paddle_serving_batches_total", {"bucket": "4"}),
             ("paddle_serving_batches_total", {"bucket": "8"}),
             ("paddle_serving_batches_total", {"bucket": "9"}),
             ("paddle_serving_bucket_compiles_total", {"bucket": "4"}),
             ("paddle_serving_bucket_compiles_total", {"bucket": "8"})]

    def serve():
        return [eng.run({"x": art.feed[:n]})[0] for n in (1, 3, 4, 7, 9, 2)]
    outs, delta = _delta(pkg, names, serve)
    occ = _val(pkg, "paddle_serving_batch_occupancy")
    with pytest.raises(KeyError):
        eng.run({"y": art.feed[:2]})
    with pytest.raises(ValueError):
        eng.run({"x": np.float32(1.0)})
    with pytest.raises(ValueError, match="positive"):
        _engine(pkg, art.f32, buckets=(0, 2))
    eng.close()
    return outs, delta, occ


def test_bucket_padding_and_overflow(art):
    (ref, rd, rocc), (port, pd, pocc) = [_padding_script(p, art)
                                         for p in BOTH]
    for a, b in zip(port, ref):
        _close(a, b)
    assert [o.shape[0] for o in port] == [1, 3, 4, 7, 9, 2]
    assert pd == rd == [26, 1, 4, 1, 1, 1, 1]
    assert pocc == rocc == 0.5


def _replica_script(pkg, art):
    eng = _engine(pkg, art.f32, buckets=(8,), replicas=2, warmup=True)
    hits = [0, 0]
    for rep in eng.replicas:
        run = rep.exe.run

        def counted(*a, _run=run, _i=rep.index, **k):
            hits[_i] += 1
            return _run(*a, **k)
        rep.exe.run = counted
    outs = [eng.run({"x": art.feed[:2]})[0] for _ in range(6)]
    devices = [rep.device for rep in eng.replicas]
    eng.close()
    return outs, hits, devices


def test_two_replicas_round_robin(art):
    (ref, rhits, _), (port, phits, pdev) = [_replica_script(p, art)
                                            for p in BOTH]
    for a, b in zip(port, ref):
        _close(a, b)
    assert phits == rhits == [3, 3]
    assert [str(d) for d in pdev] == ["cpu", "cpu"]


def test_warmup_counts_each_bucket_on_each_replica(art):
    got = []
    for pkg in BOTH:
        names = [("paddle_serving_bucket_compiles_total", {"bucket": b})
                 for b in ("1", "8")] + ["paddle_serving_requests_total"]
        eng, delta = _delta(pkg, names, lambda: _engine(
            pkg, art.f32, buckets=(1, 8), replicas=2))
        assert eng.warmup() == [1, 8]
        got.append((delta, eng._probe_feed[1]))
        eng.close()
    assert got[0] == got[1] == ([2, 2, 0], 1)


# -- deadlines, breakers, failover, the probe -----------------------------

def _deadline_script(pkg, art):
    eng = _engine(pkg, art.f32, buckets=(4,), warmup=False)
    errs = []
    for kw in (dict(deadline=time.monotonic() - 1.0), dict(deadline_ms=-5)):
        (err, delta) = _delta(
            pkg, ["paddle_serving_deadline_exceeded_total",
                  "paddle_serving_requests_total"],
            lambda: pytest.raises(pkg.sres.ServingDeadlineError,
                                  eng.run, {"x": art.feed[:2]}, **kw))
        errs.append(delta)
    out = eng.run({"x": art.feed[:2]}, deadline_ms=60000)[0]
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.run({"x": art.feed[:2]})
    return errs, out


def test_deadlines_refuse_before_dispatch(art):
    (rerr, rout), (perr, pout) = [_deadline_script(p, art) for p in BOTH]
    assert perr == rerr == [[1, 0], [1, 0]]
    _close(pout, rout)


def _failover_script(pkg, art):
    """Replica 0 fails every batch; requests are answered by replica 1,
    replica 0's breaker opens after 2 failures; disarmed, the probe
    re-admits it after the cooldown."""
    eng = _engine(pkg, art.f32, buckets=(4,), replicas=2,
                  breaker_failures=2, breaker_cooldown_ms=50.0)
    pkg.faults.arm("serving_replica_fail", at=0, times=None)
    names = ["paddle_serving_failover_total",
             ("paddle_serving_breaker_transitions_total", {"state": "open"}),
             ("paddle_serving_breaker_transitions_total",
              {"state": "closed"}),
             "paddle_serving_requests_total"]
    outs, delta = _delta(pkg, names, lambda: [
        eng.run({"x": art.feed[:3]})[0] for _ in range(6)])
    states = eng.replica_health()
    pkg.faults.disarm()
    t0 = time.monotonic()
    while eng.replica_health()[0] != "closed" and \
            time.monotonic() - t0 < 20.0:
        time.sleep(0.01)
    readmitted = eng.replica_health()
    healthz = health.health_snapshot() if pkg is PORT else None
    eng.close()
    return outs, delta, states, readmitted, healthz


def test_breaker_failover_and_probe(art):
    (ref, rd, rstates, rre, _), (port, pd, pstates, pre, hz) = [
        _failover_script(p, art) for p in BOTH]
    for a, b in zip(port, ref):
        _close(a, b)
    # 6 requests: the round-robin offers replica 0 first three times
    # before its breaker opens (2 failures), each failing over
    assert pd[:2] == rd[:2] == [2, 1]
    assert pd[3] == rd[3] == 18
    assert pstates == rstates == ["open", "closed"]
    assert pre == rre == ["closed", "closed"]
    comp = [v for k, v in hz["components"].items()
            if k.startswith("engine")] if "components" in hz else \
        [v for k, v in hz.items() if k.startswith("engine")]
    assert comp and all(c["healthy"] for c in comp)


def test_no_healthy_replica_raises_unavailable(art):
    for pkg in BOTH:
        eng = _engine(pkg, art.f32, buckets=(4,), replicas=2,
                      breaker_failures=1, breaker_cooldown_ms=600000.0,
                      warmup=False)
        pkg.faults.arm("serving_replica_fail", times=None)
        # a request charges at most one breaker: two requests open both
        for _ in range(2):
            with pytest.raises(pkg.faults.InjectedFault):
                eng.run({"x": art.feed[:2]})
        assert eng.replica_health() == ["open", "open"]
        with pytest.raises(pkg.sres.ServingUnavailableError):
            eng.run({"x": art.feed[:2]})
        pkg.faults.disarm()
        eng.close()


def _slow(seconds):
    return lambda *a, **k: time.sleep(seconds)


def test_timed_path_one_worker_per_replica_reused(art):
    eng = _engine(PORT, art.f32, buckets=(4,), replicas=2, timeout=30.0)
    for _ in range(6):
        eng.run({"x": art.feed[:2]})
    names = sorted(t.name for t in threading.enumerate()
                   if t.name.startswith("serving-exec-"))
    assert names == ["serving-exec-0", "serving-exec-1"]
    workers = [rep.worker for rep in eng.replicas]
    eng.run({"x": art.feed[:2]})
    assert [rep.worker for rep in eng.replicas] == workers
    eng.close()
    assert all(rep.worker is None for rep in eng.replicas)


def _wedge_script(pkg, art):
    """A wedge on replica 0 past the timeout: the call fails over to
    replica 1 and replica 0's breaker opens at once; a probe against the
    wedged replica fails fast instead of queueing a second call."""
    eng = _engine(pkg, art.f32, buckets=(4,), replicas=2, timeout=0.3,
                  breaker_failures=3, breaker_cooldown_ms=600000.0)
    pkg.faults.arm("serving_replica_slow", at=0, times=1,
                   action="callback", callback=_slow(1.5))
    out = eng.run({"x": art.feed[:2]})[0]
    states = eng.replica_health()
    with pytest.raises(pkg.sres.ServingTimeoutError, match="still wedged"):
        eng._execute_timed(eng.replicas[0], {"x": art.feed[:4]}, 4, 5.0)
    time.sleep(1.5)
    again = eng._execute_timed(eng.replicas[0], {"x": art.feed[:4]}, 4,
                               5.0)[0]
    eng.close()
    return out, states, again


def test_wedged_replica_fails_fast_and_recovers(art):
    (rout, rstates, ragain), (pout, pstates, pagain) = [
        _wedge_script(p, art) for p in BOTH]
    _close(pout, rout)
    _close(pagain, ragain)
    assert pstates == rstates == ["open", "closed"]


def test_close_stops_the_threads_and_refuses(art):
    eng = _engine(PORT, art.f32, buckets=(4,), replicas=2, timeout=30.0,
                  breaker_failures=1, breaker_cooldown_ms=10.0)
    port_faults.arm("serving_replica_fail", at=0, times=1)
    eng.run({"x": art.feed[:2]})
    port_faults.disarm()
    assert eng._probe is not None
    probe = eng._probe
    name = eng._health_name
    eng.close()
    assert not probe.is_alive()
    assert name not in health.health_snapshot().get("components", {})
    with pytest.raises(RuntimeError, match="closed"):
        eng.run({"x": art.feed[:2]})
    with pytest.raises(RuntimeError, match="closed"):
        eng.swap_weights(art.f32b)


# -- the micro-batcher -----------------------------------------------------

def _batcher_script(pkg, art):
    eng = _engine(pkg, art.f32, buckets=(1, 8))
    want = eng.run({"x": art.feed[:8]})[0]
    names = ["paddle_serving_requests_total", "paddle_serving_shed_total",
             ("paddle_serving_tenant_shed_total", {"tenant": "t1"}),
             ("paddle_serving_batches_total", {"bucket": "8"})]

    def script():
        mb = pkg.batcher.MicroBatcher(eng, max_delay_ms=50.0,
                                      autostart=False)
        futs = [mb.submit({"x": art.feed[i]}) for i in range(8)]
        mb.start()
        rows = [f.result(timeout=30)[0] for f in futs]
        # the overload fault sheds the next submit, tenant-attributed
        pkg.faults.arm("serving_overload", times=1)
        with pytest.raises(pkg.batcher.ServingOverloadError):
            mb.submit({"x": art.feed[0]}, tenant="t1")
        pkg.faults.disarm()
        # a projected wait past the budget is shed at the door
        mb._wait_ewma = 10.0
        with pytest.raises(pkg.batcher.ServingOverloadError, match="shed"):
            mb.submit({"x": art.feed[0]}, deadline_ms=5.0, tenant="t1")
        mb._wait_ewma = 0.0
        with pytest.raises(ValueError, match="example shape"):
            mb.submit({"x": art.feed[:2]})
        # drain serves what was accepted behind the stop marker
        mb2 = pkg.batcher.MicroBatcher(eng, autostart=False)
        late = [mb2.submit({"x": art.feed[i]}) for i in range(3)]
        mb2.drain()
        late = [f.result(timeout=5)[0] for f in late]
        with pytest.raises(RuntimeError, match="closed"):
            mb2.submit({"x": art.feed[0]})
        mb.close()
        # backpressure and close
        mb3 = pkg.batcher.MicroBatcher(eng, max_queue=2, autostart=False)
        fut = mb3.submit({"x": art.feed[0]})
        mb3.submit({"x": art.feed[1]})
        with pytest.raises(pkg.batcher.ServingOverloadError, match="full"):
            mb3.submit({"x": art.feed[2]}, timeout=0.01)
        mb3.close()
        with pytest.raises(RuntimeError, match="closed"):
            fut.result(timeout=5)
        return rows, late

    (rows, late), delta = _delta(pkg, names, script)
    eng.close()
    return want, rows, late, delta


def test_micro_batcher_as_the_reference(art):
    (rw, rrows, rlate, rd), (pw, prows, plate, pd) = [
        _batcher_script(p, art) for p in BOTH]
    for i, row in enumerate(prows):
        np.testing.assert_array_equal(row, pw[i])  # its own row, exactly
        _close(row, rrows[i])
    for a, b in zip(plate, rlate):
        _close(a, b)
    # 8 coalesced into one batch of 8; 3 drained in one batch (bucket 8)
    assert pd == rd == [11, 2, 2, 2]


def test_micro_batcher_concurrent_clients(art):
    eng = _engine(PORT, art.f32, buckets=(1, 4, 8), replicas=2)
    want = eng.run({"x": art.feed})[0]
    results, errors = {}, []
    mb = port_batcher.MicroBatcher(eng, max_delay_ms=25.0, autostart=False)

    def client(tid):
        try:
            futs = [(tid * 3 + i, mb.submit({"x": art.feed[tid * 3 + i]}))
                    for i in range(3)]
            for idx, fut in futs:
                results[idx] = fut.result(timeout=30)[0]
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
    b0 = sum(c.value for c in port_metrics.REGISTRY._families[
        "paddle_serving_batches_total"].children().values())
    for t in threads:
        t.start()
    time.sleep(0.05)
    mb.start()
    for t in threads:
        t.join()
    mb.close()
    eng.close()
    assert not errors and len(results) == 24
    for idx, out in results.items():
        _close(out, want[idx])
    batches = sum(c.value for c in port_metrics.REGISTRY._families[
        "paddle_serving_batches_total"].children().values()) - b0
    assert 24 / batches > 1.0


# -- hot weight swaps -----------------------------------------------------

def _swap_names():
    return ["paddle_deploy_swap_total", "paddle_deploy_swap_rolled_back_total"]


def _swap_script(pkg, art):
    eng = _engine(pkg, art.f32, buckets=(1, 4), replicas=2)
    x = {"x": art.feed[:3]}
    before = eng.run(x)[0]
    out = {}
    blackout0 = _hist_count(pkg, "paddle_deploy_swap_blackout_seconds")
    # lands
    (v, d1) = _delta(pkg, _swap_names(),
                     lambda: eng.swap_weights(art.f32b, watch_requests=0))
    out["landed"] = (v, d1, eng.run(x)[0])
    # a different width: the signature check refuses it
    _, d2 = _delta(pkg, _swap_names(), lambda: pytest.raises(
        pkg.engine.SwapRejectedError, eng.swap_weights, art.wide))
    # the bad-artifact and canary fault sites
    pkg.faults.arm("swap_bad_artifact", times=1)
    _, d3 = _delta(pkg, _swap_names(), lambda: pytest.raises(
        pkg.engine.SwapRejectedError, eng.swap_weights, art.f32))
    pkg.faults.arm("swap_canary_fail", times=1)
    _, d4 = _delta(pkg, _swap_names(), lambda: pytest.raises(
        pkg.engine.SwapRejectedError, eng.swap_weights, art.f32))
    out["rejected"] = (d2, d3, d4, eng.run(x)[0], eng.weights_version)
    # the watch: a failure right after a push rolls it back, and the
    # request that tripped the rollback is retried on the old weights
    v2 = eng.swap_weights(art.f32, watch_requests=10, watch_failures=1)
    pkg.faults.arm("serving_replica_fail", times=1)
    r = [eng.run(x)[0] for _ in range(2)]
    out["rolled"] = (v2, eng.weights_version, r)
    out["blackouts"] = _hist_count(
        pkg, "paddle_deploy_swap_blackout_seconds") - blackout0
    eng.close()
    return before, out


def test_swap_weights_as_the_reference(art):
    (rb, rs), (pb, ps) = [_swap_script(p, art) for p in BOTH]
    _close(pb, rb)
    v, d1, landed = ps["landed"]
    assert (v, d1) == rs["landed"][:2] == (1, [1, 0])
    _close(landed, rs["landed"][2])
    assert not np.allclose(landed, pb)
    d2, d3, d4, after, version = ps["rejected"]
    assert (d2, d3, d4, version) == rs["rejected"][:2] + \
        rs["rejected"][2:3] + (rs["rejected"][4],) == \
        ([1, 1], [1, 1], [1, 1], 1)
    np.testing.assert_array_equal(after, landed)  # bitwise as before
    v2, vend, rolled = ps["rolled"]
    assert (v2, vend) == rs["rolled"][:2] == (2, 3)
    for a, b in zip(rolled, rs["rolled"][2]):
        _close(a, b)
        np.testing.assert_array_equal(a, landed)  # the restored weights
    assert ps["blackouts"] == rs["blackouts"]


def test_swap_stages_new_tensors_never_writes_in_place(art):
    eng = _engine(PORT, art.f32, buckets=(2,), replicas=2)
    live = [{n: rep.scope.find_var(n) for n in rep.scope.var_names()}
            for rep in eng.replicas]
    snap = [{n: t.clone() for n, t in d.items()} for d in live]
    eng.swap_weights(art.f32b, watch_requests=0)
    for rep, old, copy in zip(eng.replicas, live, snap):
        for n, t in old.items():
            assert rep.scope.find_var(n) is not t
            assert t.equal(copy[n])  # the old tensor was not written
    # each replica holds its own copy
    a, b = (rep.scope.find_var("fc_0.w_0") for rep in eng.replicas)
    assert a.data_ptr() != b.data_ptr()
    eng.close()


def _int8_push_script(pkg, art):
    pkg.config.set_flags(serving_quant_compute=True)
    eng = _engine(pkg, art.int8, buckets=(4,))
    x = {"x": art.feed[:4]}
    armed = eng.run(x)[0]
    dtypes = {n: str(getattr(eng.replicas[0].scope.find_var(n), "dtype"))
              for n in ("fc_0.w_0", "fc_1.w_0")}
    v = eng.swap_weights(art.f32b, watch_requests=0)
    pushed = eng.run(x)[0]
    pkg.config.set_flags(serving_quant_compute=False)
    eng.close()
    return armed, dtypes, v, pushed


def test_an_f32_push_to_an_int8_engine(art):
    (ra, rdt, rv, rp), (pa, pdt, pv, pp) = [_int8_push_script(p, art)
                                            for p in BOTH]
    assert set(pdt.values()) == {"torch.int8"}
    assert set(rdt.values()) == {"int8"}
    assert pv == rv == 1
    _close(pa, ra, rel=1e-4)
    _close(pp, rp, rel=1e-4)


# -- artifacts: AOT index, merged file ------------------------------------

def test_reference_compiled_artifact_serves_without_unpickling(
        art, tmp_path, monkeypatch):
    d = str(tmp_path / "aot")
    with ptpu.unique_name.guard():
        main, startup = ptpu.Program(), ptpu.Program()
        with ptpu.program_guard(main, startup):
            x = ref_layers.data("x", shape=[IN])
            out = ref_layers.fc(x, OUT, act="softmax")
    scope = ptpu.Scope()
    with ptpu.scope_guard(scope):
        exe = ptpu.Executor()
        exe.run(startup)
        ref_io.save_inference_model(d, ["x"], [out], exe, main_program=main,
                                    export_compiled=True,
                                    export_buckets=(2, 4))
    index = port_deploy.load_compiled_index(d)
    assert sorted(index["buckets"]) == ["2", "4"]
    assert port_io.verify_model_artifact(d, skip_compiled=True) == \
        (True, "ok")
    for entry in index["buckets"].values():
        assert port_deploy.read_compiled_blob(d, entry)

    def refuse(*a, **k):
        raise AssertionError("a compiled/ blob was unpickled")
    monkeypatch.setattr(pickle, "loads", refuse)
    monkeypatch.setattr(pickle, "load", refuse)
    names = ["paddle_deploy_aot_fallbacks_total",
             "paddle_deploy_aot_loads_total",
             ("paddle_serving_bucket_compiles_total", {"bucket": "2"})]
    eng, delta = _delta(PORT, names, lambda: _engine(
        PORT, d, buckets=(1, 2, 4), replicas=2))
    assert delta == [4, 0, 2]  # 2 indexed buckets x 2 replicas
    got = eng.run({"x": art.feed[:3]})[0]
    merged = port_merge.merge_inference_model(d, str(tmp_path / "m"))
    eng2, delta2 = _delta(PORT, names[:1], lambda: _engine(
        PORT, merged, buckets=(2,)))
    assert delta2 == [1]
    eng.close()
    eng2.close()
    monkeypatch.undo()
    with ptpu.scope_guard(scope):
        want = exe.run(main, feed={"x": art.feed[:3]}, fetch_list=[out])[0]
    _close(got, want)
    # a re-export drops the stale compiled/ members
    port_io.save_inference_model(
        d, ["x"], [], pc.Executor(device="cpu"), main_program=pc.Program(),
        scope=pc.Scope())
    assert not os.path.exists(os.path.join(d, "compiled"))
    # a program without its feed variable has no bucket to export (the
    # port's export itself: tests/test_torch_aot.py)
    assert port_deploy.export_compiled_buckets(d, pc.Scope(),
                                               place="cpu") == []


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_merged_file_engine_equals_the_directory_engine(art, tmp_path,
                                                        writer):
    merge = ref_merge if writer == "ref" else port_merge
    merged = merge.merge_inference_model(art.int8, str(tmp_path / "m.ptpu"))
    outs = []
    for src in (art.int8, merged):
        eng = _engine(PORT, src, buckets=(4,))
        outs.append(eng.run({"x": art.feed[:4]})[0])
        unpacked = eng._unpacked_dir
        eng.close()
        if src == merged:
            assert unpacked and not os.path.exists(unpacked)
    np.testing.assert_array_equal(outs[1], outs[0])
    ref_eng = ref_engine.ServingEngine(merged, buckets=(4,))
    _close(outs[1], ref_eng.run({"x": art.feed[:4]})[0])
    ref_eng.close()


def test_entry_points_raise_without_cuda(art, monkeypatch):
    import torch
    from paddle_tpu_torch import inference
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_engine.ServingEngine(art.f32, buckets=(2,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.InferenceEngine(art.f32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.infer(art.f32, {"x": art.feed[:1]}, use_cache=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_engine.ServingEngine(art.f32, buckets=(2,), device="cuda")
