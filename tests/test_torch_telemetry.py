"""The port's telemetry plane against the reference's, on the CPU: SLO
tracking (``observability/slo.py``), mergeable snapshots and the fleet
aggregator (``aggregate.py``), the HTTP exposition (``http.py``), the
profiler (``utils/profiler.py``), a port-side metrics lint, and the
config flags this slice brings.

* ``SLOTracker`` on a driven clock (the reference's ``bench_slo``
  scenario) trips its alert at the same tick, with equal verdicts.
* ``build_snapshot`` / ``encode_snapshot`` give the same bytes for two
  registries filled alike, truncated alike under a budget; the
  aggregators' delta accounting (incarnations, staleness) gives the same
  merged exposition and totals.
* Both packages' servers answer ``/metrics``, ``/healthz`` and
  ``/debug/*`` alike on registries, health components, traces and
  flight bundles made alike.
* The metrics lint applies ``tools/check_metrics.py``'s rules to every
  family the port registers, and holds each family the port shares with
  the reference to its kind, labels and help.
"""

import json
import os
import re
import socket
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu.observability import aggregate as ref_agg
from paddle_tpu.observability import flight as ref_flight
from paddle_tpu.observability import health as ref_health
from paddle_tpu.observability import http as ref_http
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu.observability import request_trace as ref_rtrace
from paddle_tpu.observability import slo as ref_slo
from paddle_tpu.observability import tracing as ref_tracing
from paddle_tpu.serving import wire as ref_wire
from paddle_tpu.utils import profiler as ref_prof
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import core, layers
from paddle_tpu_torch.observability import aggregate, flight, health, http
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.observability import request_trace as rtrace
from paddle_tpu_torch.observability import slo, tracing
from paddle_tpu_torch.utils import profiler as prof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import check_metrics  # noqa: E402

PORT = dict(metrics=metrics, slo=slo, agg=aggregate, http=http,
            health=health, rtrace=rtrace, flight=flight, cfg=port_config,
            prof=prof, tracing=tracing)
REF = dict(metrics=ref_metrics, slo=ref_slo, agg=ref_agg, http=ref_http,
           health=ref_health, rtrace=ref_rtrace, flight=ref_flight,
           cfg=ptpu.config, prof=ref_prof, tracing=ref_tracing)


@pytest.fixture(autouse=True)
def _restore():
    yield
    for cfg in (port_config, ptpu.config):
        cfg.set_flags(request_tracing=False, flight_dir=None,
                      matmul_precision=None)


# -- SLO ------------------------------------------------------------------

def _detection(m):
    """bench_slo's detection scenario on package ``m``: healthy history
    at 0.25 s ticks, then every request over target; returns the ms from
    the fault to the fast-window alert and the verdict then."""
    reg = m["metrics"].Registry()
    hist = reg.histogram("paddle_bench_slo_e2e_ms", "bench latencies",
                         buckets=m["metrics"].LATENCY_MS_BUCKETS)
    tracker = m["slo"].SLOTracker(
        label="bench", target_p99_ms=100.0,
        source=m["slo"].local_source(histogram="paddle_bench_slo_e2e_ms",
                                     registry=reg))
    now = 0.0
    tracker.tick(now)
    while now < 90.0:
        now += 0.25
        for _ in range(8):
            hist.observe(10.0)
        tracker.tick(now)
    fault_start, detected, burns = now, None, []
    while now < fault_start + 60.0:
        now += 0.25
        for _ in range(8):
            hist.observe(800.0)
        burns.append(tracker.tick(now))
        if tracker.alerting:
            detected = now
            break
    verdict = tracker.verdict(now)
    tracker.close()
    return (detected - fault_start) * 1e3, burns, verdict


def test_slo_detection_equals_the_reference_to_the_tick():
    ms, burns, verdict = _detection(PORT)
    ref_ms, ref_burns, ref_verdict = _detection(REF)
    assert ms == ref_ms
    assert burns == ref_burns
    assert verdict == ref_verdict
    assert verdict["alerting"] and verdict["windows"]["fast"]["requests"]
    # the value chip_smoke.py's [telemetry] holds the card's run to
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_constants", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.SLO_DETECTION_MS == ref_ms


def test_slo_flags_and_labeled_source():
    for m in (PORT, REF):
        assert m["cfg"].get_flag("slo_target_p99_ms") == 0.0
        assert m["cfg"].get_flag("slo_windows") == (5.0, 60.0)
    out = []
    for m in (PORT, REF):
        reg = m["metrics"].Registry()
        h = reg.histogram("paddle_fleet_tenant_request_ms", "t",
                          labelnames=("tenant",),
                          buckets=m["metrics"].LATENCY_MS_BUCKETS)
        shed = reg.counter("paddle_serving_shed_total", "s",
                           labelnames=("tenant",))
        src = m["slo"].labeled_source(
            histogram="paddle_fleet_tenant_request_ms", label="tenant",
            value="a", registry=reg)
        tr = m["slo"].SLOTracker(label="t-a", target_p99_ms=50.0,
                                 windows=(1.0, 4.0), source=src)
        for i in range(12):
            h.labels(tenant="a").observe(20.0 if i % 3 else 90.0)
            h.labels(tenant="b").observe(500.0)
            shed.labels(tenant="a" if i == 5 else "b").inc()
            tr.tick(0.5 * (i + 1))
        out.append((tr.verdict(6.5), tr.violation_seconds, tr.alerting))
        tr.close()
    assert out[0] == out[1]
    with pytest.raises(ValueError):
        slo.SLOTracker(windows=(0.0,))


# -- snapshots and the aggregator ------------------------------------------

def _fill(m, reg, scale=1):
    c = reg.counter("paddle_req_total", "requests",
                    labelnames=("route", "code"))
    for j in range(5):
        c.labels(route="r%d" % j, code="200").inc((j + 1) * scale)
    c.labels(route="r0", code="500").inc(scale)
    g = reg.gauge("paddle_depth", "queue depth")
    g.set(3.5 * scale)
    h = reg.histogram("paddle_lat_ms", "latency", labelnames=("route",),
                      buckets=m["metrics"].LATENCY_MS_BUCKETS)
    for j in range(4):
        for v in (0.3, 7.0, 120.0 * scale, 9e4):
            h.labels(route="r%d" % j).observe(v)
    reg.histogram("paddle_empty_ms", "never observed",
                  buckets=m["metrics"].LATENCY_MS_BUCKETS)
    return reg


def test_snapshot_bytes_equal_the_reference():
    assert aggregate.MAX_LINE == ref_wire.MAX_LINE
    assert aggregate.SNAPSHOT_VERSION == ref_agg.SNAPSHOT_VERSION
    ours = _fill(PORT, metrics.Registry())
    theirs = _fill(REF, ref_metrics.Registry())
    a = aggregate.encode_snapshot(aggregate.build_snapshot(registry=ours))
    b = ref_agg.encode_snapshot(ref_agg.build_snapshot(registry=theirs))
    assert a == b
    assert aggregate.encoded_size(aggregate.snapshot_registry(ours)) == \
        len(b)
    # over a budget: the same families dropped, the same summary frame
    t0 = metrics.REGISTRY.families()[
        "paddle_fleet_snapshot_truncated_total"].value
    for budget in (len(b) - 1, 600, 10):
        sa = aggregate.build_snapshot(max_bytes=budget, registry=ours)
        sb = ref_agg.build_snapshot(max_bytes=budget, registry=theirs)
        assert aggregate.encode_snapshot(sa) == ref_agg.encode_snapshot(sb)
        assert sa.get("truncated", 0) >= 1
    assert metrics.REGISTRY.families()[
        "paddle_fleet_snapshot_truncated_total"].value > t0


def _aggregate(m):
    """Three snapshots of member m1 (a restart between the second and
    third), one of m2 that then dies: the merged view and totals."""
    agg = m["agg"].FleetAggregator("f1", interval_s=1.0,
                                   registry=m["metrics"].Registry())
    snaps = [m["agg"].snapshot_registry(_fill(m, m["metrics"].Registry(),
                                              scale=s)) for s in (1, 2, 1)]
    out = [agg.ingest("m1", "inc1", snaps[0], now=10.0),
           agg.ingest("m2", "inc7", snaps[0], now=10.5),
           agg.ingest("m1", "inc1", snaps[1], now=11.0),
           # restarted: a fresh incarnation's low totals add, never
           # subtract
           agg.ingest("m1", "inc2", snaps[2], now=12.0)]
    with pytest.raises(ValueError):
        agg.ingest("m1", "inc2", {"v": 99}, now=12.0)
    agg.mark_dead("m2")
    out += [agg.counter_value("paddle_req_total"),
            agg.counter_value("paddle_req_total", route="r0"),
            agg.counter_children("paddle_req_total", "code"),
            agg.merged_text(), agg.merged_text(member="m1"),
            agg.merged_text(member="f1:m2"), agg.merged_text(member="x"),
            sorted(agg.fleet_doc(now=13.0)["members"])]
    return out


def test_aggregator_delta_accounting_equals_the_reference():
    ours, theirs = _aggregate(PORT), _aggregate(REF)
    assert ours == theirs
    # m1: 15+1, then +15+1 (scale 2), then its restart's 16; m2: 16
    assert ours[4] == 16 * 4
    assert 'stale="1"' in ours[7]
    assert ours[10] is None


# -- the HTTP exposition -------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _normalize(body, ids):
    """A response with the trace ids, times and thread ids blanked and
    the span ids renumbered in order (the tracers count spans
    process-wide, so earlier tests move them)."""
    text = body.decode()
    for i, tid in enumerate(ids):
        text = text.replace(tid, "TRACE%d" % i)
    text = re.sub(r'"(ts|dur|ts_ms|dur_ms|thread|pid|tid)": [-0-9.e]+',
                  r'"\1": 0', text)
    order = {}
    return re.sub(r'"(span_id|parent_id)": (\d+)',
                  lambda m: '"%s": %d' % (m.group(1), order.setdefault(
                      m.group(2), len(order))), text)


def _serve(m, tmp_path, monkeypatch):
    """Package ``m``'s server over a registry, health components, one
    request trace and one flight bundle made alike; returns the
    answers of every endpoint."""
    reg = _fill(m, m["metrics"].Registry())
    monkeypatch.setattr(m["metrics"], "REGISTRY", reg)
    m["health"].register_health("test-ok", lambda: {"healthy": True,
                                                    "slots": 4})
    m["cfg"].set_flags(request_tracing=True,
                       flight_dir=str(tmp_path / "flight"))
    m["rtrace"].clear()
    ctx = m["rtrace"].mint("generate", tenant="t0")
    m["rtrace"].event(ctx, "admit", dur_ms=1.5)
    m["rtrace"].event(ctx, "decode_step", dur_ms=0.5, slot=2)
    m["rtrace"].event(ctx, "retire", reason="eos")
    rec = m["flight"].FlightRecorder(capacity=4)
    rec.set_armed(True)
    rec.record({"name": "e0"})
    monkeypatch.setattr(m["flight"], "RECORDER", rec)
    m["health"].register_provider(
        "slo", "bench", lambda: {"tracker": "bench", "alerting": False})
    srv = m["http"].TelemetryServer(port=0)
    try:
        before = _get(srv.url + "/debug/flight")
        rec.trigger("test_dump")
        ids = [ctx.trace_id]
        out = {}
        for path in ("/metrics", "/metrics?member=m9", "/healthz",
                     "/debug/trace", "/debug/trace?id=%s" % ctx.trace_id,
                     "/debug/trace?id=nope", "/debug/slo", "/debug/fleet",
                     "/nowhere"):
            code, ctype, body = _get(srv.url + path)
            out[path.replace(ctx.trace_id, "ID")] = (
                code, ctype, _normalize(body, ids))
        code, _, body = _get(srv.url + "/debug/flight")
        bundle = json.loads(body)
        out["/debug/flight"] = (before[0], code, bundle["reason"],
                                [e["name"] for e in bundle["events"]])
        code, _, body = _get(srv.url + "/debug/trace?id=%s&fmt=chrome"
                             % ctx.trace_id)
        out["chrome"] = (code, sorted({e.get("name") for e in
                                       json.loads(body)["traceEvents"]}))
        degraded = m["health"].register_health(
            "test-bad", lambda: {"healthy": False})
        del degraded
        out["/healthz degraded"] = _get(srv.url + "/healthz")[0]
        return out
    finally:
        srv.stop()
        rec.set_armed(False)
        for name in ("test-ok", "test-bad"):
            m["health"].unregister_health(name)
        m["health"].unregister_provider("slo", "bench")


def test_http_endpoints_equal_the_reference(tmp_path, monkeypatch):
    ours = _serve(PORT, tmp_path / "p", monkeypatch)
    theirs = _serve(REF, tmp_path / "r", monkeypatch)
    assert ours == theirs
    assert ours["/metrics"][0] == 200
    assert ours["/metrics"][1] == "text/plain; version=0.0.4"
    assert "paddle_req_total" in ours["/metrics"][2]
    assert ours["/healthz"][0] == 200 and ours["/healthz degraded"] == 503
    assert ours["/debug/trace?id=ID"][0] == 200
    assert ours["/debug/trace?id=nope"][0] == 404
    assert ours["/debug/flight"] == (404, 200, "test_dump", ["e0"])
    assert ours["/nowhere"][0] == 404


def test_telemetry_port_flag_serves_and_stops():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    try:
        port_config.set_flags(telemetry_port=free)
        srv = http.active_server()
        assert srv.port == free
        assert http.start_server(0) is srv       # the running one
        code, ctype, body = _get(srv.url + "/metrics")
        assert code == 200 and body.decode() == \
            metrics.REGISTRY.expose_text()
    finally:
        port_config.set_flags(telemetry_port=0)
    assert http.active_server() is None


# -- the profiler ----------------------------------------------------------

def test_profiler_handle_and_report_as_the_reference(tmp_path):
    tables = []
    for m in (PORT, REF):
        # the tables are process-wide: an earlier test's spans stay in
        # them until a reset
        m["prof"].reset_profiler()
        with m["prof"].profiler() as handle:
            with m["prof"].RecordEvent("stage_a"):
                pass
            with m["prof"].RecordEvent("stage_b"):
                pass
        assert "stage_a" in handle.report()
        path = str(tmp_path / ("host_%d.json" % len(tables)))
        handle.chrome_trace(path)
        names = {e.get("name") for e in json.load(open(path))[
            "traceEvents"]}
        assert {"stage_a", "stage_b"} <= names
        tables.append([line.split()[0] for line in
                       handle.report().splitlines()[2:]])
        m["prof"].reset_profiler()
    assert tables[0] == tables[1]


def test_profiler_trace_windows_out_preexisting_events(tmp_path):
    tracing.start(clear=True)
    try:
        with tracing.span("stale_before"):
            pass
        with prof.profiler() as handle:
            with prof.RecordEvent("inside_block"):
                pass
    finally:
        tracing.stop()
    path = str(tmp_path / "windowed.json")
    handle.chrome_trace(path)
    names = {e["name"] for e in json.load(open(path))["traceEvents"]
             if e.get("ph") == "X"}
    assert "inside_block" in names and "stale_before" not in names


def test_profiler_device_trace(tmp_path):
    """torch.profiler's trace beside the host table: on the CPU when
    asked for; a CUDA trace without CUDA raises."""
    x = torch.randn(64, 64)
    with prof.profiler(str(tmp_path / "tr"), device="cpu") as handle:
        with prof.RecordEvent("matmul"):
            (x @ x).sum()
    assert handle.device_trace == str(tmp_path / "tr" / prof.DEVICE_TRACE)
    events = json.load(open(handle.device_trace))["traceEvents"]
    assert any("mm" in str(e.get("name")) for e in events)
    assert any("mm" in k.key for k in
               handle.device_profile.key_averages())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with prof.profiler(str(tmp_path / "cuda")):
                pass


# -- the metrics lint ------------------------------------------------------

def _scan(top):
    registrations, problems = {}, []
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT, top)):
        for fn in sorted(files):
            if fn.endswith(".py"):
                check_metrics.scan_file(os.path.join(dirpath, fn),
                                        registrations, problems)
    return registrations, problems


def test_port_metrics_lint():
    """tools/check_metrics.py's rules over every port registration, and
    each family shared with the reference registered alike."""
    ours, problems = _scan("paddle_tpu_torch")
    assert problems == []
    assert len(ours) >= 90
    theirs, _ = _scan("paddle_tpu")
    for name, sites in sorted(ours.items()):
        assert check_metrics.NAME_RE.match(name), name
        helps = {h for _w, h, _k, _l in sites}
        kinds = {k for _w, _h, k, _l in sites}
        labels = {l for _w, _h, _k, l in sites}
        assert len(helps) == 1 and None not in helps and "" not in helps, \
            (name, sites)
        assert len(kinds) == 1 and len(labels) == 1, (name, sites)
        if name in theirs:
            ref = theirs[name]
            assert helps == {h for _w, h, _k, _l in ref}, name
            assert kinds == {k for _w, _h, k, _l in ref}, name
            assert labels == {l for _w, _h, _k, l in ref}, name


def test_registered_families_follow_the_rules():
    """At run time too: every family in the port's registry once the
    port's modules are imported."""
    import paddle_tpu_torch.distributed  # noqa: F401
    import paddle_tpu_torch.resilience.supervisor  # noqa: F401
    import paddle_tpu_torch.serving  # noqa: F401
    import paddle_tpu_torch.trainer  # noqa: F401
    fams = metrics.REGISTRY.families()
    for name, fam in fams.items():
        assert check_metrics.NAME_RE.match(name), name
        assert fam.help, name
    for prefix in ("paddle_resilience_", "paddle_elastic_", "paddle_slo_"):
        assert any(n.startswith(prefix) for n in fams), prefix


# -- config ----------------------------------------------------------------

def test_flag_names_equal_the_reference_but_the_listed():
    """The port carries 62 of the reference's 64 flags, the fleet tier's
    14 among them: only the two it leaves out by design (config.py's
    docstring) are missing; defaults equal, and set_flags refuses the
    two as it refuses any unknown name."""
    ours, theirs = set(port_config._flags), set(ptpu.config._flags)
    assert ours <= theirs
    assert theirs - ours == {"flash_attention", "quant_pallas"}
    assert (len(ours), len(theirs)) == (62, 64)
    for name in ours:
        assert port_config._flags[name] == ptpu.config._flags[name], name
    fleet = {n for n in ours if n.startswith(("autoscale_", "fleet_"))}
    fleet |= {"member_resident_bytes", "model_page_timeout_ms"}
    assert len(fleet) == 14
    for name in sorted(fleet):
        port_config.set_flags(**{name: port_config.get_flag(name)})
    for name in ("flash_attention", "quant_pallas"):
        with pytest.raises(KeyError):
            port_config.set_flags(**{name: True})


def test_matmul_precision_keys_the_cache_and_is_restored():
    main, startup = core.Program(), core.Program()
    with core.unique_name.guard(), core.program_guard(main, startup):
        x = layers.data("x", shape=[8])
        y = layers.fc(x, 4)
    exe = core.Executor(device="cpu")
    scope = core.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(0).randn(2, 8).astype("float32")}
    global_before = torch.get_float32_matmul_precision()
    seen = []
    orig = exe._run

    def spy(*a, **k):
        seen.append(torch.get_float32_matmul_precision())
        return orig(*a, **k)

    exe._run = spy
    base = exe.compile_stats()["compiles"] if hasattr(
        exe, "compile_stats") else None
    out0 = exe.run(main, feed=feed, fetch_list=[y], scope=scope)[0]
    for value, torch_name in (("tensorfloat32", "high"),
                              ("BF16_BF16_F32", "medium"),
                              ("highest", "highest")):
        port_config.set_flags(matmul_precision=value)
        out = exe.run(main, feed=feed, fetch_list=[y], scope=scope)[0]
        assert seen[-1] == torch_name
        assert torch.get_float32_matmul_precision() == global_before
        np.testing.assert_allclose(out, out0, rtol=1e-5)
    port_config.set_flags(matmul_precision=None)
    exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    assert seen[-1] == global_before
    # one step-cache entry for each value: None and the three
    keys = {k[8] for k in exe._cache}
    assert keys == {None, "high", "medium", "highest"}
    if base is not None:
        assert exe.compile_stats()["compiles"] == base + 4
    port_config.set_flags(matmul_precision="float64")
    with pytest.raises(ValueError, match="matmul_precision"):
        exe.run(main, feed=feed, fetch_list=[y], scope=scope)
