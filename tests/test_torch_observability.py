"""The port's observability and fault modules against the reference's:
the metrics registry, host spans, request traces, the flight recorder,
structured logs, fault injection, breakers and the bounded call, and the
config hook that arms them, on the CPU.

The registry test runs one scripted serving workload through both
packages (a breaker-armed scheduler with replay through a step fault, a
paged prefix-cache session, a speculative session through the
draft-mismatch fault, an int8 session) and holds every family the port
registers to the reference's: the same name, type, help text and label
names, and label values the reference also produced. Span, event and
fault-site names are compared the same way.
"""

import json
import logging
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import layers
from paddle_tpu.models.transformer import transformer_lm
from paddle_tpu.models.transformer import \
    transformer_lm_session as ref_lm_session
from paddle_tpu.observability import flight as ref_flight
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu.observability import request_trace as ref_rtrace
from paddle_tpu.observability import tracing as ref_tracing
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu.serving import GenerationScheduler as RefScheduler
from paddle_tpu.serving import GenerationSession as RefSession
from paddle_tpu.serving import decoding as ref_dec
from paddle_tpu.serving import resilience as ref_sres
from paddle_tpu.utils import log as ref_log
# the training pipeline's families, registered by these modules in both
# packages (the registry test compares the two registries' family sets)
from paddle_tpu import trainer as ref_trainer  # noqa: F401
from paddle_tpu.reader import staging as ref_staging  # noqa: F401
from paddle_tpu.utils import stat as ref_stat  # noqa: F401
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import observability
from paddle_tpu_torch import resilience as port_resilience
from paddle_tpu_torch.models import transformer as port_tf
from paddle_tpu_torch.observability import flight, health, metrics
from paddle_tpu_torch.observability import request_trace as rtrace
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.ops import quant_ops as port_q
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import (GenerationScheduler, GenerationSession,
                                      batcher, resilience as sres)
from paddle_tpu_torch.serving import decoding as port_dec
from paddle_tpu_torch.serving import generation as port_gen
from paddle_tpu_torch.serving import paged_cache as port_pc
from paddle_tpu_torch.utils import log
from paddle_tpu_torch import trainer as port_trainer  # noqa: F401
from paddle_tpu_torch.reader import staging as port_staging  # noqa: F401
# the supervisor's, the elastic runtime's and the telemetry plane's
# families, registered at import in both packages
from paddle_tpu_torch import distributed as port_distributed  # noqa: F401
from paddle_tpu_torch.resilience import supervisor as port_sup  # noqa: F401
from paddle_tpu_torch.observability import aggregate as _agg  # noqa: F401
from paddle_tpu_torch.observability import slo as _slo  # noqa: F401
from paddle_tpu import distributed as ref_distributed  # noqa: F401
from paddle_tpu.resilience import supervisor as ref_sup  # noqa: F401
from paddle_tpu.observability import aggregate as _ref_agg  # noqa: F401
from paddle_tpu.observability import slo as _ref_slo  # noqa: F401
# the fleet tier's: the router's, the workers' and the paging families
# register when the serving package is imported (fleet.py,
# model_paging.py), the autoscaler's when its module is
from paddle_tpu_torch.serving import autoscale as _autoscale  # noqa: F401
from paddle_tpu.serving import autoscale as _ref_autoscale  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, MAXLEN = 29, 24
KW = dict(d_model=16, num_heads=2, d_ff=32, num_layers=2)
BOS, EOS = 0, 1
PROMPTS = ([BOS], [2, 3], [4, 5, 6], [BOS, 5])
SHARED = [2, 3, 4, 5, 6, 7, 8, 9, 10]

# the families the port registers
FAMILIES = sorted([
    "paddle_generation_%s" % n for n in (
        "requests_total", "tokens_total", "prefills_total",
        "decode_steps_total", "retired_total", "slot_occupancy",
        "ttft_seconds", "inter_token_seconds", "request_seconds",
        "failover_total", "replayed_tokens_total",
        "session_rebuilds_total", "step_timeouts_total",
        "failover_recovery_seconds", "speculative_drafted_total",
        "speculative_accepted_total", "prefix_hits_total",
        "prefix_misses_total", "prefix_shared_tokens_total",
        "kv_block_cows_total", "kv_pool_evictions_total",
        "kv_blocks_in_use", "kv_spec_rollback_blocks_total")] + [
    "paddle_request_%s" % n for n in (
        "queue_wait_ms", "prefill_ms", "decode_step_ms",
        "replay_recovery_ms", "e2e_ms")] + [
    "paddle_serving_%s" % n for n in (
        "deadline_exceeded_total", "shed_total", "tenant_shed_total",
        "failover_total", "breaker_transitions_total",
        "replica_healthy")] + ["paddle_quant_compute_ops_total"] + [
    # the serving engine's, the micro-batcher's and the deploy layer's,
    # registered when the serving package is imported, as the
    # reference's are
    "paddle_serving_%s" % n for n in (
        "requests_total", "batches_total", "batch_occupancy",
        "batch_seconds", "bucket_compiles_total", "bucket_overflow_total",
        "request_seconds", "queue_depth")] + [
    "paddle_deploy_%s" % n for n in (
        "aot_loads_total", "aot_fallbacks_total", "swap_total",
        "swap_rolled_back_total", "cold_start_seconds",
        "swap_blackout_seconds")] + [
    # the executor's step cache and the persistent compile cache,
    # registered when core/executor.py and core/compile_cache.py are
    # imported, as the reference's are
    "paddle_executor_%s" % n for n in (
        "cache_hits_total", "cache_misses_total", "trace_seconds",
        "compile_seconds", "step_flops", "step_bytes")] + [
    "paddle_deploy_cache_%s_total" % n for n in (
        "hits", "misses", "quarantined", "evictions")] + [
    # the distributed embedding tables', registered when their module is
    # imported (the reference's package imports it; the port's registry
    # imports it with the ops)
    "paddle_embedding_lookup_rows_total", "paddle_embedding_a2a_bytes_total",
    "paddle_embedding_unique_ratio"] + [
    # the training pipeline's (trainer, staging, checkpoints, stat
    # timers): registered when their modules are imported, which this
    # file does in both packages
    "paddle_trainer_%s" % n for n in (
        "step_seconds", "examples_total", "examples_per_second",
        "steps_total", "checkpoint_seconds")] + [
    "paddle_staging_%s" % n for n in (
        "queue_depth", "batches_total", "stage_seconds",
        "arena_in_use_bytes", "arena_peak_bytes", "wire_bytes_total",
        "legacy_bytes_total", "h2d_transfers_total",
        "sparse_slots_total")] + [
    "paddle_checkpoint_%s" % n for n in (
        "fallbacks_total", "quarantined_total", "verify_seconds")] + [
    "paddle_stat_span_seconds", "paddle_stat_gauge"] + [
    # the supervisor's, the elastic runtime's, SLO tracking's and the
    # snapshot encoder's
    "paddle_resilience_%s" % n for n in (
        "nonfinite_steps_total", "skipped_steps_total", "rollbacks_total",
        "reader_retries_total", "watchdog_stalls_total",
        "preemptions_total")] + [
    "paddle_elastic_%s" % n for n in (
        "generation", "worker_deaths_total", "resume_seconds",
        "restarts_total", "heartbeats_total", "heartbeat_misses_total")] + [
    "paddle_slo_burn_rate", "paddle_slo_violation_seconds_total",
    "paddle_fleet_snapshot_truncated_total"] + [
    "paddle_fleet_%s" % n for n in (
        "requests_total", "failover_total", "member_deaths_total",
        "fenced_replies_total", "journal_resets_total", "deploys_total",
        "rollbacks_total", "generation", "members_live",
        "member_inflight", "request_ms", "tenant_request_ms",
        "tenant_deadline_total", "tenant_active", "recovery_seconds",
        "worker_done_total", "model_page_ins_total", "model_page_in_ms",
        "model_evictions_total", "model_residency_hits_total",
        "model_residency_misses_total", "model_request_ms",
        "model_deadline_total", "member_resident_bytes")] + [
    "paddle_autoscale_%s" % n for n in (
        "scale_ups_total", "scale_downs_total", "spawn_failures_total",
        "spawn_to_join_ms", "pending_spawns", "pressure",
        "queue_wait_ms")])


@pytest.fixture(autouse=True)
def _restore():
    yield
    faults.disarm()
    ref_faults.disarm()
    port_config.set_flags(telemetry=False, request_tracing=False,
                          trace_sample_rate=1.0, flight_dir=None)
    ptpu.config.set_flags(telemetry=False, request_tracing=False,
                          trace_sample_rate=1.0, flight_dir=None)


@pytest.fixture(scope="module")
def weights():
    with ptpu.unique_name.guard():
        main, startup = ptpu.Program(), ptpu.Program()
        with ptpu.program_guard(main, startup):
            toks = layers.data("toks", shape=[1, MAXLEN], dtype="int64",
                               append_batch_size=False)
            lbls = layers.data("lbls", shape=[1, MAXLEN], dtype="int64",
                               append_batch_size=False)
            transformer_lm(toks, lbls, vocab_size=V, is_test=True, **KW)
    scope = ptpu.Scope()
    with ptpu.scope_guard(scope):
        ptpu.Executor().run(startup)
    rs = np.random.RandomState(7)
    for n in sorted(scope.var_names()):
        cur = np.asarray(scope.find_var(n))
        scope.set_var(n, rs.standard_normal(cur.shape).astype(cur.dtype))
    return scope, {n: np.asarray(scope.find_var(n))
                   for n in scope.var_names()}


def _ref(scope, policy=None, paged=False, arm=False, **kw):
    spec = ref_lm_session(V, max_len=MAXLEN, slots=2,
                          prompt_buckets=(4, 8, 16), bos_id=BOS, eos_id=EOS,
                          paged=paged or None, block_size=4 if paged else None,
                          decode_policy=policy, **dict(KW, **kw))
    if arm:
        own = ptpu.Scope()
        for n in scope.var_names():
            own.set_var(n, np.array(scope.find_var(n)))
        scope = own
    return RefSession(spec, scope=scope, arm_quant=arm)


def _port(named, policy=None, paged=False, arm=False, **kw):
    spec = port_tf.transformer_lm_session(
        V, max_len=MAXLEN, slots=2, prompt_buckets=(4, 8, 16), bos_id=BOS,
        eos_id=EOS, device="cpu", paged=paged, block_size=4 if paged else
        None, decode_policy=policy, **dict(KW, **kw))
    return GenerationSession(spec, port_io.params_from_jax(named,
                                                           device="cpu"),
                             arm_quant=arm)


def _workload(pkg, sched_cls, fault_mod, make):
    """The scripted run: a breaker-armed, replaying scheduler through a
    step fault (drained), a paged prefix session with a shared prompt and
    a small pool, a speculative session through the draft-mismatch
    fault, an int8 session, a shed and an expired deadline. Returns the
    streams."""
    out = {}
    sched = sched_cls([make(), make()], replay_attempts=4,
                      breaker_failures=1, breaker_cooldown_ms=60000.0,
                      autostart=False)
    futs = [sched.submit(list(p), max_new_tokens=6, eos_id=-1)
            for p in PROMPTS]
    expired = sched.submit([BOS], max_new_tokens=2, deadline_ms=1e-3)
    time.sleep(0.01)
    fault_mod.arm("generation_step_fail", at=0, times=1)
    try:
        sched.drain()
    finally:
        fault_mod.disarm()
    out["chaos"] = [[int(t) for t in f.result(1)] for f in futs]
    with pytest.raises(Exception, match="deadline"):
        expired.result(1)
    shed = sched_cls(make(), autostart=False)
    shed._wait_ewma = 1.0
    shed.submit([BOS])
    with pytest.raises(Exception, match="shed"):
        shed.submit([BOS], deadline_ms=10.0)
    shed.close()
    paged = make(paged=True, num_blocks=6, prefix_cache=True)
    out["paged"] = [[int(t) for t in paged.generate(
        p, max_new_tokens=4, eos_id=-1)]
        for p in (SHARED, SHARED + [11], SHARED[:5], [12, 13, 14, 15, 16])]
    paged.close()
    spec = make(policy=pkg.DecodePolicy(
        speculate_k=3, draft=dict(num_layers=KW["num_layers"])), paged=True)
    fault_mod.arm("decode_draft_mismatch", at=0, times=2)
    try:
        out["spec"] = [int(t) for t in spec.generate(
            [BOS, 5, 7], max_new_tokens=12, eos_id=-1)]
    finally:
        fault_mod.disarm()
    spec.close()
    armed = make(arm=True)
    out["int8"] = [int(t) for t in armed.generate([2, 3], max_new_tokens=4,
                                                  eos_id=-1)]
    armed.close()
    return out


def test_registry_families_equal_reference(weights):
    # Both registries are process-global: a port test file that ran
    # earlier in this process (a bucket-12 prefill, say) leaves children
    # the scripted run below never makes. Drop every child first, so each
    # registry holds this run alone; the families stay registered and the
    # holders resolve their children again.
    metrics.REGISTRY.reset()
    ref_metrics.REGISTRY.reset()
    scope, named = weights
    ref_out = _workload(ref_dec, RefScheduler, ref_faults,
                        lambda **kw: _ref(scope, **kw))
    out = _workload(port_dec, GenerationScheduler, faults,
                    lambda **kw: _port(named, **kw))
    assert out == ref_out
    ours = metrics.REGISTRY.dump()
    theirs = ref_metrics.REGISTRY.dump()
    assert sorted(ours) == FAMILIES
    for name, fam in ours.items():
        ref = theirs[name]
        assert (fam["type"], fam["help"]) == (ref["type"], ref["help"]), name
        assert metrics.REGISTRY.families()[name].labelnames == \
            ref_metrics.REGISTRY.families()[name].labelnames, name
        # label values that carry meaning (not per-object ids) are ones
        # the reference produced too
        for key in ("bucket", "reason", "state", "op", "path"):
            mine = {s["labels"][key] for s in fam["samples"]
                    if key in s["labels"]}
            assert mine <= {s["labels"][key] for s in ref["samples"]
                            if key in s["labels"]}, (name, key)
    for name in ("paddle_generation_failover_total",
                 "paddle_generation_prefix_hits_total",
                 "paddle_generation_kv_block_cows_total",
                 "paddle_generation_kv_pool_evictions_total",
                 "paddle_generation_kv_spec_rollback_blocks_total",
                 "paddle_generation_speculative_drafted_total",
                 "paddle_serving_shed_total",
                 "paddle_serving_deadline_exceeded_total",
                 "paddle_quant_compute_ops_total"):
        assert sum(s["value"] for s in ours[name]["samples"]) > 0, name


def test_registry_parity_after_an_earlier_bucket_12_prefill(weights):
    """The order the driver's workers met: an earlier port test file in
    the same process prefilled a bucket of 12 (a child the scripted run
    never makes) before the parity test ran. The parity test resets both
    registries, so it still holds."""
    port_gen._PREFILLS.labels(bucket=12).inc()
    test_registry_families_equal_reference(weights)
    ours = metrics.REGISTRY.dump()["paddle_generation_prefills_total"]
    assert "12" not in {s["labels"]["bucket"] for s in ours["samples"]}


def _span_names(tracer_events):
    return {(e["name"], tuple(sorted(e.get("args", {}))))
            for e in tracer_events if e["name"].startswith("generation")}


def test_span_names_equal_reference(weights):
    scope, named = weights
    got = {}
    for key, cfg, trc, make, pol in (
            ("port", port_config, tracing, lambda **kw: _port(named, **kw),
             port_dec),
            ("ref", ptpu.config, ref_tracing,
             lambda **kw: _ref(scope, **kw), ref_dec)):
        cfg.set_flags(telemetry=True)
        trc.clear()
        try:
            make().generate([BOS, 5], max_new_tokens=3, eos_id=-1)
            sess = make(policy=pol.DecodePolicy(speculate_k=2), paged=True)
            sess.generate([BOS, 5], max_new_tokens=4, eos_id=-1)
            sess.close()
        finally:
            cfg.set_flags(telemetry=False)
        got[key] = _span_names(trc.events())
    assert got["port"] == got["ref"]
    assert {n for n, _ in got["port"]} == {
        "generationPrefill", "generationStep", "generationVerify"}


def _chaos_events(sched_cls, sessions, fault_mod, cfg, rt):
    cfg.set_flags(request_tracing=True)
    rt.clear()
    try:
        sched = sched_cls(sessions, replay_attempts=4, breaker_failures=1,
                          breaker_cooldown_ms=60000.0, autostart=False)
        futs = [sched.submit(list(p), max_new_tokens=4, eos_id=-1)
                for p in PROMPTS]
        fault_mod.arm("generation_step_fail", at=0, times=1)
        try:
            sched.drain()
        finally:
            fault_mod.disarm()
        [f.result(1) for f in futs]
    finally:
        cfg.set_flags(request_tracing=False)
    return [[(e["name"], tuple(sorted(e.get("attrs") or {})))
             for e in rt.trace_events(tid)] for tid in rt.trace_ids()]


def test_request_trace_events_equal_reference(weights):
    """The same chaos run drained on both packages records the same
    trace events, in the same order, with the same attribute keys."""
    scope, named = weights
    ref = _chaos_events(RefScheduler, [_ref(scope), _ref(scope)],
                        ref_faults, ptpu.config, ref_rtrace)
    ours = _chaos_events(GenerationScheduler, [_port(named), _port(named)],
                         faults, port_config, rtrace)
    assert ours == ref
    names = {n for trace in ours for n, _ in trace}
    assert {"request", "queueWait", "prefill", "decodeStep",
            "faultInjected", "sessionFailure", "failoverRequeue",
            "replayAdmit", "resolve"} <= names


def _sites(path):
    with open(path) as f:
        src = f.read()
    return set(re.findall(r'(?:fire_point|should_fire)\(\s*"(\w+)"', src))


def test_fault_sites_equal_reference():
    port = _sites(os.path.join(ROOT, "paddle_tpu_torch", "serving",
                               "generation.py"))
    ref = _sites(os.path.join(ROOT, "paddle_tpu", "serving",
                              "generation.py"))
    assert port == ref == {
        "generation_step_fail", "generation_admit_fail",
        "generation_session_wedge", "decode_draft_mismatch",
        "decode_constraint_dead_end"}
    with open(os.path.join(ROOT, "paddle_tpu_torch", "resilience",
                           "faults.py")) as f:
        doc = f.read()
    for site in port:
        assert "``%s``" % site in doc, site


# -- metrics ---------------------------------------------------------------

def _script(mod):
    reg = mod.Registry()
    c = reg.counter("x_total", "a counter", labelnames=("k",))
    c.labels(k="a").inc()
    c.labels(k="b\"q").inc(2.5)
    g = reg.gauge("y", "a gauge")
    g.set(3)
    g.dec(0.5)
    h = reg.histogram("z_ms", "a histogram", buckets=mod.LATENCY_MS_BUCKETS)
    for v in (0.05, 3, 7000, 1e9):
        h.observe(v)
    t = reg.histogram("t_seconds", "default buckets", labelnames=("r",))
    t.labels(r="g1:0").observe(0.3)
    t.labels(r="g2:0").observe(0.3)
    reg.remove_labeled("r", prefix="g1:")
    reg.label_cardinality_cap = 2
    for i in range(3):
        c.labels(k=str(i)).inc()
    with pytest.raises(ValueError):
        c.labels(k="a").inc(-1)
    with pytest.raises(ValueError):
        reg.gauge("x_total", "clash", labelnames=("k",))
    with pytest.raises(ValueError):
        c.labels(nope=1)
    return reg


def test_metrics_registry_exposes_as_the_reference():
    ours, ref = _script(metrics), _script(ref_metrics)
    assert ours.expose_text() == ref.expose_text()
    assert ours.dump_json(indent=1) == ref.dump_json(indent=1)
    assert ours.label_evictions == ref.label_evictions > 0
    ours.reset()
    ref.reset()
    assert ours.expose_text() == ref.expose_text()
    assert ours.generation == ref.generation == 1


def test_histogram_bucket_override_rules():
    for mod in (metrics, ref_metrics):
        reg = mod.Registry()
        h = reg.histogram("w", "h")
        assert h.buckets == mod.DEFAULT_TIME_BUCKETS
        reg.set_buckets("w", (1.0, 2.0))
        h.observe(1.5)
        with pytest.raises(ValueError, match="observations"):
            reg.set_buckets("w", (3.0,))
        with pytest.raises(KeyError):
            reg.set_buckets("nope", (1.0,))


# -- logs, spans, traces, flight -------------------------------------------

class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_structured_log_line_as_the_reference():
    got = []
    for mod in (log, ref_log):
        cap = _Capture()
        lg = mod.telemetry_logger()
        lg.addHandler(cap)
        try:
            mod.structured("generation_step_failed", session=0, hang=True,
                           error=RuntimeError("x"), requests=2)
        finally:
            lg.removeHandler(cap)
        got.append(cap.lines)
    assert got[0] == got[1] and len(got[0]) == 1
    event, fields = got[0][0].split(" ", 1)
    assert event == "generation_step_failed"
    assert json.loads(fields)["requests"] == 2
    assert log.logger().name == "paddle_tpu_torch"


def test_host_spans_and_chrome_trace(tmp_path):
    docs = []
    for mod in (tracing, ref_tracing):
        assert mod.span("off") is mod.NULL_SPAN
        tr = mod.Tracer()
        tr.start(clear=True)
        with tr.span("outer", {"a": 1}):
            with tr.span("inner"):
                pass
        tr.instant("mark", {"b": 2})
        tr.stop()
        assert tr.span("after") is mod.NULL_SPAN
        path = tr.emit_chrome_trace(str(tmp_path / (mod.__name__ + ".json")))
        with open(path) as f:
            doc = json.load(f)
        docs.append([(e["ph"], e["name"], sorted(e)) for e in
                     doc["traceEvents"] if e["ph"] != "M"])
        assert doc["displayTimeUnit"] == "ms"
    assert docs[0] == docs[1]
    assert [d[1] for d in docs[0]] == ["inner", "outer", "mark"]


def test_request_tracer_store_and_span_tree():
    shapes = []
    for mod in (rtrace, ref_rtrace):
        tr = mod.RequestTracer()
        assert tr.mint("k") is None          # off
        tr.set_flag(True, sample_rate=0.0)
        assert tr.mint("k") is None          # not sampled
        tr.set_flag(True, sample_rate=1.0)
        ctx = tr.mint("generation.submit", prompt_len=3)
        sid = tr.event(ctx, "prefill", dur_ms=1.0, session=0)
        tr.event(ctx, "decodeStep", parent=sid, slot=1)
        assert tr.event(mod.NO_TRACE, "x") is None
        tree = tr.span_tree(ctx.trace_id)
        root = tree["root"]
        shapes.append((tree["events"], root["name"],
                       [c["name"] for c in root["children"]],
                       [c["name"] for c in root["children"][0]["children"]],
                       sorted(root["attrs"])))
        doc = tr.chrome_trace(ctx.trace_id)
        assert [e["ph"] for e in doc["traceEvents"] if e["ph"] != "M"] == \
            ["i", "X", "i"]
        rejected = tr.mint("k")
        tr.discard(rejected)
        assert tr.trace_ids() == [ctx.trace_id]
    assert shapes[0] == shapes[1]


def test_flight_bundle_as_the_reference(tmp_path):
    bundles = []
    for mod, cfg, sub in ((flight, port_config, "port"),
                          (ref_flight, ptpu.config, "ref")):
        cfg.set_flags(flight_dir=str(tmp_path / sub))
        rec = mod.FlightRecorder(capacity=3)
        rec.record({"name": "dropped"})      # disarmed
        rec.set_armed(True)
        for i in range(5):
            rec.record({"name": "e%d" % i})
        rec.add_context("ctx", lambda: {"k": 1})
        rec.add_context("gone", lambda: None)
        path = rec.trigger("breaker_open", replica="g0:0")
        assert path is not None and rec.trigger("again") is None  # debounce
        with open(path) as f:
            bundle = json.load(f)
        bundles.append(bundle)
        rec.min_interval_sec = 0.0
        rec.max_dumps = 2
        for i in range(3):
            rec.trigger("r%d" % i)
        assert len([n for n in os.listdir(str(tmp_path / sub))
                    if n.endswith(".json")]) == 2
        assert rec.latest()["reason"] == "r2"
        rec.set_armed(False)
    ours, ref = bundles
    assert sorted(ours) == sorted(ref)
    assert [e["name"] for e in ours["events"]] == ["e2", "e3", "e4"] == \
        [e["name"] for e in ref["events"]]
    assert ours["context"] == ref["context"] == {"ctx": {"k": 1}}
    assert ours["attrs"] == ref["attrs"]
    assert set(ours["metrics"]) == set(FAMILIES)


def test_config_hook_arms_tracers_and_refuses_a_port():
    """The hook arms the tracers, and a nonzero ``telemetry_port`` starts
    the HTTP server where the port used to refuse one (0 stops it; a
    taken port is logged, not raised)."""
    import socket
    import urllib.request
    from paddle_tpu_torch.observability import http as port_http
    assert observability._on_flags_changed in port_config._on_change
    port_config.set_flags(request_tracing=True, trace_sample_rate=0.5)
    assert rtrace.enabled() and flight.RECORDER.armed
    assert rtrace._TRACER.sample_rate == 0.5
    port_config.set_flags(telemetry=True)
    assert tracing.active()
    port_config.set_flags(request_tracing=False, telemetry=False)
    assert not rtrace.enabled() and not flight.RECORDER.armed
    assert not tracing.active()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    try:
        port_config.set_flags(telemetry_port=free)
        srv = port_http.active_server()
        assert srv is not None and srv.port == free
        with urllib.request.urlopen(srv.url + "/healthz",
                                    timeout=10) as r:
            assert r.status == 200
        with socket.socket() as taken:
            taken.bind(("127.0.0.1", 0))
            taken.listen()
            port_config.set_flags(telemetry_port=taken.getsockname()[1])
            # the bind failed: the old server stopped, nothing raised
            assert port_http.active_server() is None
    finally:
        port_config.set_flags(telemetry_port=0)
    assert port_http.active_server() is None
    assert port_config.get_flag("telemetry_port") == 0
    port_config.set_flags(fault_injection=False)   # later calls work


# -- faults ----------------------------------------------------------------

def _fault_script(mod, cfg):
    log_ = []
    assert mod.should_fire("generation_step_fail", 0) is None
    mod.arm("generation_step_fail", at=1, times=2)
    assert cfg.get_flag("fault_injection") is True
    log_.append(mod.should_fire("generation_step_fail", 0) is None)
    log_.append(mod.should_fire("generation_step_fail", 1) is not None)
    with pytest.raises(mod.InjectedFault) as err:
        mod.fire_point("generation_step_fail", index=1)
    log_.append(str(err.value))
    log_.append(mod.fire_point("generation_step_fail", index=1))
    mod.arm("generation_admit_fail", times=None, exc=KeyError("k"))
    for _ in range(3):
        with pytest.raises(KeyError):
            mod.fire_point("generation_admit_fail", index=7)
    hits = []
    spec = mod.arm("generation_session_wedge", action="callback",
                   callback=lambda: hits.append(1))
    log_.append(mod.fire_point("generation_session_wedge") is spec)
    log_.append(len(hits))
    log_.append(sorted(mod.armed()))
    mod.disarm("generation_admit_fail")
    log_.append(cfg.get_flag("fault_injection"))
    mod.disarm()
    log_.append(cfg.get_flag("fault_injection"))
    with pytest.raises(ValueError):
        mod.arm("x", action="boom")
    mod.disarm()
    return log_


def test_fault_registry_behaves_as_the_reference():
    assert _fault_script(faults, port_config) == \
        _fault_script(ref_faults, ptpu.config)


def test_poison_feed_dict_as_the_reference_and_packed_raises():
    feed = {"ids": np.arange(3), "x": np.ones((2, 2), np.float32),
            "y": np.ones(2, np.float32)}
    outs = []
    for mod in (faults, ref_faults):
        mod.arm("nan_loss", at=4)
        assert mod.poison_feed(feed, 3) is feed
        outs.append(mod.poison_feed(feed, 4))
        mod.disarm()
    for name in feed:
        np.testing.assert_array_equal(outs[0][name], outs[1][name])
    assert np.isnan(outs[0]["x"]).all() and not np.isnan(outs[0]["y"]).any()
    faults.arm("nan_loss", at=0)
    with pytest.raises(NotImplementedError, match="feed dict"):
        faults.poison_feed([np.ones(2)], 0)


def test_supervisor_names_raise_not_implemented():
    """The supervisor's names resolve (lazily, as the reference's do) to
    the ported module; a name never ported raises AttributeError."""
    from paddle_tpu import resilience as ref_resilience
    for name in port_resilience._SUPERVISOR_EXPORTS:
        assert getattr(port_resilience, name) is getattr(port_sup, name)
    assert port_resilience.__all__ == ref_resilience.__all__
    with pytest.raises(AttributeError):
        port_resilience.nothing_here


# -- breakers, the bounded call, batcher helpers ---------------------------

def _breaker_script(mod):
    states = []
    b = mod.ReplicaBreaker(0, threshold=2, cooldown_sec=0.05,
                           label="t%s:0" % mod.__name__[-3:])
    gauge = mod.REPLICA_HEALTHY.labels(replica=b.label)
    b.record_failure()
    states.append((b.state, gauge.value, b.ready_to_probe()))
    b.record_failure()
    states.append((b.state, gauge.value, b.ready_to_probe()))
    time.sleep(0.06)
    states.append(b.ready_to_probe())
    b.to_half_open()
    states.append(b.state)
    b.record_failure()
    states.append(b.state)
    b.to_half_open()
    states.append(b.state)          # cooldown restarted: still open
    time.sleep(0.06)
    b.to_half_open()
    b.record_success()
    states.append((b.state, gauge.value, b.failures))
    b.record_failure(hang=True)
    states.append(b.state)
    b.retired = True
    b.record_success()
    states.append(gauge.value)      # retired: the gauge stays
    return states


def test_breaker_transitions_as_the_reference():
    assert _breaker_script(sres) == _breaker_script(ref_sres)


def test_run_bounded_as_the_reference():
    for mod in (sres, ref_sres):
        assert mod.run_bounded(lambda: 5, 1.0) == 5
        with pytest.raises(KeyError):
            mod.run_bounded(lambda: {}["x"], 1.0)
        gate = threading.Event()
        with pytest.raises(mod.ServingTimeoutError) as err:
            mod.run_bounded(gate.wait, 0.05, name="t")
        assert not err.value.pending.is_set()
        gate.set()
        assert err.value.pending.wait(1.0)


def test_step_worker_reuses_one_thread_and_reports_a_hang():
    worker = sres.BoundedWorker("generation-step-test")
    try:
        idents = {worker.call(threading.get_ident, 1.0) for _ in range(5)}
        assert len(idents) == 1 and threading.get_ident() not in idents
        with pytest.raises(ZeroDivisionError):
            worker.call(lambda: 1 / 0, 1.0)
        gate = threading.Event()
        with pytest.raises(sres.ServingTimeoutError) as err:
            worker.call(gate.wait, 0.05)
        gate.set()
        assert err.value.pending.wait(1.0)
        assert worker.call(threading.get_ident, 1.0) in idents
    finally:
        worker.stop()
    worker._thread.join(1.0)
    assert not worker._thread.is_alive()


def test_batcher_resolve_and_overload_error():
    from concurrent.futures import Future
    assert issubclass(batcher.ServingOverloadError, RuntimeError)
    assert batcher._WAIT_ALPHA == 0.2
    assert port_gen.ServingOverloadError is batcher.ServingOverloadError
    assert port_gen.ServingDeadlineError is sres.ServingDeadlineError
    f = Future()
    f.cancel()
    batcher._resolve(f, result=1)             # a cancelled client: no-op
    g = Future()
    batcher._resolve(g, exception=ValueError("v"))
    batcher._resolve(g, result=2)             # already resolved: no-op
    with pytest.raises(ValueError):
        g.result(0)


# -- health, pool gauges, the quant counter --------------------------------

def test_scheduler_health_registration(weights):
    sched = GenerationScheduler(_port(weights[1]), autostart=False,
                                breaker_failures=1)
    snap = health.health_snapshot()
    name = "generation%d" % sched._sched_id
    assert snap["components"][name]["healthy"] is True
    assert snap["components"][name]["sessions"] == ["closed"]
    sched._breakers[0].record_failure()
    assert health.health_snapshot()["status"] == "degraded"
    sched.close()
    assert name not in health.health_snapshot()["components"]


def test_pool_gauge_per_pool_and_retired_on_close(weights):
    sess = _port(weights[1], paged=True)
    label = sess.pool._label
    sess.generate([2, 3, 4], max_new_tokens=4, eos_id=-1)
    slot, _ = sess.admit([2, 3, 4, 5, 6])
    gauge = port_pc.BLOCKS_IN_USE.labels(pool=label)
    assert gauge.value == sess.pool.used_count() > 0
    sess.retire(slot)
    assert gauge.value == sess.pool.used_count()
    sess.close()
    assert not [c for c in port_pc.BLOCKS_IN_USE.children().values()
                if c.labels_dict["pool"] == label]


def test_quant_counter_counts_once_per_program_shape(weights):
    """The port's rule for the reference's trace-time counter: an armed
    session counts each of its int8 products once the first time it
    runs each program shape (a prefill bucket, the decode step), never
    again."""
    def count():
        return sum(s["value"] for s in metrics.REGISTRY.dump()
                   ["paddle_quant_compute_ops_total"]["samples"]
                   if s["labels"] == {"op": "mul", "path": "dense"})
    sess = _port(weights[1], arm=True)
    n = len(port_tf.lm_mul_weight_names(KW["num_layers"]))
    c0 = count()
    sess.generate([2, 3], max_new_tokens=4, eos_id=-1)          # bucket 4
    assert count() - c0 == 2 * n
    sess.generate([2, 3, 4], max_new_tokens=4, eos_id=-1)       # again
    assert count() - c0 == 2 * n
    sess.generate(list(range(2, 8)), max_new_tokens=2, eos_id=-1)  # 8
    assert count() - c0 == 3 * n
    plain = _port(weights[1])
    plain.generate([2, 3], max_new_tokens=2, eos_id=-1)
    assert count() - c0 == 3 * n
    assert port_q.QUANT_COMPUTE_OPS.labelnames == ("op", "path")
    assert torch.device(sess.device).type == "cpu"
