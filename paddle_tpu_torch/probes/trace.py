"""Request tracing through a live failover, and its cost (reference
``tools/trace_probe.py``).

    python3 -m paddle_tpu_torch.probes.trace
        [--model small|small-h64|flagship] [--device cpu]

1. ``tracing_overhead``: the same 12-request generation workload (12 new
   tokens each, two sessions of 4 slots behind one
   ``GenerationScheduler``) with ``request_tracing`` off and on (sample
   rate 1.0), in turns within each of 7 rounds on one warm
   scheduler; medians, and the tokens equal in both modes.
2. ``failover_trace``: with a persistent step fault on session 0 and
   replay armed (4 attempts, breaker at 1 failure), every request
   completes token for token as without it; the introspection server
   (the ``telemetry_port`` flag) serves ``/debug/trace?id=`` of a
   replayed request, whose span tree shows the hop
   ``sessionFailure`` -> ``failoverRequeue`` -> ``replayAdmit`` across
   the two sessions under one trace id.
3. ``flight_recorder``: the breaker's opening dumped a bundle, read back
   through ``/debug/flight``.

``--model small`` is the reference's LM (vocab 64, d_model 128, 4 heads,
d_ff 256, 2 layers), CPU only: its 32-wide heads are narrower than the
attention kernels take; ``small-h64`` those widths in 2 heads of 64,
the small LM's run on the card; ``flagship`` the flagship LM's widths
(vocab 32768, d_model 2048, 16 heads, d_ff 8192, 12 layers); 48
positions, prompt buckets 8, 16, 32; weights the reference's seed-7
standard normals. Each line is one JSON object under the reference's
keys; the run fails if a check does.
"""

import argparse
import json
import os
import socket
import sys
import time
import urllib.request

import numpy as np

from .. import config
from ..models.transformer import transformer_lm_session
from ..observability import flight
from ..observability import request_trace as rtrace
from ..resilience import faults
from ..serving.generation import GenerationScheduler, GenerationSession
from .common import (LM_MODELS, check, launch_counts, launches_since,
                     lm_scope, lm_widths, probe_device)

VOCAB = 64
KW = dict(d_model=128, num_heads=4, d_ff=256, num_layers=2)
BOS, EOS = 0, 1
N_REQUESTS = 12
MAX_NEW = 12
MAX_LEN = 48
PROMPT_BUCKETS = (8, 16, 32)
SLOTS = 4


def make_session(scope, vocab, kw, device):
    spec = transformer_lm_session(
        vocab, max_len=MAX_LEN, slots=SLOTS, cache_len=MAX_LEN,
        prompt_buckets=PROMPT_BUCKETS, bos_id=BOS, eos_id=EOS,
        device=device, **kw)
    sess = GenerationSession(spec, scope=scope)
    sess.generate([BOS], max_new_tokens=2, eos_id=-1)  # warm
    return sess


def prompts(vocab, n=N_REQUESTS):
    rs = np.random.RandomState(11)
    return [[BOS] + list(rs.randint(2, vocab, size=1 + (i % 5)))
            for i in range(n)]


def run_workload(sched, ps, max_new=MAX_NEW):
    futs = [sched.submit(p, max_new_tokens=max_new, eos_id=-1) for p in ps]
    return [[int(t) for t in f.result(timeout=600)] for f in futs]


def measure_overhead(sessions, ps, rounds=7, max_new=MAX_NEW):
    """(median s off, median s on, tokens): the workload with tracing
    off and on in turns within each round, on one warm scheduler; the
    tokens equal in both modes."""
    sched = GenerationScheduler(sessions)
    try:
        run_workload(sched, ps, max_new)  # warm the scheduler path
        t_off, t_on = [], []
        out = None
        for _ in range(rounds):
            config.set_flags(request_tracing=False)
            t0 = time.perf_counter()
            out_off = run_workload(sched, ps, max_new)
            t_off.append(time.perf_counter() - t0)
            config.set_flags(request_tracing=True, trace_sample_rate=1.0)
            t0 = time.perf_counter()
            out = run_workload(sched, ps, max_new)
            t_on.append(time.perf_counter() - t0)
            check(out == out_off, "tracing changed tokens")
        return float(np.median(t_off)), float(np.median(t_on)), out
    finally:
        sched.close()


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def http_json(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.load(resp)


def _walk(node):
    yield node
    for child in node.get("children", ()):
        yield from _walk(child)


def failover(sessions, ps, base, base_url, max_new=MAX_NEW):
    """The chaos run over ``sessions`` (fresh) and what the server says
    of it: (failover_trace doc, flight_recorder doc)."""
    sched = GenerationScheduler(sessions, replay_attempts=4,
                                breaker_failures=1,
                                breaker_cooldown_ms=60000.0)
    try:
        faults.arm("generation_step_fail", at=0, times=None)  # broken
        got = run_workload(sched, ps, max_new)
    finally:
        faults.disarm()
        sched.close()
    check(got == base, "chaos run must be token-identical (got %r)" % (got,))
    health = http_json(base_url + "/healthz")
    replayed = None
    for tid in rtrace.trace_ids():
        names = [e["name"] for e in rtrace.trace_events(tid) or ()]
        if "failoverRequeue" in names:
            replayed = tid
            break
    check(replayed is not None, "no request replayed: fault not hit?")
    tree = http_json(base_url + "/debug/trace?id=" + replayed)
    events = list(_walk(tree["root"]))
    by_name = {}
    for ev in events:
        by_name.setdefault(ev["name"], []).append(ev)
    check(all(ev.get("trace_id") in (replayed, None) for ev in events),
          "span tree mixed trace ids")
    fail = by_name["sessionFailure"][0]["attrs"]
    hop = by_name["replayAdmit"][0]["attrs"]
    check(fail["session"] != hop["session"],
          "failover hop must cross sessions (%r -> %r)" % (fail, hop))
    check("failoverRequeue" in by_name and "resolve" in by_name,
          "the span tree lacks failoverRequeue or resolve: %s"
          % sorted(by_name))
    trace_doc = {
        "probe": "failover_trace", "trace_id": replayed,
        "events": tree["events"],
        "hop": {"from_session": fail["session"],
                "to_session": hop["session"],
                "journal_len": hop["journal_len"]},
        "span_names": sorted(by_name),
        "healthz": health["status"]}
    # the breaker's dump is written on a thread of its own
    deadline = time.monotonic() + 10
    while flight.RECORDER.latest() is None and time.monotonic() < deadline:
        time.sleep(0.02)
    bundle = http_json(base_url + "/debug/flight")
    path = flight.RECORDER.last_dump_path
    flight_doc = {
        "probe": "flight_recorder", "dump_path": path,
        "reason": bundle["reason"], "ring_events": len(bundle["events"]),
        "config_fingerprint_keys": len(bundle["config"])}
    check(path is not None and os.path.exists(path),
          "no flight bundle on disk: %r" % (path,))
    return trace_doc, flight_doc


def run(vocab, kw, device, rounds=7, n_requests=N_REQUESTS, max_new=MAX_NEW):
    """The probe's three docs and the final one, and the baseline's
    tokens. The flags and the recorder's debounce are restored after."""
    scope = lm_scope(vocab, kw, MAX_LEN, device)[0]
    ps = prompts(vocab, n_requests)
    before = launch_counts()
    interval = flight.RECORDER.min_interval_sec
    try:
        t_off, t_on, base = measure_overhead(
            [make_session(scope, vocab, kw, device) for _ in range(2)], ps,
            rounds, max_new)
        overhead_pct = (t_on - t_off) / t_off * 100.0
        docs = [{"probe": "tracing_overhead", "t_off_s": t_off,
                 "t_on_s": t_on, "overhead_pct": overhead_pct}]
        port = free_port()
        config.set_flags(telemetry_port=port)
        flight.RECORDER.min_interval_sec = 0.0
        rtrace.clear()
        docs += failover(
            [make_session(scope, vocab, kw, device) for _ in range(2)], ps,
            base, "http://127.0.0.1:%d" % port, max_new)
    finally:
        config.set_flags(request_tracing=False, telemetry_port=0)
        flight.RECORDER.min_interval_sec = interval
    docs.append({"probe": "trace_probe", "ok": True, "requests": n_requests,
                 "overhead_pct": overhead_pct,
                 "flight_dump": docs[-1]["dump_path"]})
    docs.append({"probe": "launches", **launches_since(before)})
    return docs, base


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="small", choices=LM_MODELS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = probe_device(args.device)
    if device is None:
        return 1
    try:
        vocab, kw = lm_widths(args.model, VOCAB, KW, device)
    except ValueError as exc:
        print(exc, file=sys.stderr)
        return 2
    print(json.dumps({"model": args.model, "vocab": vocab, **kw}), flush=True)
    docs, _ = run(vocab, kw, device)
    for doc in docs:
        print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
