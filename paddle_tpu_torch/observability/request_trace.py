"""Request-scoped tracing for the serving tier (reference
``paddle_tpu/observability/request_trace.py``).

``tracing.py`` answers "what is this process doing"; this module answers
"what happened to this request?". One :class:`TraceContext` (trace id +
root span id + baggage) is minted at ``GenerationScheduler.submit``,
carried on the queue item (which for generation is the replay journal,
so a failover hop keeps its trace), and stamped onto typed span events
at every lifecycle edge: queue wait, admit/prefill (with the
prefix-cache hit length), each decode-step batch, copy-on-write block
copies, preemption and re-queue, replay failover hops (old session ->
new session, journal length), rebuild hand-overs, breaker transitions,
deadline expiry, injected faults and the resolution.
``span_tree(trace_id)`` reconstructs the request's life.

Hot-path discipline: recording is armed by the ``request_tracing``
config flag with ``trace_sample_rate`` sampling, synced into
``_TRACER.enabled`` by the observability config hook; call sites check
an attribute or a ``ctx is None``, never ``config.get_flag``. Disabled,
``mint()`` is one attribute read returning None and every event site is
a None check.

The per-stage latency histograms below are always on, like every
serving front-door metric: they fire once per request (or per decode
step), in the log-spaced millisecond buckets of
``metrics.LATENCY_MS_BUCKETS``.

Context propagation across threads: ``activate(ctx)`` sets a
thread-local that ``current()`` reads; the generation dispatcher
activates around each admission and each inline session step.

Every recorded event is also offered to the flight recorder
(``observability/flight.py``), whose bounded ring is what an auto-dump
snapshots.
"""

import collections
import itertools
import os
import random
import threading
import time

from . import flight as _flight
from . import metrics as _metrics

__all__ = ["TraceContext", "NO_TRACE", "mint", "adopt", "event",
           "global_event",
           "discard", "current", "activate", "trace_events", "span_tree",
           "chrome_trace", "trace_ids", "enabled", "clear",
           "QUEUE_WAIT_MS",
           "PREFILL_MS", "DECODE_STEP_MS", "REPLAY_RECOVERY_MS",
           "E2E_MS"]

# -- always-on per-stage latency histograms (ms, log-spaced) -----------
QUEUE_WAIT_MS = _metrics.REGISTRY.histogram(
    "paddle_request_queue_wait_ms",
    "Submit -> dispatch/admission wait per request (serving batcher "
    "and generation scheduler front doors)",
    buckets=_metrics.LATENCY_MS_BUCKETS)
PREFILL_MS = _metrics.REGISTRY.histogram(
    "paddle_request_prefill_ms",
    "Prompt (or replay-journal) prefill wall time per admission",
    buckets=_metrics.LATENCY_MS_BUCKETS)
DECODE_STEP_MS = _metrics.REGISTRY.histogram(
    "paddle_request_decode_step_ms",
    "One decode step for all of a session's active slots",
    buckets=_metrics.LATENCY_MS_BUCKETS)
REPLAY_RECOVERY_MS = _metrics.REGISTRY.histogram(
    "paddle_request_replay_recovery_ms",
    "Session failure -> the replayed request decoding again "
    "(re-queue wait + replay prefill), per failover hop",
    buckets=_metrics.LATENCY_MS_BUCKETS)
E2E_MS = _metrics.REGISTRY.histogram(
    "paddle_request_e2e_ms",
    "Submit -> successful Future resolution per request",
    buckets=_metrics.LATENCY_MS_BUCKETS)


class TraceContext:
    """One request's trace identity: carried on the queue item / replay
    journal, never re-minted across failover hops — that is the whole
    point."""

    __slots__ = ("trace_id", "span_id", "baggage")

    def __init__(self, trace_id, span_id, baggage=None):
        self.trace_id = trace_id
        self.span_id = span_id      # the root ("request") span
        self.baggage = baggage or {}

    def __repr__(self):
        return "TraceContext(%s)" % self.trace_id


# Sentinel a front door activates when its request was NOT sampled:
# downstream layers (the engine under a batcher flush) must treat it
# as "a sampling decision was already made — don't mint your own",
# not as "no front door above me". trace_id=None marks it inert:
# event()/global_event() record nothing under it.
NO_TRACE = TraceContext(None, 0)

_TLS = threading.local()


class _Activation:
    """``with activate(ctx): ...`` — sets the thread-local current
    context (restoring the previous one on exit) so deeper layers
    (executor device calls, fault hooks) attribute their events to the
    request being served. Cheap enough for per-request use; safe with
    ctx=None (explicitly clears, e.g. around a batch with no sampled
    member)."""

    __slots__ = ("ctx", "prev")

    def __init__(self, ctx):
        self.ctx = ctx

    def __enter__(self):
        self.prev = getattr(_TLS, "ctx", None)
        _TLS.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        _TLS.ctx = self.prev
        return False


def activate(ctx):
    return _Activation(ctx)


def current():
    """The thread's active TraceContext, or None. An attribute read —
    legal on the hottest paths."""
    return getattr(_TLS, "ctx", None)


class RequestTracer:
    """Bounded in-memory trace store + event mint.

    ``_traces`` maps trace_id -> {"events": [...], "dropped": int},
    insertion-ordered; past MAX_TRACES the oldest trace is evicted
    whole (a scrape-window store, not an archive — ship dumps to keep
    them). Per-trace event lists are bounded too: a runaway generation
    cannot grow host memory, it just starts counting drops.
    """

    MAX_TRACES = 512
    MAX_EVENTS_PER_TRACE = 4096

    def __init__(self):
        self.enabled = False
        self.sample_rate = 1.0
        self._traces = collections.OrderedDict()
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._span_seq = itertools.count(1)
        self._rand = random.Random()

    # -- lifecycle (config hook) ----------------------------------------
    def set_flag(self, on, sample_rate=None):
        with self._lock:
            self.enabled = bool(on)
            if sample_rate is not None:
                self.sample_rate = float(sample_rate)

    def clear(self):
        with self._lock:
            self._traces.clear()

    # -- recording -------------------------------------------------------
    def _now_ms(self):
        return (time.perf_counter() - self._epoch) * 1e3

    def _new_span_id(self):
        # plain ints: unique per process, JSON-clean, and ~3x cheaper
        # than a formatted string on the per-token event path
        return next(self._span_seq)

    def _ensure_trace_locked(self, trace_id):
        """Register ``trace_id`` in the bounded store (caller holds
        the lock): the one place the store-insertion and eviction
        policy lives."""
        rec = self._traces.get(trace_id)
        if rec is None:
            rec = {"events": [], "dropped": 0}
            self._traces[trace_id] = rec
            while len(self._traces) > self.MAX_TRACES:
                self._traces.popitem(last=False)
        return rec

    def mint(self, kind, **baggage):
        """A fresh TraceContext for one request (with its root event),
        or None when tracing is off / the request was not sampled —
        the per-request entry point, one attribute read when off."""
        if not self.enabled:
            return None
        if self.sample_rate < 1.0 and \
                self._rand.random() >= self.sample_rate:
            return None
        with self._lock:
            # 64 random bits: at a 512-trace store even sustained
            # traffic can't realistically collide (a collision would
            # silently merge two requests' span trees)
            trace_id = "t%016x" % self._rand.getrandbits(64)
            span_id = self._new_span_id()
            self._ensure_trace_locked(trace_id)
        ctx = TraceContext(trace_id, span_id, dict(baggage))
        self._record(ctx, span_id, None, "request", None,
                     dict(baggage, kind=kind))
        return ctx

    def adopt(self, trace_id, kind, **baggage):
        """A TraceContext bound to a trace id minted in another process
        (wire propagation: the fleet router sends its id in the request
        envelope and the worker adopts it, so both stores grow the same
        tree). No sampling decision here: the minting side made it, and
        the id's presence on the wire is that decision. None when
        tracing is off here or ``trace_id`` is falsy; otherwise the
        trace is registered (if unseen) and a ``kind`` span rooted in
        it."""
        if not self.enabled or not trace_id:
            return None
        with self._lock:
            self._ensure_trace_locked(trace_id)
            span_id = self._new_span_id()
        ctx = TraceContext(trace_id, span_id, dict(baggage))
        self._record(ctx, span_id, None, kind, None,
                     dict(baggage, kind=kind, adopted=True))
        return ctx

    def _record(self, ctx, span_id, parent_id, name, dur_ms, attrs):
        # built lean on purpose: this runs once per lifecycle edge of
        # every sampled request. No rounding, no thread-name resolution:
        # raw floats and the ident serialize fine.
        ev = {"trace_id": ctx.trace_id, "span_id": span_id,
              "parent_id": parent_id, "name": name,
              "ts_ms": self._now_ms(),
              "thread": threading.get_ident()}
        if dur_ms is not None:
            ev["dur_ms"] = dur_ms
        if attrs:
            ev["attrs"] = attrs
        # lock-free append: dict.get and list.append are GIL-atomic;
        # the one racing mutation is mint() evicting a whole trace,
        # after which appends land on the orphaned list — harmless.
        # The bound check is approximate under races, which a bound
        # tolerates by construction.
        rec = self._traces.get(ctx.trace_id)
        if rec is not None:
            if len(rec["events"]) < self.MAX_EVENTS_PER_TRACE:
                rec["events"].append(ev)
            else:
                rec["dropped"] += 1
        _flight.RECORDER.record(ev)
        return ev

    def event(self, ctx, name, dur_ms=None, parent=None, **attrs):
        """Record one typed span event under ``ctx`` (no-op on None
        and on the NO_TRACE sentinel). Returns the new span id, so a
        caller can parent further events under this one."""
        if ctx is None or ctx.trace_id is None:
            return None
        span_id = self._new_span_id()
        self._record(ctx, span_id, parent or ctx.span_id, name, dur_ms,
                     attrs or None)
        return span_id

    def global_event(self, name, **attrs):
        """An event not owned by one request (breaker transition,
        rebuild, pool eviction): lands on the ACTIVE request's trace
        when one is set, and always on the flight ring when armed.
        One/two attribute checks when everything is off."""
        ctx = current()
        if ctx is not None and ctx.trace_id is not None:
            return self.event(ctx, name, **attrs)
        if not (self.enabled or _flight.RECORDER.armed):
            return None
        ev = {"trace_id": None, "span_id": self._new_span_id(),
              "parent_id": None, "name": name,
              "ts_ms": self._now_ms(),
              "thread": threading.get_ident()}
        if attrs:
            ev["attrs"] = attrs
        _flight.RECORDER.record(ev)
        return None

    def discard(self, ctx):
        """Forget a minted trace whose request never entered the
        system (admission rejected: full queue, closed race). A
        rejection storm must not churn real in-flight traces out of
        the bounded store with root-only orphans."""
        if ctx is None or ctx.trace_id is None:
            return
        with self._lock:
            self._traces.pop(ctx.trace_id, None)

    # -- introspection ---------------------------------------------------
    def trace_events(self, trace_id):
        """A copy of one trace's event list (oldest first), or None."""
        with self._lock:
            rec = self._traces.get(trace_id)
            if rec is None:
                return None
            return list(rec["events"])

    def dropped(self, trace_id):
        with self._lock:
            rec = self._traces.get(trace_id)
            return 0 if rec is None else rec["dropped"]

    def trace_ids(self):
        """Known trace ids, oldest first."""
        with self._lock:
            return list(self._traces)

    def span_tree(self, trace_id):
        """The request's span tree: each event grows a ``children``
        list; events whose parent is unknown (evicted, or a global
        event adopted mid-request) attach to the root. None for an
        unknown trace."""
        events = self.trace_events(trace_id)
        if events is None:
            return None
        nodes = {}
        for ev in events:
            node = dict(ev)
            node["children"] = []
            nodes[ev["span_id"]] = node
        root, orphans = None, []
        for ev in events:
            node = nodes[ev["span_id"]]
            parent = ev.get("parent_id")
            if parent is None and root is None:
                root = node
                continue
            pnode = nodes.get(parent)
            if pnode is not None and pnode is not node:
                pnode["children"].append(node)
            else:
                orphans.append(node)
        if root is None:
            # root event evicted by the per-trace bound: synthesize
            root = {"trace_id": trace_id, "span_id": None,
                    "parent_id": None, "name": "request",
                    "children": []}
        for node in orphans:
            root["children"].append(node)
        return {"trace_id": trace_id, "dropped": self.dropped(trace_id),
                "events": len(events), "root": root}

    def chrome_trace(self, trace_id):
        """One request trace as a Perfetto-loadable chrome-trace
        document (``tracing.chrome_trace_doc`` wraps it): events with
        a duration render as complete ("X") slices, point events as
        instants ("i"), lanes keyed by the recording pid and thread.
        None for an unknown trace."""
        events = self.trace_events(trace_id)
        if events is None:
            return None
        from . import tracing as _tracing
        out = []
        tids = {}
        names = {}
        for ev in events:
            attrs = ev.get("attrs") or {}
            pid = attrs.get("pid", os.getpid())
            thread = ev.get("thread", 0)
            tid = tids.setdefault((pid, thread), len(tids))
            names.setdefault(
                tid, "pid%s-t%s" % (pid, str(thread)[-4:]))
            args = dict(attrs)
            args["span_id"] = ev.get("span_id")
            if ev.get("parent_id") is not None:
                args["parent_id"] = ev["parent_id"]
            ce = {"name": ev.get("name", "?"), "pid": pid,
                  "tid": tid, "ts": float(ev["ts_ms"]) * 1e3,
                  "cat": "request", "args": args}
            dur = ev.get("dur_ms")
            if dur is not None:
                # a duration event closes AT ts: open the slice back
                # at its start so the timeline reads causally
                ce["ph"] = "X"
                ce["dur"] = float(dur) * 1e3
                ce["ts"] -= ce["dur"]
            else:
                ce["ph"] = "i"
                ce["s"] = "t"
            out.append(ce)
        return _tracing.chrome_trace_doc(
            out, process_name="paddle_tpu_torch request %s" % trace_id,
            thread_names=names)


_TRACER = RequestTracer()


def mint(kind, **baggage):
    return _TRACER.mint(kind, **baggage)


def adopt(trace_id, kind, **baggage):
    return _TRACER.adopt(trace_id, kind, **baggage)


def event(ctx, name, dur_ms=None, parent=None, **attrs):
    return _TRACER.event(ctx, name, dur_ms=dur_ms, parent=parent,
                         **attrs)


def global_event(name, **attrs):
    return _TRACER.global_event(name, **attrs)


def discard(ctx):
    _TRACER.discard(ctx)


def trace_events(trace_id):
    return _TRACER.trace_events(trace_id)


def span_tree(trace_id):
    return _TRACER.span_tree(trace_id)


def chrome_trace(trace_id):
    return _TRACER.chrome_trace(trace_id)


def trace_ids():
    return _TRACER.trace_ids()


def enabled():
    return _TRACER.enabled


def clear():
    _TRACER.clear()
