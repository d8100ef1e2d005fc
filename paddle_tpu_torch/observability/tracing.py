"""Host-side trace spans, exported as Chrome trace-event JSON
(reference ``paddle_tpu/observability/tracing.py``).

Nestable host spans recorded per thread as complete ("ph":"X") events,
written by ``emit_chrome_trace`` in the Chrome trace-event format: load
the file in Perfetto or chrome://tracing. ``utils/profiler.py`` takes
the device trace beside them (``torch.profiler``).

Hot-path discipline: ``span()`` when the tracer is inactive returns the
preallocated ``NULL_SPAN`` singleton, one attribute check and no
allocation. Events live in a bounded ring buffer so always-on telemetry
(config flag ``telemetry``) cannot grow memory without bound.

Nesting is positional, as in chrome://tracing: two "X" events on the
same pid/tid nest iff one's [ts, ts+dur] window contains the other's.
"""

import collections
import contextlib
import json
import os
import threading
import time

__all__ = ["span", "instant", "start", "stop", "active", "clear",
           "events", "emit_chrome_trace", "chrome_trace_doc",
           "NULL_SPAN", "MAX_EVENTS"]

MAX_EVENTS = 200_000  # ring-buffer bound for always-on tracing


class _NullSpan:
    """Singleton no-op context manager: the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer, name, args):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer._record(self.name, self._t0, t1, self.args)
        return False


class Tracer:
    def __init__(self):
        self.enabled = False
        self._flag_enabled = False      # mirror of config flag "telemetry"
        self._explicit = 0              # nested start()/stop() holds
        self._events = collections.deque(maxlen=MAX_EVENTS)
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()

    # -- lifecycle -------------------------------------------------------
    def _sync_enabled(self):
        self.enabled = self._flag_enabled or self._explicit > 0

    def start(self, clear=False):
        with self._lock:
            self._explicit += 1
            if clear:
                self._events.clear()
            self._sync_enabled()

    def stop(self):
        with self._lock:
            self._explicit = max(0, self._explicit - 1)
            self._sync_enabled()

    def set_flag(self, on):
        """Config-flag hook (observability package syncs ``telemetry``)."""
        with self._lock:
            self._flag_enabled = bool(on)
            self._sync_enabled()

    def clear(self):
        with self._lock:
            self._events.clear()

    # -- recording -------------------------------------------------------
    def span(self, name, args=None):
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, args)

    def _record(self, name, t0, t1, args):
        ev = {"ph": "X", "name": name, "cat": "host",
              "ts": (t0 - self._epoch) * 1e6,
              "dur": (t1 - t0) * 1e6,
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)

    def instant(self, name, args=None):
        if not self.enabled:
            return
        ev = {"ph": "i", "name": name, "cat": "host", "s": "t",
              "ts": (time.perf_counter() - self._epoch) * 1e6,
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)

    # -- export ----------------------------------------------------------
    def now_us(self):
        """Current time on the trace clock (same scale as event ts)."""
        return (time.perf_counter() - self._epoch) * 1e6

    def events(self, ts_from=None, ts_to=None):
        with self._lock:
            evs = list(self._events)
        if ts_from is not None:
            evs = [e for e in evs if e["ts"] >= ts_from]
        if ts_to is not None:
            evs = [e for e in evs if e["ts"] <= ts_to]
        return evs

    def emit_chrome_trace(self, path, ts_from=None, ts_to=None):
        """Write {"traceEvents": [...]} (Perfetto/chrome://tracing);
        optionally windowed to [ts_from, ts_to] on the trace clock."""
        doc = chrome_trace_doc(self.events(ts_from, ts_to))
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


def chrome_trace_doc(evs, process_name="paddle_tpu_torch host",
                     thread_names=None):
    """The chrome-trace document wrapper shared by the host-op tracer
    and the request-trace exporter: prepends process/thread "M"
    metadata to already-shaped trace events. ``thread_names`` maps
    tid -> display name (default ``host-<tid>``)."""
    tids = {}
    for ev in evs:
        tids.setdefault(ev.get("tid", 0), ev.get("pid", os.getpid()))
    meta = [{"ph": "M", "name": "process_name", "pid": os.getpid(),
             "tid": 0, "args": {"name": process_name}}]
    for tid, pid in sorted(tids.items(),
                           key=lambda kv: (isinstance(kv[0], str),
                                           kv[0])):
        name = (thread_names or {}).get(tid, "host-%s" % tid)
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": tid, "args": {"name": name}})
    return {"traceEvents": meta + list(evs), "displayTimeUnit": "ms"}


_TRACER = Tracer()


def span(name, **args):
    """``with span("feed"): ...`` — NULL_SPAN when tracing is off."""
    return _TRACER.span(name, args or None)


def instant(name, **args):
    _TRACER.instant(name, args or None)


def start(clear=False):
    _TRACER.start(clear=clear)


def stop():
    _TRACER.stop()


def active():
    return _TRACER.enabled


def clear():
    _TRACER.clear()


def events(ts_from=None, ts_to=None):
    return _TRACER.events(ts_from, ts_to)


def now_us():
    return _TRACER.now_us()


def emit_chrome_trace(path, ts_from=None, ts_to=None):
    return _TRACER.emit_chrome_trace(path, ts_from, ts_to)


@contextlib.contextmanager
def trace(path=None, clear_first=True):
    """Bounded capture: start tracing, yield the tracer, optionally write
    the Chrome trace on exit."""
    start(clear=clear_first)
    try:
        yield _TRACER
    finally:
        stop()
        if path is not None:
            emit_chrome_trace(path)
