"""Crash-scoped flight recorder (reference
``paddle_tpu/observability/flight.py``): a bounded ring of recent span
events that auto-dumps a self-contained post-mortem bundle.

The recorder keeps the last few thousand request-trace events cheaply
(one armed check and a deque append per event) and
:meth:`FlightRecorder.trigger` snapshots them to a JSON bundle on:

* any client-visible error (every exceptional Future resolution of the
  serving tier funnels through ``serving.batcher._resolve``),
* a breaker opening (``serving.resilience.ReplicaBreaker``),
* a session rebuild (``serving.generation``),
* SIGTERM (installed once when armed; chains the prior handler).

A bundle is ``{reason, attrs, time, pid, config, events, metrics,
context}``: events from the ring, ``metrics`` a full registry snapshot
(``metrics.REGISTRY.dump()``), ``config`` the flag fingerprint. It is
written atomically (tmp + rename) under the ``flight_dir`` flag
(default: ``<tempdir>/paddle_tpu_torch_flight``), bounded to the newest
``max_dumps`` files, and the latest bundle stays in memory
(:meth:`FlightRecorder.latest`).

Dumps are debounced (``min_interval_sec``): a failure storm produces one
bundle per window. The armed state follows the ``request_tracing``
config flag through the observability package's change hook; disarmed,
``record`` and ``trigger`` are one attribute check.
"""

import collections
import json
import os
import signal
import tempfile
import threading
import time

__all__ = ["FlightRecorder", "RECORDER"]


def _config_fingerprint():
    from .. import config as _config
    out = {}
    for k, v in sorted(_config._flags.items()):
        out[k] = v if isinstance(v, (bool, int, float, str,
                                     type(None))) else repr(v)
    return out


class FlightRecorder:
    """Bounded event ring + debounced JSON bundle dumps."""

    def __init__(self, capacity=4096):
        self.armed = False
        self.capacity = int(capacity)
        self.ring = collections.deque(maxlen=self.capacity)
        self.min_interval_sec = 1.0
        self.max_dumps = 8
        self.last_dump_path = None
        self._last_bundle = None
        # None: never dumped, so the first trigger dumps whatever the
        # monotonic clock reads (it counts from the host's boot: the
        # reference's 0.0 debounces a first trigger on a host up for
        # less than ``min_interval_sec``)
        self._last_dump_t = None
        # RLock, not Lock: the SIGTERM handler calls dump() on
        # whatever thread the signal interrupts — if that frame was
        # already inside one of these critical sections, a plain lock
        # would deadlock the very shutdown path the handler serves
        self._lock = threading.RLock()
        self._sigterm_installed = False
        self.dumps_total = 0
        self.dump_failures = 0
        self._dump_seq = 0
        self._contexts = {}  # name -> zero-arg context callable

    # -- lifecycle (config hook) ----------------------------------------
    def set_armed(self, on):
        on = bool(on)
        self.armed = on
        if on:
            self._install_sigterm()

    def record(self, ev):
        """Offer one span event to the ring (deque append is
        GIL-atomic; the bound makes always-armed safe)."""
        if self.armed:
            self.ring.append(ev)

    def clear(self):
        self.ring.clear()

    # -- contexts --------------------------------------------------------
    def add_context(self, name, fn):
        """Attach a named context callable: its dict lands under
        ``bundle["context"][name]`` in every dump. ``fn`` returning
        None (owner gone — register a weakref closure) drops the
        context lazily; a raising ``fn`` contributes its error."""
        with self._lock:
            self._contexts[name] = fn

    def remove_context(self, name):
        with self._lock:
            self._contexts.pop(name, None)

    def _context_snapshot(self):
        with self._lock:
            items = list(self._contexts.items())
        out = {}
        for name, fn in items:
            try:
                doc = fn()
            except Exception as exc:
                out[name] = {"error": repr(exc)[:200]}
                continue
            if doc is None:
                self.remove_context(name)
                continue
            out[name] = doc
        return out

    # -- dumping ---------------------------------------------------------
    def _dump_dir(self):
        from .. import config as _config
        d = _config.get_flag("flight_dir")
        if not d:
            d = os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_flight")
        os.makedirs(d, exist_ok=True)
        return d

    def _debounced(self, now):
        """Does a dump within ``min_interval_sec`` before ``now`` hold
        the window? (Never dumped: no.) Called under the lock."""
        return self._last_dump_t is not None and \
            now - self._last_dump_t < self.min_interval_sec

    def trigger(self, reason, **attrs):
        """Debounced dump: at most one bundle per ``min_interval_sec``
        window — a failure storm yields one post-mortem, not one per
        victim. Returns the bundle path, or None (disarmed /
        debounced). A FAILED dump refunds its debounce claim, so a
        transient write error (disk full at the worst moment) doesn't
        silence the rest of the incident window too."""
        if not self.armed:
            return None
        now = time.monotonic()
        with self._lock:
            if self._debounced(now):
                return None
            prev_t, self._last_dump_t = self._last_dump_t, now
        path = self.dump(reason, **attrs)
        if path is None:
            with self._lock:
                if self._last_dump_t == now:  # nobody dumped since
                    self._last_dump_t = prev_t
        return path

    def dump(self, reason, **attrs):
        """Write the bundle unconditionally (the SIGTERM handler and
        tests call this directly; ``trigger`` is the debounced
        production entry). Never raises — a failing flight dump must
        not worsen the incident it is recording."""
        from . import metrics as _metrics
        try:
            bundle = {
                "reason": reason,
                "attrs": {k: (v if isinstance(
                    v, (bool, int, float, str, type(None))) else repr(v))
                    for k, v in attrs.items()},
                "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
                "pid": os.getpid(),
                "config": _config_fingerprint(),
                "events": list(self.ring),
                "metrics": _metrics.REGISTRY.dump(),
                "context": self._context_snapshot(),
            }
            d = self._dump_dir()
            # the sequence number disambiguates two dumps landing in
            # the same wall-clock second (short debounce windows):
            # os.replace would otherwise silently overwrite the
            # earlier incident's bundle
            with self._lock:
                self._dump_seq += 1
                seq = self._dump_seq
            name = "flight_%d_%s_%03d_%s.json" % (
                os.getpid(), time.strftime("%Y%m%d_%H%M%S"), seq,
                reason)
            path = os.path.join(d, name)
            tmp = path + ".tmp%d" % threading.get_ident()
            with open(tmp, "w") as f:
                json.dump(bundle, f)
            os.replace(tmp, path)
            self._prune(d)
            with self._lock:
                self.last_dump_path = path
                self._last_bundle = bundle
                self.dumps_total += 1
            from ..utils import log as _log
            _log.structured("flight_recorder_dump", reason=reason,
                            path=path, events=len(bundle["events"]))
            return path
        except Exception as exc:
            # never worsen the incident being recorded — but a dump
            # that silently fails leaves an incident with no bundle
            # and no signal, so count and log the failure itself
            self.dump_failures += 1
            try:
                from ..utils import log as _log
                _log.structured("flight_recorder_dump_failed",
                                reason=reason, error=repr(exc)[:200],
                                failures=self.dump_failures)
            except Exception:
                pass
            return None

    def _prune(self, d):
        try:
            now = time.time()
            dumps = []
            for n in os.listdir(d):
                if not n.startswith("flight_"):
                    continue
                path = os.path.join(d, n)
                if n.endswith(".json"):
                    dumps.append(path)
                elif ".json.tmp" in n:
                    # a crash mid-write orphans its temp file; only
                    # age-gated deletion (a concurrent dump's LIVE
                    # temp must survive) keeps the dir bounded
                    try:
                        if now - os.path.getmtime(path) > 60.0:
                            os.unlink(path)
                    except OSError:
                        pass
            dumps.sort(key=os.path.getmtime)
            for path in dumps[:-self.max_dumps]:
                os.unlink(path)
        except OSError:
            pass

    def latest(self):
        """The newest bundle (in memory), or None."""
        with self._lock:
            return self._last_bundle

    # -- SIGTERM ---------------------------------------------------------
    def _install_sigterm(self):
        """Dump on SIGTERM, then chain to whatever handler was there.
        Installable only on the main thread: a config flip from a worker
        thread just skips it."""
        if self._sigterm_installed:
            return
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def _on_term(signum, frame):
                # installed once, but honors the CURRENT armed state:
                # a process that disarmed tracing must not write
                # bundles of a stale ring on shutdown
                if self.armed:
                    self.dump("sigterm")
                if callable(prev):
                    prev(signum, frame)
                elif prev == signal.SIG_DFL:
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, _on_term)
            self._sigterm_installed = True
        except (ValueError, OSError):
            pass  # not the main thread / unsupported platform

    def trigger_async(self, reason, **attrs):
        """The debounced trigger for DISPATCHER-THREAD call sites
        (client errors in ``_resolve``, breaker opens, rebuild
        kicks): the debounce claim is taken inline (cheap, so a storm
        spawns one worker per window, not one per victim) but the
        heavy part of the dump — full registry serialize + disk
        write — runs on a background thread, because stalling the
        single dispatcher behind a contended disk would add write
        latency to every co-resident in-flight request at exactly the
        degraded moment being recorded. The worker refunds the claim
        if the dump fails."""
        if not self.armed:
            return
        now = time.monotonic()
        with self._lock:
            if self._debounced(now):
                return
            prev_t, self._last_dump_t = self._last_dump_t, now

        def work():
            if self.dump(reason, **attrs) is None:
                with self._lock:
                    if self._last_dump_t == now:
                        self._last_dump_t = prev_t

        threading.Thread(target=work, daemon=True,
                         name="flight-dump").start()

    def client_error(self, exc):
        """One client-visible exceptional resolution — the hook
        ``serving.batcher._resolve`` calls. One attribute check when
        disarmed."""
        if self.armed:
            self.trigger_async("client_error", error=repr(exc)[:300],
                               error_type=type(exc).__name__)


RECORDER = FlightRecorder()
