"""Serving-resilience primitives (reference
``paddle_tpu/serving/resilience.py``): errors, replica circuit breakers,
the bounded worker call, the long-lived bounded worker and the half-open
probe loop.

* a request whose deadline has already passed is doomed work: it is
  dropped before it occupies a device (:class:`ServingDeadlineError`);
* a wedged or failing replica (a generation session, an engine replica)
  is quarantined out of dispatch (:class:`ReplicaBreaker`: closed -> open on N consecutive
  failures or a single hang, -> half_open after a cooldown, -> closed
  when a trial succeeds);
* overload is shed early, while the deadline budget can still be
  honoured elsewhere (``serving.batcher.ServingOverloadError``).

Metric-wise everything here is always on: transitions, sheds and
deadline kills flow through the observability registry
unconditionally, under the reference's names. The mechanisms are armed
per scheduler, so the default path stays as it was.
"""

import queue
import threading
import time

from ..observability import flight as _flight
from ..observability import metrics as _metrics
from ..observability import request_trace as _rtrace
from ..utils import log as _log

__all__ = ["ServingDeadlineError", "ServingTimeoutError",
           "ServingUnavailableError", "ReplicaBreaker", "BreakerProbe",
           "BoundedWorker", "run_bounded"]

DEADLINE_EXCEEDED = _metrics.REGISTRY.counter(
    "paddle_serving_deadline_exceeded_total",
    "Requests resolved with ServingDeadlineError (dropped before or "
    "rejected at dispatch)")
SHED = _metrics.REGISTRY.counter(
    "paddle_serving_shed_total",
    "Requests shed at admission (projected queue wait exceeded the "
    "deadline budget, or injected overload)")
TENANT_SHED = _metrics.REGISTRY.counter(
    "paddle_serving_tenant_shed_total",
    "Requests shed at admission attributed to one tenant (quota "
    "rejections at the fleet router, plus worker-side sheds of "
    "tenant-tagged requests) — the per-tenant slice of "
    "paddle_serving_shed_total", labelnames=("tenant",))
FAILOVER = _metrics.REGISTRY.counter(
    "paddle_serving_failover_total",
    "Requests re-dispatched to another replica after an execution "
    "failure or hang")
BREAKER_TRANSITIONS = _metrics.REGISTRY.counter(
    "paddle_serving_breaker_transitions_total",
    "Replica circuit-breaker state entries", labelnames=("state",))
REPLICA_HEALTHY = _metrics.REGISTRY.gauge(
    "paddle_serving_replica_healthy",
    "1 while the replica's breaker is closed (in dispatch rotation)",
    labelnames=("replica",))


class ServingDeadlineError(RuntimeError):
    """The request's absolute deadline passed before it was served."""


class ServingTimeoutError(RuntimeError):
    """A replica execution exceeded the per-call timeout (hang)."""


class ServingUnavailableError(RuntimeError):
    """Every replica's breaker is open — nothing healthy to dispatch to."""


def run_bounded(fn, timeout, name="serving-exec"):
    """Run ``fn()`` on a daemon worker thread bounded by ``timeout``
    seconds — the one structure that survives a wedged device call: a
    hung execution can't be cancelled, so on timeout the worker is
    left to finish (or hang forever) on its own thread and the caller
    gets :class:`ServingTimeoutError` immediately. The error carries
    the worker's done-``Event`` as ``.pending`` so the caller can cap
    leaked threads to one per quarantined unit instead of stacking a
    fresh blocked thread behind every retry.

    On a non-timeout path the worker's return value is returned and
    its exception re-raised unchanged."""
    result = {}
    done = threading.Event()

    def work():
        try:
            result["value"] = fn()
        except BaseException as exc:  # re-raised on the caller
            result["exc"] = exc
        finally:
            done.set()

    worker = threading.Thread(target=work, daemon=True, name=name)
    worker.start()
    if not done.wait(timeout):
        err = ServingTimeoutError(
            "%s exceeded the %.3fs execution timeout" % (name, timeout))
        err.pending = done
        raise err
    if "exc" in result:
        raise result["exc"]
    return result["value"]


class BoundedWorker:
    """One long-lived thread for bounded calls, in place of the
    reference's fresh thread a call (:func:`run_bounded`).

    Kernels B3, B4 and B5 cache their scratch (and B4 its zeroed
    counters) per thread (``ops/_build.py``), so a fresh thread a call
    would allocate both anew, one more launch, every call. A call that
    outlives its timeout raises ``ServingTimeoutError`` carrying the
    job's done-Event as ``.pending``, exactly as :func:`run_bounded`
    does; the thread stays busy with the wedged job (its owner keeps the
    unit out of dispatch until the Event is set) and then serves the
    next call, so a unit (a generation session, an engine replica) never
    holds more than one thread."""

    def __init__(self, name):
        self.name = name
        self._jobs = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            job = self._jobs.get()
            if job is None:
                return
            fn, result, done = job
            try:
                result["value"] = fn()
            except BaseException as exc:  # re-raised on the caller
                result["exc"] = exc
            finally:
                done.set()

    def call(self, fn, timeout):
        result = {}
        done = threading.Event()
        self._jobs.put((fn, result, done))
        if not done.wait(timeout):
            err = ServingTimeoutError(
                "%s exceeded the %.3fs execution timeout"
                % (self.name, timeout))
            err.pending = done
            raise err
        if "exc" in result:
            raise result["exc"]
        return result["value"]

    def stop(self):
        """Let the thread exit once its current job (if any) returns."""
        self._jobs.put(None)


class ReplicaBreaker:
    """Per-replica circuit breaker.

    ``closed`` (healthy, in rotation) -> ``open`` after ``threshold``
    CONSECUTIVE execution failures, or immediately on a single hang
    past the execution timeout (a wedged device is not worth N more
    co-batched victims). ``open`` -> ``half_open`` once ``cooldown``
    seconds have passed (via :meth:`to_half_open`, driven by a trial
    admission or by the engine's background :class:`BreakerProbe`).
    ``half_open`` -> ``closed`` on the next
    success, back to ``open`` on the next failure (cooldown restarts).

    A success in any state resets the consecutive-failure count: the
    threshold distinguishes a dying replica from isolated glitches,
    exactly like the trainer's ``nonfinite_budget``.
    """

    __slots__ = ("index", "threshold", "cooldown", "state", "failures",
                 "opened_at", "label", "retired", "_lock")

    def __init__(self, index, threshold, cooldown_sec, label=None):
        self.index = int(index)
        self.threshold = max(1, int(threshold))
        self.cooldown = float(cooldown_sec)
        self.state = "closed"
        self.failures = 0
        self.opened_at = 0.0
        self.retired = False  # owner closed: stop touching the gauge
        # gauge label: schedulers pass "g<N>:<session>" so two
        # breaker-armed schedulers in one process don't overwrite each
        # other's health state on the shared registry
        self.label = str(index) if label is None else str(label)
        self._lock = threading.Lock()
        REPLICA_HEALTHY.labels(replica=self.label).set(1)

    def _transition(self, new_state):
        self.state = new_state
        BREAKER_TRANSITIONS.labels(state=new_state).inc()
        if not self.retired:
            # a straggler (disowned probe attempt, in-flight run)
            # finishing after its owner closed must not resurrect the
            # gauge child close() just removed
            REPLICA_HEALTHY.labels(replica=self.label).set(
                1 if new_state == "closed" else 0)
        _log.structured("serving_breaker", replica=self.index,
                        state=new_state, failures=self.failures)
        # a transition lands on the request being served (it caused
        # it) when tracing sampled one, always on the flight ring when
        # armed — in-memory appends, safe under the breaker lock the
        # callers hold. The flight DUMP (registry snapshot + file
        # write) is NOT: record_failure fires it after release.
        _rtrace.global_event("breakerTransition", replica=self.label,
                            state=new_state, failures=self.failures)

    def record_success(self):
        with self._lock:
            self.failures = 0
            if self.state != "closed":
                self._transition("closed")

    def record_failure(self, hang=False):
        opened = False
        with self._lock:
            self.failures += 1
            if (hang or self.state == "half_open"
                    or self.failures >= self.threshold):
                if self.state != "open":
                    self._transition("open")
                    opened = True
                self.opened_at = time.monotonic()
        if opened:
            # incident-grade: snapshot the flight ring while the
            # lead-up events are still in it. Async — outside the
            # lock AND off this thread: record_failure runs on the
            # serving/generation dispatchers, which must not stall
            # behind a registry serialize + disk write mid-incident.
            _flight.RECORDER.trigger_async("breaker_open",
                                           replica=self.label,
                                           failures=self.failures)

    def ready_to_probe(self, now=None):
        if self.state != "open":
            return False
        now = time.monotonic() if now is None else now
        return now - self.opened_at >= self.cooldown

    def to_half_open(self):
        with self._lock:
            if self.state == "open":
                self._transition("half_open")


class BreakerProbe(threading.Thread):
    """Background half-open prober: for every breaker past its cooldown,
    transition to half_open and run ``probe_fn(replica_index)`` (the
    engine re-executes a warmed bucket there); success re-admits the
    replica, failure re-opens with a fresh cooldown. Daemon, started
    lazily by the engine the first time any breaker opens."""

    def __init__(self, breakers, probe_fn, interval=None):
        super().__init__(name="serving-breaker-probe", daemon=True)
        self.breakers = breakers
        self.probe_fn = probe_fn
        if interval is None:
            # resolution scales with the cooldown being awaited, floored
            # for tests with millisecond cooldowns
            cooldown = min((b.cooldown for b in breakers), default=1.0)
            interval = min(1.0, max(cooldown / 8.0, 0.01))
        self.interval = interval
        self._stop_ev = threading.Event()

    def run(self):
        while not self._stop_ev.is_set():
            now = time.monotonic()
            unhealthy = False
            for breaker in self.breakers:
                if self._stop_ev.is_set():
                    return
                if breaker.state == "closed":
                    continue
                unhealthy = True
                # half_open stragglers (a trial dispatch that failed
                # without recording) are probed directly, so no state
                # can strand a replica out of rotation forever
                if breaker.state != "half_open" \
                        and not breaker.ready_to_probe(now):
                    continue
                breaker.to_half_open()
                try:
                    self.probe_fn(breaker.index)
                except Exception:
                    breaker.record_failure()
                else:
                    breaker.record_success()
            # park at a coarse tick while every breaker is healthy
            self._stop_ev.wait(self.interval if unhealthy
                               else max(self.interval, 1.0))

    def stop(self, join_timeout=2.0):
        self._stop_ev.set()
        if self.is_alive():
            self.join(join_timeout)
