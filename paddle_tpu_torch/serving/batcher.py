"""Micro-batching front door: ``submit(feed) -> Future`` (reference
``paddle_tpu/serving/batcher.py``).

Concurrent single-example requests (the serving traffic shape — many
users, one example each) coalesce into bucket-sized batches before
hitting the device: the dispatcher thread takes the first queued
request, then keeps gathering until the batch fills or a max-latency
deadline expires, stacks the examples batch-major, and runs them
through the :class:`~paddle_tpu_torch.serving.engine.ServingEngine` as
ONE padded-bucket execution. Each caller's Future resolves to its own
row of the outputs, so the batching is invisible to clients.

Admission control, outermost first:

* **backpressure** — a bounded queue: ``submit`` blocks while it is
  full (or raises :class:`ServingOverloadError` when a ``timeout`` is
  given) instead of letting an unbounded backlog grow.
* **adaptive shedding** — the dispatcher tracks an EWMA of observed
  queue waits; a submit carrying a deadline whose budget the projected
  wait would already blow is shed IMMEDIATELY with
  :class:`ServingOverloadError`.
* **deadlines** — ``submit(feed, deadline_ms=...)`` (default: the
  ``serving_deadline_ms`` flag; 0 = none) attaches an absolute deadline;
  items that expire while queued are dropped at dispatch with
  :class:`ServingDeadlineError` *before* the batch hits a device.
* **tenants** — a tenant-tagged shed also charges
  ``paddle_serving_tenant_shed_total{tenant=...}``;
  :class:`TenantQuotaError` is the per-tenant overload a quota enforcer
  raises (the fleet router's, in the reference).

Each example is validated against the engine's feed specs at
``submit`` time, and the flush groups co-batched items by shape and
dtype, so one malformed request can never poison its neighbours' batch.

``drain()`` is the redeploy story: stop admission, serve everything
already accepted, stop the dispatcher. ``close()`` is the fast exit
(bounded wait, leftovers failed). Fault site ``serving_overload``
(``resilience/faults.py``) forces sheds for chaos tests.

The generation scheduler shares this module's overload error, queue-wait
EWMA constant and Future-resolution helper.

Metrics: ``paddle_serving_request_seconds`` (submit -> result latency
histogram), ``paddle_serving_queue_depth`` (gauge, reset to 0 on
close/drain), ``paddle_serving_shed_total`` and
``paddle_serving_deadline_exceeded_total`` (``serving/resilience.py``).
"""

import itertools
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from .. import config as _config
from ..observability import flight as _flight
from ..observability import metrics as _metrics
from ..observability import request_trace as _rtrace
from ..observability import tracing as _tracing
from ..resilience import faults as _faults
from . import resilience as _sres
from .resilience import ServingDeadlineError

__all__ = ["MicroBatcher", "ServingOverloadError", "TenantQuotaError"]

_REQUEST_SECONDS = _metrics.REGISTRY.histogram(
    "paddle_serving_request_seconds",
    "Per-request latency, submit() to Future resolution")
_QUEUE_DEPTH = _metrics.REGISTRY.gauge(
    "paddle_serving_queue_depth",
    "Requests waiting in the micro-batcher queue")


class ServingOverloadError(RuntimeError):
    """Admission refused: the bounded queue stayed full past the submit
    timeout, or the projected queue wait exceeds the deadline budget."""


class TenantQuotaError(ServingOverloadError):
    """Admission refused because THIS tenant is over its in-flight
    quota — an overload scoped to one tenant, so callers (and the
    chaos probes) can tell "the fleet is full" from "you are bursting".
    Carries the tenant id as ``.tenant``."""

    def __init__(self, tenant, message):
        super().__init__(message)
        self.tenant = tenant


class _WorkItem:
    __slots__ = ("feed", "future", "t_submit", "deadline", "ctx")

    def __init__(self, feed, deadline=None):
        self.feed = feed
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = deadline  # absolute time.monotonic(), or None
        # request-scoped TraceContext (None = tracing off / unsampled)
        self.ctx = None


_STOP = object()

# EWMA smoothing for observed queue waits (~ the last ten batches
# dominate, so the projection tracks load swings without flapping).
_WAIT_ALPHA = 0.2


def _resolve(future, result=None, exception=None):
    """Set a Future's outcome without letting a client-side cancel()
    (racing the cancelled() check) raise InvalidStateError and kill the
    dispatcher thread.

    Every exceptional resolution across the serving stack funnels
    through here, which makes it the one flight-recorder hook for
    "client-visible error": armed, a failure storm auto-dumps one
    debounced post-mortem bundle; disarmed, it is one attribute
    check."""
    if exception is not None:
        _flight.RECORDER.client_error(exception)
    try:
        if not future.cancelled():
            if exception is not None:
                future.set_exception(exception)
            else:
                future.set_result(result)
    except Exception:
        pass  # already cancelled/resolved: the client walked away


class MicroBatcher:
    """Coalesces single-example submissions into engine batches.

    ``submit`` takes one example per feed name WITHOUT the batch dim
    (it is stacked on axis 0 here); the Future resolves to the list of
    per-example fetch outputs. ``max_batch`` defaults to the engine's
    largest bucket; ``max_delay_ms`` bounds the extra latency a lone
    request pays waiting for company.
    """

    def __init__(self, engine, max_batch=None, max_delay_ms=5.0,
                 max_queue=256, autostart=True):
        self.engine = engine
        self.max_batch = int(max_batch or engine.max_bucket)
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_delay = float(max_delay_ms) / 1e3
        self._q = queue.Queue(maxsize=max_queue)
        self._thread = None
        self._closed = False
        self._wait_ewma = 0.0  # seconds an item recently waited queued
        self._submit_seq = itertools.count()  # atomic under the GIL
        if autostart:
            self.start()

    def start(self):
        if self._closed:
            raise RuntimeError("batcher is closed")
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="micro-batcher",
                                            daemon=True)
            self._thread.start()
        return self

    def _validate(self, name, a):
        """Reject a malformed example at the door (its caller alone),
        instead of letting np.stack/XLA fail the whole coalesced batch
        it would have ridden in."""
        spec = self.engine._feed_specs.get(name)
        if spec is None:
            return
        dims = tuple(spec[0][1:])  # per-example dims, batch dim dropped
        if len(a.shape) != len(dims) or any(
                d >= 0 and s != d for d, s in zip(dims, a.shape)):
            raise ValueError(
                "feed %r: example shape %s does not match the model's "
                "per-example spec %s (submit() takes ONE example, "
                "without the batch dim)" % (name, a.shape, dims))
        if a.dtype.kind in "OSUV":  # object/str/void: poison for XLA
            raise ValueError(
                "feed %r: example dtype %s is not numeric (model "
                "expects %s)" % (name, a.dtype, spec[1]))

    def submit(self, feed, timeout=None, deadline_ms=None,
               tenant=None):
        """Enqueue one example; returns a Future of its outputs.

        ``deadline_ms``: serve-by budget from now (default: the
        ``serving_deadline_ms`` flag; 0/None = no deadline). An already
        hopeless submit is refused synchronously —
        :class:`ServingOverloadError` when the projected queue wait
        exceeds the budget, :class:`ServingDeadlineError` when the
        budget is gone — and an item whose deadline passes while queued
        resolves its Future with :class:`ServingDeadlineError` without
        reaching a device. ``timeout``: seconds to wait on a full
        queue; raises :class:`ServingOverloadError` instead of blocking
        forever. ``tenant``: attribution only — a shed of a
        tenant-tagged submit also charges
        ``paddle_serving_tenant_shed_total{tenant=...}`` (quota
        enforcement itself lives at the fleet router)."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        seq = next(self._submit_seq)
        try:
            _faults.fire_point("serving_overload", index=seq,
                               default_exc=ServingOverloadError)
        except ServingOverloadError:
            _sres.SHED.inc()
            if tenant is not None:
                _sres.TENANT_SHED.labels(tenant=str(tenant)).inc()
            raise
        if deadline_ms is None:
            deadline_ms = _config.get_flag("serving_deadline_ms")
        deadline = None
        if deadline_ms:  # 0/None = no deadline, per the contract
            budget = float(deadline_ms) / 1e3
            if budget < 0:
                _sres.DEADLINE_EXCEEDED.inc()
                raise ServingDeadlineError(
                    "deadline budget %.1f ms already spent"
                    % float(deadline_ms))
            projected = self._wait_ewma * (
                1.0 + self._q.qsize() / float(self.max_batch))
            if projected > budget:
                # Decay the estimate on every shed: only dispatched
                # items update the EWMA, so without this a congestion
                # spike would latch it high on an idle queue and shed
                # deadline traffic forever. Geometric decay re-admits
                # a probe request within a few sheds, and its REAL
                # observed wait re-anchors the estimate.
                self._wait_ewma *= (1.0 - _WAIT_ALPHA)
                _sres.SHED.inc()
                if tenant is not None:
                    _sres.TENANT_SHED.labels(
                        tenant=str(tenant)).inc()
                raise ServingOverloadError(
                    "shed: projected queue wait %.1f ms exceeds the "
                    "%.1f ms deadline budget"
                    % (projected * 1e3, budget * 1e3))
            deadline = time.monotonic() + budget
        if isinstance(feed, (list, tuple)):
            feed = dict(zip(self.engine.feed_names, feed))
        arrays = {}
        for name in self.engine.feed_names:
            a = np.asarray(feed[name])
            self._validate(name, a)
            arrays[name] = a
        item = _WorkItem(arrays, deadline=deadline)
        # trace minted at the front door, carried on the queue item;
        # one attribute read when request_tracing is off
        item.ctx = _rtrace.mint("serving.submit", seq=seq)
        try:
            self._q.put(item, block=True, timeout=timeout)
        except queue.Full:
            # never entered the system: a rejection storm must not
            # churn real in-flight traces out of the bounded store
            _rtrace.discard(item.ctx)
            raise ServingOverloadError(
                "serving queue full (%d pending)" % self._q.qsize()) \
                from None
        if self._closed and self._thread is None:
            # Raced a close()/drain() past its leftover sweep: nothing
            # may ever pop this item, so fail OUR future (idempotent —
            # the shutdown sweep may have raced us to it, and _resolve
            # makes a later pop by drain a no-op) and refuse the
            # submit. Only ours: a concurrent drain() still owns and
            # serves every other accepted item.
            _rtrace.discard(item.ctx)
            _resolve(item.future,
                     exception=RuntimeError("batcher closed"))
            raise RuntimeError("batcher is closed")
        _QUEUE_DEPTH.set(self._q.qsize())
        return item.future

    # -- dispatcher ------------------------------------------------------
    def _loop(self):
        while True:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._closed:
                    return
                continue
            if first is _STOP:
                return
            batch = [first]
            deadline = time.perf_counter() + self.max_delay
            stop = False
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                batch.append(nxt)
            _QUEUE_DEPTH.set(self._q.qsize())
            self._flush(batch)
            if stop:
                return

    def _flush(self, batch):
        """Dispatch a gathered batch: drop expired items, then run each
        same-shape group as one engine execution (mixed shapes — only
        possible for feeds with dynamic per-example dims — batch
        separately instead of failing each other)."""
        now = time.monotonic()
        live = []
        for it in batch:
            if it.deadline is not None and now >= it.deadline:
                _sres.DEADLINE_EXCEEDED.inc()
                if it.ctx is not None:
                    _rtrace.event(it.ctx, "deadlineExpired",
                                  where="in queue")
                _resolve(it.future, exception=ServingDeadlineError(
                    "deadline expired after %.1f ms in queue"
                    % ((time.perf_counter() - it.t_submit) * 1e3)))
            else:
                wait = time.perf_counter() - it.t_submit
                self._wait_ewma += _WAIT_ALPHA * (wait - self._wait_ewma)
                _rtrace.QUEUE_WAIT_MS.observe(wait * 1e3)
                if it.ctx is not None:
                    _rtrace.event(it.ctx, "queueWait", dur_ms=wait * 1e3)
                live.append(it)
        if not live:
            return
        names = self.engine.feed_names
        groups = {}
        for it in live:
            # dtype is part of the key: a stray float64/int64 example
            # batches alone instead of upcasting (and poisoning) the
            # whole stacked group
            key = tuple((it.feed[n].shape, it.feed[n].dtype)
                        for n in names)
            groups.setdefault(key, []).append(it)
        for group in groups.values():
            self._flush_group(group)

    def _flush_group(self, batch):
        # the shape-group flush is a lifecycle edge on EVERY sampled
        # member's trace; the engine dispatch (replica choice,
        # failover hops, device call) is activated under the FIRST
        # sampled member's context — co-batched requests share one
        # physical execution, so one trace carries its detail
        lead_ctx = None
        for it in batch:
            if it.ctx is not None:
                if lead_ctx is None:
                    lead_ctx = it.ctx
                _rtrace.event(it.ctx, "shapeGroupFlush",
                              size=len(batch),
                              lead=lead_ctx.trace_id)
        try:
            # nothing sampled -> activate the NO_TRACE sentinel, not
            # None: the engine below must see "sampling already
            # decided against this batch" and not mint its own orphan
            # 'serving.run' trace for it
            with _tracing.span("servingBatch", size=len(batch)), \
                    _rtrace.activate(lead_ctx if lead_ctx is not None
                                     else _rtrace.NO_TRACE):
                feed = {name: np.stack([it.feed[name] for it in batch])
                        for name in self.engine.feed_names}
                outs = self.engine.run(feed)
        except Exception as exc:  # engine failure, every replica down...
            for it in batch:
                if it.ctx is not None:
                    _rtrace.event(it.ctx, "resolveError",
                                  error=repr(exc)[:200])
                _resolve(it.future, exception=exc)
            return
        now = time.perf_counter()
        for i, it in enumerate(batch):
            res = [o[i] if getattr(o, "ndim", 0) > 0 and
                   o.shape[0] == len(batch) else o for o in outs]
            _resolve(it.future, result=res)
            e2e = now - it.t_submit
            _REQUEST_SECONDS.observe(e2e)
            _rtrace.E2E_MS.observe(e2e * 1e3)
            if it.ctx is not None:
                _rtrace.event(it.ctx, "resolve", dur_ms=e2e * 1e3)

    # -- lifecycle -------------------------------------------------------
    def _stop_dispatcher(self, timeout):
        """Common close/drain step: mark closed, wake the dispatcher
        with a stop marker, join it. Returns the items left in the
        queue (racing submits that landed behind the marker). A
        dispatcher wedged mid-batch is disowned, but the queue is
        still emptied — each item is popped exactly once, so the
        caller fails/serves what it got and the wedged thread serves
        only what it already held."""
        self._closed = True
        if self._thread is not None:
            try:
                # never block on a full queue behind a wedged
                # dispatcher — with the marker unplaceable, the sweep
                # below empties the queue and the dispatcher's get loop
                # exits on empty+closed anyway
                self._q.put_nowait(_STOP)
            except queue.Full:
                pass
            self._thread.join(timeout)
            self._thread = None
        leftovers = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                leftovers.append(item)
        return leftovers

    def drain(self, timeout=None):
        """Graceful drain (the redeploy story): stop admission, serve
        every request already accepted — including submits that raced
        the stop marker — and stop the dispatcher. Every accepted
        Future resolves; afterwards the process holds no queued work
        and a fresh batcher/engine can take over."""
        leftovers = self._stop_dispatcher(timeout)
        for i in range(0, len(leftovers), self.max_batch):
            self._flush(leftovers[i:i + self.max_batch])
        _QUEUE_DEPTH.set(0)

    def close(self, timeout=5.0):
        """Drain-and-stop with a bounded wait: queued requests before
        the stop marker still complete; anything after it is failed
        rather than left hanging; subsequent submits raise."""
        for item in self._stop_dispatcher(timeout):
            _resolve(item.future,
                     exception=RuntimeError("batcher closed"))
        _QUEUE_DEPTH.set(0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
