"""ServingEngine: bucketed, replicated inference front end (reference
``paddle_tpu/serving/engine.py``).

The engine loads an exported model (``io.save_inference_model``: a
directory or a merged single file) once and serves batches of it:

* **batch buckets**: every incoming batch is zero-padded up to the
  smallest bucket that holds it (the ``serving_buckets`` flag by
  default), so the shapes a replica sees are a small closed set, and
  the outputs are sliced back to the real rows. A batch larger than the
  largest bucket runs unpadded and is counted as an overflow.
* **warmup**: each bucket runs once on each replica at construction, so
  the first user request pays no first-run cost (kernel builds, cuBLAS
  handles, the executor's cache entry and, on the card, its CUDA graph);
  an artifact with a ``compiled/`` index primes the entries from it.
* **device replicas**: each replica has its own executor and its own
  scope holding its own copy of the weights, on the device
  ``devices[i % len(devices)]`` of the executor's kind (two replicas on
  a one-card machine share the card). Requests dispatch round-robin,
  each replica running its batches one at a time behind its lock.

Entry points run on CUDA unless the caller passes ``device="cpu"`` (or a
CPU ``place``); asked for CUDA without one, construction raises, and an
engine never carries on on the CPU. Outputs are numpy arrays, as the
reference returns them.

Resilience (``serving/resilience.py``): per-replica circuit breakers
(``breaker_failures`` or the ``serving_breaker_failures`` flag), a
per-call ``timeout`` (a hang opens the breaker at once), failover to the
next healthy replica (``paddle_serving_failover_total``), a background
:class:`BreakerProbe` re-admitting a replica after its cooldown by
re-running a warmed bucket, deadlines checked before dispatch, and
``close()``. Fault sites ``serving_replica_fail`` and
``serving_replica_slow``, indexed by replica.

Differences by design from the reference:

* a timed execution runs on its replica's one long-lived worker thread
  (``resilience.BoundedWorker``), not on a fresh thread a call: kernels
  B3, B4 and B5 keep their scratch per thread, so a fresh thread would
  allocate it anew every batch. A wedged worker stays its replica's,
  and the replica fails fast until it returns.
* a ``compiled/`` index written by the reference (pickled XLA
  executables, its ``env`` naming jax) is never unpickled: warmup counts
  one ``paddle_deploy_aot_fallbacks_total`` per indexed bucket and
  replica, logs ``aot_prime_fallback`` and runs the program. The port's
  own index (``serving/deploy.py`` ``export_compiled_buckets``: one
  ``torch.export`` program a bucket) primes each replica's cache entry
  (``_prime_bucket``), as the reference primes its executables.
* on the card, warmup leaves every bucket of every replica captured as a
  CUDA graph (``core/executor.py``), so no request pays a capture; a
  weight swap's flip installs new tensors, and each replica's next batch
  recaptures against them.

``swap_weights`` hot-swaps the weights (validate, canary, flip, watch,
rollback; ``serving/deploy.py``'s counters). Staged weights are copied
to each replica's device, the copies finished, before any replica's
lock is taken, and the flip installs new tensors in the scope, never
writing a live tensor in place.

int8 artifacts load dequantized, or, under the ``serving_quant_compute``
flag (read at construction), with their weights kept int8 for kernel
B3 (``serving/quant.py``).

Metrics (always on): ``paddle_serving_requests_total``,
``paddle_serving_batches_total``{bucket},
``paddle_serving_batch_occupancy``, ``paddle_serving_batch_seconds``
{bucket}, ``paddle_serving_bucket_compiles_total``{bucket} (the first
successful run of each feed signature on each replica),
``paddle_serving_bucket_overflow_total``, and the resilience and deploy
families. Host spans (``servingRun``, ``swapCanary``) flow to the
Chrome trace when the ``telemetry`` flag is armed.
"""

import itertools
import os
import shutil
import threading
import time
import weakref

import numpy as np
import torch

from .. import config as _config
from .. import io as _io
from ..core import compile_cache as _cc
from ..core import executor as _executor
from ..core.executor import Executor
from ..core.scope import Scope
from ..observability import health as _health
from ..observability import metrics as _metrics
from ..observability import request_trace as _rtrace
from ..observability import tracing as _tracing
from ..resilience import faults as _faults
from ..utils import log as _log
from . import deploy as _deploy
from . import resilience as _sres
from .deploy import SwapRejectedError
from .resilience import (BoundedWorker, BreakerProbe, ReplicaBreaker,
                         ServingDeadlineError, ServingTimeoutError,
                         ServingUnavailableError)

__all__ = ["ServingEngine", "SwapRejectedError"]

_REQUESTS = _metrics.REGISTRY.counter(
    "paddle_serving_requests_total",
    "Examples served through ServingEngine.run")
_BATCHES = _metrics.REGISTRY.counter(
    "paddle_serving_batches_total",
    "Batches executed per bucket size", labelnames=("bucket",))
_OCCUPANCY = _metrics.REGISTRY.gauge(
    "paddle_serving_batch_occupancy",
    "Real examples / bucket size of the most recent batch")
_BATCH_SECONDS = _metrics.REGISTRY.histogram(
    "paddle_serving_batch_seconds",
    "Device execute wall time per batch", labelnames=("bucket",))
_BUCKET_COMPILES = _metrics.REGISTRY.counter(
    "paddle_serving_bucket_compiles_total",
    "First-time (compile) executions per bucket per replica",
    labelnames=("bucket",))
_OVERFLOWS = _metrics.REGISTRY.counter(
    "paddle_serving_bucket_overflow_total",
    "Requests larger than the biggest bucket (served unpadded)")


# distinguishes per-replica health gauges when several breaker-armed
# engines share the process-global metric registry
_ENGINE_SEQ = itertools.count()


def _engine_health(ref):
    """The /healthz component callable for one engine: healthy while
    any replica's breaker is in rotation; None once the engine is
    garbage-collected (the health registry drops it lazily)."""
    def snapshot():
        eng = ref()
        if eng is None:
            return None
        states = eng.replica_health()
        return {"healthy": not eng._closed and
                any(s != "open" for s in states),
                "closed": eng._closed,
                "replicas": states}
    return snapshot


class _Replica:
    __slots__ = ("index", "exe", "scope", "device", "lock", "seen",
                 "stuck", "guard", "worker")

    def __init__(self, index, exe, scope, device):
        self.index = index
        self.exe = exe
        self.scope = scope
        self.device = device
        self.lock = threading.Lock()
        self.seen = set()  # feed signatures already run here
        self.stuck = None  # done-Event of a timed-out call, if any
        self.guard = threading.Lock()  # serializes stuck bookkeeping
        self.worker = None  # BoundedWorker, made at the first timed call


def _dtype_name(v):
    """The dtype of a scope value by name (tensor or array alike)."""
    if isinstance(v, torch.Tensor):
        return str(v.dtype).replace("torch.", "")
    return np.asarray(v).dtype.name


def _host(v):
    """A scope value as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _replica_devices(device, replicas):
    """The reference's ``devs[i % len(devs)]`` rule over the devices of
    ``device``'s kind, starting at ``device``: every CUDA card in turn,
    or the CPU."""
    if device.type != "cuda":
        return [device] * replicas
    count = torch.cuda.device_count()
    base = device.index or 0
    return [torch.device("cuda", (base + i) % count)
            for i in range(replicas)]


class ServingEngine:
    """Loads an exported model once and serves padded-bucket batches.

    ``model_dir`` may be a ``save_inference_model`` dir or a merged
    single-file model. ``buckets`` defaults to the ``serving_buckets``
    config flag. ``replicas`` > 1 copies the weights into that many
    replicas (round-robin over the devices of the engine's kind) and fans
    requests out; ``devices`` names them instead. ``device`` (or
    ``place``) is the first replica's device: CUDA when neither is
    given, ``"cpu"`` to run on the CPU.

    ``breaker_failures`` / ``breaker_cooldown_ms`` (default: the
    ``serving_breaker_*`` flags; 0 failures = breakers off) arm the
    per-replica circuit breakers. ``timeout`` (seconds) is the default
    per-call execution timeout enforced around every dispatch — a hang
    past it opens the replica's breaker immediately.
    """

    def __init__(self, model_dir, buckets=None, replicas=1, devices=None,
                 warmup=True, place=None, breaker_failures=None,
                 breaker_cooldown_ms=None, timeout=None,
                 use_exported=True, device=None):
        t_cold = time.perf_counter()
        if buckets is None:
            buckets = _config.get_flag("serving_buckets")
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError("buckets must be positive ints, got %r"
                             % (buckets,))

        exe0 = Executor(place=place, device=device)
        scope0 = Scope()
        self.model_dir = model_dir
        self._unpacked_dir = None
        self._closed = False
        artifact_dir = model_dir
        if os.path.isfile(model_dir):
            # merged single-file artifact: unpack ONCE and keep the dir
            # for the engine's lifetime (removed in close())
            from ..utils.merge_model import unpack_merged_model
            artifact_dir = self._unpacked_dir = \
                unpack_merged_model(model_dir)
        self._artifact_dir = artifact_dir
        try:
            # construction-time flag read; remembered for swap_weights: a
            # staged push loads through the SAME quant path
            self._quant_compute = bool(
                _config.get_flag("serving_quant_compute"))
            (self.program, self.feed_names,
             self.fetch_names) = _io.load_inference_model(
                 artifact_dir, exe0, scope=scope0,
                 quant_compute=self._quant_compute)
            # the exact variable set an artifact loads — the shape/dtype
            # signature swap_weights validates a new push against
            self._param_names = tuple(sorted(scope0.var_names()))
            block = self.program.global_block()
            self._feed_specs = {}
            for name in self.feed_names:
                var = block.var_or_none(name)
                if var is not None:
                    self._feed_specs[name] = (tuple(var.shape or ()),
                                              np.dtype(var.dtype))

            if devices is None and replicas > 1:
                devices = _replica_devices(exe0.device, replicas)
            self.replicas = []
            if not devices:
                self.replicas.append(_Replica(0, exe0, scope0, exe0.device))
            else:
                for i, dev in enumerate(devices):
                    dev = torch.device(dev)
                    scope = Scope()
                    for n, v in scope0.items():
                        # the first replica on exe0's device keeps the
                        # loaded tensors; every other gets its own copy
                        own = i == 0 and isinstance(v, torch.Tensor) \
                            and v.device == dev
                        scope.set_var(n, v if own else torch.as_tensor(
                            _host(v) if not isinstance(v, torch.Tensor)
                            else v).to(dev, copy=True))
                    exe = exe0 if i == 0 and dev == exe0.device \
                        else Executor(device=dev)
                    self.replicas.append(_Replica(i, exe, scope, dev))
                del scope0
            self._rr = itertools.count()
            self._engine_id = next(_ENGINE_SEQ)

            if breaker_failures is None:
                breaker_failures = _config.get_flag(
                    "serving_breaker_failures")
            if breaker_cooldown_ms is None:
                breaker_cooldown_ms = _config.get_flag(
                    "serving_breaker_cooldown_ms")
            self.default_timeout = timeout
            if breaker_failures:
                self._breakers = [
                    ReplicaBreaker(rep.index, breaker_failures,
                                   float(breaker_cooldown_ms) / 1e3,
                                   label="e%d:%d" % (self._engine_id,
                                                     rep.index))
                    for rep in self.replicas]
            else:
                self._breakers = None
            self._probe = None          # BreakerProbe, started lazily
            self._probe_feed = None     # (feed dict, bucket) from warmup
            self._probe_lock = threading.Lock()

            # deploy layer (engine-local; None/0 until a swap installs a
            # watch — the default request path costs one None check)
            self._swap_admin = threading.Lock()  # serializes swaps
            self._swap_lock = threading.Lock()   # guards watch state
            self._swap_watch = None
            self._weights_version = 0
            # {replica_index: values} a rollback could not install
            # because the replica was wedged — applied under its lock
            # before its next execution (None = nothing pending)
            self._pending_restore = None
            # True from the instant a watch failure DECIDES to roll back
            # until the restore flip lands
            self._rollback_pending = False
            # the artifact's compiled/ index, primed from at warmup
            self._aot_index = _deploy.load_compiled_index(artifact_dir) \
                if use_exported else None

            # /healthz aggregates every live engine's replica-breaker
            # view (weakref — a GC'd engine drops out lazily; close()
            # unregisters eagerly)
            self._health_name = "engine%d" % self._engine_id
            _health.register_health(self._health_name,
                                    _engine_health(weakref.ref(self)))

            if warmup:
                self.warmup()
        except Exception:
            # a failed construction must not leak the unpacked
            # merged-model copy, nor a phantom /healthz component
            unpacked, self._unpacked_dir = self._unpacked_dir, None
            if unpacked is not None:
                shutil.rmtree(unpacked, ignore_errors=True)
            if getattr(self, "_health_name", None):
                _health.unregister_health(self._health_name)
            for rep in getattr(self, "replicas", ()):
                if rep.worker is not None:
                    rep.worker.stop()
            raise
        _deploy.COLD_START_SECONDS.set(time.perf_counter() - t_cold)

    @property
    def max_bucket(self):
        return self.buckets[-1]

    # -- execution -------------------------------------------------------
    def _bucket_for(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        return None

    def _apply_pending_restore(self, rep):
        """Install the restore values a rollback left pending for this
        replica (it was wedged when the fleet flipped back). Caller
        holds ``rep.lock``, so no batch can interleave."""
        with self._swap_lock:
            pending = self._pending_restore
            vals = pending.pop(rep.index, None) if pending else None
            if pending is not None and not pending:
                self._pending_restore = None
        if vals:
            for name, val in vals.items():
                rep.scope.set_var(name, val)
            _log.structured("swap_flip_recovered", replica=rep.index)

    def _activated_execute(self, rep, feed, bucket, ctx):
        # the trace context is activated around the _execute call, not
        # at the run() call site, because the timed path runs this on
        # the replica's worker thread
        with _rtrace.activate(ctx):
            return self._execute(rep, feed, bucket)

    def _execute(self, rep, feed, bucket):
        _faults.fire_point("serving_replica_fail", index=rep.index)
        sig = tuple(sorted((n, a.shape) for n, a in feed.items()))
        # the feed's host-to-device copy before the lock, as the
        # reference's device_put
        feed = {n: torch.tensor(a, device=rep.device)
                for n, a in feed.items()}
        with rep.lock, _tracing.span("servingRun", bucket=bucket):
            if self._pending_restore is not None:
                self._apply_pending_restore(rep)
            _faults.fire_point("serving_replica_slow", index=rep.index)
            outs = rep.exe.run(self.program, feed=feed,
                               fetch_list=self.fetch_names,
                               scope=rep.scope)
            # Only after a successful run: a failed first execution must
            # not suppress the counter for the real first run that
            # happens on the next (successful) attempt.
            if sig not in rep.seen:
                rep.seen.add(sig)
                _BUCKET_COMPILES.labels(bucket=bucket).inc()
        return outs

    def _execute_timed(self, rep, feed, bucket, timeout, ctx=None):
        """Run ``_execute`` bounded by ``timeout`` seconds on the
        replica's long-lived worker thread: a hung execution is left to
        finish on it while the caller gets ServingTimeoutError — the
        breaker quarantines the replica (whose lock the hung run still
        holds) out of rotation. While that worker is still wedged, fail
        fast instead of queueing behind it."""
        with rep.guard:
            prior = rep.stuck
            if prior is not None:
                if prior.is_set():
                    rep.stuck = None  # the old run finally finished
                else:
                    raise ServingTimeoutError(
                        "replica %d still wedged in an earlier "
                        "execution" % rep.index)
            if rep.worker is None:
                rep.worker = BoundedWorker("serving-exec-%d" % rep.index)
            worker = rep.worker
        try:
            return worker.call(
                lambda: self._activated_execute(rep, feed, bucket, ctx),
                timeout)
        except ServingTimeoutError as err:
            pending = getattr(err, "pending", None)
            if pending is not None:
                with rep.guard:
                    # keep the FIRST still-unset marker
                    if rep.stuck is None or rep.stuck.is_set():
                        rep.stuck = pending
            raise

    def _run_once(self, rep, arrays, bucket, timeout, ctx=None):
        t0 = time.perf_counter()
        if ctx is not None:
            _rtrace.event(ctx, "dispatch", replica=rep.index,
                          bucket=bucket)
        if timeout is not None:
            outs = self._execute_timed(rep, arrays, bucket, timeout,
                                       ctx=ctx)
        else:
            outs = self._activated_execute(rep, arrays, bucket, ctx)
        _BATCH_SECONDS.labels(bucket=bucket).observe(
            time.perf_counter() - t0)
        return outs

    def _prepare(self, feed):
        if isinstance(feed, (list, tuple)):
            feed = dict(zip(self.feed_names, feed))
        arrays = {}
        n = None
        for name in self.feed_names:
            if name not in feed:
                raise KeyError("missing feed %r (expects %s)"
                               % (name, self.feed_names))
            a = np.asarray(feed[name])
            if a.ndim == 0:
                raise ValueError("feed %r must be batch-major" % name)
            if n is None:
                n = a.shape[0]
            elif a.shape[0] != n:
                raise ValueError(
                    "inconsistent batch: %r has %d rows, expected %d"
                    % (name, a.shape[0], n))
            arrays[name] = a
        bucket = self._bucket_for(n)
        if bucket is None:
            bucket = n
            _OVERFLOWS.inc()
        elif bucket > n:
            arrays = {name: np.concatenate(
                [a, np.zeros((bucket - n,) + a.shape[1:], a.dtype)])
                for name, a in arrays.items()}
        return arrays, n, bucket

    def _finish(self, outs, n, bucket):
        _REQUESTS.inc(n)
        _BATCHES.labels(bucket=bucket).inc()
        _OCCUPANCY.set(n / float(bucket))
        return [np.asarray(o)[:n]
                if getattr(o, "ndim", 0) > 0 and o.shape[0] == bucket
                else np.asarray(o) for o in outs]

    def _candidates(self):
        """Replica indices to try, in round-robin order. Healthy
        (breaker-closed) replicas only; when NONE is healthy, replicas
        whose cooldown has elapsed (or that are already half-open) are
        offered as trial dispatches — the traffic itself becomes the
        probe."""
        start = next(self._rr)
        n = len(self.replicas)
        order = [(start + i) % n for i in range(n)]
        if self._breakers is None:
            return order
        closed = [i for i in order if self._breakers[i].state == "closed"]
        now = time.monotonic()
        if closed:
            if self._probe is None:
                # No background prober (no warmed bucket to re-run):
                # live traffic is the only re-admission path, so lead
                # with ONE probe-ready replica as the trial — the
                # healthy replicas behind it absorb a failed trial via
                # failover, and success re-admits it. Without this a
                # half-open replica would be stranded out of rotation
                # as soon as any other replica recovers.
                for i in order:
                    breaker = self._breakers[i]
                    if breaker.state == "half_open" \
                            or breaker.ready_to_probe(now):
                        breaker.to_half_open()
                        return [i] + closed  # i is not closed, no dedup
            return closed
        trial = []
        for i in order:
            breaker = self._breakers[i]
            if breaker.state == "half_open" or breaker.ready_to_probe(now):
                breaker.to_half_open()
                trial.append(i)
        return trial

    def run(self, feed, timeout=None, deadline=None, deadline_ms=None):
        """Serve one batch: pads to the nearest bucket, dispatches to the
        next healthy replica, slices outputs back to the real batch
        size. ``feed``: {name: array} or positional list; arrays are
        batch-major. Thread-safe.

        ``timeout``: seconds to bound THIS execution (defaults to the
        engine's ``timeout``); a hang raises ServingTimeoutError and
        opens the replica's breaker. ``deadline``: absolute
        ``time.monotonic()`` deadline (or ``deadline_ms`` relative to
        now) checked *before* dispatch — an expired request raises
        ServingDeadlineError without ever occupying a device. On an
        execution failure the request fails over to the next healthy
        replica; it only raises when no replica can take it.

        While a post-swap watch window is active (``swap_weights``),
        every execution failure feeds the rollback trigger; the request
        whose failure trips the rollback — and any concurrent request
        whose failure raced the rollback flip — is transparently
        retried once against the restored weights, so no caller ever
        sees the bad push."""
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        if timeout is None:
            timeout = self.default_timeout
        if deadline is None and deadline_ms:  # 0/None = no deadline
            deadline = time.monotonic() + float(deadline_ms) / 1e3
        if deadline is not None and time.monotonic() >= deadline:
            # already doomed: refuse before the padding copies and
            # before touching round-robin/breaker state
            _sres.DEADLINE_EXCEEDED.inc()
            raise ServingDeadlineError("deadline expired before dispatch")
        # a batcher flush arrives with its lead request's context
        # already active (or the NO_TRACE sentinel, when the front
        # door above us sampled nothing — minting here would fill the
        # bounded store with orphan traces the operator chose not to
        # record); only a DIRECT engine call mints its own, and only
        # AFTER feed validation: a malformed-feed storm must not
        # churn real traces out of the bounded store with root-only
        # orphans. One attribute read when request_tracing is off.
        ctx = _rtrace.current()
        if ctx is not None and ctx.trace_id is None:
            ctx = None
            mint_own = False
        else:
            mint_own = ctx is None
        arrays, n, bucket = self._prepare(feed)
        if mint_own:
            ctx = _rtrace.mint("serving.run", bucket=bucket, n=int(n))
        # terminal edges (resolve/resolveError/deadlineExpired) are
        # recorded only on traces minted HERE: for an inherited
        # context the batcher owns the Future and records the one
        # ending — the engine contributes lifecycle edges only
        # (dispatch, failover, deviceCall).
        v0 = self._weights_version  # detect a mid-request weight flip

        if self._breakers is None and timeout is None and \
                deadline is None and self._swap_watch is None and \
                not self._rollback_pending:
            # healthy fast path: no resilience bookkeeping at
            # all. A pending rollback routes through the slow path so
            # a request dispatched onto the about-to-be-restored
            # weights gets the transparent retry, not the bad push.
            rep = self.replicas[next(self._rr) % len(self.replicas)]
            try:
                outs = self._run_once(rep, arrays, bucket, None,
                                      ctx=ctx)
            except Exception as exc:
                if self._swap_watch is None and \
                        not self._rollback_pending and \
                        not self._swap_admin.locked() and \
                        self._weights_version == v0:
                    if mint_own and ctx is not None:
                        _rtrace.event(ctx, "resolveError",
                                      error=repr(exc)[:200])
                    raise  # a plain failure, no swap anywhere near it
                # a swap/rollback raced this dispatch (the guard saw
                # pre-swap state, the execution saw the new weights):
                # fall through to the slow path, which owns the
                # watch/retry bookkeeping
            else:
                if mint_own and ctx is not None:
                    _rtrace.event(ctx, "resolve", bucket=bucket,
                                  n=int(n))
                return self._finish(outs, n, bucket)

        last_exc = None
        charged = False  # a breaker already blamed for THIS request
        for attempt in (0, 1):
            candidates = self._candidates()
            if not candidates:
                if mint_own and ctx is not None:
                    _rtrace.event(ctx, "resolveError",
                                  error="no healthy replica")
                raise ServingUnavailableError(
                    "no healthy replica (all %d breakers open)"
                    % len(self.replicas))
            retry = False
            for pos, idx in enumerate(candidates):
                if deadline is not None and time.monotonic() >= deadline:
                    _sres.DEADLINE_EXCEEDED.inc()
                    if mint_own and ctx is not None:
                        _rtrace.event(ctx, "deadlineExpired",
                                      where="before dispatch")
                    raise ServingDeadlineError(
                        "deadline expired before dispatch")
                rep = self.replicas[idx]
                breaker = self._breakers[idx] if self._breakers else None
                try:
                    outs = self._run_once(rep, arrays, bucket, timeout,
                                          ctx=ctx)
                except Exception as exc:
                    last_exc = exc
                    final = breaker is None or \
                        pos + 1 == len(candidates)
                    # post-swap watch: ONE outcome per REQUEST (the
                    # breaker's charge-at-most-once discipline) — a
                    # poison request failing over across every replica
                    # must count as a single failure, not burn the
                    # whole consecutive budget and roll back a healthy
                    # push. Noted only at the final candidate; True =
                    # the prior weights were just restored, so this
                    # request deserves one transparent retry instead
                    # of surfacing the bad push to its caller.
                    rolled = self._swap_note(False) \
                        if final and self._swap_watch is not None \
                        else False
                    if breaker is not None:
                        hang = isinstance(exc, ServingTimeoutError)
                        # A request that already failed on another
                        # replica is almost certainly poison (bad feed
                        # content) — charge at most ONE breaker per
                        # request so a few bad requests can't open
                        # every breaker and black out healthy replicas.
                        # Hangs are always the replica's fault, and a
                        # half-open trial failure must always record (a
                        # breaker left dangling in half_open would
                        # never be probed or dispatched to again once
                        # another replica recovers).
                        if hang or not charged or \
                                breaker.state == "half_open":
                            breaker.record_failure(hang=hang)
                            charged = True
                        self._ensure_probe()
                    if final:
                        if not rolled and attempt == 0 and \
                                (self._weights_version != v0 or
                                 self._rollback_pending or
                                 self._swap_admin.locked()):
                            # A CONCURRENT request's rollback (or a
                            # swap) replaced the weights this run
                            # failed against — or its flip is still
                            # in flight (decided, or admin lock
                            # held; wait it out). Either way this
                            # request deserves the same transparent
                            # retry as the one that tripped the
                            # rollback: no caller may see the bad
                            # push.
                            wait_until = time.monotonic() + \
                                self.FLIP_LOCK_TIMEOUT
                            if deadline is not None:
                                # the wait must respect the caller's
                                # deadline — the contract bounds
                                # run() by it, swap or no swap
                                wait_until = min(wait_until, deadline)
                            while (self._rollback_pending or
                                   self._swap_admin.locked()) and \
                                    time.monotonic() < wait_until:
                                time.sleep(0.001)  # let the flip land
                            rolled = self._weights_version != v0
                        if rolled and attempt == 0:
                            retry = True
                            break
                        if mint_own and ctx is not None:
                            _rtrace.event(ctx, "resolveError",
                                          error=repr(exc)[:200])
                        raise
                    _sres.FAILOVER.inc()
                    if ctx is not None:
                        _rtrace.event(ctx, "failover",
                                      from_replica=idx,
                                      hang=isinstance(
                                          exc, ServingTimeoutError),
                                      error=repr(exc)[:200])
                    continue
                if breaker is not None:
                    breaker.record_success()
                if self._swap_watch is not None:
                    self._swap_note(True)
                if mint_own and ctx is not None:
                    _rtrace.event(ctx, "resolve", bucket=bucket,
                                  n=int(n))
                return self._finish(outs, n, bucket)
            if not retry:
                break
        if mint_own and ctx is not None:
            _rtrace.event(ctx, "resolveError",
                          error=repr(last_exc)[:200])
        raise last_exc

    # -- resilience ------------------------------------------------------
    def _ensure_probe(self):
        """Start the background half-open prober the first time any
        breaker opens (needs a warmed bucket to re-execute; without
        warmup, re-admission falls back to trial dispatches)."""
        if self._probe is not None or self._probe_feed is None:
            return
        with self._probe_lock:
            if self._probe is None and not self._closed:
                probe = BreakerProbe(self._breakers, self._probe_replica)
                probe.start()
                self._probe = probe

    def _probe_replica(self, index):
        feed, bucket = self._probe_feed
        timeout = self.default_timeout
        if timeout is None:
            timeout = max(30.0, *(b.cooldown for b in self._breakers))
        self._execute_timed(self.replicas[index], feed, bucket, timeout)

    def replica_health(self):
        """Breaker state per replica ('closed' = in rotation); all
        'closed' when breakers are disarmed."""
        if self._breakers is None:
            return ["closed"] * len(self.replicas)
        return [b.state for b in self._breakers]

    def close(self):
        """Refuse new work and stop the probe and worker threads.
        In-flight runs finish; a new engine over the same export
        rebuilds everything."""
        _health.unregister_health(getattr(self, "_health_name", ""))
        with self._probe_lock:  # vs a racing _ensure_probe start
            self._closed = True
            probe, self._probe = self._probe, None
        if probe is not None:
            probe.stop()
        for rep in self.replicas:
            with rep.guard:
                worker, rep.worker = rep.worker, None
            if worker is not None:
                worker.stop()
            # the replica's captured buckets hold its weights
            rep.exe.release_graphs()
        unpacked, self._unpacked_dir = self._unpacked_dir, None
        if unpacked is not None:
            shutil.rmtree(unpacked, ignore_errors=True)
        if self._breakers is not None:
            for breaker in self._breakers:
                # retire first so a straggling probe/run can't resurrect
                # a gauge child the sweep below removes
                breaker.retired = True
            _metrics.REGISTRY.remove_labeled(
                "replica", prefix="e%d:" % self._engine_id)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- deploy: hot weight swap ----------------------------------------
    @property
    def weights_version(self):
        """Monotonic counter of weight flips (initial load = 0; every
        swap or rollback bumps it)."""
        return self._weights_version

    def _canary_feed(self):
        """A warmed bucket's feed for the canary run (warmup recorded
        one; otherwise synthesize the smallest bucket)."""
        if self._probe_feed is not None:
            return self._probe_feed
        for b, feed in _deploy._bucket_feeds(
                self.program.global_block(), self.feed_names,
                self.buckets[:1]):
            return feed, b
        return None

    # Bound on waiting for a replica's execution lock during a swap
    # flip or canary: a replica wedged in a hung device execution
    # holds its lock indefinitely (the stuck worker keeps it by
    # design), and an unbounded acquire here would deadlock
    # every future swap AND auto-rollback behind _swap_admin.
    FLIP_LOCK_TIMEOUT = 30.0

    def _run_canary(self, new_host):
        """Execute one warmed bucket against the NEW weights in a
        throwaway scope — same program, zero contact with live traffic's
        weights. Non-finite outputs or any
        execution error reject the push. Runs on the first
        breaker-healthy replica (a quarantined/wedged replica must not
        stall the canary)."""
        probe = self._canary_feed()
        if probe is None:
            _log.structured("swap_canary_skipped",
                            reason="no synthesizable bucket feed")
            return
        feed, bucket = probe
        cscope = Scope()
        for name, val in new_host.items():
            cscope.set_var(name, val)
        rep = self.replicas[0]
        if self._breakers is not None:
            for i, breaker in enumerate(self._breakers):
                if breaker.state == "closed":
                    rep = self.replicas[i]
                    break
        if not rep.lock.acquire(timeout=self.FLIP_LOCK_TIMEOUT):
            raise RuntimeError(
                "replica %d execution lock not acquired within %.0fs "
                "(wedged execution?) — canary could not run"
                % (rep.index, self.FLIP_LOCK_TIMEOUT))
        try:
            with _tracing.span("swapCanary", bucket=bucket):
                outs = rep.exe.run(self.program, feed=feed,
                                   fetch_list=self.fetch_names,
                                   scope=cscope)
        finally:
            rep.lock.release()
        for out in outs:
            arr = np.asarray(out)
            if np.issubdtype(arr.dtype, np.floating) and \
                    not np.all(np.isfinite(arr)):
                raise ValueError("canary produced non-finite outputs")

    def _flip(self, per_replica_values, skip_wedged=False,
              prior_out=None):
        """Install ``per_replica_values[rep.index]`` into each replica's
        scope under its execution lock — every batch therefore runs
        against exactly one weight version (the lock is what serializes
        batches), and replicas not currently being flipped keep
        serving. Values are staged onto each replica's device BEFORE
        any lock is taken, so the lock window is pointer flips, not
        transfers. Replicas missing from ``per_replica_values`` are
        skipped (partial-restore dicts).

        A replica whose lock can't be had within FLIP_LOCK_TIMEOUT is
        wedged in a hung execution: with ``skip_wedged`` (the rollback
        path — the flip must make progress) it is skipped with a log;
        otherwise the replicas already flipped are restored and
        SwapRejectedError raised — a half-flipped fleet never serves.

        Returns the prior per-replica values (the rollback state) and
        observes the worst single-replica lock hold as the swap
        blackout."""
        worst = 0.0
        # prior_out lets swap_weights hand the SAME dict to a
        # pre-installed watch, so a rollback tripped mid-flip (it
        # serializes behind _swap_admin, which the swap still holds)
        # always sees the fully-populated restore state
        prior = prior_out if prior_out is not None else {}
        for rep in self.replicas:
            vals = per_replica_values.get(rep.index)
            if vals is None:
                continue
            if not rep.lock.acquire(timeout=self.FLIP_LOCK_TIMEOUT):
                if skip_wedged:
                    # leave the values PENDING: they are applied under
                    # the replica's lock before its next execution
                    # (_apply_pending_restore), so a recovered replica
                    # can never serve a batch on the weights this flip
                    # meant to replace
                    with self._swap_lock:
                        if self._pending_restore is None:
                            self._pending_restore = {}
                        self._pending_restore[rep.index] = vals
                    _log.structured("swap_flip_skipped_wedged",
                                    replica=rep.index)
                    continue
                self._flip(prior, skip_wedged=True)  # restore flipped
                raise SwapRejectedError(
                    "replica %d execution lock not acquired within "
                    "%.0fs (wedged execution?) — swap aborted, prior "
                    "weights restored" % (rep.index,
                                          self.FLIP_LOCK_TIMEOUT))
            try:
                t0 = time.perf_counter()
                prior[rep.index] = {n: rep.scope.find_var(n)
                                    for n in vals}
                for name, val in vals.items():
                    rep.scope.set_var(name, val)
                worst = max(worst, time.perf_counter() - t0)
                if self._pending_restore is not None:
                    # this flip just installed NEWER values: a stale
                    # pending restore must not clobber them later
                    with self._swap_lock:
                        if self._pending_restore is not None:
                            self._pending_restore.pop(rep.index, None)
                            if not self._pending_restore:
                                self._pending_restore = None
            finally:
                rep.lock.release()
        _deploy.SWAP_BLACKOUT_SECONDS.observe(worst)
        return prior

    def _stage(self, new_host):
        """Per-replica device copies of the new weights, the copies
        finished before returning (kept out of the flip's lock window:
        the blackout is the flip, not a host-to-device copy)."""
        staged = {}
        for rep in self.replicas:
            staged[rep.index] = {n: torch.tensor(v, device=rep.device)
                                 for n, v in new_host.items()}
            if rep.device.type == "cuda":
                torch.cuda.synchronize(rep.device)
        return staged

    def swap_weights(self, model_dir, canary=True, watch_requests=50,
                     watch_failures=3):
        """Hot-swap the engine onto the weights in ``model_dir``
        without dropping traffic. Returns the new weights version.

        The push lands in three gates, each of which rejects with
        :class:`SwapRejectedError` while the prior weights keep
        serving untouched:

        1. **validate** — artifact sha256 manifest verification, then a
           full load into a staging scope and a parameter-set +
           shape/dtype signature match against the live weights (the
           program is NOT swapped: same architecture, new values — so
           every compiled bucket survives the swap).
        2. **canary** — one warmed-bucket execution against the new
           weights in a throwaway scope (replica 0, under its batch
           lock); errors or non-finite outputs reject the push.
        3. **flip** — per replica, under its execution lock: stage the
           new values onto the device first, then swap scope pointers
           between drained batches. No batch ever sees mixed versions;
           the blackout is the lock-held pointer flip
           (``paddle_deploy_swap_blackout_seconds``).

        After the flip a watch window arms: ``watch_failures``
        CONSECUTIVE execution failures within the next
        ``watch_requests`` requests auto-roll back to the prior
        weights (counted in ``paddle_deploy_swap_rolled_back_total``),
        and the request that trips the rollback retries transparently
        against the restored weights. ``watch_requests=0`` disarms the
        watch (the swap commits immediately)."""
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        with self._swap_admin:
            _deploy.SWAP_TOTAL.inc()
            try:
                _faults.fire_point("swap_bad_artifact")
                stage_scope = Scope()
                # load_inference_model digest-verifies manifested
                # artifacts before trusting the params (one hash per
                # member — no separate verify pass) and raises the
                # reason into this block
                program2, feeds2, fetches2 = _io.load_inference_model(
                    model_dir, Executor(device="cpu"), scope=stage_scope,
                    quant_compute=self._quant_compute)
                if self._quant_compute and \
                        getattr(self.program, "_quant_compute",
                                None) and \
                        not getattr(program2, "_quant_compute",
                                    None):
                    # the engine serves int8-armed weights but the
                    # push is a plain f32 artifact (no quant.json —
                    # install_quant_compute was a no-op): quantize
                    # the staged scope in place so the push gains the
                    # int8 vars + @quant.scale sidecars the live
                    # signature check expects. Without this, ANY f32
                    # push to an int8-armed engine trips the dtype
                    # gate — and so does the rollback that follows.
                    from . import quant as _quant
                    _quant.arm_quant_compute([program2], stage_scope)
                if list(feeds2) != list(self.feed_names) or \
                        list(fetches2) != list(self.fetch_names):
                    raise ValueError(
                        "feed/fetch signature mismatch: push has "
                        "%s -> %s, engine serves %s -> %s"
                        % (feeds2, fetches2, self.feed_names,
                           self.fetch_names))
                new_host = {n: _host(v) for n, v in stage_scope.items()}
                if tuple(sorted(new_host)) != self._param_names:
                    raise ValueError(
                        "parameter set mismatch: push has %d vars, "
                        "engine serves %d" % (len(new_host),
                                              len(self._param_names)))
                live = self.replicas[0].scope
                for name, val in new_host.items():
                    cur = live.find_var(name)
                    if tuple(val.shape) != tuple(cur.shape) or \
                            _dtype_name(val) != _dtype_name(cur):
                        raise ValueError(
                            "signature mismatch on %r: push %s/%s vs "
                            "live %s/%s" % (name, val.shape, val.dtype,
                                            tuple(cur.shape),
                                            _dtype_name(cur)))
            except Exception as exc:
                _deploy.SWAP_ROLLED_BACK.inc()
                _log.structured("swap_rejected", stage="validate",
                                model_dir=str(model_dir),
                                error=repr(exc))
                raise SwapRejectedError(
                    "weight push rejected during validation: %s"
                    % (exc,)) from exc
            if canary:
                try:
                    _faults.fire_point("swap_canary_fail")
                    self._run_canary(new_host)
                except Exception as exc:
                    _deploy.SWAP_ROLLED_BACK.inc()
                    _log.structured("swap_rejected", stage="canary",
                                    model_dir=str(model_dir),
                                    error=repr(exc))
                    raise SwapRejectedError(
                        "canary run failed — push rejected: %s"
                        % (exc,)) from exc
            staged = self._stage(new_host)
            # Install the watch BEFORE the flip: the instant any
            # replica serves the new weights, a failure there must
            # find the watch armed — installing it after the flip
            # leaves a window where a bad push's failures take the
            # fast path or surface to clients. The watch shares the
            # ``prior`` dict the flip populates; a rollback tripped
            # mid-flip blocks on _swap_admin (held here) until the
            # flip is complete, so it always restores the full fleet.
            prior = {}
            with self._swap_lock:
                self._swap_watch = None if not watch_requests else {
                    "prior": prior,
                    "remaining": int(watch_requests),
                    "consecutive": 0,
                    "threshold": max(1, int(watch_failures)),
                    "version": self._weights_version + 1,
                }
            try:
                self._flip(staged, prior_out=prior)
            except SwapRejectedError:
                # a wedged replica aborted the flip mid-way; the
                # already-flipped replicas were restored — the push
                # did not land
                with self._swap_lock:
                    self._swap_watch = None
                _deploy.SWAP_ROLLED_BACK.inc()
                _log.structured("swap_rejected", stage="flip",
                                model_dir=str(model_dir))
                raise
            with self._swap_lock:
                self._weights_version += 1
                version = self._weights_version
            _log.structured("swap_committed", model_dir=str(model_dir),
                            version=version,
                            watch_requests=int(watch_requests))
            return version

    def _swap_note(self, ok):
        """Feed one request outcome to the post-swap watch. Returns
        True when THIS failure tripped the auto-rollback (the caller
        then retries once against the restored weights)."""
        rollback_prior = rollback_version = None
        with self._swap_lock:
            watch = self._swap_watch
            if watch is None:
                return False
            if ok:
                watch["consecutive"] = 0
            else:
                watch["consecutive"] += 1
            watch["remaining"] -= 1
            if not ok and watch["consecutive"] >= watch["threshold"]:
                rollback_prior = watch["prior"]
                rollback_version = watch["version"]
                self._swap_watch = None
                self._rollback_pending = True
            elif watch["remaining"] <= 0:
                self._swap_watch = None
                _log.structured("swap_watch_committed",
                                version=watch["version"])
        if rollback_prior is None:
            return False
        # Serialize the restore flip with swap_weights: a concurrent
        # swap's flip must never interleave with this one (the two
        # would leave replicas on MIXED versions — per-replica lock
        # order differs), and if a newer swap already landed while we
        # raced for the admin lock, its weights supersede the bad push
        # — there is nothing left to restore.
        try:
            with self._swap_admin:
                with self._swap_lock:
                    if self._weights_version != rollback_version:
                        _log.structured("swap_rollback_superseded",
                                        watched_version=rollback_version,
                                        current=self._weights_version)
                        return False
                # the restore must make progress past a wedged replica
                # — its values stay PENDING and are installed under
                # its lock before its next execution
                # (_apply_pending_restore), so recovery can't
                # resurrect the rejected weights
                self._flip(rollback_prior, skip_wedged=True)
                with self._swap_lock:
                    self._weights_version += 1
        finally:
            with self._swap_lock:
                self._rollback_pending = False
        _deploy.SWAP_ROLLED_BACK.inc()
        _log.structured("swap_rolled_back",
                        restored_version=self._weights_version)
        return True

    # -- startup ---------------------------------------------------------
    def _prime_bucket(self, bucket, feed):
        """Prime one bucket from the artifact's exported program instead
        of building it (reference ``_prime_bucket``): the index must name
        this runtime and environment (a reference index names jax: its
        pickled blob is never read), the replica's device must be the
        exporting one, the blob's sha256 must match the index, and it is
        deserialized once for every replica; each replica's
        ``prime_aot`` is gated by the executor cache digest. Returns
        {replica index: cache entry} of the replicas primed (warmup runs
        each and only THEN counts the AOT load, or a fallback if the call
        degraded); every miss here is a counted fallback."""
        index = self._aot_index
        entry = (index or {}).get("buckets", {}).get(str(bucket))
        if entry is None:
            return {}
        env = (index or {}).get("env") or {}
        compiled = None
        primed = {}
        for rep in self.replicas:
            try:
                if not entry.get("digest"):
                    # no digest = no gate: never install a program the
                    # executor cannot prove is THIS step
                    raise ValueError(
                        "index entry for bucket %d carries no executor "
                        "digest" % bucket)
                if env.get("runtime") != "torch":
                    raise ValueError(
                        "compiled/%s was exported by another runtime; "
                        "this engine runs the program" % entry.get("file"))
                if env != _cc.env_fingerprint(rep.device):
                    raise ValueError("compiled/ was exported in another "
                                     "environment")
                if (rep.device.index or 0) != index.get("device_id"):
                    raise ValueError(
                        "replica device %d != exported device %r"
                        % (rep.device.index or 0, index.get("device_id")))
                if compiled is None:
                    compiled = _cc.deserialize_compiled(
                        _deploy.read_compiled_blob(self._artifact_dir,
                                                   entry))
                cache_entry = rep.exe.prime_aot(
                    self.program, feed, self.fetch_names, rep.scope,
                    compiled, expect_digest=entry["digest"])
            except Exception as e:
                _deploy.AOT_FALLBACKS.inc()
                _log.structured("aot_prime_fallback", bucket=bucket,
                                replica=rep.index, error=repr(e))
                continue
            # the primed execution is no compile (warmup counts one if
            # the call degrades)
            rep.seen.add(tuple(sorted((n, a.shape)
                               for n, a in feed.items())))
            primed[rep.index] = cache_entry
        return primed

    def warmup(self, example_feed=None):
        """Make every bucket on every replica ready ahead of traffic:
        prime it from the artifact's exported program when one matches,
        then run it once (on the card twice: the second run captures the
        step). Feature dims come from the program's feed vars; a
        model with dynamic (non-batch) dims needs ``example_feed`` — one
        example per feed name, WITHOUT the batch dim. Returns the warmed
        buckets. The smallest warmed bucket also becomes the breaker
        probe's health-check execution."""
        specs = {}
        for name in self.feed_names:
            if example_feed is not None and name in example_feed:
                ex = np.asarray(example_feed[name])
                specs[name] = (ex.shape, ex.dtype)
                continue
            spec = self._feed_specs.get(name)
            if spec is None:
                return []  # unknown feed var: nothing synthesizable
            specs[name] = (tuple(spec[0][1:]), spec[1])
        warmed = []
        for b in self.buckets:
            feed = _deploy.synth_bucket_feed(specs, b)
            if feed is None:
                continue  # dynamic feature dim, can't synthesize
            primed = self._prime_bucket(b, feed) if self._aot_index else {}
            for rep in self.replicas:
                # a primed replica runs too: one batch through the
                # installed program validates it now, and only a program
                # that survives its call counts as an AOT load. On the
                # card a second run captures the step
                self._execute(rep, feed, b)
                if _executor.graphs_on(rep.device):
                    self._execute(rep, feed, b)
                centry = primed.get(rep.index)
                if centry is None:
                    continue
                if centry.aot is not None and not centry.aot_failed:
                    _deploy.AOT_LOADS.inc()
                else:
                    _deploy.AOT_FALLBACKS.inc()
                    _BUCKET_COMPILES.labels(bucket=b).inc()
                    _log.structured("aot_prime_call_fallback", bucket=b,
                                    replica=rep.index)
            if not warmed:
                self._probe_feed = (feed, b)
            warmed.append(b)
        return warmed
