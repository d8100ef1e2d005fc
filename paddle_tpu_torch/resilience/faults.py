"""Deterministic fault injection for chaos testing (reference
``paddle_tpu/resilience/faults.py``).

The registry maps a *site* (a string naming a hook point in the
production code path) to armed :class:`FaultSpec` s. Hook sites call
``fire_point(site, index)``, a no-op unless the ``fault_injection``
config flag is on and a spec armed for that site matches ``index``.
Matching specs execute their action exactly ``times`` times, so chaos
tests are reproducible.

The port's hook sites (the reference's names, all of them):

==============================  ===========================================
site                            where / what
==============================  ===========================================
``generation_step_fail``        GenerationScheduler decode dispatch, before
                                the session's step; ``index`` is the
                                session number. ``times=None`` arms
                                persistent mode (the session is broken
                                until disarmed)
``generation_admit_fail``       GenerationScheduler, before a prompt's
                                prefill admission (replays included);
                                indexed by session
``generation_session_wedge``    GenerationScheduler, inside the (possibly
                                worker-bounded) step dispatch; arm with
                                ``action="callback"`` sleeping past
                                ``generation_step_timeout_ms`` to simulate
                                a wedged decode step
``decode_draft_mismatch``       GenerationSession speculative verify;
                                ``index`` is the slot: one firing forces
                                that slot's round to accept zero drafts
``decode_constraint_dead_end``  GenerationScheduler, after each landed
                                token of a constrained request; ``index``
                                is the slot: a firing forces the dead-end
                                verdict (the typed ConstraintDeadEnd)
``nan_loss``                    ResilientTrainer, before the step
                                (:func:`poison_feed`): the first float
                                feed is NaN, so the NaN flows through the
                                real computation; a packed batch is
                                poisoned in a copy of its buffer
``checkpoint_crash``            ``io.save_checkpoint``, after every file of
                                the checkpoint is written and before it is
                                published; ``index`` is the step
``collective_hang``             ResilientTrainer, inside the step's
                                watchdog window
                                (:func:`simulate_collective_hang`): the
                                step blocks like an all-reduce whose peer
                                died; only the watchdog's abort
                                escalation gets out
``reader_error``                ResilientTrainer's reader, before it
                                yields sample ``index``: raises the armed
                                exception (default IOError, inside the
                                resilient reader's transient set)
``worker_kill``                 ResilientTrainer, before the step; arm
                                with ``action="kill"`` to SIGKILL one
                                worker of an elastic run mid-pass
``master_kill``                 ElasticDataDispatcher.reader, once per
                                task lease; arm with a callback that kills
                                (and restarts) the master
``heartbeat_drop``              MembershipHeartbeat; ``index`` is the beat
                                number: a firing swallows the beat, so
                                ``times=K`` is K beats of partition and a
                                master-declared death of a live process
``serving_replica_fail``        ServingEngine, before a replica executes a
                                batch; ``index`` is the replica number
``serving_replica_slow``        ServingEngine, inside the replica's
                                execution lock (on its bounded worker when
                                the engine has a timeout); arm with
                                ``action="callback"`` sleeping past the
                                timeout to simulate a wedged replica
``serving_overload``            MicroBatcher.submit; ``index`` is the
                                submit sequence number: a firing sheds
                                the submit (ServingOverloadError)
``cache_corrupt``               PersistentCompileCache.load, before the
                                manifest read: a raising spec is treated
                                exactly like on-disk corruption (the entry
                                is quarantined and the caller rebuilds)
``swap_bad_artifact``           ServingEngine.swap_weights, at the start
                                of validation (the push is rejected)
``swap_canary_fail``            ServingEngine.swap_weights, before the
                                canary run (the push is rejected)
``fleet_member_kill``           EngineWorker's token-stream loop; ``index``
                                is the request's streamed-token count: arm
                                with ``action="kill"`` in the worker
                                process to SIGKILL the member
                                mid-generation (the router re-drives its
                                in-flight journals on a peer)
``fleet_network_partition``     both ends of the fleet wire: the router
                                fires it before dispatching to a member
                                (``index`` = member id, default exception
                                ConnectionError) and the worker's
                                heartbeat loop swallows beats under it, so
                                one arm per process is one direction of a
                                partition
``fleet_slow_member``           EngineWorker, before serving a request;
                                ``index`` is the member id: a callback
                                sleeping past the router's call timeout is
                                a wedged member (a hang opens its breaker)
``fleet_spawn_fail``            FleetAutoscaler's launch thread, before the
                                spawn callable runs; ``index`` is the
                                would-be member id: a raising spec is the
                                spawn that died before registering,
                                charged to the spawn-failure budget
``fleet_spawn_slow``            FleetAutoscaler's launch thread, after the
                                spawn callable returned: a callback
                                sleeping past
                                ``autoscale_spawn_timeout_ms`` wedges the
                                launch; the tick's sweep kills the handle
                                and charges the budget
``model_page_in_fail``          EngineWorker's page_in handler, before any
                                weight lands; ``index`` is the model id: a
                                raising spec is a refused artifact (the
                                member keeps its resident set; the router
                                charges the spawn-failure budget)
``model_page_in_slow``          EngineWorker's page_in handler; ``index``
                                is the model id: a callback sleeping past
                                ``model_page_timeout_ms`` wedges the
                                page-in (the router times it out, charges
                                the budget and retries on a peer)
``model_evict_race``            FleetRouter's eviction pressure, between
                                victim selection and the page_out send;
                                ``index`` is the victim's model id: a
                                raising spec aborts the eviction round
==============================  ===========================================

Actions: ``"raise"`` (raise ``exc``, default :class:`InjectedFault`),
``"kill"`` (``os.kill(os.getpid(), SIGKILL)`` — the real
process-death simulation for subprocess chaos tests), or
``"callback"`` (run an arbitrary callable, e.g. kill a helper daemon).
"""

import collections.abc
import os
import signal
import threading
import time

from .. import config as _config
from ..utils import log as _log

__all__ = ["InjectedFault", "arm", "disarm", "armed", "should_fire",
           "fire_point", "poison_feed", "simulate_collective_hang"]


class InjectedFault(Exception):
    """Raised by an armed ``action="raise"`` fault."""


class FaultSpec:
    __slots__ = ("site", "at", "times", "action", "exc", "callback")

    def __init__(self, site, at=None, times=1, action="raise", exc=None,
                 callback=None):
        if action not in ("raise", "kill", "callback"):
            raise ValueError("unknown fault action %r" % (action,))
        if action == "callback" and callback is None:
            raise ValueError("action='callback' needs a callback")
        self.site = site
        self.at = at          # index (step/batch) to fire at; None = any
        # remaining firings; None = persistent (fires on every match
        # until disarmed — the "session is broken, not glitching"
        # chaos shape)
        self.times = times
        self.action = action
        self.exc = exc
        self.callback = callback


_LOCK = threading.Lock()
_ARMED = {}  # site -> [FaultSpec]


def arm(site, at=None, times=1, action="raise", exc=None, callback=None):
    """Arm a fault (also flips the ``fault_injection`` config flag on).
    ``times=None`` arms PERSISTENT mode: the fault fires on every
    match until ``disarm()`` — "this session/replica is broken", as
    opposed to the counted "it glitched N times"."""
    spec = FaultSpec(site, at=at, times=times, action=action, exc=exc,
                     callback=callback)
    with _LOCK:
        _ARMED.setdefault(site, []).append(spec)
    if not _config.get_flag("fault_injection"):
        _config.set_flags(fault_injection=True)
    return spec


def disarm(site=None):
    """Drop armed faults for ``site`` (or all of them). When nothing
    remains armed, the ``fault_injection`` master switch is cleared too:
    hook sites go back to one flag check."""
    with _LOCK:
        if site is None:
            _ARMED.clear()
        else:
            _ARMED.pop(site, None)
        empty = not any(_ARMED.values())
    if empty and _config.get_flag("fault_injection"):
        _config.set_flags(fault_injection=False)


def armed(site=None):
    with _LOCK:
        if site is None:
            return {s: list(v) for s, v in _ARMED.items()}
        return list(_ARMED.get(site, ()))


def should_fire(site, index=None):
    """The matching armed spec (consuming one firing), or None.

    Cheap when disarmed: one config-flag check, no lock."""
    if not _config.get_flag("fault_injection"):
        return None
    with _LOCK:
        for spec in _ARMED.get(site, ()):
            if spec.times is not None and spec.times <= 0:
                continue
            if spec.at is not None and index is not None \
                    and spec.at != index:
                continue
            if spec.times is not None:
                spec.times -= 1
            return spec
    return None


def fire_point(site, index=None, default_exc=None):
    """Hook-site entry: execute the armed action for ``site`` if any.

    Returns the spec when a non-raising action fired (so the caller can
    branch), None when nothing fired. ``default_exc`` lets a hook site
    pick the exception class raised when the armed spec didn't name
    one (e.g. the reader site defaults to IOError so the fault lands
    in the resilient reader's transient set)."""
    spec = should_fire(site, index)
    if spec is None:
        return None
    # stamp the injected fault onto the request being served (chaos
    # probes correlate "which request ate which fault" off the span
    # tree); a thread-local read + None check, nothing when tracing
    # is off
    from ..observability import request_trace as _rtrace
    ctx = _rtrace.current()
    if ctx is not None:
        _rtrace.event(ctx, "faultInjected", site=site, index=index,
                      action=spec.action)
    _log.structured("fault_injected", site=site, index=index,
                    action=spec.action,
                    trace_id=None if ctx is None else ctx.trace_id)
    if spec.action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    if spec.action == "callback":
        spec.callback()
        return spec
    if spec.exc is not None:
        raise spec.exc
    raise (default_exc or InjectedFault)(
        "injected fault at %s[%s]" % (site, index))


def simulate_collective_hang(step, max_sec=600.0):
    """``collective_hang`` hook: when armed for ``step``, block like a
    collective whose peer was killed: an interruptible sleep loop that
    only an asynchronous unwind (KeyboardInterrupt) escapes. A
    ``callback`` spec runs the callback instead. ``max_sec`` is a
    backstop so an unwatched test cannot wedge forever."""
    spec = should_fire("collective_hang", step)
    if spec is None:
        return
    _log.structured("fault_injected", site="collective_hang",
                    index=step, action=spec.action)
    if spec.action == "callback":
        spec.callback()
        return
    deadline = None if max_sec is None else \
        (time.monotonic() + max_sec)
    while deadline is None or time.monotonic() < deadline:
        time.sleep(0.05)
    raise InjectedFault(
        "collective_hang at step %s outlived its %.0fs backstop — "
        "no watchdog abort arrived" % (step, max_sec))


def poison_feed(feed, step):
    """``nan_loss`` hook: overwrite the first float feed array with NaN
    (in a copy) when armed for ``step``, so a non-finite loss flows
    through the unmodified train computation. A packed batch
    (``core/ingest.py``) is poisoned in a copy of its buffer, in the
    byte range of its first float slot, on the buffer's device, so the
    packed path stays on its own code path under chaos testing. Any
    other feed than a dict or a packed batch raises
    NotImplementedError."""
    import numpy as np
    if should_fire("nan_loss", step) is None:
        return feed
    _log.structured("fault_injected", site="nan_loss", index=step,
                    action="poison")
    from ..core.ingest import PackedBatch
    if isinstance(feed, PackedBatch):
        import torch
        for slot in feed.layout:
            dt = np.dtype(slot.dtype)
            if not np.issubdtype(dt, np.floating):
                continue
            nan_bytes = np.frombuffer(
                np.full(slot.nbytes // dt.itemsize, np.nan, dt)
                .tobytes(), np.uint8)
            buf = feed.buffer
            if isinstance(buf, np.ndarray):
                buf = torch.from_numpy(buf)
            if feed.event is not None:
                torch.cuda.current_stream(buf.device).wait_event(feed.event)
            buf = buf.clone()
            buf[:, slot.offset:slot.offset + slot.nbytes] = \
                torch.from_numpy(nan_bytes.copy()).to(buf.device)
            poisoned = PackedBatch(buf, feed.layout, feed.shards,
                                   feed.shard_nbytes, feed.batch_size)
            poisoned.transfer_done = True
            return poisoned
        return feed
    if not isinstance(feed, collections.abc.Mapping):
        raise NotImplementedError(
            "poison_feed of a %s: only a feed dict or a packed batch is "
            "handled" % type(feed).__name__)
    out = dict(feed)
    for name, v in out.items():
        arr = np.asarray(v)
        if np.issubdtype(arr.dtype, np.floating):
            out[name] = np.full_like(arr, np.nan)
            break
    return out
