"""Fleet autoscaling: capacity as a control loop over SLO pressure
(reference ``paddle_tpu/serving/autoscale.py``).

A :class:`FleetAutoscaler` owned by a
:class:`~paddle_tpu_torch.serving.fleet.FleetRouter`'s monitor tick

* **scales up** — spawns one EngineWorker process per cooldown window
  when the SLO is under pressure: the fast-window burn rate
  (observability/slo.py) is over ``autoscale_burn_threshold``, OR the
  fleet shed anything since the last tick while the router's
  placement-wait EWMA is rising (load is arriving faster than members
  absorb it). Spawned workers warm from the persistent compile
  cache (``compile_cache_dir``: they load stored programs instead of
  building them) and join through the existing REG/generation
  discipline — the autoscaler never touches membership directly, it
  only launches a process and watches for its REG;
* **scales down** — drains then retires one member per cooldown
  window once it has held zero in-flight requests for
  ``autoscale_idle_ms`` and no pressure signal is live, preferring
  its own newest spawns and never dropping below
  ``fleet_members_min``;
* **stays stable** — one capacity action per ``autoscale_cooldown_ms``
  (hysteresis), hard ``fleet_members_min``/``fleet_members_max``
  bounds, and no action while a spawn or retire is still in flight,
  so a flapping breaker or a noisy burn signal cannot oscillate
  capacity.

A spawn that fails or wedges never blocks the monitor loop: the
launch itself runs on a short daemon thread, the pending entry is
registered *before* the process starts so the tick's sweep bounds it
by ``autoscale_spawn_timeout_ms`` (exited-before-REG and
wedged-past-the-bound both get killed and charged), and
``autoscale_spawn_failures`` consecutive-failure budget halts further
spawning — a persistently broken launch path degrades to a
fixed-size fleet, not a fork/crash loop. A spawn callback that starts
a worker on a CUDA card starts a new interpreter
(``subprocess.Popen``): a CUDA context does not survive ``fork``.

The controller owns NO thread of its own: ``tick()`` is called from
the router's existing monitor loop (or manually, with an explicit
``now``/``burn``, which is how the simulated-clock unit tests drive
it). Default flags construct no autoscaler at all — the router's
monitor gates on one attribute-is-None check.

Fault sites (resilience/faults.py): ``fleet_spawn_fail`` (raise: the
spawn dies before its REG — charged to the budget), ``fleet_spawn_slow``
(arm a callback sleeping past ``autoscale_spawn_timeout_ms``: the
spawn wedges and the sweep kills + charges it).
"""

import itertools
import threading
import time

from .. import config as _config
from ..observability import flight as _flight
from ..observability import metrics as _metrics
from ..resilience import faults as _faults
from ..utils import log as _log

__all__ = ["FleetAutoscaler"]

_SCALE_UPS = _metrics.REGISTRY.counter(
    "paddle_autoscale_scale_ups_total",
    "Capacity-up actions (spawn launched), by trigger signal",
    labelnames=("reason",))
_SCALE_DOWNS = _metrics.REGISTRY.counter(
    "paddle_autoscale_scale_downs_total",
    "Capacity-down actions (idle member drained and retired)")
_SPAWN_FAILURES = _metrics.REGISTRY.counter(
    "paddle_autoscale_spawn_failures_total",
    "Provisioning failures charged to the budget, by cause (error: "
    "the spawn callable raised; exit: the process died before REG; "
    "timeout: no REG within autoscale_spawn_timeout_ms; page_in: a "
    "model page-in failed or wedged — serving/model_paging.py)",
    labelnames=("cause",))
_SPAWN_JOIN_MS = _metrics.REGISTRY.histogram(
    "paddle_autoscale_spawn_to_join_ms",
    "Launch-to-REG latency of autoscaler-spawned members (the "
    "scale-up-to-first-token floor)",
    buckets=_metrics.LATENCY_MS_BUCKETS)
_PENDING = _metrics.REGISTRY.gauge(
    "paddle_autoscale_pending_spawns",
    "Spawns launched but not yet REGistered", labelnames=("scaler",))
_PRESSURE = _metrics.REGISTRY.gauge(
    "paddle_autoscale_pressure",
    "1 while a scale-up signal (burn over threshold, or sheds with a "
    "rising placement wait) is live", labelnames=("scaler",))
_WAIT_GAUGE = _metrics.REGISTRY.gauge(
    "paddle_autoscale_queue_wait_ms",
    "The router's placement-wait EWMA as sampled at the last tick "
    "(the load signal the shed-rate trigger is gated on)",
    labelnames=("scaler",))

_ids = itertools.count(1)


class _PendingSpawn:
    __slots__ = ("mid", "handle", "t0", "deadline", "reason", "joined")

    def __init__(self, mid, t0, deadline, reason):
        self.mid = mid
        self.handle = None   # set by the launch thread once spawned
        self.t0 = t0
        self.deadline = deadline
        self.reason = reason
        self.joined = False  # swept as joined, not charged


class FleetAutoscaler:
    """The capacity control loop for one
    :class:`~paddle_tpu_torch.serving.fleet.FleetRouter`.

    ``spawn`` is the launch callable: ``spawn(member_id)`` starts one
    EngineWorker process that will REGister with the router under that
    id, and returns a process handle exposing ``poll()`` (None while
    alive) and ``kill()`` — ``subprocess.Popen`` satisfies it, and the
    unit tests pass fakes. The callable may block (it runs on a short
    daemon thread, never on the monitor); its member joins, or gets
    swept, through the pending table.

    Constructing an autoscaler attaches it to the router (the
    router's monitor loop ticks whatever is attached); ``close()``
    detaches. All ``None`` knobs resolve from config flags HERE, at
    construction — nothing in ``tick()`` reads a flag.
    """

    def __init__(self, router, spawn, members_min=None, members_max=None,
                 burn_threshold=None, cooldown_ms=None, idle_ms=None,
                 spawn_timeout_ms=None, spawn_failure_budget=None,
                 member_prefix=None, drain_timeout=10.0):
        if members_max is None:
            members_max = _config.get_flag("fleet_members_max")
        if burn_threshold is None:
            burn_threshold = _config.get_flag("autoscale_burn_threshold")
        if cooldown_ms is None:
            cooldown_ms = _config.get_flag("autoscale_cooldown_ms")
        if idle_ms is None:
            idle_ms = _config.get_flag("autoscale_idle_ms")
        if spawn_timeout_ms is None:
            spawn_timeout_ms = _config.get_flag("autoscale_spawn_timeout_ms")
        if spawn_failure_budget is None:
            spawn_failure_budget = _config.get_flag(
                "autoscale_spawn_failures")
        self.router = router
        self.spawn = spawn
        # members_min defaults from the router (already flag-resolved
        # there — the autoscaler adds no second read of it).
        self.members_min = int(router.members_min
                               if members_min is None else members_min)
        self.members_max = int(members_max)
        self.burn_threshold = float(burn_threshold)
        self.cooldown = float(cooldown_ms) / 1e3
        self.idle = float(idle_ms) / 1e3
        self.spawn_timeout = float(spawn_timeout_ms) / 1e3
        self.spawn_failure_budget = int(spawn_failure_budget)
        self.drain_timeout = float(drain_timeout)
        self.label = "%s:as" % getattr(router, "label", "fleet")
        self.member_prefix = ("as%d" % next(_ids)
                              if member_prefix is None else member_prefix)
        self._lock = threading.Lock()
        self._closed = False
        self._pending = {}        # mid -> _PendingSpawn
        self._spawned = []        # mids this scaler launched, join order
        self._retiring = set()
        self._idle_since = {}     # mid -> first tick seen with 0 inflight
        self._seq = itertools.count(1)
        self._last_action = None  # time of the last capacity action
        self._prev_ewma = 0.0
        self._prev_sheds = 0.0
        self.spawn_failures = 0
        self.halted = False
        self.ticks = 0
        router.attach_autoscaler(self)

    # -- the control loop --------------------------------------------------

    def tick(self, now=None, burn=None):
        """One controller step: sweep pending spawns, read the
        signals, take at most one capacity action. Called from the
        router's monitor loop (``now``/``burn`` supplied there), or
        manually with a simulated clock. Never blocks: spawns and
        retires run on daemon threads."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._closed:
                return
            self.ticks += 1
            self._sweep_locked(now)
            pressure, reason = self._signals_locked(now, burn)
            busy = bool(self._pending) or bool(self._retiring)
            in_cooldown = (self._last_action is not None
                           and now - self._last_action < self.cooldown)
            n = self._capacity_locked()
            if pressure and not busy and not in_cooldown \
                    and not self.halted and n < self.members_max:
                self._launch_locked(now, reason)
            elif not pressure and not busy and not in_cooldown \
                    and n > self.members_min:
                self._maybe_retire_locked(now)

    def _capacity_locked(self):
        """Members the controller considers provisioned: live (in any
        serving state) plus spawns still pending REG."""
        return len(self.router.members_live()) + len(self._pending)

    def _sweep_locked(self, now):
        """Resolve pending spawns: REGistered -> joined; exited before
        REG or past the deadline -> killed and charged. The sweep is
        the ONLY place a wedged spawn is bounded — the launch thread
        itself may block forever without holding anything up."""
        if not self._pending:
            return
        live = set(self.router.members_live())
        for mid in list(self._pending):
            rec = self._pending[mid]
            if mid in live:
                del self._pending[mid]
                rec.joined = True
                self._spawned.append(mid)
                _SPAWN_JOIN_MS.observe((now - rec.t0) * 1e3)
                _log.structured("autoscale_member_joined",
                                scaler=self.label, member=mid,
                                join_ms=round((now - rec.t0) * 1e3, 1))
            elif rec.handle is not None and rec.handle.poll() is not None:
                self._charge_locked(rec, "exit")
            elif now >= rec.deadline:
                self._charge_locked(rec, "timeout")
        _PENDING.labels(scaler=self.label).set(len(self._pending))

    def _signals_locked(self, now, burn):
        """The scale-up predicate: fast-window burn over threshold, or
        any shed since the last tick while the placement wait is
        rising. Returns ``(pressure, reason)``."""
        ewma = float(getattr(self.router, "place_wait_ewma", 0.0))
        sheds = float(getattr(self.router, "shed_signal", lambda: 0.0)())
        shed_delta = sheds - self._prev_sheds
        rising = ewma > self._prev_ewma
        self._prev_sheds = sheds
        self._prev_ewma = ewma
        if burn is not None and burn > self.burn_threshold:
            verdict = (True, "burn")
        elif shed_delta > 0 and rising:
            verdict = (True, "shed")
        else:
            verdict = (False, None)
        _PRESSURE.labels(scaler=self.label).set(1.0 if verdict[0] else 0.0)
        _WAIT_GAUGE.labels(scaler=self.label).set(ewma * 1e3)
        return verdict

    # -- scale up ----------------------------------------------------------

    def _launch_locked(self, now, reason):
        mid = "%s-%d" % (self.member_prefix, next(self._seq))
        rec = _PendingSpawn(mid, now, now + self.spawn_timeout, reason)
        self._pending[mid] = rec
        self._last_action = now
        _SCALE_UPS.labels(reason=reason).inc()
        _PENDING.labels(scaler=self.label).set(len(self._pending))
        _log.structured("autoscale_scale_up", scaler=self.label,
                        member=mid, reason=reason)
        t = threading.Thread(target=self._spawn_thread, args=(rec,),
                             daemon=True, name="autoscale-spawn-%s" % mid)
        t.start()
        return mid

    def _spawn_thread(self, rec):
        try:
            # a raising spec here IS the spawn that died before REG
            _faults.fire_point("fleet_spawn_fail", index=rec.mid)
            handle = self.spawn(rec.mid)
            with self._lock:
                # a spawn callable may block until its member is up, and
                # the member registers before it returns: a sweep that
                # already saw it join leaves it be (the reference kills
                # it here, taking every such pending entry for one the
                # sweep charged)
                if rec.mid in self._pending or rec.joined:
                    rec.handle = handle
                    handle = None
            if handle is not None:   # already swept (charged)
                _kill_quietly(handle)
            # an armed callback sleeping past autoscale_spawn_timeout_ms
            # wedges the launch thread; the sweep charges the spawn
            _faults.fire_point("fleet_spawn_slow", index=rec.mid)
        except Exception as exc:
            with self._lock:
                if rec.mid in self._pending:
                    self._charge_locked(rec, "error")
            _log.structured("autoscale_spawn_error", scaler=self.label,
                            member=rec.mid, error=str(exc))

    def _charge_locked(self, rec, cause):
        """A spawn failed: kill what's left of it, charge the budget,
        halt spawning when the budget is spent."""
        self._pending.pop(rec.mid, None)
        if rec.handle is not None:
            _kill_quietly(rec.handle)
        self.spawn_failures += 1
        _SPAWN_FAILURES.labels(cause=cause).inc()
        _log.structured("autoscale_spawn_charged", scaler=self.label,
                        member=rec.mid, cause=cause,
                        failures=self.spawn_failures,
                        budget=self.spawn_failure_budget)
        if not self.halted \
                and self.spawn_failures >= self.spawn_failure_budget:
            self.halted = True
            _log.structured("autoscale_halted", scaler=self.label,
                            failures=self.spawn_failures)
            _flight.RECORDER.trigger_async("autoscale_spawn_budget")

    def charge_failure(self, cause):
        """Charge one provisioning failure that happened OUTSIDE the
        spawn path — a wedged or failed model page-in
        (serving/model_paging.py) spends the same budget a failed
        spawn does: both are capacity actions, and a persistently
        broken one must halt the control loop (flight bundle, halted
        flag) instead of thrashing the fleet."""
        with self._lock:
            self.spawn_failures += 1
            _SPAWN_FAILURES.labels(cause=str(cause)).inc()
            _log.structured("autoscale_spawn_charged",
                            scaler=self.label, member=None,
                            cause=str(cause),
                            failures=self.spawn_failures,
                            budget=self.spawn_failure_budget)
            if not self.halted \
                    and self.spawn_failures >= \
                    self.spawn_failure_budget:
                self.halted = True
                _log.structured("autoscale_halted",
                                scaler=self.label,
                                failures=self.spawn_failures)
                _flight.RECORDER.trigger_async(
                    "autoscale_spawn_budget")

    def request_scale_up(self, reason="manual", now=None):
        """Spawn one member immediately (bench / operator path):
        bypasses the pressure predicate and the cooldown, still honors
        the max bound, the halt, and the one-spawn-in-flight rule.
        Returns the pending member id, or None if refused."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._closed or self.halted or self._pending \
                    or self._capacity_locked() >= self.members_max:
                return None
            return self._launch_locked(now, reason)

    def reset_spawn_budget(self):
        """Re-arm spawning after the failure budget halted it (an
        operator fixed the launch path)."""
        with self._lock:
            self.spawn_failures = 0
            self.halted = False

    # -- scale down --------------------------------------------------------

    def _maybe_retire_locked(self, now):
        loads = self.router.member_loads()
        # idle bookkeeping: a member is a retire candidate only after
        # holding zero in-flight continuously for idle_ms
        for mid, inflight in loads.items():
            if inflight > 0:
                self._idle_since.pop(mid, None)
            else:
                self._idle_since.setdefault(mid, now)
        for mid in list(self._idle_since):
            if mid not in loads:
                del self._idle_since[mid]
        idle = [mid for mid, t0 in self._idle_since.items()
                if now - t0 >= self.idle and mid not in self._retiring]
        if not idle:
            return
        # prefer our own newest spawn (last hired, first retired); a
        # hand-launched member only goes when nothing we spawned is idle
        own = [mid for mid in reversed(self._spawned) if mid in idle]
        mid = own[0] if own else sorted(idle)[-1]
        self._retiring.add(mid)
        self._last_action = now
        self._idle_since.pop(mid, None)
        _log.structured("autoscale_scale_down", scaler=self.label,
                        member=mid)
        t = threading.Thread(target=self._retire_thread, args=(mid,),
                             daemon=True, name="autoscale-retire-%s" % mid)
        t.start()

    def _retire_thread(self, mid):
        try:
            ok = self.router.retire_member(mid,
                                           drain_timeout=self.drain_timeout)
        except Exception as exc:
            ok = False
            _log.structured("autoscale_retire_error", scaler=self.label,
                            member=mid, error=str(exc))
        with self._lock:
            self._retiring.discard(mid)
            if ok:
                if mid in self._spawned:
                    self._spawned.remove(mid)
                _SCALE_DOWNS.inc()

    # -- introspection -----------------------------------------------------

    def doc(self, now=None):
        """The ``/debug/fleet`` autoscale section."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return {
                "members_min": self.members_min,
                "members_max": self.members_max,
                "burn_threshold": self.burn_threshold,
                "cooldown_ms": self.cooldown * 1e3,
                "idle_ms": self.idle * 1e3,
                "pending": sorted(self._pending),
                "retiring": sorted(self._retiring),
                "spawned": list(self._spawned),
                "spawn_failures": self.spawn_failures,
                "halted": self.halted,
                "ticks": self.ticks,
                "last_action_age_s": None if self._last_action is None
                else round(now - self._last_action, 3),
                "place_wait_ewma_ms": round(self._prev_ewma * 1e3, 3),
            }

    def close(self):
        """Detach from the router and kill anything still pending.
        Joined members are the router's to manage (its close drops
        them); only un-REGistered spawns are ours to reap."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pending = list(self._pending.values())
            self._pending.clear()
        for rec in pending:
            if rec.handle is not None:
                _kill_quietly(rec.handle)
        if getattr(self.router, "_autoscaler", None) is self:
            self.router.attach_autoscaler(None)
        _metrics.REGISTRY.remove_labeled("scaler", value=self.label)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _kill_quietly(handle):
    try:
        handle.kill()
    except Exception:
        pass
