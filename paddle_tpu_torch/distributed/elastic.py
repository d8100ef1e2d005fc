"""The elastic multi-process training runtime (reference
``paddle_tpu/distributed/elastic.py``), over ``torch.distributed``.

* **Membership**: workers ``register`` with the task master and a
  :class:`MembershipHeartbeat` thread beats on a background cadence. The
  master (``native/task_master.cc``) declares a worker dead after a
  missed-heartbeat deadline, bumps the cluster *generation*, and
  re-leases the dead worker's data chunks at once. Survivors learn of
  the resize when their next beat comes back ``GENMISMATCH``.
* **Hang-free abort**: a killed peer leaves the survivors waiting in an
  all-reduce that no Python code can interrupt (NCCL on the card, gloo
  on the CPU). The resilience
  :class:`~paddle_tpu_torch.resilience.supervisor.StepWatchdog` escalates
  an overrun step through ``on_hang`` -> :func:`collective_abort`, which
  aborts the process group (``launch.abort_multihost``: on NCCL the
  communicators' abort ends the waiting kernel, so the blocked
  synchronize returns), and the watchdog's interrupt then unwinds the
  train loop, bounded by ``step_deadline_sec``. The reference shuts
  ``jax.distributed`` down instead.
* **Resume on a resized world**: :class:`ElasticTrainerLoop` then
  re-registers at the new generation, re-runs ``init_multihost`` at the
  surviving world size under the new generation's store prefix,
  rebuilds the trainer (mesh and DistStrategy at the new size, through
  the caller's ``build`` factory, e.g. ``parallel.resize_strategy``),
  restores the newest intact checkpoint through the digest-verified
  fall-back path, and resumes: the master's lease table is the dataset
  position.

Every transition is visible through the always-on ``paddle_elastic_*``
metrics. Deterministic chaos comes from the ``worker_kill`` /
``heartbeat_drop`` / ``collective_hang`` fault sites
(``resilience/faults.py``).

With the elastic machinery unused (no ElasticTrainerLoop, default
flags) nothing here touches the train path.
"""

import gc
import os
import threading
import time

from .. import config as _config
from ..observability import metrics as _metrics
from ..resilience import faults as _faults
from ..utils import log as _log
from .launch import abort_multihost, init_multihost
from .master import GenerationMismatch, MasterClient

__all__ = ["ElasticTrainerLoop", "ElasticWorld", "MembershipHeartbeat",
           "ElasticRestartLimit", "collective_abort"]

# Recovery counters: always-on (they move on rare events, not per step).
_GENERATION = _metrics.REGISTRY.gauge(
    "paddle_elastic_generation",
    "This worker's view of the cluster membership generation")
_WORKER_DEATHS = _metrics.REGISTRY.counter(
    "paddle_elastic_worker_deaths_total",
    "Peer deaths observed via master generation bumps")
_RESUME_SECONDS = _metrics.REGISTRY.histogram(
    "paddle_elastic_resume_seconds",
    "Restart-trigger to restored-and-ready latency: re-register + "
    "runtime rebuild + digest-verified checkpoint restore")
_RESTARTS = _metrics.REGISTRY.counter(
    "paddle_elastic_restarts_total",
    "Elastic runtime teardown/rebuild cycles on this worker")
_HEARTBEATS = _metrics.REGISTRY.counter(
    "paddle_elastic_heartbeats_total", "Membership heartbeats sent")
_HB_MISSES = _metrics.REGISTRY.counter(
    "paddle_elastic_heartbeat_misses_total",
    "Heartbeats that failed to reach the master (connection errors)")
# resting value so scrapers see the family before the first bring-up
# (0 = this process has not joined a cluster)
_GENERATION.set(0)


class ElasticRestartLimit(RuntimeError):
    """The elastic loop exceeded its restart budget — the job is
    flapping (e.g. the master keeps resizing under it), not healing."""


# Per-master last-seen deaths, shared by every observer in this process
# (heartbeat threads AND trainer loops), so one peer death increments
# paddle_elastic_worker_deaths_total exactly once no matter which path
# noticed it first.
_deaths_seen = {}
_deaths_lock = threading.Lock()


def _observe_deaths(client):
    """Fold the master's authoritative cumulative deaths count into the
    local counter as a delta. The first observation of a master only
    sets the baseline — deaths that predate this process joining are
    not events it witnessed."""
    try:
        deaths = client.cluster()["deaths"]
    except (ConnectionError, OSError, ValueError, IndexError):
        return
    with _deaths_lock:
        last = _deaths_seen.get(client.addr)
        _deaths_seen[client.addr] = deaths
        if last is not None and deaths > last:
            _WORKER_DEATHS.inc(deaths - last)


def collective_abort(reason="", wait_sec=5.0):
    """Abort a (possibly wedged) process group so this process can
    re-initialize at a new world size (``launch.abort_multihost``).

    A collective waiting on a dead peer is abandoned, not waited on: on
    NCCL the communicators' abort ends it on the card. The state a
    strategy placed for the old world is dropped with the trainer: the
    rebuilt Executor re-places it under the new strategy, whose fresh
    uid keys fresh step-cache entries. Safe to call from any thread,
    idempotent, never raises. Returns whether a group was aborted.
    ``wait_sec`` bounds the wait on the communicators' cleanup
    (``launch.abort_multihost``)."""
    _log.structured("elastic_collective_abort", reason=reason)
    return abort_multihost(wait_sec)


class ElasticWorld:
    """What a build factory gets to size the runtime by: the membership
    view at bring-up and the handles it needs to wire a dispatcher."""

    def __init__(self, generation, n_live, worker_id, client,
                 process_id=0, num_processes=1):
        self.generation = generation
        self.n_live = n_live
        self.worker_id = worker_id
        self.client = client          # main-thread MasterClient
        self.process_id = process_id
        self.num_processes = num_processes

    def __repr__(self):
        return ("ElasticWorld(gen=%d, live=%d, worker=%r, proc=%d/%d)"
                % (self.generation, self.n_live, self.worker_id,
                   self.process_id, self.num_processes))


class MembershipHeartbeat:
    """Background liveness beats against the task master.

    Owns its own :class:`MasterClient` (clients are not thread-safe).
    On ``GENMISMATCH`` — a peer died and the master resized, or a
    restarted master forgot us — it re-registers at the current
    generation and fires ``on_change(old_gen, new_gen, n_live)`` so the
    runtime can escalate (typically ``trainer.request_restart``).
    Connection errors are absorbed (the master may be restarting;
    counted in ``paddle_elastic_heartbeat_misses_total``). The
    ``heartbeat_drop`` fault site swallows beats, which is how chaos
    tests force a master-declared death of a live process.
    """

    def __init__(self, port, worker_id, generation, host="127.0.0.1",
                 interval_sec=None, on_change=None):
        self.worker_id = worker_id
        self.generation = generation
        self.interval = (interval_sec if interval_sec is not None else
                         _config.get_flag("elastic_heartbeat_interval_sec"))
        self.on_change = on_change
        self._client = MasterClient(port, host=host, retries=2,
                                    backoff=0.05)
        self._stop_evt = threading.Event()
        self._thread = None
        self._beats = 0

    def start(self):
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="paddle-elastic-heartbeat")
        self._thread.start()
        return self

    def stop(self):
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self):
        _observe_deaths(self._client)  # baseline for the delta
        while not self._stop_evt.wait(self.interval):
            self._beats += 1
            if _faults.should_fire("heartbeat_drop", self._beats):
                continue  # injected network partition: beat never sent
            try:
                self._client.heartbeat(self.worker_id, self.generation)
                _HEARTBEATS.inc()
            except GenerationMismatch:
                self._rejoin()
            except (ConnectionError, OSError):
                _HB_MISSES.inc()

    def _rejoin(self):
        try:
            new_gen, n_live = self._client.register(self.worker_id)
        except (ConnectionError, OSError):
            _HB_MISSES.inc()
            return
        old = self.generation
        if new_gen == old:
            return  # master restart re-registration; membership as was
        self.generation = new_gen
        _GENERATION.set(new_gen)
        _observe_deaths(self._client)
        _log.structured("elastic_generation_change", old=old,
                        new=new_gen, live=n_live,
                        worker=self.worker_id)
        if self.on_change is not None:
            try:
                self.on_change(old, new_gen, n_live)
            except Exception:  # noqa: BLE001 — the beat must go on
                _log.logger().warning(
                    "elastic on_change callback failed", exc_info=True)


class ElasticTrainerLoop:
    """Run a training job that survives peer churn.

    ``build(world)`` is the caller's factory: given an
    :class:`ElasticWorld` it returns ``(trainer, reader)`` — a trainer
    (typically a ResilientTrainer with ``checkpoint_dir`` set and a
    ``step_deadline_sec`` watchdog) and the pass reader (typically an
    :class:`~paddle_tpu_torch.distributed.master.ElasticDataDispatcher`
    reader fenced with ``world.generation``). The factory runs once per
    generation, so mesh, DistStrategy and trainer are rebuilt at every
    resize; the checkpoint is restored by ``trainer.startup()``, the
    digest-verified newest-intact path.

    Restart triggers, all funneled into one teardown/rebuild cycle:

    * the heartbeat thread sees a generation bump ->
      ``trainer.request_restart`` (in-flight step finishes, loop exits
      at the step boundary with a restart record);
    * the step watchdog aborts a hung step (wedged collective) ->
      KeyboardInterrupt unwinds ``train`` after ``on_hang`` ran
      :func:`collective_abort` (an error the aborted group raises
      before the interrupt lands is taken as the same abort);
    * a fenced master call raises :class:`GenerationMismatch`;
    * (the port's, in coordinator mode with ``settle_sec``) a collective
      raises on a peer's death (gloo sees the closed connection at once)
      and the master declares the death within twice ``settle_sec``.

    Every bring-up starts with a membership **rendezvous**: the first
    one blocks until ``min_workers`` (default: ``num_processes``, the
    launch plan) have joined, restarts take whoever is live; the world
    is then sized from one atomic ``MEMBERS`` snapshot, with ranks in
    sorted-worker_id order — consistent across workers because any
    membership change bumps the generation and fences stale views
    into a rebuild.

    With ``coordinator_address`` set, each bring-up re-runs
    ``init_multihost`` (after :func:`collective_abort` aborted the old
    group) with the surviving world size, this worker's membership rank
    and the generation, whose prefix of the coordinator's TCP store
    keeps the new group's rendezvous apart from the old one's. Rank 0
    holds that store: name the coordinator host's worker so it sorts
    first (e.g. ``w0``), and note that losing it, like losing the
    master, is not survivable. ``initialization_timeout_sec`` (60 s when
    None) bounds the rendezvous and every collective of the group, so a
    gloo wait on a dead peer ends there. ``device`` picks the backend as
    ``init_multihost`` does (NCCL by default, gloo for ``"cpu"``).
    Without a coordinator (one process, or a local chaos harness), the
    loop is the same choreography with no group.

    ``settle_sec`` (a port addition; 0, the reference's behavior, by
    default) holds each rendezvous until its member list has not changed
    for that long: with at least the master's heartbeat deadline, a peer
    that died just before the snapshot is reaped first instead of being
    sized into a group that would wait on it.
    """

    def __init__(self, build, master_port, worker_id=None,
                 master_host="127.0.0.1", heartbeat_interval_sec=None,
                 max_restarts=None, coordinator_address=None,
                 num_processes=None,
                 initialization_timeout_sec=None, min_workers=None,
                 rendezvous_timeout_sec=120.0,
                 master_reconnect_sec=30.0, device=None, settle_sec=0.0):
        self.build = build
        self.master_port = master_port
        self.master_host = master_host
        self.worker_id = worker_id or "w-%d" % os.getpid()
        self.heartbeat_interval_sec = heartbeat_interval_sec
        self.max_restarts = (max_restarts if max_restarts is not None
                             else _config.get_flag("elastic_max_restarts"))
        self.coordinator_address = coordinator_address
        self.num_processes = num_processes
        # no process_id here: the rank is recomputed at every bring-up
        # from the settled membership (sorted worker_id order), so a
        # caller-pinned rank would be wrong after the first resize
        self.initialization_timeout_sec = (
            60.0 if initialization_timeout_sec is None
            else initialization_timeout_sec)
        self.device = device
        # first-bring-up rendezvous quorum: wait for the launch plan to
        # fully join before building, so concurrently starting workers
        # agree on the world instead of each building at a different
        # n_live. Defaults to num_processes (the plan) when given.
        self.min_workers = (min_workers if min_workers is not None
                            else (num_processes or 1))
        self.rendezvous_timeout_sec = rendezvous_timeout_sec
        self.master_reconnect_sec = master_reconnect_sec
        # a member list must hold this long (beating meanwhile) before a
        # world is sized by it: a peer that died just before the snapshot
        # is reaped within the master's heartbeat deadline, so a settle
        # of at least that deadline keeps it out of the group, which
        # would otherwise wait on it (0: the reference's behavior)
        self.settle_sec = settle_sec
        self.restarts = 0
        self.generations = []   # every generation this worker joined
        # bring-ups at each generation: a restart that kept its
        # generation (a hang abort) takes a fresh store prefix too
        self._bringups = {}
        self._client = MasterClient(master_port, host=master_host)
        # set by the on_hang escalation (watchdog thread) so the loop
        # can tell a watchdog abort from a user Ctrl-C — both arrive
        # as KeyboardInterrupt, but only the former should restart
        self._hang_abort = False

    # -- bring-up ---------------------------------------------------------
    def _register_with_retry(self):
        """Register, absorbing a restarting master for up to
        ``master_reconnect_sec`` (the steady-state heartbeat path
        absorbs the same outage; bring-up must not be the one moment a
        master restart is fatal)."""
        deadline = time.monotonic() + self.master_reconnect_sec
        while True:
            try:
                return self._client.register(self.worker_id)
            except (ConnectionError, OSError):
                if time.monotonic() >= deadline:
                    raise
                _HB_MISSES.inc()
                time.sleep(0.5)

    def _rendezvous(self):
        """Register, then wait for a consistent membership snapshot:
        the first bring-up blocks until ``min_workers`` have joined
        (the launch plan), restarts just take whoever is live. Returns
        (generation, sorted member ids) — one MEMBERS response, so the
        view is atomic; any membership change after it bumps the
        generation and the fence forces a rebuild rather than letting
        two workers build different-sized worlds."""
        gen, _ = self._register_with_retry()
        min_live = self.min_workers if not self.generations else 1
        deadline = time.monotonic() + self.rendezvous_timeout_sec
        settled = None   # the snapshot a settle window is holding
        while True:
            try:
                mgen, members = self._client.members()
            except (ConnectionError, OSError):
                gen, _ = self._register_with_retry()
                continue
            if mgen != gen or self.worker_id not in members:
                # a join/death moved the cluster under us (or a
                # restarted master forgot us): adopt the new generation
                gen, _ = self._register_with_retry()
                continue
            if len(members) >= min_live:
                if not self.settle_sec or settled == (mgen, members):
                    return gen, members
                settled = (mgen, members)
                self._settle(gen)
                continue
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    "elastic rendezvous timed out after %.0fs: %d of "
                    "%d workers joined (%r)"
                    % (self.rendezvous_timeout_sec, len(members),
                       min_live, members))
            # a quorum wait can outlast the master's heartbeat
            # deadline: beat so the wait reads as alive, not dead (the
            # master refreshes liveness even on a GENMISMATCH beat;
            # the members() recheck above adopts any new generation)
            try:
                self._client.heartbeat(self.worker_id, gen)
            except (GenerationMismatch, ConnectionError, OSError):
                pass
            time.sleep(0.1)

    def _settle(self, gen):
        """Beat through ``settle_sec`` (the wait reads as alive)."""
        until = time.monotonic() + self.settle_sec
        while time.monotonic() < until:
            try:
                self._client.heartbeat(self.worker_id, gen)
            except (GenerationMismatch, ConnectionError, OSError):
                return
            time.sleep(0.05)

    def _bring_up(self):
        gen, members = self._rendezvous()
        _GENERATION.set(gen)
        _observe_deaths(self._client)
        self.generations.append(gen)
        # ranks follow sorted worker_id order in the settled member
        # list — dense, consistent across workers at this generation
        rank, world_n = members.index(self.worker_id), len(members)
        world = ElasticWorld(gen, world_n, self.worker_id,
                             self._client, process_id=rank,
                             num_processes=world_n)
        _log.structured("elastic_bring_up", generation=gen,
                        live=world_n, rank=rank,
                        worker=self.worker_id,
                        restarts=self.restarts)
        return world

    def _init_group(self, world):
        """Bring the process group up for ``world`` (coordinator mode):
        at the surviving world size, under a store prefix of its own for
        each bring-up at a generation; rank 0 holds the store, so the
        coordinator host's worker must sort first (e.g. "w0"). Runs with
        the heartbeat already beating: a rank waiting here for the
        others is alive."""
        if not self.coordinator_address:
            return
        n = self._bringups.get(world.generation, 0)
        self._bringups[world.generation] = n + 1
        world.process_id, world.num_processes = init_multihost(
            self.coordinator_address,
            num_processes=world.n_live, process_id=world.process_id,
            initialization_timeout_sec=self.initialization_timeout_sec,
            device=self.device,
            generation="%d.%d" % (world.generation, n))

    def _escalate(self, trainer):
        """Wire the hang-escalation chain into the trainer's policy (if
        it has one): watchdog overrun -> collective_abort -> abort.
        The wrapper also marks the abort as watchdog-originated so the
        loop's KeyboardInterrupt handler restarts on a hang but lets a
        real user Ctrl-C propagate."""
        policy = getattr(trainer, "policy", None)
        if policy is None or not policy.step_deadline_sec:
            return
        inner = getattr(policy, "on_hang", None)

        def on_hang(step, elapsed):
            self._hang_abort = True
            if inner is not None:
                inner(step, elapsed)
            else:
                # not waited on: the watchdog's interrupt must follow the
                # abort at once, before the main thread, unblocked by it,
                # issues another collective on the aborted group (one it
                # would wait on for good)
                collective_abort("hung step %s (%.1fs)"
                                 % (step, elapsed), wait_sec=0)
        policy.on_hang = on_hang
        # without the abort the escalation can't unwind a wedged loop
        policy.watchdog_abort = True

    def _membership_moved(self, world):
        """Whether the cluster's generation moves away from ``world``'s
        within twice ``settle_sec`` (coordinator mode with a settle
        window only): the test of whether a collective's error is a
        peer's death, which the master declares at its deadline."""
        if not (self.coordinator_address and self.settle_sec):
            return False
        deadline = time.monotonic() + 2.0 * self.settle_sec
        while True:
            try:
                if self._client.cluster()["generation"] != world.generation:
                    return True
            except (ConnectionError, OSError, ValueError, IndexError):
                pass
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)

    @staticmethod
    def _absorb_interrupt(timeout_sec=10.0):
        """Wait for the watchdog's interrupt, which follows its
        ``on_hang`` (the abort), so that it lands here and not in the
        next bring-up."""
        deadline = time.monotonic() + timeout_sec
        try:
            while time.monotonic() < deadline:
                time.sleep(0.01)
        except KeyboardInterrupt:
            pass

    # -- the loop ---------------------------------------------------------
    def run(self, num_passes=1, event_handler=None, prefetch=0,
            staging=False):
        """Train to completion across restarts; returns the final
        ``train`` result. Raises :class:`ElasticRestartLimit` after
        ``max_restarts`` teardown/rebuild cycles.

        ``prefetch``/``staging`` default off here (unlike
        ``Trainer.train``, which defaults to a staged prefetch of 8): a
        hang abort must unwind through ``collective_abort`` while the
        staging thread may itself be blocked on the card behind the dead
        collective, so the default keeps the abort path free of
        background device work. Pass ``prefetch=8, staging=True`` for
        the staged pipeline when throughput matters more than the
        worst-case abort latency."""
        trigger_t = None  # set at restart detection, for resume latency
        while True:
            restart_reason = None
            result = None
            hb = None
            trainer = reader = None
            trainer_box = []
            try:
                world = self._bring_up()
                # beats start before the (possibly slow) group bring-up
                # and build: a worker mid-rebuild (init_multihost, mesh,
                # first step) is alive, not dead — without a beat covering
                # this window the master would reap it at the heartbeat
                # deadline and fence every healthy survivor into yet
                # another restart. A generation change landing before
                # the trainer exists is parked and delivered right
                # after build; the lock makes park-vs-publish atomic,
                # so a change can never fall between the heartbeat
                # thread's box check and the main thread's park check.
                park = threading.Lock()
                trainer_box, pending_restart = [], []

                def _on_change(old, new, live):
                    reason = "generation_%d_to_%d" % (old, new)
                    with park:
                        if trainer_box:
                            trainer_box[0].request_restart(reason)
                        else:
                            pending_restart.append(reason)

                hb = MembershipHeartbeat(
                    self.master_port, self.worker_id, world.generation,
                    host=self.master_host,
                    interval_sec=self.heartbeat_interval_sec,
                    on_change=_on_change)
                hb.start()
                self._hang_abort = False
                try:
                    self._init_group(world)
                    trainer, reader = self.build(world)
                    self._escalate(trainer)
                    with park:
                        trainer_box.append(trainer)
                        parked = (pending_restart[0]
                                  if pending_restart else None)
                    if parked is not None:
                        trainer.request_restart(parked)
                    trainer.startup()  # restore newest intact ckpt
                    if trigger_t is not None:
                        resume_s = time.perf_counter() - trigger_t
                        _RESUME_SECONDS.observe(resume_s)
                        _log.structured(
                            "elastic_resumed",
                            generation=world.generation,
                            step=trainer.step_id,
                            resume_seconds=round(resume_s, 3))
                        trigger_t = None
                    result = trainer.train(reader,
                                           num_passes=num_passes,
                                           event_handler=event_handler,
                                           prefetch=prefetch,
                                           staging=staging)
                except GenerationMismatch as e:
                    restart_reason = ("generation_fence_%d"
                                      % e.current_generation)
                except Exception:
                    if self._hang_abort:
                        # a collective of the aborted group raised (gloo's
                        # wait ends at the group's timeout, an aborted
                        # NCCL work errors) before the watchdog's
                        # interrupt landed: the same abort
                        self._hang_abort = False
                        restart_reason = "collective_hang_abort"
                        self._absorb_interrupt()
                    elif self._membership_moved(world):
                        # a collective failed on a peer's death (gloo sees
                        # the closed connection at once) that the master
                        # declares within the settle window
                        restart_reason = "collective_error_peer_death"
                    else:
                        raise
                finally:
                    hb.stop()
            except KeyboardInterrupt:
                # watchdog abort: the wedged step was escalated through
                # on_hang (collective_abort already ran) and the
                # interrupt unwound the loop: restart, don't die. The
                # interrupt can land anywhere in the iteration, not
                # just inside train(): interrupt_main delivers
                # asynchronously, so a step that was slow-but-alive can
                # finish and leave the interrupt to arrive during
                # startup, the finally's hb.stop(), or the next
                # bring-up — catching at iteration scope keeps every
                # landing site on the restart path. A KeyboardInterrupt
                # with no preceding escalation is a real user Ctrl-C:
                # propagate it.
                if not self._hang_abort:
                    raise
                self._hang_abort = False
                restart_reason = "collective_hang_abort"
                if hb is not None:
                    hb.stop()  # idempotent; re-run if interrupted
            if restart_reason is None:
                if result and result.get("restart"):
                    restart_reason = result.get("reason", "requested")
                else:
                    return result
            trigger_t = time.perf_counter()
            self.restarts += 1
            _RESTARTS.inc()
            _log.structured("elastic_restart", reason=restart_reason,
                            restarts=self.restarts,
                            max_restarts=self.max_restarts)
            if self.restarts > self.max_restarts:
                raise ElasticRestartLimit(
                    "elastic restart budget exhausted: %d restarts "
                    "(last reason: %s)" % (self.restarts,
                                           restart_reason))
            # the old world's trainer holds its strategy's groups: drop it
            # with the abort, so the groups are freed and their
            # connections close (a gloo peer still waiting on one then
            # errors at once instead of at its timeout)
            trainer = reader = hb = None
            trainer_box.clear()
            collective_abort(restart_reason)
            gc.collect()
