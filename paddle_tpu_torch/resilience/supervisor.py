"""The training supervisor (reference ``paddle_tpu/resilience/
supervisor.py``).

``ResilientTrainer`` wraps the :class:`~paddle_tpu_torch.trainer.Trainer`
loop with the recovery behaviors a long-running job needs:

* **Non-finite steps**: a per-step finite check of the fetched loss and
  metrics applies a policy: ``skip`` (a bounded budget of identity
  steps) or ``rollback`` (reload the last intact checkpoint, with an
  optional learning-rate backoff). Both arm the executor's
  ``nonfinite_guard``, so a poisoned batch leaves the parameters and the
  optimizer state as they were: the update ops then write new tensors
  and the guard keeps the old ones (``core/executor.py``).
* **Reader faults**: transient reader exceptions (the OSError family by
  default) are retried with exponential backoff and the pass resumes at
  the first unconsumed sample; a permanent failure still propagates once
  the retry budget is spent.
* **Preemption**: SIGTERM/SIGINT finish the in-flight step, write a
  final checkpoint whose ``latest.json`` carries the resume metadata,
  and return it from ``train``.
* **Hung steps**: a watchdog thread fires a counter and a structured log
  line (and optionally aborts the loop) when a step overruns its
  deadline. The abort is ``_thread.interrupt_main()``, which unwinds
  only when the main thread runs Python again: a thread blocked in a
  CUDA synchronize or an NCCL wait does not, so ``on_hang`` runs first
  and is where the group is aborted
  (``distributed.elastic.collective_abort``), which returns the wait.

Every recovery event is a counter in the metrics registry
(``paddle_resilience_*``, recorded whether or not telemetry is on).
Deterministic chaos comes from ``resilience.faults``.

The finite check reads the fetched values on the host: on the card that
is one synchronize a step, which a ``ResilientTrainer`` pays where the
plain ``Trainer`` with ``async_metrics`` runs ahead.
"""

import signal
import threading
import time
from contextlib import contextmanager

import numpy as np
import torch

from .. import config as _config
from ..observability import metrics as _metrics
from ..trainer import Trainer
from ..utils import log as _log
from . import faults as _faults

__all__ = ["RecoveryPolicy", "ResilientTrainer", "resilient_reader",
           "StepWatchdog", "preemption_guard"]

# Recovery counters: always on (they fire on rare events, not per step).
_NONFINITE_STEPS = _metrics.REGISTRY.counter(
    "paddle_resilience_nonfinite_steps_total",
    "Steps whose fetched loss/metrics contained NaN/Inf")
_SKIPPED_STEPS = _metrics.REGISTRY.counter(
    "paddle_resilience_skipped_steps_total",
    "Non-finite steps neutralized to identity updates (skip policy)")
_ROLLBACKS = _metrics.REGISTRY.counter(
    "paddle_resilience_rollbacks_total",
    "Non-finite steps answered by reloading the last intact checkpoint")
_READER_RETRIES = _metrics.REGISTRY.counter(
    "paddle_resilience_reader_retries_total",
    "Transient reader failures absorbed by retry-with-backoff")
_WATCHDOG_STALLS = _metrics.REGISTRY.counter(
    "paddle_resilience_watchdog_stalls_total",
    "Steps that exceeded the hung-step watchdog deadline")
_PREEMPTIONS = _metrics.REGISTRY.counter(
    "paddle_resilience_preemptions_total",
    "SIGTERM/SIGINT preemptions handled by a running train loop")


class RecoveryPolicy:
    """Recovery knobs; unset fields default to the config flags
    (``nonfinite_policy``, ``nonfinite_budget``, ``reader_retries``,
    ``step_deadline_sec``), read here."""

    def __init__(self, nonfinite_policy=None, nonfinite_budget=None,
                 lr_backoff=None, reader_retries=None,
                 reader_backoff=0.05, transient_exceptions=(OSError,),
                 step_deadline_sec=None, watchdog_abort=False,
                 on_hang=None,
                 preempt_signals=(signal.SIGTERM, signal.SIGINT)):
        self.nonfinite_policy = (nonfinite_policy or
                                 _config.get_flag("nonfinite_policy"))
        if self.nonfinite_policy not in ("raise", "skip", "rollback"):
            raise ValueError("nonfinite_policy must be raise|skip|"
                             "rollback, got %r" % (self.nonfinite_policy,))
        self.nonfinite_budget = (
            _config.get_flag("nonfinite_budget")
            if nonfinite_budget is None else nonfinite_budget)
        # rollback only: every learning_rate variable is multiplied by
        # this after each rollback (None keeps the rate). With an
        # LRScheduler the scheduler re-derives the rate each step, so
        # the backoff has no lasting effect: schedule the decay there
        self.lr_backoff = lr_backoff
        self.reader_retries = (
            _config.get_flag("reader_retries")
            if reader_retries is None else reader_retries)
        self.reader_backoff = reader_backoff
        self.transient_exceptions = tuple(transient_exceptions)
        self.step_deadline_sec = (
            _config.get_flag("step_deadline_sec")
            if step_deadline_sec is None else step_deadline_sec)
        self.watchdog_abort = watchdog_abort
        # hang escalation: called (step, elapsed_sec) from the watchdog
        # thread before the abort; the place to abort a wedged process
        # group (distributed.elastic.collective_abort) so the abort can
        # unwind the loop instead of waiting on the dead collective
        self.on_hang = on_hang
        self.preempt_signals = tuple(preempt_signals)


def resilient_reader(reader, retries=None, backoff=0.05,
                     transient=(OSError,), on_retry=None):
    """Wrap a reader so transient failures don't kill the pass.

    When iterating the underlying reader raises one of ``transient``,
    the iterator is re-created after an exponential backoff and
    fast-forwarded past the samples already consumed (the reader must
    be re-creatable, the standard reader contract). The same failure
    repeating ``retries`` times without progress propagates: permanent
    faults still fail the pass. Each absorbed failure increments
    ``paddle_resilience_reader_retries_total``."""
    if retries is None:
        retries = _config.get_flag("reader_retries")
    transient = tuple(transient)

    def reader_creator():
        consumed = 0
        attempts = 0
        while True:
            pos = 0  # position within this iterator
            try:
                # reader() is inside the retried region: a creator that
                # opens its source eagerly can fail transiently too
                it = reader()
                for sample in it:
                    pos += 1
                    if pos <= consumed:
                        continue  # replaying already-delivered samples
                    consumed += 1
                    attempts = 0  # progress resets the budget
                    yield sample
                return
            except transient as e:
                attempts += 1
                _READER_RETRIES.inc()
                if attempts > retries:
                    raise
                delay = backoff * (2 ** (attempts - 1))
                _log.structured("reader_retry", attempt=attempts,
                                retries=retries, consumed=consumed,
                                error=repr(e),
                                backoff_sec=round(delay, 4))
                if on_retry is not None:
                    on_retry(attempts, e)
                time.sleep(delay)
    return reader_creator


def _fault_reader(reader):
    """``reader_error`` chaos hook: raise the armed exception before
    yielding sample ``index`` (wrapped in only while fault injection is
    armed)."""
    def reader_creator():
        for i, sample in enumerate(reader()):
            # IOError by default, so an arm() without exc lands in the
            # resilient reader's transient (OSError) set
            _faults.fire_point("reader_error", i, default_exc=IOError)
            yield sample
    return reader_creator


class StepWatchdog:
    """Background thread that flags steps exceeding a deadline.

    ``step_started``/``step_finished`` bracket each step; when a step
    overruns, the watchdog fires the stall counter and one structured
    log line (once per step), runs ``on_hang``, and with ``abort``
    raises KeyboardInterrupt in the main thread. That raise lands at
    the next Python bytecode of the main thread: a wait inside CUDA or
    NCCL has to be ended by ``on_hang`` first. ResilientTrainer keeps
    SIGINT on its default handler while abort is armed, since
    ``interrupt_main`` is delivered as SIGINT."""

    def __init__(self, deadline_sec, abort=False, poll_interval=None,
                 on_hang=None):
        self.deadline = float(deadline_sec)
        self.abort = abort
        # escalation hook, called (step, elapsed) once per overrunning
        # step from the watchdog thread before the abort; its errors
        # are logged, never raised: a broken escalation must not kill
        # the watchdog
        self.on_hang = on_hang
        self._poll = poll_interval if poll_interval is not None else \
            min(max(self.deadline / 4.0, 0.005), 1.0)
        self._lock = threading.Lock()
        self._t0 = None
        self._step = None
        self._fired = False
        self._stop_evt = threading.Event()
        self._thread = None

    def start(self):
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="paddle-step-watchdog")
        self._thread.start()
        return self

    def stop(self):
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def step_started(self, step_id):
        with self._lock:
            self._t0 = time.monotonic()
            self._step = step_id
            self._fired = False

    def step_finished(self):
        with self._lock:
            self._t0 = None

    def _run(self):
        while not self._stop_evt.wait(self._poll):
            with self._lock:
                t0, step, fired = self._t0, self._step, self._fired
            if t0 is None or fired:
                continue
            elapsed = time.monotonic() - t0
            if elapsed <= self.deadline:
                continue
            with self._lock:
                if self._fired or self._t0 is not t0:
                    continue
                self._fired = True
            _WATCHDOG_STALLS.inc()
            _log.structured("watchdog_stall", step=step,
                            elapsed_sec=round(elapsed, 3),
                            deadline_sec=self.deadline,
                            abort=self.abort,
                            escalated=self.on_hang is not None)
            if self.on_hang is not None:
                try:
                    self.on_hang(step, elapsed)
                except Exception:  # noqa: BLE001 — the watchdog lives on
                    _log.logger().warning(
                        "watchdog on_hang escalation failed",
                        exc_info=True)
            if self.abort:
                import _thread
                _thread.interrupt_main()


@contextmanager
def preemption_guard(trainer, signals=(signal.SIGTERM, signal.SIGINT)):
    """Install preemption handlers for the duration of a train loop.

    The handler only sets the trainer's stop flag (signal-safe), so the
    in-flight step completes and the loop writes its final checkpoint
    with resume metadata before exiting. Previous handlers are restored
    on the way out. Outside the main thread (where Python forbids
    signal()) this is a no-op."""
    if not signals or \
            threading.current_thread() is not threading.main_thread():
        yield
        return

    def handler(signum, frame):
        _PREEMPTIONS.inc()
        trainer.request_stop("signal_%d" % signum)
        _log.structured("preemption_signal", signal=int(signum),
                        step=trainer.step_id)

    old = {}
    try:
        for s in signals:
            old[s] = signal.signal(s, handler)
        yield
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def _is_finite(v):
    """Whether a fetched value holds no NaN/Inf (a tensor on the card is
    read back: one synchronize)."""
    if isinstance(v, torch.Tensor):
        return not v.is_floating_point() or bool(torch.isfinite(v).all())
    arr = np.asarray(v)
    return not np.issubdtype(arr.dtype, np.floating) or \
        bool(np.isfinite(arr).all())


class ResilientTrainer(Trainer):
    """Trainer with a recovery policy (see the module docstring).

    The non-finite check reads the fetched metrics on the host, one
    synchronize a step: with ``async_metrics`` the run-ahead pipeline is
    traded for acting on each step's health.
    """

    def __init__(self, *args, policy=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.policy = policy or RecoveryPolicy()
        self.nonfinite_seen = 0
        self._watchdog = None
        if self.policy.nonfinite_policy != "raise":
            if not _config.get_flag("nonfinite_guard"):
                # skip/rollback are only sound with the update guarded
                # on the device; the flag stays set process-wide (it
                # keys the executor's step cache like amp)
                _config.set_flags(nonfinite_guard=True)
            if _config.get_flag("check_nan_inf"):
                # the assert-and-die flag raises inside the executor
                # before the policy could run: the guard supersedes it
                _log.logger().warning(
                    "check_nan_inf disabled: it would abort the step "
                    "before the %r nonfinite policy could act",
                    self.policy.nonfinite_policy)
                _config.set_flags(check_nan_inf=False)

    # -- per-step ------------------------------------------------------------
    def _train_feed(self, feed):
        fault_injection = _config.get_flag("fault_injection")
        if fault_injection:
            feed = _faults.poison_feed(feed, self.step_id)
            # elastic chaos: hard-kill this worker mid-pass
            _faults.fire_point("worker_kill", self.step_id)
        if self._watchdog is not None:
            self._watchdog.step_started(self.step_id)
        try:
            if fault_injection:
                # wedge inside the watchdog window, like a collective
                # whose peer died: only the escalation gets out
                _faults.simulate_collective_hang(self.step_id)
            return super()._train_feed(feed)
        finally:
            if self._watchdog is not None:
                self._watchdog.step_finished()

    def _post_step(self, metrics):
        """Runs inside the base step, before the periodic checkpoint
        trigger: a non-finite step is handled before it could checkpoint
        itself."""
        if self._watchdog is not None:
            # the timed window is the step itself: a rollback's restore
            # below must not trip the deadline (step_finished is
            # idempotent)
            self._watchdog.step_finished()
        if not self._all_finite(metrics):
            return self._handle_nonfinite(metrics)
        # progress resets the budget: it bounds consecutive bad steps
        # (divergence), not isolated glitches over a long job
        self.nonfinite_seen = 0
        return metrics

    def _save_checkpoint(self, telemetry, extra_meta=None):
        """A save under a distribution strategy waits on the mesh (the
        gather and the writer's barrier): a dead peer wedges it as it
        wedges a step, so it runs inside the watchdog's window too."""
        if self._watchdog is None or self.exe.strategy is None:
            return super()._save_checkpoint(telemetry, extra_meta)
        self._watchdog.step_started(self.step_id)
        try:
            return super()._save_checkpoint(telemetry, extra_meta)
        finally:
            self._watchdog.step_finished()

    @staticmethod
    def _all_finite(metrics):
        return all(_is_finite(v) for v in metrics.values())

    def _handle_nonfinite(self, metrics):
        self.nonfinite_seen += 1
        _NONFINITE_STEPS.inc()
        policy = self.policy.nonfinite_policy
        budget = self.policy.nonfinite_budget
        if policy == "raise":
            raise FloatingPointError(
                "non-finite loss/metrics at step %d (policy=raise)"
                % self.step_id)
        if self.nonfinite_seen > budget:
            raise FloatingPointError(
                "non-finite budget exhausted: %d consecutive bad steps "
                "> budget %d (policy=%s) — training is diverging, not "
                "glitching" % (self.nonfinite_seen, budget, policy))
        if policy == "skip":
            # nonfinite_guard already made the update an identity on the
            # device; the step is recorded as consumed but skipped
            _SKIPPED_STEPS.inc()
            _log.structured("nonfinite_skip", step=self.step_id,
                            seen=self.nonfinite_seen, budget=budget)
            out = dict(metrics)
            out["skipped_nonfinite"] = True
            return out
        # rollback: take the live learning rates first. They carry every
        # earlier backoff, while the checkpoint's may predate them, so
        # backing off from the live value compounds (0.1 -> 0.05 ->
        # 0.025) instead of bouncing off the checkpointed rate
        pre_lrs = self._current_lrs() if self.policy.lr_backoff else None
        step = self.restore_checkpoint()
        if step is None:
            raise FloatingPointError(
                "non-finite step %d and no checkpoint to roll back to "
                "(set checkpoint_dir / checkpoint_every_n_steps)"
                % self.step_id)
        _ROLLBACKS.inc()
        if pre_lrs:
            self._set_lrs({n: v * self.policy.lr_backoff
                           for n, v in pre_lrs.items()})
        _log.structured("nonfinite_rollback", restored_step=step,
                        seen=self.nonfinite_seen, budget=budget,
                        lr_backoff=self.policy.lr_backoff)
        out = dict(metrics)
        out["rolled_back_to"] = step
        return out

    def _current_lrs(self):
        from ..core.scope import global_scope
        scope = global_scope()
        return {name: scope.find_var(name).clone()
                for name in self.main_program.global_block().vars
                if name.startswith("learning_rate")
                and scope.has_var(name)}

    def _set_lrs(self, values):
        from ..core.scope import global_scope
        scope = global_scope()
        for name, v in values.items():
            scope.set_var(name, v)

    # -- pass loop -----------------------------------------------------------
    def train(self, reader, num_passes=1, event_handler=None,
              prefetch=8, staging=True):
        wrapped = reader
        if _config.get_flag("fault_injection"):
            wrapped = _fault_reader(wrapped)
        if self.policy.reader_retries:
            wrapped = resilient_reader(
                wrapped, retries=self.policy.reader_retries,
                backoff=self.policy.reader_backoff,
                transient=self.policy.transient_exceptions)
        if self.policy.step_deadline_sec:
            self._watchdog = StepWatchdog(
                self.policy.step_deadline_sec,
                abort=self.policy.watchdog_abort,
                on_hang=self.policy.on_hang).start()
        sigs = self.policy.preempt_signals
        if self.policy.watchdog_abort:
            # the abort is delivered as SIGINT by interrupt_main(): were
            # SIGINT the guard's, the abort would become a stop flag a
            # hung step never checks
            sigs = tuple(s for s in sigs if s != signal.SIGINT)
        try:
            with preemption_guard(self, sigs):
                return super().train(wrapped, num_passes=num_passes,
                                     event_handler=event_handler,
                                     prefetch=prefetch, staging=staging)
        finally:
            if self._watchdog is not None:
                self._watchdog.stop()
                self._watchdog = None
