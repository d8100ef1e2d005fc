"""The training entry points of the port (reference
``paddle_tpu/trainer.py``).

:func:`train_step` runs one step of an ``nn.Module`` model: forward,
loss, backward, and the update of every parameter with a gradient; a
ResNet's forward updates its batch-norm running statistics in place.

:class:`Trainer` is the reference's event-driven loop over the program
path, with the parity of its two surfaces:
* legacy C++ Trainer / TrainerInternal hot loop (``paddle/trainer/
  Trainer.cpp:265,406``, ``TrainerInternal.cpp:66-171``): pass loop, batch
  loop, evaluators, per-pass checkpoints, stat timers;
* v2 Python ``paddle.v2.trainer.SGD.train`` (``python/paddle/v2/
  trainer.py:37,137``): reader + event_handler protocol with
  BeginPass/EndPass/BeginIteration/EndIteration events.

Each batch is one ``Executor.run`` of the program (forward, backward and
update, the state updated in place); the reader goes through the staged
input pipeline (``reader/staging.py``: a background thread packs and
copies each batch to the card ahead of the step) or, with
``staging=False``, a host-side prefetch queue. On a CUDA device the
staged pipeline needs its pinned arena: ``train`` raises rather than
drop to the plain queue. ``save_inference_model`` and a distribution
``strategy`` raise NotImplementedError.
"""

import itertools
import time

import numpy as np

from . import config as _config
from . import io as _io
from . import reader as _reader
from .core.executor import Executor
from .core.framework import default_main_program, default_startup_program
from .core.ingest import PackedBatch
from .observability import metrics as _metrics
from .observability import tracing as _tracing
from .utils import log as _log
from .utils.stat import timer, stat_set

__all__ = ["Trainer", "BeginPass", "EndPass", "BeginIteration",
           "EndIteration", "train_step"]

# the ROADMAP Queue A item that brings inference export
_EXPORT = 'ROADMAP Queue A, "Inference export and the serving engine"'


def train_step(model, optimizer, *feeds):
    """One training step of ``model`` with ``optimizer``: ``model(*feeds)``
    returns ``(loss, second, ...)`` — a ResNet's ``(img, label)`` give
    ``(loss, acc, logits)``, a transformer LM's ``(tokens, labels)``
    ``(loss, logits)``; ``second`` may be None. Returns ``(loss,
    second)``, detached, on the model's device; nothing is read back to
    the host."""
    optimizer.zero_grad()
    loss, second = model(*feeds)[:2]
    loss.backward()
    optimizer.step()
    return loss.detach(), None if second is None else second.detach()

# Step telemetry (recording gated by the config flag "telemetry").
_STEP_SECONDS = _metrics.REGISTRY.histogram(
    "paddle_trainer_step_seconds",
    "Host wall time per train step. With async_metrics this is "
    "dispatch time, NOT device latency (PROFILE.md sync rule) — use "
    "examples_per_second (cumulative, sync-independent) for throughput")
_EXAMPLES_TOTAL = _metrics.REGISTRY.counter(
    "paddle_trainer_examples_total", "Examples consumed by train steps")
_EXAMPLES_PER_SEC = _metrics.REGISTRY.gauge(
    "paddle_trainer_examples_per_second",
    "Cumulative throughput per trainer: examples / wall time since "
    "that Trainer's first step (valid under async dispatch — no "
    "per-step host sync)",
    labelnames=("trainer",))
_TRAINER_IDS = itertools.count(1)
_STEPS_TOTAL = _metrics.REGISTRY.counter(
    "paddle_trainer_steps_total", "Optimizer steps taken")
_CKPT_SECONDS = _metrics.REGISTRY.histogram(
    "paddle_trainer_checkpoint_seconds", "Checkpoint save wall time")


def _batch_size(feed):
    """Largest leading dim across feed arrays (examples in this step)."""
    if isinstance(feed, PackedBatch):
        return feed.batch_size
    n = 0
    for v in feed.values():
        shape = getattr(v, "shape", None)
        if shape:
            n = max(n, int(shape[0]))
    return n


class BeginPass:
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass:
    def __init__(self, pass_id, metrics=None):
        self.pass_id = pass_id
        self.metrics = metrics or {}


class BeginIteration:
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration:
    def __init__(self, pass_id, batch_id, step_id, metrics):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.step_id = step_id
        self.metrics = metrics

    @property
    def cost(self):
        return self.metrics.get("loss")


class Trainer:
    def __init__(self, loss, optimizer=None, feeder=None, metrics=None,
                 main_program=None, startup_program=None, strategy=None,
                 checkpoint_dir=None, checkpoint_every_n_steps=None,
                 scheduler=None, place=None, async_metrics=False,
                 periodic_log_interval=None, device=None):
        """metrics: {name: Variable} fetched each batch alongside loss.
        feeder: DataFeeder (or None — reader yields feed dicts directly).
        async_metrics: keep per-batch metric fetches as device arrays —
        no host sync per step, so the train loop runs dispatch-ahead
        (the throughput recipe, PROFILE.md sink #1); event handlers can
        still np.asarray() a metric when they actually need the value.
        periodic_log_interval: with the ``telemetry`` flag on, emit one
        structured throughput line (utils.log.structured) every N steps.
        place/device: where the program runs (``Executor``): CUDA when
        neither is given, ``device="cpu"`` on the CPU.
        """
        self.loss = loss
        self.main_program = main_program or default_main_program()
        self.startup_program = startup_program or \
            default_startup_program()
        self.exe = Executor(place=place, strategy=strategy, device=device)
        self.feeder = feeder
        self.metrics = dict(metrics or {})
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every_n_steps
        self.scheduler = scheduler
        self.async_metrics = async_metrics
        self.periodic_log_interval = periodic_log_interval
        self.step_id = 0
        self._initialized = False
        # preemption: set by request_stop() (e.g. a SIGTERM handler —
        # resilience/supervisor.py); checked at step boundaries so the
        # in-flight step always completes before the loop exits
        self._stop_reason = None
        # elastic restart: set by request_restart() (e.g. the
        # membership-heartbeat thread on a cluster generation bump —
        # distributed/elastic.py); same step-boundary discipline, but
        # the caller rebuilds the runtime and resumes instead of exiting
        self._restart_reason = None
        # telemetry window: (first-step start time, examples since);
        # the throughput gauge is per-instance ("trainer" label) — two
        # Trainers must not clobber one label-less value
        self._tel_t0 = None
        self._tel_examples = 0
        self._tel_label = "t%d" % next(_TRAINER_IDS)

    # -- lifecycle -----------------------------------------------------------
    def startup(self):
        if self._initialized:
            return
        self.exe.run(self.startup_program)
        if self.checkpoint_dir:
            step = _io.load_checkpoint(self.exe, self.checkpoint_dir,
                                       self.main_program)
            if step is not None:
                self.step_id = step
                self._sync_scheduler()
        self._initialized = True

    def _sync_scheduler(self):
        """Re-align the host-side LR schedule with a step_id that was
        just set from a checkpoint (resume or rollback) — the
        scheduler's counter is not part of the persisted scope state,
        and left alone it would keep scheduling LRs for the step count
        of the abandoned timeline."""
        if self.scheduler is not None:
            self.scheduler.step_num = self.step_id

    def _fetches(self):
        names = ["loss"] + sorted(self.metrics)
        vars_ = [self.loss] + [self.metrics[k] for k in sorted(
            self.metrics)]
        return names, vars_

    def train_batch(self, batch):
        """One train batch; returns {metric: value}."""
        if _config.get_flag("telemetry"):
            with timer("feed"):
                feed = self.feeder.feed(batch) if self.feeder else batch
        else:
            feed = self.feeder.feed(batch) if self.feeder else batch
        return self._train_feed(feed)

    def _train_feed(self, feed):
        """One step from an already-assembled feed dict."""
        self.startup()
        names, vars_ = self._fetches()
        telemetry = _config.get_flag("telemetry")
        t0 = time.perf_counter() if telemetry else 0.0
        with timer("trainOneBatch"):
            vals = self.exe.run(self.main_program, feed=feed,
                                fetch_list=vars_,
                                return_numpy=not self.async_metrics)
        if telemetry:
            self._record_step(feed, t0, time.perf_counter())
        self.step_id += 1
        if self.scheduler is not None:
            self.scheduler.step()
        if self.async_metrics:
            metrics = dict(zip(names, vals))
        else:
            metrics = dict(zip(names, [np.asarray(v).item()
                                       if np.asarray(v).size == 1 else
                                       np.asarray(v) for v in vals]))
        # recovery hook (ResilientTrainer) — runs BEFORE the periodic
        # checkpoint trigger so a rollback decision can't be preempted
        # by checkpointing the offending step first
        metrics = self._post_step(metrics)
        if self.checkpoint_dir and self.checkpoint_every and \
                metrics.get("rolled_back_to") is None and \
                self.step_id % self.checkpoint_every == 0:
            self._save_checkpoint(telemetry)
        return metrics

    def _post_step(self, metrics):
        """Per-step recovery hook; the base trainer is a no-op. A
        subclass may inspect/annotate the metrics, roll state back
        (setting ``rolled_back_to``), or raise."""
        return metrics

    def _save_checkpoint(self, telemetry, extra_meta=None):
        ck0 = time.perf_counter()
        with timer("saveCheckpoint"):
            _io.save_checkpoint(self.exe, self.checkpoint_dir,
                                self.step_id, self.main_program,
                                extra_meta=extra_meta)
        if telemetry:
            _CKPT_SECONDS.observe(time.perf_counter() - ck0)

    # -- resilience hooks (resilience/supervisor.py drives these) ------------
    def request_stop(self, reason="preempt"):
        """Ask the train loop to stop at the next step boundary: the
        in-flight step finishes, a final checkpoint (with resume
        metadata) is written, and ``train`` returns the preemption
        record. Signal-handler safe (only sets a flag)."""
        self._stop_reason = reason

    def request_restart(self, reason="elastic"):
        """Ask the train loop to stop at the next step boundary for a
        runtime rebuild (elastic resize): the in-flight step finishes, a
        checkpoint is written at the clean boundary, and ``train``
        returns a record with ``restart: True`` so the supervising loop
        (distributed.elastic.ElasticTrainerLoop) can tear down and
        re-initialize at the new world size. Thread/signal-safe (only
        sets a flag)."""
        self._restart_reason = reason

    def restore_checkpoint(self):
        """Reload the newest intact checkpoint into the scope and rewind
        ``step_id`` to it (the rollback primitive). Returns the restored
        step, or None when there is no checkpoint to restore."""
        if not self.checkpoint_dir:
            return None
        step = _io.load_checkpoint(self.exe, self.checkpoint_dir,
                                   self.main_program)
        if step is not None:
            self.step_id = step
            self._sync_scheduler()
        return step

    def _record_step(self, feed, t0, t1):
        """Telemetry-path step accounting (flag already checked).

        Throughput is computed over the cumulative window since this
        Trainer's first step: under async_metrics the per-step wall
        time is dispatch-only (no host sync — PROFILE.md), so an
        instantaneous examples/dt would be wildly inflated; the
        cumulative rate stays correct because the device eventually
        backpressures the dispatching host."""
        n = _batch_size(feed)
        _STEP_SECONDS.observe(t1 - t0)
        _STEPS_TOTAL.inc()
        if self._tel_t0 is None:
            self._tel_t0 = t0
        eps = 0.0
        if n:
            _EXAMPLES_TOTAL.inc(n)
            self._tel_examples += n
            if t1 > self._tel_t0:
                eps = self._tel_examples / (t1 - self._tel_t0)
                _EXAMPLES_PER_SEC.labels(trainer=self._tel_label) \
                    .set(eps)
        interval = self.periodic_log_interval
        if interval and (self.step_id + 1) % interval == 0:
            _log.structured(
                "train_throughput", step=self.step_id + 1,
                step_ms=round((t1 - t0) * 1e3, 3),
                examples_per_sec=round(eps, 2),
                examples_total=int(_EXAMPLES_TOTAL.value),
                steps_total=int(_STEPS_TOTAL.value))

    def train(self, reader, num_passes=1, event_handler=None,
              prefetch=8, staging=True):
        """Pass/batch loop with events (v2 SGD.train parity).

        With ``staging`` (default), batches are assembled on a
        background thread in the staging arena's page-locked blocks and
        copied to the card ahead of consumption (reader/staging.py, the
        async double-buffer DataProvider analog). On the CPU it falls
        back to the plain Python prefetch queue when neither the arena
        nor packing is active; on a CUDA device that raises instead.

        Returns None on normal completion. If ``request_stop`` fires
        mid-pass (preemption), the loop finishes the in-flight step,
        writes a final checkpoint whose ``latest.json`` carries the
        resume metadata, and returns that metadata dict.
        """
        # do NOT clear _stop_reason/_restart_reason here: a preemption
        # signal or a heartbeat restart request landing before train()
        # is entered — e.g. during an EXTERNAL startup()/restore (the
        # elastic loop runs startup first to time the resume) — must
        # survive into the loop, not be wiped. Leftovers from a
        # previous train() on this object can't leak: both exit
        # epilogues clear both flags, and the exception path below
        # clears them.
        self.startup()
        event_handler = event_handler or (lambda e: None)
        staged = None
        if staging and prefetch:
            from .reader.staging import StagedReader
            staged = StagedReader(reader, feeder=self.feeder,
                                  depth=prefetch,
                                  program=self.main_program,
                                  device=self.exe.device)
            if not (staged.arena_active or staged.packing_enabled()):
                if self.exe.device.type == "cuda":
                    staged.close()
                    raise RuntimeError(
                        "Trainer.train on %s: the staged pipeline has "
                        "neither a pinned arena nor packing; it does not "
                        "fall back to the plain queue on a CUDA device"
                        % self.exe.device)
                staged = None  # arena unavailable (the CPU only)
        batches = None
        exc_live = False
        try:
            for pass_id in range(num_passes):
                event_handler(BeginPass(pass_id))
                if staged is not None:
                    batches = staged()
                    run_one = self._train_feed
                else:
                    batched = _reader.buffered(reader, prefetch) \
                        if prefetch else reader
                    batches = batched()
                    run_one = self.train_batch
                last_metrics = {}
                last_batch_id = -1
                for batch_id, batch in enumerate(batches):
                    event_handler(BeginIteration(pass_id, batch_id))
                    with _tracing.span("trainStep"):
                        metrics = run_one(batch)
                    last_metrics = metrics
                    last_batch_id = batch_id
                    event_handler(EndIteration(pass_id, batch_id,
                                               self.step_id, metrics))
                    if self._stop_reason or self._restart_reason:
                        break
                if self._stop_reason:
                    return self._preempt_exit(pass_id, last_batch_id)
                if self._restart_reason:
                    return self._restart_exit(pass_id, last_batch_id)
                if self.checkpoint_dir:
                    self._save_checkpoint(_config.get_flag("telemetry"))
                event_handler(EndPass(pass_id, last_metrics))
            # normal completion: a stop/restart landing after the final
            # per-pass check (during the last checkpoint save, EndPass,
            # or between passes' checks) arrives with training already
            # done — clear it here so it can't replay as a phantom
            # preempt/restart exit in a later train() on this object
            self._stop_reason = None
            self._restart_reason = None
        except BaseException:
            # flag for teardown: sys.exc_info() in the finally would
            # also see an outer HANDLED exception and misreport
            exc_live = True
            # an unconsumed stop/restart must not leak into a later
            # train() on a reused trainer
            self._stop_reason = None
            self._restart_reason = None
            raise
        finally:
            if staged is not None:
                self._teardown_staged(staged, batches, exc_live)

    def _preempt_exit(self, pass_id, batch_id):
        """Preemption epilogue: one final checkpoint whose latest.json
        records exactly where training stopped, so a restarted trainer
        resumes at the interrupted step (the Go pserver's
        checkpoint-on-SIGTERM discipline, SURVEY §5.4)."""
        resume = {"preempted": True, "reason": self._stop_reason,
                  "pass_id": pass_id, "batch_id": batch_id,
                  "step": self.step_id}
        if self.checkpoint_dir:
            self._save_checkpoint(_config.get_flag("telemetry"),
                                  extra_meta=resume)
        _log.structured("train_preempted", **resume)
        # clear BOTH flags: a restart request that lost the race to a
        # preemption in the same window must not leak into the next
        # train() on this object and fake an instant restart
        self._stop_reason = None
        self._restart_reason = None
        return resume

    def _restart_exit(self, pass_id, batch_id):
        """Elastic-restart epilogue: the loop stopped at a clean step
        boundary (state is consistent — unlike the hang-abort path,
        which restores from the last checkpoint instead), so persist a
        checkpoint for the post-rebuild trainer to resume from and hand
        the restart record back to the supervising loop."""
        record = {"restart": True, "reason": self._restart_reason,
                  "pass_id": pass_id, "batch_id": batch_id,
                  "step": self.step_id}
        if self.checkpoint_dir:
            self._save_checkpoint(_config.get_flag("telemetry"),
                                  extra_meta=record)
        _log.structured("train_restart_requested", **record)
        # clear BOTH flags (see _preempt_exit): a stop landing between
        # the loop's two checks must not leak into the next train()
        self._restart_reason = None
        self._stop_reason = None
        return record

    @staticmethod
    def _teardown_staged(staged, batches, exc_live):
        """Stop the staged reader and record its final gauges. When an
        exception is already propagating out of the train loop
        (``exc_live``), teardown errors are logged instead of raised so
        they can't mask the original failure."""
        def _guard(fn):
            try:
                return fn()
            except Exception:
                if not exc_live:
                    raise
                _log.logger().warning(
                    "staged-reader teardown error (suppressed; an "
                    "exception is already propagating)", exc_info=True)
                return None

        if batches is not None:
            _guard(batches.close)  # stop+join the fill thread first
        gauges = _guard(staged.stats)
        if gauges:
            _guard(lambda: stat_set.set_gauges(gauges))
        _guard(staged.close)

    def test(self, reader, test_program, fetch_dict):
        """Average fetches over a test reader (Tester parity)."""
        self.startup()
        names = sorted(fetch_dict)
        vars_ = [fetch_dict[k] for k in names]
        totals = {n: 0.0 for n in names}
        count = 0
        for batch in reader():
            feed = self.feeder.feed(batch) if self.feeder else batch
            vals = self.exe.run(test_program, feed=feed,
                                fetch_list=vars_)
            for n, v in zip(names, vals):
                totals[n] += float(np.asarray(v).mean())
            count += 1
        return {n: totals[n] / max(count, 1) for n in names}

    def save_inference_model(self, dirname, feed_names, fetch_vars):
        raise NotImplementedError(
            "save_inference_model is not ported yet: %s" % _EXPORT)

    def report(self):
        return stat_set.report()
