"""The port's training supervisor (``paddle_tpu_torch/resilience/
supervisor.py``) against the reference's (``tests/test_resilience.py``),
on the CPU.

The regression model of the reference's tests (fc 4 -> 8 relu -> 1, a
mean squared error), here under Momentum(0.05, 0.9) so the skipped step
has accumulators to leave alone, starts in both packages from the
reference's startup scope and sees the same batches, made from a numpy
seed: the skip policy's parameters within 1e-5 of the reference's and
bitwise unchanged across the skipped step (velocities included), the
rollback marks and the compounded learning-rate backoff equal, the
budget exhausted and reset, the reader retry and its permanent failure,
the watchdog once per overrun step and its abort, and preemption
checkpoints that one package writes and the other resumes from. The
``paddle_resilience_*`` families carry the reference's names and help.
"""

import os
import signal
import time

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import io as ref_io
from paddle_tpu import layers as ref_layers
from paddle_tpu import trainer as ref_trainer
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu.resilience import supervisor as ref_sup
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import core, layers, optimizer
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import trainer as port_trainer
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.resilience import (RecoveryPolicy, ResilientTrainer,
                                         StepWatchdog, faults,
                                         resilient_reader)
from paddle_tpu_torch.resilience import supervisor as port_sup

TOL = 1e-5
PARAMS = ("fc_0.w_0", "fc_0.w_1", "fc_1.w_0", "fc_1.w_1")
STATE = PARAMS + tuple(n + "_velocity_acc_0" for n in PARAMS)


@pytest.fixture(autouse=True)
def _reset():
    yield
    faults.disarm()
    ref_faults.disarm()
    for cfg in (port_config, ptpu.config):
        cfg.set_flags(fault_injection=False, nonfinite_guard=False,
                      nonfinite_policy="raise", check_nan_inf=False)


def _counter(name, reg=metrics.REGISTRY):
    fam = reg.families().get(name)
    return 0.0 if fam is None else fam.value


def _program(ref, lr=0.05):
    fw, lay = (ptpu, ref_layers) if ref else (core, layers)
    main, startup = fw.Program(), fw.Program()
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        x = lay.data("x", shape=[4])
        y = lay.data("y", shape=[1])
        h = lay.fc(x, 8, act="relu")
        p = lay.fc(h, 1)
        loss = lay.mean(lay.square_error_cost(p, y))
        opt = (ptpu.optimizer if ref else optimizer).Momentum(
            learning_rate=lr, momentum=0.9)
        if ref:
            opt.minimize(loss, startup_program=startup)
        else:
            opt.minimize(loss, startup)
    return main, startup, loss


@pytest.fixture(scope="module")
def init():
    """The reference's startup scope, as numpy."""
    main, startup, _ = _program(True)
    scope = ptpu.Scope()
    with ptpu.scope_guard(scope):
        ptpu.Executor().run(startup)
    return {n: np.array(scope.find_var(n)) for n in scope.var_names()}


def _reader(n, batch=16, seed=0):
    def gen():
        rs = np.random.RandomState(seed)
        for _ in range(n):
            xb = rs.randn(batch, 4).astype("float32")
            yield {"x": xb,
                   "y": (xb.sum(1, keepdims=True) * 0.5).astype("float32")}
    return gen


def _state(ref, scope, names=STATE):
    if ref:
        return {n: np.array(scope.find_var(n)) for n in names}
    return {n: scope.find_var(n).detach().cpu().numpy().copy()
            for n in names}


def _run(ref, init, policy_kw, steps, ckpt=None, every=None, arm=(),
         events=None, lr=0.05, scope=None):
    """One pass of ``steps`` batches in one package from ``init``;
    returns (final state, [EndIteration marks], trainer, scope)."""
    main, startup, loss = _program(ref, lr)
    pkg, sup, flt = ((ref_trainer, ref_sup, ref_faults) if ref else
                     (port_trainer, port_sup, faults))
    for site, kw in arm:
        flt.arm(site, **kw)
    if scope is None:
        scope = ptpu.Scope() if ref else port_io.scope_from_jax(
            init, device="cpu")
        if ref:
            for n, v in init.items():
                scope.set_var(n, v)
    marks = []

    def handler(e):
        if isinstance(e, pkg.EndIteration):
            marks.append((e.step_id, e.metrics.get("skipped_nonfinite"),
                          e.metrics.get("rolled_back_to")))
            if events is not None:
                events(e, scope)

    guard = ptpu.scope_guard(scope) if ref else core.scope_guard(scope)
    try:
        with guard:
            kw = dict(main_program=main, startup_program=startup,
                      checkpoint_dir=ckpt, checkpoint_every_n_steps=every,
                      policy=sup.RecoveryPolicy(**policy_kw))
            if not ref:
                kw["device"] = "cpu"
            tr = sup.ResilientTrainer(loss, **kw)
            tr._initialized = True       # the reference's startup scope
            tr.train(_reader(steps), num_passes=1, staging=False,
                     event_handler=handler)
    finally:
        flt.disarm()
    return _state(ref, scope), marks, tr, scope


def test_skip_policy_equals_the_reference_and_leaves_the_state(init):
    seen = {}

    def grab(e, scope):
        if e.step_id in (3, 4):
            seen[e.step_id] = _state(False, scope)

    skipped0 = _counter("paddle_resilience_skipped_steps_total")
    kw = dict(nonfinite_policy="skip", nonfinite_budget=3)
    arm = [("nan_loss", dict(at=3))]
    ours, marks, tr, _ = _run(False, init, kw, 8, arm=arm, events=grab)
    theirs, ref_marks, _, _ = _run(True, init, kw, 8, arm=arm)
    assert marks == ref_marks
    assert [m for m in marks if m[1]] == [(4, True, None)]
    for n in STATE:
        np.testing.assert_allclose(ours[n], theirs[n], rtol=TOL, atol=TOL,
                                   err_msg=n)
    # the skipped step (step_id 4 at its EndIteration) left every
    # parameter and velocity bitwise as step 3 did
    for n in STATE:
        np.testing.assert_array_equal(seen[4][n], seen[3][n], err_msg=n)
    assert _counter("paddle_resilience_skipped_steps_total") == \
        skipped0 + 1
    assert port_config.get_flag("nonfinite_guard")
    assert all(np.isfinite(v).all() for v in ours.values())


def test_rollback_marks_and_lr_backoff_equal(init, tmp_path):
    kw = dict(nonfinite_policy="rollback", nonfinite_budget=3,
              lr_backoff=0.5)
    arm = [("nan_loss", dict(at=5))]
    r0 = _counter("paddle_resilience_rollbacks_total")
    ours, marks, _, scope = _run(False, init, kw, 8,
                                 ckpt=str(tmp_path / "p"), every=2,
                                 arm=arm)
    theirs, ref_marks, _, ref_scope = _run(True, init, kw, 8,
                                           ckpt=str(tmp_path / "r"),
                                           every=2, arm=arm)
    assert [m[2] for m in marks if m[2]] == \
        [m[2] for m in ref_marks if m[2]] == [4]
    assert marks == ref_marks
    assert _counter("paddle_resilience_rollbacks_total") == r0 + 1
    lr = scope.find_var("learning_rate_0").numpy()
    np.testing.assert_allclose(lr, np.asarray(
        ref_scope.find_var("learning_rate_0")))
    np.testing.assert_allclose(lr, 0.025)
    for n in STATE:
        np.testing.assert_allclose(ours[n], theirs[n], rtol=TOL, atol=TOL,
                                   err_msg=n)


def test_lr_backoff_compounds_as_the_reference(init, tmp_path):
    kw = dict(nonfinite_policy="rollback", nonfinite_budget=5,
              lr_backoff=0.5)
    arm = [("nan_loss", dict(at=5, times=2))]
    ours, marks, _, scope = _run(False, init, kw, 10,
                                 ckpt=str(tmp_path / "p"), every=4,
                                 arm=arm)
    theirs, ref_marks, _, ref_scope = _run(True, init, kw, 10,
                                           ckpt=str(tmp_path / "r"),
                                           every=4, arm=arm)
    assert marks == ref_marks
    assert [m[2] for m in marks if m[2]] == [4, 4]
    np.testing.assert_allclose(scope.find_var("learning_rate_0").numpy(),
                               0.05 * 0.5 * 0.5)
    np.testing.assert_allclose(
        np.asarray(ref_scope.find_var("learning_rate_0")), 0.05 * 0.25)
    for n in STATE:
        np.testing.assert_allclose(ours[n], theirs[n], rtol=TOL, atol=TOL,
                                   err_msg=n)


def test_budget_exhausted_and_reset(init):
    for ref in (False, True):
        with pytest.raises(FloatingPointError, match="budget exhausted"):
            _run(ref, init, dict(nonfinite_policy="skip",
                                 nonfinite_budget=2), 8,
                 arm=[("nan_loss", dict(times=100))])
    seen = []
    for ref in (False, True):
        _, marks, tr, _ = _run(ref, init, dict(nonfinite_policy="skip",
                                               nonfinite_budget=1), 8,
                               arm=[("nan_loss", dict(at=1)),
                                    ("nan_loss", dict(at=4))])
        seen.append((tr.nonfinite_seen, marks))
    assert seen[0] == seen[1]
    assert seen[0][0] == 0
    with pytest.raises(FloatingPointError, match="policy=raise"):
        _run(False, init, {}, 8, arm=[("nan_loss", dict(at=2))])


def test_check_nan_inf_does_not_void_the_policy(init):
    port_config.set_flags(check_nan_inf=True)
    _, marks, _, _ = _run(False, init, dict(nonfinite_policy="skip",
                                            nonfinite_budget=3), 5,
                          arm=[("nan_loss", dict(at=2))])
    assert not port_config.get_flag("check_nan_inf")
    assert len(marks) == 5


def test_reader_retry_and_permanent_failure():
    outs = []
    for mod in (port_sup, ref_sup):
        state = {"fail": True}

        def flaky():
            for i in range(10):
                if i == 4 and state["fail"]:
                    state["fail"] = False
                    raise IOError("transient")
                yield i

        def creator_fails():
            if state.setdefault("open", True):
                state["open"] = False
                raise IOError("briefly unavailable")
            return iter(range(5))

        r0 = _counter("paddle_resilience_reader_retries_total",
                      metrics.REGISTRY if mod is port_sup
                      else ref_metrics.REGISTRY)
        outs.append((list(mod.resilient_reader(lambda: flaky(),
                                               backoff=0.001)()),
                     list(mod.resilient_reader(creator_fails,
                                               backoff=0.001)())))
        assert _counter("paddle_resilience_reader_retries_total",
                        metrics.REGISTRY if mod is port_sup
                        else ref_metrics.REGISTRY) == r0 + 2

        def dead():
            yield 0
            raise IOError("permanent")

        with pytest.raises(IOError, match="permanent"):
            list(mod.resilient_reader(lambda: dead(), retries=2,
                                      backoff=0.001)())
    assert outs[0] == outs[1] == (list(range(10)), list(range(5)))


@pytest.mark.parametrize("exc", [IOError("injected"), None])
def test_reader_fault_through_the_trainer(init, exc):
    arm = [("reader_error", dict(at=3, exc=exc) if exc else dict(at=2))]
    kw = dict(nonfinite_policy="skip", reader_backoff=0.001)
    ours, marks, _, _ = _run(False, init, kw, 6, arm=arm)
    theirs, ref_marks, _, _ = _run(True, init, kw, 6, arm=arm)
    assert len(marks) == 6 and marks == ref_marks
    for n in STATE:
        np.testing.assert_allclose(ours[n], theirs[n], rtol=TOL, atol=TOL)


def test_watchdog_fires_once_per_overrun_step():
    stalls0 = _counter("paddle_resilience_watchdog_stalls_total")
    hangs = []
    wd = StepWatchdog(0.05, poll_interval=0.01,
                      on_hang=lambda s, e: hangs.append(s)).start()
    try:
        wd.step_started(1)
        time.sleep(0.25)
        assert _counter("paddle_resilience_watchdog_stalls_total") == \
            stalls0 + 1
        wd.step_finished()
        wd.step_started(2)
        wd.step_finished()
        time.sleep(0.1)
        wd.step_started(3)
        time.sleep(0.25)
        assert _counter("paddle_resilience_watchdog_stalls_total") == \
            stalls0 + 2
        assert hangs == [1, 3]
    finally:
        wd.stop()


def test_watchdog_abort_interrupts_main_thread():
    wd = StepWatchdog(0.05, abort=True, poll_interval=0.01).start()
    try:
        wd.step_started(1)
        t0 = time.monotonic()
        with pytest.raises(KeyboardInterrupt):
            for _ in range(100):      # 5 s unless the interrupt lands
                time.sleep(0.05)
        assert time.monotonic() - t0 < 2.0
    finally:
        wd.stop()


def test_watchdog_abort_leaves_sigint_on_default_handler(init):
    observed = {}

    def handler(e, scope):
        if e.step_id == 1:
            observed["sigint"] = signal.getsignal(signal.SIGINT)
            observed["sigterm"] = signal.getsignal(signal.SIGTERM)

    _run(False, init, dict(step_deadline_sec=60, watchdog_abort=True), 3,
         events=handler)
    assert observed["sigint"] is signal.default_int_handler
    assert callable(observed["sigterm"]) and \
        observed["sigterm"] is not signal.SIG_DFL


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_preemption_checkpoint_crosses_packages(init, tmp_path, writer):
    """SIGTERM at step 3 in one package: the final checkpoint carries
    the resume metadata; the other package's ResilientTrainer resumes
    from it and ends where an uninterrupted reference pass ends."""
    ckpt = str(tmp_path / "ck")
    preempt0 = _counter("paddle_resilience_preemptions_total",
                        metrics.REGISTRY if writer == "port"
                        else ref_metrics.REGISTRY)

    def sigterm(e, scope):
        if e.step_id == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    ref = writer == "reference"
    _, marks, _, _ = _run(ref, init, {}, 8, ckpt=ckpt, every=100,
                          events=sigterm)
    assert [m[0] for m in marks] == [1, 2, 3]
    assert _counter("paddle_resilience_preemptions_total",
                    ref_metrics.REGISTRY if ref else metrics.REGISTRY) \
        == preempt0 + 1
    meta = (ref_io if ref else port_io).load_checkpoint_meta(ckpt)
    assert meta["preempted"] and meta["step"] == 3
    assert meta["reason"] == "signal_%d" % signal.SIGTERM
    # the other package resumes: startup() loads the checkpoint
    main, startup, loss = _program(not ref)
    if ref:
        scope = core.Scope()
        with core.scope_guard(scope):
            tr = ResilientTrainer(loss, main_program=main,
                                  startup_program=startup,
                                  checkpoint_dir=ckpt, device="cpu")
            tr.startup()
            assert tr.step_id == 3
            # the rest of the pass: the batches after the third
            rest = list(_reader(8)())[3:]
            tr.train(lambda: iter(rest), num_passes=1, staging=False)
        resumed = _state(False, scope)
    else:
        scope = ptpu.Scope()
        with ptpu.scope_guard(scope):
            tr = ref_sup.ResilientTrainer(loss, main_program=main,
                                          startup_program=startup,
                                          checkpoint_dir=ckpt)
            tr.startup()
            assert tr.step_id == 3
            rest = list(_reader(8)())[3:]
            tr.train(lambda: iter(rest), num_passes=1, staging=False)
        resumed = _state(True, scope)
    whole, _, _, _ = _run(True, init, {}, 8)
    for n in STATE:
        np.testing.assert_allclose(resumed[n], whole[n], rtol=TOL,
                                   atol=TOL, err_msg=n)


def test_resilience_families_equal_the_reference():
    ours = metrics.REGISTRY.families()
    theirs = ref_metrics.REGISTRY.families()
    mine = sorted(n for n in ours if n.startswith("paddle_resilience_"))
    assert mine == sorted(n for n in theirs
                          if n.startswith("paddle_resilience_")) == sorted(
        "paddle_resilience_%s" % n for n in (
            "nonfinite_steps_total", "skipped_steps_total",
            "rollbacks_total", "reader_retries_total",
            "watchdog_stalls_total", "preemptions_total"))
    for name in mine:
        assert (ours[name].kind, ours[name].help, ours[name].labelnames) \
            == (theirs[name].kind, theirs[name].help,
                theirs[name].labelnames), name


def test_policy_defaults_read_the_flags():
    p = RecoveryPolicy()
    ref = ref_sup.RecoveryPolicy()
    for k in ("nonfinite_policy", "nonfinite_budget", "reader_retries",
              "step_deadline_sec", "preempt_signals"):
        assert getattr(p, k) == getattr(ref, k), k
    port_config.set_flags(nonfinite_policy="skip")
    try:
        assert RecoveryPolicy().nonfinite_policy == "skip"
    finally:
        port_config.set_flags(nonfinite_policy="raise")
    with pytest.raises(ValueError, match="raise|skip|rollback"):
        RecoveryPolicy(nonfinite_policy="retry")


def test_finite_check_reads_tensors():
    assert ResilientTrainer._all_finite(
        {"loss": torch.tensor(1.0), "n": torch.tensor([1, 2]), "k": 3})
    assert not ResilientTrainer._all_finite(
        {"loss": torch.tensor([1.0, float("nan")])})
    assert not ResilientTrainer._all_finite({"loss": np.float32(np.inf)})
    assert resilient_reader is port_sup.resilient_reader
