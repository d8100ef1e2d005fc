"""The port's event-driven ``Trainer`` (``paddle_tpu_torch/trainer.py``)
against the reference's, on the CPU.

A small ResNet program (``resnet_cifar10(depth=8)`` at 16 x 16, Momentum
0.01/0.9) is trained by both ``Trainer.train`` loops over packed uint8
feeds (``packed_feeds`` on, the staged pipeline) for two passes from the
reference's startup scope: the event sequence and step ids are the
reference's, and the losses within the program path's tolerance
(``test_torch_program_resnet.py``, 1e-4 relative). A small softmax
classifier runs the rest against the reference: ``test()``,
``report()``, the preempt and restart exits with their ``latest.json``,
periodic checkpoints and resume, the trainer's metric families, and
what the port refuses.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import layers as ref_layers
from paddle_tpu import trainer as ref_trainer
from paddle_tpu.core import ingest as ref_ingest  # noqa: F401
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch import trainer as port_trainer
from paddle_tpu_torch.models import resnet as port_resnet
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.reader import staging
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RES, BATCH, LR = 16, 4, 0.01
F32_RTOL = 1e-4
TRAINER_FAMILIES = sorted(
    "paddle_trainer_%s" % n for n in (
        "step_seconds", "examples_total", "examples_per_second",
        "steps_total", "checkpoint_seconds"))


@pytest.fixture(autouse=True)
def _restore():
    yield
    for cfg in (port_config, ptpu.config):
        cfg.set_flags(packed_feeds=False, telemetry=False)


def _resnet(pkg):
    ref = pkg is ref_trainer
    fw = ptpu if ref else pc
    layers = ref_layers if ref else port_layers
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 0
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        img = layers.data("img", shape=[3, RES, RES], wire_dtype="uint8",
                          scale=1.0 / 255.0)
        label = layers.data("label", shape=[1], dtype="int64",
                            wire_dtype="int32")
        if ref:
            loss = ref_resnet.resnet_cifar10(img, label, depth=8)[0]
            ptpu.optimizer.Momentum(LR, 0.9).minimize(loss, startup)
        else:
            loss = port_resnet.resnet_cifar10(img, label, depth=8)[0]
            port_opt.Momentum(LR, 0.9).minimize(loss, startup)
    return main, startup, loss


def _image_reader(n=3):
    def reader():
        rs = np.random.RandomState(11)
        for _ in range(n):
            yield {"img": rs.randint(0, 256, (BATCH, 3, RES, RES))
                   .astype(np.uint8),
                   "label": rs.randint(0, 10, (BATCH, 1)).astype(np.int32)}
    return reader


def _recorder(pkg, out):
    def handler(e):
        row = [type(e).__name__, e.pass_id, getattr(e, "batch_id", None),
               getattr(e, "step_id", None)]
        if isinstance(e, pkg.EndIteration):
            row.append(float(np.asarray(e.cost)))
        if isinstance(e, pkg.EndPass):
            row.append(sorted(e.metrics))
        out.append(row)
    return handler


@pytest.fixture(scope="module")
def reference_run():
    """The reference's startup scope and its events over two passes of
    three packed batches."""
    main, startup, loss = _resnet(ref_trainer)
    ptpu.config.set_flags(packed_feeds=True)
    events = []
    scope = ptpu.Scope()
    try:
        with ptpu.scope_guard(scope):
            tr = ref_trainer.Trainer(loss, main_program=main,
                                     startup_program=startup)
            tr.startup()
            init = {n: np.array(scope.find_var(n))
                    for n in scope.var_names()}
            tr.train(_image_reader(), num_passes=2,
                     event_handler=_recorder(ref_trainer, events))
    finally:
        ptpu.config.set_flags(packed_feeds=False)
    return init, events


def _port_events(init, staging_on=True, telemetry=False):
    main, startup, loss = _resnet(port_trainer)
    port_config.set_flags(packed_feeds=True, telemetry=telemetry)
    events = []
    scope = port_io.scope_from_jax(init, device="cpu")
    with pc.scope_guard(scope):
        tr = port_trainer.Trainer(loss, main_program=main,
                                  startup_program=startup, device="cpu")
        tr._initialized = True   # the reference's startup scope
        tr.train(_image_reader(), num_passes=2, staging=staging_on,
                 event_handler=_recorder(port_trainer, events))
    return events, tr


def _split(events):
    shape = [e[:4] + e[5:] for e in events]
    losses = [e[4] for e in events if e[0] == "EndIteration"]
    return shape, losses


def test_packed_staged_training_equals_the_reference(reference_run):
    init, ref_events = reference_run
    events, tr = _port_events(init)
    shape, losses = _split(events)
    ref_shape, ref_losses = _split(ref_events)
    assert shape == ref_shape
    assert [e[3] for e in events if e[0] == "EndIteration"] == \
        list(range(1, 7))
    assert tr.step_id == 6
    for got, want in zip(losses, ref_losses):
        assert abs(got - want) <= F32_RTOL * abs(want), (losses, ref_losses)
    # the plain prefetch queue (staging off) takes the same steps
    plain, _ = _port_events(init, staging_on=False)
    assert plain == events


def test_telemetry_counts_steps_and_examples(reference_run):
    init, _ = reference_run
    port_trainer._STEPS_TOTAL.inc(0)
    s0 = port_trainer._STEPS_TOTAL.value
    e0 = port_trainer._EXAMPLES_TOTAL.value
    t0 = staging._TRANSFERS.value
    _, tr = _port_events(init, telemetry=True)
    assert port_trainer._STEPS_TOTAL.value - s0 == 6
    assert port_trainer._EXAMPLES_TOTAL.value - e0 == 6 * BATCH
    assert staging._TRANSFERS.value - t0 == 6   # one per packed batch
    gauge = port_trainer._EXAMPLES_PER_SEC.labels(trainer=tr._tel_label)
    assert gauge.value > 0


def test_trainer_families_equal_the_reference():
    ours = metrics.REGISTRY.families()
    theirs = ref_metrics.REGISTRY.families()
    mine = sorted(n for n in ours if n.startswith("paddle_trainer_"))
    assert mine == TRAINER_FAMILIES
    for name in mine + ["paddle_stat_span_seconds", "paddle_stat_gauge"]:
        assert (ours[name].kind, ours[name].help, ours[name].labelnames) \
            == (theirs[name].kind, theirs[name].help,
                theirs[name].labelnames), name


def _classifier(pkg):
    ref = pkg is ref_trainer
    fw = ptpu if ref else pc
    layers = ref_layers if ref else port_layers
    main, startup, test = fw.Program(), fw.Program(), fw.Program()
    startup.random_seed = 3
    for prog, train in ((main, True), (test, False)):
        with fw.unique_name.guard(), fw.program_guard(prog, startup):
            x = layers.data("x", shape=[5])
            y = layers.data("y", shape=[1], dtype="int64")
            logits = layers.fc(x, 3, param_attr="fc.w", bias_attr="fc.b")
            loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
            if train:
                (ptpu.optimizer if ref else port_opt).SGD(0.1).minimize(
                    loss, startup)
                train_loss = loss
            else:
                test_loss = loss
    return main, startup, test, train_loss, test_loss


def _xy_reader(n=6, seed=1):
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(n):
            yield {"x": rs.randn(4, 5).astype(np.float32),
                   "y": rs.randint(0, 3, (4, 1)).astype(np.int64)}
    return reader


def _make(pkg, scope, **kw):
    main, startup, test, loss, test_loss = _classifier(pkg)
    extra = {} if pkg is ref_trainer else {"device": "cpu"}
    guard = ptpu.scope_guard if pkg is ref_trainer else pc.scope_guard
    with guard(scope):
        tr = pkg.Trainer(loss, main_program=main, startup_program=startup,
                         **kw, **extra)
        tr.startup()
    return tr, test, test_loss, guard


def _both(fn, **kw):
    """fn(pkg, trainer, test program, test loss) under each package's
    scope guard: (port result, reference result)."""
    out = []
    for pkg, scope in ((port_trainer, pc.Scope()),
                       (ref_trainer, ptpu.Scope())):
        tr, test, test_loss, guard = _make(pkg, scope, **kw)
        with guard(scope):
            out.append(fn(pkg, tr, test, test_loss))
    return out


def test_test_and_report_as_the_reference():
    def run(pkg, tr, test, test_loss):
        tr.train(_xy_reader(), num_passes=1)
        return tr.test(_xy_reader(3, seed=5), test, {"loss": test_loss})

    got, want = _both(run)
    assert sorted(got) == ["loss"]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    report = port_trainer.Trainer.report(None)
    assert "StatSet" in report and "trainOneBatch" in report


@pytest.mark.parametrize("exit_", ["stop", "restart"])
def test_preempt_and_restart_exits_as_the_reference(tmp_path, exit_):
    out = []
    for pkg, scope, name in ((port_trainer, pc.Scope(), "port"),
                             (ref_trainer, ptpu.Scope(), "ref")):
        tr, _, _, guard = _make(pkg, scope,
                                checkpoint_dir=str(tmp_path / name))

        def handler(e, tr=tr, pkg=pkg):
            if isinstance(e, pkg.EndIteration) and e.batch_id == 1:
                if exit_ == "stop":
                    tr.request_stop("sigterm")
                else:
                    tr.request_restart("resize")

        with guard(scope):
            record = tr.train(_xy_reader(), num_passes=2,
                              event_handler=handler)
        with open(os.path.join(tr.checkpoint_dir, "latest.json")) as f:
            latest = json.load(f)
        assert tr._stop_reason is None and tr._restart_reason is None
        out.append((record, latest, sorted(os.listdir(tr.checkpoint_dir))))
    (record, latest, files), (r_record, r_latest, r_files) = out
    assert record == r_record
    assert record["step"] == 2 and record["batch_id"] == 1
    assert {k: v for k, v in latest.items() if k != "dir"} == \
        {k: v for k, v in r_latest.items() if k != "dir"}
    assert latest["dir"].endswith("checkpoint_2")
    assert files == r_files


def test_periodic_checkpoints_and_resume(tmp_path):
    d = str(tmp_path / "ck")
    scope = pc.Scope()
    tr, _, _, guard = _make(port_trainer, scope, checkpoint_dir=d,
                            checkpoint_every_n_steps=2)
    with guard(scope):
        tr.train(_xy_reader(5), num_passes=1)
        w = scope.find_var("fc.w").clone()
    # every 2 steps, then the pass's end; keep_last 3
    assert sorted(os.listdir(d)) == ["checkpoint_2", "checkpoint_4",
                                     "checkpoint_5", "latest.json"]
    fresh = pc.Scope()
    tr2, _, _, _ = _make(port_trainer, fresh, checkpoint_dir=d)
    assert tr2.step_id == 5
    assert torch.equal(fresh.find_var("fc.w"), w)
    # the rollback primitive: back to the newest intact checkpoint
    with guard(fresh):
        tr2.train(_xy_reader(2), num_passes=1)
        assert tr2.step_id == 7
        assert tr2.restore_checkpoint() == 7
    sched = type("Sched", (), {"step_num": 0, "step": lambda self: None})()
    tr2.scheduler = sched
    tr2._sync_scheduler()
    assert sched.step_num == 7


def test_what_the_trainer_refuses(tmp_path, monkeypatch):
    scope = pc.Scope()
    tr, _, _, _ = _make(port_trainer, scope)
    main, startup, _, loss, _ = _classifier(port_trainer)
    # a strategy is taken (it no longer raises): the executor runs on it
    from paddle_tpu_torch import parallel
    strat = parallel.DataParallel(n_devices=1)
    assert port_trainer.Trainer(loss, main_program=main,
                                startup_program=startup, strategy=strat,
                                device="cpu").exe.strategy is strat

    # on a CUDA device, a staged reader with neither an arena nor
    # packing is not swapped for the plain queue
    class NoArena:
        arena_active = False

        def __init__(self, *a, **kw):
            pass

        def packing_enabled(self):
            return False

        def close(self):
            NoArena.closed = True

    monkeypatch.setattr(staging, "StagedReader", NoArena)
    tr.exe.device = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="does not fall back"):
        tr.train(_xy_reader(1))
    assert NoArena.closed
    # on the CPU the reference's fallback is kept
    tr.exe.device = torch.device("cpu")
    with pc.scope_guard(scope):
        tr.train(_xy_reader(2))
    assert tr.step_id == 2


def test_an_exception_mid_pass_leaves_no_thread_and_no_flag():
    scope = pc.Scope()
    tr, _, _, guard = _make(port_trainer, scope)
    port_config.set_flags(packed_feeds=True)

    def handler(e):
        if isinstance(e, port_trainer.EndIteration) and e.batch_id == 1:
            tr.request_stop()
            raise KeyError("handler broke")

    with guard(scope):
        with pytest.raises(KeyError, match="handler broke"):
            tr.train(_xy_reader(6), event_handler=handler)
    assert tr._stop_reason is None and tr._restart_reason is None
    assert not [t for t in threading.enumerate()
                if getattr(getattr(t, "_target", None), "__name__", "")
                == "_fill" and t.is_alive()]
    # the trainer trains on afterwards
    with guard(scope):
        assert tr.train(_xy_reader(1)) is None


def test_train_step_stays_for_the_module_route():
    lin = torch.nn.Linear(3, 2)

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = lin

        def forward(self, x, y):
            out = self.lin(x)
            return torch.nn.functional.cross_entropy(out, y), out

    m = M()
    opt = torch.optim.SGD(m.parameters(), 0.1)
    loss, logits = port_trainer.train_step(
        m, opt, torch.ones(2, 3), torch.tensor([0, 1]))
    assert loss.requires_grad is False and logits.shape == (2, 2)
