"""ResNet-8 for CIFAR trained through the port's program path (front end,
``Momentum.minimize``, ``Executor``) against the reference's.

The reference builds ``resnet_cifar10(depth=8)`` at 16 x 16 with
Momentum(0.01, 0.9), runs its startup program and 3 steps on batch 4,
with ``fused_conv_bn`` off and on and ``amp`` off and on (a module
fixture, one reference run per combination). The port builds the same
program with its own front end, takes the reference's initial scope
(``io.scope_from_jax``) and runs the same 3 steps. Tolerances are
PERF.md §2's for the small ResNet: f32 losses, parameters, velocities
and running statistics within 1e-4 of each tensor's norm; under amp
(bf16 products summed in other orders) losses within 1e-2 relative and
every parameter within 2 lr a step.

Also: recompute on equals recompute off; the reference's serialized
program run by the port equals the port-built one; and the executor
route equals the ``nn.Module`` route (``models/resnet.py``,
``trainer.train_step``) from the same weights."""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import layers as ref_layers
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch import trainer
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.models import resnet as port_resnet
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

LR, STEPS, RES, BATCH = 0.01, 3, 16, 4
F32_RTOL = 1e-4
AMP_LOSS_RTOL = 1e-2


def _feeds():
    rs = np.random.RandomState(5)
    return {"img": rs.standard_normal((BATCH, 3, RES, RES))
            .astype(np.float32),
            "label": rs.randint(0, 10, (BATCH, 1)).astype(np.int64)}


def _build(pkg, fused, recompute=False):
    ref = pkg == "ref"
    cfg = ptpu.config if ref else port_config
    fw = ptpu if ref else pc
    layers = ref_layers if ref else port_layers
    cfg.set_flags(fused_conv_bn=fused)
    try:
        main, startup = fw.Program(), fw.Program()
        startup.random_seed = 0
        with fw.unique_name.guard(), fw.program_guard(main, startup):
            img = layers.data("img", shape=[3, RES, RES])
            label = layers.data("label", shape=[1], dtype="int64")
            if ref:
                loss = ref_resnet.resnet_cifar10(img, label, depth=8)[0]
                ptpu.optimizer.Momentum(LR, 0.9).minimize(loss, startup)
            else:
                loss = port_resnet.resnet_cifar10(
                    img, label, depth=8, recompute=recompute)[0]
                port_opt.Momentum(LR, 0.9).minimize(loss, startup)
    finally:
        cfg.set_flags(fused_conv_bn=False)
    return main, startup, loss.name


def _state(scope, numpy_of):
    return {n: numpy_of(scope.find_var(n)) for n in scope.var_names()
            if not n.startswith("@")}


@pytest.fixture(scope="module")
def reference():
    """{(fused, amp): (initial scope, losses, final state)}."""
    out = {}
    for fused in (False, True):
        main, startup, loss = _build("ref", fused)
        for amp in (None, "bfloat16"):
            scope = ptpu.Scope()
            exe = ptpu.Executor()
            with ptpu.scope_guard(scope):
                exe.run(startup)
                init = {n: np.array(scope.find_var(n))
                        for n in scope.var_names()}
                ptpu.config.set_flags(amp=amp)
                try:
                    losses = [float(exe.run(main, feed=_feeds(),
                                            fetch_list=[loss])[0])
                              for _ in range(STEPS)]
                finally:
                    ptpu.config.set_flags(amp=None)
            out[fused, amp] = (init, losses, _state(scope, np.array))
    return out


def _port_train(main, loss, init, amp=None):
    scope = port_io.scope_from_jax(init, device="cpu")
    exe = pc.Executor(device="cpu")
    port_config.set_flags(amp=amp)
    try:
        losses = [float(exe.run(main, feed=_feeds(), fetch_list=[loss],
                                scope=scope)[0]) for _ in range(STEPS)]
    finally:
        port_config.set_flags(amp=None)
    return losses, _state(scope, lambda t: t.numpy())


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("amp", [None, "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
def test_three_momentum_steps_match_the_reference(reference, fused, amp):
    init, want_losses, want = reference[fused, amp]
    main, _, loss = _build("port", fused)
    losses, got = _port_train(main, loss, init, amp)
    assert sorted(got) == sorted(want)
    if amp is None:
        np.testing.assert_allclose(losses, want_losses, rtol=F32_RTOL)
        worst = max(got, key=lambda n: _rel(got[n], want[n]))
        assert _rel(got[worst], want[worst]) <= F32_RTOL, worst
    else:
        np.testing.assert_allclose(losses, want_losses, rtol=AMP_LOSS_RTOL)
        params = [n for n in want if n.count(".w_") and "_acc_" not in n]
        assert params
        for n in params:
            assert np.abs(got[n] - want[n]).max() <= 2 * LR * STEPS, n
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("amp", [None, "bfloat16"])
def test_recompute_equals_no_recompute(reference, amp):
    """Each residual block under ``recompute_block`` (run again for its
    gradient by torch.utils.checkpoint): the same losses and state, the
    running statistics updated once a step."""
    init = reference[False, None][0]
    plain = _port_train(*_build("port", False)[::2], init, amp)
    main, _, loss = _build("port", False, recompute=True)
    assert sum(op.type == "recompute_block"
               for op in main.global_block().ops) == 3
    again = _port_train(main, loss, init, amp)
    np.testing.assert_allclose(again[0], plain[0], rtol=1e-6)
    for n, v in plain[1].items():
        np.testing.assert_allclose(again[1][n], v, rtol=1e-5, atol=1e-7,
                                   err_msg=n)


def test_reference_serialized_program_runs_the_same(reference):
    init = reference[True, None][0]
    ref_main, _, loss = _build("ref", True)
    loaded = port_ser.program_from_dict(
        json.loads(json.dumps(ref_ser.program_to_dict(ref_main))))
    ours = _port_train(_build("port", True)[0], loss, init)
    theirs = _port_train(loaded, loss, init)
    assert ours[0] == theirs[0]
    for n, v in ours[1].items():
        np.testing.assert_array_equal(theirs[1][n], v, err_msg=n)


@pytest.mark.parametrize("fused", [False, True])
def test_executor_route_equals_module_route(reference, fused):
    """The same weights through ``Executor.run`` of the program and
    through the ``nn.Module`` ResNet with ``trainer.train_step``."""
    init = reference[fused, None][0]
    main, _, loss = _build("port", fused)
    prog_losses, prog = _port_train(main, loss, init)
    port_config.set_flags(fused_conv_bn=fused)
    try:
        model = port_resnet.resnet_cifar10(8, device="cpu")
    finally:
        port_config.set_flags(fused_conv_bn=False)
    opt = port_opt.Momentum(model.reference_parameters(), 0.5, 0.9)
    port_io.params_from_jax(init, model=model, optimizer=opt)
    assert opt.learning_rate == pytest.approx(LR)
    feeds = _feeds()
    img, label = (torch.from_numpy(feeds[k]) for k in ("img", "label"))
    mod_losses = [float(trainer.train_step(model, opt, img, label)[0])
                  for _ in range(STEPS)]
    np.testing.assert_allclose(mod_losses, prog_losses, rtol=1e-6)
    tensors = dict(model.reference_tensors(), **opt.accumulators())
    for n, t in tensors.items():
        np.testing.assert_allclose(t.detach().numpy(), prog[n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)
