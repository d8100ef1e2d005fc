"""The port's ResNet training path (``paddle_tpu_torch/models/resnet.py``,
``layers/conv.py``, ``optimizer.py``, ``trainer.py``, ``io.py``) against
the reference's programs, from the same weights: the reference's scope
after its startup program is carried into the port by name
(``io.params_from_jax`` with the model and the optimizer).

* The small convnet of the reference's fused-conv test
  (``tests/test_quant_compute.py`` ``_train_convnet``), fused and
  unfused, three SGD steps: the port's losses equal the reference's to
  ``rtol = 1e-5`` (float32 through two conv layers and an fc), and the
  port's fused net equals its unfused net to the reference's own
  ``rtol = 1e-4``.
* ResNet-8 for CIFAR (basic blocks, fused), two Momentum steps: losses,
  parameters, velocities and running statistics to 1e-4 of each
  tensor's magnitude, and the ``is_test`` logits after training.
* Full-depth ResNet-50, fused, 64 x 64 images, batch 4, Momentum(1e-3,
  0.9), one step: the scope's names and shapes; the loss to 1e-5; the
  running statistics (forward quantities) to 1e-3 of each tensor's norm;
  every velocity (the step's gradient) and updated parameter to 5e-2 of
  its norm. The last is loose on purpose: one float32 step of this
  network from He-normal initial weights is ill-conditioned. Against a
  float64 run of the same step the reference's own velocities are off by
  up to 1.8% of their norm (median 1.3%), and the port's by as much; the
  test also holds the port to be no less accurate than the reference
  over all 161 velocities (median distance to the float64 step at most
  1.5 times the reference's).
* The fused ResNet-50 forward routes 30 convolutions to kernel B1's
  wrapper, and the scope names of other depths and of the unfused form
  match the reference's programs."""

import numpy as np
import pytest
import torch
from torch import nn

import paddle_tpu as ptpu
from paddle_tpu import layers
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch import trainer
from paddle_tpu_torch.layers.conv import FC, ConvBN, UniqueNames
from paddle_tpu_torch.models import resnet as port_resnet
from paddle_tpu_torch.ops import conv_bn as port_cb
from paddle_tpu_torch.ops.loss_ops import mean, softmax_with_cross_entropy
from paddle_tpu_torch.ops.nn_ops import pool2d
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _state(scope):
    return {n: np.array(scope.find_var(n)) for n in scope.var_names()
            if not n.startswith("@")}


def _run_reference(build, feeds, fused, optimizer, steps, fetch_test=None):
    """Build a program with ``build(img, label) -> loss`` under the
    ``fused_conv_bn`` flag, run its startup and ``steps`` training steps
    on ``feeds`` (img, label). Returns (state before, losses, state after,
    is_test outputs of ``fetch_test`` or None)."""
    ptpu.config.set_flags(fused_conv_bn=fused)
    try:
        with ptpu.unique_name.guard():
            main, startup = ptpu.Program(), ptpu.Program()
            main.random_seed = startup.random_seed = 11
            with ptpu.program_guard(main, startup):
                img = layers.data("img", shape=list(feeds[0].shape[1:]))
                label = layers.data("label", shape=[1], dtype="int64")
                loss = build(img, label)
                optimizer.minimize(loss, startup_program=startup)
    finally:
        ptpu.config.set_flags(fused_conv_bn=False)
    exe = ptpu.Executor()
    scope = ptpu.Scope()
    losses = []
    with ptpu.scope_guard(scope):
        exe.run(startup)
        before = _state(scope)
        for _ in range(steps):
            out, = exe.run(main, feed={"img": feeds[0], "label": feeds[1]},
                           fetch_list=[loss])
            losses.append(float(np.asarray(out)))
        after = _state(scope)
    return before, losses, after


def _port_state(model, opt):
    out = {n: t.detach().double().numpy()
           for n, t in model.reference_tensors().items()}
    out.update({n: v.double().numpy()
                for n, v in opt.accumulators().items()})
    return out


def _port_build(build, *args, fused, **kwargs):
    """A port model built under the port's ``fused_conv_bn`` flag."""
    port_config.set_flags(fused_conv_bn=fused)
    try:
        return build(*args, **kwargs)
    finally:
        port_config.set_flags(fused_conv_bn=False)


def _rel(a, b):
    """||a - b|| / ||b|| over a tensor."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# -- the reference's fused-conv test net ----------------------------------

def _ref_convnet(img, label):
    h = ref_resnet.conv_bn_layer(img, 8, 3, 1, 1)
    h = ref_resnet.conv_bn_layer(h, 8, 1, 1, 0)
    pool = layers.pool2d(h, pool_size=8, pool_type="avg",
                         global_pooling=True)
    logits = layers.fc(layers.reshape(pool, [-1, 8]), 4)
    return layers.mean(layers.softmax_with_cross_entropy(logits, label))


class _PortConvnet(nn.Module):
    """The same net from the port's layers, named as the reference's."""

    def __init__(self, fused):
        super().__init__()
        names = UniqueNames()
        self.device = torch.device("cpu")
        self.convs = nn.Sequential(
            ConvBN(4, 8, 3, 1, 1, fused=fused, names=names, device="cpu"),
            ConvBN(8, 8, 1, 1, 0, fused=fused, names=names, device="cpu"))
        self.fc = FC(8, 4, names=names, device="cpu")

    def reference_tensors(self):
        out = {}
        for layer in list(self.convs) + [self.fc]:
            for attr, name in layer.ref_names.items():
                out[name] = getattr(layer, attr)
        return out

    def reference_parameters(self):
        return {n: t for n, t in self.reference_tensors().items()
                if isinstance(t, nn.Parameter)}

    def forward(self, img, label):
        pool = pool2d(self.convs(img), 8, "avg", global_pooling=True)
        logits = self.fc(pool.reshape(-1, 8))
        return mean(softmax_with_cross_entropy(logits, label)[0]), None


def _convnet_feeds():
    rs = np.random.RandomState(11)
    return (rs.randn(6, 4, 8, 8).astype("float32"),
            rs.randint(0, 4, (6, 1)).astype("int64"))


def _port_convnet_losses(fused, before, feeds, steps=3):
    model = _PortConvnet(fused)
    opt = port_opt.SGD(model.reference_parameters(), 0.5)
    port_io.params_from_jax(before, model=model, optimizer=opt)
    assert opt.learning_rate == np.float32(0.1)
    img, label = (torch.from_numpy(a) for a in feeds)
    return [float(trainer.train_step(model, opt, img, label)[0])
            for _ in range(steps)]


@pytest.mark.parametrize("fused", [False, True])
def test_convnet_losses_match_reference(fused):
    feeds = _convnet_feeds()
    before, want, _ = _run_reference(_ref_convnet, feeds, fused,
                                     ptpu.optimizer.SGD(0.1), 3)
    got = _port_convnet_losses(fused, before, feeds)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[0] > got[-1]


def test_convnet_fused_matches_unfused():
    """The port's two forms from the same weights (the fused scope's
    names mapped onto the unfused ones by position)."""
    feeds = _convnet_feeds()
    before, _, _ = _run_reference(_ref_convnet, feeds, True,
                                  ptpu.optimizer.SGD(0.1), 0)
    fused = _port_convnet_losses(True, before, feeds)
    unfused_names = list(_PortConvnet(False).reference_tensors())
    fused_names = list(_PortConvnet(True).reference_tensors())
    mapped = {u: before[f] for u, f in zip(unfused_names, fused_names)}
    mapped["learning_rate_0"] = before["learning_rate_0"]
    unfused = _port_convnet_losses(False, mapped, feeds)
    np.testing.assert_allclose(fused, unfused, rtol=1e-4)


# -- ResNet for CIFAR, basic blocks --------------------------------------

def test_resnet_cifar8_two_momentum_steps_and_is_test():
    rs = np.random.RandomState(3)
    feeds = (rs.randn(4, 3, 8, 8).astype("float32"),
             rs.randint(0, 10, (4, 1)).astype("int64"))

    def build(img, label):
        return ref_resnet.resnet_cifar10(img, label, depth=8)[0]

    before, want, after = _run_reference(
        build, feeds, True, ptpu.optimizer.Momentum(0.01, 0.9), 2)
    model = _port_build(port_resnet.resnet_cifar10, 8, fused=True,
                        device="cpu")
    opt = port_opt.Momentum(model.reference_parameters(), 0.5, 0.9)
    port_io.params_from_jax(before, model=model, optimizer=opt)
    img, label = (torch.from_numpy(a) for a in feeds)
    got = [float(trainer.train_step(model, opt, img, label)[0])
           for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    state = _port_state(model, opt)
    assert sorted(state) + ["learning_rate_0"] == sorted(after)
    for name, val in state.items():
        ref = after[name]
        np.testing.assert_allclose(val, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)
    # is_test: the trained weights and running statistics, another build
    test_model = _port_build(port_resnet.resnet_cifar10, 8, fused=True,
                             is_test=True, device="cpu")
    with torch.no_grad():
        for name, t in test_model.reference_tensors().items():
            t.copy_(torch.from_numpy(after[name]))
        logits = test_model.logits(img)
    with ptpu.unique_name.guard():
        main, startup = ptpu.Program(), ptpu.Program()
        with ptpu.program_guard(main, startup):
            x = layers.data("img", shape=[3, 8, 8])
            y = layers.data("label", shape=[1], dtype="int64")
            ptpu.config.set_flags(fused_conv_bn=True)
            try:
                ref_logits = ref_resnet.resnet_cifar10(x, y, depth=8,
                                                       is_test=True)[2]
            finally:
                ptpu.config.set_flags(fused_conv_bn=False)
    scope = ptpu.Scope()
    with ptpu.scope_guard(scope):
        exe = ptpu.Executor()
        exe.run(startup)
        for name, val in after.items():
            scope.set_var(name, val)
        want_logits, = exe.run(main, feed={"img": feeds[0],
                                           "label": feeds[1]},
                               fetch_list=[ref_logits])
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4,
                               atol=1e-4 * np.abs(want_logits).max())


# -- full-depth ResNet-50 -------------------------------------------------

RES, BATCH, LR = 64, 4, 1e-3


@pytest.fixture(scope="module")
def resnet50_step():
    """One Momentum step of the fused ResNet-50 from the reference's
    initial weights: on the reference, on the port in float32, and on the
    port in float64. Returns a dict of the three runs."""
    rs = np.random.RandomState(0)
    feeds = (rs.randn(BATCH, 3, RES, RES).astype("float32"),
             rs.randint(0, 1000, (BATCH, 1)).astype("int64"))

    def build(img, label):
        return ref_resnet.resnet_imagenet(img, label, depth=50)[0]

    before, losses, after = _run_reference(
        build, feeds, True, ptpu.optimizer.Momentum(LR, 0.9), 1)
    runs = {"ref": (losses[0], after), "before": before}
    for name, dtype in (("port", torch.float32), ("f64", torch.float64)):
        model = _port_build(port_resnet.resnet_imagenet, 50, fused=True,
                            device="cpu")
        opt = port_opt.Momentum(model.reference_parameters(), 0.5, 0.9)
        port_io.params_from_jax(before, model=model, optimizer=opt)
        model.to(dtype)
        opt = port_opt.Momentum(model.reference_parameters(),
                                opt.learning_rate, 0.9)
        img = torch.from_numpy(feeds[0]).to(dtype)
        loss, _ = trainer.train_step(model, opt, img,
                                     torch.from_numpy(feeds[1]))
        runs[name] = (float(loss), _port_state(model, opt))
    return runs


def test_resnet50_scope_names_and_shapes(resnet50_step):
    before = resnet50_step["before"]
    names = port_resnet.resnet_scope_names(50, fused_conv_bn=True)
    assert (len(names["parameters"]), len(names["running_stats"]),
            len(names["velocities"])) == (161, 106, 161)
    ours = names["parameters"] + names["running_stats"] + names["velocities"]
    assert sorted(ours + ["learning_rate_0"]) == sorted(before)
    state = resnet50_step["port"][1]
    assert sorted(state) == sorted(ours)
    for name in ours:
        assert state[name].shape == before[name].shape, name


def test_resnet50_step_loss(resnet50_step):
    want = resnet50_step["ref"][0]
    assert abs(resnet50_step["port"][0] - want) <= 1e-5 * abs(want)
    assert abs(resnet50_step["f64"][0] - want) <= 1e-5 * abs(want)


def test_resnet50_step_running_stats(resnet50_step):
    ref, port = resnet50_step["ref"][1], resnet50_step["port"][1]
    names = port_resnet.resnet_scope_names(50)["running_stats"]
    errs = {n: _rel(port[n], ref[n]) for n in names}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])


def test_resnet50_step_parameters_and_velocities(resnet50_step):
    ref, port = resnet50_step["ref"][1], resnet50_step["port"][1]
    f64 = resnet50_step["f64"][1]
    names = port_resnet.resnet_scope_names(50)
    errs = {n: _rel(port[n], ref[n])
            for n in names["parameters"] + names["velocities"]}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 5e-2, (worst, errs[worst])
    port_err = np.median([_rel(port[n], f64[n]) for n in names["velocities"]])
    ref_err = np.median([_rel(ref[n], f64[n]) for n in names["velocities"]])
    assert port_err <= 1.5 * ref_err, (port_err, ref_err)
    # the update itself: p_new = p - lr * v with v = g from zero
    before = resnet50_step["before"]
    for n in names["parameters"]:
        v = port[n + "_velocity_acc_0"]
        np.testing.assert_allclose(port[n], before[n] - np.float32(LR) * v,
                                   rtol=1e-6, atol=1e-7, err_msg=n)


def test_resnet50_forward_routes_30_convs_to_b1(monkeypatch):
    """Every 1x1 stride-1 convolution of the fused ResNet-50 goes to the
    B1 wrapper (on the CPU it computes the plain version): 30 per
    forward; the unfused model sends none."""
    calls = []
    real = port_cb.conv_bn_stats_1x1

    def counting(x, w):
        calls.append((x.shape[1], w.shape[0], x.shape[2]))
        return real(x, w)

    monkeypatch.setattr(port_cb, "conv_bn_stats_1x1", counting)
    img = torch.from_numpy(np.random.RandomState(1).randn(
        1, 3, 64, 64).astype(np.float32))
    for fused, want in ((True, 30), (False, 0)):
        calls.clear()
        model = _port_build(port_resnet.resnet_imagenet, 50, fused=fused,
                            device="cpu")
        with torch.no_grad():
            model.logits(img)
        assert len(calls) == want
    model = _port_build(port_resnet.resnet_imagenet, 50, fused=True,
                        device="cpu")
    calls.clear()
    with torch.no_grad():
        model.logits(img)
    shapes = sorted(set((c, o) for c, o, _ in calls))
    assert shapes == sorted([(64, 64), (64, 256), (256, 64), (512, 128),
                             (128, 512), (1024, 256), (256, 1024),
                             (2048, 512), (512, 2048)])


@pytest.mark.parametrize("depth,fused,cifar", [
    (50, False, False), (18, True, False), (101, True, False),
    (20, False, True)])
def test_scope_names_match_reference_program(depth, fused, cifar):
    ptpu.config.set_flags(fused_conv_bn=fused)
    try:
        with ptpu.unique_name.guard():
            main, startup = ptpu.Program(), ptpu.Program()
            with ptpu.program_guard(main, startup):
                img = layers.data("img", shape=[3, 32, 32])
                label = layers.data("label", shape=[1], dtype="int64")
                build = ref_resnet.resnet_cifar10 if cifar \
                    else ref_resnet.resnet_imagenet
                loss = build(img, label, depth=depth)[0]
                ptpu.optimizer.Momentum(0.1, 0.9).minimize(
                    loss, startup_program=startup)
    finally:
        ptpu.config.set_flags(fused_conv_bn=False)
    want = {n: tuple(v.shape) for n, v in main.global_block().vars.items()
            if v.persistable and not n.startswith("learning_rate")}
    names = port_resnet.resnet_scope_names(depth, fused_conv_bn=fused,
                                           class_dim=10 if cifar else 1000,
                                           cifar=cifar)
    ours = names["parameters"] + names["running_stats"] + names["velocities"]
    assert sorted(ours) == sorted(want)
    build = port_resnet.resnet_cifar10 if cifar \
        else port_resnet.resnet_imagenet
    model = _port_build(build, depth, 10 if cifar else 1000, fused=fused,
                        device="meta")
    for name, t in model.reference_tensors().items():
        assert tuple(t.shape) == want[name], name


@pytest.mark.parametrize("fused", [False, True])
def test_recompute_matches_no_recompute(fused):
    """``recompute=True`` runs each residual block under
    torch.utils.checkpoint: the same loss, gradients and running
    statistics as without it (the statistics updated once, not again
    when the block is recomputed for its gradient)."""
    rs = np.random.RandomState(6)
    img = torch.from_numpy(rs.randn(4, 3, 16, 16).astype("float32"))
    label = torch.from_numpy(rs.randint(0, 10, (4, 1)))
    got = []
    for recompute in (False, True):
        model = _port_build(port_resnet.resnet_cifar10, 8, fused=fused,
                            device="cpu", recompute=recompute)
        loss = model(img, label)[0]
        loss.backward()
        got.append((loss.item(), {n: p.grad.clone() for n, p in
                                  model.reference_parameters().items()},
                    {n: t.clone() for n, t in
                     model.reference_tensors().items()}))
    assert got[1][0] == got[0][0]
    for n, g in got[0][1].items():
        torch.testing.assert_close(got[1][1][n], g, rtol=0, atol=0)
    for n, t in got[0][2].items():
        torch.testing.assert_close(got[1][2][n], t, rtol=0, atol=0)
    # the statistics moved once from their initial 0 and 1
    stem = [n for n in got[0][2] if n.endswith(".global_0")][0]
    assert got[1][2][stem].abs().max() > 0


def test_resnet_cifar8_amp_two_momentum_steps():
    """ResNet-8 for CIFAR, unfused, two Momentum steps under amp bf16
    against the reference's program run under the flag: its ``conv2d``
    and the fc's ``mul`` are WHITE ops (bfloat16 products), batch norm
    takes its moments in f32, the loss is f32. Losses to 1e-2 relative
    and every parameter within 2 lr a step (the LM's amp tolerances:
    bf16 products summed in other orders); the port's model reads the
    flag at each forward, so it is built with the flag off."""
    rs = np.random.RandomState(4)
    feeds = (rs.randn(4, 3, 8, 8).astype("float32"),
             rs.randint(0, 10, (4, 1)).astype("int64"))
    lr, steps = 0.01, 2

    def build(img, label):
        return ref_resnet.resnet_cifar10(img, label, depth=8)[0]

    ptpu.config.set_flags(amp="bfloat16")
    try:
        before, want, after = _run_reference(
            build, feeds, False, ptpu.optimizer.Momentum(lr, 0.9), steps)
    finally:
        ptpu.config.set_flags(amp=None)
    model = _port_build(port_resnet.resnet_cifar10, 8, fused=False,
                        device="cpu")
    opt = port_opt.Momentum(model.reference_parameters(), 0.5, 0.9)
    port_io.params_from_jax(before, model=model, optimizer=opt)
    img, label = (torch.from_numpy(a) for a in feeds)
    stem_dtypes = []
    model.stem.register_forward_hook(
        lambda mod, args, out: stem_dtypes.append(out.dtype))
    port_config.set_flags(amp="bfloat16")
    try:
        got, logits_dtypes = [], []
        for _ in range(steps):
            loss, _, logits = model(img, label)
            logits_dtypes.append(logits.dtype)
            opt.zero_grad()
            loss.backward()
            opt.step()
            got.append(float(loss.detach()))
            assert loss.dtype == torch.float32
    finally:
        port_config.set_flags(amp=None)
    np.testing.assert_allclose(got, want, rtol=1e-2)
    # the convolutions ran in bf16 (the stem's conv, then its batch norm
    # in the dtype that flows in); the fc's bf16 product plus its f32
    # bias is f32, as jnp.add gives
    assert stem_dtypes == [torch.bfloat16] * steps
    assert logits_dtypes == [torch.float32] * steps
    state = _port_state(model, opt)
    for name in model.reference_parameters():
        diff = np.abs(state[name] - after[name]).max()
        assert diff <= 2 * lr * steps, (name, diff)
    # with the flag off again the same model computes f32 convolutions
    with torch.no_grad():
        model.logits(img)
    assert stem_dtypes[-1] == torch.float32
