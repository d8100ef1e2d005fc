"""LeNet-5 on MNIST, BASELINE config 1 (``models/lenet.py`` in both
packages; the book test ``tests/test_book_mnist.py``): the program the
port builds serializes as the reference's; the port converges on its own
to the book test's thresholds (the MLP above 0.95 over its last 10 of 60
steps, LeNet-5 above 0.9 over its last 10 of 50); and 5 Adam steps from
a ``paddle_tpu`` checkpoint (``save_persistables`` → ``load_persistables``)
give per-step losses within 1e-5 of the reference's, the parameters and
moments within 1e-5 of their largest magnitude. Synthetic digits (the
book test's) from seeded numpy; the reference convolves in XLA, the port
in torch (TF32 off)."""

import json

import numpy as np
import pytest

import paddle_tpu as ptpu
from paddle_tpu import io as ref_io
from paddle_tpu import layers as ref_layers
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu.models import lenet as ref_lenet
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.models import lenet as port_lenet
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

LOSS_RTOL = 1e-5


def synth_digits(n, rs, img_shape=(1, 28, 28), n_classes=10):
    """The book test's separable digits: a class-dependent blob."""
    y = rs.randint(0, n_classes, size=n)
    x = rs.randn(n, *img_shape).astype("float32") * 0.3
    for i in range(n):
        c = y[i]
        r0, c0 = 2 + (c // 5) * 12, 2 + (c % 5) * 5
        x[i, 0, r0:r0 + 6, c0:c0 + 4] += 2.0
    return x, y.astype("int64").reshape(-1, 1)


def _lenet(pkg, lr=1e-3, train=True):
    """LeNet-5's program: with Adam's update ops, or without them (the
    test program, reading the same parameter names)."""
    fw, L, model, opt = (ptpu, ref_layers, ref_lenet, ptpu.optimizer) \
        if pkg == "ref" else (pc, port_layers, port_lenet, port_opt)
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 1
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        img = L.data("img", shape=[1, 28, 28])
        label = L.data("label", shape=[1], dtype="int64")
        loss, acc, _ = model.lenet5(img, label)
        if train:
            opt.Adam(learning_rate=lr).minimize(loss, startup)
    return main, startup, loss, acc


def _train(main, startup, loss, acc, steps, bs=64):
    exe, scope = pc.Executor(device="cpu"), pc.Scope()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(0)
    accs = []
    for _ in range(steps):
        xb, yb = synth_digits(bs, rs)
        _, av = exe.run(main, feed={"img": xb, "label": yb},
                        fetch_list=[loss, acc], scope=scope)
        accs.append(float(av))
    return accs


@pytest.mark.parametrize("which", [0, 1], ids=["main", "startup"])
def test_lenet_program_is_the_references(which):
    ref = json.dumps(ref_ser.program_to_dict(_lenet("ref")[which]))
    port = json.dumps(port_ser.program_to_dict(_lenet("port")[which]))
    assert port == ref


def test_port_lenet5_converges():
    accs = _train(*_lenet("port"), steps=50)
    assert np.mean(accs[-10:]) > 0.9, accs[-10:]


def test_port_mlp_converges():
    main, startup = pc.Program(), pc.Program()
    with pc.unique_name.guard(), pc.program_guard(main, startup):
        img = port_layers.data("img", shape=[1, 28, 28])
        label = port_layers.data("label", shape=[1], dtype="int64")
        flat = port_layers.reshape(img, [-1, 784])
        h1 = port_layers.fc(flat, 128, act="relu")
        h2 = port_layers.fc(h1, 64, act="relu")
        logits = port_layers.fc(h2, 10)
        loss = port_layers.mean(
            port_layers.softmax_with_cross_entropy(logits, label))
        acc = port_layers.accuracy(port_layers.softmax(logits), label)
        port_opt.Adam(learning_rate=1e-3).minimize(loss, startup)
    accs = _train(main, startup, loss, acc, steps=60)
    assert np.mean(accs[-10:]) > 0.95, accs[-10:]


def test_five_adam_steps_from_a_reference_checkpoint(tmp_path):
    d = str(tmp_path)
    main, startup, loss, _ = _lenet("ref")
    exe = ptpu.Executor()
    rs = np.random.RandomState(7)
    feeds = [dict(zip(("img", "label"), synth_digits(64, rs)))
             for _ in range(5)]
    scope = ptpu.Scope()
    with ptpu.scope_guard(scope):
        exe.run(startup)
        ref_io.save_persistables(exe, d, main_program=main)
        want = [float(exe.run(main, feed=f, fetch_list=[loss])[0])
                for f in feeds]
    pmain, _, ploss, _ = _lenet("port")
    pexe, pscope = pc.Executor(device="cpu"), pc.Scope()
    port_io.load_persistables(pexe, d, main_program=pmain, scope=pscope)
    got = [float(pexe.run(pmain, feed=f, fetch_list=[ploss],
                          scope=pscope)[0]) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for v in pmain.global_block().vars.values():
        if not v.persistable or v.name.startswith("@"):
            continue
        w = np.asarray(scope.find_var(v.name))
        g = pscope.find_var(v.name).numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= LOSS_RTOL * scale, v.name


def test_test_program_matches_training_forward():
    """The test program (no update ops: on the card, the one a server
    captures as a CUDA graph) gives the training program's loss at the
    same weights, bitwise and repeatably."""
    main, startup, loss, _ = _lenet("port")
    test, _, tloss, _ = _lenet("port", train=False)
    exe, scope = pc.Executor(device="cpu"), pc.Scope()
    exe.run(startup, scope=scope)
    xb, yb = synth_digits(16, np.random.RandomState(2))
    feed = {"img": xb, "label": yb}
    t1 = exe.run(test, feed=feed, fetch_list=[tloss], scope=scope)[0]
    t2 = exe.run(test, feed=feed, fetch_list=[tloss], scope=scope)[0]
    tr = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(t1, tr)
