"""The stacked-LSTM sentiment classifier, BASELINE config 3
(``models/lstm_sentiment.py`` in both packages) at a small width: the
port builds the reference's program byte for byte; 3 Adam steps from the
reference's startup weights give its losses within 1e-4 and its
parameters within 2 lr a step; and the port learns the reference's
synthetic sentiment task (``tests/test_models.py``) above 0.9 accuracy
over its last 10 of 60 steps, as the reference does. Feeds from seeded
numpy."""

import json

import numpy as np
import pytest

import paddle_tpu as ptpu
from paddle_tpu import layers as ref_layers
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu.models import lstm_sentiment as ref_model
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.models import lstm_sentiment as port_model
from test_torch_ops_cases import one_thread  # noqa: F401

VOCAB, T = 50, 12
LR = 2e-3
STEPS = 3
LOSS_RTOL = 1e-4


pytestmark = pytest.mark.usefixtures("one_thread")


def synth_sentiment(n, t, vocab, rs):
    """The reference's task: positive sequences hold a run of token 5."""
    y = rs.randint(0, 2, n)
    x = rs.randint(10, vocab, (n, t))
    length = rs.randint(t // 2, t + 1, n)
    for i in range(n):
        if y[i]:
            pos = rs.randint(0, length[i] - 1)
            x[i, pos:pos + 2] = 5
        x[i, length[i]:] = 0
    return (x.astype("int64"), length.astype("int64"),
            y.astype("int64").reshape(-1, 1))


def _program(pkg, stacked_num=2):
    fw, L, model, opt = (ptpu, ref_layers, ref_model, ptpu.optimizer) \
        if pkg == "ref" else (pc, port_layers, port_model, port_opt)
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 5
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        data = L.data("words", shape=[T], dtype="int64")
        length = L.data("length", shape=[], dtype="int64")
        label = L.data("label", shape=[1], dtype="int64")
        loss, acc, _ = model.stacked_lstm_net(
            data, length, label, dict_dim=VOCAB, emb_dim=16, hid_dim=32,
            stacked_num=stacked_num)
        opt.Adam(learning_rate=LR).minimize(loss, startup)
    return main, startup, loss, acc


def _feeds(n, seed):
    rs = np.random.RandomState(seed)
    return [dict(zip(("words", "length", "label"),
                     synth_sentiment(8, T, VOCAB, rs))) for _ in range(n)]


@pytest.mark.parametrize("stacked_num", [2, 3])
def test_program_is_the_references(stacked_num):
    for which in (0, 1):
        ref = json.dumps(ref_ser.program_to_dict(
            _program("ref", stacked_num)[which]))
        port = json.dumps(port_ser.program_to_dict(
            _program("port", stacked_num)[which]))
        assert port == ref, which


@pytest.mark.parametrize("stacked_num", [2, 3])
def test_three_adam_steps_match_the_reference(stacked_num):
    main, startup, loss, _ = _program("ref", stacked_num)
    exe, scope = ptpu.Executor(), ptpu.Scope()
    exe.run(startup, scope=scope)
    init = {n: np.array(scope.find_var(n)) for n in scope.var_names()}
    feeds = _feeds(STEPS, 3)
    want = [float(exe.run(main, feed=f, fetch_list=[loss],
                          scope=scope)[0]) for f in feeds]
    pmain, _, ploss, _ = _program("port", stacked_num)
    pexe = pc.Executor(device="cpu")
    pscope = port_io.scope_from_jax(init, device="cpu")
    got = [float(pexe.run(pmain, feed=f, fetch_list=[ploss],
                          scope=pscope)[0]) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for name in scope.var_names():
        w = np.asarray(scope.find_var(name))
        if name.startswith("@") or not np.issubdtype(w.dtype, np.floating):
            continue
        g = pscope.find_var(name).numpy()
        assert np.abs(g - w).max() <= 2 * LR * STEPS, name


def test_port_learns_the_synthetic_task():
    main, startup, loss, acc = _program("port")
    exe, scope = pc.Executor(device="cpu"), pc.Scope()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(0)
    accs = []
    for _ in range(60):
        x, length, y = synth_sentiment(32, T, VOCAB, rs)
        _, a = exe.run(main, feed={"words": x, "length": length,
                                   "label": y},
                       fetch_list=[loss, acc], scope=scope)
        accs.append(float(a))
    assert np.mean(accs[-10:]) > 0.9, accs[-10:]
