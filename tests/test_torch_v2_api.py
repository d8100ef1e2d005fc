"""The v2 API surface of the port (``paddle_tpu_torch.v2``) against the
reference's (``paddle_tpu.v2``): the three scripts of
``tests/test_v2_api.py`` — the book's recognize_digits MLP, the tar
checkpoint idiom and a sequence classifier — written once and run in
both packages from the same starting tar.

Each script starts in both packages (``SGD.test`` over the first batch
runs each one's startup); the reference's values then cross into the
port through ``Parameters.to_tar`` / ``init_from_tar``, and the port's
``to_tar`` of them is byte-identical to the reference's. Tolerances:
every step's cost within rtol 1e-4 of the reference's (tens of steps of
f32 rounding apart), test costs within rtol 1e-4, ``infer``'s
probabilities within atol 1e-5; parameter names equal.
"""

import io

import numpy as np
import pytest

import paddle_tpu as ptpu
import paddle_tpu.v2 as ref_v2
import paddle_tpu_torch.v2 as port_v2
from paddle_tpu_torch import core as pc
from paddle_tpu_torch.core import framework as port_framework
from paddle_tpu_torch.core import scope as port_scope
from paddle_tpu_torch.v2 import place as port_place
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

COST_RTOL = 1e-4
PROB_ATOL = 1e-5
# each package's v2 surface, and the name guard its builds run under (the
# same names in both: unique-name counters start at 0)
PACKAGES = (("ref", ref_v2, ptpu.unique_name.guard),
            ("port", port_v2, pc.unique_name.guard))


@pytest.fixture(autouse=True)
def _port_defaults():
    """Fresh default programs and scope of the port for each test (as
    ``conftest.py`` gives the reference's), and the v2 device on the CPU;
    the recorded device is put back after."""
    prev_main = port_framework.switch_main_program(pc.Program())
    prev_startup = port_framework.switch_startup_program(pc.Program())
    prev_scope = port_scope._global_scope
    prev_device = port_place._recorded[0]
    port_scope._global_scope = pc.Scope()
    port_v2.init(use_gpu=False, trainer_count=1)
    yield
    port_framework.switch_main_program(prev_main)
    port_framework.switch_startup_program(prev_startup)
    port_scope._global_scope = prev_scope
    port_place._recorded[0] = prev_device


def _digits_reader(n, seed=0):
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(n):
            label = int(rs.randint(0, 10))
            im = rs.rand(64).astype("float32") * 0.1
            im[label * 6:(label * 6) + 6] += 1.0  # separable pattern
            yield im, label
    return reader


def _mlp(paddle, hidden):
    images = paddle.layer.data("pixel", paddle.data_type.dense_vector(64))
    label = paddle.layer.data("label", paddle.data_type.integer_value(10))
    h = paddle.layer.fc(images, size=hidden,
                        act=paddle.activation.Relu())
    predict = paddle.layer.fc(h, size=10, act=paddle.activation.Softmax())
    return predict, paddle.layer.classification_cost(input=predict,
                                                     label=label)


def _start(paddle, cost, optimizer, first, feeding, tar=None):
    """Parameters and SGD of ``cost``, started (``SGD.test`` over the
    batch ``first`` runs the startup), then loaded from ``tar`` when
    given. Returns (parameters, trainer, the tar of the start)."""
    params = paddle.parameters.create(cost)
    trainer = paddle.trainer.SGD(cost=cost, parameters=params,
                                 update_equation=optimizer)
    trainer.test(lambda: iter([first]), feeding=feeding)
    if tar is not None:
        params.init_from_tar(io.BytesIO(tar))
    out = io.BytesIO()
    params.to_tar(out)
    return params, trainer, out.getvalue()


def _costs(paddle, trainer, reader, passes, feeding, saves=None):
    costs = []

    def handler(event):
        if isinstance(event, paddle.event.EndIteration):
            costs.append(event.cost)
        if saves is not None and isinstance(event, paddle.event.EndPass):
            buf = io.BytesIO()
            trainer.save_parameter_to_tar(buf)
            saves.append(buf.getvalue())
    trainer.train(reader, num_passes=passes, event_handler=handler,
                  feeding=feeding)
    return costs


def test_v2_mlp_trains_tests_and_infers_as_reference():
    feeding = {"pixel": 0, "label": 1}
    train = ref_v2.batch(_digits_reader(512), 32)
    held = ref_v2.batch(_digits_reader(128, seed=9), 32)
    samples = list(_digits_reader(16, seed=3)())
    first = next(iter(train()))
    out = {}
    tar = None
    for name, paddle, guard in PACKAGES:
        with guard():
            predict, cost = _mlp(paddle, 32)
            params, trainer, start = _start(
                paddle, cost, paddle.optimizer.Momentum(learning_rate=0.1,
                                                        momentum=0.9),
                first, feeding, tar)
        tar = tar or start
        assert start == tar
        costs = _costs(paddle, trainer, train, 3, feeding)
        result = trainer.test(held, feeding=feeding)
        probs = paddle.infer(output_layer=predict, parameters=params,
                             input=samples, feeding=feeding)
        out[name] = (params.names(), costs, result.cost, probs,
                     params[params.names()[0]])
    (rn, rc, rt, rp, rw), (pn, pcs, pt, pp, pw) = out["ref"], out["port"]
    assert pn == rn
    np.testing.assert_allclose(pcs, rc, rtol=COST_RTOL)
    assert pcs[-1] < 0.5 * pcs[0]
    np.testing.assert_allclose(pt, rt, rtol=COST_RTOL)
    assert pp.shape == (16, 10)
    np.testing.assert_allclose(pp, rp, atol=PROB_ATOL)
    truth = np.array([s[1] for s in samples])
    assert (pp.argmax(1) == truth).mean() > 0.8
    assert isinstance(pw, np.ndarray) and np.abs(pw).max() > 0
    np.testing.assert_allclose(pw, rw, rtol=COST_RTOL, atol=1e-6)


def test_v2_parameters_tar_roundtrip_as_reference():
    """The tar idiom in both packages (reference parameters.py:328
    to_tar, :358 from_tar, :387 init_from_tar; the book's EndPass save):
    saves every pass, a detached ``from_tar``, a perturbed scope restored,
    ``exclude_params``; and the tars byte-identical both ways for equal
    values."""
    feeding = {"pixel": 0, "label": 1}
    train = ref_v2.batch(_digits_reader(128), 32)
    samples = list(_digits_reader(8, seed=5)())
    first = next(iter(train()))
    out, tar = {}, None
    for name, paddle, guard in PACKAGES:
        with guard():
            predict, cost = _mlp(paddle, 16)
            params, trainer, start = _start(
                paddle, cost, paddle.optimizer.Momentum(learning_rate=0.1),
                first, feeding, tar)
        tar = tar or start
        saves = []
        costs = _costs(paddle, trainer, train, 2, feeding, saves)
        assert len(saves) == 2

        def infer():
            return paddle.infer(output_layer=predict, parameters=params,
                                input=samples, feeding=feeding)
        before = infer()
        restored = paddle.parameters.Parameters.from_tar(
            io.BytesIO(saves[-1]))
        assert sorted(restored.names()) == sorted(params.names())
        for nm in params.names():
            np.testing.assert_array_equal(restored.get(nm), params.get(nm))
            assert restored.get(nm).dtype == params.get(nm).dtype
        for nm in params.names():
            params.set(nm, params.get(nm) + 1.5)
        perturbed = infer()
        assert np.abs(perturbed - before).max() > 1e-3
        params.init_from_tar(io.BytesIO(saves[-1]))
        np.testing.assert_allclose(infer(), before, rtol=1e-6)
        skip = params.names()[0]
        params.set(skip, params.get(skip) + 2.0)
        params.init_from_tar(io.BytesIO(saves[-1]), exclude_params=[skip])
        assert np.abs(params.get(skip) - restored.get(skip)).max() > 1.0
        out[name] = (params, costs, saves, before)
    (rparams, rc, rsaves, rb), (pparams, pcs, psaves, pb) = \
        out["ref"], out["port"]
    np.testing.assert_allclose(pcs, rc, rtol=COST_RTOL)
    np.testing.assert_allclose(pb, rb, atol=PROB_ATOL)
    # equal values make equal bytes, both ways: the reference's last save
    # through the port, and the port's through the reference
    pparams.init_from_tar(io.BytesIO(rsaves[-1]))
    buf = io.BytesIO()
    pparams.to_tar(buf)
    assert buf.getvalue() == rsaves[-1]
    rparams.init_from_tar(io.BytesIO(psaves[-1]))
    buf = io.BytesIO()
    rparams.to_tar(buf)
    assert buf.getvalue() == psaves[-1]


def test_v2_sequence_classifier_as_reference():
    def reader():
        rs = np.random.RandomState(1)
        for _ in range(256):
            lab = int(rs.randint(0, 2))
            ln = int(rs.randint(5, 30))
            ids = rs.randint(10, 100, ln)
            if lab:
                ids[: max(2, ln // 3)] = 7
            yield ids.astype("int64").tolist(), lab
    feeding = {"words": 0, "lbl": 1}
    train = ref_v2.batch(reader, 16)
    first = next(iter(train()))
    out, tar = {}, None
    for name, paddle, guard in PACKAGES:
        with guard():
            words = paddle.layer.data(
                "words", paddle.data_type.integer_value_sequence(100))
            label = paddle.layer.data("lbl",
                                      paddle.data_type.integer_value(2))
            pooled = paddle.layer.pooling(
                paddle.layer.embedding(words, size=16),
                pooling_type=paddle.pooling.Avg())
            predict = paddle.layer.fc(pooled, size=2,
                                      act=paddle.activation.Softmax())
            cost = paddle.layer.classification_cost(input=predict,
                                                    label=label)
            params, trainer, start = _start(
                paddle, cost, paddle.optimizer.Adam(learning_rate=5e-3),
                first, feeding, tar)
        tar = tar or start
        assert start == tar
        out[name] = (params.names(), _costs(paddle, trainer, train, 6,
                                            feeding))
    assert out["port"][0] == out["ref"][0]
    got, want = out["port"][1], out["ref"][1]
    np.testing.assert_allclose(got, want, rtol=COST_RTOL)
    assert np.mean(got[-8:]) < 0.7 * np.mean(got[:8])


def test_v2_surface_equals_reference():
    assert port_v2.__all__ == ref_v2.__all__
    for name in port_v2.__all__:
        assert hasattr(port_v2, name), name
    assert port_v2.networks.__name__ == "paddle_tpu_torch.nets"
    assert port_v2.attr.__name__ == "ParamAttr"
    assert port_v2.batch is port_v2.reader.batch
    for name in ("Momentum", "Adam", "AdaGrad", "RMSProp", "AdaDelta"):
        ref_opt = getattr(ref_v2.optimizer, name)(regularization_rate=0.01)
        port_opt = getattr(port_v2.optimizer, name)(regularization_rate=0.01)
        assert type(port_opt).__name__ == type(ref_opt).__name__
        assert type(port_opt.regularization).__name__ == \
            type(ref_opt.regularization).__name__
    assert port_v2.optimizer.Adam().regularization is None


def test_init_records_the_device():
    import torch
    assert port_v2.init(device="cpu") == torch.device("cpu")
    assert port_v2.init(use_gpu=False, trainer_count=4) == \
        torch.device("cpu")
    assert port_place.current() == torch.device("cpu")
    assert port_place.current("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            port_v2.init()
        with pytest.raises(RuntimeError):
            port_v2.init(use_gpu=True)


def test_parameters_get_copies_and_set_writes_in_place():
    """``get`` gives a host numpy copy of the scope's tensor; ``set``
    writes into that tensor in place, in its dtype, and a parameter the
    scope does not hold yet lands on the handle's device."""
    import torch
    with pc.unique_name.guard():
        predict, cost = _mlp(port_v2, 8)
        params = port_v2.parameters.create(cost)
        trainer = port_v2.trainer.SGD(
            cost=cost, parameters=params,
            update_equation=port_v2.optimizer.Momentum(learning_rate=0.1))
    first = next(iter(ref_v2.batch(_digits_reader(32), 32)()))
    trainer.test(lambda: iter([first]), feeding={"pixel": 0, "label": 1})
    name = params.names()[0]
    tensor = port_scope.global_scope().find_var(name)
    got = params.get(name)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    got += 1.0                          # a copy: the scope is untouched
    assert not np.array_equal(got, params.get(name))
    value = np.full(tensor.shape, 0.25, np.float64)
    params.set(name, value)
    assert port_scope.global_scope().find_var(name) is tensor
    assert tensor.dtype == torch.float32
    np.testing.assert_array_equal(params.get(name), value.astype(np.float32))
    port_scope.global_scope().erase(name)
    params.set(name, value)
    placed = port_scope.global_scope().find_var(name)
    assert placed.device == torch.device("cpu")
    assert placed.dtype == torch.float64
