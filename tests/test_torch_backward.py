"""The port's IR-level autodiff (``paddle_tpu_torch/core/backward.py``
and the executor's ``vjp_grad`` route) against the reference's.

* Counterparts of the five tests of ``tests/test_backward.py``
  (accumulation over a shared variable, stop_gradient, an unused
  parameter, a chain of ops that trains, ``parameter_list``), with the
  slice's ops in place of ``elementwise_mul``/``reduce_sum``; each
  program also runs in the reference (serialized by the port, loaded
  there) and the gradients agree.
* For every differentiable op of the slice, a one-op program with the
  loss ``mean(flatten(out) @ R)`` (R fixed random weights, so no output
  sums to a constant): the port's gradients (autograd through the op's
  own compute, float32) against central differences of the same compute
  in float64 (``tests/op_test.py``'s check, with float64 differences in
  place of float32 ones), and against the reference's ``jax.vjp``
  (float32, its program loaded from the port's JSON) within 1e-5 of each
  gradient's norm.
"""

import json

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as ptpu
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.core.backward import append_backward
from paddle_tpu_torch.core.executor import _TraceState
from paddle_tpu_torch.initializer import Constant
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CPU = dict(device="cpu")


def _ref_run(main, startup, feed, fetch):
    """Run the port-built ``main`` (after ``startup``) in the reference,
    loaded from the port's JSON."""
    load = lambda p: ref_ser.program_from_dict(  # noqa: E731
        json.loads(json.dumps(port_ser.program_to_dict(p))))
    exe = ptpu.Executor()
    with ptpu.scope_guard(ptpu.Scope()):
        if startup is not None:
            exe.run(load(startup))
        return exe.run(load(main), feed=feed, fetch_list=fetch)


def _port_run(main, startup, feed, fetch):
    exe = pc.Executor(**CPU)
    scope = pc.Scope()
    if startup is not None:
        exe.run(startup, scope=scope)
    return exe.run(main, feed=feed, fetch_list=fetch, scope=scope)


def _param(main, startup, name, shape, value):
    w = main.global_block().create_parameter(
        name=name, shape=shape, dtype="float32",
        initializer=Constant(value))
    sblock = startup.global_block()
    svar = sblock.create_var(name=name, shape=shape, dtype="float32",
                             persistable=True)
    Constant(value)(svar, sblock)
    return w


def _both(main, startup, feed, fetch):
    fetch = [v if isinstance(v, str) else v.name for v in fetch]
    ours = _port_run(main, startup, feed, fetch)
    theirs = _ref_run(main, startup, feed, fetch)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    return ours


def test_grad_accumulation_shared_var():
    """s = x1 @ w + x2 @ w: the gradient of w sums both paths (a ``sum``
    op folds the two contributions)."""
    main, startup = pc.Program(), pc.Program()
    with pc.program_guard(main, startup):
        x1 = layers.data("x1", shape=[3])
        x2 = layers.data("x2", shape=[3])
        w = _param(main, startup, "w", [3, 2], 2.0)
        a = layers.nn._single(layers.nn.LayerHelper("mul"), "mul",
                              {"X": [x1.name], "Y": [w.name]})
        b = layers.nn._single(layers.nn.LayerHelper("mul"), "mul",
                              {"X": [x2.name], "Y": [w.name]})
        loss = layers.mean(layers.elementwise_add(a, b))
        p_g = append_backward(loss)
    assert "sum" in [op.type for op in main.global_block().ops]
    x1v = np.array([[1., 2., 3.]], dtype="float32")
    x2v = np.array([[10., 20., 30.]], dtype="float32")
    g, = _both(main, startup, {"x1": x1v, "x2": x2v}, [p_g[0][1]])
    np.testing.assert_allclose(
        g, np.repeat((x1v + x2v).reshape(3, 1), 2, axis=1) / 2, rtol=1e-6)


def test_stop_gradient_blocks_path():
    main, startup = pc.Program(), pc.Program()
    with pc.program_guard(main, startup):
        x = layers.data("x", shape=[3])
        w = _param(main, startup, "w", [3], 2.0)
        a = layers.elementwise_add(x, w, axis=1)
        a.stop_gradient = True
        b = layers.elementwise_add(x, w, axis=1)
        loss = layers.mean(layers.elementwise_add(a, layers.relu(b)))
        p_g = append_backward(loss)
    xv = np.array([[1., 2., 3.], [-9., 2., 0.5]], dtype="float32")
    g, = _both(main, startup, {"x": xv}, [p_g[0][1]])
    # only path b contributes: d mean / d w_j = sum_i [x_ij + 2 > 0] / 6
    np.testing.assert_allclose(g, ((xv + 2) > 0).sum(0) / 6.0, rtol=1e-6)


def test_unused_param_gets_zero_grad():
    main, startup = pc.Program(), pc.Program()
    with pc.program_guard(main, startup):
        x = layers.data("x", shape=[3])
        w = _param(main, startup, "w", [3], 2.0)
        _param(main, startup, "unused", [5], 1.0)
        loss = layers.mean(layers.elementwise_add(x, w, axis=1))
        p_g = append_backward(loss)
    grads = {p.name: g for p, g in p_g}
    xv = np.ones((1, 3), dtype="float32")
    gw, gu = _both(main, startup, {"x": xv},
                   [grads["w"], grads["unused"]])
    np.testing.assert_allclose(gw, np.full(3, 1 / 3.0), rtol=1e-6)
    np.testing.assert_allclose(gu, np.zeros(5))


def test_chain_through_many_ops():
    """fc -> relu -> fc -> softmax+xent; grads flow end to end and SGD
    training reduces the loss, step for step as the reference's."""
    main, startup = pc.Program(), pc.Program()
    main.random_seed = startup.random_seed = 3
    with pc.unique_name.guard(), pc.program_guard(main, startup):
        x = layers.data("x", shape=[8])
        y = layers.data("y", shape=[1], dtype="int64")
        h = layers.fc(x, 16, act="relu")
        logits = layers.fc(h, 4)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
        port_opt.SGD(learning_rate=0.5).minimize(loss,
                                                 startup_program=startup)
    rs = np.random.RandomState(0)
    xv = rs.randn(64, 8).astype("float32")
    yv = (xv[:, 0] > 0).astype("int64").reshape(-1, 1)
    exe = pc.Executor(**CPU)
    scope = pc.Scope()
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed={"x": xv, "y": yv},
                            fetch_list=[loss], scope=scope)[0])
              for _ in range(60)]
    assert losses[-1] < 0.5 * losses[0]
    # the reference, from the same program, draws the same initial
    # weights and takes the same steps
    ref_main = ref_ser.program_from_dict(port_ser.program_to_dict(main))
    ref_start = ref_ser.program_from_dict(port_ser.program_to_dict(startup))
    rexe = ptpu.Executor()
    with ptpu.scope_guard(ptpu.Scope()):
        rexe.run(ref_start)
        ref = [float(rexe.run(ref_main, feed={"x": xv, "y": yv},
                              fetch_list=[loss.name])[0])
               for _ in range(5)]
    np.testing.assert_allclose(losses[:5], ref, rtol=1e-5)


def test_parameter_list_restricts():
    main, startup = pc.Program(), pc.Program()
    with pc.program_guard(main, startup):
        x = layers.data("x", shape=[3])
        w1 = _param(main, startup, "w1", [3], 2.0)
        w2 = _param(main, startup, "w2", [3], 3.0)
        s = layers.elementwise_add(
            layers.elementwise_add(x, w1, axis=1),
            layers.elementwise_add(x, w2, axis=1))
        p_g = append_backward(layers.mean(s), parameter_list=["w1"])
    assert [p.name for p, _ in p_g] == ["w1"]


F = "float32"
# name -> (op, {slot: array}, attrs, {slot: n outputs}, output the loss
# reads, slots differentiated)
_rs = np.random.RandomState(7)


def _a(*shape, away=0.0):
    x = _rs.standard_normal(shape).astype(np.float32)
    return np.where(np.abs(x) < away, np.sign(x) * away + x, x) \
        .astype(np.float32)


BN_OUTS = {"Y": 1, "MeanOut": 1, "VarianceOut": 1, "SavedMean": 1,
           "SavedVariance": 1}
GRAD_CASES = {
    "conv2d": ("conv2d", {"Input": _a(2, 3, 5, 5), "Filter": _a(4, 3, 3, 3)},
               {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
                "groups": 1}, {"Output": 1}, "Output", ("Input", "Filter")),
    "conv2d strided dilated": (
        "conv2d", {"Input": _a(2, 2, 7, 6), "Filter": _a(3, 2, 2, 3)},
        {"strides": [2, 1], "paddings": [1, 0], "dilations": [2, 1],
         "groups": 1}, {"Output": 1}, "Output", ("Input", "Filter")),
    "pool2d max": ("pool2d", {"X": _a(2, 3, 6, 6)},
                   {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1],
                    "pooling_type": "max"}, {"Out": 1}, "Out", ("X",)),
    "pool2d avg": ("pool2d", {"X": _a(2, 3, 6, 6)},
                   {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1],
                    "pooling_type": "avg", "exclusive": True}, {"Out": 1},
                   "Out", ("X",)),
    "pool2d global": ("pool2d", {"X": _a(2, 3, 4, 4)},
                      {"ksize": [4, 4], "pooling_type": "avg",
                       "global_pooling": True}, {"Out": 1}, "Out", ("X",)),
    "batch_norm": ("batch_norm", {"X": _a(4, 3, 3, 3), "Scale": _a(3),
                                  "Bias": _a(3), "Mean": _a(3),
                                  "Variance": np.abs(_a(3)) + 0.5},
                   {"momentum": 0.9, "epsilon": 1e-5}, BN_OUTS, "Y",
                   ("X", "Scale", "Bias")),
    "conv2d_bn 1x1": ("conv2d_bn", {"Input": _a(4, 3, 4, 4),
                                    "Filter": _a(5, 3, 1, 1), "Scale": _a(5),
                                    "Bias": _a(5), "Mean": _a(5),
                                    "Variance": np.abs(_a(5)) + 0.5},
                      {"strides": [1, 1], "paddings": [0, 0]}, BN_OUTS, "Y",
                      ("Input", "Filter", "Scale", "Bias")),
    "conv2d_bn 3x3": ("conv2d_bn", {"Input": _a(3, 2, 5, 5),
                                    "Filter": _a(4, 2, 3, 3), "Scale": _a(4),
                                    "Bias": _a(4), "Mean": _a(4),
                                    "Variance": np.abs(_a(4)) + 0.5},
                      {"strides": [2, 2], "paddings": [1, 1]}, BN_OUTS, "Y",
                      ("Input", "Filter", "Scale", "Bias")),
    "mul": ("mul", {"X": _a(3, 2, 2), "Y": _a(4, 5)},
            {"x_num_col_dims": 1, "y_num_col_dims": 1}, {"Out": 1}, "Out",
            ("X", "Y")),
    "elementwise_add": ("elementwise_add", {"X": _a(2, 3, 4), "Y": _a(3)},
                        {"axis": 1}, {"Out": 1}, "Out", ("X", "Y")),
    "relu": ("relu", {"X": _a(3, 4, away=0.05)}, {}, {"Out": 1}, "Out",
             ("X",)),
    "softmax": ("softmax", {"X": _a(3, 5)}, {}, {"Out": 1}, "Out", ("X",)),
    "softmax_with_cross_entropy": (
        "softmax_with_cross_entropy",
        {"Logits": _a(4, 5), "Label": np.array([[0], [3], [4], [1]])},
        {"soft_label": False}, {"Softmax": 1, "Loss": 1}, "Loss",
        ("Logits",)),
    "mean": ("mean", {"X": _a(3, 4)}, {}, {"Out": 1}, "Out", ("X",)),
    "sum": ("sum", {"X": [_a(3, 4), _a(3, 4), _a(3, 4)]}, {}, {"Out": 1},
            "Out", ("X",)),
    "reshape": ("reshape", {"X": _a(2, 3, 2)}, {"shape": [-1, 6]},
                {"Out": 1}, "Out", ("X",)),
    "top_k": ("top_k", {"X": _a(3, 6)}, {"k": 2}, {"Out": 1, "Indices": 1},
              "Out", ("X",)),
}


def _one_op(case):
    """(program, feed, [(slot, i, grad var name)], the op, R) of a
    one-op case: inputs are fed (the differentiated ones need grad), the
    loss is mean(reshape(out, [1, -1]) @ R)."""
    op_type, inputs, attrs, outs, loss_slot, diff = GRAD_CASES[case]
    main = pc.Program()
    feed, names = {}, {}
    with pc.program_guard(main, pc.Program()):
        block = main.global_block()
        for slot, arrs in inputs.items():
            arrs = arrs if isinstance(arrs, list) else [arrs]
            names[slot] = []
            for i, arr in enumerate(arrs):
                name = "in_%s_%d" % (slot, i)
                block.create_var(name=name, shape=arr.shape, dtype=arr.dtype,
                                 stop_gradient=slot not in diff)
                feed[name] = arr
                names[slot].append(name)
        out_names = {s: ["out_%s_%d" % (s, i) for i in range(n)]
                     for s, n in outs.items()}
        for ns in out_names.values():
            for n in ns:
                block.create_var(name=n)
        op = block.append_op(op_type, inputs=names, outputs=out_names,
                             attrs=attrs)
        out = block.var(out_names[loss_slot][0])
        k = int(np.prod(out.shape)) if out.shape else 1
        r = np.random.RandomState(3).standard_normal((k, 1)) \
            .astype(np.float32)
        rv = block.create_var(name="R", shape=[k, 1], dtype=F,
                              stop_gradient=True)
        feed["R"] = r
        flat = layers.reshape(out, [1, k])
        prod = layers.nn._single(layers.nn.LayerHelper("mul"), "mul",
                                 {"X": [flat.name], "Y": [rv.name]})
        loss = layers.mean(prod)
        wrt = [n for s in diff for n in names[s]]
        p_g = append_backward(loss, parameter_list=wrt)
    grads = {p.name: g.name for p, g in p_g}
    return main, feed, [(n, grads[n]) for n in wrt], op, r, loss_slot


def _loss64(op, feed, r, loss_slot):
    """The case's loss by the op's own compute, in float64."""
    values = {}
    for slot, names in op.inputs.items():
        values[slot] = [torch.from_numpy(np.asarray(feed[n], np.float64)
                                         if feed[n].dtype.kind == "f"
                                         else feed[n]) for n in names]
    ctx = registry.ExecContext(op, values, block=op.block,
                               trace=_TraceState(device=torch.device("cpu")))
    with torch.no_grad():
        res = registry.normalize_outputs(
            op, registry.get_op_def(op.type).compute(ctx))
    out = res[loss_slot][0].double().reshape(1, -1)
    return float((out @ torch.from_numpy(r.astype(np.float64))).mean())


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_gradient_check(case):
    main, feed, wrt, op, r, loss_slot = _one_op(case)
    got = _port_run(main, None, feed, [g for _, g in wrt])
    theirs = _ref_run(main, None, feed, [g for _, g in wrt])
    for (name, _), g, want in zip(wrt, got, theirs):
        scale = max(float(np.linalg.norm(want)), 1e-30)
        assert float(np.linalg.norm(g - want)) <= 1e-5 * scale, (case, name)
        # central differences of the same compute in float64
        x = np.asarray(feed[name], np.float64)
        num = np.zeros_like(x)
        h = 1e-6
        for idx in np.ndindex(x.shape):
            for sign in (1, -1):
                xp = x.copy()
                xp[idx] += sign * h
                num[idx] += sign * _loss64(op, dict(feed, **{name: xp}), r,
                                           loss_slot)
        num /= 2 * h
        np.testing.assert_allclose(g, num, rtol=1e-3,
                                   atol=1e-4 * np.abs(num).max(),
                                   err_msg="%s %s" % (case, name))


def test_recompute_block_gradient_equals_plain_and_reference():
    """A conv + batch norm + relu group under ``layers.recompute``: its
    gradients equal the same group without it (the sub-block runs again
    under ``torch.utils.checkpoint``), and the reference's; its running
    statistics leave the block once."""
    feed = {"x": _a(4, 3, 5, 5)}
    got = {}
    for recompute in (False, True):
        main, startup = pc.Program(), pc.Program()
        with pc.unique_name.guard(), pc.program_guard(main, startup):
            x = layers.data("x", shape=[3, 5, 5])
            x.stop_gradient = False

            def group():
                c = layers.conv2d(x, 4, 3, padding=1, bias_attr=False)
                return layers.batch_norm(c, act="relu")
            y = layers.recompute(group) if recompute else group()
            loss = layers.mean(layers.fc(layers.reshape(y, [-1, 100]), 3))
            p_g = append_backward(loss, parameter_list=[
                "x"] + [p.name for p in main.all_parameters()])
        fetch = [g.name for _, g in p_g] + ["batch_norm_0.global_0"]
        got[recompute] = _port_run(main, startup, feed, fetch)
        if recompute:
            assert main.global_block().ops[0].type == "recompute_block"
            theirs = _ref_run(main, startup, feed, fetch)
    for a, b, c in zip(got[False], got[True], theirs):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
        assert np.linalg.norm(b - c) <= 1e-5 * max(np.linalg.norm(c), 1e-30)
    # one update of the running mean from 0: 0.1 of the batch mean
    assert np.abs(got[True][-1]).max() > 0


def test_reference_vjp_is_what_the_tests_compare_against():
    """The reference's grads come from jax.vjp of its compute: a direct
    check on one case, so the comparisons above are against autodiff,
    not against the port's own numbers."""
    main, feed, wrt, op, r, _ = _one_op("softmax")
    theirs, = _ref_run(main, None, feed, [wrt[0][1]])
    x = feed[wrt[0][0]]
    _, vjp = jax.vjp(lambda v: jax.nn.softmax(v, axis=-1), x)
    cot = (r.reshape(x.shape) / 1.0).astype(np.float32)
    np.testing.assert_allclose(theirs, vjp(cot)[0], rtol=1e-5, atol=1e-7)
