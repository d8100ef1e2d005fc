"""Program serialization across the two packages
(``paddle_tpu_torch/core/serialization.py`` against
``paddle_tpu/core/serialization.py``), and the port's front end against
the reference's.

ResNet-8 for CIFAR, plain, fused (``conv2d_bn``) and with each residual
block recomputed (``recompute_block`` over a sub-block), each after
``Momentum.minimize`` (forward, ``vjp_grad``/``sum``/``fill_like``
backward and ``momentum`` updates), and its startup program: the JSON of
a program serialized by either package loads in the other and serializes
to the same bytes; and the port's front end, given the reference's
calls, builds the reference's program byte for byte."""

import json

import numpy as np
import pytest

import paddle_tpu as ptpu
from paddle_tpu import layers as ref_layers
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.core.framework import BFLOAT16
from paddle_tpu_torch.models import resnet as port_resnet

KINDS = ("plain", "fused", "recompute")


def _ref_cifar(img, label, depth, recompute):
    """The reference's ``resnet_cifar10`` from its own pieces, each
    residual block in ``layers.recompute`` when asked (its
    ``resnet_cifar10`` takes no ``recompute``)."""
    n = (depth - 2) // 6
    conv1 = ref_resnet.conv_bn_layer(img, 16, 3, 1, 1)
    res = conv1
    for ch, stride in ((16, 1), (32, 2), (64, 2)):
        res = ref_resnet.layer_warp(ref_resnet.basicblock, res, ch, n,
                                    stride, False, recompute)
    pool = ref_layers.pool2d(res, pool_size=8, pool_type="avg",
                             global_pooling=True)
    flat = ref_layers.reshape(pool, [-1, pool.shape[1]])
    logits = ref_layers.fc(flat, 10)
    loss = ref_layers.mean(ref_layers.softmax_with_cross_entropy(logits,
                                                                 label))
    ref_layers.accuracy(ref_layers.softmax(logits), label)
    return loss


def build(pkg, kind, depth=8, res=16, lr=0.1):
    """(main, startup) of ResNet-``depth`` for CIFAR with Momentum(lr,
    0.9), built by ``pkg`` ("ref" or "port")."""
    ref = pkg == "ref"
    cfg = ptpu.config if ref else port_config
    fw = ptpu if ref else pc
    layers = ref_layers if ref else port_layers
    cfg.set_flags(fused_conv_bn=kind == "fused")
    try:
        main, startup = fw.Program(), fw.Program()
        with fw.unique_name.guard(), fw.program_guard(main, startup):
            img = layers.data("img", shape=[3, res, res])
            label = layers.data("label", shape=[1], dtype="int64")
            if ref:
                loss = _ref_cifar(img, label, depth, kind == "recompute")
                opt = ptpu.optimizer.Momentum(lr, 0.9)
            else:
                loss = port_resnet.resnet_cifar10(
                    img, label, depth=depth,
                    recompute=kind == "recompute")[0]
                opt = port_opt.Momentum(lr, 0.9)
            opt.minimize(loss, startup)
    finally:
        cfg.set_flags(fused_conv_bn=False)
    return main, startup


def _json(ser, program):
    return json.dumps(ser.program_to_dict(program))


@pytest.fixture(scope="module")
def programs():
    return {(pkg, kind): build(pkg, kind) for pkg in ("ref", "port")
            for kind in KINDS}


@pytest.mark.parametrize("which", ["main", "startup"])
@pytest.mark.parametrize("kind", KINDS)
def test_front_end_builds_the_reference_program(programs, kind, which):
    i = 0 if which == "main" else 1
    ours = _json(port_ser, programs["port", kind][i])
    assert ours == _json(ref_ser, programs["ref", kind][i])


@pytest.mark.parametrize("which", ["main", "startup"])
@pytest.mark.parametrize("kind", KINDS)
def test_programs_cross_byte_identical(programs, kind, which):
    i = 0 if which == "main" else 1
    theirs = _json(ref_ser, programs["ref", kind][i])
    loaded = port_ser.program_from_dict(json.loads(theirs))
    assert _json(port_ser, loaded) == theirs
    ours = _json(port_ser, programs["port", kind][i])
    back = ref_ser.program_from_dict(json.loads(ours))
    assert _json(ref_ser, back) == ours


def test_the_programs_hold_the_slice(programs):
    main, startup = programs["port", "recompute"]
    types = {op.type for b in main.blocks for op in b.ops}
    assert {"recompute_block", "vjp_grad", "fill_like", "momentum",
            "conv2d", "batch_norm"} <= types
    assert len(main.blocks) == 1 + 3  # one sub-block a residual block
    # a variable read by two ops (a block's input: its shortcut and its
    # first conv) has its gradients folded by a sum
    plain = programs["port", "plain"][0].global_block().ops
    assert "sum" in {op.type for op in plain}
    fused = {op.type for op in programs["port", "fused"][0].global_block()
             .ops}
    assert "conv2d_bn" in fused and "conv2d" not in fused
    assert {op.type for op in startup.global_block().ops} == {
        "gaussian_random", "fill_constant", "uniform_random"}


def test_vjp_grad_refs_resolve_to_their_forward_op(programs):
    main = port_ser.program_from_dict(
        port_ser.program_to_dict(programs["port", "plain"][0]))
    ops = main.global_block().ops
    grads = [op for op in ops if op.type == "vjp_grad"]
    assert grads and all(op.attrs["fwd_op"] in ops and
                         op.attrs["fwd_op"].type == op.attrs["fwd_op_type"]
                         for op in grads)


def test_attr_encodings_round_trip():
    main = pc.Program()
    block = main.global_block()
    block.create_var(name="x", shape=[2], dtype="bfloat16")
    first = block.append_op("relu", inputs={"X": ["x"]},
                            outputs={"Out": ["x"]}, infer_shape=False)
    attrs = {"t": (1, 2), "d": np.dtype("int32"), "b": BFLOAT16,
             "a": np.arange(6, dtype=np.float32).reshape(2, 3),
             "m": {"k": [1, (2, 3)]}, "f": np.float32(0.5),
             "i": np.int64(3), "op": first}
    block.append_op("relu", inputs={"X": ["x"]}, outputs={"Out": ["x"]},
                    attrs=attrs, infer_shape=False)
    data = port_ser.program_to_dict(main)
    back = port_ser.program_from_dict(json.loads(json.dumps(data)))
    got = back.global_block().ops[1].attrs
    assert got["t"] == (1, 2) and got["d"] == np.dtype("int32")
    assert got["b"] is BFLOAT16 and got["m"] == {"k": [1, (2, 3)]}
    np.testing.assert_array_equal(got["a"], attrs["a"])
    assert got["f"] == 0.5 and got["i"] == 3
    assert got["op"] is back.global_block().ops[0]
    assert back.global_block().var("x").dtype is BFLOAT16
    # the reference reads what the port writes
    assert json.dumps(ref_ser.program_to_dict(ref_ser.program_from_dict(
        json.loads(json.dumps(data))))) == json.dumps(data)


def test_serialization_refuses_what_it_cannot_write():
    main = pc.Program()
    block = main.global_block()
    block.create_var(name="x", shape=[2])
    op = block.append_op("relu", inputs={"X": ["x"]},
                         outputs={"Out": ["x"]}, infer_shape=False)
    op.attrs["live"] = object()
    with pytest.raises(TypeError, match="attrs must be data"):
        port_ser.program_to_dict(main)
    op.attrs["live"] = [op]
    with pytest.raises(TypeError, match="top-level"):
        port_ser.program_to_dict(main)
    op.attrs["live"] = pc.Program().global_block().append_op(
        "relu", infer_shape=False)
    with pytest.raises(ValueError, match="outside the program"):
        port_ser.program_to_dict(main)
    with pytest.raises(ValueError, match="format version"):
        port_ser.program_from_dict({"format_version": 99, "blocks": []})
