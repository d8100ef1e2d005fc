"""The sequence ops of the RNN and seq2seq slice against the reference
(``ops/sequence_ops.py``, ``array_read``/``array_write`` of
``ops/tensor_ops.py`` and ``chunk_eval_counts`` of ``ops/metric_ops.py``
in both packages), on the cases of ``probes/op_cases.py``: forward
outputs within the case's tolerance (1e-5 of max|ref| for the time
loops, exact for ids, lengths and counts) with the reference's slots,
shapes and dtypes; gradients of every float input (autograd through the
op against ``jax.vjp``) within 1e-4 of max|grad|; build-time shapes.
Pinned cases: ``sequence_pool(last)`` of a zero-length row takes the
padding's last step, as the reference's wrapped index -1 does; a tensor
array's index -1, ``max_len`` and below -``max_len`` clamp as XLA's
dynamic slices do; the sequence layers build the reference's programs
byte for byte."""

import json

import numpy as np
import pytest

import paddle_tpu as ptpu
from paddle_tpu import layers as ref_layers
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch.core import registry as port_registry
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.probes.op_cases import Case, RNN_CASES, RNN_FAMILIES
from test_torch_ops_cases import (assert_outputs_match, rel_err, run_port,
                                  run_ref)
from test_torch_ops_cases import one_thread  # noqa: F401
from test_torch_ops_grad import grads
from test_torch_ops_shapes import _infer

GRAD_RTOL = 1e-4
FAMILIES = ("sequence", "tensor", "metric")
CASES = [c for c in RNN_CASES
         if any(c.op_type in RNN_FAMILIES[f] for f in FAMILIES)]


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_forward_matches_reference(case):
    assert_outputs_match(run_port(case), run_ref(case), case.tol, case.id)


@pytest.mark.parametrize("case", [c for c in CASES if c.grad],
                         ids=lambda c: c.id)
def test_gradient_matches_reference(case):
    want, got = grads(case)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        if np.abs(w).max() or np.abs(g).max():
            assert rel_err(g, w) <= GRAD_RTOL, (case.id, rel_err(g, w))


@pytest.mark.parametrize(
    "case", [c for c in CASES if not port_registry.get_op_def(
        c.op_type).skip_eval_shape], ids=lambda c: c.id)
def test_build_time_shapes_match_reference(case):
    inputs = case.inputs()
    assert _infer("port", case, inputs, False) == \
        _infer("ref", case, inputs, False)


def test_last_step_of_an_empty_row_is_the_references():
    """Length 0: the index -1 wraps to the last (padding) step in both
    packages."""
    case = next(c for c in CASES if c.id == "sequence_pool-last")
    x = case.inputs()["X"]
    out = run_port(case)["Out"][0]
    np.testing.assert_array_equal(out[2], x[2, -1])
    np.testing.assert_array_equal(out, run_ref(case)["Out"][0])


@pytest.mark.parametrize("name,row", [("in", 2), ("minus1", 3),
                                      ("max-len", 3), ("below", 0)])
def test_tensor_array_index_clamps(name, row):
    """The row each index reaches: -1 the last, ``max_len`` clamped to the
    last, -6 (below -``max_len``) clamped to the first."""
    read = next(c for c in CASES if c.id == "array_read-" + name)
    arr = read.inputs()["Array"]
    np.testing.assert_array_equal(run_port(read)["Out"][0], arr[row])
    write = next(c for c in CASES if c.id == "array_write-" + name)
    inputs = write.inputs()
    out = run_port(write)["Out"][0]
    np.testing.assert_array_equal(out[row], inputs["X"])
    keep = [r for r in range(4) if r != row]
    np.testing.assert_array_equal(out[keep], inputs["Array"][keep])


def _sequence_layers(pkg):
    fw, L = (ptpu, ref_layers) if pkg == "ref" else (pc, port_layers)
    main, startup = fw.Program(), fw.Program()
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        x = L.data("x", shape=[6, 8])
        ids = L.data("ids", shape=[6], dtype="int64")
        length = L.data("len", shape=[], dtype="int64")
        outs = [L.sequence_pool(x, "max", length=length),
                L.sequence_first_step(x), L.sequence_last_step(x, length),
                L.sequence_softmax(L.reshape(L.fc(x, 1, num_flatten_dims=2),
                                             [-1, 6]), length),
                L.sequence_reverse(x, length),
                L.sequence_erase_pad(ids, length, [2, 3])[0],
                L.sequence_conv(x, 5, 3, act="relu"),
                L.dynamic_lstm(L.fc(x, 16, num_flatten_dims=2), 4,
                               length=length, use_peepholes=True)[0],
                L.dynamic_gru(L.fc(x, 12, num_flatten_dims=2), 4,
                              length=length, is_reverse=True),
                L.sequence_reshape(x, 4, length)[0],
                L.lod_reset(x, length, length)[1],
                L.max_sequence_len(length),
                L.sequence_concat_packed(x, x, length, length)[0],
                L.sequence_expand(L.sequence_pool(x, "sum"), x, length),
                L.sequence_slice(x, 1, 3), L.sequence_concat([x, x])]
        h = L.fill_constant_batch_size_like(x, shape=[-1, 4],
                                            dtype="float32", value=0.0)
        step = L.reshape(L.slice(x, [1], [0], [1]), [-1, 8])
        outs += list(L.gru_unit(L.fc(step, 12), h, 4))
        outs += list(L.lstm_unit(step, h, h, forget_bias=1.0))
        arr = L.create_array(3, [8])
        i = L.fill_constant([1], "int32", 1)
        outs.append(L.array_read(L.array_write(
            L.reshape(L.slice(step, [0], [0], [1]), [8]), i, arr), i))
    return main, startup


def test_sequence_layers_build_the_references_programs():
    for a, b in zip(_sequence_layers("ref"), _sequence_layers("port")):
        assert json.dumps(port_ser.program_to_dict(b)) == \
            json.dumps(ref_ser.program_to_dict(a))


@pytest.mark.parametrize("op_type,attrs", [
    ("dynamic_lstm", {}), ("dynamic_lstm", {"is_reverse": True}),
    ("dynamic_gru", {}), ("dynamic_gru", {"is_reverse": True}),
    ("sequence_pool", {"pool_type": "max"}),
    ("sequence_pool", {"pool_type": "last"}),
    ("sequence_softmax", {}), ("sequence_reverse", {})],
    ids=lambda v: v if isinstance(v, str) else "-".join(map(str, v.values())))
def test_padding_invariance(op_type, attrs):
    """Garbage in the padding, and more padded steps, change nothing at
    the valid steps (bitwise: a padded step carries the state through as
    ``0 * h_new + 1 * h_prev``)."""
    rs = np.random.RandomState(5)
    length = np.array([6, 3, 1], np.int32)
    width = {"dynamic_lstm": 16, "dynamic_gru": 12}.get(op_type, 4)
    x = rs.randn(3, 6, width).astype(np.float32)
    if op_type == "sequence_softmax":
        x = x[:, :, 0]
    valid = np.arange(6)[None] < length[:, None]
    noisy = np.where(valid.reshape(valid.shape + (1,) * (x.ndim - 2)), x,
                     rs.randn(*x.shape).astype(np.float32) * 100)
    longer = np.concatenate([noisy, rs.randn(*((3, 4) + x.shape[2:]))
                             .astype(np.float32)], axis=1)
    extra = {}
    if op_type in ("dynamic_lstm", "dynamic_gru"):
        h = width // (4 if op_type == "dynamic_lstm" else 3)
        extra = {"Weight": 0.5 * rs.randn(h, width).astype(np.float32),
                 "Bias": 0.1 * rs.randn(1, width).astype(np.float32)}
    slot = "Input" if op_type in ("dynamic_lstm", "dynamic_gru") else "X"
    outs = []
    for data in (x, noisy, longer):
        case = Case(op_type, lambda rs, d=data: dict(
            {slot: d, "Length": length}, **extra), attrs)
        outs.append(run_port(case))
    for slot_out in outs[0]:
        for run in outs[1:]:
            a, b = outs[0][slot_out][0], run[slot_out][0]
            if a.ndim >= 2 and a.shape[1] == 6:
                mask = valid.reshape(valid.shape + (1,) * (a.ndim - 2))
                np.testing.assert_array_equal(
                    np.where(mask, a, 0), np.where(mask, b[:, :6], 0))
            else:
                np.testing.assert_array_equal(a, b)
