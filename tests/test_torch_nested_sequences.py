"""Nested (2-level) sequences against the reference
(``ops/nested_ops.py`` and the nested layers of ``layers/sequence.py``
in both packages): the masks, the inner pool, ``sub_seq`` and
``sub_nested_seq`` on the cases of ``probes/op_cases.py`` (exact, or the
pools within their sum tolerance; gradients within 1e-4 of max|grad|),
with an empty sub-sequence pooling to 0, a window past either end masked
rather than clamped, and a negative selection an empty sub-sequence; the
layers' programs byte for byte; and the reference's hierarchical model
(an inner GRU over each sentence through ``nested_flatten``, an outer GRU
over the sentence encodings) trained 3 Adam steps from the reference's
startup weights to its losses."""

import json

import numpy as np
import pytest

import paddle_tpu as ptpu
from paddle_tpu import layers as ref_layers
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.probes.op_cases import RNN_CASES, RNN_FAMILIES
from test_torch_ops_cases import (assert_outputs_match, rel_err, run_port,
                                  run_ref)
from test_torch_ops_cases import one_thread  # noqa: F401
from test_torch_ops_grad import grads
from test_torch_ops_shapes import _infer

B, S, T, D, H = 4, 3, 5, 4, 8
LR = 5e-3
STEPS = 3
CASES = [c for c in RNN_CASES if c.op_type in RNN_FAMILIES["nested"]]


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_forward_matches_reference(case):
    assert_outputs_match(run_port(case), run_ref(case), case.tol, case.id)


@pytest.mark.parametrize("case", [c for c in CASES if c.grad],
                         ids=lambda c: c.id)
def test_gradient_matches_reference(case):
    want, got = grads(case)
    for w, g in zip(want, got):
        if np.abs(w).max() or np.abs(g).max():
            assert rel_err(g, w) <= 1e-4, (case.id, rel_err(g, w))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_build_time_shapes_match_reference(case):
    inputs = case.inputs()
    assert _infer("port", case, inputs, False) == \
        _infer("ref", case, inputs, False)


@pytest.mark.parametrize("pool", ["max", "first", "last"])
def test_an_empty_sub_sequence_pools_to_zero(pool):
    case = next(c for c in CASES if c.id == "nested_sequence_pool-" + pool)
    np.testing.assert_array_equal(run_port(case)["Out"][0][0, 1], 0.0)


def test_windows_past_the_ends_are_masked():
    case = next(c for c in CASES if c.op_type == "sub_seq")
    x = case.inputs()["X"]
    out = run_port(case)["Out"][0]
    # offset 4, size 4 over T 6: two steps, then zeros, not step 5 again
    np.testing.assert_array_equal(out[1, :2], x[1, 4:6])
    np.testing.assert_array_equal(out[1, 2:], 0.0)
    # offset -1: the step before the start is masked
    np.testing.assert_array_equal(out[2, 0], 0.0)
    np.testing.assert_array_equal(out[2, 1], x[2, 0])


def _hierarchical(pkg):
    fw, L, opt = (ptpu, ref_layers, ptpu.optimizer) if pkg == "ref" else \
        (pc, port_layers, port_opt)
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 9
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        x = L.data("x", shape=[B, S, T, D], append_batch_size=False)
        seq_len = L.data("seq_len", shape=[B], dtype="int64",
                         append_batch_size=False)
        sub_len = L.data("sub_len", shape=[B, S], dtype="int64",
                         append_batch_size=False)
        y = L.data("y", shape=[B, 1], append_batch_size=False)
        flat, flat_len = L.nested_flatten(x, sub_len)
        enc = L.dynamic_gru(L.fc(flat, 3 * H, num_flatten_dims=2), H,
                            length=flat_len)
        sent = L.nested_unflatten(
            L.sequence_pool(enc, "last", length=flat_len), B, S)
        doc = L.dynamic_gru(L.fc(sent, 3 * H, num_flatten_dims=2), H,
                            length=seq_len)
        pred = L.fc(L.sequence_pool(doc, "last", length=seq_len), 1)
        loss = L.mean(L.square_error_cost(pred, y))
        outer, inner = L.nested_sequence_mask(seq_len, sub_len, S, T)
        pooled = L.nested_sequence_pool(x, sub_len, "average")
        sel = L.fill_constant([B, 2], "int32", 1)
        picked, _ = L.sub_nested_seq(x, sub_len, sel)
        opt.Adam(learning_rate=LR).minimize(loss, startup)
    return main, startup, [loss, outer, inner, pooled, picked]


def _feeds(n, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        seq_len = rs.randint(1, S + 1, B)
        sub_len = rs.randint(1, T + 1, (B, S)) * \
            (np.arange(S)[None] < seq_len[:, None])
        out.append({"x": rs.randn(B, S, T, D).astype(np.float32),
                    "seq_len": seq_len.astype(np.int32),
                    "sub_len": sub_len.astype(np.int32),
                    "y": rs.randn(B, 1).astype(np.float32)})
    return out


def test_hierarchical_model_trains_as_the_reference():
    main, startup, fetch = _hierarchical("ref")
    pmain, pstartup, pfetch = _hierarchical("port")
    for a, b in ((main, pmain), (startup, pstartup)):
        assert json.dumps(port_ser.program_to_dict(b)) == \
            json.dumps(ref_ser.program_to_dict(a))
    exe, scope = ptpu.Executor(), ptpu.Scope()
    exe.run(startup, scope=scope)
    init = {n: np.array(scope.find_var(n)) for n in scope.var_names()}
    pexe = pc.Executor(device="cpu")
    pscope = port_io.scope_from_jax(init, device="cpu")
    for f in _feeds(STEPS):
        want = exe.run(main, feed=f, fetch_list=fetch, scope=scope)
        got = pexe.run(pmain, feed=f, fetch_list=pfetch, scope=pscope)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-7)
