"""The legacy layer tail against the reference (``ops/legacy_tail_ops.py``
and ``layers/legacy.py`` in both packages).

The 6 op types on the cases of ``probes/op_cases.py`` (``mdlstm`` in
each of its direction flips): forward within each case's tolerance,
build-time shapes equal, gradients within 1e-5 of max|ref| (``mdlstm``'s
within 1e-4: its time loop); ``lambda_cost``'s gradient is the
reference's custom VJP (the hand-derived LambdaRank gradient), not zero,
where autograd of its forward is zero. Then one program holding the 6
layers and the 19 compositions, each fed by an fc of its own from one
input (``_tail_program``): it serializes as the reference's, and one
SGD(0.5) step from the reference's checkpoint gives each layer's output
within 1e-5 (``mdlstm``'s 1e-5 of its time loop), and each parameter of
the layer's fcs and of the layer itself moves by the reference's move
(0.5 x its gradient through the layer) within 1e-4 of its largest
element (``mdlstm``'s 1e-4), one order above the forward's: a gradient
chains the layer's backward and the fcs'."""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import io as ref_io
from paddle_tpu import layers as ref_layers
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.ops import legacy_tail_ops
from paddle_tpu_torch.probes.op_cases import (RNN, TAIL_CASES,
                                              TAIL_FAMILIES)
from test_torch_ops_cases import (assert_outputs_match, rel_err, run_port,
                                  run_ref)
from test_torch_ops_grad import grads
from test_torch_image_models import numpy_startup
from test_torch_ops_shapes import _infer
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

GRAD_RTOL = 1e-5
RNN_GRAD_RTOL = 1e-4
STEP_RTOL = 1e-5
CASES = [c for c in TAIL_CASES if c.op_type in TAIL_FAMILIES["legacy"]]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_forward_matches_reference(case):
    assert_outputs_match(run_port(case), run_ref(case, jit=True), case.tol,
                         case.id)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_build_time_shapes_match_reference(case):
    inputs = case.inputs()
    assert _infer("port", case, inputs, False) == \
        _infer("ref", case, inputs, False)


@pytest.mark.parametrize("case", [c for c in CASES if c.grad],
                         ids=lambda c: c.id)
def test_gradient_matches_reference(case):
    want, got = grads(case, jit=True)
    tol = RNN_GRAD_RTOL if case.tol == RNN else GRAD_RTOL
    for w, g in zip(want, got):
        if np.abs(w).max() or np.abs(g).max():
            assert rel_err(g, w) <= tol, (case.id, rel_err(g, w))


def test_lambda_cost_gradient_is_the_custom_vjp_not_zero():
    case = next(c for c in CASES if c.op_type == "lambda_cost")
    (_, want), (_, got) = grads(case, jit=True)       # Score's, X's
    assert np.abs(want).max() > 0.01
    assert rel_err(got, want) <= GRAD_RTOL
    # autograd of the forward alone: NDCG is piecewise constant in X
    inputs = case.inputs()
    x = torch.from_numpy(inputs["X"]).requires_grad_()
    valid = torch.arange(6)[None, :] < torch.from_numpy(
        inputs["Length"]).long()[:, None]
    cost = legacy_tail_ops.ndcg(x, torch.from_numpy(inputs["Score"]),
                                valid, case.attrs["NDCG_num"])
    assert not cost.requires_grad


B = 3


def _tail_program(pkg):
    """The 6 layers and the 19 compositions of ``layers/legacy.py``, each
    fed by fcs of its own from ``x`` [B, 6]; SGD(0.5) on the sum of the
    float outputs' means and mean squares. Returns the programs, the outputs by
    layer and the trainable parameters each layer's fcs (and the layer)
    created."""
    fw, L, opt = (ptpu, ref_layers, ptpu.optimizer) if pkg == "ref" else \
        (pc, port_layers, port_opt)
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 4
    outs, params = {}, {}
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        x = L.data("x", shape=[6])
        label = L.data("label", shape=[1], dtype="int64")
        multi = L.data("multi", shape=[4])
        score = L.data("score", shape=[5])
        length = L.data("length", shape=[], dtype="int32")
        sel = L.data("sel", shape=[3], dtype="int32")
        ids0 = L.data("ids0", shape=[1, 2], dtype="int32")
        ids1 = L.data("ids1", shape=[2, 2], dtype="int32")
        gold0 = L.data("gold0", shape=[], dtype="int32")
        gold1 = L.data("gold1", shape=[], dtype="int32")
        block = main.global_block()

        def fc(n, act=None):
            return L.fc(x, n, act=act)

        def prob(n):
            return L.softmax(fc(n))

        layers = [
            ("bilinear_interp", lambda: L.bilinear_interp(
                L.reshape(fc(24), [-1, 2, 3, 4]), 5, 2)),
            ("selective_fc", lambda: L.selective_fc(fc(4), 7, select=sel)),
            ("data_norm", lambda: L.data_norm(fc(4), mode="min-max", stats={
                "min": np.full(4, -1.0, np.float32),
                "max": np.array([1, 2, 3, 4], np.float32)})),
            ("mdlstm", lambda: L.mdlstm(L.reshape(fc(24), [-1, 2, 3, 4]),
                                        2, directions=(False, True))),
            ("lambda_cost", lambda: L.lambda_cost(fc(5), score, length,
                                                  NDCG_num=3)),
            ("cross_entropy_over_beam", lambda: L.cross_entropy_over_beam(
                [(fc(5), ids0, gold0), (fc(6), ids1, gold1)])),
            ("interpolation", lambda: L.interpolation(
                fc(4), fc(4), fc(1, "sigmoid"))),
            ("linear_comb", lambda: L.linear_comb(fc(3), fc(6), 2)),
            ("slope_intercept", lambda: L.slope_intercept(fc(4), 2.0, 0.5)),
            ("repeat", lambda: L.repeat(fc(4), 3)),
            ("rotate", lambda: L.rotate(fc(12), 2, 3)),
            ("out_prod", lambda: L.out_prod(fc(3), fc(2))),
            ("gated_unit", lambda: L.gated_unit(fc(4), 3, act="tanh")),
            ("power", lambda: L.power(fc(4, "sigmoid"), fc(1, "sigmoid"))),
            ("trans", lambda: L.trans(fc(4))),
            ("l2_distance", lambda: L.l2_distance(fc(4), fc(4))),
            ("sum_to_one_norm", lambda: L.sum_to_one_norm(
                fc(4, "sigmoid"))),
            ("row_l2_norm", lambda: L.row_l2_norm(fc(4))),
            ("eos", lambda: L.eos(prob(5), 2)),
            ("cross_entropy_with_selfnorm", lambda:
             L.cross_entropy_with_selfnorm(prob(5), label)),
            ("multi_binary_label_cross_entropy", lambda:
             L.multi_binary_label_cross_entropy(fc(4, "sigmoid"), multi)),
            ("sum_cost", lambda: L.sum_cost(fc(4))),
            ("cos_sim_vec_mat", lambda: L.cos_sim_vec_mat(fc(3), fc(9),
                                                          scale=2.0)),
            ("featmap_expand", lambda: L.featmap_expand(fc(4), 2,
                                                        as_row_vector=False)),
            ("convex_comb", lambda: L.convex_comb(fc(2), fc(6), 3)),
        ]
        for name, build in layers:
            before = {p.name for p in block.all_parameters()}
            outs[name] = build()
            params[name] = sorted(p.name for p in block.all_parameters()
                                  if p.name not in before and p.trainable)
        # mean + mean square: neither a unit-sum nor a unit-norm row makes
        # both constant
        loss = L.sums([t for n, o in outs.items() if n != "eos"
                       for t in (L.mean(o), L.mean(L.square(o)))])
        opt.SGD(0.5).minimize(loss, startup)
    return main, startup, outs, params, loss


def _tail_feed():
    rs = np.random.RandomState(6)
    return {"x": rs.randn(B, 6).astype(np.float32),
            "label": rs.randint(0, 5, (B, 1)).astype(np.int64),
            "multi": (rs.rand(B, 4) > 0.5).astype(np.float32),
            "score": rs.randint(0, 4, (B, 5)).astype(np.float32),
            "length": np.array([5, 3, 1], np.int32),
            "sel": np.array([[0, 6, 2], [3, -1, 3], [-1, 5, 1]], np.int32),
            "ids0": np.array([[[1, 3]], [[0, 2]], [[1, 4]]], np.int32),
            "ids1": np.array([[[0, 2], [4, 5]], [[1, -1], [3, 4]],
                              [[0, 1], [2, 3]]], np.int32),
            "gold0": np.array([3, 0, 2], np.int32),
            "gold1": np.array([5, 3, 0], np.int32)}


LAYERS = [name for name in _tail_program("port")[3]]


@pytest.mark.parametrize("which", [0, 1], ids=["main", "startup"])
def test_tail_program_is_the_references(which):
    ref = json.dumps(ref_ser.program_to_dict(_tail_program("ref")[which]))
    port = json.dumps(port_ser.program_to_dict(_tail_program("port")[which]))
    assert port == ref


@pytest.fixture(scope="module")
def tail_step(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tail"))
    feed = _tail_feed()
    main, startup, outs, _, loss = _tail_program("ref")
    exe, scope = ptpu.Executor(), ptpu.Scope()
    with ptpu.scope_guard(scope):
        numpy_startup(startup, scope)
        ref_io.save_persistables(exe, d, main_program=main)
        init = {p.name: np.array(scope.find_var(p.name))
                for p in main.global_block().all_parameters()}
        want = exe.run(main, feed=feed, fetch_list=list(outs.values()))
    pmain, _, pouts, params, _ = _tail_program("port")
    pexe, pscope = pc.Executor(device="cpu"), pc.Scope()
    port_io.load_persistables(pexe, d, main_program=pmain, scope=pscope)
    got = pexe.run(pmain, feed=feed, fetch_list=list(pouts.values()),
                   scope=pscope)
    return dict(want=dict(zip(outs, want)), got=dict(zip(pouts, got)),
                scope=scope, pscope=pscope, params=params, init=init)


def _tol(name):
    return RNN if name == "mdlstm" else STEP_RTOL


@pytest.mark.parametrize("name", LAYERS)
def test_layer_forward_matches_reference(tail_step, name):
    got, want = tail_step["got"][name], np.asarray(tail_step["want"][name])
    assert got.shape == want.shape and got.dtype == want.dtype
    assert rel_err(got, want) <= _tol(name), rel_err(got, want)


@pytest.mark.parametrize("name", [n for n in LAYERS if n != "eos"])
def test_layer_gradient_matches_reference(tail_step, name):
    """Each of the layer's parameters' move in the SGD step (0.5 x its
    gradient, through the layer alone) against the reference's."""
    names = tail_step["params"][name]
    assert names
    for p in names:
        init = tail_step["init"][p]
        w = np.asarray(tail_step["scope"].find_var(p)) - init
        g = tail_step["pscope"].find_var(p).numpy() - init
        assert np.abs(w).max() > 0, p
        assert rel_err(g, w) <= 10 * _tol(name), (p, rel_err(g, w))
