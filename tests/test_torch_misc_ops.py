"""The misc op types against the reference (``ops/misc_ops.py``, the
layers over them in ``layers/nn.py``, ``layers/detection.py``'s
``roi_pool`` and ``layers/control_flow.py``'s ``Print``, in both
packages).

The 7 op types on the cases of ``probes/op_cases.py``: forward within
each case's tolerance, build-time shapes equal, gradients within 1e-5 of
max|ref|; ``roi_pool``'s gradient among tied maxima split evenly, as the
reference's ``max``, exactly; a program of the layers serializes as the
reference's, and one SGD step of it from the reference's checkpoint
gives its outputs and updated parameters within 1e-5; ``Print``'s line
is the reference's (``message: <array>``), and a program holding it is
refused capture and export."""

import json

import jax
import numpy as np
import pytest

import paddle_tpu as ptpu
from paddle_tpu import io as ref_io
from paddle_tpu import layers as ref_layers
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.ops import control_flow_ops
from paddle_tpu_torch.probes.op_cases import (TAIL_CASES, TAIL_FAMILIES,
                                              Case)
from test_torch_ops_cases import (assert_outputs_match, rel_err, run_port,
                                  run_ref)
from test_torch_ops_grad import grads
from test_torch_ops_shapes import _infer

GRAD_RTOL = 1e-5
STEP_RTOL = 1e-5
CASES = [c for c in TAIL_CASES if c.op_type in TAIL_FAMILIES["misc"]]


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
    for w, g in zip(want, got):
        if np.abs(w).max() or np.abs(g).max():
            assert rel_err(g, w) <= GRAD_RTOL, (case.id, rel_err(g, w))


def test_roi_pool_splits_the_gradient_among_tied_maxima():
    """Bins of equal values, two ROIs overlapping on them: the gradient is
    shared evenly among each bin's tied pixels, as the reference's
    ``max`` shares it, exactly."""
    x = np.zeros((1, 2, 4, 6), np.float32)
    x[0, 0, :2, :3] = 1.0                     # a bin of six ties
    x[0, 1, 1, 2] = x[0, 1, 2, 4] = 3.0       # two ties in one bin
    case = Case("roi_pool", lambda _: {
        "X": x, "ROIs": np.array([[0, 0, 0, 5, 3], [0, 1, 0, 5, 3]],
                                 np.float32)},
        {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0},
        name="ties")
    (_, want), (_, got) = grads(case, jit=True)    # ROIs', X's
    np.testing.assert_array_equal(got, want)
    # column 0 lies in the first ROI's tied bin alone: an even share
    assert got[0, 0, 0, 0] == got[0, 0, 1, 0] > 0


def _layers_program(pkg):
    """switch_order, scale_shift, resize, kmax_seq_score, scale_sub_region
    and roi_pool in one program; SGD(0.1) on the sum of the float
    outputs' means."""
    fw, L, opt = (ptpu, ref_layers, ptpu.optimizer) if pkg == "ref" else \
        (pc, port_layers, port_opt)
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 2
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        x = L.data("x", shape=[3, 4, 6])
        scores = L.data("scores", shape=[6])
        length = L.data("length", shape=[], dtype="int32")
        ind = L.data("ind", shape=[6], dtype="int32")
        rois = L.data("rois", shape=[5])
        nhwc = L.switch_order(x)
        shifted = L.scale_shift(nhwc)
        rows = L.resize(shifted, 4)
        top = L.kmax_seq_score(scores, length=length, beam_size=3)
        sub = L.scale_sub_region(x, ind, value=2.0)
        pooled = L.roi_pool(sub, rois, 2, 3, 0.5)
        outs = [nhwc, shifted, rows, sub, pooled]
        loss = L.sums([L.mean(o) for o in outs[1:]])
        opt.SGD(0.1).minimize(loss, startup)
    return main, startup, outs + [top, loss]


def _layers_feed():
    rs = np.random.RandomState(8)
    return {"x": rs.randn(2, 3, 4, 6).astype(np.float32),
            "scores": rs.randint(0, 4, (2, 6)).astype(np.float32),
            "length": np.array([6, 2], np.int32),
            "ind": np.array([[1, 2, 2, 3, 1, 6], [3, 3, 1, 4, 2, 2]],
                            np.int32),
            "rois": np.array([[0, 0, 0, 10, 6], [1, 2, 1, 9, 7],
                              [1, 6, 6, 4, 2]], np.float32)}


@pytest.mark.parametrize("which", [0, 1], ids=["main", "startup"])
def test_layers_program_is_the_references(which):
    ref = json.dumps(ref_ser.program_to_dict(_layers_program("ref")[which]))
    port = json.dumps(port_ser.program_to_dict(
        _layers_program("port")[which]))
    assert port == ref


def test_layers_sgd_step_from_a_reference_checkpoint(tmp_path):
    d = str(tmp_path)
    feed = _layers_feed()
    main, startup, fetch = _layers_program("ref")
    exe, scope = ptpu.Executor(), ptpu.Scope()
    with ptpu.scope_guard(scope):
        exe.run(startup)
        ref_io.save_persistables(exe, d, main_program=main)
        want = exe.run(main, feed=feed, fetch_list=fetch)
    pmain, _, pfetch = _layers_program("port")
    pexe, pscope = pc.Executor(device="cpu"), pc.Scope()
    port_io.load_persistables(pexe, d, main_program=pmain, scope=pscope)
    got = pexe.run(pmain, feed=feed, fetch_list=pfetch, scope=pscope)
    for v, g, w in zip(fetch, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, v.name
        assert rel_err(g, w) <= STEP_RTOL, (v.name, rel_err(g, w))
    params = [p.name for p in pmain.global_block().all_parameters()]
    assert len(params) == 2
    for name in params:
        w = np.asarray(scope.find_var(name))
        assert rel_err(pscope.find_var(name).numpy(), w) <= STEP_RTOL


def _print_program(pkg):
    fw, L = (ptpu, ref_layers) if pkg == "ref" else (pc, port_layers)
    main, startup = fw.Program(), fw.Program()
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        x = L.data("x", shape=[3])
        y = L.Print(L.scale(x, scale=2.0), message="doubled")
        out = L.mean(y)
    return main, out


def test_print_writes_the_references_line(capfd):
    feed = {"x": np.arange(6, dtype=np.float32).reshape(2, 3) / 4}
    main, out = _print_program("ref")
    ptpu.Executor().run(main, feed=feed, fetch_list=[out])
    jax.effects_barrier()
    ref_text = capfd.readouterr().out
    main, out = _print_program("port")
    before = control_flow_ops.HOST_READS["print"]
    pc.Executor(device="cpu").run(main, feed=feed, fetch_list=[out])
    port_text = capfd.readouterr().out
    assert port_text == ref_text == "doubled: %s\n" % (2 * feed["x"])
    assert control_flow_ops.HOST_READS["print"] == before + 1


def test_print_program_is_refused_capture_and_export(capfd):
    main, out = _print_program("port")
    feed = {"x": np.ones((2, 3), np.float32)}
    exe = pc.Executor(device="cpu")
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[out])
    assert capfd.readouterr().out.count("doubled: ") == 3
    stats = exe.capture_stats()
    assert stats["captures"] == 0 and stats["refused"] == 1
    reason, = stats["refused_reasons"].values()
    assert "print" in reason
    with pytest.raises(ValueError, match="cannot be exported"):
        exe.lower(main, feed=feed, fetch_list=[out], scope=pc.Scope())
