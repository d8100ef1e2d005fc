"""The SSD detection family against the reference (``ops/detection_ops.py``,
``layers/detection.py``, ``models/ssd.py`` and ``evaluator.DetectionMAP``
in both packages).

The four op types on the cases of ``probes/op_cases.py`` (forward within
each case's tolerance, build-time shapes equal) and ``multibox_loss``'s
gradient within 1e-5 of max|ref|; the rules where torch parts from JAX,
each pinned exactly: two ground-truth boxes sharing a best prior (the
higher index takes it, as the reference's scatter leaves it), hard
negatives among equal losses (all confidence logits equal: the lower
prior indices, a stable sort), NMS and the top-k among tied scores (the
lower index first); ``ssd_net`` at 64², one Momentum(0.01, 0.9) step from
a ``paddle_tpu`` checkpoint (losses within 1e-5, every parameter and
velocity within 1e-5 of its largest magnitude) and its detections after
that step (labels equal, scores and boxes within 1e-5); and
``DetectionMAP`` over the same detections, 11-point and integral,
within 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import evaluator as ref_evaluator
from paddle_tpu import io as ref_io
from paddle_tpu.ops import detection_ops as ref_det
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import evaluator as port_evaluator
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch.ops import detection_ops as port_det
from paddle_tpu_torch.probes.op_cases import (TAIL_CASES, TAIL_FAMILIES,
                                              Case)
from test_torch_image_models import (_ssd, numpy_startup, ssd_feed,
                                     state_errors)
from test_torch_ops_cases import (assert_outputs_match, rel_err, run_port,
                                  run_ref)
from test_torch_ops_grad import grads
from test_torch_ops_shapes import _infer
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

GRAD_RTOL = 1e-5
STEP_RTOL = 1e-5
MAP_ATOL = 1e-12
CASES = [c for c in TAIL_CASES if c.op_type in TAIL_FAMILIES["detection"]]
MULTIBOX = next(c for c in CASES if c.op_type == "multibox_loss")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_forward_matches_reference(case):
    assert_outputs_match(run_port(case), run_ref(case, jit=True), case.tol, case.id)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_build_time_shapes_match_reference(case):
    inputs = case.inputs()
    assert _infer("port", case, inputs, False) == \
        _infer("ref", case, inputs, False)


def test_multibox_loss_gradient_matches_reference():
    want, got = grads(MULTIBOX, jit=True)
    assert any(np.abs(w).max() for w in want)
    for w, g in zip(want, got):
        assert rel_err(g, w) <= GRAD_RTOL, rel_err(g, w)


def _shared_best_prior():
    """Priors where boxes 0 and 2 of image 0 have the same best prior (2);
    box 1 a prior of its own; image 1 with one valid box and padding."""
    priors = np.array([[0.0, 0.0, 0.2, 0.2], [0.5, 0.5, 0.9, 0.9],
                       [0.3, 0.3, 0.5, 0.5], [0.6, 0.0, 0.9, 0.3]],
                      np.float32)
    gt = np.array([[[0.31, 0.3, 0.5, 0.5], [0.6, 0.02, 0.9, 0.3],
                    [0.3, 0.31, 0.5, 0.52]],
                   [[0.0, 0.0, 0.21, 0.2], [0.3, 0.3, 0.5, 0.5],
                    [0.3, 0.3, 0.5, 0.5]]], np.float32)
    count = np.array([3, 1], np.int32)
    return priors, gt, count


def test_shared_best_prior_goes_to_the_higher_box():
    priors, gt, count = _shared_best_prior()
    valid = np.arange(3)[None, :] < count[:, None]
    want = []
    for i in range(2):
        iou = ref_det._iou_matrix(jnp.asarray(priors), jnp.asarray(gt[i]))
        assert int(np.argmax(np.asarray(iou)[:, 0])) == 2 or i
        want.append(np.asarray(ref_det._match(iou, jnp.asarray(valid[i]),
                                              0.5)))
    got = port_det.match(
        port_det.iou_matrix(torch.from_numpy(priors).expand(2, -1, -1),
                            torch.from_numpy(gt)),
        torch.from_numpy(valid), 0.5)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    assert got[0, 2] == 2
    # and the loss over it, with its gradient
    rs = np.random.RandomState(3)
    case = Case("multibox_loss", lambda _: {
        "Loc": 0.5 * rs.standard_normal((2, 4, 4)).astype(np.float32),
        "Conf": rs.standard_normal((2, 4, 3)).astype(np.float32),
        "PriorBox": priors, "PriorBoxVar": np.full((4, 4), 0.1, np.float32),
        "GtBox": gt, "GtLabel": np.array([[1, 2, 1], [2, 0, 0]], np.int32),
        "GtCount": count}, MULTIBOX.attrs, name="shared")
    inputs = case.inputs()
    assert_outputs_match(run_port(case, inputs), run_ref(case, inputs, jit=True),
                         MULTIBOX.tol)


def test_hard_negatives_among_equal_losses():
    """All confidence logits equal: every negative's loss ties, and the
    lower prior indices are mined, with their gradient."""
    inputs = MULTIBOX.inputs()
    inputs["Conf"] = np.zeros_like(inputs["Conf"])
    case = Case("multibox_loss", lambda _: inputs, MULTIBOX.attrs,
                name="ties")
    assert_outputs_match(run_port(case), run_ref(case, jit=True), MULTIBOX.tol)
    want, got = grads(case, jit=True)
    for w, g in zip(want, got):
        assert rel_err(g, w) <= GRAD_RTOL, rel_err(g, w)


def test_nms_and_top_k_among_tied_scores():
    """Scores equal within each class: the candidates are the lowest
    prior indices, NMS visits them in index order, and the final top-k
    keeps the lowest index first."""
    base = next(c for c in CASES if c.op_type == "detection_output")
    inputs = base.inputs()
    n, p, c = inputs["Scores"].shape
    inputs["Scores"] = np.broadcast_to(
        np.array([0.1, 0.3, 0.3, 0.3], np.float32), (n, p, c)).copy()
    case = Case("detection_output", lambda _: inputs, base.attrs,
                name="tied")
    port, ref = run_port(case)["Out"][0], run_ref(case, jit=True)["Out"][0]
    # labels and scores exact, the decoded boxes within the case's
    # tolerance
    np.testing.assert_array_equal(port[..., :2], ref[..., :2])
    assert rel_err(port[..., 2:], ref[..., 2:]) <= base.tol
    assert (port[..., 0] >= 0).sum() > 0


@pytest.fixture(scope="module")
def ssd_step(tmp_path_factory):
    """One step of ssd_net at 64² (21 classes, batch 2) in each package
    from the reference's checkpoint (``numpy_startup``), then each
    package's detections on other images from its trained scope."""
    d = str(tmp_path_factory.mktemp("ssd"))
    rs = np.random.RandomState(11)
    feed = ssd_feed(2, 64, rs)
    images = {"img": rs.rand(2, 3, 64, 64).astype(np.float32)}
    main, startup, loss = _ssd("ref", 64)
    infer, _, dets = _ssd("ref", 64, "infer")
    exe, scope = ptpu.Executor(), ptpu.Scope()
    with ptpu.scope_guard(scope):
        numpy_startup(startup, scope)
        ref_io.save_persistables(exe, d, main_program=main)
        want = float(np.asarray(exe.run(main, feed=feed,
                                        fetch_list=[loss])[0]).ravel()[0])
        want_dets = np.asarray(exe.run(infer, feed=images,
                                       fetch_list=[dets])[0])
    pmain, _, ploss = _ssd("port", 64)
    pinfer, _, pdets = _ssd("port", 64, "infer")
    pexe, pscope = pc.Executor(device="cpu"), pc.Scope()
    port_io.load_persistables(pexe, d, main_program=pmain, scope=pscope)
    got = float(np.asarray(pexe.run(pmain, feed=feed, fetch_list=[ploss],
                                    scope=pscope)[0]).ravel()[0])
    got_dets = pexe.run(pinfer, feed=images, fetch_list=[pdets],
                        scope=pscope)[0]
    return dict(want=want, got=got, scope=scope, pscope=pscope, pmain=pmain,
                want_dets=want_dets, got_dets=got_dets, feed=feed)


def test_ssd_momentum_step_from_a_reference_checkpoint(ssd_step):
    s = ssd_step
    assert abs(s["got"] - s["want"]) <= STEP_RTOL * abs(s["want"])
    errs = state_errors(s["scope"], s["pscope"], s["pmain"])
    bad = {n: e for n, e in errs.items() if e > STEP_RTOL}
    assert not bad, bad


def test_ssd_detections_after_the_step(ssd_step):
    want, got = ssd_step["want_dets"], ssd_step["got_dets"]
    assert got.shape == want.shape == (2, 16, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    assert (want[..., 0] >= 1).any()
    assert rel_err(got[..., 1:], want[..., 1:]) <= STEP_RTOL


@pytest.mark.parametrize("ap_version", ["11point", "integral"])
def test_detection_map_matches_reference(ssd_step, ap_version):
    """Both evaluators over the same stream: the reference's detections
    against their ground truth, then detections that hit it (boxes of
    the truth, shuffled scores, some labels wrong)."""
    rs = np.random.RandomState(4)
    feed = ssd_step["feed"]
    hits = np.full((2, 6, 6), -1.0, np.float32)
    for i in range(2):
        for g in range(int(feed["gc"][i])):
            hits[i, g] = [feed["gl"][i, g] if rs.rand() > 0.3 else 5,
                          rs.rand(), *feed["gb"][i, g]]
    maps = []
    for ev_mod in (ref_evaluator, port_evaluator):
        ev = ev_mod.DetectionMAP(21, ap_version=ap_version)
        for dets in (ssd_step["want_dets"], hits):
            ev.update(dets, feed["gb"], feed["gl"], feed["gc"])
        maps.append(ev.eval())
    assert abs(maps[0] - maps[1]) <= MAP_ATOL, maps
    assert maps[0] > 0
