"""The 16 evaluator classes against the reference (``evaluator.py`` in both
packages).

The eight stateful ones (``Accuracy``, ``ChunkEvaluator``, ``Auc``,
``PrecisionRecall``, ``PnPair``, ``EditDistanceEvaluator``,
``SumEvaluator`` and ``ColumnSumEvaluator``, plain and weighted or one
column) in one program, run over the same 3 batches in each package:
``eval()`` within 1e-6 of the reference's, their states persistable
tensors in the scope, and the ``Evaluator`` base's ``reset`` zeroing
them; ``DetectionMAP`` over the same detections, 11-point and integral,
within 1e-12; and the six printers in one training program (the
gradient printer after ``minimize``): each prints the reference's lines,
the ids and values exactly and the gradient within 1e-5 of its largest
element."""

import contextlib
import io
import re

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import evaluator as ref_evaluator
from paddle_tpu import io as ref_io
from paddle_tpu import layers as ref_layers
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import evaluator as port_evaluator
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_opt

EVAL_RTOL = 1e-6
MAP_ATOL = 1e-12
GRAD_RTOL = 1e-5
N, T = 8, 6


def _pkg(pkg):
    return (ptpu, ref_layers, ref_evaluator, ptpu.optimizer) \
        if pkg == "ref" else (pc, port_layers, port_evaluator, port_opt)


def _stateful(pkg):
    """The stateful evaluators over one batch's data layers."""
    fw, L, E, _ = _pkg(pkg)
    main, startup = fw.Program(), fw.Program()
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        probs = L.data("probs", shape=[3])
        label = L.data("label", shape=[1], dtype="int64")
        score = L.data("score", shape=[1])
        query = L.data("query", shape=[1], dtype="int64")
        tags = L.data("tags", shape=[T], dtype="int32")
        gold = L.data("gold", shape=[T], dtype="int32")
        length = L.data("length", shape=[], dtype="int32")
        hyp_len = L.data("hyp_len", shape=[], dtype="int32")
        x = L.data("x", shape=[2])
        w = L.data("w", shape=[1])
        evs = {
            "Accuracy": E.Accuracy(probs, label, k=2),
            "ChunkEvaluator": E.ChunkEvaluator(tags, gold, length, 2),
            "Auc": E.Auc(score, label, num_thresholds=50),
            "PrecisionRecall": E.PrecisionRecall(probs, label, 3),
            "PnPair": E.PnPair(score, label, query),
            "EditDistanceEvaluator": E.EditDistanceEvaluator(
                tags, hyp_len, gold, length),
            "SumEvaluator": E.SumEvaluator(x),
            "SumEvaluator-weighted": E.SumEvaluator(x, weight=w),
            "ColumnSumEvaluator": E.ColumnSumEvaluator(x),
            "ColumnSumEvaluator-col": E.ColumnSumEvaluator(x, col_idx=1),
        }
    return main, startup, evs


def _batches():
    rs = np.random.RandomState(9)
    out = []
    for _ in range(3):
        label = rs.randint(0, 3, (N, 1))
        probs = rs.rand(N, 3).astype(np.float32)
        probs[np.arange(N), label[:, 0]] += rs.rand(N) > 0.4
        out.append({
            "probs": probs, "label": (label > 0).astype(np.int64) +
            (label > 1), "score": rs.rand(N, 1).astype(np.float32),
            "query": rs.randint(0, 3, (N, 1)).astype(np.int64),
            "tags": rs.randint(0, 5, (N, T)).astype(np.int32),
            "gold": rs.randint(0, 5, (N, T)).astype(np.int32),
            "length": rs.randint(1, T + 1, N).astype(np.int32),
            "hyp_len": rs.randint(0, T + 1, N).astype(np.int32),
            "x": rs.randn(N, 2).astype(np.float32),
            "w": rs.rand(N, 1).astype(np.float32)})
    return out


STATEFUL = list(_stateful("port")[2])


@pytest.fixture(scope="module")
def evaluated():
    """Each package's evaluators after the 3 batches: their eval(), the
    port's scope and evaluators."""
    batches = _batches()
    main, startup, evs = _stateful("ref")
    exe, scope = ptpu.Executor(), ptpu.Scope()
    with ptpu.scope_guard(scope):
        exe.run(startup)
        for feed in batches:
            exe.run(main, feed=feed)
        want = {k: ev.eval() for k, ev in evs.items()}
    pmain, pstartup, pevs = _stateful("port")
    pexe, pscope = pc.Executor(device="cpu"), pc.Scope()
    pexe.run(pstartup, scope=pscope)
    for feed in batches:
        pexe.run(pmain, feed=feed, scope=pscope)
    got = {k: ev.eval(scope=pscope) for k, ev in pevs.items()}
    return dict(want=want, got=got, scope=pscope, evs=pevs)


@pytest.mark.parametrize("name", STATEFUL)
def test_stateful_evaluator_matches_reference(evaluated, name):
    want = np.atleast_1d(np.asarray(evaluated["want"][name], np.float64))
    got = np.atleast_1d(np.asarray(evaluated["got"][name], np.float64))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=EVAL_RTOL, atol=1e-12)
    assert np.abs(want).max() > 0
    for var in evaluated["evs"][name].states:
        assert isinstance(evaluated["scope"].find_var(var.name),
                          torch.Tensor)


def test_reset_zeroes_the_states(evaluated):
    scope = evaluated["scope"]
    ev = evaluated["evs"]["Auc"]
    ev.reset(scope=scope)
    for var in ev.states:
        t = scope.find_var(var.name)
        assert isinstance(t, torch.Tensor) and not t.abs().max()
    assert ev.eval(scope=scope) == 0.0


@pytest.mark.parametrize("ap_version", ["11point", "integral"])
def test_detection_map_matches_reference(ap_version):
    rs = np.random.RandomState(2)
    gt = rs.uniform(0, 0.6, (3, 4, 4)).astype(np.float32)
    gt[..., 2:] += 0.3
    labels = rs.randint(1, 4, (3, 4))
    counts = np.array([4, 2, 0])
    maps = []
    for mod in (ref_evaluator, port_evaluator):
        ev = mod.DetectionMAP(4, ap_version=ap_version)
        rs2 = np.random.RandomState(3)
        for _ in range(2):
            dets = np.full((3, 6, 6), -1.0, np.float32)
            for i in range(3):
                for j in range(6):
                    g = rs2.randint(0, 4)
                    dets[i, j] = [labels[i, g] if rs2.rand() > 0.2 else 3,
                                  rs2.rand(), *(gt[i, g] + rs2.uniform(
                                      -0.1, 0.1, 4))]
            ev.update(torch.from_numpy(dets) if mod is port_evaluator
                      else dets, gt, labels, counts)
        maps.append(ev.eval())
    assert abs(maps[0] - maps[1]) <= MAP_ATOL and maps[0] > 0, maps


def _printers(pkg):
    fw, L, E, opt = _pkg(pkg)
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 1
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        x = L.data("x", shape=[3])
        label = L.data("label", shape=[1], dtype="int64")
        ids = L.data("ids", shape=[4], dtype="int64")
        h = L.fc(x, 2, bias_attr=False)
        loss = L.mean(L.square(h))
        opt.SGD(0.1).minimize(loss, startup)
        E.ValuePrinter(x)
        E.GradientPrinter(h)
        E.MaxIdPrinter(x)
        E.MaxFramePrinter(L.reshape(x, [-1, 3, 1]))
        E.SeqTextPrinter(ids)
        E.ClassificationErrorPrinter(x, label)
    return main, startup, loss


PRINTERS = ["value_printer", "gradient_printer", "maxid_printer",
            "maxframe_printer", "seq_text_printer",
            "classification_error_printer"]


@pytest.fixture(scope="module")
def printed(tmp_path_factory):
    """Each package's printed text of one step of the printers' program,
    from the same startup (both print through Python's ``sys.stdout``)."""
    d = str(tmp_path_factory.mktemp("printers"))
    rs = np.random.RandomState(4)
    feed = {"x": rs.randn(2, 3).astype(np.float32),
            "label": np.array([[0], [2]], np.int64),
            "ids": np.array([[3, 4, 1, 0], [2, 1, 0, 0]], np.int64)}
    text = {}
    main, startup, loss = _printers("ref")
    exe, scope = ptpu.Executor(), ptpu.Scope()
    with ptpu.scope_guard(scope), \
            contextlib.redirect_stdout(io.StringIO()) as out:
        exe.run(startup)
        ref_io.save_persistables(exe, d, main_program=main)
        exe.run(main, feed=feed, fetch_list=[loss])
        jax.effects_barrier()
    text["ref"] = out.getvalue()
    main, startup, loss = _printers("port")
    pexe, pscope = pc.Executor(device="cpu"), pc.Scope()
    port_io.load_persistables(pexe, d, main_program=main, scope=pscope)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        pexe.run(main, feed=feed, fetch_list=[loss], scope=pscope)
    text["port"] = out.getvalue()
    return text


def _entry(text, printer):
    """The text a printer printed: from its message to the next one."""
    m = re.search(r"^%s.*?(?=^\w+_printer|\Z)" % printer, text,
                  re.M | re.S)
    assert m, (printer, text)
    return m.group(0)


@pytest.mark.parametrize("printer", PRINTERS)
def test_printer_prints_the_references_line(printed, printer):
    want, got = (_entry(printed[p], printer) for p in ("ref", "port"))
    if printer != "gradient_printer":
        assert got == want
        return
    head = want.split(":")[0]
    assert got.split(":")[0] == head
    nums = [np.array([float(v) for v in re.findall(
        r"-?\d+\.\d*(?:e[-+]\d+)?", t.split(":", 1)[1])])
        for t in (want, got)]
    assert nums[0].size == nums[1].size == 4
    assert np.abs(nums[1] - nums[0]).max() <= \
        GRAD_RTOL * np.abs(nums[0]).max()


def test_seq_text_printer_joins_as_the_reference():
    ids = np.array([[3, 4, 1, 0], [2, 7, 3, 1]], np.int64)
    vocab = ["<pad>", "<eos>", "a", "bear", "walks"]
    want = ref_evaluator.SeqTextPrinter.to_text(ids, vocab)
    assert port_evaluator.SeqTextPrinter.to_text(
        torch.from_numpy(ids), vocab) == want == ["bear walks",
                                                  "a <unk> bear"]
