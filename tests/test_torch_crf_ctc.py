"""The structured-prediction ops against the reference
(``ops/crf_ctc_ops.py`` and ``layers/nn.py``'s CRF and CTC layers in
both packages): the linear-chain CRF's cost and Viterbi path, the CTC
loss, ``ctc_align`` and the edit distance on the cases of
``probes/op_cases.py`` (costs within 1e-5 of max|ref| and their
gradients within 1e-4; paths, alignments and distances exact); the edit
distance's row-at-once recurrence against a plain Levenshtein table on a
seeded batch of ragged sequences; the layers' programs byte for byte,
and a CRF tagger and a CTC model trained 3 Adam steps from the
reference's startup weights to its losses."""

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
from paddle_tpu_torch.probes.op_cases import RNN_CASES, RNN_FAMILIES, Case
from test_torch_ops_cases import (assert_outputs_match, rel_err, run_port,
                                  run_ref)
from test_torch_ops_cases import one_thread  # noqa: F401
from test_torch_ops_shapes import _infer
from test_torch_ops_grad import grads

GRAD_RTOL = 1e-4
LR = 1e-2
STEPS = 3
CASES = [c for c in RNN_CASES if c.op_type in RNN_FAMILIES["crf_ctc"]]


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
            assert rel_err(g, w) <= GRAD_RTOL, (case.id, rel_err(g, w))

@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_build_time_shapes_match_reference(case):
    inputs = case.inputs()
    assert _infer("port", case, inputs, False) == \
        _infer("ref", case, inputs, False)


def _levenshtein(a, b):
    d = np.arange(len(b) + 1, dtype=np.float64)
    for i, x in enumerate(a, 1):
        prev, d[0] = d[0], i
        for j, y in enumerate(b, 1):
            prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1, prev + (x != y))
    return d[-1]


@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance_is_levenshtein(normalized):
    rs = np.random.RandomState(11)
    n, t1, t2 = 16, 9, 7
    inputs = {"Hyps": rs.randint(0, 3, (n, t1)).astype(np.int32),
              "Refs": rs.randint(0, 3, (n, t2)).astype(np.int32),
              "HypsLength": rs.randint(0, t1 + 1, n).astype(np.int32),
              "RefsLength": rs.randint(0, t2 + 1, n).astype(np.int32)}
    case = Case("edit_distance", lambda rs: inputs,
                {"normalized": normalized})
    got = run_port(case)["Out"][0][:, 0]
    want = np.array([_levenshtein(h[:hl], r[:rl]) for h, r, hl, rl in zip(
        inputs["Hyps"], inputs["Refs"], inputs["HypsLength"],
        inputs["RefsLength"])])
    if normalized:
        want = want / np.maximum(inputs["RefsLength"], 1)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert_outputs_match(run_port(case), run_ref(case), 0.0)


def _tagger(pkg, train=True):
    """An fc emission over embeddings, its CRF cost, Viterbi decoding
    with the trained transition; a CTC head with its greedy decoder and
    edit distance."""
    fw, L, opt = (ptpu, ref_layers, ptpu.optimizer) if pkg == "ref" else \
        (pc, port_layers, port_opt)
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 8
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        words = L.data("words", shape=[7], dtype="int64")
        tags = L.data("tags", shape=[7], dtype="int64")
        length = L.data("len", shape=[], dtype="int64")
        lab = L.data("lab", shape=[3], dtype="int64")
        lab_len = L.data("lab_len", shape=[], dtype="int64")
        emb = L.embedding(words, size=[20, 8])
        em = L.fc(emb, 5, num_flatten_dims=2)
        crf = L.linear_chain_crf(em, tags, length=length,
                                 param_attr="crfw")
        path = L.crf_decoding(em, "crfw", length=length)
        ctc = L.warpctc(em, lab, length, lab_len, blank=0)
        ids, ids_len = L.ctc_greedy_decoder(em, 0, length)
        dist, _ = L.edit_distance(ids, lab, ids_len, lab_len)
        loss = L.elementwise_add(L.mean(crf), L.mean(ctc))
        if train:
            opt.Adam(learning_rate=LR).minimize(loss, startup)
    return main, startup, [loss, path, ids, dist]


def _tagger_feeds(n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"words": rs.randint(0, 20, (4, 7)).astype(np.int32),
             "tags": rs.randint(0, 5, (4, 7)).astype(np.int32),
             "len": np.array([7, 5, 3, 6], np.int32),
             "lab": rs.randint(1, 5, (4, 3)).astype(np.int32),
             "lab_len": np.array([3, 2, 1, 3], np.int32)}
            for _ in range(n)]


def test_crf_and_ctc_models_train_as_the_reference():
    main, startup, fetch = _tagger("ref")
    pmain, pstartup, pfetch = _tagger("port")
    for a, b in ((main, pmain), (startup, pstartup)):
        assert json.dumps(port_ser.program_to_dict(b)) == \
            json.dumps(ref_ser.program_to_dict(a))
    exe, scope = ptpu.Executor(), ptpu.Scope()
    exe.run(startup, scope=scope)
    init = {n: np.array(scope.find_var(n)) for n in scope.var_names()}
    pexe = pc.Executor(device="cpu")
    pscope = port_io.scope_from_jax(init, device="cpu")
    for f in _tagger_feeds(STEPS):
        want = exe.run(main, feed=f, fetch_list=fetch, scope=scope)
        got = pexe.run(pmain, feed=f, fetch_list=pfetch, scope=pscope)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)
