"""The seq2seq NMT with attention, BASELINE config 4 (``models/seq2seq.py``
in both packages; ``bench.py``'s ``bench_seq2seq`` recipe at a small
width): the port builds the reference's programs byte for byte; 3 Adam
steps from the reference's startup weights give its losses within 1e-4
and its parameters within 2 lr a step; greedy and beam decoding from the
trained scope give the reference's tokens exactly; beam width 1 is
greedy; and a scope the reference trained crosses through the
checkpoint format (``params.npz`` + ``params.meta.json``) and computes
the reference's loss. Feeds from seeded numpy."""

import json

import numpy as np
import pytest

import paddle_tpu as ptpu
from paddle_tpu import io as ref_io
from paddle_tpu import layers as ref_layers
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu.models import seq2seq as ref_s2s
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.models import seq2seq as port_s2s
from paddle_tpu_torch.probes.op_cases import RNN_CASES, RNN_FAMILIES
from test_torch_ops_cases import (assert_outputs_match, rel_err, run_port,
                                  run_ref)
from test_torch_ops_cases import one_thread  # noqa: F401
from test_torch_ops_shapes import _infer
from test_torch_ops_grad import grads

B, T, V, EMB, HID = 4, 6, 40, 8, 16
LR = 1e-3
STEPS = 3
LOSS_RTOL = 1e-4
GEN = 7


pytestmark = pytest.mark.usefixtures("one_thread")


DECODER_CASES = [c for c in RNN_CASES
                 if c.op_type in RNN_FAMILIES["seq2seq"]]


@pytest.mark.parametrize("case", DECODER_CASES, ids=lambda c: c.id)
def test_decoder_ops_match_reference(case):
    """The teacher-forced decoder (its vocabulary projection taken out of
    the loop), greedy and beam decoding, on ``probes/op_cases.py``'s
    cases: logits within 1e-5 of max|ref|, tokens exact; the decoder's
    gradients within 1e-4; the build-time shapes."""
    assert_outputs_match(run_port(case), run_ref(case), case.tol, case.id)
    if case.grad:
        want, got = grads(case)
        for w, g in zip(want, got):
            if np.abs(w).max() or np.abs(g).max():
                assert rel_err(g, w) <= 1e-4, (case.id, rel_err(g, w))
    inputs = case.inputs()
    assert _infer("port", case, inputs, False) == \
        _infer("ref", case, inputs, False)


def _program(pkg, mode="train", beam_size=4):
    fw, L, model, opt = (ptpu, ref_layers, ref_s2s, ptpu.optimizer) \
        if pkg == "ref" else (pc, port_layers, port_s2s, port_opt)
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 3
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        src = L.data("src", shape=[T], dtype="int64")
        slen = L.data("src_len", shape=[], dtype="int64")
        trg = L.data("trg", shape=[T], dtype="int64")
        tlen = L.data("trg_len", shape=[], dtype="int64")
        lbl = L.data("lbl", shape=[T], dtype="int64")
        out = model.seq2seq_attention(
            src, slen, trg, tlen, lbl, src_vocab=V, trg_vocab=V,
            emb_dim=EMB, hid_dim=HID, mode=mode, max_gen_len=GEN,
            beam_size=beam_size)
        if mode == "train":
            opt.Adam(learning_rate=LR).minimize(out[0], startup)
    return main, startup, out


def _feeds(n, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        out.append({
            "src": rs.randint(2, V, (B, T)).astype(np.int32),
            "trg": rs.randint(2, V, (B, T)).astype(np.int32),
            "lbl": rs.randint(2, V, (B, T)).astype(np.int32),
            "src_len": np.array([T, T - 2, 3, 1], np.int32),
            "trg_len": np.array([T, 4, T - 1, 2], np.int32)})
    return out


@pytest.fixture(scope="module")
def trained():
    """The reference's startup weights, its 3 Adam steps' losses and its
    scope after them."""
    main, startup, (loss, _) = _program("ref")
    scope = ptpu.Scope()
    exe = ptpu.Executor()
    exe.run(startup, scope=scope)
    init = {n: np.array(scope.find_var(n)) for n in scope.var_names()}
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in _feeds(STEPS)]
    after = {n: np.array(scope.find_var(n)) for n in scope.var_names()}
    return init, losses, after


@pytest.mark.parametrize("mode", ["train", "greedy", "beam"])
def test_programs_are_the_references(mode):
    for which in (0, 1):
        ref = json.dumps(ref_ser.program_to_dict(_program("ref", mode)
                                                 [which]))
        port = json.dumps(port_ser.program_to_dict(_program("port", mode)
                                                   [which]))
        assert port == ref, (mode, which)


def test_three_adam_steps_match_the_reference(trained):
    init, want, after = trained
    main, _, (loss, _) = _program("port")
    exe = pc.Executor(device="cpu")
    scope = port_io.scope_from_jax(init, device="cpu")
    got = [float(exe.run(main, feed=f, fetch_list=[loss],
                         scope=scope)[0]) for f in _feeds(STEPS)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for name, w in after.items():
        if name.startswith("@") or not np.issubdtype(w.dtype, np.floating):
            continue
        g = scope.find_var(name).numpy()
        assert np.abs(g - w).max() <= 2 * LR * STEPS, name


def _generate(pkg, named, mode, beam_size=4):
    main, _, (ids, length) = _program(pkg, mode, beam_size)
    feed = {k: v for k, v in _feeds(1, seed=5)[0].items()
            if k in ("src", "src_len")}
    # the generation programs read the target placeholders only to size
    # nothing: feed them as the training program does
    feed.update({k: v for k, v in _feeds(1, seed=5)[0].items()
                 if k not in feed})
    if pkg == "ref":
        scope = ptpu.Scope()
        for n, v in named.items():
            scope.set_var(n, np.array(v))
        return ptpu.Executor().run(main, feed=feed, fetch_list=[ids, length],
                                   scope=scope)
    exe = pc.Executor(device="cpu")
    scope = port_io.scope_from_jax(named, device="cpu")
    return exe.run(main, feed=feed, fetch_list=[ids, length], scope=scope)


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_decoded_tokens_are_the_references(trained, mode):
    named = trained[2]
    want = _generate("ref", named, mode)
    got = _generate("port", named, mode)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_beam_width_one_is_greedy(trained):
    named = trained[2]
    greedy = _generate("port", named, "greedy")
    beam1 = _generate("port", named, "beam", beam_size=1)
    np.testing.assert_array_equal(beam1[0], greedy[0])


def test_reference_checkpoint_crosses(trained, tmp_path):
    """A scope the reference trained, saved by its ``save_params``
    (``params.npz`` + ``params.meta.json``), loads into the port and
    computes the reference's loss on a new batch."""
    init, _, _ = trained
    main, startup, (loss, _) = _program("ref")
    exe = ptpu.Executor()
    scope = ptpu.Scope()
    for n, v in init.items():
        scope.set_var(n, np.array(v))
    feeds = _feeds(STEPS + 1, seed=9)
    for f in feeds[:STEPS]:
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    with ptpu.scope_guard(scope):
        ref_io.save_params(exe, str(tmp_path), main_program=main)
    test, _, (tloss, _) = _program("ref")
    want = float(exe.run(test, feed=feeds[-1], fetch_list=[tloss],
                         scope=scope)[0])
    pmain, _, (ploss, _) = _program("port")
    pexe, pscope = pc.Executor(device="cpu"), pc.Scope()
    port_io.load_params(pexe, str(tmp_path), main_program=pmain,
                        scope=pscope)
    # the Adam moments are not parameters: a forward-only program reads
    # the parameters alone
    fwd, _, (floss, _) = _program("port", mode="train")
    got = float(pexe.run(_forward_only(fwd, floss), feed=feeds[-1],
                         fetch_list=[floss], scope=pscope)[0])
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def _forward_only(main, loss):
    """``main`` cut after the op that writes ``loss``."""
    block = main.global_block()
    last = max(i for i, op in enumerate(block.ops)
               if loss.name in op.output_names())
    del block.ops[last + 1:]
    main._version += 1
    return main
