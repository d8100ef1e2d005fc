"""Beam search against the reference (``ops/beam_search_ops.py``,
``layers/beam_search.py`` and ``models/transformer.py``
``transformer_lm_generate`` in both packages): the step and decode ops
on the cases of ``probes/op_cases.py``; the tie rule (equal scores
lowest index first, as ``lax.top_k``; a stable final ranking); a
``BeamSearchDecoder`` over a GRU step; and ``transformer_lm_generate``
in beam and sample modes, whose tokens equal the reference's exactly
and, at beam 1 and sampled, a KV-cached ``GenerationSession``'s from
``[bos]`` on the same weights (the reference's own parities). Its step
sub-block keeps a token history whose column past the end is dropped at
the last step."""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import layers as ref_layers
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu.models import transformer as ref_tf
from paddle_tpu.ops import beam_search_ops as ref_bs
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.models import transformer as port_tf
from paddle_tpu_torch.ops import beam_search_ops as port_bs
from paddle_tpu_torch.probes.op_cases import RNN_CASES, RNN_FAMILIES
from paddle_tpu_torch.serving import GenerationSession
from paddle_tpu_torch.serving.decoding import DecodePolicy
from test_torch_ops_cases import assert_outputs_match, run_port, run_ref
from test_torch_ops_cases import one_thread  # noqa: F401
from test_torch_ops_shapes import _infer
V, MAXLEN = 29, 12
KW = dict(d_model=16, num_heads=2, d_ff=32, num_layers=2)
BOS, EOS = 0, 1
SEED, TEMP, TOPK = 20260807, 0.9, 6

CASES = [c for c in RNN_CASES if c.op_type in RNN_FAMILIES["beam"]]


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_beam_ops_match_reference(case):
    assert_outputs_match(run_port(case), run_ref(case), case.tol, case.id)

@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_build_time_shapes_match_reference(case):
    inputs = case.inputs()
    assert _infer("port", case, inputs, False) == \
        _infer("ref", case, inputs, False)


def test_ties_take_the_lowest_index_first():
    """Equal candidates: the lowest flat index wins, as ``lax.top_k``; a
    frozen beam's non-EOS tokens all tie at NEG_INF; equal normalized
    scores keep the beams' order."""
    import jax.numpy as jnp
    scores = np.array([[0.0, -1.0, -1.0]], np.float32)
    logp = np.log(np.full((3, 5), 0.2, np.float32))
    done = np.array([[False, False, True]])
    want = ref_bs.beam_step(jnp.asarray(scores), jnp.asarray(logp),
                            jnp.asarray(done), 1)
    got = port_bs.beam_step(torch.from_numpy(scores),
                            torch.from_numpy(logp), torch.from_numpy(done),
                            1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    seqs = np.array([[[2, 1, 1], [3, 1, 1], [4, 5, 1]]], np.int32)
    norm = np.array([[-2.0, -2.0, -4.0]], np.float32)
    want = ref_bs._finalize(jnp.asarray(seqs), jnp.asarray(norm), 1, "avg")
    got = port_bs.finalize(torch.from_numpy(seqs), torch.from_numpy(norm),
                           1, "avg")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _gru_decoder(pkg, beam_size):
    """A GRU step under BeamSearchDecoder: embedding, gru_unit, fc."""
    fw, L = (ptpu, ref_layers) if pkg == "ref" else (pc, port_layers)
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 4
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        h0 = L.data("h0", shape=[6])
        bs = L.BeamSearchDecoder(beam_size=beam_size, max_len=5,
                                 bos_id=BOS, eos_id=EOS)
        with bs.step():
            tok = bs.token()
            h_prev = bs.state(h0)
            emb = L.embedding(tok, size=[11, 6], param_attr="gd.emb")
            proj = L.fc(emb, 18, param_attr="gd.proj")
            h, _, _ = L.gru_unit(proj, h_prev, 6, param_attr="gd.w",
                                 bias_attr="gd.b")
            bs.update_state(h_prev, h)
            bs.set_logits(L.fc(h, 11, param_attr="gd.out"))
        outs = bs(return_all_beams=True)
    return main, startup, outs


@pytest.mark.parametrize("beam_size", [1, 3])
def test_gru_beam_search_decoder_matches_reference(beam_size):
    ref_main, ref_start, ref_outs = _gru_decoder("ref", beam_size)
    main, _, outs = _gru_decoder("port", beam_size)
    assert json.dumps(port_ser.program_to_dict(main)) == \
        json.dumps(ref_ser.program_to_dict(ref_main))
    scope = ptpu.Scope()
    exe = ptpu.Executor()
    exe.run(ref_start, scope=scope)
    rs = np.random.RandomState(2)
    for n in sorted(scope.var_names()):
        cur = np.asarray(scope.find_var(n))
        scope.set_var(n, rs.standard_normal(cur.shape).astype(cur.dtype))
    named = {n: np.array(scope.find_var(n)) for n in scope.var_names()}
    feed = {"h0": rs.standard_normal((3, 6)).astype(np.float32)}
    want = exe.run(ref_main, feed=feed, fetch_list=list(ref_outs),
                   scope=scope)
    got = pc.Executor(device="cpu").run(
        main, feed=feed, fetch_list=list(outs),
        scope=port_io.scope_from_jax(named, device="cpu"))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)


def _generate_program(pkg, **kw):
    fw, L, tf = (ptpu, ref_layers, ref_tf) if pkg == "ref" else \
        (pc, port_layers, port_tf)
    main, startup = fw.Program(), fw.Program()
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        anchor = L.data("anchor", shape=[1], dtype="int32")
        outs = tf.transformer_lm_generate(
            anchor, vocab_size=V, max_len=MAXLEN, bos_id=BOS, eos_id=EOS,
            **dict(KW, **kw))
    return main, startup, outs


@pytest.fixture(scope="module")
def lm_weights():
    """The reference's generation program's weights, redrawn as the
    reference's parity test draws them."""
    _, startup, _ = _generate_program("ref", beam_size=1)
    scope = ptpu.Scope()
    ptpu.Executor().run(startup, scope=scope)
    rs = np.random.RandomState(7)
    return {n: rs.standard_normal(np.asarray(scope.find_var(n)).shape)
            .astype(np.asarray(scope.find_var(n)).dtype)
            for n in sorted(scope.var_names())}


def _run_generate(pkg, named, batch=1, **kw):
    main, _, outs = _generate_program(pkg, **kw)
    feed = {"anchor": np.zeros((batch, 1), np.int32)}
    if pkg == "ref":
        scope = ptpu.Scope()
        for n, v in named.items():
            scope.set_var(n, np.array(v))
        return ptpu.Executor().run(main, feed=feed, fetch_list=list(outs),
                                   scope=scope)
    return pc.Executor(device="cpu").run(
        main, feed=feed, fetch_list=list(outs),
        scope=port_io.scope_from_jax(named, device="cpu"))


GEN_MODES = {
    "beam1": dict(beam_size=1),
    "beam4-all": dict(beam_size=4, return_all_beams=True),
    "sample": dict(decode="sample", sample_seed=SEED, temperature=TEMP,
                   top_k=TOPK),
}


@pytest.mark.parametrize("mode", list(GEN_MODES))
def test_transformer_lm_generate_matches_reference(lm_weights, mode):
    kw = GEN_MODES[mode]
    want = _run_generate("ref", lm_weights, batch=2, **kw)
    got = _run_generate("port", lm_weights, batch=2, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["beam1", "sample"])
def test_cached_session_equals_the_uncached_generation(lm_weights, mode):
    """From ``[bos]``, the KV-cached session (greedy, or sampling with the
    same seed and knobs) emits the uncached generation's tokens."""
    ids, lengths, _ = _run_generate("port", lm_weights, **GEN_MODES[mode])
    want = [int(t) for t in ids[0][:int(lengths[0])]]
    pol = DecodePolicy(kind="sample", temperature=TEMP, top_k=TOPK) \
        if mode == "sample" else None
    spec = port_tf.transformer_lm_session(
        V, max_len=MAXLEN, slots=3, cache_len=16, prompt_buckets=(4, 8),
        bos_id=BOS, eos_id=EOS, decode_policy=pol, device="cpu", **KW)
    sess = GenerationSession(spec, port_io.scope_from_jax(lm_weights,
                                                          device="cpu"))
    try:
        got = [int(t) for t in sess.generate(
            [BOS], max_new_tokens=MAXLEN,
            seed=SEED if mode == "sample" else 0)]
    finally:
        sess.close()
    assert got == want
