"""The same prompts through the reference's GenerationSession and the
port's, over the same weights: the reference's scope is saved with
``paddle_tpu.io.save_params`` and read back by
``paddle_tpu_torch.io.load_params``.

Tolerances: greedy tokens must be identical; prefill and decode logits
agree within atol = rtol = 1e-4 (float32 through two layers, norms and
an FFN, with sums taken in another order; the reference runs its f32
matmuls at ``highest`` precision under the test config)."""

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import layers
from paddle_tpu.models.transformer import (transformer_lm,
                                           transformer_lm_session)
from paddle_tpu.serving import GenerationSession
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch.models import transformer as port_tf
from paddle_tpu_torch.ops import flash_attention as port_attn
from paddle_tpu_torch.serving import generation as port_gen

V, MAXLEN = 29, 16
KW = dict(d_model=32, num_heads=2, d_ff=64, num_layers=2)
BOS, EOS = 0, 1
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
PROMPTS = ([BOS], [BOS, 5, 7], [2, 3, 4, 5, 6], [9, 8, 7, 6, 5, 4, 3, 2, 11])


@pytest.fixture(autouse=True)
def _flash_on():
    prev = ptpu.config.get_flag("flash_attention")
    ptpu.config.set_flags(flash_attention=True)
    yield
    ptpu.config.set_flags(flash_attention=prev)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Randomized LM weights in a reference scope (as
    tests/test_generation.py builds it), saved and read back by the port:
    (scope, {name: np.ndarray})."""
    with ptpu.unique_name.guard():
        main, startup = ptpu.Program(), ptpu.Program()
        with ptpu.program_guard(main, startup):
            toks = layers.data("toks", shape=[1, MAXLEN], dtype="int64",
                               append_batch_size=False)
            lbls = layers.data("lbls", shape=[1, MAXLEN], dtype="int64",
                               append_batch_size=False)
            transformer_lm(toks, lbls, vocab_size=V, is_test=True, **KW)
    exe = ptpu.Executor()
    scope = ptpu.Scope()
    with ptpu.scope_guard(scope):
        exe.run(startup)
    rs = np.random.RandomState(7)
    for n in sorted(scope.var_names()):
        cur = np.asarray(scope.find_var(n))
        scope.set_var(n, rs.standard_normal(cur.shape).astype(cur.dtype))
    d = str(tmp_path_factory.mktemp("lm_params"))
    ptpu.io.save_params(exe, d, main_program=main, scope=scope)
    return scope, port_io.load_params(d)


def _ref_session(scope, slots=3, prompt_buckets=(4, 8, 16)):
    spec = transformer_lm_session(V, max_len=MAXLEN, slots=slots,
                                  cache_len=MAXLEN,
                                  prompt_buckets=prompt_buckets,
                                  bos_id=BOS, eos_id=EOS, **KW)
    return GenerationSession(spec, scope=scope)


def _port_session(named, slots=3, prompt_buckets=(4, 8, 16)):
    spec = port_tf.transformer_lm_session(
        V, max_len=MAXLEN, slots=slots, cache_len=MAXLEN,
        prompt_buckets=prompt_buckets, eos_id=EOS, device="cpu", **KW)
    return port_gen.GenerationSession(
        spec, port_io.params_from_jax(named, device="cpu"))


def test_load_params_reads_every_parameter(weights):
    scope, named = weights
    assert sorted(named) == sorted(port_tf.lm_param_names(2))
    for name, val in named.items():
        np.testing.assert_array_equal(val, np.asarray(scope.find_var(name)))


def test_greedy_tokens_identical(weights):
    scope, named = weights
    ref, port = _ref_session(scope), _port_session(named)
    outs = []
    for prompt in PROMPTS:
        want = [int(t) for t in ref.generate(prompt)]
        got = port.generate(prompt)
        assert got == want, prompt
        outs.append(tuple(got))
    # prompt-dependent output: an attractor token cannot fake parity
    assert len(set(outs)) == len(outs)
    assert port_attn.flash_attention.launches == 0   # CPU: plain versions
    assert port_attn.decode_attention.launches == 0


def _argmax_input(program):
    """Name of the logits row the reference program's argmax reads."""
    for op in program.global_block().ops:
        if op.type == "arg_max":
            return op.inputs["X"][0]
    raise AssertionError("no argmax op")


def test_prefill_and_decode_logits_match(weights):
    """Drive both models slot by slot: prefill two prompts into slots
    0 and 1, then decode all slots together, comparing logits."""
    scope, named = weights
    ref = _ref_session(scope)
    spec = ref.spec
    port = _port_session(named).model
    tokens = {}
    for slot, prompt in enumerate(([BOS, 5, 7], [2, 3, 4, 5, 6, 7, 8, 9, 3])):
        n = len(prompt)
        bucket = ref.prompt_bucket(n)
        padded = np.full((1, bucket), EOS, np.int64)
        padded[0, :n] = prompt
        prog = spec.prefill_programs[bucket]
        f_tok, f_len, f_pos, f_slot = spec.prefill_feeds[:4]
        want, = ref.exe.run(
            prog, feed={f_tok: padded, f_len: np.array([n], np.int32),
                        f_pos: np.array([n - 1], np.int32),
                        f_slot: np.array([slot], np.int32)},
            fetch_list=[_argmax_input(prog)], scope=ref.scope)
        got = port.prefill(torch.from_numpy(padded), n, slot)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
        tokens[slot] = int(np.argmax(want))
        assert int(got.argmax()) == tokens[slot]
    lengths = np.array([3, 9, 0], np.int32)
    last = np.array([tokens[0], tokens[1], 0], np.int64)
    f_tok, f_pos = spec.decode_feeds[:2]
    for _ in range(4):
        want, = ref.exe.run(
            spec.decode_program,
            feed={f_tok: last.reshape(-1, 1), f_pos: lengths},
            fetch_list=[_argmax_input(spec.decode_program)],
            scope=ref.scope)
        got = port.decode(torch.from_numpy(last.reshape(-1, 1)),
                          torch.from_numpy(lengths))
        # slot 2 is free: its row is masked garbage on both sides
        np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2],
                                   **LOGIT_TOL)
        last[:2] = np.asarray(want)[:2].argmax(-1)
        assert (got.numpy()[:2].argmax(-1) == last[:2]).all()
        lengths[:2] += 1


def _mid_flight(sess):
    """Admit, step, admit mid-decode, retire mid-flight, reuse the slot
    (the sequence of tests/test_generation.py's no-flush test)."""
    sA, tA = sess.admit([BOS])
    toks = {"A": [tA]}
    for _ in range(2):
        toks["A"].append(sess.step()[sA])
    sB, tB = sess.admit([2, 3])
    toks["B"] = [tB]
    for _ in range(3):
        step = sess.step()
        toks["A"].append(step[sA])
        toks["B"].append(step[sB])
    sess.retire(sA)
    sC, tC = sess.admit([4, 5, 6, 7, 8])
    toks["C"] = [tC]
    for _ in range(3):
        step = sess.step()
        toks["B"].append(step[sB])
        toks["C"].append(step[sC])
    return sA, sC, {k: [int(t) for t in v] for k, v in toks.items()}


def test_mid_flight_admit_and_retire_identical(weights):
    scope, named = weights
    ref_a, ref_c, want = _mid_flight(_ref_session(scope, slots=2))
    port_a, port_c, got = _mid_flight(_port_session(named, slots=2))
    assert (port_a, port_c) == (ref_a, ref_c)
    assert port_c == port_a          # the retired slot was reused
    assert got == want


def test_scheduler_concurrent_requests_match_solo(weights):
    _, named = weights
    solo_sess = _port_session(named)
    prompts = PROMPTS[1:]
    solo = {tuple(p): solo_sess.generate(p, max_new_tokens=6, eos_id=-1)
            for p in prompts}
    sched = port_gen.GenerationScheduler(_port_session(named, slots=2))
    try:
        futs = {tuple(p): sched.submit(p, max_new_tokens=6, eos_id=-1)
                for p in prompts}
        for p, fut in futs.items():
            got = [int(t) for t in fut.result(timeout=60)]
            assert got == solo[p], p
    finally:
        sched.close()


def test_scheduler_drain_and_close(weights):
    _, named = weights
    sched = port_gen.GenerationScheduler(_port_session(named, slots=1),
                                         autostart=False)
    futs = [sched.submit([BOS], max_new_tokens=3) for _ in range(3)]
    sched.start()
    sched.drain()
    for fut in futs:
        assert 1 <= len(fut.result(timeout=1)) <= 3
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit([BOS])
    sched = port_gen.GenerationScheduler(_port_session(named, slots=1),
                                         autostart=False)
    fut = sched.submit([BOS], max_new_tokens=2)
    sched.close()
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=1)


def test_scheduler_backpressure_and_deadline(weights):
    _, named = weights
    sched = port_gen.GenerationScheduler(_port_session(named, slots=1),
                                         max_queue=1, autostart=False)
    sched.submit([BOS])
    with pytest.raises(port_gen.ServingOverloadError):
        sched.submit([BOS], timeout=0.01)
    with pytest.raises(port_gen.ServingDeadlineError):
        sched.submit([BOS], deadline_ms=-5)
    sched.close()


def test_flag_names_and_defaults_match_reference():
    from paddle_tpu_torch import config as port_config
    for name in ("generation_slots", "generation_cache_buckets",
                 "generation_prompt_buckets", "serving_deadline_ms"):
        assert port_config.get_flag(name) == ptpu.config.get_flag(name)
    spec = port_tf.transformer_lm_session(V, max_len=MAXLEN, device="cpu",
                                          **KW)
    assert (spec.slots, spec.cache_len, spec.prompt_buckets) == \
        (4, 128, (MAXLEN,))   # bucket 16 capped at max_len, as reference
    with pytest.raises(KeyError, match="unknown flag"):
        port_config.set_flags(flash_attention=True)
