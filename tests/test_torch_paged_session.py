"""The paged layout with prefix reuse, end to end: the same prompts
through the reference's paged GenerationSession and the port's, over the
same weights (saved with ``paddle_tpu.io.save_params``, read back by
``paddle_tpu_torch.io.load_params``), and through the port's scheduler.

Everything compared here is exact: greedy tokens, the prefill log
(bucket, shared prefix, window), prefix-cache counters, block tables and
the pools' free lists. The reference runs with ``flash_attention`` on
(its Pallas kernels interpreted on the CPU), and also off where the test
says so; the port takes its plain versions on CPU tensors."""

import numpy as np
import pytest

import paddle_tpu as ptpu
from paddle_tpu import layers
from paddle_tpu.models.transformer import (transformer_lm,
                                           transformer_lm_session)
from paddle_tpu.serving import GenerationScheduler, GenerationSession
from paddle_tpu.serving import paged_cache as ref_pc
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch.models import transformer as port_tf
from paddle_tpu_torch.ops import flash_attention as port_fa
from paddle_tpu_torch.serving import generation as port_gen
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

V, MAXLEN, CACHE = 29, 12, 16
KW = dict(d_model=16, num_heads=2, d_ff=32, num_layers=2)
BOS, EOS = 0, 1
BUCKETS, BS = (4, 8), 4
# ragged prompts crossing block edges, then shared prefixes: a repeat
# (reuse capped at n - 1), a partial-tail match and a full-block match
PROMPTS = ([BOS], [BOS, 5, 7], [2, 3, 4, 5], [2, 3, 4, 5, 6],
           [2, 3, 4, 5, 6, 7, 8], [2, 3, 4, 5, 6, 7, 8], [2, 3, 4, 5, 6, 9],
           [2, 3, 4, 5, 11])


@pytest.fixture(autouse=True)
def _flash_on():
    prev = ptpu.config.get_flag("flash_attention")
    ptpu.config.set_flags(flash_attention=True)
    yield
    ptpu.config.set_flags(flash_attention=prev)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Randomized LM weights in a reference scope, saved and read back by
    the port: (scope, {name: np.ndarray})."""
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


def _ref_session(scope, slots=3, num_blocks=None, prefix_cache=True,
                 buckets=BUCKETS):
    spec = transformer_lm_session(
        V, max_len=MAXLEN, slots=slots, cache_len=CACHE,
        prompt_buckets=buckets, bos_id=BOS, eos_id=EOS, paged=True,
        block_size=BS, num_blocks=num_blocks, prefix_cache=prefix_cache,
        **KW)
    return GenerationSession(spec, scope=scope)


def _port_session(named, slots=3, num_blocks=None, prefix_cache=True,
                  paged=True, buckets=BUCKETS):
    spec = port_tf.transformer_lm_session(
        V, max_len=MAXLEN, slots=slots, cache_len=CACHE,
        prompt_buckets=buckets, eos_id=EOS, device="cpu", paged=paged,
        block_size=BS, num_blocks=num_blocks, prefix_cache=prefix_cache,
        **KW)
    return port_gen.GenerationSession(
        spec, port_io.params_from_jax(named, device="cpu"))


def _books(sess):
    """The pool's free list and refcounts, the prefix index's LRU."""
    return (list(sess.pool._free),
            [sess.pool.refcount(b) for b in range(sess.pool.num_blocks)],
            None if sess.prefix is None else list(sess.prefix._lru))


def _ref_stats(sess):
    return {k: sess.prefix_stats()[k]
            for k in ("hits", "misses", "shared_tokens", "entries")}


def _cows():
    return ref_pc.BLOCK_COWS._default().value


@pytest.mark.parametrize("flash", [False, True])
def test_greedy_tokens_prefill_log_and_books_identical(weights, flash):
    """Acceptance: paged greedy tokens equal the reference's (its flag on
    and off) and the port's dense session's; the prefill log, prefix
    counters, copy-on-write count and pool books are identical."""
    ptpu.config.set_flags(flash_attention=flash)
    scope, named = weights
    ref, port = _ref_session(scope), _port_session(named)
    dense = _port_session(named, paged=False)
    cows0 = _cows()
    outs = []
    for prompt in PROMPTS:
        want = [int(t) for t in ref.generate(prompt)]
        got = port.generate(prompt)
        assert got == want, prompt
        assert dense.generate(prompt) == want, prompt
        assert _books(port) == _books(ref), prompt
        outs.append(tuple(got))
    assert len(set(outs)) > 3          # prompt-dependent outputs
    assert port.prefill_log == ref.prefill_log
    assert [h for _, h, _ in port.prefill_log] == [0, 1, 0, 4, 5, 6, 5, 4]
    stats = port.prefix_stats()
    assert {k: stats[k] for k in _ref_stats(ref)} == _ref_stats(ref)
    assert stats["cows"] == _cows() - cows0 > 0
    assert port_fa.decode_attention_paged.launches == 0   # CPU: plain
    port.check_pool_invariant()
    pool = port.pool
    port.close()
    assert pool.used_count() == 0
    ref.close()


def _mid_flight(sess):
    """Admit, step, admit a sharer mid-decode, retire mid-flight, reuse
    the slot; the tables after each call."""
    seen = []
    sA, tA = sess.admit([2, 3, 4, 5, 6])
    toks = {"A": [tA]}
    toks["A"].append(sess.step()[sA])
    seen.append([list(t) for t in sess.tables])
    sB, tB = sess.admit([2, 3, 4, 5, 6, 7])      # shares A's prompt blocks
    toks["B"] = [tB]
    for _ in range(3):
        step = sess.step()
        toks["A"].append(step[sA])
        toks["B"].append(step[sB])
        seen.append([list(t) for t in sess.tables])
    sess.retire(sA)
    sC, tC = sess.admit([BOS, 9])
    toks["C"] = [tC]
    for _ in range(2):
        step = sess.step()
        toks["B"].append(step[sB])
        toks["C"].append(step[sC])
        seen.append([list(t) for t in sess.tables])
    sess.retire(sB)
    sess.retire(sC)
    return {k: [int(t) for t in v] for k, v in toks.items()}, seen


def test_mid_flight_tokens_and_tables_identical(weights):
    scope, named = weights
    want, want_tables = _mid_flight(_ref_session(scope, slots=2))
    port = _port_session(named, slots=2)
    got, got_tables = _mid_flight(port)
    assert got == want
    assert got_tables == want_tables
    port.check_pool_invariant()


def test_copy_on_write_isolation(weights):
    """Two sequences admitted from the same prompt share its blocks and
    decode together without seeing each other's writes: each equals its
    solo run, and the cached prefix still serves a third admission."""
    scope, named = weights
    prompt = [2, 3, 4, 5, 6]
    solo = _port_session(named, paged=False).generate(prompt, eos_id=-1)
    runs = {}
    for name, sess in (("ref", _ref_session(scope, slots=2, num_blocks=20)),
                       ("port", _port_session(named, slots=2,
                                              num_blocks=20))):
        cows0 = _cows()
        sA, tA = sess.admit(prompt)
        toks_a = [tA, sess.step()[sA]]
        sB, tB = sess.admit(prompt)                # shares A's blocks
        toks_b = [tB]
        for _ in range(4):
            step = sess.step()
            toks_a.append(step[sA])
            toks_b.append(step[sB])
        sess.retire(sA)
        sess.retire(sB)
        third = sess.generate(prompt, max_new_tokens=6, eos_id=-1)
        cows = sess.prefix_stats()["cows"] if name == "port" \
            else _cows() - cows0
        runs[name] = ([int(t) for t in toks_a], [int(t) for t in toks_b],
                      [int(t) for t in third], cows, sess.prefill_log)
        sess.check_pool_invariant()
    assert runs["port"] == runs["ref"]
    toks_a, toks_b, third, cows, _ = runs["port"]
    assert toks_a == solo[:6] and toks_b == solo[:5] and third == solo[:6]
    assert cows > 0


def _exhaust(sched_cls, sess):
    """Two long budgets over a 3-block pool: one sequence must starve.
    Both are queued before the dispatcher starts, so the interleaving is
    the same in both packages."""
    sched = sched_cls(sess, autostart=False)
    futs = [sched.submit([2, 3], max_new_tokens=8, eos_id=-1),
            sched.submit([4, 5], max_new_tokens=8, eos_id=-1)]
    sched.start()
    try:
        return [[int(t) for t in f.result(timeout=60)] for f in futs]
    finally:
        sched.drain()


def test_pool_exhaustion_finishes_at_the_reference_length(weights):
    scope, named = weights
    ref = _ref_session(scope, slots=2, num_blocks=3, prefix_cache=False)
    port = _port_session(named, slots=2, num_blocks=3, prefix_cache=False)
    want = _exhaust(GenerationScheduler, ref)
    got = _exhaust(port_gen.GenerationScheduler, port)
    assert got == want
    assert any(len(o) < 8 for o in got) and all(len(o) >= 1 for o in got)
    port.check_pool_invariant()
    assert port.pool.used_count() == 0


def test_admit_ok_parks_a_request(weights):
    scope, named = weights
    answers = []
    for sess in (_ref_session(scope, slots=2, num_blocks=2,
                              prefix_cache=False),
                 _port_session(named, slots=2, num_blocks=2,
                               prefix_cache=False)):
        s0, _ = sess.admit([2, 3, 4, 5, 6])
        busy = sess.admit_ok(5)
        sess.retire(s0)
        answers.append((busy, sess.admit_ok(5), sess.admit_ok(8)))
    assert answers[0] == answers[1] == (False, True, True)
    # the whole pool stays admittable with the copy-on-write margin
    assert _port_session(named, slots=1, num_blocks=2).admit_ok(8)
    # through the scheduler: B waits for A's blocks instead of failing
    solo = _port_session(named, slots=2, num_blocks=8, prefix_cache=False)
    prompts = ([2, 3, 4, 5, 6], [7, 8, 9, 10, 11])
    want = [solo.generate(p, max_new_tokens=3, eos_id=-1) for p in prompts]
    sess = _port_session(named, slots=2, num_blocks=2, prefix_cache=False)
    sched = port_gen.GenerationScheduler(sess, autostart=False)
    futs = [sched.submit(p, max_new_tokens=3, eos_id=-1) for p in prompts]
    sched.start()
    try:
        got = [[int(t) for t in f.result(timeout=60)] for f in futs]
    finally:
        sched.drain()
    assert got == want
    # A ran its 2 steps alone before B was admitted
    assert sess.steps == 4 and sess.prefills == 2
    sess.check_pool_invariant()


def test_prompt_longer_than_every_bucket_admitted_through_window_fits(
        weights):
    """A 10-token prompt fits no bucket (4, 8); once an 8-token prefix
    of it is cached, its window of 2 fits the 4 bucket. The port's
    scheduler places it through ``window_fits``; the tokens equal the
    reference session's for the same admission."""
    scope, named = weights
    system = [2, 3, 4, 5, 6, 7, 8, 9]
    long_prompt = system + [10, 11]
    ref = _ref_session(scope)
    port = _port_session(named)
    sched = port_gen.GenerationScheduler(port)
    try:
        cold = sched.submit(long_prompt, max_new_tokens=3, eos_id=-1)
        with pytest.raises(port_gen.ServingUnavailableError):
            cold.result(timeout=60)
        assert port.window_fits(long_prompt) == \
            ref.window_fits(long_prompt) is False
        want_sys = [int(t) for t in ref.generate(system, max_new_tokens=2)]
        assert [int(t) for t in sched.submit(
            system, max_new_tokens=2).result(timeout=60)] == want_sys
        assert port.window_fits(long_prompt) == \
            ref.window_fits(long_prompt) is True
        want = [int(t) for t in ref.generate(long_prompt, max_new_tokens=3,
                                             eos_id=-1)]
        got = sched.submit(long_prompt, max_new_tokens=3, eos_id=-1)
        assert [int(t) for t in got.result(timeout=60)] == want
    finally:
        sched.drain()
    assert port.prefill_log == ref.prefill_log
    assert port.prefill_log[-1] == (4, 8, 2)
    with pytest.raises(ValueError, match="bucket"):   # dense: refused
        port_gen.GenerationScheduler(
            _port_session(named, paged=False),
            autostart=False).submit(long_prompt)


def test_scheduler_concurrent_submits_match_solo(weights):
    _, named = weights
    prompts = ([2, 3, 4, 5, 6], [2, 3, 4, 5, 7, 8], [2, 3, 4, 9])
    solo_sess = _port_session(named)
    solo = [solo_sess.generate(p, max_new_tokens=6, eos_id=-1)
            for p in prompts]
    sess = _port_session(named, slots=2, num_blocks=10)
    sched = port_gen.GenerationScheduler(sess)
    try:
        futs = [sched.submit(p, max_new_tokens=6, eos_id=-1)
                for p in prompts]
        got = [[int(t) for t in f.result(timeout=60)] for f in futs]
    finally:
        sched.drain()
    assert got == solo
    assert sess.prefix_stats()["hits"] >= 1
    sess.check_pool_invariant()
    pool = sess.pool
    sess.close()
    assert pool.used_count() == 0


def test_paged_flags_match_reference_and_default_to_dense():
    for name in ("generation_paged_kv", "generation_block_size",
                 "generation_pool_blocks", "generation_prefix_cache"):
        assert port_config.get_flag(name) == ptpu.config.get_flag(name)
    spec = port_tf.transformer_lm_session(V, max_len=MAXLEN, slots=2,
                                          cache_len=CACHE, device="cpu",
                                          **KW)
    assert not spec.paged and spec.num_blocks == 0
    port_config.set_flags(generation_paged_kv=True,
                          generation_prefix_cache=True)
    try:
        spec = port_tf.transformer_lm_session(V, max_len=MAXLEN, slots=2,
                                              cache_len=CACHE, device="cpu",
                                              **KW)
    finally:
        port_config.set_flags(generation_paged_kv=False,
                              generation_prefix_cache=False)
    # block 16 and the pool auto-sized to byte parity: 2 x ceil(16 / 16)
    assert (spec.paged, spec.block_size, spec.max_blocks, spec.num_blocks,
            spec.prefix_cache) == (True, 16, 1, 2, True)
