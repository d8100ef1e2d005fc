"""Serving through the program path: ``transformer_lm_session``'s cached
generation programs built by the port's front end and run by its
``Executor`` (``GenerationSession(spec, scope)``), against the
reference's ``GenerationSession`` on the same weights, on the CPU.

A small LM (vocab 64, d_model 32, 2 heads, d_ff 64, 2 layers, max_len 32,
4 slots, prompt buckets 8 and 16, block size 4) with the seed-7
standard-normal weights of the reference's tests, crossed into the port's
scope through ``io.scope_from_jax``. Each reference configuration is
served once a module (an int8 one on its own copy of the scope: arming
quantizes a scope in place).

* The spec's programs (every prefill bucket, decode, block copy, verify,
  and the draft's) serialize byte-identical to the reference's, both
  ways, with the decode-policy flags off and on.
* Streams equal the reference's token for token, and the port's
  ``nn.Module`` route's on the same weights: greedy dense; greedy paged
  with prefix hits, copy-on-write and a repeat (prefill logs and prefix
  counters equal too); int8 weights with bfloat16 pools; sampled;
  constrained; speculative (equal to plain decoding as well).
* The logits of a prefill program within 1e-5 of max|logits| of the
  reference's, dense and paged.
* ``compile_stats()`` equals the reference's after the same requests;
  a second session claiming a live session's caches on one scope is
  refused; the pools are written in place.
* ``GenerationScheduler`` over program sessions: it serves the reference's
  streams, replays after an injected step fault to the fault-free
  tokens, and a rebuild (new cache names on the same scope) and a
  ``swap_weights`` (new tensors in the scope, none written in place) give
  the reference's streams.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import layers
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu.models.transformer import transformer_lm
from paddle_tpu.models.transformer import \
    transformer_lm_session as ref_lm_session
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu.serving import GenerationScheduler as RefScheduler
from paddle_tpu.serving import GenerationSession as RefSession
from paddle_tpu.serving import decoding as ref_dec
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.models import transformer as port_tf
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import GenerationScheduler, GenerationSession
from paddle_tpu_torch.serving import decoding as port_dec
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

V, MAXLEN, SLOTS = 64, 32, 4
KW = dict(d_model=32, num_heads=2, d_ff=64, num_layers=2)
BOS, EOS = 0, 1
BUCKETS, BS = (8, 16), 4
NEW = 10
PROMPTS = ([BOS, 5, 7], [2, 3, 4, 5, 6, 7, 8, 9, 10], [9, 3, 2, 11, 4])
# ragged prompts crossing block edges, then shared prefixes: a repeat
# (reuse capped at n - 1), a partial-tail match and a full-block match
PAGED_PROMPTS = ([BOS], [BOS, 5, 7], [2, 3, 4, 5], [2, 3, 4, 5, 6],
                 [2, 3, 4, 5, 6, 7, 8], [2, 3, 4, 5, 6, 7, 8],
                 [2, 3, 4, 5, 6, 9], [2, 3, 4, 5, 11])
SEEDS = (1234, 99)
SAMPLE = dict(kind="sample", temperature=0.8, top_k=8, top_p=0.9)
DIGITS = range(2, 12)
DFA = {0: {d: 1 for d in DIGITS},
       1: {**{d: 1 for d in DIGITS}, 12: 0, EOS: 2},
       2: {EOS: 2}}

# name -> (session keywords, policy keywords, armed): the configurations
# served against the reference
CONFIGS = {
    "dense": (dict(paged=False), None, False),
    "paged": (dict(paged=True, prefix_cache=True), None, False),
    "int8-bf16": (dict(paged=True, prefix_cache=True, dtype="bfloat16"),
                  None, True),
    "sample": (dict(paged=False), SAMPLE, False),
    "constrained": (dict(paged=False), {"dfa": True}, False),
    # the whole target as the draft: every round accepts drafts
    "speculative": (dict(paged=True, prefix_cache=True),
                    dict(speculate_k=3, draft=dict(num_layers=2)), False),
}


def _policy(pkg, kw):
    if kw is None:
        return None
    kw = dict(kw)
    if kw.pop("dfa", False):
        kw["constraint"] = pkg.DFAConstraint(DFA)
    return pkg.DecodePolicy(**kw)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    ref_faults.disarm()


def _weights(seed):
    with ptpu.unique_name.guard():
        main, startup = ptpu.Program(), ptpu.Program()
        with ptpu.program_guard(main, startup):
            toks = layers.data("toks", shape=[1, MAXLEN], dtype="int64",
                               append_batch_size=False)
            transformer_lm(toks, toks, vocab_size=V, is_test=True, **KW)
    scope = ptpu.Scope()
    with ptpu.scope_guard(scope):
        ptpu.Executor().run(startup)
    rs = np.random.RandomState(seed)
    for n in sorted(scope.var_names()):
        cur = np.asarray(scope.find_var(n))
        scope.set_var(n, rs.standard_normal(cur.shape).astype(cur.dtype))
    return {n: np.asarray(scope.find_var(n)) for n in scope.var_names()}


@pytest.fixture(scope="module")
def named():
    return _weights(7)


def _ref_scope(named):
    scope = ptpu.Scope()
    for n, v in named.items():
        scope.set_var(n, np.array(v))
    return scope


def _kw(session_kw, pkg, policy_kw, **extra):
    kw = dict(KW, max_len=MAXLEN, slots=SLOTS, prompt_buckets=BUCKETS,
              bos_id=BOS, eos_id=EOS, block_size=BS,
              decode_policy=_policy(pkg, policy_kw))
    kw.update(session_kw)
    kw.update(extra)
    return kw


def _ref_session(name, scope, **extra):
    session_kw, policy_kw, armed = CONFIGS[name]
    spec = ref_lm_session(V, **_kw(session_kw, ref_dec, policy_kw, **extra))
    return RefSession(spec, scope=scope, arm_quant=armed)


def _spec(name, **extra):
    session_kw, policy_kw, _ = CONFIGS[name]
    return port_tf.transformer_lm_session(
        V, device="cpu", **_kw(session_kw, port_dec, policy_kw, **extra))


def _program_session(name, named, scope=None, **extra):
    return GenerationSession(
        _spec(name, **extra),
        port_io.scope_from_jax(named, device="cpu") if scope is None
        else scope, arm_quant=CONFIGS[name][2])


def _module_session(name, named):
    return GenerationSession(_spec(name),
                             port_io.params_from_jax(named, device="cpu"),
                             arm_quant=CONFIGS[name][2])


def _prompts(name):
    prompts = PAGED_PROMPTS if CONFIGS[name][0].get("prefix_cache") \
        else PROMPTS
    seeds = SEEDS if name == "sample" else (0,)
    return [(p, s) for p in prompts for s in seeds]


def _streams(sess, name):
    out = [[int(t) for t in sess.generate(p, max_new_tokens=NEW, eos_id=-1,
                                          seed=s)]
           for p, s in _prompts(name)]
    return out


@pytest.fixture(scope="module")
def ref(named):
    """{config: (streams, prefill log, prefix stats, compile stats)} of
    the reference's sessions, each served once on its own scope."""
    out = {}
    for name in CONFIGS:
        sess = _ref_session(name, _ref_scope(named))
        try:
            streams = _streams(sess, name)
            out[name] = (streams, list(getattr(sess, "prefill_log", [])),
                         sess.prefix_stats(), sess.compile_stats())
        finally:
            sess.close()
    return out


# -- the programs ------------------------------------------------------------

def _programs(spec):
    """[(label, Program)] of a spec and its draft's."""
    out = [("prefill/%d" % p, prog)
           for p, prog in sorted(spec.prefill_programs.items())]
    out.append(("decode", spec.decode_program))
    for label in ("copy", "verify"):
        prog = getattr(spec, label + "_program")
        if prog is not None:
            out.append((label, prog))
    if spec.draft_spec is not None:
        out += [("draft " + label, prog)
                for label, prog in _programs(spec.draft_spec)]
    return out


def _ns(spec):
    return spec.cache_vars[0][0].split(".")[0]


@pytest.mark.parametrize("paged,flags", [
    (False, {}), (True, {}),
    (False, dict(decode_policy="sample", decode_temperature=0.8,
                 decode_top_k=8, decode_top_p=0.9)),
    (True, dict(decode_policy="sample", decode_temperature=0.8,
                decode_speculate_k=3)),
    (True, dict(decode_constraint="dfa"))])
def test_programs_serialize_byte_identical_both_ways(paged, flags):
    """Built under the same cache namespace, every program of the two
    specs serializes to the same JSON (the draft's under its own
    namespace), and each package's loads the other's and dumps it
    back unchanged."""
    specs = []
    for pkg, config in ((ref_dec, ptpu.config), (port_dec, port_config)):
        set_flags = dict(flags)
        if set_flags.get("decode_constraint") == "dfa":
            set_flags["decode_constraint"] = pkg.DFAConstraint(DFA)
        config.set_flags(**set_flags)
        try:
            kw = dict(KW, max_len=MAXLEN, slots=SLOTS, prompt_buckets=BUCKETS,
                      bos_id=BOS, eos_id=EOS, paged=paged, block_size=BS,
                      cache_ns="kv_session_t")
            specs.append(ref_lm_session(V, **kw) if pkg is ref_dec else
                         port_tf.transformer_lm_session(V, device="cpu",
                                                        **kw))
        finally:
            config.set_flags(decode_policy="greedy", decode_temperature=1.0,
                             decode_top_k=0, decode_top_p=1.0,
                             decode_speculate_k=0, decode_constraint=None)
    ref_spec, port_spec = specs
    assert (flags != {}) == (port_spec.policy is not None)
    ref_progs, port_progs = _programs(ref_spec), _programs(port_spec)
    assert [label for label, _ in port_progs] == \
        [label for label, _ in ref_progs]
    for (label, rp), (_, pp) in zip(ref_progs, port_progs):
        want = json.dumps(ref_ser.program_to_dict(rp))
        got = json.dumps(port_ser.program_to_dict(pp))
        if label.startswith("draft"):
            got = got.replace(_ns(port_spec.draft_spec),
                              _ns(ref_spec.draft_spec))
        assert got == want, label
        assert json.dumps(ref_ser.program_to_dict(ref_ser.program_from_dict(
            port_ser.program_to_dict(pp)))) == json.dumps(
                port_ser.program_to_dict(pp)), label
        assert json.dumps(port_ser.program_to_dict(
            port_ser.program_from_dict(ref_ser.program_to_dict(rp)))) \
            == want, label
    for field in ("prefill_feeds", "prefill_fetch", "decode_feeds",
                  "decode_fetch", "copy_feeds", "verify_feeds",
                  "verify_fetch", "cache_vars", "max_blocks", "num_blocks"):
        assert getattr(port_spec, field) == getattr(ref_spec, field), field


# -- streams ------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_streams_equal_reference_and_module_route(named, ref, name):
    want, log, stats, _ = ref[name]
    sess = _program_session(name, named)
    assert _streams(sess, name) == want
    assert _streams(_module_session(name, named), name) == want
    if sess.paged:
        assert sess.prefill_log == log
        got = sess.prefix_stats()
        assert {k: got[k] for k in stats} == stats
        assert stats["hits"] > 0 and got["cows"] > 0
        sess.check_pool_invariant()
    if name == "speculative":
        assert sess.spec_rounds > 0 and sess.spec_accepted > 0
        # speculation emits the plain paged stream
        assert want == ref["paged"][0][:len(want)]
    if name == "sample":
        assert want[0] != want[1]   # the seed matters
    sess.close()


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_logits_within_1e5(named, paged):
    """The logits the prefill program computes (the LM head's output,
    the transpose's input) at bucket 16, fetched from both executors
    after the same feeds."""
    name = "paged" if paged else "dense"
    rspec = ref_lm_session(V, **_kw(CONFIGS[name][0], ref_dec, None))
    pspec = _spec(name)
    feed = {"gen.ptok": np.array([[2, 3, 4, 5, 6, 7, 8, 9, 10] + [EOS] * 7]),
            "gen.plen": np.array([9], np.int32),
            "gen.ppos": np.array([8], np.int32)}
    if paged:
        feed.update({"gen.phist": np.array([0], np.int32),
                     "gen.ppix": np.arange(16, dtype=np.int32),
                     "gen.ptab": np.arange(pspec.max_blocks,
                                           dtype=np.int32)})
    else:
        feed["gen.slot"] = np.array([1], np.int32)
    outs = []
    for spec, run in ((rspec, "ref"), (pspec, "port")):
        prog = spec.prefill_programs[16]
        logits = next(op.inputs["X"][0] for op in prog.global_block().ops
                      if op.type == "transpose")
        if run == "ref":
            scope = _ref_scope(named)
            sess = RefSession(spec, scope=scope)
            outs.append(np.asarray(sess.exe.run(
                prog, feed=feed, fetch_list=[logits], scope=scope)[0]))
        else:
            sess = GenerationSession(spec, port_io.scope_from_jax(
                named, device="cpu"))
            outs.append(sess.exe.run(prog, feed=feed, fetch_list=[logits],
                                     scope=sess.scope)[0])
        sess.close()
    assert outs[0].shape == outs[1].shape == (1, 16, V)
    err = np.abs(outs[1][0, :9] - outs[0][0, :9]).max()
    assert err <= 1e-5 * np.abs(outs[0][0, :9]).max()


def test_compile_stats_equal_reference(named, ref):
    for name in ("dense", "paged", "speculative"):
        sess = _program_session(name, named)
        _streams(sess, name)
        assert sess.compile_stats() == ref[name][3], name
        sess.close()


def test_duplicate_cache_claim_refused_and_released(named):
    scope = port_io.scope_from_jax(named, device="cpu")
    spec = _spec("paged")
    sess = GenerationSession(spec, scope)
    with pytest.raises(ValueError, match="already driven"):
        GenerationSession(spec, scope)
    # another spec (new cache names) on the same scope is a replica
    other = GenerationSession(_spec("paged"), scope)
    # the pools carry a sink block past their declared shape, and are
    # written in place: the scope keeps the tensors it was given
    name, shape, _ = spec.cache_vars[0]
    pool = scope.find_var(name)
    assert tuple(pool.shape) == (shape[0] + 1,) + tuple(shape[1:])
    assert sess.generate(PAGED_PROMPTS[4], max_new_tokens=4) and \
        scope.find_var(name) is pool and pool.abs().sum() > 0
    sess.close()
    assert not scope.has_var(name)
    GenerationSession(spec, scope).close()
    other.close()


# -- the scheduler ------------------------------------------------------------

def _served(sched, prompts, max_new, seeds=None):
    futs = [sched.submit(list(p), max_new_tokens=max_new, eos_id=-1,
                         seed=None if seeds is None else seeds[i])
            for i, p in enumerate(prompts)]
    return [[int(t) for t in f.result(timeout=60)] for f in futs]


def test_scheduler_serves_and_replays_a_step_fault(named, ref):
    """Two program sessions on one scope: the reference's streams, with
    and without a step fault at the first step (replayed on the other
    session, token for token)."""
    want = [s[:6] for s in ref["dense"][0]]
    scope = port_io.scope_from_jax(named, device="cpu")
    sched = GenerationScheduler(
        [_program_session("dense", named, scope),
         _program_session("dense", named, scope)],
        replay_attempts=4, breaker_failures=1, breaker_cooldown_ms=60000.0)
    try:
        assert _served(sched, PROMPTS, 6) == want
        faults.arm("generation_step_fail", at=0, times=1)
        assert _served(sched, PROMPTS, 6) == want
        assert sched.session_health()[0] == "open"
    finally:
        sched.close()


def test_scheduler_rebuild_and_swap_give_reference_streams(named, ref):
    scope = port_io.scope_from_jax(named, device="cpu")
    sess = _program_session("paged", named, scope)
    old_ns = {n for n, _, _ in sess.spec.cache_vars}
    sched = GenerationScheduler([sess], replay_attempts=10,
                                breaker_failures=1,
                                breaker_cooldown_ms=30.0, rebuild_limit=2)
    try:
        faults.arm("generation_step_fail", at=0, times=3)
        assert _served(sched, PAGED_PROMPTS[4:5], NEW) == \
            [ref["paged"][0][4]]
        new = sched.sessions[0]
        assert new is not sess and new.scope is scope
        assert {n for n, _, _ in new.spec.cache_vars}.isdisjoint(old_ns)
        assert all(not scope.has_var(n) for n in old_ns)
        faults.disarm()
        # the swap installs new tensors: the old ones are left as they were
        other = _weights(11)
        held = {n: scope.find_var(n) for n in other if scope.has_var(n)}
        assert set(other) - set(held) == {"@RNG_STATE@"}
        before = {n: t.clone() for n, t in held.items()}
        assert sched.swap_weights(other) == 1
        for n, t in held.items():
            assert scope.find_var(n) is not t and torch.equal(t, before[n])
        got = _served(sched, PROMPTS[:2], NEW)
    finally:
        sched.close()
    rsess = _ref_session("paged", _ref_scope(other))
    rsched = RefScheduler([rsess])
    try:
        assert got == _served(rsched, PROMPTS[:2], NEW)
    finally:
        rsched.close()
