"""Decode policies end to end: the port's ``GenerationSession`` and
``GenerationScheduler`` (``paddle_tpu_torch/serving``) against the
reference's sessions on the same weights (the seed-7 standard-normal LM of
``tests/test_decoding.py``, crossed through ``io.params_from_jax``),
dense and paged, on the CPU.

Every comparison is of tokens and is exact: sampled streams for two
seeds, speculative streams (greedy and sampled) against plain ones and
the reference's, constrained streams, a replay from the middle of a
journal. The logits of the two packages differ in the last bits (f32
sums in another order), and the Gumbel noise by an ulp; a token could
differ only at a near-tie within that, which these seeded weights do
not contain. The reference sessions are built once a module.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import layers
from paddle_tpu.models.transformer import (transformer_lm,
                                           transformer_lm_session)
from paddle_tpu.serving import GenerationSession
from paddle_tpu.serving import decoding as ref_dec
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch.models import transformer as port_tf
from paddle_tpu_torch.ops import quant_ops as port_q
from paddle_tpu_torch.serving import decoding as port_dec
from paddle_tpu_torch.serving import generation as port_gen
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

V, MAXLEN = 29, 24
KW = dict(d_model=16, num_heads=2, d_ff=32, num_layers=2)
BOS, EOS = 0, 1
BUCKETS, BS = (4, 8, 16), 4
PROMPTS = ([BOS, 5, 7], [2, 3, 4, 5, 6], [9, 3, 2, 11, 4, 8, 13])
SEEDS = (1234, 99)
NEW = 12
SAMPLE = dict(kind="sample", temperature=0.8, top_k=8, top_p=0.9)
# a number-list grammar over the small vocab: digits 2..11, a comma 12,
# EOS 1 ends a list after a digit and then repeats
DIGITS = range(2, 12)
DFA = {0: {d: 1 for d in DIGITS},
       1: {**{d: 1 for d in DIGITS}, 12: 0, EOS: 2},
       2: {EOS: 2}}
DEAD_DFA = {0: {5: 1}, 1: {6: 3}, 3: {}}


def _policy(pkg, name):
    """The named policy of ``pkg`` (the reference's or the port's
    ``serving.decoding``)."""
    dfa = pkg.DFAConstraint(DFA)
    return {
        "greedy": None,
        "sample": pkg.DecodePolicy(**SAMPLE),
        "greedy-spec": pkg.DecodePolicy(speculate_k=3),
        "sample-spec": pkg.DecodePolicy(speculate_k=3, **SAMPLE),
        "perfect-spec": pkg.DecodePolicy(
            speculate_k=3, draft=dict(num_layers=KW["num_layers"])),
        "dfa": pkg.DecodePolicy(constraint=dfa),
        "dfa-sample": pkg.DecodePolicy(constraint=dfa, **SAMPLE),
        "dead": pkg.DecodePolicy(constraint=pkg.DFAConstraint(DEAD_DFA)),
    }[name]


@pytest.fixture(scope="module")
def weights():
    """(reference scope, {name: np.ndarray}) of the seeded LM."""
    with ptpu.unique_name.guard():
        main, startup = ptpu.Program(), ptpu.Program()
        with ptpu.program_guard(main, startup):
            toks = layers.data("toks", shape=[1, MAXLEN], dtype="int64",
                               append_batch_size=False)
            lbls = layers.data("lbls", shape=[1, MAXLEN], dtype="int64",
                               append_batch_size=False)
            transformer_lm(toks, lbls, vocab_size=V, is_test=True, **KW)
    scope = ptpu.Scope()
    with ptpu.scope_guard(scope):
        ptpu.Executor().run(startup)
    rs = np.random.RandomState(7)
    for n in sorted(scope.var_names()):
        cur = np.asarray(scope.find_var(n))
        scope.set_var(n, rs.standard_normal(cur.shape).astype(cur.dtype))
    named = {n: np.asarray(scope.find_var(n)) for n in scope.var_names()}
    return scope, named


@pytest.fixture(scope="module")
def ref_streams(weights):
    """{(policy, layout): {(prompt index, seed): tokens}} of the
    reference's sessions, each built once and closed."""
    scope, _ = weights
    out = {}
    for name, paged in (("sample", False), ("sample", True),
                        ("greedy", True), ("greedy-spec", True),
                        ("dfa", False), ("dfa-sample", False)):
        spec = transformer_lm_session(
            V, max_len=MAXLEN, slots=2, prompt_buckets=BUCKETS,
            bos_id=BOS, eos_id=EOS, paged=paged or None,
            block_size=BS if paged else None,
            decode_policy=_policy(ref_dec, name), **KW)
        sess = GenerationSession(spec, scope=scope)
        try:
            out[name, paged] = {
                (i, s): [int(t) for t in sess.generate(
                    p, max_new_tokens=NEW, eos_id=-1, seed=s)]
                for i, p in enumerate(PROMPTS) for s in SEEDS}
        finally:
            sess.close()
    return out


def _port(named, name, paged=False, **kw):
    spec = port_tf.transformer_lm_session(
        V, max_len=MAXLEN, slots=2, prompt_buckets=BUCKETS, eos_id=EOS,
        device="cpu", paged=paged, block_size=BS if paged else None,
        decode_policy=_policy(port_dec, name), **KW)
    return port_gen.GenerationSession(
        spec, port_io.params_from_jax(named, device="cpu"), **kw)


def _streams(sess):
    out = {(i, s): sess.generate(p, max_new_tokens=NEW, eos_id=-1, seed=s)
           for i, p in enumerate(PROMPTS) for s in SEEDS}
    sess.check_pool_invariant()
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_sampled_streams_equal_reference(weights, ref_streams, paged):
    got = _streams(_port(weights[1], "sample", paged))
    assert got == ref_streams["sample", paged]
    # the seed matters: two seeds give two streams somewhere
    assert any(got[i, SEEDS[0]] != got[i, SEEDS[1]]
               for i in range(len(PROMPTS)))


def test_greedy_speculative_equals_plain_and_reference(weights,
                                                       ref_streams):
    spec = _port(weights[1], "greedy-spec", paged=True)
    plain = _port(weights[1], "greedy", paged=True)
    got = _streams(spec)
    assert got == _streams(plain)
    assert got == ref_streams["greedy", True] == \
        ref_streams["greedy-spec", True]
    assert spec.verifies > 0 and spec.spec_drafted == 3 * spec.verifies
    assert spec.draft.prefills == spec.prefills
    # a shared self-draft: the target's tensors, no copies
    ours = spec.model.reference_state()
    for name, t in spec.draft.model.reference_state().items():
        assert t.data_ptr() == ours[name].data_ptr(), name


def test_sampled_speculative_equals_plain_sampled(weights, ref_streams):
    spec = _port(weights[1], "sample-spec", paged=True)
    got = _streams(spec)
    assert got == ref_streams["sample", True]
    assert spec.verifies > 0 and spec.spec_drafted == 3 * spec.verifies


def test_perfect_draft_accepts_k_every_round(weights, ref_streams):
    sess = _port(weights[1], "perfect-spec", paged=True)
    assert sess.draft.model.num_layers == KW["num_layers"]
    got = _streams(sess)
    assert got == ref_streams["greedy", True]
    assert sess.verifies > 0
    assert sess.spec_accepted == sess.spec_drafted == 3 * sess.verifies


@pytest.mark.parametrize("name", ["dfa", "dfa-sample"])
def test_constrained_streams_equal_reference(weights, ref_streams, name):
    sess = _port(weights[1], name)
    got = _streams(sess)
    assert got == ref_streams[name, False]
    c = sess.policy.constraint
    for toks in got.values():
        state = c.start
        for t in toks:
            state = c.advance(state, t)     # raises on an illegal token


@pytest.mark.parametrize("name,paged", [("sample", False), ("sample", True),
                                        ("dfa-sample", False)])
def test_replay_from_mid_journal_is_bit_identical(weights, name, paged):
    """Admit prompt + a prefix of the stream with the stream's seed (and
    the constraint state folded through it) and step on: the rest of the
    stream comes back token for token."""
    sess = _port(weights[1], name, paged)
    prompt, seed, cut = list(PROMPTS[1]), 4321, 5
    full = sess.generate(prompt, max_new_tokens=NEW, eos_id=-1, seed=seed)
    cstate = None
    if sess.constrained:
        c = sess.policy.constraint
        cstate = c.advance_many(c.start, full[:cut])
    slot, first = sess.admit(np.asarray(prompt + full[:cut]), seed=seed,
                             cstate=cstate)
    cont = [first]
    while len(cont) < NEW - cut:
        cont.append(sess.step()[slot])
    sess.retire(slot)
    assert cont == full[cut:]


def test_scheduler_mints_and_reuses_seeds(weights, monkeypatch):
    minted = []

    def mint():
        minted.append(4242 + len(minted))
        return minted[-1]
    monkeypatch.setattr(port_gen, "mint_seed", mint)
    sess = _port(weights[1], "sample")
    sched = port_gen.GenerationScheduler(sess, autostart=False)
    assert sched.policy_fingerprint() == \
        _policy(ref_dec, "sample").fingerprint()
    futs = [sched.submit(PROMPTS[0], max_new_tokens=8, eos_id=-1, seed=777)
            for _ in range(2)]
    futs.append(sched.submit(PROMPTS[0], max_new_tokens=8, eos_id=-1))
    sched.drain()
    a, b, c = (list(f.result(1)) for f in futs)
    assert a == b == sess.generate(PROMPTS[0], 8, eos_id=-1, seed=777)
    assert minted == [4242]
    assert c == sess.generate(PROMPTS[0], 8, eos_id=-1, seed=4242)
    # greedy sessions mint nothing: the seed is 0
    greedy = port_gen.GenerationScheduler(_port(weights[1], "greedy"),
                                          autostart=False)
    assert greedy.policy_fingerprint() == "greedy"
    greedy.submit(PROMPTS[0], max_new_tokens=2)
    greedy.drain()
    assert minted == [4242]


def test_speculative_scheduler_streams_and_books(weights, ref_streams):
    """Speculative rounds through the scheduler, two requests co-batched:
    the lists a round emits are cut at the budget, and the pool's books
    balance after."""
    sess = _port(weights[1], "greedy-spec", paged=True)
    sched = port_gen.GenerationScheduler(sess, autostart=False)
    futs = [sched.submit(p, max_new_tokens=NEW, eos_id=-1)
            for p in PROMPTS[:2]]
    sched.drain()
    for i, f in enumerate(futs):
        assert list(f.result(1)) == ref_streams["greedy", True][i, SEEDS[0]]
    sess.check_pool_invariant()
    assert sess.pool.used_count() == len(sess.prefix.pinned_blocks()) \
        if sess.prefix is not None else sess.pool.used_count() == 0


def test_step_feeds_keys_and_tags_speculative_rounds(weights):
    """A plain sampled step's phase 1 carries each slot's key words
    ``decoding_key(seed, length + 1)``, derived on the host, on the
    session's device; a speculative session's phase 1 is tagged as a
    round and carries each slot's (length, table row)."""
    from paddle_tpu_torch.ops.random_ops import decoding_key
    sess = _port(weights[1], "sample")
    for p, seed in zip(PROMPTS[:2], SEEDS):
        sess.admit(np.asarray(p), seed=seed)
    prepared = sess.step_prepare()
    assert not prepared.speculative and prepared.windows is None
    keys, mask = prepared.feed
    assert mask is None and keys.device == torch.device(sess.device)
    want = decoding_key(torch.tensor(SEEDS),
                        torch.tensor([len(p) + 1 for p in PROMPTS[:2]]))
    assert torch.equal(keys, want)
    sess.step_run(prepared)
    spec = _port(weights[1], "greedy-spec", paged=True)
    slot, _ = spec.admit(np.asarray(PROMPTS[0]))
    prepared = spec.step_prepare()
    assert prepared.speculative and prepared.feed is None
    assert set(prepared.windows) == {slot}
    assert prepared.windows[slot][0] == len(PROMPTS[0])
    assert isinstance(spec.step_run(prepared)[slot], list)
    spec.check_pool_invariant()


def test_mixed_fingerprints_refused(weights):
    a, b = _port(weights[1], "sample"), _port(weights[1], "greedy")
    with pytest.raises(ValueError, match="decode policy"):
        port_gen.GenerationScheduler([a, b], autostart=False)
    # a speculative greedy session makes greedy's decisions
    port_gen.GenerationScheduler(
        [b, _port(weights[1], "greedy-spec", paged=True)], autostart=False)


def test_dead_end_resolves_as_client_error(weights):
    sched = port_gen.GenerationScheduler(_port(weights[1], "dead"),
                                         autostart=False)
    f = sched.submit(PROMPTS[0], max_new_tokens=8)
    ok = sched.submit(PROMPTS[1], max_new_tokens=1)
    sched.drain()
    with pytest.raises(port_dec.ConstraintDeadEnd) as err:
        f.result(1)
    assert err.value.state == 3 and err.value.position == 2
    assert list(ok.result(1)) == [5]
    assert not sched.sessions[0].active.any()


def test_speculation_needs_paged_and_known_draft_keys():
    with pytest.raises(ValueError, match="paged"):
        port_tf.transformer_lm_session(
            V, max_len=MAXLEN, slots=2, prompt_buckets=BUCKETS,
            device="cpu", decode_policy=port_dec.DecodePolicy(
                speculate_k=2), **KW)
    with pytest.raises(ValueError, match="draft"):
        port_tf.transformer_lm_session(
            V, max_len=MAXLEN, slots=2, prompt_buckets=BUCKETS,
            device="cpu", paged=True, block_size=BS,
            decode_policy=port_dec.DecodePolicy(
                speculate_k=2, draft=dict(nonsense=3)), **KW)
    spec = port_tf.transformer_lm_session(
        V, max_len=MAXLEN, slots=2, prompt_buckets=BUCKETS, device="cpu",
        decode_policy=None, **KW)
    assert spec.policy is None and spec.draft_spec is None


def test_int8_speculative_draft_goes_through_b3(weights, monkeypatch):
    """Arming the speculative session arms its self-draft in the same
    call: every product of the target (13 a pass) and of the 1-layer
    draft (7 a pass) takes B3's plain version on the CPU, and the draft's
    armed weights are the target's int8 tensors, no float32 copy."""
    calls = []
    plain = port_q.int8_matmul_plain

    def counted(*args):
        calls.append(args[1].shape)
        return plain(*args)
    monkeypatch.setattr(port_q, "int8_matmul_plain", counted)
    sess = _port(weights[1], "greedy-spec", paged=True, arm_quant=True)
    draft = sess.draft
    ours = sess.model.reference_state()
    names = port_tf.lm_mul_weight_names(1)
    for name in names:
        w, scale = draft.model.mul_weight(name)
        assert w.dtype == torch.int8 and scale is not None, name
        assert w.data_ptr() == ours[name].data_ptr(), name
    assert not [n for n, t in draft.model.reference_state().items()
                if t.dtype == torch.float32 and n in names]
    out = sess.generate(PROMPTS[2], max_new_tokens=NEW, eos_id=-1)
    assert len(out) == NEW and sess.verifies > 0
    target = len(port_tf.lm_mul_weight_names(KW["num_layers"]))
    assert len(calls) == \
        target * (sess.prefills + sess.steps + sess.verifies) + \
        len(names) * (draft.prefills + draft.steps)
    # and the armed speculative stream is the armed plain session's
    plain_sess = _port(weights[1], "greedy", paged=True, arm_quant=True)
    assert out == plain_sess.generate(PROMPTS[2], max_new_tokens=NEW,
                                      eos_id=-1)


def test_draft_of_other_widths_takes_its_own_params_and_arms_itself(
        weights):
    """``decode_draft_model`` with other widths: the self-draft cannot
    share the target's tensors (a shape error names the weight), so the
    session takes ``draft_params``; armed, the draft quantizes its own
    weights. The stream is the target's plain one whatever the draft."""
    draft_kw = dict(d_model=8, num_heads=2, d_ff=16, num_layers=1)
    pol = port_dec.DecodePolicy(speculate_k=3, draft=draft_kw)
    spec = port_tf.transformer_lm_session(
        V, max_len=MAXLEN, slots=2, prompt_buckets=BUCKETS, eos_id=EOS,
        device="cpu", paged=True, block_size=BS, decode_policy=pol, **KW)
    params = port_io.params_from_jax(weights[1], device="cpu")
    with pytest.raises(ValueError, match="shape"):
        port_gen.GenerationSession(spec, params)
    small = port_tf.TransformerLM(
        V, draft_kw["d_model"], draft_kw["num_heads"], draft_kw["d_ff"],
        draft_kw["num_layers"], MAXLEN, device="cpu")
    small.reset_parameters(seed=3)
    draft_params = {n: t.detach().clone()
                    for n, t in small.reference_tensors().items()}
    sess = port_gen.GenerationSession(spec, params, arm_quant=True,
                                      draft_params=draft_params)
    for name in port_tf.lm_mul_weight_names(1):
        w, _ = sess.draft.model.mul_weight(name)
        assert w.dtype == torch.int8
    assert sess.draft._quant_armed == port_tf.lm_mul_weight_names(1)
    assert sess.draft.model.tok_embedding.data_ptr() != \
        sess.model.tok_embedding.data_ptr()
    plain = _port(weights[1], "greedy", paged=True, arm_quant=True)
    for p in PROMPTS:
        assert sess.generate(p, max_new_tokens=NEW, eos_id=-1) == \
            plain.generate(p, max_new_tokens=NEW, eos_id=-1)
    sess.check_pool_invariant()
    with pytest.raises(ValueError, match="draft_params"):
        port_gen.GenerationSession(
            port_tf.transformer_lm_session(
                V, max_len=MAXLEN, slots=2, prompt_buckets=BUCKETS,
                device="cpu", decode_policy=None, **KW),
            params, draft_params=draft_params)
