"""Scheduler resilience of the port against the reference, on the CPU:
token-replay failover, step timeouts, session rebuild, deadlines during
replay, the breaker-gauge namespace, trace propagation and the default-off
guarantees (the counterparts of ``tests/test_generation_failover.py``),
the scheduler resilience and weight-swap tests of
``tests/test_generation.py``, pool preemption and paged failover
(``tests/test_paged_cache.py``), and the two decode-policy fault sites
(``tests/test_decoding.py``).

Both packages serve the seed-7 standard-normal LM of the reference's
tests (V 29, d_model 16, 2 heads, d_ff 32, 2 layers, MAXLEN 12), crossed
into the port through ``io.params_from_jax``; the same faults are
injected into each package's own ``resilience.faults``. Every stream is
compared with ``==`` to the reference's fault-free stream; a replay must
give it back token for token, greedy, sampled and speculative. Where the
reference's count is deterministic (a dispatcherless ``drain()``), the
port's counters must equal its counters by name, labels and value. The
reference's baselines are computed once a module.
"""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import layers
from paddle_tpu.models.transformer import transformer_lm
from paddle_tpu.models.transformer import \
    transformer_lm_session as ref_lm_session
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu.serving import GenerationScheduler as RefScheduler
from paddle_tpu.serving import GenerationSession as RefSession
from paddle_tpu.serving import decoding as ref_dec
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch.models import transformer as port_tf
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.observability import request_trace as rtrace
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import (GenerationScheduler, GenerationSession,
                                      ServingDeadlineError,
                                      ServingOverloadError,
                                      ServingUnavailableError)
from paddle_tpu_torch.serving import decoding as port_dec
from paddle_tpu_torch.serving.resilience import REPLICA_HEALTHY
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

V, MAXLEN = 29, 12
KW = dict(d_model=16, num_heads=2, d_ff=32, num_layers=2)
BOS, EOS = 0, 1
PROMPTS = ([BOS], [2, 3], [4, 5, 6], [BOS, 5])
BUCKETS = (4, 8, 12)
SEEDS = [1000 + 17 * i for i in range(len(PROMPTS))]


def _counter(name, registry=metrics.REGISTRY, **labels):
    for s in registry.dump().get(name, {}).get("samples", ()):
        if all(s["labels"].get(k) == v for k, v in labels.items()):
            return s["value"]
    return 0.0


def _scope(seed, max_len=MAXLEN):
    with ptpu.unique_name.guard():
        main, startup = ptpu.Program(), ptpu.Program()
        with ptpu.program_guard(main, startup):
            toks = layers.data("toks", shape=[1, max_len], dtype="int64",
                               append_batch_size=False)
            lbls = layers.data("lbls", shape=[1, max_len], dtype="int64",
                               append_batch_size=False)
            transformer_lm(toks, lbls, vocab_size=V, is_test=True, **KW)
    scope = ptpu.Scope()
    with ptpu.scope_guard(scope):
        ptpu.Executor().run(startup)
    rs = np.random.RandomState(seed)
    for n in sorted(scope.var_names()):
        cur = np.asarray(scope.find_var(n))
        scope.set_var(n, rs.standard_normal(cur.shape).astype(cur.dtype))
    return scope, {n: np.asarray(scope.find_var(n))
                   for n in scope.var_names()}


@pytest.fixture(scope="module")
def weights():
    """(reference scope, {name: array}) of the seed-7 LM."""
    return _scope(7)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    ref_faults.disarm()


def _ref_session(scope, slots=2, decode_policy=None, paged=False, **kw):
    spec = ref_lm_session(V, max_len=MAXLEN, slots=slots, cache_len=MAXLEN,
                          prompt_buckets=BUCKETS, bos_id=BOS, eos_id=EOS,
                          decode_policy=decode_policy, paged=paged or None,
                          **dict(KW, **kw))
    return RefSession(spec, scope=scope)


def _port(named, slots=2, decode_policy=None, prompt_buckets=BUCKETS,
          max_len=MAXLEN, cache_len=MAXLEN, arm_quant=False, **kw):
    spec = port_tf.transformer_lm_session(
        V, max_len=max_len, slots=slots, cache_len=cache_len,
        prompt_buckets=prompt_buckets, bos_id=BOS, eos_id=EOS, device="cpu",
        decode_policy=decode_policy, **dict(KW, **kw))
    return GenerationSession(spec, port_io.params_from_jax(
        named, device="cpu"), arm_quant=arm_quant)


def _sampled(pkg):
    return pkg.DecodePolicy(kind="sample", temperature=0.9)


def _ref_run(scope, prompts, max_new, decode_policy=None, seeds=None):
    """The reference's fault-free scheduler run over two sessions."""
    sched = RefScheduler([_ref_session(scope, decode_policy=decode_policy),
                          _ref_session(scope, decode_policy=decode_policy)])
    try:
        futs = [sched.submit(list(p), max_new_tokens=max_new, eos_id=-1,
                             seed=None if seeds is None else seeds[i])
                for i, p in enumerate(prompts)]
        return [[int(t) for t in f.result(timeout=60)] for f in futs]
    finally:
        sched.close()


@pytest.fixture(scope="module")
def base(weights):
    """The reference's fault-free streams, by name."""
    scope, _ = weights
    return {
        "greedy": _ref_run(scope, PROMPTS, 6),
        "sampled": _ref_run(scope, PROMPTS, 6, _sampled(ref_dec), SEEDS),
        "bos5": _ref_run(scope, ([BOS],), 5)[0],
        "bos4": _ref_run(scope, ([BOS],), 4)[0],
        "23x9": _ref_run(scope, ([2, 3],), 9)[0],
        "bos11": _ref_run(scope, ([BOS],), 11)[0],
    }


def _served(sched, prompts, max_new, seeds=None, timeout=60):
    futs = [sched.submit(list(p), max_new_tokens=max_new, eos_id=-1,
                         seed=None if seeds is None else seeds[i])
            for i, p in enumerate(prompts)]
    return [[int(t) for t in f.result(timeout=timeout)] for f in futs]


# -- token-replay failover -------------------------------------------------

class TestReplayFailover:
    def test_step_fault_zero_errors_bit_identical(self, weights, base):
        named = weights[1]
        f0 = _counter("paddle_generation_failover_total")
        r0 = _counter("paddle_generation_replayed_tokens_total")
        sched = GenerationScheduler(
            [_port(named), _port(named)], replay_attempts=4,
            breaker_failures=1, breaker_cooldown_ms=60000.0)
        try:
            faults.arm("generation_step_fail", at=0, times=1)
            assert _served(sched, PROMPTS, 6) == base["greedy"]
            assert _counter("paddle_generation_failover_total") > f0
            assert _counter("paddle_generation_replayed_tokens_total") > r0
            assert sched.session_health()[0] == "open"
        finally:
            sched.close()

    def test_persistent_step_fault_sampled_bit_identical(self, weights,
                                                         base):
        named = weights[1]
        want = base["sampled"]
        assert len(set(map(tuple, want))) > 1
        pol = _sampled(port_dec)
        sched = GenerationScheduler(
            [_port(named, decode_policy=pol),
             _port(named, decode_policy=pol)],
            replay_attempts=4, breaker_failures=1,
            breaker_cooldown_ms=60000.0)
        try:
            faults.arm("generation_step_fail", at=0, times=None)
            assert _served(sched, PROMPTS, 6, seeds=SEEDS) == want
            assert sched.session_health()[0] == "open"
        finally:
            sched.close()

    def test_admit_fault_replays_to_healthy_session(self, weights, base):
        named = weights[1]
        sched = GenerationScheduler(
            [_port(named), _port(named)], replay_attempts=2,
            breaker_failures=1, breaker_cooldown_ms=60000.0)
        try:
            faults.arm("generation_admit_fail", at=0, times=1)
            assert _served(sched, ([BOS],), 5)[0] == base["bos5"]
        finally:
            sched.close()

    def test_replay_promotes_to_larger_prompt_bucket(self, weights, base):
        named = weights[1]
        sched = GenerationScheduler(
            [_port(named), _port(named)], replay_attempts=2,
            breaker_failures=1, breaker_cooldown_ms=60000.0,
            autostart=False)
        try:
            fut = sched.submit([2, 3], max_new_tokens=9, eos_id=-1)
            assert sched._place(sched._next_item(block=False))
            for _ in range(4):
                sched._step_all()        # 5 tokens generated
            p0 = _counter("paddle_generation_prefills_total", bucket="8")
            faults.arm("generation_step_fail", times=1)
            sched._step_all()            # killed mid-decode -> replay
            faults.disarm()
            for _ in range(40):
                if fut.done():
                    break
                item = sched._next_item(block=False)
                if item is not None:
                    sched._place(item)
                sched._step_all()
            assert [int(t) for t in fut.result(timeout=5)] == base["23x9"]
            # the 7-token journal went through the larger bucket
            assert _counter("paddle_generation_prefills_total",
                            bucket="8") == p0 + 1
        finally:
            sched.close()

    def test_replay_prefers_sessions_that_have_not_failed_it(self, weights,
                                                             base):
        named = weights[1]
        sched = GenerationScheduler(
            [_port(named), _port(named)], replay_attempts=3,
            breaker_failures=3, breaker_cooldown_ms=60000.0)
        try:
            faults.arm("generation_step_fail", at=0, times=None)
            assert _served(sched, ([BOS],), 4)[0] == base["bos4"]
            assert sched.session_health() == ["closed", "closed"]
        finally:
            sched.close()

    def test_replay_budget_spent_surfaces_failure(self, weights):
        sched = GenerationScheduler(
            [_port(weights[1])], replay_attempts=2, breaker_failures=1,
            breaker_cooldown_ms=10.0)
        try:
            faults.arm("generation_step_fail", at=0, times=None)
            fut = sched.submit([BOS], max_new_tokens=5, eos_id=-1)
            with pytest.raises(faults.InjectedFault):
                fut.result(timeout=60)
        finally:
            sched.close()

    def test_poison_request_charges_at_most_one_breaker(self, weights,
                                                        base):
        named = weights[1]
        sched = GenerationScheduler(
            [_port(named), _port(named)], replay_attempts=3,
            breaker_failures=1, breaker_cooldown_ms=60000.0)
        try:
            faults.arm("generation_admit_fail", times=2)
            assert _served(sched, ([BOS],), 4)[0] == base["bos4"]
            assert sched.session_health() == ["open", "closed"]
        finally:
            sched.close()

    def test_poison_step_charges_at_most_one_breaker(self, weights, base):
        named = weights[1]
        sched = GenerationScheduler(
            [_port(named), _port(named)], replay_attempts=3,
            breaker_failures=1, breaker_cooldown_ms=60000.0)
        try:
            faults.arm("generation_step_fail", times=2)
            assert _served(sched, ([BOS],), 4)[0] == base["bos4"]
            assert sched.session_health() == ["open", "closed"]
        finally:
            sched.close()


# the counters a dispatcherless drain() makes deterministic, with the
# labels each is compared under
_DRAIN_COUNTERS = (
    ("paddle_generation_requests_total", {}),
    ("paddle_generation_tokens_total", {}),
    ("paddle_generation_decode_steps_total", {}),
    ("paddle_generation_failover_total", {}),
    ("paddle_generation_replayed_tokens_total", {}),
    ("paddle_generation_prefills_total", {"bucket": "4"}),
    ("paddle_generation_prefills_total", {"bucket": "8"}),
    ("paddle_generation_retired_total", {"reason": "max_tokens"}),
    ("paddle_generation_retired_total", {"reason": "failover"}),
    ("paddle_generation_retired_total", {"reason": "error"}),
    ("paddle_serving_breaker_transitions_total", {"state": "open"}),
    ("paddle_serving_breaker_transitions_total", {"state": "half_open"}),
    ("paddle_serving_breaker_transitions_total", {"state": "closed"}),
)


def _drain_chaos(sched_cls, sessions, fault_mod, submit_seeds=None):
    """Queue PROMPTS, fail session 0's first step, drain without a
    dispatcher. Returns (streams, {counter: delta})."""
    registry = metrics.REGISTRY if fault_mod is faults \
        else ref_metrics.REGISTRY
    before = [_counter(n, registry, **lb) for n, lb in _DRAIN_COUNTERS]
    sched = sched_cls(sessions, replay_attempts=4, breaker_failures=1,
                      breaker_cooldown_ms=60000.0, autostart=False)
    futs = [sched.submit(list(p), max_new_tokens=6, eos_id=-1,
                         seed=None if submit_seeds is None
                         else submit_seeds[i])
            for i, p in enumerate(PROMPTS)]
    fault_mod.arm("generation_step_fail", at=0, times=1)
    try:
        sched.drain()
    finally:
        fault_mod.disarm()
    out = [[int(t) for t in f.result(1)] for f in futs]
    after = [_counter(n, registry, **lb) for n, lb in _DRAIN_COUNTERS]
    return out, {"%s%s" % (n, sorted(lb.items())): a - b
                 for (n, lb), a, b in zip(_DRAIN_COUNTERS, after, before)}


def test_failover_counters_equal_reference(weights, base):
    """The same chaos run drained on both packages: the same streams and
    the same counter deltas by name, labels and value."""
    scope, named = weights
    ref_out, ref_counts = _drain_chaos(
        RefScheduler, [_ref_session(scope), _ref_session(scope)],
        ref_faults)
    out, counts = _drain_chaos(GenerationScheduler,
                               [_port(named), _port(named)], faults)
    assert ref_out == base["greedy"]
    assert out == ref_out
    assert counts == ref_counts
    assert counts["paddle_generation_failover_total[]"] > 0


# -- hang-free dispatcher --------------------------------------------------

class TestStepTimeout:
    def test_wedged_step_replays_and_quarantines(self, weights, base):
        """A session wedged past the step timeout is a failure, not a
        freeze: its requests replay elsewhere with identical tokens and
        the breaker opens at once. The port runs a session's bounded
        steps on one long-lived worker (the reference: a fresh thread a
        step), so no session ever holds more than one step thread, and
        the wedged one is not stacked behind."""
        named = weights[1]
        t0 = _counter("paddle_generation_step_timeouts_total")
        sessions = [_port(named), _port(named)]
        for s in sessions:
            s.generate([BOS], max_new_tokens=2, eos_id=-1)
        sched = GenerationScheduler(
            sessions, replay_attempts=4, breaker_failures=3,
            breaker_cooldown_ms=60000.0, step_timeout_ms=500.0)
        try:
            faults.arm("generation_session_wedge", at=0, times=1,
                       action="callback", callback=lambda: time.sleep(2.0))
            assert _served(sched, PROMPTS, 6) == base["greedy"]
            assert _counter("paddle_generation_step_timeouts_total") \
                == t0 + 1
            assert sched.session_health()[0] == "open"
            time.sleep(0.1)
            workers = [t.name for t in threading.enumerate()
                       if t.name.startswith("generation-step-")]
            assert len(workers) <= len(sessions)
            assert len(set(workers)) == len(workers)
        finally:
            sched.close()
        time.sleep(2.2)   # the wedged job returns, and its worker exits
        assert not [t for t in threading.enumerate()
                    if t.name.startswith("generation-step-")]

    def test_timed_steps_reuse_one_thread_per_session(self, weights):
        """Every bounded step of a session runs on the same thread, so
        the kernels' per-thread scratch is taken once, not every step."""
        idents = []
        named = weights[1]
        sess = _port(named)
        run = sess.step_run

        def step_run(prepared):
            idents.append(threading.get_ident())
            return run(prepared)
        sess.step_run = step_run
        sched = GenerationScheduler(sess, step_timeout_ms=5000.0)
        try:
            _served(sched, ([BOS], [2, 3]), 6)
        finally:
            sched.close()
        assert len(idents) >= 5 and len(set(idents)) == 1
        assert idents[0] != threading.get_ident()


# -- session rebuild -------------------------------------------------------

class TestSessionRebuild:
    def test_quarantined_session_rebuilt_and_serves(self, weights, base):
        named = weights[1]
        sess = _port(named)
        old_ns = {n for n, _, _ in sess.spec.cache_vars}
        b0 = _counter("paddle_generation_session_rebuilds_total")
        sched = GenerationScheduler(
            [sess], replay_attempts=10, breaker_failures=1,
            breaker_cooldown_ms=30.0, rebuild_limit=2)
        try:
            faults.arm("generation_step_fail", at=0, times=3)
            assert _served(sched, ([BOS],), 5)[0] == base["bos5"]
            assert _counter("paddle_generation_session_rebuilds_total") \
                == b0 + 1
            new = sched.sessions[0]
            assert {n for n, _, _ in new.spec.cache_vars} != old_ns
            assert sched.session_health() == ["closed"]
            # the replacement took the weights by reference: no copy
            old_state = sess.model.reference_state()
            for name, t in new.model.reference_state().items():
                assert t.data_ptr() == old_state[name].data_ptr(), name
        finally:
            sched.close()

    def test_rebuilt_sampled_session_keeps_policy_bit_identical(self,
                                                                weights):
        scope, named = weights
        seed = 31337
        want = _ref_run(scope, ([BOS],), 5, _sampled(ref_dec), [seed])[0]
        pol = _sampled(port_dec)
        sched = GenerationScheduler(
            [_port(named, decode_policy=pol)], replay_attempts=10,
            breaker_failures=1, breaker_cooldown_ms=30.0, rebuild_limit=2)
        try:
            faults.arm("generation_step_fail", at=0, times=3)
            assert _served(sched, ([BOS],), 5, seeds=[seed])[0] == want
            assert sched.sessions[0].sampled
            assert sched.policy_fingerprint() == pol.fingerprint()
        finally:
            sched.close()

    def test_rebuild_budget_bounded(self, weights):
        sched = GenerationScheduler([_port(weights[1])], autostart=False,
                                    replay_attempts=1, breaker_failures=1,
                                    rebuild_limit=1)
        try:
            sched._rebuilds[0] = 1
            sched._trial_failures[0] = 99
            sched._maybe_rebuild(0)
            assert not sched._rebuilding
            assert sched._rebuilds[0] == 1
        finally:
            sched.close()

    @pytest.mark.parametrize("kind", ["int8", "speculative"])
    def test_rebuild_shares_armed_and_draft_weights(self, weights, kind,
                                                    monkeypatch):
        """A rebuild of an int8-armed session shares the int8 weights and
        scales and quantizes nothing again; a speculative session's
        rebuilt draft shares the rebuilt target's tensors."""
        from paddle_tpu_torch.serving import quant as port_quant
        named = weights[1]
        if kind == "int8":
            spec = port_tf.transformer_lm_session(
                V, max_len=MAXLEN, slots=2, cache_len=MAXLEN,
                prompt_buckets=BUCKETS, device="cpu", decode_policy=None,
                **KW)
            old = GenerationSession(
                spec, port_io.params_from_jax(named, device="cpu"),
                arm_quant=True)
        else:
            old = _port(named, decode_policy=port_dec.DecodePolicy(
                speculate_k=2), paged=True, block_size=4)
        calls = []
        monkeypatch.setattr(port_quant, "quantize_array",
                            lambda *a: calls.append(a))
        new = GenerationScheduler._build_replacement(old)
        assert not calls
        state, want = new.model.reference_state(), \
            old.model.reference_state()
        assert sorted(state) == sorted(want)
        for name, t in state.items():
            assert t.data_ptr() == want[name].data_ptr(), name
        if kind == "int8":
            assert new._quant_armed == old._quant_armed
            w, scale = new.model.mul_weight(new._quant_armed[0])
            assert w.dtype == torch.int8 and scale is not None
        else:
            for name, t in new.draft.model.reference_state().items():
                assert t.data_ptr() == state[name].data_ptr(), name
        assert new.generate([2, 3], max_new_tokens=6, eos_id=-1) == \
            old.generate([2, 3], max_new_tokens=6, eos_id=-1)
        new.close()


# -- deadline during replay ------------------------------------------------

class TestDeadlineDuringReplay:
    def test_expires_parked_without_reprefill(self, weights):
        named = weights[1]
        sched = GenerationScheduler(
            [_port(named, slots=1), _port(named, slots=1)],
            replay_attempts=4, breaker_failures=1,
            breaker_cooldown_ms=60000.0)
        try:
            r_start = _counter("paddle_generation_requests_total")
            # a step of the port on this LM takes ~1 ms: slow session 0
            # so the long generation still holds its slot when the
            # victim's replay parks behind it
            faults.arm("generation_session_wedge", at=0, times=None,
                       action="callback", callback=lambda: time.sleep(0.1))
            long_fut = sched.submit([BOS], max_new_tokens=11, eos_id=-1)
            victim = sched.submit([2, 3], max_new_tokens=8, eos_id=-1,
                                  deadline_ms=400.0)
            deadline = time.monotonic() + 30
            while _counter("paddle_generation_requests_total") \
                    < r_start + 2 and time.monotonic() < deadline:
                time.sleep(0.005)
            req0 = _counter("paddle_generation_requests_total")
            faults.arm("generation_step_fail", at=1, times=None)
            t0 = time.perf_counter()
            with pytest.raises(ServingDeadlineError):
                victim.result(timeout=30)
            assert time.perf_counter() - t0 < 5.0
            assert _counter("paddle_generation_requests_total") == req0
            faults.disarm()
            assert len(long_fut.result(timeout=60)) == 11
        finally:
            sched.close()


# -- breaker-gauge namespace -----------------------------------------------

class TestGaugeNamespace:
    def test_session_gauges_namespaced_and_retired(self, weights):
        named = weights[1]
        sched_a = GenerationScheduler([_port(named)], autostart=False,
                                      breaker_failures=1)
        sched_b = GenerationScheduler([_port(named)], autostart=False,
                                      breaker_failures=1)
        label_a = "g%d:0" % sched_a._sched_id
        label_b = "g%d:0" % sched_b._sched_id
        labels = {c.labels_dict["replica"]
                  for c in REPLICA_HEALTHY.children().values()}
        assert label_a in labels and label_b in labels
        assert label_a != label_b
        assert not any(lb.startswith("e") for lb in (label_a, label_b))
        sched_a.close()
        sched_b.close()
        labels = {c.labels_dict["replica"]
                  for c in REPLICA_HEALTHY.children().values()}
        assert label_a not in labels and label_b not in labels


# -- trace propagation under chaos -----------------------------------------

class TestTracePropagation:
    def test_replay_spans_share_one_trace_id_across_sessions(self, weights,
                                                             base):
        named = weights[1]
        port_config.set_flags(request_tracing=True)
        rtrace.clear()
        sched = GenerationScheduler(
            [_port(named), _port(named)], replay_attempts=4,
            breaker_failures=1, breaker_cooldown_ms=60000.0)
        try:
            faults.arm("generation_step_fail", at=0, times=1)
            assert _served(sched, PROMPTS, 6) == base["greedy"]
        finally:
            sched.close()
            port_config.set_flags(request_tracing=False)
        assert len(rtrace.trace_ids()) == len(PROMPTS)
        replayed = []
        for tid in rtrace.trace_ids():
            events = rtrace.trace_events(tid)
            assert all(e["trace_id"] == tid for e in events)
            names = [e["name"] for e in events]
            if "failoverRequeue" not in names:
                continue
            replayed.append(tid)
            pre = next(e for e in events if e["name"] == "prefill")
            fail = next(e for e in events if e["name"] == "sessionFailure")
            hop = next(e for e in events if e["name"] == "replayAdmit")
            assert fail["attrs"]["session"] == pre["attrs"]["session"] == 0
            assert hop["attrs"]["session"] != 0
            assert hop["attrs"]["journal_len"] >= 2
            assert names.index("failoverRequeue") \
                < names.index("replayAdmit") < names.index("resolve")
        assert replayed, "the injected fault replayed no request"


# -- default-off guarantees ------------------------------------------------

class TestDefaultOff:
    def test_flags_exist_with_defaults(self):
        for name in ("generation_replay_attempts", "generation_rebuild_limit",
                     "generation_step_timeout_ms", "telemetry_port",
                     "serving_breaker_failures"):
            assert port_config.get_flag(name) == \
                ptpu.config.get_flag(name) == 0
        for name in ("request_tracing", "telemetry", "fault_injection"):
            assert port_config.get_flag(name) is False
        assert port_config.get_flag("trace_sample_rate") == 1.0
        assert port_config.get_flag("serving_breaker_cooldown_ms") == \
            ptpu.config.get_flag("serving_breaker_cooldown_ms") == 1000.0
        assert port_config.get_flag("flight_dir") is None

    def test_dispatcher_hot_path_reads_no_flags(self, weights,
                                                monkeypatch):
        sess = _port(weights[1])
        sess.generate([BOS], max_new_tokens=2, eos_id=-1)
        sched = GenerationScheduler(sess)
        try:
            assert sched.replay_attempts == 0
            assert sched.rebuild_limit == 0
            assert sched.step_timeout is None
            calls = []
            orig = port_config.get_flag

            def counting(name):
                calls.append(name)
                return orig(name)
            monkeypatch.setattr(port_config, "get_flag", counting)
            got = sched.submit([BOS], max_new_tokens=4,
                               eos_id=-1).result(timeout=60)
            assert len(got) == 4
            assert not [c for c in calls if c.startswith((
                "generation_", "request_tracing", "trace_sample_rate",
                "telemetry", "flight_dir", "serving_", "decode_"))]
            assert calls, "the fault master switch was never read"
            assert set(calls) <= {"fault_injection", "amp"}
            assert not [t for t in threading.enumerate()
                        if t.name.startswith("generation-step-")]
            assert not rtrace.enabled()
        finally:
            sched.close()

    def test_default_step_failure_still_resolves_exceptionally(self,
                                                               weights):
        sched = GenerationScheduler(_port(weights[1]))
        try:
            faults.arm("generation_step_fail", at=0, times=1)
            fut = sched.submit([BOS], max_new_tokens=5, eos_id=-1)
            with pytest.raises(faults.InjectedFault):
                fut.result(timeout=30)
        finally:
            sched.close()


# -- scheduler resilience (tests/test_generation.py) -----------------------

class TestSchedulerResilience:
    def test_expired_deadline_never_reaches_a_slot(self, weights):
        sess = _port(weights[1], slots=1, prompt_buckets=(4,))
        sched = GenerationScheduler(sess, autostart=False)
        fut = sched.submit([BOS], deadline_ms=1)
        time.sleep(0.02)
        sched.start()
        with pytest.raises(ServingDeadlineError):
            fut.result(timeout=5)
        assert sess.prefills == 0
        sched.close()

    def test_queued_deadline_expires_while_all_slots_busy(self, weights):
        sess = _port(weights[1], slots=1, prompt_buckets=(4,))
        faults.arm("generation_session_wedge", at=0, times=None,
                   action="callback", callback=lambda: time.sleep(0.02))
        sched = GenerationScheduler(sess)
        try:
            long_fut = sched.submit([BOS], max_new_tokens=11, eos_id=-1)
            doomed = sched.submit([BOS], deadline_ms=30, eos_id=-1)
            t0 = time.perf_counter()
            with pytest.raises(ServingDeadlineError):
                doomed.result(timeout=10)
            assert time.perf_counter() - t0 < 5.0
            assert len(long_fut.result(timeout=60)) == 11
        finally:
            sched.close()

    def test_placement_respects_token_budget_capacity(self, weights):
        named = weights[1]
        # a 6-position model: the reference reads the first 6 rows of the
        # position table from the scope, the port loads them
        short = dict(named, **{"pos_encoding_0.w_0":
                               named["pos_encoding_0.w_0"][:6]})
        tiny = _port(short, slots=1, max_len=6, cache_len=6,
                     prompt_buckets=(4,))
        big = _port(named, slots=1, prompt_buckets=(4,))
        sched = GenerationScheduler([tiny, big])
        try:
            got = sched.submit([BOS], max_new_tokens=10,
                               eos_id=-1).result(timeout=60)
            assert len(got) == 10
        finally:
            sched.close()

    def test_one_spec_two_sessions_own_their_caches(self, weights, base):
        """The reference refuses a second session on one spec and scope,
        whose cache variables it would share (``already driven``). A port
        session allocates its caches itself, so two sessions of one spec
        hold disjoint caches and serve independently (a difference by
        design); close() frees them."""
        named = weights[1]
        spec = port_tf.transformer_lm_session(
            V, max_len=MAXLEN, slots=2, cache_len=MAXLEN,
            prompt_buckets=BUCKETS, bos_id=BOS, eos_id=EOS, device="cpu",
            decode_policy=None, **KW)
        params = port_io.params_from_jax(named, device="cpu")
        a, b = GenerationSession(spec, params), GenerationSession(spec,
                                                                  params)
        ptrs = {t.data_ptr() for s in (a, b) for kv in s.model.caches
                for t in kv}
        assert len(ptrs) == 2 * 2 * KW["num_layers"]
        sa, _ = a.admit([BOS])
        assert b.generate([BOS], max_new_tokens=5, eos_id=-1) == \
            base["bos5"]
        a.retire(sa)
        a.close()
        assert a.model.caches == []
        assert b.generate([BOS], max_new_tokens=4, eos_id=-1) == \
            base["bos4"]

    def test_negative_budget_rejected_synchronously(self, weights):
        sched = GenerationScheduler(
            _port(weights[1], slots=1, prompt_buckets=(4,)),
            autostart=False)
        with pytest.raises(ServingDeadlineError):
            sched.submit([BOS], deadline_ms=-5)
        sched.close()

    def test_full_queue_backpressure(self, weights):
        sched = GenerationScheduler(
            _port(weights[1], slots=1, prompt_buckets=(4,)), max_queue=1,
            autostart=False)
        sched.submit([BOS])
        with pytest.raises(ServingOverloadError):
            sched.submit([BOS], timeout=0.01)
        sched.close()

    def test_projected_wait_sheds_hopeless_deadline(self, weights):
        """The queue-wait EWMA projects the admission wait; a deadline
        budget it already exceeds is shed at the door and counted."""
        sched = GenerationScheduler(
            _port(weights[1], slots=1, prompt_buckets=(4,)),
            autostart=False)
        try:
            s0 = _counter("paddle_serving_shed_total")
            sched._wait_ewma = 0.5           # 500 ms a request
            sched.submit([BOS])
            with pytest.raises(ServingOverloadError, match="shed"):
                sched.submit([BOS], deadline_ms=100.0)
            assert _counter("paddle_serving_shed_total") == s0 + 1
            assert sched._wait_ewma == pytest.approx(0.4)
        finally:
            sched.close()

    def test_step_failure_opens_breaker_and_fails_requests(self, weights):
        sess = _port(weights[1], slots=2, prompt_buckets=(4,))
        sched = GenerationScheduler(sess, breaker_failures=1,
                                    breaker_cooldown_ms=60000.0)
        try:
            faults.arm("generation_step_fail", times=1)
            fut = sched.submit([BOS], max_new_tokens=6)
            with pytest.raises(faults.InjectedFault):
                fut.result(timeout=30)
            deadline = time.monotonic() + 5
            while sched.session_health() != ["open"] and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            assert sched.session_health() == ["open"]
            fut2 = sched.submit([BOS], max_new_tokens=2)
            with pytest.raises(ServingUnavailableError):
                fut2.result(timeout=30)
        finally:
            sched.close()


# -- weight swap -----------------------------------------------------------

@pytest.fixture(scope="module")
def weights11():
    """The seed-11 LM and the reference's greedy stream of [BOS] on it."""
    scope, named = _scope(11)
    sess = _ref_session(scope)
    try:
        want = [int(t) for t in sess.generate([BOS], max_new_tokens=4,
                                              eos_id=-1)]
    finally:
        sess.close()
    return named, want


class TestSwapWeights:
    def test_swap_weights_between_steps(self, weights, weights11, base):
        named = weights[1]
        sess = _port(named, slots=2, prompt_buckets=(4,))
        sched = GenerationScheduler(sess)
        try:
            old = [int(t) for t in sched.submit(
                [BOS], max_new_tokens=4, eos_id=-1).result(timeout=60)]
            assert old == base["bos4"]
            assert sched.swap_weights(weights11[0]) == 1
            new = [int(t) for t in sched.submit(
                [BOS], max_new_tokens=4, eos_id=-1).result(timeout=60)]
            assert new == weights11[1]
            assert sched.weights_version == 1
        finally:
            sched.close()

    def test_swap_rejects_bad_push(self, weights):
        sess = _port(weights[1], slots=1, prompt_buckets=(4,))
        sched = GenerationScheduler(sess, autostart=False)
        try:
            with pytest.raises(ValueError, match="unknown variable"):
                sched.swap_weights({"nope": np.zeros(3, "float32")})
            with pytest.raises(ValueError, match="signature mismatch"):
                sched.swap_weights(
                    {"tok_embedding": np.zeros((2, 2), "float32")})
            with pytest.raises(ValueError, match="cache variable"):
                name, shape, _ = sess.spec.cache_vars[0]
                sched.swap_weights({name: np.zeros(shape, "float32")})
            assert sched.weights_version == 0
        finally:
            sched.close()

    def test_swap_refuses_int8_weight_without_its_scales(self, weights):
        spec = port_tf.transformer_lm_session(
            V, max_len=MAXLEN, slots=1, cache_len=MAXLEN,
            prompt_buckets=(4,), device="cpu", decode_policy=None, **KW)
        sess = GenerationSession(
            spec, port_io.params_from_jax(weights[1], device="cpu"),
            arm_quant=True)
        name = sess._quant_armed[0]
        w, scale = sess.model.mul_weight(name)
        sched = GenerationScheduler(sess, autostart=False)
        try:
            with pytest.raises(ValueError, match="without its scales"):
                sched.swap_weights({name: w.clone()})
            with pytest.raises(ValueError, match="without their int8"):
                sched.swap_weights({name + "@quant.scale": scale.clone()})
            assert sched.swap_weights({name: w.clone(),
                                       name + "@quant.scale":
                                       scale.clone()}) == 1
            assert sess.model.mul_weight(name)[0].dtype == torch.int8
        finally:
            sched.close()

    def test_swap_reaches_a_sharing_draft_and_keeps_sharing(self, weights,
                                                            weights11):
        """Rebinding reaches the speculative self-draft and a second
        session sharing the weights (one new tensor for both), and
        leaves a session outside the scheduler on the old tensors."""
        named = weights[1]
        pol = port_dec.DecodePolicy(speculate_k=2)
        a = _port(named, decode_policy=pol, paged=True, block_size=4)
        spec = port_tf.transformer_lm_session(
            V, max_len=MAXLEN, slots=2, cache_len=MAXLEN,
            prompt_buckets=BUCKETS, bos_id=BOS, eos_id=EOS, device="cpu",
            paged=True, block_size=4, decode_policy=pol, **KW)
        b = GenerationSession(spec, a.model.reference_state(), share=True)
        outside = GenerationSession(spec, a.model.reference_state(),
                                    share=True)
        old_ptr = a.model.tok_embedding.data_ptr()
        sched = GenerationScheduler([a, b], autostart=False)
        try:
            sched.swap_weights(weights11[0])
        finally:
            sched.close()
        sa, sb = a.model.reference_state(), b.model.reference_state()
        for name, t in sa.items():
            assert t.data_ptr() == sb[name].data_ptr(), name
        for model in (a.draft.model, b.draft.model):
            for name, t in model.reference_state().items():
                assert t.data_ptr() == sa[name].data_ptr(), name
        assert outside.model.tok_embedding.data_ptr() == old_ptr
        want = weights11[1]
        assert a.generate([BOS], max_new_tokens=4, eos_id=-1) == want
        assert b.generate([BOS], max_new_tokens=4, eos_id=-1) == want

    def test_swap_during_a_wedged_step_writes_no_live_tensor(self, weights,
                                                             weights11):
        """A swap applied while a step is left behind past its timeout
        writes nothing that step reads: the old tensors keep their values
        bit for bit, and the sessions serve the new weights."""
        named = weights[1]
        sessions = [_port(named), _port(named)]
        old = {n: t.clone() for n, t in
               sessions[0].model.reference_state().items()}
        live = sessions[0].model.reference_state()
        release = threading.Event()
        sched = GenerationScheduler(
            sessions, replay_attempts=4, breaker_failures=1,
            breaker_cooldown_ms=60000.0, step_timeout_ms=300.0)
        try:
            faults.arm("generation_session_wedge", at=0, times=1,
                       action="callback", callback=lambda: release.wait(10))
            first = sched.submit([BOS], max_new_tokens=4, eos_id=-1)
            assert len(first.result(timeout=60)) == 4
            assert sched._wedged
            assert sched.swap_weights(weights11[0]) == 1
            release.set()
            got = [int(t) for t in sched.submit(
                [BOS], max_new_tokens=4, eos_id=-1).result(timeout=60)]
            assert got == weights11[1]
        finally:
            release.set()
            sched.close()
        for name, t in live.items():
            assert torch.equal(t, old[name]), name


# -- preemption and paged failover (tests/test_paged_cache.py) -------------

def _ref_paged(scope, slots, num_blocks, prefix_cache):
    spec = ref_lm_session(V, max_len=MAXLEN, slots=slots, cache_len=16,
                          prompt_buckets=(4, 8), bos_id=BOS, eos_id=EOS,
                          paged=True, block_size=4, num_blocks=num_blocks,
                          prefix_cache=prefix_cache, **KW)
    return RefSession(spec, scope=scope)


def _port_paged(named, slots, num_blocks, prefix_cache=True):
    return _port(named, slots=slots, prompt_buckets=(4, 8), cache_len=16,
                 paged=True, block_size=4, num_blocks=num_blocks,
                 prefix_cache=prefix_cache)


class TestPagedPreemption:
    def test_pool_preemption_replays_explicit_budget_in_full(self,
                                                             weights):
        scope, named = weights
        ref = _ref_paged(scope, 2, 8, False)
        try:
            solos = {p: [int(t) for t in ref.generate(
                list(p), max_new_tokens=8, eos_id=-1)]
                for p in ((2, 3), (4, 5))}
        finally:
            ref.close()
        p0 = _counter("paddle_generation_retired_total", reason="preempted")
        sess = _port_paged(named, 2, 3, prefix_cache=False)
        sched = GenerationScheduler(sess, replay_attempts=4)
        try:
            futs = {p: sched.submit(list(p), max_new_tokens=8, eos_id=-1)
                    for p in solos}
            for p, f in futs.items():
                assert [int(t) for t in f.result(timeout=120)] == solos[p]
        finally:
            sched.drain()
        assert _counter("paddle_generation_retired_total",
                        reason="preempted") > p0
        sess.check_pool_invariant()
        assert sess.pool.used_count() == 0

    def test_starved_sequence_finishes_short_with_replay_off(self,
                                                             weights):
        sess = _port_paged(weights[1], 2, 3, prefix_cache=False)
        sched = GenerationScheduler(sess)
        try:
            futs = [sched.submit([2, 3], max_new_tokens=8, eos_id=-1),
                    sched.submit([4, 5], max_new_tokens=8, eos_id=-1)]
            outs = [f.result(timeout=60) for f in futs]
        finally:
            sched.drain()
        assert any(len(o) < 8 for o in outs), [len(o) for o in outs]
        assert sess.pool.used_count() == 0

    def test_replay_bit_identical_with_suffix_only_reprefill(self, weights):
        scope, named = weights
        prompt = [2, 3, 4, 5, 6, 7, 8, 9]
        ref = _ref_paged(scope, 2, 24, True)
        try:
            baseline = [int(t) for t in ref.generate(
                prompt, max_new_tokens=6, eos_id=-1)]
        finally:
            ref.close()
        s_a, s_b = _port_paged(named, 2, 24), _port_paged(named, 2, 24)
        s_b.generate(prompt, max_new_tokens=1, eos_id=-1)
        warm_log = len(s_b.prefill_log)
        sched = GenerationScheduler([s_a, s_b], breaker_failures=1,
                                    breaker_cooldown_ms=10000,
                                    replay_attempts=2)
        try:
            faults.arm("generation_step_fail", at=0, times=None)
            got = [int(t) for t in sched.submit(
                prompt, max_new_tokens=6, eos_id=-1).result(timeout=120)]
        finally:
            faults.disarm()
            sched.drain()
        assert got == baseline
        replay_log = s_b.prefill_log[warm_log:]
        assert replay_log and all(h >= 8 for _, h, _ in replay_log), \
            replay_log
        s_a.check_pool_invariant()
        s_b.check_pool_invariant()

    def test_leaked_step_worker_cannot_corrupt_pool_books(self, weights):
        scope, named = weights
        prompts = ([2, 3, 4], [5, 6])
        ref = _ref_paged(scope, 2, 24, True)
        try:
            want = [[int(t) for t in ref.generate(
                list(p), max_new_tokens=5, eos_id=-1)] for p in prompts]
        finally:
            ref.close()
        s_a, s_b = _port_paged(named, 2, 24), _port_paged(named, 2, 24)
        sched = GenerationScheduler(
            [s_a, s_b], replay_attempts=4, breaker_failures=3,
            breaker_cooldown_ms=60000.0, step_timeout_ms=400.0)
        try:
            faults.arm("generation_session_wedge", at=0, times=1,
                       action="callback", callback=lambda: time.sleep(1.0))
            assert _served(sched, prompts, 5, timeout=120) == want
            assert sched.session_health()[0] == "open"
            time.sleep(1.2)   # the left-behind step returns
            s_a.check_pool_invariant()
            s_b.check_pool_invariant()
        finally:
            sched.close()


# -- decode-policy fault sites (tests/test_decoding.py) --------------------

DEC_MAXLEN = 24


def _dec_port(named, policy, paged=True, **over):
    return _port(named, decode_policy=policy, paged=paged, block_size=4,
                 max_len=DEC_MAXLEN, cache_len=DEC_MAXLEN,
                 prompt_buckets=(4, 8, 16), **over)


@pytest.fixture(scope="module")
def dec_weights():
    """The reference's test_decoding LM (MAXLEN 24), seed 7."""
    return _scope(7, DEC_MAXLEN)


def test_draft_mismatch_fault_forces_rollback(dec_weights):
    named = dec_weights[1]
    r0 = _counter("paddle_generation_kv_spec_rollback_blocks_total")
    perfect = port_dec.DecodePolicy(speculate_k=3,
                                    draft=dict(num_layers=KW["num_layers"]))
    sess = _dec_port(named, perfect)
    faults.arm("decode_draft_mismatch", at=0, times=2)
    out = sess.generate([BOS, 5, 7], max_new_tokens=12, eos_id=-1)
    faults.disarm("decode_draft_mismatch")
    sess.check_pool_invariant()
    base = _dec_port(named, None).generate([BOS, 5, 7], max_new_tokens=12,
                                           eos_id=-1)
    assert out == base
    assert _counter("paddle_generation_kv_spec_rollback_blocks_total") > r0
    assert sess.spec_accepted < sess.spec_drafted


def test_dead_end_fault_site(dec_weights):
    dfa = port_dec.DFAConstraint({0: {5: 1}, 1: {6: 2}, 2: {EOS: 2}})
    faults.arm("decode_constraint_dead_end", at=0, times=1)
    sched = GenerationScheduler(
        _dec_port(dec_weights[1], port_dec.DecodePolicy(constraint=dfa),
                  paged=False), autostart=False)
    f = sched.submit([BOS, 5, 7], max_new_tokens=8)
    sched.drain()
    with pytest.raises(port_dec.ConstraintDeadEnd):
        f.result(1)


def test_speculative_rejects_step_timeout(dec_weights):
    sess = _dec_port(dec_weights[1], port_dec.DecodePolicy(speculate_k=2))
    with pytest.raises(ValueError, match="step_timeout"):
        GenerationScheduler(sess, step_timeout_ms=500, autostart=False)


def test_speculative_counters_count_drafts_and_accepts(dec_weights):
    """The registry's speculative counters rise by the session's own
    counts, which stay readable as ``spec_drafted`` / ``spec_accepted``
    (read-only)."""
    d0 = _counter("paddle_generation_speculative_drafted_total")
    a0 = _counter("paddle_generation_speculative_accepted_total")
    sess = _dec_port(dec_weights[1], port_dec.DecodePolicy(
        speculate_k=3, draft=dict(num_layers=KW["num_layers"])))
    sess.generate([BOS, 5, 7], max_new_tokens=12, eos_id=-1)
    assert sess.spec_drafted == 3 * sess.verifies > 0
    assert _counter("paddle_generation_speculative_drafted_total") - d0 \
        == sess.spec_drafted
    assert _counter("paddle_generation_speculative_accepted_total") - a0 \
        == sess.spec_accepted == sess.spec_drafted
    with pytest.raises(AttributeError):
        sess.spec_drafted = 0


# -- checks owed by the decode policies ------------------------------------

def test_speculative_near_capacity_fallback_equals_reference(dec_weights):
    """A request that runs to within k rows of the cache: the session
    falls back to plain rounds (the draft mirroring them) and the stream
    equals plain decoding, the reference's speculative stream and the
    reference's plain one."""
    scope, named = dec_weights

    def ref_stream(policy):
        spec = ref_lm_session(V, max_len=DEC_MAXLEN, slots=2,
                              prompt_buckets=(4, 8, 16), bos_id=BOS,
                              eos_id=EOS, paged=True, block_size=4,
                              decode_policy=policy, **KW)
        sess = RefSession(spec, scope=scope)
        try:
            return [int(t) for t in sess.generate([BOS, 5, 7], eos_id=-1)]
        finally:
            sess.close()
    pol = port_dec.DecodePolicy(speculate_k=3)
    spec_sess = _dec_port(named, pol)
    mirrors = []
    mirror = spec_sess._draft_mirror_plain

    def counted(result):
        mirrors.append(dict(result))
        return mirror(result)
    spec_sess._draft_mirror_plain = counted
    got = spec_sess.generate([BOS, 5, 7], eos_id=-1)
    assert len(got) == DEC_MAXLEN - 3 + 1   # to the cache's last row
    assert mirrors, "no plain round ran near capacity"
    assert spec_sess.verifies > 0
    spec_sess.check_pool_invariant()
    plain = _dec_port(named, None).generate([BOS, 5, 7], eos_id=-1)
    assert got == plain
    assert got == ref_stream(ref_dec.DecodePolicy(speculate_k=3)) == \
        ref_stream(None)


def test_int8_whole_target_draft_accepts_as_the_reference(dec_weights):
    """The int8 speculative session with the whole target as its draft:
    the port accepts exactly as many drafts as the reference on the same
    weights, prompts and k (each reference session on its own scope copy,
    since its arming quantizes the scope in place)."""
    scope, named = dec_weights
    prompts = ([BOS, 5, 7], [2, 3, 4, 5, 6], [9, 3, 2, 11, 4, 8, 13])
    draft = dict(num_layers=KW["num_layers"])
    ref_scope = ptpu.Scope()
    for n, v in named.items():
        ref_scope.set_var(n, np.array(v))
    spec = ref_lm_session(V, max_len=DEC_MAXLEN, slots=2,
                          prompt_buckets=(4, 8, 16), bos_id=BOS, eos_id=EOS,
                          paged=True, block_size=4,
                          decode_policy=ref_dec.DecodePolicy(
                              speculate_k=3, draft=draft), **KW)
    ref = RefSession(spec, scope=ref_scope, arm_quant=True)
    a0 = _counter("paddle_generation_speculative_accepted_total",
                  ref_metrics.REGISTRY)
    d0 = _counter("paddle_generation_speculative_drafted_total",
                  ref_metrics.REGISTRY)
    try:
        ref_out = [[int(t) for t in ref.generate(p, max_new_tokens=12,
                                                 eos_id=-1)]
                   for p in prompts]
    finally:
        ref.close()
    ref_acc = _counter("paddle_generation_speculative_accepted_total",
                       ref_metrics.REGISTRY) - a0
    ref_drafted = _counter("paddle_generation_speculative_drafted_total",
                           ref_metrics.REGISTRY) - d0
    sess = _dec_port(named, port_dec.DecodePolicy(speculate_k=3,
                                                  draft=draft),
                     arm_quant=True)
    out = [sess.generate(p, max_new_tokens=12, eos_id=-1) for p in prompts]
    assert out == ref_out
    assert (sess.spec_accepted, sess.spec_drafted) == (ref_acc, ref_drafted)


def test_swap_flushes_the_prefix_cache(weights, weights11):
    """A prompt cached before a swap is prefilled again after it: the
    stream equals a fresh session's on the new weights. (The reference
    keeps its prefix index across a swap, so its next admission of the
    prompt would share K/V rows the old weights computed.)"""
    named11, _ = weights11
    prompt = [2, 3, 4, 5, 6, 7, 8, 9]
    sess = _port_paged(weights[1], 2, 24)
    sched = GenerationScheduler(sess, autostart=False)
    try:
        sess.generate(prompt, max_new_tokens=2, eos_id=-1)
        assert sess.prefix.peek(prompt) == 8
        sched.swap_weights(named11)
        assert len(sess.prefix) == 0
        got = sess.generate(prompt, max_new_tokens=4, eos_id=-1)
        assert sess.prefill_log[-1][1] == 0      # nothing shared
    finally:
        sched.close()
    fresh = _port_paged(named11, 2, 24)
    assert got == fresh.generate(prompt, max_new_tokens=4, eos_id=-1)
    sess.check_pool_invariant()


@pytest.mark.parametrize("arm", [False, True], ids=["f32", "int8"])
def test_paged_replay_reruns_generated_rows_as_decode_steps(dec_weights,
                                                            arm):
    """A paged replay admission (``decoded`` > 0) prefills the prompt's
    rows and re-runs the journal's generated rows through the decode
    step's arithmetic (``verify_paged``): every K/V row and the owed token
    are bitwise those of the fault-free decode (the reference re-prefills
    the whole journal through its prefill attention)."""
    named = dec_weights[1]

    def make():
        return _dec_port(named, None, arm_quant=arm)
    a, b = make(), make()
    prompt = [2, 3, 4, 5, 6]
    sa, first = a.admit(prompt)
    toks = [first]
    for _ in range(6):
        toks.append(a.step()[sa])
    hist = np.asarray(prompt + toks[:-1])
    sb, owed = b.admit(hist, decoded=len(toks) - 1)
    assert owed == toks[-1]
    n = hist.size
    for (ka, va), (kb, vb) in zip(a.model.caches, b.model.caches):
        for pool_a, pool_b in ((ka, kb), (va, vb)):
            ra = [a.tables[sa][p // 4] * 4 + p % 4 for p in range(n)]
            rb = [b.tables[sb][p // 4] * 4 + p % 4 for p in range(n)]
            assert torch.equal(pool_a.reshape(-1, pool_a.shape[-1])[ra],
                               pool_b.reshape(-1, pool_b.shape[-1])[rb])
    assert b.prefill_log[-1] == (16, 0, n)   # the whole window's bucket
    a.check_pool_invariant()
    b.check_pool_invariant()
