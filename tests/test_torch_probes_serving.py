"""The LM probes of ``paddle_tpu_torch.probes`` (``paged_cache``,
``trace``, ``generate``, ``decode_policy``) against the reference probes
of ``tools/``, loaded from their paths, on the CPU at the reference's own
small widths (``--model small``; ``paged_cache`` and ``trace`` also at
``small-h64``, the widths their card runs take), both sides on the
reference probes' seeded weights: the reference's run (its ``main``
where it prints what is compared, otherwise its own functions) beside
the port probe's ``run``. The reference's startup programs are not compiled
(``test_torch_probes_measure.fast_startup``), and the probes' workloads
are cut where a constant of theirs allows (fewer requests, tokens and
rounds for ``trace``, 8 steps for ``generate``, 16 tokens for
``decode_policy``).

Held exactly: ``paged_cache``'s prefix counters, prefill log, pool and
dense-equivalent bytes and both concurrency counts, and its closed
shape set; ``trace``'s tokens with tracing off and on and under the
fault, the replayed request's span names and failover hop;
``generate``'s re-encode and cached greedy tokens; ``decode_policy``'s
greedy and speculative tokens and the drafted and accepted counts."""

import ast
import json
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu.models.transformer import \
    transformer_lm_session as ref_lm_session
from paddle_tpu.observability import flight as ref_flight
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu.serving.decoding import DecodePolicy as RefPolicy
from paddle_tpu.serving.generation import GenerationSession as RefSession
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch.observability import flight
from paddle_tpu_torch.probes import (common, decode_policy, generate,
                                     paged_cache, trace)
from paddle_tpu_torch.resilience import faults
from test_torch_ops_cases import one_thread  # noqa: F401
from test_torch_probes_measure import fast_startup, ref_probe  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread", "fast_startup", "state")

CPU = torch.device("cpu")


@pytest.fixture
def state(tmp_path):
    """Both packages' config flags and flight recorders as they were, the
    faults disarmed; the bundles go to ``tmp_path``."""
    ref, port = dict(ptpu.config._flags), dict(port_config._flags)
    recs = [(r, r.min_interval_sec, r._last_dump_t)
            for r in (ref_flight.RECORDER, flight.RECORDER)]
    ptpu.config.set_flags(flight_dir=str(tmp_path / "ref"))
    port_config.set_flags(flight_dir=str(tmp_path / "port"))
    yield
    faults.disarm()
    ref_faults.disarm()
    for r, interval, last in recs:
        r.min_interval_sec, r._last_dump_t = interval, last
    ptpu.config.set_flags(**{k: v for k, v in ref.items()
                             if ptpu.config._flags.get(k) != v})
    port_config.set_flags(**{k: v for k, v in port.items()
                             if port_config._flags.get(k) != v})


def _json_lines(text):
    out = []
    for line in text.splitlines():
        if line.startswith("{"):
            out.append(json.loads(line))
    return out


def test_lm_widths_presets():
    """``small`` is each reference probe's own widths, and on the card it
    is refused where its heads are narrower than the attention kernels
    take (``paged_cache`` and ``trace``: 32 wide); ``small-h64`` keeps
    every width but the heads' (64 wide); ``flagship`` is the flagship
    LM whatever the probe."""
    cuda = torch.device("cuda")
    for probe in (paged_cache, trace, generate, decode_policy):
        assert common.lm_widths("small", probe.VOCAB, probe.KW, CPU) == \
            (probe.VOCAB, probe.KW)
        vocab, kw = common.lm_widths("small-h64", probe.VOCAB, probe.KW,
                                     cuda)
        assert vocab == probe.VOCAB
        assert kw["d_model"] // kw["num_heads"] == 64
        assert {k: v for k, v in kw.items() if k != "num_heads"} == \
            {k: v for k, v in probe.KW.items() if k != "num_heads"}
        vocab, kw = common.lm_widths("flagship", probe.VOCAB, probe.KW, cuda)
        assert dict(kw, vocab_size=vocab) == common.FLAGSHIP_LM
    for probe in (paged_cache, trace):
        with pytest.raises(ValueError, match="small-h64"):
            common.lm_widths("small", probe.VOCAB, probe.KW, cuda)
    for probe in (generate, decode_policy):
        assert common.lm_widths("small", probe.VOCAB, probe.KW, cuda) == \
            (probe.VOCAB, probe.KW)


@pytest.mark.parametrize("model", ["small", "small-h64"])
def test_paged_cache_matches_the_reference(monkeypatch, capsys, model):
    """The reference probe's printed counts against the port probe's, at
    8 requests: equal, with its two ratios as it rounds them. At
    ``small-h64`` (the card's small run: the same widths in 64-wide
    heads) the reference runs at those widths too."""
    ref = ref_probe("paged_cache_probe")
    vocab, kw = common.lm_widths(model, paged_cache.VOCAB, paged_cache.KW,
                                 CPU)
    monkeypatch.setattr(ref, "KW", kw)
    monkeypatch.setattr(sys, "argv", ["paged_cache_probe", "--requests", "8"])
    assert ref.main() == 0
    out = capsys.readouterr().out
    want = _json_lines(out)
    log_line = next(l for l in out.splitlines()
                    if l.startswith("prefill log"))
    want_log = ast.literal_eval(log_line.split(": ", 1)[1])
    docs = paged_cache.run(vocab, kw, CPU, 8)
    prefix, log, memory, compiles, conc = docs[:5]
    rate = prefix.pop("prefix_hit_rate")
    assert round(rate, 3) == want[0].pop("prefix_hit_rate")
    assert prefix == want[0]
    assert log["prefill_log"] == [tuple(e) for e in want_log]
    assert memory == want[1]
    assert compiles["executor_compiles"] <= 4
    assert compiles["executor_compiles"] == want[2]["executor_compiles"]
    gain = conc.pop("concurrency_gain")
    assert round(gain, 2) == want[3].pop("concurrency_gain")
    assert conc == want[3]


@pytest.mark.parametrize("model", ["small", "small-h64"])
def test_trace_matches_the_reference(monkeypatch, capsys, model):
    """The reference probe at 4 requests of 4 tokens and one overhead
    round, its workload's tokens recorded, against the port probe's: the
    baseline's tokens equal (each side also holds its tracing-on and
    faulted runs to them), the replayed request's span names, event count
    and failover hop equal, and each dumped a bundle for the breaker. At
    ``small-h64`` the reference runs at those widths too."""
    ref = ref_probe("trace_probe")
    vocab, kw = common.lm_widths(model, trace.VOCAB, trace.KW, CPU)
    monkeypatch.setattr(ref, "KW", kw)
    monkeypatch.setattr(ref, "N_REQUESTS", 4)
    monkeypatch.setattr(ref, "MAX_NEW", 4)
    monkeypatch.setattr(ref.measure_overhead, "__defaults__", (1,))
    seen = []
    real = ref.run_workload

    def recording(sched):
        out = real(sched)
        seen.append(out)
        return out
    monkeypatch.setattr(ref, "run_workload", recording)
    ref.main()
    want = {d["probe"]: d for d in _json_lines(capsys.readouterr().out)}
    docs, base = trace.run(vocab, kw, CPU, rounds=1, n_requests=4,
                           max_new=4)
    got = {d["probe"]: d for d in docs}
    assert base == seen[0] == seen[-1]
    for key in ("span_names", "hop", "events", "healthz"):
        assert got["failover_trace"][key] == want["failover_trace"][key], key
    assert got["flight_recorder"]["reason"] == \
        want["flight_recorder"]["reason"] == "breaker_open"
    assert got["trace_probe"]["ok"] and want["trace_probe"]["ok"]


def test_generate_tokens_match_the_reference():
    """At 8 steps (re-encode at 8 and 16 tokens; the session's 24
    positions): the re-encode program's ids and one slot's cached greedy
    tokens at 8 and 16 equal the reference's, each on the reference
    probe's weights for its length."""
    ref = ref_probe("generate_probe")
    steps = 8
    _, tokens = generate.run(generate.VOCAB, generate.KW, CPU, steps=steps)
    for length in (steps, 2 * steps):
        with ptpu.unique_name.guard():
            scope, exe, main, ids = ref.build_scope(length)
        want = exe.run(main, feed={"anchor": np.zeros((1, 1), "int32")},
                       fetch_list=[ids], scope=scope)[0]
        assert tokens["reencode_%d" % length] == \
            [int(t) for t in np.asarray(want).reshape(-1)]
    with ptpu.unique_name.guard():
        scope = ref.build_scope(max(2 * steps, steps + 16))[0]
    for length in (steps, 2 * steps):
        spec = ref_lm_session(
            ref.VOCAB, max_len=length, slots=1, cache_len=length,
            prompt_buckets=(8,), bos_id=ref.BOS, eos_id=ref.EOS, **ref.KW)
        sess = RefSession(spec, scope=scope)
        want = sess.generate([ref.BOS], max_new_tokens=length, eos_id=-1)
        assert tokens["cached_%d" % length] == [int(t) for t in want]


def _ref_counter(name):
    for s in ref_metrics.REGISTRY.dump().get(name, {}).get("samples", ()):
        return s["value"]
    return 0.0


def test_decode_policy_matches_the_reference():
    """At 16 tokens on the reference's small-residual weights: greedy and
    speculative (the 1-layer self-draft, k 4) tokens equal the
    reference's, speculative equal to greedy, and the drafted and
    accepted counts of the speculative run equal the reference's."""
    ref = ref_probe("decode_policy_probe")
    n = 16
    doc, runs = decode_policy.run(decode_policy.VOCAB, decode_policy.KW, CPU,
                                  lengths=(n,))
    assert not [e for e in doc["errors"] if "SLOWER" not in e]
    with ptpu.unique_name.guard():
        scope = ref.build_scope()
    plain = ref.session(scope, None)
    greedy, _ = ref.timed_generate(plain, decode_policy.PROMPT, n)
    plain.close()
    d0 = _ref_counter(decode_policy.DRAFTED)
    a0 = _ref_counter(decode_policy.ACCEPTED)
    spec = ref.session(scope, RefPolicy(kind="greedy",
                                        speculate_k=ref.SPECULATE_K))
    out, _ = ref.timed_generate(spec, decode_policy.PROMPT, n)
    spec.close()
    assert runs["greedy_%d" % n] == [int(t) for t in greedy]
    assert runs["speculative_%d" % n] == [int(t) for t in out] == \
        runs["greedy_%d" % n]
    assert runs["drafted_%d" % n] == \
        _ref_counter(decode_policy.DRAFTED) - d0
    assert runs["accepted_%d" % n] == \
        _ref_counter(decode_policy.ACCEPTED) - a0
    assert runs["drafted_%d" % n] > 0
