"""Decode policies: sampling's cost, and speculative decoding's accept
rate and speedup (reference ``tools/decode_policy_probe.py``).

    python3 -m paddle_tpu_torch.probes.decode_policy
        [--model small|flagship] [--device cpu]

One slot of a paged session (block 16, bucket 8, 160 positions) from the
prompt [0, 5, 7, 11], each generation timed on its second call (the
first, of 4 tokens, warms it), wall clock ended by the tokens read back:

* ``sampling_overhead_pct``: 64 tokens sampled (temperature 0.9, top-k
  40, seed 1234) against 64 greedy;
* ``speculative_accept_rate``: accepted over drafted tokens of the
  1-layer self-draft at k 4, over 64 tokens (the registry's
  ``paddle_generation_speculative_*`` counters);
* ``speculative_speedup_len{64,128}``: greedy time over speculative time
  at 64 and 128 tokens.

The weights are the reference's small-residual init: seed-7 standard
normals, the layer norms at their initial gain 1 and bias 0, the
residual-writing projections (``.o.w``, ``.ffn2.``) scaled by
1e-3 / sqrt(fan_in), so the 1-layer draft mostly agrees with the target.
Prints one JSON document; ``ok`` is false, and the exit code 1, if the
speculative tokens differ from greedy's, the pool's books break, the
accept rate is 0, or speculation is not faster than greedy at either
length (the reference's checks). ``--model small`` is the reference's
LM (vocab 256, d_model 256, 4 heads, d_ff 1024, 6 layers), ``flagship``
the flagship LM's widths.
"""

import argparse
import json
import sys
import time

from ..models.transformer import transformer_lm_session
from ..observability import metrics
from ..serving.decoding import DecodePolicy
from ..serving.generation import GenerationSession
from .common import (launch_counts, launches_since, lm_scope, lm_widths,
                     probe_device)

VOCAB = 256
KW = dict(d_model=256, num_heads=4, d_ff=1024, num_layers=6)
MAX_LEN = 160
BOS, EOS = 0, 1
# each block writes ~eps of the unit-variance residual stream: the
# 1/sqrt(fan_in) factor cancels a random N(0, 1) matrix's ~sqrt(d) gain
RESIDUAL_EPS = 1e-3
SPECULATE_K = 4
PROMPT = [BOS, 5, 7, 11]
DRAFTED = "paddle_generation_speculative_drafted_total"
ACCEPTED = "paddle_generation_speculative_accepted_total"


def session(scope, vocab, kw, device, policy):
    spec = transformer_lm_session(
        vocab, max_len=MAX_LEN, slots=1, prompt_buckets=(8,), bos_id=BOS,
        eos_id=EOS, paged=True, block_size=16, decode_policy=policy,
        device=device, **kw)
    return GenerationSession(spec, scope=scope)


def timed_generate(sess, n, seed=0):
    """(tokens, seconds) of the second of two generations."""
    sess.generate(PROMPT, max_new_tokens=4, eos_id=-1, seed=seed)  # warm
    t0 = time.perf_counter()
    out = sess.generate(PROMPT, max_new_tokens=n, eos_id=-1, seed=seed)
    return [int(t) for t in out], time.perf_counter() - t0


def counter(name):
    for s in metrics.REGISTRY.dump().get(name, {}).get("samples", ()):
        return s["value"]
    return 0.0


def run(vocab, kw, device, lengths=(64, 128)):
    """(doc, tokens by run): the reference's document, and the greedy and
    speculative tokens at each length with the drafted and accepted
    counts."""
    scope = lm_scope(vocab, kw, MAX_LEN, device,
                     residual_eps=RESIDUAL_EPS)[0]
    doc, runs, errors = {}, {}, []
    n0 = lengths[0]
    plain = session(scope, vocab, kw, device, None)
    greedy, t_greedy = timed_generate(plain, n0)
    plain.close()
    sampled = session(scope, vocab, kw, device,
                      DecodePolicy(kind="sample", temperature=0.9, top_k=40))
    runs["sampled"], t_sampled = timed_generate(sampled, n0, seed=1234)
    sampled.close()
    doc["sampling_overhead_pct"] = 100.0 * (t_sampled - t_greedy) / t_greedy
    doc["greedy_tokens_per_sec_len%d" % n0] = n0 / t_greedy
    spec_pol = DecodePolicy(kind="greedy", speculate_k=SPECULATE_K)
    for n in lengths:
        plain = session(scope, vocab, kw, device, None)
        base, t_plain = timed_generate(plain, n)
        plain.close()
        d0, a0 = counter(DRAFTED), counter(ACCEPTED)
        spec = session(scope, vocab, kw, device, spec_pol)
        out, t_spec = timed_generate(spec, n)
        try:
            spec.check_pool_invariant()
        except Exception as exc:  # noqa: BLE001
            errors.append("POOL INVARIANT BROKEN: %r" % (exc,))
        spec.close()
        if out != base:
            errors.append("SPECULATIVE OUTPUT DIVERGED at len %d" % n)
        drafted, accepted = counter(DRAFTED) - d0, counter(ACCEPTED) - a0
        runs["greedy_%d" % n], runs["speculative_%d" % n] = base, out
        runs["drafted_%d" % n], runs["accepted_%d" % n] = drafted, accepted
        doc["speculative_speedup_len%d" % n] = t_plain / t_spec
        if n == n0:
            doc["speculative_accept_rate"] = accepted / max(drafted, 1.0)
            doc["speculative_tokens_per_sec_len%d" % n] = n / t_spec
    # speculation must pay at serving lengths, with a nonzero accept rate
    if doc["speculative_accept_rate"] <= 0.0:
        errors.append("SPECULATIVE ACCEPT RATE IS ZERO")
    for n in lengths:
        if doc["speculative_speedup_len%d" % n] <= 1.0:
            errors.append("SPECULATIVE SLOWER THAN GREEDY at len %d" % n)
    doc["ok"] = not errors and len(greedy) == n0
    doc["errors"] = errors
    return doc, runs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="small", choices=["small", "flagship"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = probe_device(args.device)
    if device is None:
        return 1
    vocab, kw = lm_widths(args.model, VOCAB, KW, device)
    print(json.dumps({"model": args.model, "vocab": vocab, **kw}), flush=True)
    before = launch_counts()
    doc, _ = run(vocab, kw, device)
    for err in doc["errors"]:
        print(err, file=sys.stderr)
    print(json.dumps({"probe": "launches", **launches_since(before)}),
          flush=True)
    print(json.dumps(doc, indent=2), flush=True)
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
