"""KV-cached decoding and continuous batching against the re-encode
baseline (reference ``tools/generate_probe.py``).

    python3 -m paddle_tpu_torch.probes.generate [--steps 64]
        [--model small|flagship] [--device cpu]

1. ``reencode_len``: the O(L^2) re-encode reference
   (``transformer_lm_generate``, beam 1: the whole backbone over the
   history at every step) from ``[bos]`` at lengths ``steps`` and
   2 ``steps``, each on a program of that length: tokens a second (the
   second run, wall clock ended by the ids read back).
2. The session (4 slots, buckets 8 and 16, ``max(2 steps, steps + 16)``
   positions): three admissions, ``steps`` decode steps with an admission
   at a quarter and a retire plus an admission at half: the step's
   percentiles, decode tokens a second, the first admission's time to its
   token, slot occupancy, the executor's compiles, and the speedup over
   re-encode.
3. One slot at each length: cached tokens a second against re-encode.
4. The scheduler: 12 submits, 16 new tokens each; compiles added.
5. At one cache budget (4 dense slots against the same rows in blocks of
   8 with 16 lanes, ``paged_cache.fixed_budget``): sequences held at
   once.
6. The generation metric families, and the kernels' launches.

Wall times end in tokens read back. ``--model small`` is the reference's
LM (vocab 64, d_model 256, 4 heads, d_ff 1024, 2 layers), ``flagship``
the flagship LM's widths; weights the reference's seed-7 standard
normals. Each line is one JSON object under the reference's keys.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..models.transformer import transformer_lm_session
from ..observability import metrics
from ..serving.generation import GenerationScheduler, GenerationSession
from .common import (launch_counts, launches_since, lm_scope,
                     lm_widths, probe_device, sync)
from .paged_cache import fixed_budget

VOCAB = 64
KW = dict(d_model=256, num_heads=4, d_ff=1024, num_layers=2)
BOS, EOS = 0, 1
SLOTS = 4


def _pct(xs, p):
    return float(np.percentile(np.asarray(xs), p)) if len(xs) else 0.0


def reencode(exe, main, ids, scope, device):
    """(tokens, seconds) of the second run of the re-encode program."""
    feed = {"anchor": torch.zeros((1, 1), dtype=torch.int32, device=device)}
    exe.run(main, feed=feed, fetch_list=[ids], scope=scope)  # warm
    sync(device)
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, fetch_list=[ids], scope=scope)[0]
    dt = time.perf_counter() - t0
    return [int(t) for t in np.asarray(out).reshape(-1)], dt


def _spec(vocab, kw, device, max_len, slots, buckets, **extra):
    return transformer_lm_session(
        vocab, max_len=max_len, slots=slots, cache_len=max_len,
        prompt_buckets=buckets, bos_id=BOS, eos_id=EOS, device=device,
        **extra, **kw)


def continuous(sess, steps, rs):
    """The session's run with admissions and a retire in flight."""
    t0 = time.perf_counter()
    slot0, _ = sess.admit([BOS])
    ttft_ms = (time.perf_counter() - t0) * 1e3
    sess.admit(list(rs.randint(2, sess.spec.vocab_size, 5)))
    sess.admit(list(rs.randint(2, sess.spec.vocab_size, 7)))
    step_ms, occupancies = [], []
    produced = 3
    for i in range(steps):
        if i == steps // 4:      # an admission into the free slot
            sess.admit(list(rs.randint(2, sess.spec.vocab_size, 12)))
            produced += 1
        if i == steps // 2:      # a retire and an admission in one step
            sess.retire(slot0)
            sess.admit(list(rs.randint(2, sess.spec.vocab_size, 3)))
            produced += 1
        t0 = time.perf_counter()
        toks = sess.step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        produced += len(toks)
        occupancies.append(sess.occupancy())
    decode_tps = produced / (sum(step_ms) / 1e3)
    stats = sess.compile_stats()
    report = {
        "decode_steps": steps, "tokens_decoded": produced,
        "decode_tokens_per_sec": decode_tps,
        "time_to_first_token_ms": ttft_ms,
        "inter_token_ms_p50": _pct(step_ms, 50),
        "inter_token_ms_p95": _pct(step_ms, 95),
        "cache_slot_occupancy_mean": float(np.mean(occupancies)),
        "cache_slot_occupancy_max": float(np.max(occupancies)),
        "executor_compiles": stats["compiles"],
        "executor_cache_entries": stats["entries"]}
    for s in sess.active_slots():
        sess.retire(s)
    return report


def solo(scope, vocab, kw, device, length):
    """(tokens, tokens a second) of one slot generating ``length`` from
    ``[bos]`` (the second call)."""
    sess = GenerationSession(_spec(vocab, kw, device, length, 1, (8,)),
                             scope=scope)
    sess.generate([BOS], max_new_tokens=length, eos_id=-1)  # warm
    t0 = time.perf_counter()
    toks = sess.generate([BOS], max_new_tokens=length, eos_id=-1)
    dt = time.perf_counter() - t0
    sess.close()
    return [int(t) for t in toks], len(toks) / dt


def scheduler(sess, rs, n=12):
    """(doc, tokens) of ``n`` concurrent submits."""
    before = sess.compile_stats()["compiles"]
    sched = GenerationScheduler(sess)
    futs = [sched.submit(list(rs.randint(2, sess.spec.vocab_size,
                                         int(rs.randint(1, 8)))),
                         max_new_tokens=16, eos_id=-1) for _ in range(n)]
    outs = [[int(t) for t in f.result(timeout=600)] for f in futs]
    sched.drain()
    stats = sess.compile_stats()
    return {"scheduler_requests": n,
            "completed": sum(1 for o in outs if len(o) > 0),
            "executor_compiles": stats["compiles"],
            "compiles_added_by_scheduler_run": stats["compiles"] - before
            }, outs


def run(vocab, kw, device, steps=64):
    """(docs, tokens): every doc in order, and the tokens of the
    re-encode and one-slot runs by length and of the scheduler's
    requests."""
    max_len = max(2 * steps, steps + 16)
    before = launch_counts()
    docs, tokens, reencode_tps = [], {}, {}
    for length in (steps, 2 * steps):
        scope_b, exe_b, main_b, ids_b = lm_scope(vocab, kw, length, device,
                                                 generate=True)
        toks, dt = reencode(exe_b, main_b, ids_b, scope_b, device)
        tokens["reencode_%d" % length] = toks
        reencode_tps[length] = length / dt
        docs.append({"reencode_len": length,
                     "tokens_per_sec": reencode_tps[length]})
        del scope_b, exe_b
    scope = lm_scope(vocab, kw, max_len, device, generate=True)[0]
    sess = GenerationSession(_spec(vocab, kw, device, max_len, SLOTS,
                                   (8, 16)), scope=scope)
    rs = np.random.RandomState(0)
    report = continuous(sess, steps, rs)
    report["batched_speedup_vs_reencode@%d" % steps] = \
        report["decode_tokens_per_sec"] / reencode_tps[steps]
    docs.append(report)
    for length in (steps, 2 * steps):
        toks, tps = solo(scope, vocab, kw, device, length)
        tokens["cached_%d" % length] = toks
        docs.append({"length": length, "cached_tokens_per_sec": tps,
                     "reencode_tokens_per_sec": reencode_tps[length],
                     "speedup": tps / reencode_tps[length]})
    doc, tokens["scheduler"] = scheduler(sess, rs)
    docs.append(doc)
    rows, dense_n, paged_n = fixed_budget(scope, vocab, kw, device, rs,
                                          max_len, SLOTS)
    docs.append({"cache_budget_rows": rows, "dense_max_concurrent": dense_n,
                 "paged_max_concurrent": paged_n,
                 "concurrency_gain": paged_n / float(dense_n)})
    sess.close()
    docs.append({"metrics": [
        line for line in metrics.REGISTRY.expose_text().splitlines()
        if "generation" in line and not line.startswith("#")]})
    docs.append({"probe": "launches", **launches_since(before)})
    return docs, tokens


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=64,
                    help="decode steps in the continuous-batching run")
    ap.add_argument("--model", default="small", choices=["small", "flagship"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = probe_device(args.device)
    if device is None:
        return 1
    vocab, kw = lm_widths(args.model, VOCAB, KW, device)
    print(json.dumps({"model": args.model, "vocab": vocab, **kw}), flush=True)
    for doc in run(vocab, kw, device, args.steps)[0]:
        print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
