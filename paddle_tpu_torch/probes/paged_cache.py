"""The paged KV cache: prefix reuse, block-pool memory and concurrency at
a fixed budget (reference ``tools/paged_cache_probe.py``).

    python3 -m paddle_tpu_torch.probes.paged_cache [--requests 8]
        [--model small|small-h64|flagship] [--device cpu]

``--requests`` requests share a 14-token system prompt, each with one
token of its own, through a paged ``GenerationSession`` (block 8, the
prefix cache on, prompt buckets 8 and 16, 64 positions) behind a
``GenerationScheduler``, 8 new tokens each. Printed, one JSON object a
line under the reference's keys: the prefix counters (the common prefix
is prefilled exactly once, every later admission only its suffix; the
prefill log of (bucket, hist, window) beside them), the blocks in use
against the dense layout's bytes at the same moment, the executor's
compiles (the closed shape set: 2 prompt buckets, 1 decode, 1 block
copy), and at one cache budget (4 dense slots of 64 rows, a pool of 32
blocks of 8 with 16 lanes) how many mixed-length sequences each layout
holds at once: paged at least twice dense. The pool's books are checked
after each part. Then the paged-cache metric families and the kernels'
launches.

``--model small`` is the reference's LM (vocab 64, d_model 64, 2 heads,
d_ff 128, 2 layers), CPU only: its 32-wide heads are narrower than the
attention kernels take; ``small-h64`` those widths in one head of 64,
the small LM's run on the card; ``flagship`` the flagship LM's widths.
Weights the reference's seed-7 standard normals.
"""

import argparse
import json
import sys

import numpy as np

from ..models.transformer import transformer_lm_session
from ..observability import metrics
from ..serving.generation import GenerationScheduler, GenerationSession
from .common import (LM_MODELS, check, launch_counts, launches_since,
                     lm_scope, lm_widths, probe_device)

VOCAB = 64
KW = dict(d_model=64, num_heads=2, d_ff=128, num_layers=2)
BOS, EOS = 0, 1
BLOCK_SIZE = 8
MAX_LEN = 64


def _spec(vocab, kw, device, slots, buckets, max_len=MAX_LEN, **extra):
    return transformer_lm_session(
        vocab, max_len=max_len, slots=slots, cache_len=max_len,
        prompt_buckets=buckets, bos_id=BOS, eos_id=EOS, device=device,
        **extra, **kw)


def shared_prefix(scope, vocab, kw, device, requests, rs):
    """The shared-system-prompt workload's docs."""
    slots = max(requests, 4)
    system = list(rs.randint(2, vocab, 14))
    sess = GenerationSession(_spec(
        vocab, kw, device, slots, (8, 16), paged=True, block_size=BLOCK_SIZE,
        prefix_cache=True), scope=scope)
    sched = GenerationScheduler(sess)
    ps = [system + [2 + i] for i in range(requests)]
    futs = [sched.submit(p, max_new_tokens=8, eos_id=-1) for p in ps]
    outs = [[int(t) for t in f.result(timeout=600)] for f in futs]
    check(all(len(o) == 8 for o in outs), [len(o) for o in outs])
    sched.drain()
    xstats = sess.prefix_stats()
    pstats = sess.pool_stats()
    row_bytes = pstats["bytes_per_block"] / BLOCK_SIZE
    log = [tuple(int(v) for v in e) for e in sess.prefill_log]
    full = sum(1 for _, hist, _ in log if hist == 0)
    prompt_tokens = sum(len(p) for p in ps)
    docs = [{
        "requests": requests, "prefix_hits": xstats["hits"],
        "prefix_misses": xstats["misses"],
        "prefix_hit_rate": xstats["shared_tokens"] / float(prompt_tokens),
        "shared_tokens": xstats["shared_tokens"], "full_prefills": full,
        "suffix_only_prefills": len(log) - full}]
    check(full == 1, "common prefix must prefill exactly once, got %d" % full)
    docs.append({"prefill_log": log[:requests]})
    # prompt blocks stay cached (pinned by the index) after the drain
    docs.append({
        "blocks_in_use": pstats["blocks_in_use"],
        "num_blocks": pstats["num_blocks"],
        "paged_cache_bytes": int(pstats["blocks_in_use"]
                                 * pstats["bytes_per_block"]),
        "dense_equiv_bytes": int(slots * MAX_LEN * row_bytes),
        "block_size": BLOCK_SIZE})
    stats = sess.compile_stats()
    docs.append({"executor_compiles": stats["compiles"],
                 "executor_cache_entries": stats["entries"],
                 "closed_set": "2 prompt buckets + 1 decode + 1 block-copy"})
    check(stats["compiles"] <= 4, stats)
    sess.check_pool_invariant()
    sess.close()
    return docs


def fixed_budget(scope, vocab, kw, device, rs, max_len=MAX_LEN,
                 dense_slots=4):
    """(cache rows, dense sequences, paged sequences) held at once at one
    cache budget: ``dense_slots`` dense slots of ``max_len`` rows against
    a pool of the same rows in blocks of 8 with 4x the lanes (a lane no
    longer pins a worst-case row), admitting mixed 2-7 token prompts
    until each is full; then every paged lane decodes once."""
    budget_rows = dense_slots * max_len
    dense = GenerationSession(_spec(vocab, kw, device, dense_slots, (8,),
                                    max_len=max_len), scope=scope)
    paged = GenerationSession(_spec(
        vocab, kw, device, 4 * dense_slots, (8,), max_len=max_len,
        paged=True, block_size=BLOCK_SIZE,
        num_blocks=budget_rows // BLOCK_SIZE, prefix_cache=False),
        scope=scope)
    mixed = [list(rs.randint(2, vocab, int(n)))
             for n in rs.randint(2, 8, 64)]
    dense_n = 0
    for p in mixed:
        try:
            dense.admit(p)
            dense_n += 1
        except RuntimeError:
            break
    paged_n = 0
    for p in mixed:
        if not (paged.free_slots() and paged.admit_ok(len(p))):
            break
        paged.admit(p)
        paged_n += 1
    paged.step()
    for s in list(paged.active_slots()):
        paged.retire(s)
    paged.check_pool_invariant()
    paged.close()
    dense.close()
    return budget_rows, dense_n, paged_n


def run(vocab, kw, device, requests=8):
    """Every doc of the probe, in order."""
    scope = lm_scope(vocab, kw, MAX_LEN, device, generate=True)[0]
    rs = np.random.RandomState(0)
    before = launch_counts()
    docs = shared_prefix(scope, vocab, kw, device, requests, rs)
    rows, dense_n, paged_n = fixed_budget(scope, vocab, kw, device, rs)
    docs.append({"cache_budget_rows": rows,
                 "dense_concurrent_sequences": dense_n,
                 "paged_concurrent_sequences": paged_n,
                 "concurrency_gain": paged_n / float(dense_n)})
    check(paged_n >= 2 * dense_n, (paged_n, dense_n))
    docs.append({"metrics": [
        line for line in metrics.REGISTRY.expose_text().splitlines()
        if ("prefix" in line or "kv_block" in line or "kv_pool" in line
            or "blocks_in_use" in line) and not line.startswith("#")]})
    docs.append({"probe": "launches", **launches_since(before)})
    return docs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=8,
                    help="requests sharing the system prompt")
    ap.add_argument("--model", default="small", choices=LM_MODELS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = probe_device(args.device)
    if device is None:
        return 1
    try:
        vocab, kw = lm_widths(args.model, VOCAB, KW, device)
    except ValueError as exc:
        print(exc, file=sys.stderr)
        return 2
    print(json.dumps({"model": args.model, "vocab": vocab, **kw}), flush=True)
    for doc in run(vocab, kw, device, args.requests):
        print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
