"""One fleet member process: an ``EngineWorker`` serving a deterministic
transformer LM through a ``GenerationScheduler`` over the generation
programs (the port's counterpart of the reference's
``tests/fleet_worker_child.py``, with the same arguments and defaults).

    python -m paddle_tpu_torch.probes.fleet_worker --router HOST:PORT
        --member m0 [--seed 7] [--slots N] [--kill-at-token N]
        [--decode-policy greedy|sample] [--decode-temperature T]
        [--fail-after-swap TAG] [--compile-cache DIR] [--heartbeat-ms MS]
        [--metrics-interval-ms MS] [--version TAG] [--model ID]
        [--device cuda|cpu] [--params PATH] [--vocab V] [--max-len L]
        [--cache-len C] [--prompt-buckets 8,16,32] [--d-model D]
        [--num-heads H] [--d-ff F] [--num-layers N]

It registers with the router at ``--router`` and prints
``READY <member> <port>`` on stdout once registered. Every member built
from one ``--seed`` holds the same weights, bit for bit the reference's
``build_scope(seed)``: a ``np.random.RandomState(seed).standard_normal``
draw over the sorted names of the LM program's parameters. That is
what makes a replay journal re-driven on a peer give the fault-free
tokens. ``--params PATH`` loads an ``.npz`` of those weights instead
(``write_weights_manifest`` beside it; the manifest is required and
checked), which a parent writes once for many members.

``--kill-at-token N`` arms ``fleet_member_kill`` with ``action="kill"``
at streamed token N: the worker SIGKILLs itself mid-generation.
``--fail-after-swap TAG`` makes a swap landing TAG behave as a broken
push (a persistent ``generation_step_fail`` until a rollback).

``--device`` defaults to ``cuda`` and raises without a card; ``cpu`` is
for the CPU tests. On CUDA the member builds nothing (the kernels are
built by the parent before any member starts) and refuses to register
unless its warm-up generation launched the flash kernel (B2) and the
dense decode kernel (B4). When the worker stops it prints a final
``LAUNCHES {...}`` line: the kernel wrappers' launch counts
(``ops/launches.py``) since the warm-up, with the prefill admissions
and decode steps its sessions ran over the same span.

The parent imports :func:`build_scope`, :func:`model_params`,
:func:`make_scheduler`, :func:`sampled_policy` and :func:`chaos_prompts`
to build the same model in-process for the oracle and to write deploy
pushes.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

VOCAB = 64
MAX_LEN = 48
KW = dict(d_model=64, num_heads=2, d_ff=128, num_layers=2)
PROMPT_BUCKETS = (8, 16, 32)
BOS, EOS = 0, 1


def lm_program(vocab=VOCAB, max_len=MAX_LEN, **kw):
    """(main, startup) of ``transformer_lm`` as the reference's fleet
    child builds it: tokens and labels [1, max_len], is_test."""
    from paddle_tpu_torch import core, layers
    from paddle_tpu_torch.models.transformer import transformer_lm
    kw = dict(KW, **kw)
    with core.unique_name.guard():
        main, startup = core.Program(), core.Program()
        with core.program_guard(main, startup):
            toks = layers.data("toks", shape=[1, max_len], dtype="int64",
                               append_batch_size=False)
            lbls = layers.data("lbls", shape=[1, max_len], dtype="int64",
                               append_batch_size=False)
            transformer_lm(toks, lbls, vocab_size=vocab, is_test=True,
                           **kw)
    return main, startup


def _param_decls(vocab, max_len, kw):
    """{name: (shape, numpy dtype)} of the variables the LM's startup
    program initializes, read from its ops, not run: its random
    initializers would be overwritten at once, and at full width they
    took most of a member's start on the card."""
    _, startup = lm_program(vocab, max_len, **kw)
    block = startup.global_block()
    return {n: (tuple(block.vars[n].shape), np.dtype(block.vars[n].dtype))
            for op in block.ops for names in op.outputs.values()
            for n in names}


def build_scope(seed=7, device="cpu", vocab=VOCAB, max_len=MAX_LEN, **kw):
    """The LM's scope with every float variable drawn from
    ``np.random.RandomState(seed).standard_normal`` over the sorted
    names, as the reference's ``build_scope`` draws them: a member built
    from one seed serves the same weights in either package. (The
    reference's scope also holds its startup's RNG state; the port's
    executor makes one when a program needs it.)"""
    import torch
    from paddle_tpu_torch import core
    scope = core.Scope()
    rs = np.random.RandomState(seed)
    for n, (shape, dtype) in sorted(_param_decls(vocab, max_len,
                                                 kw).items()):
        if dtype.kind != "f":
            raise TypeError("%s is %s: the draw covers floats only"
                            % (n, dtype))
        draw = rs.standard_normal(shape).astype(dtype)
        scope.set_var(n, torch.from_numpy(draw).to(device))
    return scope


def load_scope(path, device="cpu", vocab=VOCAB, max_len=MAX_LEN, **kw):
    """The LM's scope loaded from the ``.npz`` at ``path``, which must
    carry a manifest that verifies
    (``serving.model_paging.write_weights_manifest``) and hold exactly
    the startup's variables, with their shapes and dtypes."""
    import torch
    from paddle_tpu_torch import core
    from paddle_tpu_torch.serving.model_paging import \
        verify_weights_manifest
    if verify_weights_manifest(path) is None:
        raise ValueError("%s has no weights manifest" % path)
    decls = _param_decls(vocab, max_len, kw)
    scope = core.Scope()
    with np.load(path) as data:
        if sorted(data.files) != sorted(decls):
            raise ValueError("%s names %d arrays, the program %d variables"
                             % (path, len(data.files), len(decls)))
        for n, (shape, dtype) in sorted(decls.items()):
            arr = data[n]
            if tuple(arr.shape) != shape or arr.dtype != dtype:
                raise ValueError("%s: %s %s, the program declares %s %s"
                                 % (n, arr.shape, arr.dtype, shape, dtype))
            scope.set_var(n, torch.from_numpy(arr).to(device))
    return scope


def model_params(scope, factor=1.0):
    """The swappable float params of a freshly built scope (session cache
    variables and ``@...@`` state left out), optionally scaled: the
    deploy-push payload, numpy arrays computed as the reference computes
    them."""
    out = {}
    for n in sorted(scope.var_names()):
        if n.startswith("@") or n.startswith("kv_session"):
            continue
        cur = scope.find_var(n)
        if cur.is_floating_point():
            arr = cur.detach().cpu().numpy()
            out[n] = (arr * factor).astype(arr.dtype)
    return out


def make_scheduler(scope, slots=4, replay_attempts=2, warm=True,
                   decode_policy=None, device="cpu", vocab=VOCAB,
                   max_len=MAX_LEN, cache_len=None,
                   prompt_buckets=PROMPT_BUCKETS, **kw):
    """A ``GenerationScheduler`` over one dense program session on
    ``scope`` (the reference child's configuration at its defaults),
    warmed when ``warm`` with two short generations where the reference
    runs one: each serving entry (the prefill bucket and the decode step)
    then ran twice, so on the card it is captured as a CUDA graph before
    the member takes traffic."""
    from paddle_tpu_torch.models.transformer import transformer_lm_session
    from paddle_tpu_torch.serving.generation import (GenerationScheduler,
                                                     GenerationSession)
    spec = transformer_lm_session(
        vocab, max_len=max_len, slots=slots,
        cache_len=max_len if cache_len is None else cache_len,
        prompt_buckets=tuple(prompt_buckets), bos_id=BOS, eos_id=EOS,
        decode_policy=decode_policy, device=device, **dict(KW, **kw))
    sess = GenerationSession(spec, scope=scope)
    if warm:
        for _ in range(2):
            sess.generate([BOS], max_new_tokens=2, eos_id=-1)
    return GenerationScheduler(sess, replay_attempts=replay_attempts)


def sampled_policy(temperature=4.0, top_k=0, top_p=1.0):
    """The sampled policy the sampled-fleet chaos runs share (the
    reference child's, so fingerprints agree across packages)."""
    from paddle_tpu_torch.serving.decoding import DecodePolicy
    return DecodePolicy(kind="sample", temperature=temperature,
                        top_k=top_k, top_p=top_p)


def chaos_prompts(n, seed=0):
    """Varied prompts (an attractor sequence cannot fake bit-identity),
    the reference child's draws."""
    rs = np.random.RandomState(seed)
    return [[BOS] + [int(t) for t in
                     rs.randint(2, VOCAB, int(rs.randint(1, 7)))]
            for _ in range(n)]


def launch_counts():
    """{kernel wrapper attribute: launches} of ``ops/launches.py``."""
    from paddle_tpu_torch.ops import launches
    counts, _ = launches.snapshot()
    return {"%s.%s" % (fn.__name__, attr): int(n)
            for (fn, attr), n in counts.items()}


def cache_counts():
    """{hits, misses, quarantined} of the persistent compile cache
    (``paddle_deploy_cache_*_total``) in this process."""
    from paddle_tpu_torch.observability import metrics
    dump = metrics.REGISTRY.dump()
    return {k: sum(s["value"] for s in dump.get(
        "paddle_deploy_cache_%s_total" % k, {}).get("samples", ()))
        for k in ("hits", "misses", "quarantined")}


def session_counts(sched):
    """(prefill admissions, decode steps) the scheduler's sessions ran."""
    return (sum(int(s.prefills) for s in sched.sessions),
            sum(int(s.steps) for s in sched.sessions))


def _lm_kw(args):
    return dict(vocab=args.vocab, max_len=args.max_len,
                d_model=args.d_model, num_heads=args.num_heads,
                d_ff=args.d_ff, num_layers=args.num_layers)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--router", required=True)
    ap.add_argument("--member", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--kill-at-token", type=int, default=None)
    ap.add_argument("--decode-policy", default=None,
                    choices=(None, "greedy", "sample"))
    ap.add_argument("--decode-temperature", type=float, default=4.0)
    ap.add_argument("--fail-after-swap", default=None)
    ap.add_argument("--compile-cache", default=None)
    ap.add_argument("--heartbeat-ms", type=float, default=None)
    ap.add_argument("--metrics-interval-ms", type=float, default=None)
    ap.add_argument("--version", default="v0")
    ap.add_argument("--model", default=None,
                    help="catalog model this worker starts resident "
                    "for (multi-model fleets)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--params", default=None,
                    help="an .npz of the weights, with its manifest")
    ap.add_argument("--vocab", type=int, default=VOCAB)
    ap.add_argument("--max-len", type=int, default=MAX_LEN)
    ap.add_argument("--cache-len", type=int, default=None)
    ap.add_argument("--prompt-buckets", default=",".join(
        str(b) for b in PROMPT_BUCKETS))
    ap.add_argument("--d-model", type=int, default=KW["d_model"])
    ap.add_argument("--num-heads", type=int, default=KW["num_heads"])
    ap.add_argument("--d-ff", type=int, default=KW["d_ff"])
    ap.add_argument("--num-layers", type=int, default=KW["num_layers"])
    args = ap.parse_args(argv)
    t0 = time.perf_counter()

    import torch
    from paddle_tpu_torch import config, place
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving.fleet import EngineWorker
    from paddle_tpu_torch.utils import log

    device = place.resolve_device(args.device)   # raises without a card
    policy = None
    if args.decode_policy == "sample":
        policy = sampled_policy(temperature=args.decode_temperature)
    kw = _lm_kw(args)
    t1 = time.perf_counter()
    if args.params:
        scope = load_scope(args.params, device=device, **kw)
    else:
        scope = build_scope(args.seed, device=device, **kw)
    t2 = time.perf_counter()
    if args.compile_cache:
        # a cold member loads the serving programs a warm one stored;
        # set after the startup ran, which runs once and is not worth
        # an export (its random draws are replaced at once)
        config.set_flags(compile_cache_dir=args.compile_cache)
    cache0 = cache_counts()
    before = launch_counts()
    sched = make_scheduler(
        scope, slots=args.slots, decode_policy=policy, device=device,
        cache_len=args.cache_len,
        prompt_buckets=[int(b) for b in args.prompt_buckets.split(",")],
        **kw)
    if device.type == "cuda":
        torch.cuda.synchronize()
        warm = {k: v - before[k] for k, v in launch_counts().items()}
        if not (warm["flash_attention.launches"] > 0 and
                warm["decode_attention.launches"] > 0):
            raise RuntimeError("the warm-up generation launched %s: the "
                               "member does not serve without its kernels"
                               % warm)
    base, base_sess = launch_counts(), session_counts(sched)
    # where a member's start goes (stderr): the imports, the weights, the
    # session's build and warm-up (with the compile cache's hits and
    # misses, each miss an export stored for the next member)
    log.structured("fleet_worker_started", member=args.member,
                   imports_s=round(t1 - t0, 3),
                   weights_s=round(t2 - t1, 3),
                   warm_s=round(time.perf_counter() - t2, 3),
                   cache={k: v - cache0[k]
                          for k, v in cache_counts().items()})

    if args.kill_at_token is not None:
        faults.arm("fleet_member_kill", at=args.kill_at_token,
                   times=1, action="kill")

    host, port = args.router.rsplit(":", 1)
    worker = EngineWorker(
        sched, member_id=args.member, router_addr=(host, int(port)),
        heartbeat_ms=args.heartbeat_ms, version=args.version,
        fail_after_swap_tag=args.fail_after_swap,
        metrics_interval_ms=args.metrics_interval_ms,
        model=args.model)
    print("READY %s %d" % (args.member, worker.addr[1]), flush=True)
    try:
        worker.serve_forever()
    finally:
        sched.close()
        admissions, steps = session_counts(sched)
        counts = {k: v - base[k] for k, v in launch_counts().items()}
        print("LAUNCHES %s" % json.dumps(dict(
            counts, member=args.member, pid=os.getpid(),
            admissions=admissions - base_sess[0],
            steps=steps - base_sess[1])), flush=True)


if __name__ == "__main__":
    sys.exit(main())
