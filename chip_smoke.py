#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with an NVIDIA H100, ``nvcc``
and PyTorch built for CUDA. In order, it:

1. builds every CUDA kernel of the serving path from ``paddle_tpu_torch/
   csrc`` (one ``nvcc`` per source, in parallel) and prints what
   ``-Xptxas -v`` reports;
2. holds each kernel against its plain PyTorch version on the card, at
   the shapes the serving path gives it, and a small LM on the card
   against the same LM on the CPU;
3. makes full-width weights of the flagship LM (vocab 32768, d_model
   2048, 16 heads, d_ff 8192, 12 layers, 1024 positions) with numpy from
   the seed and loads them by their reference names through
   ``io.params_from_jax``;
4. serves four requests, prompts filling both prompt buckets (128, 512),
   32 new tokens each, through ``GenerationScheduler.submit``, and checks
   the kernels' launch counts against admissions and decode steps;
5. times prefill and decode steps end to end, profiles one of each
   with torch.profiler (device-busy share, top kernels), and times each
   kernel on the device (profiler kernel durations) beside its bound, its
   plain version and the one PyTorch call that computes the same
   function.

Any failed phase exits nonzero. The line before the last is the card's
name and power limit from nvidia-smi; the one before that lists the
kernels as JSON; the last line is ``{"ok": true, "device": ...}``.
"""

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np

FULL = dict(vocab_size=32768, d_model=2048, num_heads=16, d_ff=8192,
            num_layers=12, max_len=1024)
SLOTS, CACHE_LEN, BUCKETS = 8, 1024, (128, 512)
PROMPT_LENS = (100, 128, 300, 512)
NEW_TOKENS = 32
# H100 SXM data sheet: HBM3 bandwidth, and f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# kernel vs plain version on the card: both f32, sums in another order
KERNEL_ATOL = 1e-4
# the small LM on the card vs on the CPU: f32 through two layers
LM_ATOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters=30, warmup=3):
    """Mean time per call of ``fn()`` in ms between CUDA events around
    back-to-back calls: device time plus any gap the host leaves between
    launches (a short kernel's wrapper can take longer than the kernel)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=30, warmup=3):
    """Mean device time per call of ``fn()`` in ms: the summed durations
    of the kernels and copies it runs, from torch.profiler (CUPTI), so
    host gaps between launches do not count. Falls back to
    :func:`cuda_ms` when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if not us:
        print("[time] the profiler saw no device time: CUDA events instead")
        return cuda_ms(fn, iters, warmup)
    return us / iters / 1e3


def make_params(cfg, rng):
    """Reference-named LM weights: matrices normal(0, 0.02), biases 0,
    layer-norm scales 1 and shifts 0 (the reference's initializers)."""
    from paddle_tpu_torch.models.transformer import lm_param_names
    v, d, f = cfg["vocab_size"], cfg["d_model"], cfg["d_ff"]
    shapes = {"tok_embedding": (v, d), "pos_encoding_0.w_0":
              (cfg["max_len"], d), "lm_head.w": (d, v)}
    named = {}
    for name in lm_param_names(cfg["num_layers"]):
        if name.startswith("layer_norm_"):
            fill = 1.0 if name.endswith(".w_0") else 0.0
            named[name] = np.full(d, fill, np.float32)
        elif name.endswith(".b"):
            named[name] = np.zeros(f if ".ffn1." in name else d, np.float32)
        else:
            shape = shapes.get(name)
            if shape is None:
                shape = ((d, f) if ".ffn1." in name else
                         (f, d) if ".ffn2." in name else (d, d))
            w = rng.standard_normal(shape, dtype=np.float32)
            w *= 0.02
            named[name] = w
    return named


def phase_build():
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build(force=True)
    print("[build] %d kernel sources in %.1f s"
          % (len(logs), time.perf_counter() - t0))
    for stem, log in sorted(logs.items()):
        for line in log.splitlines():
            if "ptxas" in line:
                print("[build] %s: %s" % (stem, line.strip()))


def phase_compare(rng):
    """Each kernel against its plain version on the same card inputs."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    h, d = FULL["num_heads"], FULL["d_model"] // FULL["num_heads"]
    flash_errs = []
    for p, n in ((128, 100), (512, 300), (512, 512)):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (1, h, p, d), dtype=np.float32)).cuda() for _ in range(3))
        seg = (torch.arange(p, device="cuda")[None] < n).to(torch.int32)
        got = fa.flash_attention(q, k, v, causal=True, segment_ids=seg)
        want = fa.flash_attention_plain(q, k, v, True, seg)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        flash_errs.append(err)
        print("[compare] flash_attention P=%d len=%d max_abs_err=%.3g "
              "(tol %g)" % (p, n, err, KERNEL_ATOL))
        check(err <= KERNEL_ATOL, "flash_attention disagrees: %g" % err)
        check(not got[:, :, n:].any(), "flash_attention padded rows not 0")
    # off the main path: no segment ids, non-causal, head dim 64, ragged T
    for causal, p, n, hd in ((True, 100, None, 128), (False, 200, 77, 64)):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (2, 4, p, hd), dtype=np.float32)).cuda() for _ in range(3))
        seg = None if n is None else \
            (torch.arange(p, device="cuda")[None] < n).to(torch.int32) \
            .expand(2, p).contiguous()
        err = float((fa.flash_attention(q, k, v, causal, seg) -
                     fa.flash_attention_plain(q, k, v, causal, seg))
                    .abs().max())
        print("[compare] flash_attention causal=%s T=%d seg=%s D=%d "
              "max_abs_err=%.3g (tol %g)" % (causal, p, n, hd, err,
                                             KERNEL_ATOL))
        check(err <= KERNEL_ATOL, "flash_attention disagrees: %g" % err)
    decode_errs = []
    for s, c, hh, hd, lens in (
            (SLOTS, CACHE_LEN, h, d, [1, 7, 129, 300, 512, 513, 1000, 1024]),
            (3, 100, 4, 64, [1, 50, 100])):
        q = torch.from_numpy(rng.standard_normal((s, hh * hd),
                                                 dtype=np.float32))
        kc, vc = (torch.from_numpy(rng.standard_normal(
            (s, c, hh * hd), dtype=np.float32)) for _ in range(2))
        q, kc, vc = q.cuda(), kc.cuda(), vc.cuda()
        lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = fa.decode_attention(q, kc, vc, lens, hh)
        want = fa.decode_attention_plain(q, kc, vc, lens, hh)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print("[compare] decode_attention S=%d C=%d H=%d D=%d "
              "max_abs_err=%.3g (tol %g)" % (s, c, hh, hd, err, KERNEL_ATOL))
        check(err <= KERNEL_ATOL, "decode_attention disagrees: %g" % err)
        if hh == h:
            decode_errs.append(err)
    return {"flash_attention": max(flash_errs),
            "decode_attention": max(decode_errs)}


def phase_small_lm(rng):
    """A small LM (head dim 128) on the card, kernels in the path, held
    against the same LM on the CPU (plain versions): prefill logits and
    eight teacher-forced decode steps."""
    import torch
    from paddle_tpu_torch.models.transformer import TransformerLM
    from paddle_tpu_torch.io import params_from_jax
    cfg = dict(vocab_size=512, d_model=256, num_heads=2, d_ff=512,
               num_layers=2, max_len=256)
    named = make_params(cfg, rng)
    models = {}
    for dev in ("cpu", "cuda"):
        m = TransformerLM(device=dev, **cfg)
        m.load_params(params_from_jax(named, device=dev))
        m.allocate_cache(2, 256)
        models[dev] = m
    n = 150
    prompt = np.full((1, 256), 1, np.int64)
    prompt[0, :n] = rng.integers(2, cfg["vocab_size"], n)
    worst = 0.0
    logits = {dev: m.prefill(torch.from_numpy(prompt).to(dev), n, 1).cpu()
              for dev, m in models.items()}
    worst = max(worst, float((logits["cpu"] - logits["cuda"]).abs().max()))
    tok = int(logits["cpu"].argmax())
    lengths = np.array([0, n], np.int32)
    for _ in range(8):
        toks = np.array([[0], [tok]], np.int64)
        logits = {dev: m.decode(torch.from_numpy(toks).to(dev),
                                torch.from_numpy(lengths).to(dev)).cpu()
                  for dev, m in models.items()}
        worst = max(worst, float((logits["cpu"][1] -
                                  logits["cuda"][1]).abs().max()))
        tok = int(logits["cpu"][1].argmax())
        lengths[1] += 1
    print("[small-lm] card vs CPU logits max_abs_err=%.3g (tol %g)"
          % (worst, LM_ATOL))
    check(worst <= LM_ATOL, "small LM on the card disagrees with the CPU")
    check(np.isfinite(logits["cuda"].numpy()).all(), "non-finite logits")


def phase_serve(sess, rng):
    """Serve the requests through the scheduler with every launch count
    at 0 just before; returns the counts and the served lengths."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.serving import GenerationScheduler
    prompts = [rng.integers(2, FULL["vocab_size"], n) for n in PROMPT_LENS]
    sched = GenerationScheduler(sess, autostart=False)
    fa.flash_attention.launches = 0
    fa.decode_attention.launches = 0
    prefills0, steps0 = sess.prefills, sess.steps
    t0 = time.perf_counter()
    futs = [sched.submit(p, max_new_tokens=NEW_TOKENS, eos_id=-1)
            for p in prompts]
    sched.start()
    outs = [f.result(timeout=600) for f in futs]
    sched.drain(timeout=60)
    torch.cuda.synchronize()
    launches = {"flash_attention": fa.flash_attention.launches,
                "decode_attention": fa.decode_attention.launches}
    wall = time.perf_counter() - t0
    admissions = sess.prefills - prefills0
    steps = sess.steps - steps0
    layers = FULL["num_layers"]
    print("[serve] %d requests, %d admissions, %d decode steps in %.2f s; "
          "launches %s" % (len(prompts), admissions, steps, wall, launches))
    for p, out in zip(prompts, outs):
        check(len(out) == NEW_TOKENS, "request of %d tokens returned %d"
              % (p.size, len(out)))
        check(((out >= 0) & (out < FULL["vocab_size"])).all(),
              "token out of the vocabulary")
    check(admissions == len(prompts), "admissions %d" % admissions)
    check(launches["flash_attention"] == layers * admissions > 0,
          "flash launches %d != %d x %d admissions"
          % (launches["flash_attention"], layers, admissions))
    check(launches["decode_attention"] == layers * steps > 0,
          "decode launches %d != %d x %d steps"
          % (launches["decode_attention"], layers, steps))
    final = [p.size + NEW_TOKENS - 1 for p in prompts]
    return launches, final


def phase_latency(sess, rng):
    """End-to-end on one session, host clock around work that ends in a
    token read back: TTFT of an idle server per prompt bucket, and the
    decode step with every slot active."""
    import torch
    ttft = {}
    for p in BUCKETS:
        times = []
        for _ in range(3):
            prompt = rng.integers(2, FULL["vocab_size"], p)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slot, _ = sess.admit(prompt)
            times.append((time.perf_counter() - t0) * 1e3)
            sess.retire(slot)
        ttft[p] = sorted(times)[1]
    for i in range(SLOTS):
        sess.admit(rng.integers(2, FULL["vocab_size"], 64 + 56 * i))
    for _ in range(3):
        sess.step()
    rounds = []
    for _ in range(3):
        n = 16
        t0 = time.perf_counter()
        for _ in range(n):
            sess.step()
        rounds.append((time.perf_counter() - t0) * 1e3 / n)
    for s in range(SLOTS):
        sess.retire(s)
    step_ms = sorted(rounds)[1]
    print("[latency] ttft_ms (idle server, median of 3) %s; decode step "
          "with %d active slots %.3f ms (%.3f ms per token; median of 3 "
          "rounds of 16 steps: %s)"
          % ({k: round(v, 3) for k, v in ttft.items()}, SLOTS, step_ms,
             step_ms / SLOTS, [round(r, 3) for r in rounds]))


def phase_profile(sess, rng):
    """Where device time goes: torch.profiler over one 512-token
    admission, then over 4 decode steps with every slot active. Prints
    each window's device-busy share (kernel time over wall time; one
    stream, so kernels do not overlap) and its top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def window(label, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + \
                    e.time_range.elapsed_us()
        busy = sum(by_name.values())
        if not busy:
            print("[profile] %s: the profiler saw no device time (not "
                  "measured)" % label)
            return
        print("[profile] %s: wall %.3f ms, device busy %.3f ms (%.1f%%)"
              % (label, wall_us / 1e3, busy / 1e3, 100 * busy / wall_us))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        for name, us in top:
            print("[profile]   %6.1f%% %9.3f ms  %s"
                  % (100 * us / busy, us / 1e3, name[:110]))

    prompt = rng.integers(2, FULL["vocab_size"], BUCKETS[-1])
    window("prefill 512", lambda: sess.retire(sess.admit(prompt)[0]))
    for i in range(SLOTS):
        sess.admit(rng.integers(2, FULL["vocab_size"], 64 + 56 * i))
    window("4 decode steps, %d slots" % SLOTS,
           lambda: [sess.step() for _ in range(4)])
    for s in range(SLOTS):
        sess.retire(s)


def phase_time(rng, launches, errs, final_lengths):
    """Each kernel at the path's shapes: its time, its plain version's,
    the library call's, and its bound from this run's inputs."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    h, d = FULL["num_heads"], FULL["d_model"] // FULL["num_heads"]
    rows = []

    # prefill attention: the 512 bucket with a 512-token prompt
    p = n = 512
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, h, p, d), dtype=np.float32)).cuda() for _ in range(3))
    seg = (torch.arange(p, device="cuda")[None] < n).to(torch.int32)
    saved = fa.flash_attention.launches
    kernel = functools.partial(fa.flash_attention, q, k, v, True, seg)
    ms, event_ms = device_ms(kernel), cuda_ms(kernel)
    fa.flash_attention.launches = saved
    plain_ms = device_ms(lambda: fa.flash_attention_plain(q, k, v, True, seg))
    live = torch.ones(p, p, dtype=torch.bool, device="cuda").tril()
    live &= (seg[0][:, None] == seg[0][None, :]) & (seg[0][None, :] != 0)
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=live[None, None]))
    pairs = n * (n + 1) // 2            # attendable (query, key) pairs
    flops = 4 * d * h * pairs           # QK^T and PV, 2 flops per MAC
    nbytes = 4 * (4 * h * p * d) + 4 * p
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/ops/pallas_attention.py:584",
        launches=launches["flash_attention"],
        max_abs_err=errs["flash_attention"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S > flops / F32_FLOPS
        else "operations", library_ms=lib_ms))
    events = {"flash_attention": event_ms}

    # decode attention: all slots, the lengths the served requests ended
    # at, free slots at length 1 (as the path runs them)
    s, c = SLOTS, CACHE_LEN
    lens_host = np.ones(s, np.int32)
    lens_host[:len(final_lengths)] = final_lengths
    q = torch.from_numpy(rng.standard_normal((s, h * d), dtype=np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal(
        (s, c, h * d), dtype=np.float32)) for _ in range(2))
    q, kc, vc = q.cuda(), kc.cuda(), vc.cuda()
    lens = torch.from_numpy(lens_host).cuda()
    saved = fa.decode_attention.launches
    kernel = functools.partial(fa.decode_attention, q, kc, vc, lens, h)
    ms, events["decode_attention"] = device_ms(kernel), cuda_ms(kernel)
    fa.decode_attention.launches = saved
    plain_ms = device_ms(lambda: fa.decode_attention_plain(q, kc, vc, lens,
                                                           h))
    kt = kc.reshape(s, c, h, d).transpose(1, 2).contiguous()
    vt = vc.reshape(s, c, h, d).transpose(1, 2).contiguous()
    qt = q.reshape(s, h, 1, d)
    mask = (torch.arange(c, device="cuda")[None] < lens[:, None])
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None, None, :]))
    total = int(lens_host.sum())
    nbytes = 2 * total * h * d * 4 + 2 * s * h * d * 4 + 4 * s
    flops = 4 * total * h * d
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    rows.append(dict(
        name="decode_attention", route="cuda",
        source="paddle_tpu_torch/csrc/decode_attention.cu",
        replaces="paddle_tpu/ops/pallas_attention.py:558",
        launches=launches["decode_attention"],
        max_abs_err=errs["decode_attention"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S > flops / F32_FLOPS
        else "operations", library_ms=lib_ms))
    for r in rows:
        print("[time] %s: device %.4f ms (bound %.4f ms by %s, plain %.4f "
              "ms, library %.4f ms); back-to-back calls %.4f ms each "
              "between CUDA events" % (
                  r["name"], r["ms"], r["bound_ms"], r["bound_by"],
                  r["plain_ms"], r["library_ms"], events[r["name"]]))
    print("[time] decode lengths %s" % lens_host.tolist())
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    try:
        from paddle_tpu_torch.io import params_from_jax
        from paddle_tpu_torch.models.transformer import \
            transformer_lm_session
        from paddle_tpu_torch.serving import GenerationSession
    except ImportError as exc:
        print("FAIL: paddle_tpu_torch not importable: %s" % exc,
              file=sys.stderr)
        return 1
    rng = np.random.default_rng(args.seed)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print("[device] %s (%d visible), torch %s, CUDA %s"
          % (torch.cuda.get_device_name(0), torch.cuda.device_count(),
             torch.__version__, torch.version.cuda))
    try:
        phase_build()
        errs = phase_compare(rng)
        phase_small_lm(rng)
        t0 = time.perf_counter()
        named = make_params(FULL, rng)
        params = params_from_jax(named, device="cuda")
        del named
        spec = transformer_lm_session(
            slots=SLOTS, cache_len=CACHE_LEN, prompt_buckets=BUCKETS,
            eos_id=1, device="cuda", **FULL)
        sess = GenerationSession(spec, params)
        del params
        torch.cuda.synchronize()
        nparam = sum(p.numel() for p in sess.model.parameters())
        print("[weights] %d parameters (%.2f GB f32) made and loaded in "
              "%.1f s" % (nparam, nparam * 4 / 1e9, time.perf_counter() - t0))
        launches, final = phase_serve(sess, rng)
        phase_latency(sess, rng)
        phase_profile(sess, rng)
        rows = phase_time(rng, launches, errs, final)
        print("[memory] peak allocated %.2f GB"
              % (torch.cuda.max_memory_allocated() / 1e9))
    except SmokeFailure as exc:
        print("FAIL: %s" % exc, file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
