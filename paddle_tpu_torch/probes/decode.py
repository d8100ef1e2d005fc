"""Kernels B5 (``csrc/decode_attention_paged.cu``) and B4
(``csrc/decode_attention.cu``), which share the split-key body
``csrc/decode_split.cuh``, on the card, at the serving path's width (8
slots, 16 heads of 128, block 16, 64 blocks a table, 512 blocks a pool)
and three sets of lengths: the paged cell's, one slot at 1024 with the
others at 1 (the worst imbalance), and all eight at 1024.

    python3 -m paddle_tpu_torch.probes.decode [b5] [sweep] [b4] [host]
        [--baseline DIR]

``b5`` times B5 on float32 and bfloat16 pools, on a cold L2 (calls taken
in turn over copies of the pools, ``probes.common.cold_calls``) and warm,
with its bound and its error against the plain version; ``sweep`` times
the key-chunk sizes (``PAGED_CHUNKS``), grid sizes (``PAGED_CTAS``) and
edited builds of the shared body (``BUILDS``: loads in flight by dtype,
CTAs an SM) at each set of lengths on the cold clock, for B5 and for B4
on the same logical rows, with the CTAs launched and the CTAs that took
a work item (counted on the card); ``b4`` times B4 on the dense cache
that holds B5's logical rows, beside B5, both clocks, and checks that
the two outputs are bitwise equal; with ``--baseline DIR`` (a directory
holding an earlier ``decode_attention.cu`` whose C entries take (q, k,
v, lengths, o, slots, heads, d, c, stream), such as the source before
B4 took the split body) that build is timed beside them on the same
caches; ``host`` times the host side of one B5 call (its plan, its
scratch, the C entry's two launches, the wrapper) beside B4's (its plan,
scratch and counters, the C entry's one launch, the wrapper) and, with
``--baseline DIR``, the earlier B4's C entry and wrapper in the same
process. Builds of
edited sources go to ``build/probe/`` inside the package. Needs one CUDA
card and ``nvcc``.
"""

import argparse
import ctypes
import functools
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops import flash_attention as fa
from .common import (HBM_BYTES_PER_S, build_baseline, build_edited,
                     cold_calls, cuda_ms, host_us)

SLOTS, HEADS, HEAD_DIM, BLOCK, TABLE = 8, 16, 128, 16, 64
POOL = SLOTS * TABLE
LENGTHS = {"paged cell": (259, 331, 531, 259, 131, 1, 1, 1),
           "one at 1024": (1024,) + (1,) * (SLOTS - 1),
           "all at 1024": (1024,) * SLOTS}
DTYPES = (torch.float32, torch.bfloat16)
# the sweep: key-chunk sizes, grid sizes (at the plan's chunk), and edited
# builds of the shared body: the other number of loads in flight for each
# cache dtype (8 for f32 and 4 for bf16 in the source), and the split
# kernels held to 3 CTAs an SM
PAGED_CHUNKS = (32, 64, 128, 256)
PAGED_CTAS = (132, 264, 528, 1056)
BUILDS = {"current": (),
          "f32-loads-4": (("constexpr int kLoadsF32 = 8;",
                           "constexpr int kLoadsF32 = 4;"),),
          "bf16-loads-8": (("constexpr int kLoadsBF16 = 4;",
                            "constexpr int kLoadsBF16 = 8;"),),
          "3-ctas-an-sm": (("constexpr int kCtasAnSm = 1;",
                            "constexpr int kCtasAnSm = 3;"),)}
# rounds of the host probe's B4 against the earlier B4, in turn
HOST_ROUNDS = 15
# the C entries of B4 before it took the split body
_P, _I = ctypes.c_void_p, ctypes.c_int
BASELINE_ENTRIES = {"decode_attention_f32": (_P,) * 5 + (_I,) * 4 + (_P,),
                    "decode_attention_bf16": (_P,) * 5 + (_I,) * 4 + (_P,)}


def paged_inputs(rng, lens, dtype):
    """q [S, H*D] f32, pools [POOL, BLOCK, H*D] of ``dtype``, int32
    lengths, and tables [S, TABLE] scattered over the pool (dead entries
    = POOL)."""
    hd = HEADS * HEAD_DIM
    tables = np.full((SLOTS, TABLE), POOL, np.int32)
    perm = iter(rng.permutation(POOL))
    for s, n in enumerate(lens):
        for j in range(-(-n // BLOCK)):
            tables[s, j] = next(perm)
    pools = [torch.from_numpy(rng.standard_normal(
        (POOL, BLOCK, hd), dtype=np.float32)).cuda().to(dtype)
        for _ in range(2)]
    q = torch.from_numpy(rng.standard_normal((SLOTS, hd), dtype=np.float32))
    return (q.cuda(), pools[0], pools[1],
            torch.tensor(lens, dtype=torch.int32, device="cuda"),
            torch.from_numpy(tables).cuda())


def live_bytes(lens, dtype):
    """K and V bytes the lengths make a decode read."""
    return 2 * sum(lens) * HEADS * HEAD_DIM * torch.finfo(dtype).bits // 8


def bound_ms(lens, dtype):
    return (live_bytes(lens, dtype) + 2 * SLOTS * HEADS * HEAD_DIM * 4) \
        / HBM_BYTES_PER_S * 1e3


def dense_of(pk, pv, tables):
    """The dense caches [S, TABLE * BLOCK, H*D] holding the logical rows
    the tables map into the pools (dead entries clamped, as the kernels
    clamp them)."""
    tbl = tables.long().clamp(0, POOL - 1)
    return tuple(p[tbl].reshape(SLOTS, TABLE * BLOCK, HEADS * HEAD_DIM)
                 for p in (pk, pv))


def split_work(launch):
    """(CTAs that took a work item, items taken) of one launch of a split
    kernel: ``launch(work)`` with an int32 [2] counter on the card."""
    work = torch.zeros(2, dtype=torch.int32, device="cuda")
    launch(work)
    ctas, items = work.tolist()
    return ctas, items


def probe_b5(rng):
    for label, lens in LENGTHS.items():
        for dtype in DTYPES:
            q, pk, pv, lengths, tables = paged_inputs(rng, lens, dtype)
            args = (lengths, tables, HEADS)
            got = fa.decode_attention_paged(q, pk, pv, *args)
            err = float((got - fa._decode_paged_reference(q, pk, pv, *args))
                        .abs().max())
            cold = cuda_ms(cold_calls(
                lambda: lambda k=pk.clone(), v=pv.clone():
                fa.decode_attention_paged(q, k, v, *args),
                live_bytes(lens, dtype)))
            warm = cuda_ms(lambda: fa.decode_attention_paged(q, pk, pv,
                                                             *args))
            print("[b5] %s %s: cold %.4f ms, warm %.4f ms, bound %.4f ms; "
                  "max_abs_err vs plain %.3g"
                  % (label, str(dtype)[6:], cold, warm,
                     bound_ms(lens, dtype), err))


def probe_sweep(rng):
    fns = {kernel: build_edited(stem, tuple(stem + "_" + k
                                            for k in ("f32", "bf16")),
                                BUILDS)
           for kernel, stem in (("B5", "decode_attention_paged"),
                                ("B4", "decode_attention"))}
    for label, lens in LENGTHS.items():
        for i, dtype in enumerate(DTYPES):
            q, pk, pv, lengths, tables = paged_inputs(rng, lens, dtype)
            kc, vc = dense_of(pk, pv, tables)
            want = fa._decode_paged_reference(q, pk, pv, lengths, tables,
                                              HEADS)
            nbytes = live_bytes(lens, dtype)
            for kernel in ("B5", "B4"):
                if kernel == "B5":
                    caches = cold_calls(lambda: (pk.clone(), pv.clone()),
                                        nbytes)

                    def call(k, v, plan, fn, work=None):
                        return fa._launch_paged(q, k, v, lengths, tables,
                                                HEADS, plan, fn, work)
                    cache = (pk, pv)
                else:
                    caches = cold_calls(lambda: (kc.clone(), vc.clone()),
                                        nbytes)

                    def call(k, v, plan, fn, work=None):
                        return fa._launch_dense(q, k, v, lengths, HEADS,
                                                plan, fn, work)
                    cache = (kc, vc)
                configs = [(build, chunk, None) for build in BUILDS
                           for chunk in PAGED_CHUNKS]
                configs += [("current", None, ctas) for ctas in PAGED_CTAS]
                parts = []
                for build, chunk, ctas in configs:
                    plan = fa._split_plan(SLOTS, HEADS, HEAD_DIM,
                                          TABLE * BLOCK, chunk=chunk,
                                          ctas=ctas)
                    fn = fns[kernel][build][i]
                    err = float((call(*cache, plan, fn) - want).abs().max())
                    ms = cuda_ms([functools.partial(call, k, v, plan, fn)
                                  for k, v in caches])
                    working = split_work(functools.partial(
                        call, *cache, plan, fn))[0]
                    parts.append("%s, chunk %d, %d CTAs (%d with work): "
                                 "%.4f ms, err %.2g"
                                 % (build, plan.chunk, plan.ctas, working, ms,
                                    err))
                print("[sweep] %s %s %s: %s" % (kernel, label,
                                                 str(dtype)[6:],
                                                 "; ".join(parts)))
                del caches
            del kc, vc


def probe_b4(rng, baseline=None):
    old = None
    if baseline:
        old = build_baseline(os.path.join(baseline, "decode_attention.cu"),
                             BASELINE_ENTRIES)
    for label, lens in LENGTHS.items():
        for dtype in DTYPES:
            q, pk, pv, lengths, tables = paged_inputs(rng, lens, dtype)
            kc, vc = dense_of(pk, pv, tables)
            nbytes = live_bytes(lens, dtype)
            got = fa.decode_attention(q, kc, vc, lengths, HEADS)
            paged = fa.decode_attention_paged(q, pk, pv, lengths, tables,
                                              HEADS)
            err = float((got - fa.decode_attention_plain(
                q, kc, vc, lengths, HEADS)).abs().max())
            same = torch.equal(got, paged)
            cold = cuda_ms(cold_calls(
                lambda: lambda k=kc.clone(), v=vc.clone():
                fa.decode_attention(q, k, v, lengths, HEADS), nbytes))
            warm = cuda_ms(lambda: fa.decode_attention(q, kc, vc, lengths,
                                                       HEADS))
            cold5 = cuda_ms(cold_calls(
                lambda: lambda k=pk.clone(), v=pv.clone():
                fa.decode_attention_paged(q, k, v, lengths, tables, HEADS),
                nbytes))
            line = ("[b4] %s %s: cold %.4f ms, warm %.4f ms, bound %.4f ms, "
                    "max_abs_err vs plain %.3g; B5 on the same logical rows "
                    "cold %.4f ms (B4/B5 %.3f), outputs %s"
                    % (label, str(dtype)[6:], cold, warm,
                       bound_ms(lens, dtype), err, cold5, cold / cold5,
                       "bitwise equal" if same else "DIFFER"))
            if old is not None:
                fn = old["decode_attention_" + ("f32" if dtype ==
                                                torch.float32 else "bf16")]

                def earlier(k, v):
                    out = torch.empty_like(q)
                    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    lengths.data_ptr(), out.data_ptr(), SLOTS,
                                    HEADS, HEAD_DIM, TABLE * BLOCK,
                                    _build.stream(q.device)), "baseline")
                    return out
                cold0 = cuda_ms(cold_calls(
                    lambda: functools.partial(earlier, kc.clone(),
                                              vc.clone()), nbytes))
                line += "; baseline build cold %.4f ms (baseline/B4 %.2f)" % (
                    cold0, cold0 / cold)
            print(line)
            del kc, vc


def baseline_wrapper(fn, q, k_cache, v_cache, lengths, num_heads):
    """The wrapper of the earlier B4 (one launch, no plan, scratch or
    counters) around its C entry ``fn``, with the checks the current
    wrapper makes: the host side the current wrapper is held to."""
    s, hd = q.shape
    fa._require(k_cache.dim() == 3 and k_cache.shape[0] == s
                and k_cache.shape[2] == hd and v_cache.shape == k_cache.shape,
                "caches must be [S, C, H*D]")
    fa._require(hd % num_heads == 0, "H*D not divisible by the heads")
    fa._require(tuple(lengths.shape) == (s,), "lengths must be [S]")
    c = k_cache.shape[1]
    d = hd // num_heads
    if fa._on_cpu(q, k_cache, v_cache, lengths):
        raise ValueError("the baseline runs on the card")
    fa._check_decode_inputs(q, k_cache, v_cache)
    fa._require(d in fa._HEAD_DIMS, "head dim %d", d)
    fa._require(lengths.dtype == torch.int32 and lengths.is_contiguous(),
                "lengths must be contiguous int32")
    out = torch.empty_like(q)
    stream = _build.stream(q.device)
    _build.check(fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    lengths.data_ptr(), out.data_ptr(), s, num_heads, d, c,
                    stream), "baseline")
    return out


def probe_host(rng, baseline=None):
    lens = LENGTHS["paged cell"]
    dev = torch.device("cuda", torch.cuda.current_device())
    st = _build.stream(dev)
    q, pk, pv, lengths, tables = paged_inputs(rng, lens, torch.bfloat16)
    kc, vc = dense_of(pk, pv, tables)
    plan = fa._paged_plan(SLOTS, HEADS, HEAD_DIM, BLOCK, TABLE)
    fn = _build.entry("decode_attention_paged_bf16")
    scratch = _build.scratch(dev, st, plan.scratch_bytes)
    counters = _build.counters(dev, st, plan.counters)
    out = torch.empty_like(q)
    fn4 = _build.entry("decode_attention_bf16")
    cases = (
        ("_paged_plan (cached)", lambda: fa._paged_plan(
            SLOTS, HEADS, HEAD_DIM, BLOCK, TABLE)),
        ("_split_plan (cached)", lambda: fa._split_plan(
            SLOTS, HEADS, HEAD_DIM, TABLE * BLOCK)),
        ("_build.scratch(dev, stream, %d)" % plan.scratch_bytes,
         lambda: _build.scratch(dev, st, plan.scratch_bytes)),
        ("_build.counters(dev, stream, %d)" % plan.counters,
         lambda: _build.counters(dev, st, plan.counters)),
        ("_build.split_buffers(dev, stream, %d, %d)" % (
            plan.scratch_bytes, plan.counters),
         lambda: _build.split_buffers(dev, st, plan.scratch_bytes,
                                      plan.counters)),
        ("B5 ctypes call and its two launches alone", lambda: fn(
            q.data_ptr(), pk.data_ptr(), pv.data_ptr(), lengths.data_ptr(),
            tables.data_ptr(), out.data_ptr(), scratch.data_ptr(), None,
            SLOTS, HEADS, HEAD_DIM, POOL, BLOCK, TABLE, plan.chunk,
            plan.ctas, st)),
        ("B5 decode_attention_paged bf16", lambda: fa.decode_attention_paged(
            q, pk, pv, lengths, tables, HEADS)),
        ("B4 ctypes call and its one launch alone", lambda: fn4(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), counters.data_ptr(), None,
            SLOTS, HEADS, HEAD_DIM, TABLE * BLOCK, plan.chunk, plan.ctas,
            st)),
        ("B4 decode_attention bf16", lambda: fa.decode_attention(
            q, kc, vc, lengths, HEADS)),
    )
    if baseline:
        fn0 = build_baseline(os.path.join(baseline, "decode_attention.cu"),
                             BASELINE_ENTRIES)["decode_attention_bf16"]
        cases += (
            ("baseline C entry and its one launch alone", lambda: fn0(
                q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), SLOTS, HEADS, HEAD_DIM,
                TABLE * BLOCK, st)),
            ("baseline wrapper bf16", lambda: baseline_wrapper(
                fn0, q, kc, vc, lengths, HEADS)),
        )
    for name, f in cases:
        print("[host] %-44s %7.2f us per call" % (name, host_us(f)))
    if baseline:
        # B4's wrapper and C entry against the earlier ones in turn, many
        # short rounds: the host's spread between rounds is wider than
        # their difference
        pairs = {name: f for name, f in cases if name in (
            "B4 decode_attention bf16", "baseline wrapper bf16",
            "B4 ctypes call and its one launch alone",
            "baseline C entry and its one launch alone")}
        times = {name: [] for name in pairs}
        for _ in range(HOST_ROUNDS):
            for name, f in pairs.items():
                times[name].append(host_us(f, n=500))
        for name, ts in times.items():
            ts.sort()
            print("[host] %-44s median %7.2f, min %7.2f us per call over %d "
                  "rounds in turn" % (name, ts[len(ts) // 2], ts[0],
                                      len(ts)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probes", nargs="*",
                    choices=["b5", "sweep", "b4", "host"],
                    help="default: all four")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", default=None,
                    help="a directory holding an earlier decode_attention.cu "
                    "to time beside B4 (b4, host)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print("[device] %s" % smi)
    rng = np.random.default_rng(args.seed)
    _build.build(["decode_attention", "decode_attention_paged"])
    probes = {"b5": probe_b5, "sweep": probe_sweep,
              "b4": functools.partial(probe_b4, baseline=args.baseline),
              "host": functools.partial(probe_host, baseline=args.baseline)}
    for probe in args.probes or list(probes):
        probes[probe](rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
