"""Kernels B5 (``csrc/decode_attention_paged.cu``) and B4
(``csrc/decode_attention.cu``) on the card, at the serving path's width
(8 slots, 16 heads of 128, block 16, 64 blocks a table, 512 blocks a
pool) and three sets of lengths: the paged cell's, one slot at 1024 with
the others at 1 (the worst imbalance), and all eight at 1024.

    python3 -m paddle_tpu_torch.probes.decode [b5] [sweep] [b4] [host]

``b5`` times B5 on float32 and bfloat16 pools, on a cold L2 (calls taken
in turn over copies of the pools, ``probes.common.cold_calls``) and warm,
with its bound and its error against the plain version; ``sweep`` times
B5's key-chunk sizes (``PAGED_CHUNKS``), grid sizes (``PAGED_CTAS``)
and edited builds of the source (``BUILDS``: loads in flight, CTAs an
SM) at each set of lengths on the cold clock, with the CTAs launched and
the CTAs that took a work item (counted on the card); ``b4`` times B4 on
the same logical caches, dense, both clocks; ``host`` times the host
side of one B5 call at the paged cell's lengths (its plan, its scratch,
the C entry's two launches, the wrapper) beside B4's wrapper and C
entry (one launch). Builds of edited sources go to ``build/probe/``
inside the package. Needs one CUDA card and ``nvcc``.
"""

import argparse
import functools
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops import flash_attention as fa
from .common import build_edited, cold_calls, cuda_ms, host_us

SLOTS, HEADS, HEAD_DIM, BLOCK, TABLE = 8, 16, 128, 16, 64
POOL = SLOTS * TABLE
LENGTHS = {"paged cell": (259, 331, 531, 259, 131, 1, 1, 1),
           "one at 1024": (1024,) + (1,) * (SLOTS - 1),
           "all at 1024": (1024,) * SLOTS}
HBM_BYTES_PER_S = 3.35e12
# the sweep: key-chunk sizes, grid sizes (at the plan's chunk), and edited
# builds of the source: 4 loads of K and V in flight a lane instead of 8,
# and the split kernel held to 3 CTAs an SM (85 registers a thread)
PAGED_CHUNKS = (32, 64, 128, 256)
PAGED_CTAS = (132, 264, 528, 1056)
BUILDS = {"current": (),
          "loads-4": (("constexpr int kLoads = 8;",
                       "constexpr int kLoads = 4;"),),
          "3-ctas-an-sm": (("__launch_bounds__(kWarps * 32)\npaged_split",
                            "__launch_bounds__(kWarps * 32, 3)\n"
                            "paged_split"),)}


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


def split_work(q, pk, pv, lengths, tables, heads, plan, fn):
    """(CTAs that took a work item, items taken) of one launch of B5's
    split by ``plan`` through the C entry ``fn``, counted on the card."""
    work = torch.zeros(2, dtype=torch.int32, device=q.device)
    fa._launch_paged(q, pk, pv, lengths, tables, heads, plan, fn, work)
    ctas, items = work.tolist()
    return ctas, items


def probe_b5(rng):
    for label, lens in LENGTHS.items():
        for dtype in (torch.float32, torch.bfloat16):
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
    fns = build_edited("decode_attention_paged",
                       ("decode_attention_paged_f32",
                        "decode_attention_paged_bf16"), BUILDS)
    for label, lens in LENGTHS.items():
        for i, dtype in enumerate((torch.float32, torch.bfloat16)):
            q, pk, pv, lengths, tables = paged_inputs(rng, lens, dtype)
            want = fa._decode_paged_reference(q, pk, pv, lengths, tables,
                                              HEADS)
            pools = cold_calls(lambda: (pk.clone(), pv.clone()),
                               live_bytes(lens, dtype))
            configs = [(build, chunk, None) for build in BUILDS
                       for chunk in PAGED_CHUNKS]
            configs += [("current", None, ctas) for ctas in PAGED_CTAS]
            parts = []
            for build, chunk, ctas in configs:
                plan = fa._paged_plan(SLOTS, HEADS, HEAD_DIM, BLOCK, TABLE,
                                      chunk=chunk, ctas=ctas)
                fn = fns[build][i]

                def call(k, v, plan=plan, fn=fn):
                    return fa._launch_paged(q, k, v, lengths, tables, HEADS,
                                            plan, fn)
                err = float((call(pk, pv) - want).abs().max())
                ms = cuda_ms([functools.partial(call, k, v)
                              for k, v in pools])
                working = split_work(q, pk, pv, lengths, tables, HEADS,
                                     plan, fn)[0]
                parts.append("%s, chunk %d, %d CTAs (%d with work): "
                             "%.4f ms, err %.2g"
                             % (build, plan.chunk, plan.ctas, working, ms,
                                err))
            print("[sweep] %s %s: %s" % (label, str(dtype)[6:],
                                          "; ".join(parts)))
            del pools


def probe_b4(rng):
    c, hd = TABLE * BLOCK, HEADS * HEAD_DIM
    for label, lens in LENGTHS.items():
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.from_numpy(rng.standard_normal(
                (SLOTS, hd), dtype=np.float32)).cuda()
            kc, vc = (torch.from_numpy(rng.standard_normal(
                (SLOTS, c, hd), dtype=np.float32)).cuda().to(dtype)
                for _ in range(2))
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            cold = cuda_ms(cold_calls(
                lambda: lambda k=kc.clone(), v=vc.clone():
                fa.decode_attention(q, k, v, lengths, HEADS),
                live_bytes(lens, dtype)))
            warm = cuda_ms(lambda: fa.decode_attention(q, kc, vc, lengths,
                                                       HEADS))
            print("[b4] %s %s: cold %.4f ms, warm %.4f ms, bound %.4f ms"
                  % (label, str(dtype)[6:], cold, warm,
                     bound_ms(lens, dtype)))
            del kc, vc


def probe_host(rng):
    lens = LENGTHS["paged cell"]
    dev = torch.device("cuda", torch.cuda.current_device())
    st = _build.stream(dev)
    q, pk, pv, lengths, tables = paged_inputs(rng, lens, torch.bfloat16)
    plan = fa._paged_plan(SLOTS, HEADS, HEAD_DIM, BLOCK, TABLE)
    fn = _build.entry("decode_attention_paged_bf16")
    scratch = _build.scratch(dev, st, plan.scratch_bytes)
    out = torch.empty_like(q)
    kc, vc = (torch.zeros((SLOTS, TABLE * BLOCK, HEADS * HEAD_DIM),
                          dtype=torch.bfloat16, device=dev)
              for _ in range(2))
    fn4 = _build.entry("decode_attention_bf16")
    cases = (
        ("_paged_plan (cached)", lambda: fa._paged_plan(
            SLOTS, HEADS, HEAD_DIM, BLOCK, TABLE)),
        ("_build.scratch(dev, stream, %d)" % plan.scratch_bytes,
         lambda: _build.scratch(dev, st, plan.scratch_bytes)),
        ("B5 ctypes call and its two launches alone", lambda: fn(
            q.data_ptr(), pk.data_ptr(), pv.data_ptr(), lengths.data_ptr(),
            tables.data_ptr(), out.data_ptr(), scratch.data_ptr(), None,
            SLOTS, HEADS, HEAD_DIM, POOL, BLOCK, TABLE, plan.chunk,
            plan.ctas, st)),
        ("B5 decode_attention_paged bf16", lambda: fa.decode_attention_paged(
            q, pk, pv, lengths, tables, HEADS)),
        ("B4 ctypes call and its one launch alone", lambda: fn4(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), SLOTS, HEADS, HEAD_DIM, TABLE * BLOCK, st)),
        ("B4 decode_attention bf16", lambda: fa.decode_attention(
            q, kc, vc, lengths, HEADS)),
    )
    for name, f in cases:
        print("[host] %-44s %7.2f us per call" % (name, host_us(f)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probes", nargs="*",
                    choices=["b5", "sweep", "b4", "host"],
                    help="default: all four")
    ap.add_argument("--seed", type=int, default=0)
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
    probes = {"b5": probe_b5, "sweep": probe_sweep, "b4": probe_b4,
              "host": probe_host}
    for probe in args.probes or list(probes):
        probes[probe](rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
