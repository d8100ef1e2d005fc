"""Kernel B3 (``csrc/int8_matmul.cu``) on the card: its design variants,
its prefill tiles, and the host time of one launch.

    python3 -m paddle_tpu_torch.probes.int8 [variants] [tiles] [host]

``variants`` builds the kernel's source and edited copies of it, each
with one decision undone or changed, and times every build at the path's
decode and prefill shapes (profiler kernel durations), with the count of
output elements that differ from the plain version:

* ``current``: the source as it is;
* ``divide-all-rows``: a decode tile's rows past m are quantized too,
  rather than stored as 0 without a division;
* ``first-full-width``: as ``divide-all-rows``, and the decode CTA's
  warps also meet at a block-wide barrier every k tile, with the amax
  loop unrolled 4 — the design of the first full-width run;
* ``no-division``: x * scale in place of x / scale; wrong results,
  timed to price the IEEE divisions;
* ``decode-64-columns``: decode CTAs of 64 columns and 4 k groups
  instead of 32 columns and 8.

``tiles`` runs each prefill tile of the source
(``quant_ops.PREFILL_TILES``) and each of ``TILES``, built in edited
copies of it, at each prefill shape of the path (m 128 and 512), and
times each between CUDA events over queued calls and by the profiler
(``probes.common``), beside the tile ``quant_ops._plan`` picks, with the
count of output elements that differ from the plain version.

``host`` times the host side of the pieces of one B3 launch, and the f32
``torch.matmul`` that B3 replaces, on the path's decode shape, and of a
prefill launch (its plan, its scratch, the C entry's two launches).

Builds go to ``build/probe/`` inside the package. Needs one CUDA card
and ``nvcc``.
"""

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import _build, nn_ops, quant_ops
from .common import build_edited, cuda_ms, device_ms

# (old, new) source edits per variant; each old text must be present
_UNSKIP = ("row0 + r < m ? quant4(xa[i], s_scale[r]) : 0u",
           "quant4(xa[i], s_scale[r])")
VARIANTS = {
    "current": (),
    "divide-all-rows": (_UNSKIP,),
    "first-full-width": (
        _UNSKIP,
        ("if constexpr (GT == 32) __syncwarp(); else __syncthreads();",
         "__syncthreads();"),
        ("#pragma unroll 8\n        for (int c = lane; c < k / 4;",
         "#pragma unroll 4\n        for (int c = lane; c < k / 4;")),
    "no-division": (("rintf(__fdiv_rn(v[i], scale))", "rintf(v[i] * scale)"),),
    "decode-64-columns": (("launch<1, 1, 8>(", "launch<1, 2, 4>("),),
}
# tiles the C entry does not instantiate, each built in place of its
# tile 0 (64 x 128): name -> ((BM, BN), the warp layout WM, WN, MT, NTL)
TILES = {"128x128": ((128, 128), "2, 4, 4, 4"),
         "128x64": ((128, 64), "2, 2, 4, 4"),
         "64x64": ((64, 64), "2, 2, 2, 4")}
TILE_SWEEP = {"current": ()}
TILE_SWEEP.update(
    (name, (("kPrefillTiles[][2] = {{64, 128},",
             "kPrefillTiles[][2] = {{%d, %d}," % tile),
            ("launch_prefill<0, 2, 4, 2, 4>(",
             "launch_prefill<0, %s>(" % warps)))
    for name, (tile, warps) in TILES.items())
# decode (m 8, each layer's four (2048, 2048) products, the FFN pair and
# the LM head), the LM head at prefill (m 1) and one prefill FFN product
SHAPES = ((8, 2048, 2048), (8, 2048, 8192), (8, 8192, 2048),
          (8, 2048, 32768), (1, 2048, 32768), (512, 2048, 8192))
# B3 launches of one decode step per shape: 12 layers
PER_STEP = {(8, 2048, 2048): 48, (8, 2048, 8192): 12, (8, 8192, 2048): 12,
            (8, 2048, 32768): 1}
# the prefill products of the path: windows padded to the buckets
PREFILL_SHAPES = tuple((m, k, n) for m in (128, 512)
                       for k, n in ((2048, 2048), (2048, 8192),
                                    (8192, 2048)))


def launcher(fn, x, wq, ws, out, plan, name):
    """A call of a ctypes ``int8_matmul`` by ``plan``, its scratch made
    once here."""
    m, k = x.shape
    n = wq.shape[1]
    scratch = torch.empty(max(plan.scratch_bytes, 1), dtype=torch.uint8,
                          device=x.device)
    st = _build.stream(x.device)

    def call():
        _build.check(fn(x.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                        out.data_ptr(), scratch.data_ptr(), m, k, n,
                        plan.tile, st), name)
    return call


def quantized(rng, k, n):
    """A normal(0, 0.02) weight quantized as arming does, on the card."""
    from ..serving.quant import quantize_array
    w = rng.standard_normal((k, n), dtype=np.float32) * np.float32(0.02)
    q, s = quantize_array(w, 1)
    return torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()


def probe_variants(rng):
    fns = build_edited("int8_matmul", "int8_matmul", VARIANTS)
    step = {name: 0.0 for name in fns}
    for m, k, n in SHAPES:
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
        x = x.cuda()
        wq, ws = quantized(rng, k, n)
        want = quant_ops.int8_matmul_plain(x, wq, ws)
        parts = []
        for name, fn in fns.items():
            out = torch.empty((m, n), device="cuda")
            call = launcher(fn, x, wq, ws, out, quant_ops._plan(m, k, n),
                            name)
            call()
            torch.cuda.synchronize()
            ms = device_ms(call)
            step[name] += ms * PER_STEP.get((m, k, n), 0)
            parts.append("%s %.4f ms (%d differ)"
                         % (name, ms, int((out != want).sum())))
        print("[variants] m=%d k=%d n=%d: %s" % (m, k, n, "; ".join(parts)))
    print("[variants] B3 device time of one decode step (73 products): %s"
          % "; ".join("%s %.3f ms" % kv for kv in step.items()))


def probe_tiles(rng):
    fns = build_edited("int8_matmul", "int8_matmul", TILE_SWEEP)
    for m, k, n in PREFILL_SHAPES:
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
        x = x.cuda()
        wq, ws = quantized(rng, k, n)
        want = quant_ops.int8_matmul_plain(x, wq, ws)
        parts = []
        runs = [(fns["current"], tile, quant_ops.PREFILL_TILES)
                for tile in range(len(quant_ops.PREFILL_TILES))]
        runs += [(fns[name], 0, (bm_bn,) + quant_ops.PREFILL_TILES[1:])
                 for name, (bm_bn, _) in TILES.items()]
        for fn, tile, tiles in runs:
            plan = quant_ops._plan(m, k, n, tile=tile, tiles=tiles)
            out = torch.empty((m, n), device="cuda")
            call = launcher(fn, x, wq, ws, out, plan, "int8_matmul")
            call()
            torch.cuda.synchronize()
            differ = int((out != want).sum())
            parts.append("%dx%d (%d CTAs) events %.4f ms, profiler %.4f ms, "
                         "%d differ" % (plan.bm, plan.bn,
                                        plan.grid[0] * plan.grid[1],
                                        cuda_ms(call), device_ms(call),
                                        differ))
        chosen = quant_ops._plan(m, k, n)
        print("[tiles] m=%d k=%d n=%d (plan: %dx%d): %s"
              % (m, k, n, chosen.bm, chosen.bn, "; ".join(parts)))


def host_us(fn, n=2000):
    """Mean host time of one ``fn()`` call in microseconds, without
    waiting for the device."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def probe_host(rng):
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.from_numpy(rng.standard_normal((8, 1, 2048),
                                             dtype=np.float32)).cuda()
    x2 = x.reshape(8, 2048)
    wq, ws = quantized(rng, 2048, 2048)
    w32 = wq.float() * ws[None, :]
    out = torch.empty((8, 2048), device="cuda")
    fn = _build.entry("int8_matmul")
    st = _build.stream(dev)
    plan = quant_ops._plan(8, 2048, 2048)
    xp = torch.from_numpy(rng.standard_normal((512, 2048),
                                              dtype=np.float32)).cuda()
    pre = quant_ops._plan(512, 2048, 2048)
    outp = torch.empty((512, 2048), device="cuda")
    scratch = torch.empty(pre.scratch_bytes, dtype=torch.uint8, device="cuda")
    cases = (
        ("torch.cuda.current_stream(dev).cuda_stream",
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("_build.stream(dev)", lambda: _build.stream(dev)),
        ("torch.empty [8, 2048]",
         lambda: torch.empty((8, 2048), dtype=torch.float32, device=dev)),
        ("ctypes call and launch alone", lambda: fn(
            x2.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(),
            None, 8, 2048, 2048, plan.tile, st)),
        ("quant_matmul_2d [8, 2048] x [2048, 2048]",
         lambda: quant_ops.quant_matmul_2d(x2, wq, ws)),
        ("nn_ops.mul int8 [8, 1, 2048]", lambda: nn_ops.mul(x, wq, ws)),
        ("torch.matmul f32 [8, 1, 2048]", lambda: torch.matmul(x, w32)),
        ("quant_ops._plan(512, 2048, 2048)",
         lambda: quant_ops._plan(512, 2048, 2048)),
        ("torch.empty prefill scratch (%d bytes)" % pre.scratch_bytes,
         lambda: torch.empty(pre.scratch_bytes, dtype=torch.uint8,
                             device=dev)),
        ("ctypes call, prefill [512, 2048] x [2048, 2048]", lambda: fn(
            xp.data_ptr(), wq.data_ptr(), ws.data_ptr(), outp.data_ptr(),
            scratch.data_ptr(), 512, 2048, 2048, pre.tile, st)),
        ("quant_matmul_2d [512, 2048] x [2048, 2048]",
         lambda: quant_ops.quant_matmul_2d(xp, wq, ws)),
        ("torch.matmul f32 [512, 2048] x [2048, 2048]",
         lambda: torch.matmul(xp, w32)),
    )
    for name, f in cases:
        print("[host] %-44s %7.2f us per call" % (name, host_us(f)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probes", nargs="*",
                    choices=["variants", "tiles", "host"],
                    help="default: all three")
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
    _build.build(["int8_matmul"])
    probes = {"variants": probe_variants, "tiles": probe_tiles,
              "host": probe_host}
    for probe in args.probes or list(probes):
        probes[probe](rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
