"""Kernel B1 and the probe T1 on the card.

    python3 -m paddle_tpu_torch.probes.conv_bn [t1] [t1-variants] [b1]
        [--seed N] [--baseline DIR]

``t1`` (reference ``tools/fused_conv_bn_probe.py``): a 1x1 convolution
with the BN-apply + ReLU of its input in the prologue and the BN
statistics of its output in the epilogue, in bf16, at the probe's three
ResNet-50 cases (rows R = 256 H W, C -> 4 C) and ragged ones. For each it
prints the kernel's time (``ops.conv_bn.conv1x1_bn_relu``,
``csrc/conv1x1_bn_relu.cu``) at its tile (starred) and at each other
tile of ``T1_TILES``, built in an edited copy of the source, its plain
version's, the torch route's (:func:`torch_route`, the
reference probe's ``xla_path`` in torch), all between CUDA events over
queued calls (``probes.common.cuda_ms``), beside its bytes bound; the
largest difference of y (in bf16 steps of max|y|) and of the sums
against the plain version, and whether two calls, the second on
partial sums that held NaN, give the same bits. With ``--baseline DIR``
(a directory holding an earlier ``conv_bn_stats.cu`` whose C entry
``conv1x1_bn_relu_bf16`` takes (x, a, b, w, y, part_s, part_ss, s, ss,
r, c, o, stream) with 64-row partials, such as the source before T1
moved to its own) that build is timed beside it.

``t1-variants``: T1 at the probe's cases at its tile, built from
edited copies of its source (``T1_VARIANTS``: without y's stores, one
CTA an SM promised to the register allocator, without the column sums'
shuffles), with the profiler's time of each of its two launches.

``b1``: kernel B1 with each tile of its source (``conv_bn.B1_TILES``)
and each of ``TILES``, built in an edited copy of it, at each shape of
the ResNet-50 step at batch 256 and at ragged shapes: the largest error
of y against the plain version in units of max|y|, whether two launches
repeat bit for bit, and its time between CUDA events over queued calls
and by the profiler (``probes.common``), beside cuDNN's ``F.conv2d``
plus the two sums and the tile ``conv_bn._plan`` picks.

The build goes to ``build/`` inside the package. Needs one CUDA card
and ``nvcc``.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import torch

from ..ops import _build, conv_bn
from ..place import resolve_device
from .common import (HBM_BYTES_PER_S, build_baseline, build_edited, cuda_ms,
                     device_ms)

# (name, rows, C, O): bottleneck conv3 shapes per stage at batch 256
CASES = (("stage2 28x28 128->512", 256 * 28 * 28, 128, 512),
         ("stage3 14x14 256->1024", 256 * 14 * 14, 256, 1024),
         ("stage1 56x56 64->256", 256 * 56 * 56, 64, 256))
# off the probe's cases: ragged R, C and O (element-wise copies), more
# channels than a z tile holds (chunks of 256), a single row
T1_RAGGED = (("ragged", 1000, 72, 136), ("odd", 333, 37, 21),
             ("wide C", 700, 600, 264), ("one row", 1, 8, 8))
_P, _I = ctypes.c_void_p, ctypes.c_int
BASELINE_ENTRY = {"conv1x1_bn_relu_bf16": (_P,) * 9 + (_I,) * 3 + (_P,)}
BASELINE_ROWS = 64    # its rows a partial sum


def t1_inputs(gen, r, c, o):
    """x, a, b, w of the reference probe's kinds, bf16, on the card."""
    x = torch.randn(r, c, device="cuda", generator=gen).bfloat16()
    a = (torch.rand(c, device="cuda", generator=gen) + 0.5).bfloat16()
    b = (torch.randn(c, device="cuda", generator=gen) * 0.1).bfloat16()
    w = (torch.randn(c, o, device="cuda", generator=gen) * 0.05).bfloat16()
    return x, a, b, w


# T1's tile (conv_bn.T1_TILE) and the others swept, each built in an
# edited copy of its source: name -> (rows, columns) a CTA
T1_TILES = {"current": conv_bn.T1_TILE, "128x128": (128, 128),
            "64x128": (64, 128)}
T1_TILE_SWEEP = {
    name: (("constexpr int kT1BM = %d;" % conv_bn.T1_TILE[0],
            "constexpr int kT1BM = %d;" % bm),
           ("constexpr int kT1BN = %d;" % conv_bn.T1_TILE[1],
            "constexpr int kT1BN = %d;" % bn)) if name != "current" else ()
    for name, (bm, bn) in T1_TILES.items()}
# edited builds of T1's source for ``t1-variants``: where its time goes
T1_VARIANTS = {
    "current": (),
    # the y tile staged but not stored: the time without y's DRAM writes
    "no-y-stores": (("          __stcs(reinterpret_cast<uint4*>(y + gr * O + o),\n"
                     "                 *reinterpret_cast<const uint4*>(src));",
                     "          if (src == nullptr) y[0] = src[0];"),),
    # one CTA an SM promised to the register allocator
    "1-cta-an-sm": (("__global__ void __launch_bounds__(kT1Threads)\n"
                     "conv1x1_bn_relu_kernel",
                     "__global__ void __launch_bounds__(kT1Threads, 1)\n"
                     "conv1x1_bn_relu_kernel"),),
    # the column sums' shuffles left out (the sums come out wrong): their
    # share of the epilogue
    "no-sum-shuffles": (("    reduce_scatter8(cs, lane);\n"
                         "    reduce_scatter8(css, lane);\n", ""),)}


def kernel_split(fn, iters=10):
    """{kernel name: device us per call of fn()} from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("(")[0].split("::")[-1][:40]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / iters
    return out


def probe_variants(seed):
    fns = build_edited("conv1x1_bn_relu", "conv1x1_bn_relu_bf16",
                       T1_VARIANTS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for name, r, c, o in CASES:
        x, a, b, w = t1_inputs(gen, r, c, o)
        plan = conv_bn._t1_plan(r, c, o)
        parts = ["%s %.4f ms" % (variant, cuda_ms(
            lambda fn=fn: conv_bn._launch_t1(x, a, b, w, plan, fn=fn)))
            for variant, fn in fns.items()]
        split = kernel_split(lambda: conv_bn._launch_t1(x, a, b, w, plan))
        parts.append("by kernel (profiler, us): %s" % ", ".join(
            "%s %.1f" % kv for kv in split.items()))
        print("[t1-variants] %s (%dx%d): %s" % (name, plan.bm, plan.bn,
                                                 "; ".join(parts)))
        del x, a, b, w


def torch_route(x, a, b, w):
    """The reference probe's ``xla_path`` in torch, its yardstick: the
    prologue in bf16 ops, one bf16 x bf16 -> f32 product, the cast, the
    sums of the cast y in f32."""
    z = torch.relu(x * a + b)
    y = torch.mm(z, w, out_dtype=torch.float32).to(x.dtype)
    yf = y.float()
    return y, yf.sum(dim=0), (yf * yf).sum(dim=0)


def t1_bound_ms(r, c, o):
    """x and a, b, w read once, y and the two sums written once."""
    return (2 * (r * c + 2 * c + c * o + r * o) + 8 * o) \
        / HBM_BYTES_PER_S * 1e3


def t1_errors(got, want):
    """(y's largest difference in bf16 steps (2^-7) of max|y|, the sums'
    relative to the sum of |y| and of y^2) of ``got`` against ``want``."""
    y, s, ss = got
    wy, ws, wss = want
    yf, wyf = y.float(), wy.float()
    step = float(wyf.abs().max()) * 2 ** -7
    ey = float((yf - wyf).abs().max()) / step
    es = float(((s - ws).abs() / wyf.abs().sum(0).clamp(min=1e-30)).max())
    ess = float(((ss - wss).abs() / wss.clamp(min=1e-30)).max())
    return ey, es, ess


def probe(seed, baseline=None):
    old = None
    if baseline:
        old = build_baseline(os.path.join(baseline, "conv_bn_stats.cu"),
                             BASELINE_ENTRY)["conv1x1_bn_relu_bf16"]
    fns = build_edited("conv1x1_bn_relu", "conv1x1_bn_relu_bf16",
                       T1_TILE_SWEEP)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for name, r, c, o in CASES + T1_RAGGED:
        x, a, b, w = t1_inputs(gen, r, c, o)
        want = conv_bn.conv1x1_bn_relu_plain(x, a, b, w)
        parts = []
        for tile_name, fn in fns.items():
            plan = conv_bn._t1_plan(r, c, o, tile=T1_TILES[tile_name])
            got = conv_bn._launch_t1(x, a, b, w, plan, fn=fn)
            nan = torch.full((2, plan.row_tiles, o), float("nan"),
                             device="cuda")
            again = conv_bn._launch_t1(x, a, b, w, plan, part=nan, fn=fn)
            same = all(torch.equal(p, q) for p, q in zip(got, again))
            ey, es, ess = t1_errors(got, want)
            ms = cuda_ms(lambda: conv_bn._launch_t1(x, a, b, w, plan, fn=fn))
            parts.append("%dx%d%s %.4f ms (y %.2f steps, sums %.2g/%.2g, %s)"
                         % (plan.bm, plan.bn,
                            "*" if tile_name == "current" else "", ms, ey,
                            es, ess, "repeats" if same else "DIFFERS"))
        plain_ms = cuda_ms(lambda: conv_bn.conv1x1_bn_relu_plain(x, a, b, w))
        route_ms = cuda_ms(lambda: torch_route(x, a, b, w))
        line = ("[t1] %s R=%d C=%d O=%d: %s; plain %.4f ms; torch route "
                "%.4f ms; bound %.4f ms (bytes)"
                % (name, r, c, o, "; ".join(parts), plain_ms, route_ms,
                   t1_bound_ms(r, c, o)))
        if old is not None:
            def earlier():
                y = torch.empty((r, o), dtype=torch.bfloat16, device="cuda")
                part = torch.empty((2, -(-r // BASELINE_ROWS), o),
                                   device="cuda")
                sums = torch.empty((2, o), device="cuda")
                _build.check(old(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                                 w.data_ptr(), y.data_ptr(),
                                 part[0].data_ptr(), part[1].data_ptr(),
                                 sums[0].data_ptr(), sums[1].data_ptr(), r,
                                 c, o, _build.stream(x.device)), "baseline")
            line += "; baseline build %.4f ms" % cuda_ms(earlier)
        print(line)
        del x, a, b, w, want


# B1's (C, O, H = W) on the ResNet-50 path at batch 256, and ragged
# (N, C, O, H, W) cases: pixel tiles across images, P % 4 != 0
B1_SHAPES = ((64, 64, 56), (64, 256, 56), (256, 64, 56), (512, 128, 28),
             (128, 512, 28), (1024, 256, 14), (256, 1024, 14),
             (2048, 512, 7), (512, 2048, 7))
B1_RAGGED = ((3, 37, 19, 5, 7), (7, 96, 40, 9, 11), (5, 72, 136, 6, 6))
# tiles the C entry does not instantiate, each built in place of its
# tile 0 (64 x 128): name -> (BM, BN)
TILES = {"128x128": (128, 128)}
TILE_SWEEP = {"current": ()}
TILE_SWEEP.update(
    (name, (("kTiles[][2] = {{64, 128},", "kTiles[][2] = {{%d, %d}," % tile),))
    for name, tile in TILES.items())


def probe_b1(seed):
    import torch.nn.functional as F
    fns = build_edited("conv_bn_stats", "conv_bn_stats_f32", TILE_SWEEP)
    runs = [(fns["current"], tile, conv_bn.B1_TILES)
            for tile in range(len(conv_bn.B1_TILES))]
    runs += [(fns[name], 0, (tile,) + conv_bn.B1_TILES[1:])
             for name, tile in TILES.items()]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    cases = [(256, c, o, h, h) for c, o, h in B1_SHAPES] + list(B1_RAGGED)
    for n, c, o, h, w in cases:
        x = torch.randn(n, c, h, w, device="cuda", generator=gen)
        wt = torch.randn(o, c, 1, 1, device="cuda", generator=gen) \
            * c ** -0.5
        wy = conv_bn.conv_bn_stats_plain(x, wt)[0]
        scale = float(wy.abs().max())
        parts = []
        for fn, tile, tiles in runs:
            plan = conv_bn._plan(n, c, h * w, o, tile=tile, tiles=tiles)

            def call():
                return conv_bn._launch(x, wt, plan, fn=fn)

            got, again = call(), call()
            torch.cuda.synchronize()
            err = float((got[0] - wy).abs().max()) / scale
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            del got, again
            parts.append("%dx%d (%d CTAs) events %.4f ms, profiler %.4f ms, "
                         "err %.2e, %s" % (plan.bm, plan.bn, plan.ctas,
                                           cuda_ms(call),
                                           device_ms(call), err,
                                           "repeats" if same else "DIFFERS"))

        def library():
            y = F.conv2d(x, wt)
            return y, y.sum(dim=(0, 2, 3)), (y * y).sum(dim=(0, 2, 3))

        chosen = conv_bn._plan(n, c, h * w, o)
        print("[b1] N=%d C=%d O=%d %dx%d (plan %dx%d): %s; cuDNN + sums "
              "events %.4f ms, profiler %.4f ms"
              % (n, c, o, h, w, chosen.bm, chosen.bn, "; ".join(parts),
                 cuda_ms(library), device_ms(library)))
        del x, wt, wy


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probes", nargs="*",
                    choices=["t1", "t1-variants", "b1"],
                    help="default: t1 and b1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", default=None,
                    help="a directory holding an earlier conv_bn_stats.cu "
                    "whose T1 entry to time beside T1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    resolve_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print("[device] %s" % smi)
    _build.build(["conv_bn_stats", "conv1x1_bn_relu"])
    for name in args.probes or ["t1", "b1"]:
        if name == "t1":
            probe(args.seed, args.baseline)
        elif name == "t1-variants":
            probe_variants(args.seed)
        else:
            probe_b1(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
