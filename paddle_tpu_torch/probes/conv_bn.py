"""Kernel B1 and the probe T1 on the card.

    python3 -m paddle_tpu_torch.probes.conv_bn [t1] [b1] [--seed N]

``t1`` (reference ``tools/fused_conv_bn_probe.py``): a 1x1 convolution
with the BN-apply + ReLU of its input in the prologue and the BN
statistics of its output in the epilogue, in bf16, against the plain
torch path, at the probe's three ResNet-50 cases. For each case (rows
R = 256 H W, C -> O) it prints, as the reference probe does, the plain
path's time (``conv1x1_bn_relu_plain``: ``z = relu(x * a + b)`` rounded
to bf16, an f32 matmul, the sums), the kernel's
(``ops.conv_bn.conv1x1_bn_relu``, the bf16 instantiation in kernel B1's
source ``csrc/conv_bn_stats.cu``), their ratio, the largest difference
of y and of the sums per row, and the ideal bytes (x read once, y
written once). Times are profiler kernel durations.

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
import json
import subprocess
import sys

import torch

from ..ops import _build, conv_bn
from ..place import resolve_device
from .common import build_edited, cuda_ms, device_ms

# (name, rows, C, O): bottleneck conv3 shapes per stage at batch 256
CASES = (("stage2 28x28 128->512", 256 * 28 * 28, 128, 512),
         ("stage3 14x14 256->1024", 256 * 14 * 14, 256, 1024),
         ("stage1 56x56 64->256", 256 * 56 * 56, 64, 256))


def probe(seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for name, n, c, o in CASES:
        x = torch.randn(n, c, device="cuda", generator=gen).bfloat16()
        a = (torch.rand(c, device="cuda", generator=gen) + 0.5).bfloat16()
        b = (torch.randn(c, device="cuda", generator=gen) * 0.1).bfloat16()
        w = (torch.randn(c, o, device="cuda", generator=gen)
             * 0.05).bfloat16()
        plain_ms = device_ms(lambda: conv_bn.conv1x1_bn_relu_plain(
            x, a, b, w))
        kernel_ms = device_ms(lambda: conv_bn.conv1x1_bn_relu(x, a, b, w))
        y, s, _ = conv_bn.conv1x1_bn_relu(x, a, b, w)
        wy, ws, _ = conv_bn.conv1x1_bn_relu_plain(x, a, b, w)
        err = float((y.float() - wy.float()).abs().max())
        serr = float((s - ws).abs().max()) / n
        ideal_gb = (n * c * 2 + n * o * 2) / 1e9
        print(json.dumps({
            "case": name, "plain_ms": round(plain_ms, 4),
            "kernel_ms": round(kernel_ms, 4),
            "speedup": round(plain_ms / kernel_ms, 3),
            "max_err": err, "stats_err_per_row": serr,
            "ideal_GB": round(ideal_gb, 4),
            "ideal_ms_at_3.35TB/s": round(ideal_gb / 3.35, 4)}))


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
    ap.add_argument("probes", nargs="*", choices=["t1", "b1"],
                    help="default: both")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    resolve_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print("[device] %s" % smi)
    _build.build(["conv_bn_stats"])
    for name in args.probes or ["t1", "b1"]:
        {"t1": probe, "b1": probe_b1}[name](args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
