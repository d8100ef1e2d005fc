"""Convolution throughput by layout and dtype, and the bf16 matmul
(reference ``tools/layout_probe.py``).

    python3 -m paddle_tpu_torch.probes.layout [--device cpu]

An 8-deep stack of 3x3 convolutions (stride 1, padding 1) each followed
by a ReLU, one weight for all eight, at ResNet-50's mid stage
[256, 256, 28, 28] on the card, in {NCHW, channels-last (``NHWC``)} x
{float32, bfloat16} (``F.conv2d``, cuDNN; TF32 off), and the 8192³
bfloat16 product (``torch.matmul``). Times are device times
(``probes/common.py`` ``cuda_ms``); TFLOP/s and the share of the H100's
data-sheet peak for the dtype (f32 67, bf16 989 TFLOP/s). On the CPU,
where the reference has no size of its own: [8, 32, 14, 14] and 512³.
Inputs are N(0, 1) from a seeded generator. Each line is one JSON
object.
"""

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from .common import BF16_FLOPS, F32_FLOPS, probe_device, probe_ms

CARD = dict(shape=(256, 256, 28, 28), m=8192)
CPU = dict(shape=(8, 32, 14, 14), m=512)
DEPTH = 8
PEAK = {torch.float32: F32_FLOPS, torch.bfloat16: BF16_FLOPS}
LAYOUTS = {"NCHW": torch.contiguous_format, "NHWC": torch.channels_last}


def stack(x, w):
    """The 8-deep conv + ReLU stack (the reference's ``conv_stack``'s
    ``f``)."""
    y = x
    for _ in range(DEPTH):
        y = torch.relu(F.conv2d(y, w, padding=1))
    return y


def inputs(layout, dtype, shape, device, seed=0):
    """(x [B, C, H, W], w [C, C, 3, 3]) in ``layout``'s memory format."""
    b, c, h, wd = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    fmt = LAYOUTS[layout]
    x = torch.randn((b, c, h, wd), generator=gen, device=device)
    w = torch.randn((c, c, 3, 3), generator=gen, device=device)
    return (x.to(dtype).contiguous(memory_format=fmt),
            w.to(dtype).contiguous(memory_format=fmt))


def conv_stack(layout, dtype, shape, device):
    """(ms, TFLOP/s) of the stack."""
    x, w = inputs(layout, dtype, shape, device)
    ms = probe_ms(lambda: stack(x, w), device)
    b, c, h, wd = shape
    flops = DEPTH * 2 * b * h * wd * c * c * 9
    return ms, flops / ms / 1e9


def matmul(m, device):
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((m, m), generator=gen, device=device).to(torch.bfloat16)
    ms = probe_ms(lambda: torch.matmul(a, a), device, iters=20)
    return ms, 2 * m ** 3 / ms / 1e9


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = probe_device(args.device)
    if device is None:
        return 1
    cfg = CARD if device.type == "cuda" else CPU
    ms, tf = matmul(cfg["m"], device)
    print(json.dumps({"probe": "matmul", "m": cfg["m"], "dtype": "bfloat16",
                      "ms": ms, "tflops": tf,
                      "pct_of_peak": 100 * tf * 1e12 / BF16_FLOPS}),
          flush=True)
    for layout in LAYOUTS:
        for dtype in (torch.float32, torch.bfloat16):
            ms, tf = conv_stack(layout, dtype, cfg["shape"], device)
            print(json.dumps({
                "probe": "conv_stack", "layout": layout,
                "dtype": str(dtype).split(".")[1], "shape": cfg["shape"],
                "ms": ms, "tflops": tf,
                "pct_of_peak": 100 * tf * 1e12 / PEAK[dtype]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
