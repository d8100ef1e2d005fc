"""The probe T1 on the card (reference ``tools/fused_conv_bn_probe.py``):
a 1x1 convolution with the BN-apply + ReLU of its input in the
prologue and the BN statistics of its output in the epilogue, in bf16,
against the plain torch path, at the probe's three ResNet-50 cases.

    python3 -m paddle_tpu_torch.probes.conv_bn [--seed N]

For each case (rows R = 256 H W, C -> O) it prints, as the reference
probe does, the plain path's time (``conv1x1_bn_relu_plain``:
``z = relu(x * a + b)`` rounded to bf16, an f32 matmul, the sums), the
kernel's (``ops.conv_bn.conv1x1_bn_relu``, the bf16 instantiation of
kernel B1's source ``csrc/conv_bn_stats.cu``), their ratio, the largest
difference of y and of the sums per row, and the ideal bytes (x read
once, y written once). Times are profiler kernel durations. The build
goes to ``build/`` inside the package. Needs one CUDA card and
``nvcc``.
"""

import argparse
import json
import subprocess
import sys

import torch

from ..ops import _build, conv_bn
from ..place import resolve_device
from .int8 import device_ms

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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    probe(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
