"""The ResNet program's training step, its reckoned work and its MFU
(reference ``tools/mfu_probe.py``).

    python3 -m paddle_tpu_torch.probes.mfu [--batch 256] [--depth 50]
        [--amp bfloat16|none] [--recompute] [--fused-conv-bn]
        [--steps 20] [--warmup 5] [--top-ops N] [--no-time] [--device cpu]

Builds ``resnet_imagenet`` as a program (Momentum(0.1, 0.9)), feeds one
``RandomState(0)`` batch (images N(0, 1), int32 labels in 0..999) from
the device, and times ``--steps`` runs of ``Executor.run`` after
``--warmup``, closed by reading the last loss. On the card the sizes are
the reference's (batch 256 at 224²); on the CPU, where the reference has
no size of its own, batch 4 at 64², 2 steps after 1.

Prints one JSON line under the reference's keys. The work is reckoned
from the program (``probes/common.py`` ``program_work``: 3x the
forward's convolution and fc FLOPs, the parameters' and activations'
bytes), where the reference reads XLA's cost analysis: it stands under
``ca_tflops_per_step`` and ``ca_gb_per_step``, and ``roofline_ms`` is
the larger of those bytes at the H100's HBM rate and those FLOPs at its
peak. ``mfu`` is the reference's figure (12.3 G multiply-adds an image,
ResNet-50 only) over the H100's FLOP/s peak for the step's dtype (bf16
under amp, f32 otherwise): it counts a multiply-add as one operation
where the peak counts two, so it is about half the step's FLOP
utilization; ``mfu_program``, the reckoned FLOPs over the same peak, is
that utilization. ``--top-ops N`` ranks the program's ops by the bytes
of their outputs (the reference ranks the compiled HLO's), then by
type. A last line gives the kernels' launches.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import config, core, layers, optimizer
from ..core.framework import convert_dtype
from ..models import resnet
from .common import (BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S, launch_counts,
                     launches_since, probe_device, program_work)

CARD = dict(batch=256, steps=20, warmup=5)
CPU = dict(batch=4, steps=2, warmup=1)
RES = {"cuda": 224, "cpu": 64}
# the reference's multiply-adds a ResNet-50 image, forward and backward
GMAC_PER_IMAGE = 12.3


def build_step(batch, depth, recompute, device, res=224, seed=0):
    """(executor, scope, main program, startup, loss, feed): the program
    built and its startup run; the flags as the caller set them."""
    main, startup = core.Program(), core.Program()
    with core.unique_name.guard(), core.program_guard(main, startup):
        img = layers.data("img", shape=[3, res, res])
        label = layers.data("label", shape=[1], dtype="int64")
        loss, _, _ = resnet.resnet_imagenet(img, label, depth=depth,
                                            recompute=recompute)
        optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(
            loss, startup_program=startup)
    exe, scope = core.Executor(device=device), core.Scope()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(seed)
    feed = {"img": torch.from_numpy(
                rs.randn(batch, 3, res, res).astype(np.float32)).to(device),
            "label": torch.from_numpy(
                rs.randint(0, 1000, (batch, 1)).astype(np.int32)).to(device)}
    return exe, scope, main, startup, loss, feed


def run_steps(exe, scope, main, loss, feed, steps, warmup):
    """(seconds a step, last loss) of ``steps`` runs after ``warmup``."""
    for _ in range(max(warmup, 1)):
        r = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)
    float(r[0])
    t0 = time.perf_counter()
    for _ in range(steps):
        r = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)
    lv = float(r[0])
    return (time.perf_counter() - t0) / steps, lv


def top_ops(main, batch, n):
    """The program's ``n`` largest op outputs by bytes at ``batch``, and
    the bytes by op type (the 12 largest)."""
    block = main.global_block()
    rows = []
    for i, op in enumerate(block.ops):
        for names in op.outputs.values():
            for name in names:
                var = block.var_or_none(name)
                if var is None or var.shape is None:
                    continue
                numel = int(np.prod([batch if d == -1 else d
                                     for d in var.shape]))
                try:
                    size = np.dtype(convert_dtype(var.dtype)).itemsize
                except TypeError:
                    size = 2  # bfloat16
                rows.append((numel * size, name, list(var.shape), op.type, i))
    rows.sort(key=lambda r: -r[0])
    agg = {}
    for b, _, _, kind, _ in rows:
        agg[kind] = agg.get(kind, 0) + b
    return rows[:n], sorted(agg.items(), key=lambda kv: -kv[1])[:12]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int)
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--amp", default="bfloat16")
    ap.add_argument("--recompute", action="store_true")
    ap.add_argument("--fused-conv-bn", action="store_true",
                    help="the fused_conv_bn flag: kernel B1 at f32")
    ap.add_argument("--steps", type=int)
    ap.add_argument("--warmup", type=int)
    ap.add_argument("--top-ops", type=int, default=0)
    ap.add_argument("--no-time", action="store_true",
                    help="the reckoning only (no timed window)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = probe_device(args.device)
    if device is None:
        return 1
    sizes = CARD if device.type == "cuda" else CPU
    for k, v in sizes.items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    amp = None if args.amp in (None, "", "none") else args.amp
    config.set_flags(amp=amp, fused_conv_bn=args.fused_conv_bn)
    try:
        exe, scope, main_p, _, loss, feed = build_step(
            args.batch, args.depth, args.recompute, device,
            res=RES[device.type])
        peak = BF16_FLOPS if amp else F32_FLOPS
        out = {"batch": args.batch, "res": RES[device.type],
               "depth": args.depth,
               "amp": args.amp, "recompute": bool(args.recompute),
               "fused_conv_bn": bool(args.fused_conv_bn),
               "device": torch.cuda.get_device_name(device)
               if device.type == "cuda" else "cpu",
               "work_from": "program_work"}
        flops, nbytes, params = program_work(main_p, args.batch)
        out["ca_tflops_per_step"] = flops / 1e12
        out["ca_gb_per_step"] = nbytes / 1e9
        out["roofline_ms"] = max(nbytes / HBM_BYTES_PER_S,
                                 flops / peak) * 1e3
        out["params"] = params
        before = launch_counts()
        if not args.no_time:
            dt, lv = run_steps(exe, scope, main_p, loss, feed, args.steps,
                               args.warmup)
            out["loss"] = lv
            out["ms_per_step"] = dt * 1e3
            out["img_per_sec"] = args.batch / dt
            out["peak_tflops"] = peak / 1e12
            if args.depth == 50:
                # the reference's key and formula: 12.3 G multiply-adds
                # an image (ResNet-50's; other depths report time and
                # throughput only) over a FLOP/s peak, so about half of
                # mfu_program
                out["mfu"] = args.batch / dt * GMAC_PER_IMAGE * 1e9 / peak
            out["mfu_program"] = flops / dt / peak
            if device.type == "cuda":
                out["peak_allocated_gb"] = \
                    torch.cuda.max_memory_allocated(device) / 1e9
        print(json.dumps(out), flush=True)
        if args.top_ops:
            rows, agg = top_ops(main_p, args.batch, args.top_ops)
            print("-- top op outputs by bytes --")
            for b, name, shape, kind, i in rows:
                print("%8.1f MB  %-16s %-24s %s (op %d)"
                      % (b / 1e6, kind, shape, name, i))
            print("-- output bytes by op type --")
            for k, v in agg:
                print("%8.2f GB  %s" % (v / 1e9, k))
        print(json.dumps({"probe": "launches", **launches_since(before)}),
              flush=True)
    finally:
        config.set_flags(amp=None, fused_conv_bn=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
