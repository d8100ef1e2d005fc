"""Where the staged training pipeline's step time goes (reference
``tools/pipeline_probe.py``).

    python3 -m paddle_tpu_torch.probes.pipeline [--device cpu]
        [--amp bfloat16|none] [--fused-conv-bn]

ResNet-50 at 224², batch 8, 12 steps on the card; ResNet-20 (CIFAR) at
32², batch 4, 4 steps on the CPU (the reference's two sizes).
Momentum(0.1, 0.9) under the ``amp`` flag (bfloat16, as the reference
sets it), through ``Trainer._train_feed``. Each line is one JSON object:

* ``compute``: the step with its batch resident on the device, each step
  read back (``median_synced_ms``), and a chain of steps closed by one
  synchronize (``async_chain_ms``);
* ``h2d``: one batch copied host to device and waited for, from pageable
  and (on the card) from page-locked memory: median, min, max of 6, MB/s;
* ``staged_pass``: ``StagedReader`` (depth 8) feeding the steps, each
  batch's stages on the staging thread (``assembly``: the reader's pull;
  ``arena``: the copy into the arena block; ``h2d``: the copy's dispatch
  on the reader's stream; ``completion``: the wait for its event) and the
  consumer's step, medians and spreads (the first step dropped);
* ``in_window_h2d``: one copy right after the pass;
* ``wire``: the same batches as uint8 images and int32 labels through
  the packed single-copy path against float32 through the per-array
  path, from the staging counters: MB and copies a batch.

The CIFAR net takes 1000 classes: the reference's CPU configuration
feeds the labels it draws (0..999) to a 10-class head, whose loss is NaN
there (an out-of-range gather fills), where the port's gather refuses
them. The last lines are each step's loss and the kernels' launches.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import config, core, layers, optimizer
from ..models import resnet
from ..reader import staging
from ..reader.staging import StagedReader
from ..trainer import Trainer
from .common import launch_counts, launches_since, probe_device, sync

CARD = dict(depth=50, res=224, batch=8, steps=12)
CPU = dict(depth=20, res=32, batch=4, steps=4)
CLASSES, LR, MOMENTUM = 1000, 0.1, 0.9


def sizes(device):
    return dict(CARD if device.type == "cuda" else CPU)


def build(cfg, device):
    """(Trainer, main program, loss) of the probe's ResNet; the flags
    (``amp``, ``fused_conv_bn``) as the caller set them."""
    main, startup = core.Program(), core.Program()
    res = cfg["res"]
    with core.unique_name.guard(), \
            core.program_guard(main, startup):
        img = layers.data("img", shape=[3, res, res])
        label = layers.data("label", shape=[1], dtype="int64")
        if cfg["depth"] == 50:
            loss, _, _ = resnet.resnet_imagenet(img, label, depth=50,
                                                class_dim=CLASSES)
        else:
            loss, _, _ = resnet.resnet_cifar10(img, label, depth=cfg["depth"],
                                               class_dim=CLASSES)
        optimizer.Momentum(learning_rate=LR, momentum=MOMENTUM).minimize(
            loss, startup_program=startup)
    tr = Trainer(loss, main_program=main, startup_program=startup,
                 async_metrics=True, device=device)
    return tr, main, loss


def host_batches(cfg, n=3):
    """The reference's three batches: images N(0, 1), labels in 0..999,
    one ``RandomState(0)`` stream."""
    rs = np.random.RandomState(0)
    b, res = cfg["batch"], cfg["res"]
    return [{"img": rs.randn(b, 3, res, res).astype("float32"),
             "label": rs.randint(0, 1000, (b, 1)).astype("int64")}
            for _ in range(n)]


def _loss(metrics):
    return float(metrics["loss"])


def compute_only(tr, batch, steps, device):
    """The step on a resident batch: one warm step, ``steps`` each read
    back, then ``steps`` closed by one synchronize."""
    feed = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    sync(device)
    losses = [_loss(tr._train_feed(feed))]
    ts = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(_loss(tr._train_feed(feed)))
        ts.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(steps):
        m = tr._train_feed(feed)
    losses.append(_loss(m))
    chain = (time.perf_counter() - t0) / steps * 1e3
    return {"probe": "compute", "median_synced_ms": float(np.median(ts)),
            "async_chain_ms": chain, "steps": steps}, losses


def h2d(batches, device, reps=6):
    """One batch to the device and waited for, from pageable and from
    page-locked host memory."""
    nbytes = sum(v.nbytes for v in batches[0].values())
    pin = device.type == "cuda"
    rows = []
    for mode in ("pageable", "pinned") if pin else ("pageable",):
        times = []
        for rep in range(reps):
            srcs = [torch.from_numpy(v) for v in
                    batches[rep % len(batches)].values()]
            if mode == "pinned":
                srcs = [s.pin_memory() for s in srcs]
            t0 = time.perf_counter()
            for s in srcs:
                s.to(device, non_blocking=mode == "pinned")
            sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        times = np.array(times)
        rows.append({"probe": "h2d", "mode": mode,
                     "median_ms": float(np.median(times)),
                     "min_ms": float(times.min()),
                     "max_ms": float(times.max()),
                     "mb_per_s": nbytes / np.median(times) / 1e3})
    return rows


class Instrumented(StagedReader):
    """A ``StagedReader`` that times its staging thread's stages for
    each batch (see the module's docstring)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.stage = {"stage": [], "h2d": [], "completion": []}
        self._h2d = self._done = 0.0

    def _copy(self, off, nbytes):
        t0 = time.perf_counter()
        out = super()._copy(off, nbytes)
        self._h2d += time.perf_counter() - t0
        return out

    def _wait(self, event):
        t0 = time.perf_counter()
        StagedReader._wait(event)
        self._done += time.perf_counter() - t0

    def _stage_feed(self, feed):
        self._h2d = self._done = 0.0
        t0 = time.perf_counter()
        out = super()._stage_feed(feed)
        self.stage["stage"].append((time.perf_counter() - t0) * 1e3)
        self.stage["h2d"].append(self._h2d * 1e3)
        self.stage["completion"].append(self._done * 1e3)
        return out

    def per_batch(self):
        """{stage: [ms a batch]} of the batches staged."""
        windows = [(t1 - t0) * 1e3 for t0, t1 in self.records]
        st = self.stage
        return {
            "assembly": [w - s for w, s in zip(windows, st["stage"])],
            "arena": [s - h - c for s, h, c in
                      zip(st["stage"], st["h2d"], st["completion"])],
            "h2d": st["h2d"], "completion": st["completion"]}


def _spread(xs):
    xs = np.asarray(xs, dtype=np.float64)
    return {"median": float(np.median(xs)), "min": float(xs.min()),
            "max": float(xs.max())}


def staged_pass(tr, batches, steps, device):
    """``steps`` steps fed by an instrumented ``StagedReader``."""
    def reader():
        for i in range(steps):
            yield dict(batches[i % len(batches)])

    staged = Instrumented(reader, depth=8, device=device)
    step_ms, losses = [], []
    t_pass = prev = time.perf_counter()
    first_wait = None
    for i, feed in enumerate(staged()):
        t_got = time.perf_counter()
        m = tr._train_feed(feed)
        if i == 0:
            first_wait = (t_got - prev) * 1e3
        losses.append(m["loss"])
        step_ms.append((time.perf_counter() - prev) * 1e3)
        prev = time.perf_counter()
    sync(device)
    total = (time.perf_counter() - t_pass) * 1e3
    stages = staged.per_batch()
    staged.close()
    out = {"probe": "staged_pass", "total_ms": total, "steps": steps,
           "first_batch_wait_ms": first_wait,
           "step_ms": _spread(step_ms[1:] or step_ms)}
    out.update({"%s_ms" % k: _spread(v) for k, v in stages.items()})
    return out, [float(x) for x in losses]


def in_window_h2d(batch, device):
    t0 = time.perf_counter()
    for v in batch.values():
        torch.from_numpy(v).to(device)
    sync(device)
    return {"probe": "in_window_h2d", "ms": (time.perf_counter() - t0) * 1e3}


def wire(batches, cfg, device):
    """Bytes and copies a batch of the packed uint8/int32 wire against
    the per-array float32 path, from the staging counters."""
    res, steps = cfg["res"], cfg["steps"]
    wire_batches = [
        {"img": (hb["img"] * 255).clip(0, 255).astype("uint8"),
         "label": hb["label"].astype("int32")} for hb in batches]
    wire_prog = core.Program()
    with core.unique_name.guard(), \
            core.program_guard(wire_prog, core.Program()):
        layers.data("img", shape=[3, res, res], wire_dtype="uint8",
                    scale=1.0 / 255.0)
        layers.data("label", shape=[1], dtype="int64", wire_dtype="int32")

    def counted(bs, pack):
        def rd():
            for i in range(steps):
                yield dict(bs[i % len(bs)])
        prev = config.get_flag("telemetry")
        config.set_flags(telemetry=True)
        c0 = (staging._TRANSFERS.value, staging._WIRE_BYTES.value,
              staging._LEGACY_BYTES.value)
        try:
            sr = StagedReader(rd, depth=4, pack=pack, program=wire_prog,
                              device=device)
            t0 = time.perf_counter()
            for _ in sr():
                pass  # transfer cost only; no consumer step
            ms = (time.perf_counter() - t0) / steps * 1e3
            sr.close()
        finally:
            config.set_flags(telemetry=prev)
        return (staging._TRANSFERS.value - c0[0],
                staging._WIRE_BYTES.value - c0[1],
                staging._LEGACY_BYTES.value - c0[2], ms)

    n_leg, b_leg, _, ms_leg = counted(batches, False)
    n_wire, b_wire, b_as_legacy, ms_wire = counted(wire_batches, True)
    return {"probe": "wire", "batches": steps,
            "legacy_mb_per_batch": b_leg / steps / 1e6,
            "legacy_copies": n_leg, "legacy_ms_per_batch": ms_leg,
            "wire_mb_per_batch": b_wire / steps / 1e6,
            "wire_copies": n_wire, "wire_ms_per_batch": ms_wire,
            "bytes_cut": b_as_legacy / max(b_wire, 1),
            "copies_cut": max(n_leg // max(n_wire, 1), 1)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--amp", default="bfloat16",
                    help="the amp flag: bfloat16 (the reference's) or none")
    ap.add_argument("--fused-conv-bn", action="store_true",
                    help="build with the fused_conv_bn flag (kernel B1 "
                         "at f32)")
    args = ap.parse_args(argv)
    device = probe_device(args.device)
    if device is None:
        return 1
    cfg = sizes(device)
    amp = None if args.amp == "none" else args.amp
    config.set_flags(amp=amp, fused_conv_bn=args.fused_conv_bn)
    try:
        tr, _, _ = build(cfg, device)
        batches = host_batches(cfg)
        tr.startup()
        print(json.dumps(dict(cfg, amp=args.amp,
                              fused_conv_bn=args.fused_conv_bn,
                              batch_mb=sum(v.nbytes for v in
                                           batches[0].values()) / 1e6)),
              flush=True)
        before = launch_counts()
        row, compute_losses = compute_only(tr, batches[0], cfg["steps"],
                                           device)
        print(json.dumps(row), flush=True)
        for row in h2d(batches, device):
            print(json.dumps(row), flush=True)
        row, staged_losses = staged_pass(tr, batches, cfg["steps"], device)
        print(json.dumps(row), flush=True)
        print(json.dumps(in_window_h2d(batches[1], device)), flush=True)
        print(json.dumps(wire(batches, cfg, device)), flush=True)
        losses = compute_losses + staged_losses
        print(json.dumps({"probe": "losses", "compute": compute_losses,
                          "staged": staged_losses,
                          "finite": bool(np.isfinite(losses).all())}),
              flush=True)
        print(json.dumps({"probe": "launches",
                          **launches_since(before)}), flush=True)
    finally:
        config.set_flags(amp=None, fused_conv_bn=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
