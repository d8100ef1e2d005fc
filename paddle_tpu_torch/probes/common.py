"""What the probes and ``chip_smoke.py`` share: the one clock of a
kernel's time (CUDA events over calls queued behind a sleep kernel), the
profiler's sums printed beside it, and builds of edited copies of a
kernel's source (the probes' design variants and tile sweeps)."""

import ctypes
import os
import subprocess
import time

import torch

from ..ops import _build

# the shortest sleep that holds back a timed run, in cycles: about 17 ms
# at the H100's boost clock
QUEUE_SLEEP_CYCLES = 2 ** 25
# the longest, about 1 s at the boost clock
QUEUE_SLEEP_MAX_CYCLES = 2 ** 31


def cuda_ms(fn, iters=30, warmup=3):
    """Mean device time per call of ``fn()`` in ms between CUDA events,
    the calls enqueued behind a sleep kernel long enough for the host
    to enqueue them all, so that they run back to back: no host gap
    between launches counts, and every launch does (profiler sums have
    dropped launches). A ``fn`` that waits for the device reads its
    host gaps too."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # twice the host's enqueue time of all the calls at 2 GHz
    cycles = int(2 * iters * host_s * 2e9)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(min(max(cycles, QUEUE_SLEEP_CYCLES),
                          QUEUE_SLEEP_MAX_CYCLES))
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


def build_edited(stem, entry, variants):
    """{variant: ctypes ``entry``} built by nvcc, in parallel, from
    copies of ``csrc/<stem>.cu`` with each variant's (old, new) text
    edits applied in turn (no edits: the source as it is), into
    ``build/probe/``. Each old text must be present."""
    with open(os.path.join(_build.CSRC, stem + ".cu")) as f:
        source = f.read()
    out_dir = os.path.join(_build.BUILD, "probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError("variant %s: %r is not in %s.cu"
                                   % (name, old, stem))
            text = text.replace(old, new)
        src = os.path.join(out_dir, "%s-%s.cu" % (stem, name))
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, "lib%s-%s.so" % (stem, name))
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, log))
        fn = getattr(ctypes.CDLL(lib), entry)
        fn.argtypes = list(_build.ENTRY_POINTS[entry][1])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns
