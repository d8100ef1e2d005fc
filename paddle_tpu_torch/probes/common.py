"""What the probes and ``chip_smoke.py`` share: the one clock of a
kernel's time (CUDA events over calls queued behind a sleep kernel, on
warm buffers or taken in turn over copies that keep the L2 cold), the
profiler's sums printed beside it, the host time of a call, and builds
of edited copies of a kernel's source (the probes' design variants and
tile sweeps)."""

import ctypes
import itertools
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


# the H100's L2 cache, and the bytes a cold timing reads between two
# calls on one buffer: twice the L2, so no byte of a call is still cached
# when its buffers come round again
L2_BYTES = 50 * 2 ** 20
COLD_BYTES = 2 * L2_BYTES


def cold_calls(make, nbytes):
    """Calls for :func:`cuda_ms` that find the L2 cold, as the serving
    path finds it (a decode step reads 73 weights and 12 layers' K/V):
    ``make()`` returns a call over buffers of its own, of which the call
    reads ``nbytes``; made as many times as it takes for the other calls
    to read COLD_BYTES between two turns of one call. Together they hold
    at least COLD_BYTES + ``nbytes`` distinct bytes."""
    return [make() for _ in range(1 + -(-COLD_BYTES // max(int(nbytes), 1)))]


def cuda_ms(fn, iters=30, warmup=3):
    """Mean device time per call of ``fn()`` in ms between CUDA events,
    the calls enqueued behind a sleep kernel long enough for the host
    to enqueue them all, so that they run back to back: no host gap
    between launches counts, and every launch does (profiler sums have
    dropped launches). A ``fn`` that waits for the device reads its
    host gaps too.

    ``fn`` may be a list of calls over distinct buffers
    (:func:`cold_calls`): they are taken in turn, from where the warm-up
    left off, so each timed call reads what the others have pushed out
    of the L2 (the cold clock); one call reads the L2 as its last run
    left it (the warm clock)."""
    calls = list(fn) if isinstance(fn, (list, tuple)) else [fn]
    turn = itertools.count()

    def call():
        calls[next(turn) % len(calls)]()

    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
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
        call()
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
    ``build/probe/``. Each old text must be present. A tuple of entry
    names gives {variant: (one ctypes function each)}."""
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
        handles = []
        for e in (entry,) if isinstance(entry, str) else entry:
            fn = getattr(ctypes.CDLL(lib), e)
            fn.argtypes = list(_build.ENTRY_POINTS[e][1])
            fn.restype = ctypes.c_int
            handles.append(fn)
        fns[name] = handles[0] if isinstance(entry, str) else tuple(handles)
    return fns


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
