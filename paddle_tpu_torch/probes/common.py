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
import tempfile
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
    copies of ``csrc/<stem>.cu`` and the headers it includes, with each
    variant's (old, new) text edits applied in turn to the file that
    holds the old text (no edits: the sources as they are), into
    a new directory ``build/probe/<stem>-<variant>-*/`` (a library loaded
    in this process is never written over). Each old text must be
    present. A tuple of entry names gives {variant: (one ctypes function
    each)}."""
    texts = {}
    for path in _build.sources(stem):
        with open(path) as f:
            texts[os.path.basename(path)] = f.read()
    procs = {}
    for name, edits in variants.items():
        edited = dict(texts)
        for old, new in edits:
            holder = next((f for f, t in edited.items() if old in t), None)
            if holder is None:
                raise RuntimeError("variant %s: %r is not in %s.cu or its "
                                   "headers" % (name, old, stem))
            edited[holder] = edited[holder].replace(old, new)
        probe_dir = os.path.join(_build.BUILD, "probe")
        os.makedirs(probe_dir, exist_ok=True)
        out_dir = tempfile.mkdtemp(prefix="%s-%s-" % (stem, name),
                                   dir=probe_dir)
        for fname, text in edited.items():
            with open(os.path.join(out_dir, fname), "w") as f:
                f.write(text)
        procs[name] = _nvcc(os.path.join(out_dir, stem + ".cu"),
                            os.path.join(out_dir, "lib%s.so" % stem))
    names = (entry,) if isinstance(entry, str) else entry
    argtypes = {e: _build.ENTRY_POINTS[e][1] for e in names}
    return {name: _bind(lib, proc, entry, argtypes)
            for name, (lib, proc) in procs.items()}


def build_baseline(path, entries):
    """The C entries ``entries`` ({name: argtypes}) of the source file at
    ``path`` (an earlier version of a kernel, with its own signatures),
    built by nvcc into a new directory ``build/probe/baseline-*/``:
    {name: ctypes function}."""
    base = os.path.splitext(os.path.basename(path))[0]
    probe_dir = os.path.join(_build.BUILD, "probe")
    os.makedirs(probe_dir, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="baseline-", dir=probe_dir)
    lib, proc = _nvcc(path, os.path.join(out_dir, "lib%s.so" % base))
    return dict(zip(entries, _bind(lib, proc, tuple(entries), entries)))


def _nvcc(src, lib):
    """(lib, the nvcc process building ``src`` into it)."""
    return lib, subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", lib,
         src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _bind(lib, proc, entry, argtypes):
    """Wait for ``proc`` and bind ``entry`` (a name or a tuple of names)
    of ``lib`` with its argtypes from ``argtypes`` ({name: argtypes})."""
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError("nvcc failed for %s:\n%s" % (lib, log))
    handles = []
    for e in (entry,) if isinstance(entry, str) else entry:
        fn = getattr(ctypes.CDLL(lib), e)
        fn.argtypes = list(argtypes[e])
        fn.restype = ctypes.c_int
        handles.append(fn)
    return handles[0] if isinstance(entry, str) else tuple(handles)


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
