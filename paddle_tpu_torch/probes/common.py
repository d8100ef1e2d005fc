"""What the probes and ``chip_smoke.py`` share: the one clock of a
kernel's time (CUDA events over calls queued behind a sleep kernel, on
warm buffers or taken in turn over copies that keep the L2 cold), the
profiler's sums printed beside it, the host time of a call, builds of
edited copies of a kernel's source (the probes' design variants and tile
sweeps), the card's data-sheet peaks, a training program's reckoned
work, the card's nvidia-smi line, and the start of a measurement probe
(its ``--device``, its first line, the kernel launches of its run)."""

import ctypes
import functools
import itertools
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..ops import _build

# H100 SXM data sheet: HBM3 bandwidth, f32 outside the tensor cores, and
# dense bf16, int8 and fp8 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
FP8_FLOPS = 1979e12

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


def program_work(main, batch):
    """A training step's reckoned work at ``batch``: (f32 FLOPs, bytes,
    parameters). FLOPs: 3x the forward's convolutions (``conv2d``, and
    the fused ``conv2d_bn``) and fc products (forward, and the two
    gradient products); bytes: each parameter read and written with its
    gradient and velocity (24 B), each convolution, fc and pool output
    written forward and read backward (8 B an element)."""
    block = main.global_block()

    def numel(name):
        shape = block.var(name).shape
        return batch * int(np.prod([d for d in shape if d != -1]))
    flops = acts = 0
    for op in block.ops:
        if op.type in ("conv2d", "conv2d_bn"):
            out = op.outputs["Output" if op.type == "conv2d" else "Y"][0]
            w = block.var(op.inputs["Filter"][0]).shape
            flops += 2 * numel(out) * int(np.prod(w[1:]))
            acts += numel(out)
        elif op.type == "mul":
            k = block.var(op.inputs["Y"][0]).shape[0]
            flops += 2 * numel(op.outputs["Out"][0]) * k
            acts += numel(op.outputs["Out"][0])
        elif op.type == "pool2d":
            acts += numel(op.outputs["Out"][0])
    params = sum(int(np.prod(p.shape)) for p in block.all_parameters())
    return 3 * flops, 24 * params + 8 * acts, params


@functools.lru_cache(maxsize=1)
def card_line():
    """The card's name and power limit, as nvidia-smi gives them (read
    once a process)."""
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return lines[0] if lines else "nvidia-smi: no output"


def probe_device(name):
    """The device a measurement probe runs on, from its ``--device``
    (``name``): CUDA unless the caller asked for the CPU. Without CUDA
    and without ``--device cpu`` it prints "no CUDA device" and returns
    None (the probe then exits nonzero: no run falls back to the CPU on
    its own). On the card its first line is the card's nvidia-smi
    line."""
    if torch.device(name).type == "cuda" and not torch.cuda.is_available():
        print("FAIL: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return None
    from ..place import resolve_device
    device = resolve_device(name)
    print("[device] %s" % (card_line() if device.type == "cuda"
                           else "cpu"), flush=True)
    return device


# the kernels of ``ops/launches.py``'s counts, in its order
_KERNELS = ("B2 f32", "B2 bf16", "T2", "B4", "B5", "B3", "B1", "T1")


def launch_counts():
    """{kernel: launches so far} of every hand-written kernel."""
    from ..ops import launches
    return {k: getattr(*pair)
            for k, pair in zip(_KERNELS, launches._counted())}


def launches_since(before):
    """{kernel: launches since ``before`` (a :func:`launch_counts`)}."""
    return {k: n - before[k] for k, n in launch_counts().items()}


def check(cond, msg):
    """A probe's check: raise with ``msg`` (the run exits nonzero)
    unless ``cond``."""
    if not cond:
        raise AssertionError(msg)


def sync(device):
    """Wait for ``device``'s work (a no-op on the CPU): every wall time
    of a probe ends here."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe_ms(fn, device, iters=10, warmup=1):
    """ms a call of ``fn()``: on the card its device time
    (:func:`cuda_ms`), on the CPU the mean wall time of ``iters`` calls
    after ``warmup``."""
    if device.type == "cuda":
        return cuda_ms(fn, iters=iters, warmup=warmup)
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


# the widths of the flagship LM (``bench.py``'s transformer at the
# accelerator's size; ``probes/flash.py``'s step)
FLAGSHIP_LM = dict(vocab_size=32768, d_model=2048, num_heads=16, d_ff=8192,
                   num_layers=12)
# the head dims the attention kernels B2, B4 and B5 are built for
KERNEL_HEAD_DIMS = (64, 128)


# an LM probe's --model: the reference probe's own widths; those widths
# with 64-wide heads (the same d_model in fewer heads), the card's run of
# a probe whose reference heads are narrower than the kernels take; and
# the flagship LM's
LM_MODELS = ("small", "small-h64", "flagship")


def lm_widths(model, vocab, kw, device):
    """(vocab, widths) of an LM probe's ``--model``: ``small`` is the
    reference probe's own (``vocab``, ``kw``), ``small-h64`` those widths
    with heads 64 wide, ``flagship`` the flagship LM's. ValueError for
    ``small`` on the card where its heads are not a width that B2, B4 and
    B5 take (64 and 128 only)."""
    if model == "flagship":
        kw = dict(FLAGSHIP_LM)
        return kw.pop("vocab_size"), kw
    kw = dict(kw)
    if model == "small-h64":
        kw["num_heads"] = max(1, kw["d_model"] // KERNEL_HEAD_DIMS[0])
    elif device.type == "cuda" and \
            kw["d_model"] // kw["num_heads"] not in KERNEL_HEAD_DIMS:
        raise ValueError(
            "--model small has %d-wide heads; the attention kernels take "
            "%s: run --model small-h64 or flagship on the card"
            % (kw["d_model"] // kw["num_heads"],
               " and ".join(map(str, KERNEL_HEAD_DIMS))))
    return vocab, kw


def lm_scope(vocab, kw, max_len, device, generate=False, seed=7,
             residual_eps=None, bos=0, eos=1):
    """(scope, executor, main program, fetch) of the reference probes'
    LM: ``transformer_lm`` over [1, max_len] tokens (``is_test``), or with
    ``generate`` ``transformer_lm_generate`` (beam 1; fetch its ids), its
    startup run on ``device``, then every variable in name order
    overwritten with ``RandomState(seed)`` standard normals in its dtype,
    as the reference probes do. With ``residual_eps`` (the decode-policy
    probe's init) only floating variables are drawn, the layer norms keep
    their initial values, and the residual-writing projections (``.o.w``,
    ``.ffn2.``) are scaled by eps / sqrt(fan_in)."""
    from .. import core, layers
    from ..models.transformer import transformer_lm, transformer_lm_generate
    main, startup = core.Program(), core.Program()
    fetch = None
    with core.unique_name.guard(), core.program_guard(main, startup):
        if generate:
            anchor = layers.data("anchor", shape=[1], dtype="int32")
            fetch, _, _ = transformer_lm_generate(
                anchor, vocab_size=vocab, max_len=max_len, beam_size=1,
                bos_id=bos, eos_id=eos, **kw)
        else:
            toks = layers.data("toks", shape=[1, max_len], dtype="int64",
                               append_batch_size=False)
            lbls = layers.data("lbls", shape=[1, max_len], dtype="int64",
                               append_batch_size=False)
            transformer_lm(toks, lbls, vocab_size=vocab, is_test=True, **kw)
    exe, scope = core.Executor(device=device), core.Scope()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(seed)
    for n in sorted(scope.var_names()):
        cur = scope.find_var(n)
        if residual_eps is not None and (
                not cur.dtype.is_floating_point or
                n.startswith("layer_norm")):
            continue
        w = rs.standard_normal(tuple(cur.shape))
        if residual_eps is not None and (".o.w" in n or ".ffn2." in n):
            fan_in = cur.shape[0] if cur.dim() == 2 else 1
            w = w * (residual_eps / np.sqrt(max(fan_in, 1)))
        scope.set_var(n, torch.from_numpy(w).to(cur.dtype).to(device))
    return scope, exe, main, fetch
