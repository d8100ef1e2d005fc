"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into ``build/lib<name>.so`` inside the package, at first use,
then loaded with ``ctypes``. Nothing here includes PyTorch's headers, so a
build takes seconds, not minutes. Sources are compiled in parallel, one
``nvcc`` process each. A library newer than its source and than every
``csrc/*.cuh`` the source includes (``#include "..."``, followed through
the headers) is reused; a header shared by two sources makes both
stale.
"""

import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points: name -> (source stem, argtypes). Pointers and the
# stream are c_void_p, so ctypes never truncates them to 32 bits.
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRY_POINTS = {
    "flash_attention_f32": ("flash_attention",
                            (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "flash_attention_bf16": ("flash_attention",
                             (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _P)),
    "decode_attention_f32": ("decode_attention",
                             (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _P)),
    "decode_attention_bf16": ("decode_attention",
                              (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _P)),
    "decode_attention_paged_f32": ("decode_attention_paged",
                                   (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _P)),
    "decode_attention_paged_bf16": ("decode_attention_paged",
                                    (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _I, _I, _I, _I, _I, _P)),
    "int8_matmul": ("int8_matmul", (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _P)),
    "conv_bn_stats_f32": ("conv_bn_stats",
                          (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _P)),
    "conv1x1_bn_relu_bf16": ("conv1x1_bn_relu",
                             (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _P)),
}

_lock = threading.Lock()
_libs = {}
# per thread: (device index, raw stream) -> the uint8 scratch the
# kernels that thread launches on that stream share
_local = threading.local()


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels cannot be built on this machine")
    return path


def _lib_path(stem):
    return os.path.join(BUILD, "lib%s.so" % stem)


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(stem):
    """The paths of ``csrc/<stem>.cu`` and of every file under ``csrc/``
    it includes with quotes, followed through the headers."""
    todo, seen = [os.path.join(CSRC, stem + ".cu")], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        with open(path) as f:
            for name in _INCLUDE.findall(f.read()):
                dep = os.path.join(os.path.dirname(path), name)
                if os.path.exists(dep):
                    todo.append(dep)
    return seen


def _stale(stem):
    lib = _lib_path(stem)
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    return any(built < os.path.getmtime(src) for src in sources(stem))


def build(stems=None, force=False):
    """Compile the given sources (default: every ``csrc/*.cu``), all at
    once, one ``nvcc`` each. Returns {stem: compiler output} (``-Xptxas
    -v`` prints registers, shared memory and spills per kernel) for the
    sources it compiled. Raises RuntimeError naming the first failure."""
    if stems is None:
        stems = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    todo = [s for s in stems if force or _stale(s)]
    if not todo:
        return {}
    os.makedirs(BUILD, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for stem in todo:
        tmp = "%s.tmp.%d" % (_lib_path(stem), os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, stem + ".cu")]
        procs[stem] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for stem, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[stem] = out
        if proc.returncode != 0:
            failed.append(stem)
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, _lib_path(stem))
    if failed:
        raise RuntimeError("nvcc failed for %s:\n%s"
                           % (failed[0], logs[failed[0]]))
    return logs


def entry(name):
    """The ctypes function ``name`` from its kernel library, building
    the library on first use."""
    with _lock:
        fn = _libs.get(name)
        if fn is None:
            stem, argtypes = ENTRY_POINTS[name]
            build([stem])
            lib = ctypes.CDLL(_lib_path(stem))
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _libs[name] = fn
        return fn


def stream(device):
    """The raw handle of PyTorch's current stream on CUDA ``device``, as
    an int for ctypes. The private accessor (the one Triton's launcher
    uses) skips ``torch.cuda.current_stream(device).cuda_stream``'s
    Stream object, which a launch would otherwise build every time."""
    return torch._C._cuda_getCurrentRawStream(device.index)


@contextlib.contextmanager
def capture_buffers():
    """While a CUDA graph is captured on this thread: the scratch and
    counter buffers its launches take come from a dict of their own,
    which this yields and the graph's holder keeps. A graph bakes in the
    buffers' addresses; the thread's own dict drops a buffer when a larger
    request grows it, which would leave a graph reading freed memory."""
    prev = getattr(_local, "capture", None)
    bufs = _local.capture = {}
    try:
        yield bufs
    finally:
        _local.capture = prev


def _buffers(device, stream):
    """The calling thread's [scratch, counters] for launches on ``stream``
    on ``device`` (None until first asked for); under
    :func:`capture_buffers`, the capture's."""
    bufs = getattr(_local, "capture", None)
    if bufs is None:
        bufs = getattr(_local, "buffers", None)
    if bufs is None:
        bufs = _local.buffers = {}
    key = (device.index, stream)
    pair = bufs.get(key)
    if pair is None:
        pair = bufs[key] = [None, None]
    return pair


def scratch(device, stream, nbytes):
    """A uint8 scratch buffer of at least ``nbytes`` on ``device`` for
    the calling thread's launches on ``stream``, made once and reused:
    one thread's calls are enqueued one after another, so its launches
    on one stream run in the order of its calls, and each kernel writes
    every scratch byte it reads before it reads it. Each thread has its
    own: ctypes lets go of the GIL during a C call, so two threads
    enqueueing on one stream could interleave one call's launches with
    another's, and one call's quantize pass could overwrite the rows
    another call's product has yet to read. It grows to the largest
    request seen."""
    pair = _buffers(device, stream)
    if pair[0] is None or pair[0].numel() < nbytes:
        pair[0] = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              device=device)
    return pair[0]


def counters(device, stream, n):
    """An int32 buffer of at least ``n`` zeros on ``device`` for the
    calling thread's launches on ``stream``, made once and reused, kept
    apart from :func:`scratch`: a kernel that counts in it (B4's last-CTA
    combine) sets every entry it counted back to 0 before it ends, so the
    next launch finds zeros, while other kernels' partials in the scratch
    could never overwrite a count. Per thread, as :func:`scratch`; it
    grows to the largest request seen (a new zeroed buffer)."""
    pair = _buffers(device, stream)
    if pair[1] is None or pair[1].numel() < n:
        pair[1] = torch.zeros(max(n, 1), dtype=torch.int32, device=device)
    return pair[1]


def split_buffers(device, stream, nbytes, n):
    """(:func:`scratch` of ``nbytes``, :func:`counters` of ``n``) in one
    lookup: B4's launch path."""
    pair = _buffers(device, stream)
    if pair[0] is None or pair[0].numel() < nbytes or \
            pair[1] is None or pair[1].numel() < n:
        return scratch(device, stream, nbytes), counters(device, stream, n)
    return pair[0], pair[1]


def check(err, name):
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError("%s: CUDA error %d at launch" % (name, err))
