"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into ``build/lib<name>.so`` inside the package, at first use,
then loaded with ``ctypes``. Nothing here includes PyTorch's headers, so a
build takes seconds, not minutes. Sources are compiled in parallel, one
``nvcc`` process each. A library newer than its source is reused.
"""

import ctypes
import os
import shutil
import subprocess
import threading

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
    "decode_attention_f32": ("decode_attention",
                             (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
}

_lock = threading.Lock()
_libs = {}


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


def _stale(stem):
    lib = _lib_path(stem)
    src = os.path.join(CSRC, stem + ".cu")
    return not os.path.exists(lib) or \
        os.path.getmtime(lib) < os.path.getmtime(src)


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


def check(err, name):
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError("%s: CUDA error %d at launch" % (name, err))
