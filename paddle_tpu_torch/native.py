"""Loader of the port's C inference API (``csrc/capi.cc``): built with
``g++`` against this interpreter's headers and libpython at first use,
into the git-ignored ``build/`` beside the CUDA kernels, and loaded with
``ctypes``. A library newer than its source is reused."""

import ctypes
import os
import shutil
import subprocess
import sysconfig
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "capi.cc")
LIBRARY = os.path.join(_PKG, "build", "libptc_capi.so")

_lock = threading.Lock()
_lib = [None]

__all__ = ["build_capi", "capi_lib", "PtcTensor"]


def _python_flags():
    """(include flags, link flags) of this interpreter, from
    ``python3-config`` where it answers, else from ``sysconfig``."""
    cfg = shutil.which("python3-config")
    if cfg:
        inc = subprocess.run([cfg, "--includes"], capture_output=True,
                             text=True).stdout.split()
        ld = subprocess.run([cfg, "--embed", "--ldflags"],
                            capture_output=True, text=True).stdout.split()
        if inc:
            return inc, ld
    paths = sysconfig.get_paths()
    inc = ["-I" + paths["include"]]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = sysconfig.get_config_var("LDVERSION") or ""
    return inc, ["-L" + libdir, "-lpython" + ver] if libdir else []


def build_capi(force=False):
    """Compile ``csrc/capi.cc`` into ``build/libptc_capi.so`` unless a
    library newer than the source is there; returns its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    with _lock:
        fresh = os.path.exists(LIBRARY) and \
            os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)
        if fresh and not force:
            return LIBRARY
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++) to build the C API")
        inc, ld = _python_flags()
        os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
        tmp = "%s.%d.tmp" % (LIBRARY, os.getpid())
        out = subprocess.run(
            [cxx, "-O2", "-std=c++17", "-fPIC", "-Wall", *inc, "-shared",
             "-o", tmp, SOURCE, *ld], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError("building the C API failed:\n%s%s"
                               % (out.stdout, out.stderr))
        os.replace(tmp, LIBRARY)
        return LIBRARY


def capi_lib():
    """The C API library, built if needed, with its signatures set. From
    Python it joins the running interpreter; a standalone C program links
    it with libpython and calls ``ptc_init(repo_path)``."""
    if _lib[0] is not None:
        return _lib[0]
    lib = ctypes.CDLL(build_capi())
    lib.ptc_init.restype = ctypes.c_int
    lib.ptc_init.argtypes = [ctypes.c_char_p]
    lib.ptc_model_load.restype = ctypes.c_void_p
    lib.ptc_model_load.argtypes = [ctypes.c_char_p]
    lib.ptc_model_forward.restype = ctypes.c_int
    lib.ptc_model_num_outputs.restype = ctypes.c_int
    lib.ptc_model_num_outputs.argtypes = [ctypes.c_void_p]
    lib.ptc_model_output_name.restype = ctypes.c_char_p
    lib.ptc_model_output_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ptc_model_output_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.ptc_model_output_data.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int64)]
    lib.ptc_model_output_ndim.restype = ctypes.c_int
    lib.ptc_model_output_ndim.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ptc_model_output_dim.restype = ctypes.c_int64
    lib.ptc_model_output_dim.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int]
    lib.ptc_model_release.argtypes = [ctypes.c_void_p]
    _lib[0] = lib
    return lib


class PtcTensor(ctypes.Structure):
    """Mirror of capi.cc's ptc_tensor."""
    _fields_ = [("name", ctypes.c_char_p),
                ("data", ctypes.c_void_p),
                ("shape", ctypes.POINTER(ctypes.c_int64)),
                ("ndim", ctypes.c_int),
                ("dtype", ctypes.c_int)]
