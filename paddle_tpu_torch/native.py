"""Loader of the port's native libraries, built with ``g++`` at first use
into the git-ignored ``build/`` beside the CUDA kernels and loaded with
``ctypes``; a library newer than its source is reused:

* the C inference API (``csrc/capi.cc``), against this interpreter's
  headers and libpython;
* the RecordIO reader and writer (``native/recordio.cc``) and the
  shuffling sample pool (``native/shuffle_pool.cc``), the reference's
  sources compiled unchanged (its ``native/Makefile`` flags), so a file
  either package writes reads back through the other."""

import ctypes
import os
import shutil
import subprocess
import sysconfig
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "capi.cc")
LIBRARY = os.path.join(_PKG, "build", "libptc_capi.so")
_NATIVE = os.path.join(os.path.dirname(_PKG), "native")

_lock = threading.Lock()
_lib = [None]
_libs = {}

__all__ = ["build_capi", "capi_lib", "PtcTensor", "build_native_lib",
           "recordio_lib", "shuffle_pool_lib"]


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


def _compile(src, lib, flags, libs=(), force=False):
    """Compile ``src`` into the shared library ``lib`` with g++ unless a
    library newer than the source is there; returns ``lib``. Raises
    RuntimeError with the compiler's output when the build fails."""
    with _lock:
        if os.path.exists(lib) and not force and \
                os.path.getmtime(lib) >= os.path.getmtime(src):
            return lib
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++) to build %s" % src)
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        tmp = "%s.%d.tmp" % (lib, os.getpid())
        out = subprocess.run(
            [cxx, "-O2", "-std=c++17", "-fPIC", "-Wall", *flags, "-shared",
             "-o", tmp, src, *libs], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError("building %s failed:\n%s%s"
                               % (src, out.stdout, out.stderr))
        os.replace(tmp, lib)
        return lib


def build_capi(force=False):
    """Compile ``csrc/capi.cc`` into ``build/libptc_capi.so`` (see
    :func:`_compile`); returns its path."""
    inc, ld = _python_flags()
    return _compile(SOURCE, LIBRARY, inc, ld, force)


def build_native_lib(stem, force=False):
    """Compile ``native/<stem>.cc`` into ``build/lib<stem>.so`` (see
    :func:`_compile`); returns its path."""
    return _compile(os.path.join(_NATIVE, stem + ".cc"),
                    os.path.join(_PKG, "build", "lib%s.so" % stem), (),
                    force=force)


def _native(stem, sigs):
    """lib<stem> loaded once, each (name, restype, argtypes) of ``sigs``
    set on it."""
    with _lock:
        if stem in _libs:
            return _libs[stem]
    lib = ctypes.CDLL(build_native_lib(stem))
    for name, restype, argtypes in sigs:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    with _lock:
        return _libs.setdefault(stem, lib)


_P, _U32, _S = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p
_I = ctypes.c_int


def recordio_lib():
    """The RecordIO library (``native/recordio.cc``): chunked records,
    each chunk with its length and checksum."""
    return _native("recordio", [
        ("ptrc_writer_open", _P, [_S, _U32]),
        ("ptrc_writer_write", _I, [_P, _S, _U32]),
        ("ptrc_writer_close", _I, [_P]),
        ("ptrc_reader_open", _P, [_S]),
        ("ptrc_reader_num_chunks", _I, [_P]),
        ("ptrc_reader_load_chunk", _I, [_P, _I]),
        ("ptrc_reader_next", _I, [_P, _S, _U32]),
        ("ptrc_reader_peek_len", _I, [_P]),
        ("ptrc_reader_close", None, [_P])])


def shuffle_pool_lib():
    """The shuffling sample pool (``native/shuffle_pool.cc``): records
    pushed by a producer, popped in an order its seed fixes."""
    return _native("shuffle_pool", [
        ("ptpool_create", _P, [_U32, _U32, _U32]),
        ("ptpool_push", _I, [_P, _S, _U32]),
        ("ptpool_pop", _I, [_P, _S, _U32]),
        ("ptpool_close", None, [_P]),
        ("ptpool_size", _I, [_P]),
        ("ptpool_destroy", None, [_P])])


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
