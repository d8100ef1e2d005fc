"""Single-file inference model bundles (reference
``paddle_tpu/utils/merge_model.py``: merge config + params into one file
so the C API and mobile deployments ship a single artifact).

A merged model is a plain zip of the inference dir's members
(``__model__`` JSON, ``params.npz``, ``params.meta.json``, plus
``quant.json`` for int8 exports, the sha256 ``manifest.json``, and any
``compiled/`` members) in the reference's layout, so a bundle written by
either package unpacks in the other. The data members are pickle-free;
``compiled/`` members are the exported bucket programs a ServingEngine
primes from (``serving/deploy.py``), or a reference artifact's pickled
executables, which the port never loads (the engine counts a fallback
for each and runs the program).

One difference by design: ``params.npz`` is stored, not deflated. The
npz is itself a zip of raw arrays, and deflate gains a few percent on
float weights at tens of MB/s, minutes for a full-width model; the
other members are deflated as the reference deflates them, and zip
readers take either method.
"""

import os
import shutil
import tempfile
import zipfile

__all__ = ["merge_inference_model", "unpack_merged_model", "MEMBERS",
           "SIDECAR_MEMBERS", "MANIFEST_MEMBER", "COMPILED_DIR"]

# THE artifact layout, defined once (io.py and serving/deploy.py import
# these): core members every export writes, sidecar members the manifest
# digests when present, the manifest itself, and the dir of AOT-compiled
# bucket executables.
MEMBERS = ("__model__", "params.npz", "params.meta.json")
SIDECAR_MEMBERS = ("quant.json",)
MANIFEST_MEMBER = "manifest.json"
COMPILED_DIR = "compiled"

_MEMBERS = MEMBERS
_OPTIONAL_MEMBERS = SIDECAR_MEMBERS + (MANIFEST_MEMBER,)
_COMPILED_PREFIX = COMPILED_DIR + "/"
# members written without deflate (see the module docstring)
_STORED = frozenset({"params.npz"})
# bytes a copy step moves in and out of a member (zipfile's own steps
# are 8 KiB: a full-width model's params.npz takes ~370k of them)
_CHUNK = 1 << 24


def _safe_compiled_member(name):
    """True for a flat ``compiled/<file>`` member (zip-slip safe: no
    nesting, no traversal, no absolute paths)."""
    if not name.startswith(_COMPILED_PREFIX):
        return False
    base = name[len(_COMPILED_PREFIX):]
    return bool(base) and "/" not in base and "\\" not in base \
        and base not in (".", "..") and not base.startswith("..")


def _write(z, path, name):
    info = zipfile.ZipInfo.from_file(path, name)
    info.compress_type = zipfile.ZIP_STORED if name in _STORED \
        else zipfile.ZIP_DEFLATED
    with open(path, "rb") as src, \
            z.open(info, "w", force_zip64=True) as dst:
        shutil.copyfileobj(src, dst, _CHUNK)


def _extract(z, name, out):
    """Extract member ``name`` (one of the pinned, flat names) under
    ``out``."""
    path = os.path.join(out, *name.split("/"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with z.open(name) as src, open(path, "wb") as dst:
        shutil.copyfileobj(src, dst, _CHUNK)


def merge_inference_model(dirname, out_file):
    """Bundle a save_inference_model dir into ONE file."""
    # validate BEFORE creating the zip: a failed merge must not leave a
    # truncated artifact at out_file (or destroy a good one)
    for m in _MEMBERS:
        if not os.path.exists(os.path.join(dirname, m)):
            raise FileNotFoundError(
                "%r is not an inference model dir (missing %s)"
                % (dirname, m))
    with zipfile.ZipFile(out_file, "w", zipfile.ZIP_DEFLATED) as z:
        for m in _MEMBERS:
            _write(z, os.path.join(dirname, m), m)
        for m in _OPTIONAL_MEMBERS:
            if os.path.exists(os.path.join(dirname, m)):
                _write(z, os.path.join(dirname, m), m)
        cdir = os.path.join(dirname, COMPILED_DIR)
        if os.path.isdir(cdir):
            for f in sorted(os.listdir(cdir)):
                path = os.path.join(cdir, f)
                if os.path.isfile(path):
                    _write(z, path, _COMPILED_PREFIX + f)
    return out_file


def unpack_merged_model(path):
    """Extract a merged model file to a temp dir; returns the dir.
    Zip-slip safe: member names are pinned to the known set."""
    out = tempfile.mkdtemp(prefix="ptpu_model_")
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        missing = [m for m in _MEMBERS if m not in names]
        if missing:
            raise ValueError("merged model %r missing members: %s"
                             % (path, missing))
        for m in _MEMBERS:
            _extract(z, m, out)
        for m in _OPTIONAL_MEMBERS:
            if m in names:
                _extract(z, m, out)
        for m in sorted(names):
            if _safe_compiled_member(m):
                _extract(z, m, out)
    return out
