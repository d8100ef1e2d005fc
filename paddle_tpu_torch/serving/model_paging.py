"""Weight manifests for ``.npz`` weights artifacts (reference
``paddle_tpu/serving/model_paging.py``, its manifest functions, which
``serving/deploy.py`` re-exports).

:func:`write_weights_manifest` writes the sha256, the byte size and each
variable's shape and dtype beside an artifact; :func:`verify_weights_manifest`
refuses a truncated or switched artifact before any weight touches a
scope. The manifest's JSON is the reference's, so it crosses both ways.
The model catalog and residency set belong to the fleet tier, which is
not ported yet (ROADMAP Queue A, "Fleet tier").
"""

import hashlib
import json
import os

import numpy as np

__all__ = ["write_weights_manifest", "verify_weights_manifest"]


def _sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_weights_manifest(params_path, params=None):
    """Write the page-in manifest beside an ``.npz`` weights artifact:
    per-var shape/dtype plus the artifact's sha256. Returns the manifest
    path."""
    if params is None:
        with np.load(params_path) as data:
            params = {k: np.asarray(v) for k, v in data.items()}
    manifest = {
        "sha256": _sha256(params_path),
        "bytes": os.path.getsize(params_path),
        "vars": {name: {"shape": list(np.shape(v)),
                        "dtype": str(np.asarray(v).dtype)}
                 for name, v in sorted(params.items())},
    }
    path = str(params_path) + ".manifest.json"
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def verify_weights_manifest(params_path):
    """Verify an ``.npz`` artifact against its manifest, if one exists.
    Returns the manifest dict (None when unmanifested — the legacy push
    shape stays loadable); raises ValueError on a digest or size
    mismatch."""
    path = str(params_path) + ".manifest.json"
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    size = os.path.getsize(params_path)
    if int(manifest.get("bytes", -1)) != size:
        raise ValueError(
            "weights artifact %s is %d bytes, manifest says %s"
            % (params_path, size, manifest.get("bytes")))
    if _sha256(params_path) != manifest.get("sha256"):
        raise ValueError(
            "weights artifact %s fails its manifest digest — "
            "truncated or switched push" % (params_path,))
    return manifest
