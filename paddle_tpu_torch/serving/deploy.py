"""Deploys: the artifact's ``compiled/`` index, the weight-swap error and
the ``paddle_deploy_*`` counters (reference
``paddle_tpu/serving/deploy.py``, the half that needs no executable).

* :class:`SwapRejectedError` and the swap and rollback counters back
  ``ServingEngine.swap_weights`` (``engine.py``): a push is digest
  verified, signature checked and canary executed before the flip, and a
  failure burst after the flip rolls it back.
* :func:`synth_bucket_feed` is the one zero-feed synthesis of a bucket,
  shared by the engine's warmup and any export.
* :func:`load_compiled_index` and :func:`read_compiled_blob` read a
  reference artifact's ``compiled/index.json`` and a blob's bytes,
  digest-verified, on the host. The blobs are pickled XLA executables:
  nothing in the port deserializes one. The engine counts a
  ``paddle_deploy_aot_fallbacks_total`` for each indexed bucket on each
  replica and runs the program, the reference's own answer to skew.
* :func:`export_compiled_buckets` returns ``[]``, the reference's answer
  for a backend that cannot serialize executables: the artifact ships
  without ``compiled/`` (ROADMAP Queue A, "The compile cache and AOT").
* :func:`write_weights_manifest` / :func:`verify_weights_manifest`,
  re-exported from ``serving/model_paging.py``.

Fault sites (``resilience/faults.py``): ``swap_bad_artifact`` (fires in
swap validation) and ``swap_canary_fail`` (fires before the canary run).
"""

import hashlib
import json
import os

import numpy as np

from ..observability import metrics as _metrics
from ..utils import log as _log
from ..utils.merge_model import COMPILED_DIR as _COMPILED_DIR

from .model_paging import (verify_weights_manifest,
                           write_weights_manifest)

__all__ = ["SwapRejectedError", "export_compiled_buckets",
           "load_compiled_index", "read_compiled_blob",
           "synth_bucket_feed", "write_weights_manifest",
           "verify_weights_manifest"]

AOT_LOADS = _metrics.REGISTRY.counter(
    "paddle_deploy_aot_loads_total",
    "Serving buckets primed by deserializing an exported AOT "
    "executable (no XLA compile)")
AOT_FALLBACKS = _metrics.REGISTRY.counter(
    "paddle_deploy_aot_fallbacks_total",
    "Serving buckets that had an exported AOT executable but degraded "
    "to the compile path (digest/env/device skew or corrupt blob)")
SWAP_TOTAL = _metrics.REGISTRY.counter(
    "paddle_deploy_swap_total",
    "ServingEngine.swap_weights attempts")
SWAP_ROLLED_BACK = _metrics.REGISTRY.counter(
    "paddle_deploy_swap_rolled_back_total",
    "Weight pushes that did not land: rejected by validation/canary "
    "before the flip, or auto-rolled back by the post-swap failure "
    "watch")
COLD_START_SECONDS = _metrics.REGISTRY.gauge(
    "paddle_deploy_cold_start_seconds",
    "ServingEngine construction + warmup wall time (most recent "
    "engine)")
SWAP_BLACKOUT_SECONDS = _metrics.REGISTRY.histogram(
    "paddle_deploy_swap_blackout_seconds",
    "Longest single-replica flip-lock hold per swap/rollback (the "
    "serving blackout a weight flip costs one replica)")

_INDEX_FILE = "index.json"


class SwapRejectedError(RuntimeError):
    """A weight push was refused (artifact/signature/canary failure) or
    auto-rolled back — the engine is still serving the prior weights."""


def synth_bucket_feed(feature_specs, bucket):
    """Zero feed for one bucket from ``{name: (feature_dims, dtype)}``;
    None when any feature dim is dynamic."""
    feed = {}
    for name, (dims, dtype) in feature_specs.items():
        if any(d < 0 for d in dims):
            return None
        feed[name] = np.zeros((bucket,) + tuple(dims), dtype)
    return feed


def _bucket_feeds(block, feed_names, buckets):
    """(bucket, feed) per synthesizable bucket of an exported program,
    via :func:`synth_bucket_feed`. Skips buckets any dynamic non-batch
    dim makes unsynthesizable; yields nothing when a feed var is missing
    from the block."""
    specs = {}
    for name in feed_names:
        var = block.var_or_none(name)
        if var is None:
            return
        specs[name] = (tuple(var.shape or ())[1:], np.dtype(var.dtype))
    for b in buckets:
        feed = synth_bucket_feed(specs, b)
        if feed is not None:
            yield b, feed


def export_compiled_buckets(dirname, scope, buckets=None, place=None):
    """The buckets whose executables were embedded under ``compiled/``:
    none, as the reference answers on a backend that cannot serialize
    executables (the artifact ships plain and engines run the program)."""
    _log.structured("aot_export_skipped", dir=dirname,
                    error="no serializable executables in this backend")
    return []


def load_compiled_index(model_dir):
    """The ``compiled/index.json`` dict of an artifact dir, or None
    (plain artifact, a merged file not unpacked, torn index). Never
    raises."""
    if not os.path.isdir(model_dir):
        return None
    path = os.path.join(model_dir, _COMPILED_DIR, _INDEX_FILE)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def read_compiled_blob(model_dir, entry):
    """One bucket blob's bytes, digest-verified against its index entry;
    raises ValueError on a mismatch. The bytes are never unpickled."""
    fname = os.path.basename(str(entry.get("file", "")))
    path = os.path.join(model_dir, _COMPILED_DIR, fname)
    with open(path, "rb") as f:
        blob = f.read()
    if hashlib.sha256(blob).hexdigest() != entry.get("sha256"):
        raise ValueError("AOT blob %s failed digest verification"
                         % fname)
    return blob
