"""Deploys: AOT-exported serving artifacts, the weight-swap error and the
``paddle_deploy_*`` counters (reference ``paddle_tpu/serving/deploy.py``).

* :func:`export_compiled_buckets`, called by
  ``io.save_inference_model(..., export_compiled=True)``: exports each
  serving bucket's step of the just-written artifact
  (``Executor.lower``: a ``torch.export`` program with the state as
  inputs, so it survives a weight swap) and embeds it under
  ``compiled/``: one ``bucket_<b>.bin`` a bucket and an ``index.json``
  with each blob's sha256, the environment fingerprint (``env``, whose
  ``runtime`` is ``"torch"``), the exporting device's index, and the
  executor cache digest that proves the program IS the step a loading
  engine would build. A ServingEngine's warmup primes each replica from
  it (``engine.py`` ``_prime_bucket``); any skew (torch version, card,
  kernel sources, flags, a corrupt blob) degrades to running the
  program, counted, never an error. A reference artifact's blobs are
  pickled XLA executables: the port never loads one (its index names
  another runtime), and counts the fallback.
* :class:`SwapRejectedError` and the swap and rollback counters back
  ``ServingEngine.swap_weights`` (``engine.py``): a push is digest
  verified, signature checked and canary executed before the flip, and a
  failure burst after the flip rolls it back.
* :func:`synth_bucket_feed` is the one zero-feed synthesis of a bucket,
  shared by the engine's warmup and the export, so the feed signature,
  and therefore the recorded digest, cannot drift between the two.
* :func:`load_compiled_index` and :func:`read_compiled_blob` read an
  artifact's ``compiled/index.json`` and a blob's bytes, digest-verified.
* :func:`write_weights_manifest` / :func:`verify_weights_manifest`,
  re-exported from ``serving/model_paging.py``.

Fault sites (``resilience/faults.py``): ``swap_bad_artifact`` (fires in
swap validation) and ``swap_canary_fail`` (fires before the canary run);
with ``cache_corrupt`` (``core/compile_cache.py``) they make the deploy
layer chaos-testable.
"""

import json
import os

import numpy as np

from .. import config as _config
from ..core import compile_cache as _cc
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


def export_compiled_buckets(dirname, scope, buckets=None, place=None,
                            quant_compute=None):
    """Export every serving bucket's step of the artifact at ``dirname``
    and embed the serialized programs under ``compiled/``.

    The program is re-read from the exported ``__model__`` (not the
    in-memory pruned program), so the digest recorded per bucket is
    computed over the same deserialized program a loading engine holds.
    ``scope`` provides the state's shapes and dtypes; the programs take
    the weights as inputs. An int8 artifact under ``quant_compute``
    (default: the ``serving_quant_compute`` flag, which an engine reads
    at construction) is exported as such an engine serves it: loaded
    with its weights kept int8 and its program armed. ``place`` is the
    exporting device (CUDA by default; ``"cpu"``).

    Returns the list of buckets exported (a bucket whose step cannot be
    exported is skipped and logged ``aot_export_skipped``)."""
    from .. import io as _io
    from ..core.executor import Executor
    from ..core.scope import Scope
    from ..core.serialization import program_from_dict
    from . import quant as _quant
    if buckets is None:
        buckets = _config.get_flag("serving_buckets")
    if quant_compute is None:
        quant_compute = bool(_config.get_flag("serving_quant_compute"))
    buckets = tuple(sorted({int(b) for b in buckets}))
    with open(os.path.join(dirname, "__model__")) as f:
        bundle = json.load(f)
    program = program_from_dict(bundle["program"])
    feed_names = bundle["spec"]["feed_names"]
    fetch_names = bundle["spec"]["fetch_names"]
    exe = Executor(place=place)
    if quant_compute and _quant.load_quant_meta(dirname) is not None:
        scope = Scope()
        program, _, _ = _io.load_inference_model(dirname, exe, scope=scope,
                                                 quant_compute=True)
    cdir = os.path.join(dirname, _COMPILED_DIR)
    index = {"env": _cc.env_fingerprint(exe.device),
             "device_id": exe.device.index or 0,
             "feed_names": list(feed_names),
             "fetch_names": list(fetch_names),
             "buckets": {}}
    exported = []
    for b, feed in _bucket_feeds(program.global_block(), feed_names,
                                 buckets):
        try:
            blob = _cc.serialize_compiled(exe.lower(
                program, feed=feed, fetch_list=fetch_names, scope=scope))
        except Exception as e:
            _log.structured("aot_export_skipped", bucket=b, error=repr(e))
            continue
        digest = exe.cache_digest(program, feed=feed,
                                  fetch_list=fetch_names, scope=scope)
        os.makedirs(cdir, exist_ok=True)
        fname = "bucket_%d.bin" % b
        with open(os.path.join(cdir, fname), "wb") as f:
            f.write(blob)
        index["buckets"][str(b)] = {
            "file": fname,
            "sha256": _cc.sha256_bytes(blob),
            "digest": digest,
            "nbytes": len(blob),
        }
        exported.append(b)
    if exported:
        with open(os.path.join(cdir, _INDEX_FILE), "w") as f:
            json.dump(index, f)
        _log.structured("aot_export", dir=dirname, buckets=exported)
    return exported


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
    raises ValueError on a mismatch (callers run the program)."""
    fname = os.path.basename(str(entry.get("file", "")))
    path = os.path.join(model_dir, _COMPILED_DIR, fname)
    with open(path, "rb") as f:
        blob = f.read()
    if _cc.sha256_bytes(blob) != entry.get("sha256"):
        raise ValueError("AOT blob %s failed digest verification"
                         % fname)
    return blob
