"""Checkpoints and parameters in the reference's on-disk layout
(reference ``paddle_tpu/io.py``).

``paddle_tpu.io.save_params`` writes ``<dir>/params.npz`` (arrays under
keys v0, v1, ...) and ``<dir>/params.meta.json`` ({key: variable
name}); :func:`load_params` reads that layout with numpy alone, and
:func:`params_from_jax` turns the arrays into tensors on a device (the
LM's serving weights) or copies them into a model (a ResNet or a
transformer LM) and its optimizer by name. :func:`scope_from_jax` puts
them into a ``core.Scope``, from which the Executor runs a program.

The program path's save and load are the reference's, in the same
layout, so a checkpoint crosses between the packages in both
directions: ``save_params``/``load_params`` (the reference's form, an
executor first), ``save_persistables``/``load_persistables`` (the whole
training state: parameters, optimizer accumulators, running statistics,
the RNG key) and the crash-safe per-step checkpoints
(``save_checkpoint``: a temp dir, fsync, a sha256 ``manifest.json``, one
atomic rename, the ``checkpoint_crash`` fault point, ``latest.json``
with resume metadata, ``keep_last`` and bounded ``corrupt_*`` pruning;
``load_checkpoint`` loads the newest intact one and quarantines the
corrupt). The RNG key crosses as the reference stores it (uint32 words)
and loads as the port's int64 words; loaded arrays become tensors on the
executor's device; a bfloat16 tensor is saved as float32 (numpy has no
bfloat16).

Inference export is the reference's too, in its layout, so an artifact
crosses both ways: ``prune_program`` slices a program to its fetches,
``save_inference_model`` writes the pruned ``__model__`` JSON, the
parameters, an optional int8 ``quant.json`` (``quantize="int8"``,
``serving/quant.py``) and the sha256 ``manifest.json``;
``load_inference_model`` verifies the manifest (a manifest-less legacy
artifact loads with a one-time warning), loads a directory or a merged
single file (``utils/merge_model.py``), and dequantizes an int8 export
or, with ``quant_compute``, keeps its weights int8 for kernel B3.
``compiled/`` members are digested but never loaded here.
"""

import hashlib
import json
import os
import re
import shutil
import time

import numpy as np
import torch

from .core.framework import Parameter, RNG_STATE_VAR, default_main_program
from .core.scope import Scope, global_scope
from .observability import metrics as _metrics
from .resilience import faults as _faults
from .utils import log as _log
from .models.transformer import check_lm_params, infer_num_layers
from .optimizer import LR_NAME
from .place import resolve_device
# the artifact layout is defined ONCE in utils/merge_model.py
from .utils.merge_model import (COMPILED_DIR as _COMPILED_DIR,
                                MEMBERS as _ARTIFACT_CORE,
                                SIDECAR_MEMBERS as _ARTIFACT_OPTIONAL)

__all__ = ["load_params", "params_from_jax", "scope_from_jax",
           "save_params", "save_persistables", "load_persistables",
           "save_checkpoint", "load_checkpoint", "load_checkpoint_meta",
           "verify_checkpoint", "save_inference_model",
           "load_inference_model", "verify_model_artifact",
           "prune_program", "write_artifact_manifest",
           "artifact_manifest_digest"]

# the reference scope's random-number state (``core/framework.py``
# RNG_STATE_VAR)
RNG_STATE = RNG_STATE_VAR

# Recovery observability (always on: these fire on rare events, never in
# the per-step hot path), under the reference's names and help text.
_CKPT_FALLBACKS = _metrics.REGISTRY.counter(
    "paddle_checkpoint_fallbacks_total",
    "Loads that fell back past a corrupt/missing newest checkpoint to "
    "an older intact one")
_CKPT_QUARANTINED = _metrics.REGISTRY.counter(
    "paddle_checkpoint_quarantined_total",
    "Checkpoint dirs renamed to corrupt_* after failing digest/load "
    "verification")
_CKPT_VERIFY_SECONDS = _metrics.REGISTRY.histogram(
    "paddle_checkpoint_verify_seconds",
    "Wall time of one checkpoint digest verification")

_CKPT_RE = re.compile(r"checkpoint_(\d+)$")
_MANIFEST = "manifest.json"

# one-time legacy warnings, keyed by the caller-visible artifact path
_LEGACY_WARNED = set()


def _read_npz(dirname, filename="params"):
    """{variable name: np.ndarray} of ``<dirname>/<filename>.npz`` and its
    ``.meta.json``."""
    path = os.path.join(dirname, filename)
    with open(os.path.join(dirname, filename + ".meta.json")) as f:
        meta = json.load(f)
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        return {name: data[key] for key, name in meta.items()}


def load_params(*args, **kwargs):
    """Two forms. ``load_params(dirname, filename="params")``: {variable
    name: np.ndarray} from a params checkpoint. The reference's
    ``load_params(executor, dirname, main_program=None,
    filename="params", scope=None)``: the same arrays loaded into
    ``scope`` (the global scope by default); returns their names."""
    if args and isinstance(args[0], (str, os.PathLike)):
        return _read_npz(*args, **kwargs)
    return _load_into(*args, **kwargs)


def _select_vars(program, predicate):
    return [v for v in program.global_block().vars.values()
            if predicate(v)]


def _host_array(name, val):
    """What the npz stores for one scope value: numpy as it is, a tensor
    on the host (bfloat16 as float32), the RNG key as the reference's
    uint32 words."""
    if isinstance(val, torch.Tensor):
        val = val.detach()
        if val.dtype == torch.bfloat16:
            val = val.float()
        val = val.cpu().numpy()
    arr = np.asarray(val)
    if name == RNG_STATE_VAR:
        arr = arr.astype(np.uint32)
    return arr


def _scope_value(name, arr, device):
    """A loaded array as the scope holds it: a tensor on ``device`` (the
    executor's; the CPU without one), the RNG key as the port's int64
    words."""
    arr = np.asarray(arr)
    if name == RNG_STATE_VAR:
        arr = arr.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _writer(executor):
    """Whether this process writes what a save writes: under a strategy
    only the mesh's first rank does (the others wait for it)."""
    st = getattr(executor, "strategy", None)
    return st is None or st.mesh.rank == st.mesh.first_rank()


def _wait_for_writer(executor):
    st = getattr(executor, "strategy", None)
    if st is not None and st.mesh.mesh_group is not None:
        torch.distributed.barrier(group=st.mesh.mesh_group)


def _save(var_names, dirname, filename, scope, executor=None,
          program=None):
    """Write ``var_names`` of ``scope`` as one npz; under a strategy each
    state's global value (gathered: every rank calls it), written by the
    mesh's first rank."""
    values = executor.global_state(scope, var_names, program) \
        if getattr(executor, "strategy", None) is not None else None
    if not _writer(executor):
        return
    os.makedirs(dirname, exist_ok=True)
    arrays, meta = {}, {}
    for name in var_names:
        val = scope.find_var(name) if values is None else values.get(name)
        if val is None:
            continue
        key = "v%d" % len(arrays)
        arrays[key] = _host_array(name, val)
        meta[key] = name
    path = os.path.join(dirname, filename)
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)
    with open(os.path.join(dirname, filename + ".meta.json"), "w") as f:
        json.dump(meta, f)


def _load(executor, dirname, filename, scope):
    device = getattr(executor, "device", None) or "cpu"
    loaded = []
    for name, arr in _read_npz(dirname, filename).items():
        scope.set_var(name, _scope_value(name, arr, device))
        loaded.append(name)
    return loaded


def _load_into(executor, dirname, main_program=None, filename="params",
               scope=None):
    return _load(executor, dirname, filename, scope or global_scope())


def save_params(executor, dirname, main_program=None, filename="params",
                scope=None):
    """Save trainable parameters only (reference save_params)."""
    program = main_program or default_main_program()
    names = [v.name for v in _select_vars(
        program, lambda v: isinstance(v, Parameter))]
    _save(names, dirname, filename, scope or global_scope(), executor,
          program)


def save_persistables(executor, dirname, main_program=None,
                      filename="persistables", scope=None):
    """Save ALL persistable vars — params, optimizer accumulators, BN
    running stats, RNG state (reference save_persistables: full training
    state for exact resume)."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    names = [v.name for v in _select_vars(program,
                                          lambda v: v.persistable)]
    if scope.has_var(RNG_STATE_VAR):
        names.append(RNG_STATE_VAR)
    _save(names, dirname, filename, scope, executor, program)


def load_persistables(executor, dirname, main_program=None,
                      filename="persistables", scope=None):
    return _load(executor, dirname, filename, scope or global_scope())


def params_from_jax(named, device=None, model=None, optimizer=None):
    """{reference name: array} -> {name: tensor} on ``device`` (default
    CUDA).

    Without ``model``: the transformer LM. Every name of the LM whose
    layer count the names imply must be present, and no other: a missing
    or unknown name raises ValueError. An armed reference scope is
    accepted as it is: the int8 form of a mul weight with its scales
    under ``<name>@quant.scale`` (``models.transformer.check_lm_params``).

    With ``model`` (a ``models.resnet.ResNet`` or a
    ``models.transformer.TransformerLM``): the reference scope's
    parameters (and a ResNet's running statistics) are copied into the
    model by name (``model.reference_tensors()``), and with ``optimizer``
    its accumulators (``optimizer.accumulators()``: Momentum's
    ``<param>_velocity_acc_0``, Adam's moments and beta powers) and
    ``learning_rate_0`` into the optimizer. The names must be exactly
    those, with the model's shapes: a missing or unknown name, or another
    shape, raises ValueError before anything is copied. The tensors go to
    the model's device; ``device`` must then be left out.

    Either way a scope's ``@RNG_STATE@`` is dropped: a whole reference
    scope after ``startup`` loads as it is."""
    named = {n: v for n, v in named.items() if n != RNG_STATE}
    if model is None:
        check_lm_params(named, infer_num_layers(named))
        device = resolve_device(device)
        return {name: torch.as_tensor(np.asarray(val)).to(device)
                for name, val in named.items()}
    if device is not None:
        raise ValueError("device is the model's own (%s): leave it out with "
                         "model" % model.device)
    targets = dict(model.reference_tensors())
    if optimizer is not None:
        targets.update(optimizer.accumulators())
    lr = {LR_NAME} if optimizer is not None else set()
    missing = sorted(set(targets) - set(named))
    unknown = sorted(set(named) - set(targets) - lr)
    if missing or unknown:
        raise ValueError("names do not match the model%s: missing %s, "
                         "unknown %s" % (" and optimizer" if optimizer
                                         else "", missing, unknown))
    src = {name: torch.as_tensor(np.asarray(val))
           for name, val in named.items()}
    for name, t in src.items():
        if name not in lr and tuple(t.shape) != tuple(targets[name].shape):
            raise ValueError("%s: shape %s, expected %s" % (
                name, tuple(t.shape), tuple(targets[name].shape)))
    out = {}
    with torch.no_grad():
        for name, t in src.items():
            if name in lr:
                optimizer.learning_rate = float(t.reshape(-1)[0])
                out[name] = t.to(model.device)
                continue
            targets[name].copy_(t)
            out[name] = targets[name]
    return out


def scope_from_jax(named, device=None):
    """{reference scope name: array} -> a new ``core.Scope`` holding a
    copy of each as a tensor on ``device`` (default CUDA), under its own
    name and dtype (the executor updates state in place; the caller's
    arrays stay as they are): int8 weights with their ``@quant.scale``
    sidecars stay as they are, and only ``@RNG_STATE@`` is dropped, as
    :func:`params_from_jax` drops it (the port's executor seeds its own
    key from the program's ``random_seed``)."""
    device = resolve_device(device)
    scope = Scope()
    for name, val in named.items():
        if name != RNG_STATE:
            scope.set_var(name, torch.tensor(np.asarray(val), device=device))
    return scope


def _sha256_file(path, bufsize=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(bufsize)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _fsync_path(path):
    """Best-effort fsync of a file's pages or a directory's entries
    (a rename is only power-loss durable once its parent dir inode is
    synced; some filesystems refuse dir fsync, hence best-effort)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_json_atomic(path, obj):
    """tmp + os.replace (+ parent-dir fsync): readers never see a
    torn/truncated JSON, and the replace survives power loss."""
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_path(os.path.dirname(path) or ".")


def save_checkpoint(executor, dirname, step, main_program=None, scope=None,
                    keep_last=3, extra_meta=None):
    """Crash-safe per-step checkpoint dirs with resume meta (legacy
    per-pass dirs + Go pserver checkpoint meta, SURVEY §5.3/§5.4).

    The checkpoint is written into a temp dir and published with one
    atomic rename, so a process killed at ANY point during the save
    never leaves a half-written ``checkpoint_<step>`` for
    ``load_checkpoint`` to trip over. A ``manifest.json`` inside the
    dir records the per-file sha256 digests that ``load_checkpoint``
    verifies before trusting the state. ``extra_meta`` (e.g. preemption
    resume info) is merged into ``latest.json``, itself replaced
    atomically. Under a strategy every rank of the mesh calls it: the
    state is gathered to its global values and the mesh's first rank
    writes, the others returning once it has published."""
    if not _writer(executor):
        # under a strategy: gather with the writer, then wait for it
        save_persistables(executor, dirname, main_program, scope=scope)
        _wait_for_writer(executor)
        return
    os.makedirs(dirname, exist_ok=True)
    cdir = os.path.join(dirname, "checkpoint_%d" % step)
    # sweep stale temp dirs from past crashed/killed writers, whatever
    # their pid (concurrent savers into one dir are unsupported anyway
    # — they'd already race latest.json): each one is a full-size copy
    # of the model state and would otherwise leak disk forever
    for d in os.listdir(dirname):
        if d.startswith("_tmp_checkpoint_"):
            shutil.rmtree(os.path.join(dirname, d), ignore_errors=True)
    tmp = os.path.join(dirname, "_tmp_checkpoint_%d.%d"
                       % (step, os.getpid()))
    try:
        save_persistables(executor, tmp, main_program, scope=scope)
        for fn in os.listdir(tmp):
            # flush the data pages too — without this the rename below
            # is durable but the npz it publishes may not be
            _fsync_path(os.path.join(tmp, fn))
        digests = {fn: _sha256_file(os.path.join(tmp, fn))
                   for fn in sorted(os.listdir(tmp))}
        _write_json_atomic(os.path.join(tmp, _MANIFEST),
                           {"step": step, "digests": digests})
        # chaos hook: everything written, nothing published — the
        # window a preempted/killed writer most often dies in
        _faults.fire_point("checkpoint_crash", step)
        if os.path.isdir(cdir):  # re-checkpoint of the same step
            shutil.rmtree(cdir, ignore_errors=True)
        os.rename(tmp, cdir)  # the publish point (atomic within a fs)
        _fsync_path(dirname)  # make the publish power-loss durable
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    meta = {"step": step, "dir": cdir}
    meta.update(extra_meta or {})
    _write_json_atomic(os.path.join(dirname, "latest.json"), meta)
    # prune old (skip foreign dirs that don't match checkpoint_<int>;
    # keep_last<=0 means keep everything)
    if keep_last > 0:
        kept = sorted([d for d in os.listdir(dirname)
                       if _CKPT_RE.fullmatch(d)],
                      key=lambda d: int(d.split("_")[1]))
        for d in kept[:-keep_last]:
            shutil.rmtree(os.path.join(dirname, d), ignore_errors=True)
        # quarantined dirs are evidence, but bounded evidence: each is
        # a full-size copy of the model state, so keep only the newest
        # few or a flaky disk fills the checkpoint volume
        corrupt = sorted(
            (d for d in os.listdir(dirname) if d.startswith("corrupt_")),
            key=lambda d: os.path.getmtime(os.path.join(dirname, d)))
        for d in corrupt[:-2]:
            shutil.rmtree(os.path.join(dirname, d), ignore_errors=True)
    _wait_for_writer(executor)


def verify_checkpoint(cdir):
    """Digest-verify one checkpoint dir. Returns (ok, reason)."""
    t0 = time.perf_counter()
    try:
        mpath = os.path.join(cdir, _MANIFEST)
        if not os.path.isdir(cdir):
            return False, "missing dir"
        if not os.path.exists(mpath):
            # pre-manifest (seed-era) checkpoint: loadable but not
            # verifiable — accept when the data files at least exist
            if os.path.exists(os.path.join(cdir, "persistables.npz")):
                return True, "legacy (no manifest)"
            return False, "no manifest and no persistables"
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except ValueError:
            return False, "unreadable manifest"
        for fn, want in sorted(manifest.get("digests", {}).items()):
            path = os.path.join(cdir, fn)
            if not os.path.exists(path):
                return False, "missing file %s" % fn
            if _sha256_file(path) != want:
                return False, "digest mismatch on %s" % fn
        return True, "ok"
    finally:
        _CKPT_VERIFY_SECONDS.observe(time.perf_counter() - t0)


def _quarantine(cdir, reason):
    """Move a corrupt checkpoint aside (never delete evidence)."""
    base = os.path.dirname(cdir)
    dst = os.path.join(base, "corrupt_" + os.path.basename(cdir))
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = os.path.join(base, "corrupt_%s.%d"
                           % (os.path.basename(cdir), n))
    try:
        os.rename(cdir, dst)
    except OSError:
        return
    _CKPT_QUARANTINED.inc()
    _log.structured("checkpoint_quarantined", dir=cdir, reason=reason,
                    moved_to=dst)


def _checkpoint_candidates(dirname):
    """(step, dir) candidates, newest first. latest.json is a HINT, not
    an override: its target is promoted to the front only when it is at
    least as new as everything the directory scan found — a crash
    between the atomic checkpoint publish and the latest.json rewrite
    leaves latest pointing one step behind, and resuming from it would
    silently discard a fully intact newer checkpoint."""
    steps = {}
    try:
        entries = os.listdir(dirname)
    except OSError:
        return []
    for d in entries:
        m = _CKPT_RE.fullmatch(d)
        if m:
            steps[int(m.group(1))] = os.path.join(dirname, d)
    out = sorted(steps.items(), reverse=True)
    meta = load_checkpoint_meta(dirname)
    if meta and isinstance(meta.get("step"), int) and \
            (not out or meta["step"] >= out[0][0]):
        # prefer the scanned on-disk path for that step: latest.json's
        # stored 'dir' goes stale when the checkpoint tree is moved or
        # was saved under a different cwd — substituting it would
        # discard a perfectly intact newest checkpoint
        pair = (meta["step"],
                steps.get(meta["step"]) or meta.get("dir") or
                os.path.join(dirname, "checkpoint_%d" % meta["step"]))
        out = [pair] + [p for p in out if p[0] != meta["step"]]
    return out


def load_checkpoint_meta(dirname):
    """The latest.json dict (step/dir plus any resume metadata saved by
    a preempted trainer), or None when missing/unreadable."""
    try:
        with open(os.path.join(dirname, "latest.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def load_checkpoint(executor, dirname, main_program=None, scope=None):
    """Load the newest INTACT checkpoint; returns its step (or None).

    Every candidate is digest-verified first (``manifest.json``); a
    corrupt or vanished newest checkpoint — truncated file, pruned dir
    that latest.json still points at, torn write from a pre-atomic
    writer — is quarantined to ``corrupt_*`` and the next older intact
    one is loaded instead. Fallbacks and quarantines are counted in the
    metrics registry (``paddle_checkpoint_*``)."""
    candidates = _checkpoint_candidates(dirname)
    for i, (step, cdir) in enumerate(candidates):
        ok, reason = verify_checkpoint(cdir)
        if ok:
            try:
                load_persistables(executor, cdir, main_program,
                                  scope=scope)
            except Exception as e:  # verified yet unloadable: quarantine
                ok, reason = False, "load failed: %r" % (e,)
            else:
                if i > 0:
                    _CKPT_FALLBACKS.inc()
                    _log.structured(
                        "checkpoint_fallback", loaded=cdir, step=step,
                        skipped=[c for _, c in candidates[:i]])
                return step
        if os.path.isdir(cdir):
            _quarantine(cdir, reason)
        else:
            _log.structured("checkpoint_skipped", dir=cdir,
                            reason=reason)
    return None


def prune_program(program, fetch_names):
    """Backward-slice a program to the ops needed for ``fetch_names``
    (reference ``framework/prune.cc`` + save_inference_model pruning)."""
    from .core.framework import Program, Variable
    from .core.executor import EMPTY_VAR
    block = program.global_block()
    needed = set(fetch_names)
    keep_rev = []
    for op in reversed(block.ops):
        outs = set(op.output_names()) - {EMPTY_VAR}
        if outs & needed:
            keep_rev.append(op)
            needed |= set(n for n in op.input_names() if n != EMPTY_VAR)
    new_prog = Program()
    nb = new_prog.global_block()
    op_map = {}
    for op in reversed(keep_rev):
        for n in op.input_names() + op.output_names():
            if n == EMPTY_VAR or nb.has_var(n):
                continue
            src = block.var_or_none(n)
            if src is None:
                continue
            if isinstance(src, Parameter):
                var = Parameter(nb, name=n, shape=src.shape,
                                dtype=src.dtype, trainable=src.trainable)
            else:
                var = Variable(nb, name=n, shape=src.shape,
                               dtype=src.dtype,
                               persistable=src.persistable,
                               stop_gradient=src.stop_gradient)
            var.is_data = getattr(src, "is_data", False)
            nb.vars[n] = var
        attrs = dict(op.attrs)
        if "fwd_op" in attrs and attrs["fwd_op"] in op_map:
            attrs["fwd_op"] = op_map[attrs["fwd_op"]]
        new_op = type(op)(nb, op.type, op.inputs, op.outputs, attrs)
        op_map[op] = new_op
        nb.ops.append(new_op)
    new_prog._bump_version()
    return new_prog


def _artifact_members(dirname):
    """Relative paths of the artifact files a manifest covers (core +
    optional sidecars + compiled/ members actually present)."""
    members = [m for m in _ARTIFACT_CORE + _ARTIFACT_OPTIONAL
               if os.path.exists(os.path.join(dirname, m))]
    cdir = os.path.join(dirname, _COMPILED_DIR)
    if os.path.isdir(cdir):
        members += sorted(_COMPILED_DIR + "/" + f
                          for f in os.listdir(cdir)
                          if os.path.isfile(os.path.join(cdir, f)))
    return members


def write_artifact_manifest(dirname):
    """(Re)write the artifact's sha256 ``manifest.json`` — call after
    any republish that rewrites members in place (the engine-cache key
    and swap validation both trust the digest)."""
    digests = {m: _sha256_file(os.path.join(dirname, m))
               for m in _artifact_members(dirname)}
    _write_json_atomic(os.path.join(dirname, _MANIFEST),
                       {"kind": "inference_model", "digests": digests})


def artifact_manifest_digest(dirname):
    """sha256 of the manifest file itself — a single content key for
    the whole artifact (params-only or quant-only republishes change
    it). None for legacy manifest-less artifacts."""
    path = os.path.join(dirname, _MANIFEST)
    if not os.path.exists(path):
        return None
    return _sha256_file(path)


def verify_model_artifact(dirname, skip_compiled=True):
    """Digest-verify an inference-model artifact dir. Returns
    (ok, reason). Legacy manifest-less dirs verify as ok ("legacy");
    ``skip_compiled`` leaves ``compiled/`` members to their consumer."""
    if not os.path.isdir(dirname):
        return False, "missing dir"
    mpath = os.path.join(dirname, _MANIFEST)
    if not os.path.exists(mpath):
        if os.path.exists(os.path.join(dirname, "__model__")):
            return True, "legacy (no manifest)"
        return False, "no manifest and no __model__"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return False, "unreadable manifest: %r" % (e,)
    digests = manifest.get("digests", {})
    # a core/sidecar member present on disk but absent from the manifest
    # is as suspect as a digest mismatch: a stray quant.json would
    # otherwise be APPLIED unverified (silently wrong model)
    for fn in _ARTIFACT_CORE + _ARTIFACT_OPTIONAL:
        if fn not in digests and \
                os.path.exists(os.path.join(dirname, fn)):
            return False, "unmanifested file %s" % fn
    for fn, want in sorted(digests.items()):
        if skip_compiled and fn.startswith(_COMPILED_DIR + "/"):
            continue
        path = os.path.join(dirname, fn)
        try:
            digest = _sha256_file(path)
        except OSError as e:
            return False, "unreadable file %s: %r" % (fn, e)
        if digest != want:
            return False, "digest mismatch on %s" % fn
    return True, "ok"


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, scope=None, quantize=None,
                         export_compiled=False, export_buckets=None):
    """Export the program pruned to ``target_vars`` and its parameters
    for inference (reference save_inference_model). ``quantize="int8"``
    rewrites the exported weights to per-output-channel int8
    (``serving/quant.py``). ``export_compiled=True`` embeds each serving
    bucket's exported step under ``compiled/`` (``serving/deploy.py``
    ``export_compiled_buckets``, on the executor's device; the buckets
    are ``export_buckets`` or the ``serving_buckets`` flag), which a
    ServingEngine primes from. Every member is sha256-digested into
    ``manifest.json``."""
    program = main_program or default_main_program()
    program = prune_program(program, [v.name for v in target_vars])
    os.makedirs(dirname, exist_ok=True)
    save_params(executor, dirname, program, scope=scope)
    spec = {
        "feed_names": list(feeded_var_names),
        "fetch_names": [v.name for v in target_vars],
    }
    from .core.serialization import program_to_dict
    with open(os.path.join(dirname, "__model__"), "w") as f:
        json.dump({"program": program_to_dict(program), "spec": spec}, f)
    if quantize:
        from .serving import quant as _quant
        _quant.quantize_model_dir(dirname, program=program, dtype=quantize)
    # a re-export must never inherit a previous export's AOT members:
    # their digests cannot match the new program
    stale = os.path.join(dirname, _COMPILED_DIR)
    if os.path.isdir(stale):
        shutil.rmtree(stale, ignore_errors=True)
    if export_compiled:
        from .serving import deploy as _deploy
        # the export of an int8 artifact loads it, verified
        write_artifact_manifest(dirname)
        _deploy.export_compiled_buckets(
            dirname, scope=scope if scope is not None else global_scope(),
            buckets=export_buckets, place=getattr(executor, "device", None))
    write_artifact_manifest(dirname)


def load_inference_model(dirname, executor, scope=None,
                         quant_compute=False):
    """Returns (program, feed_names, fetch_names); the parameters land in
    ``scope`` (the global scope by default) as tensors on the executor's
    device. ``dirname`` may also be a single merged-model FILE
    (utils/merge_model.py). Artifacts with a ``manifest.json`` are
    digest-verified before the params are trusted (corruption raises
    ValueError); legacy manifest-less artifacts load with a one-time
    warning. ``compiled/`` members are not loaded here (a ServingEngine
    primes from them).

    An int8 export (``quant.json``) is dequantized to float32 here, so
    every loader is quant-agnostic, unless ``quant_compute=True``
    (ServingEngine under the ``serving_quant_compute`` flag): then the
    weights the compute path can serve stay int8 in the scope with their
    scales beside them, no float32 copy is made, and the program is
    tagged so the executor sends their products to kernel B3."""
    orig_path = dirname
    tmp_dir = None
    if os.path.isfile(dirname):
        from .utils.merge_model import unpack_merged_model
        dirname = tmp_dir = unpack_merged_model(dirname)
    try:
        if os.path.exists(os.path.join(dirname, _MANIFEST)):
            ok, reason = verify_model_artifact(dirname, skip_compiled=True)
            if not ok:
                raise ValueError(
                    "inference model artifact %r failed integrity "
                    "verification: %s" % (orig_path, reason))
        elif orig_path not in _LEGACY_WARNED:
            _LEGACY_WARNED.add(orig_path)
            _log.structured("artifact_legacy_no_manifest", dir=orig_path)
            import warnings
            warnings.warn(
                "inference model %r has no manifest.json (pre-integrity "
                "export) — loading unverified; re-export to add digests"
                % (orig_path,), stacklevel=2)
        with open(os.path.join(dirname, "__model__")) as f:
            bundle = json.load(f)
        from .core.serialization import program_from_dict
        program = program_from_dict(bundle["program"])
        load_params(executor, dirname, main_program=program, scope=scope)
        from .serving import quant as _quant
        tgt_scope = scope if scope is not None else global_scope()
        if quant_compute:
            _quant.install_quant_compute(dirname, program, tgt_scope)
        else:
            _quant.maybe_dequantize(dirname, tgt_scope)
    finally:
        if tmp_dir is not None:
            shutil.rmtree(tmp_dir, ignore_errors=True)
    spec = bundle["spec"]
    return program, spec["feed_names"], spec["fetch_names"]
