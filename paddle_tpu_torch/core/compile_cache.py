"""Persistent on-disk compile cache: restart = load, not rebuild
(reference ``paddle_tpu/core/compile_cache.py``).

The executor's in-memory cache entries die with the process. This module
mirrors them onto disk (config flag ``compile_cache_dir``): each entry is
the step's ``torch.export.ExportedProgram`` (``Executor.lower``: the
block's ops over the state, feeds and fetches the run takes, the kernels
as ``paddle_tpu_torch::`` torch ops) serialized through
``torch.export.save``, plus a per-entry JSON manifest carrying its sha256
digest and the environment fingerprint. A program whose step is not
serializable (a training program: ``torch.autograd.grad`` cannot be
exported) stores no entry and runs as before.

**Key stability.** The in-memory key leads with ``program._uid``, a
per-process counter. The persistent key is a sha256 over the *content*:
the program's serialized dict (``core/serialization.py``, byte-identical
to the reference's), the feed signature, fetch names, donation, every
trace-time flag that keys the in-memory cache, the ingest specs, the int8
tag, and the environment fingerprint (torch and CUDA runtime versions,
the device's name, compute capability and count, a sha256 of the kernel
sources ``csrc/*.cu``/``*.cuh``, and the numeric settings that change
results: TF32 and deterministic algorithms). Same source program, shapes,
flags and machine give the same digest; anything else is a clean miss.

**Corruption tolerance**: every load digest-verifies the blob against its
manifest; a truncated, bit-flipped or unloadable entry, or one whose
manifest is itself torn, is quarantined to ``corrupt_*`` and the caller
silently rebuilds. An environment mismatch is a miss, not a quarantine.
The chaos hook ``cache_corrupt`` (``resilience/faults.py``) injects
exactly this failure.

Trust boundary: ``torch.export.load`` reads the program and the tensor
constants the archive holds, so cache dirs and ``compiled/`` artifact
members must come from a writer you trust.

**Size bound** (``compile_cache_max_bytes`` flag; 0 = unbounded):
``store()`` publishes its entry first, then evicts the coldest entries,
``.bin`` and manifest together, ordered by mtime, which ``load()``
touches on every hit (least recently used), until the dir fits. The
just-published entry is never evicted.

Counters (always on; every event here is a cold-start event, never a
per-step cost): ``paddle_deploy_cache_hits_total`` / ``_misses_total`` /
``_quarantined_total`` / ``_evictions_total``.
"""

import glob
import hashlib
import io
import json
import os
import threading

import torch

from ..observability import metrics as _metrics
from ..utils import log as _log

__all__ = ["PersistentCompileCache", "active_cache", "entry_digest",
           "env_fingerprint", "serialize_compiled",
           "deserialize_compiled", "sha256_bytes"]

CACHE_HITS = _metrics.REGISTRY.counter(
    "paddle_deploy_cache_hits_total",
    "Persistent compile-cache entries deserialized instead of compiled")
CACHE_MISSES = _metrics.REGISTRY.counter(
    "paddle_deploy_cache_misses_total",
    "Persistent compile-cache lookups that fell through to an XLA "
    "compile (absent, env-skewed, or quarantined entry)")
CACHE_QUARANTINED = _metrics.REGISTRY.counter(
    "paddle_deploy_cache_quarantined_total",
    "Persistent compile-cache entries moved to corrupt_* after failing "
    "digest verification or deserialization")
CACHE_EVICTIONS = _metrics.REGISTRY.counter(
    "paddle_deploy_cache_evictions_total",
    "Persistent compile-cache entries evicted (mtime-LRU) to keep the "
    "dir under compile_cache_max_bytes")

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_sources_digest = None


class _CorruptEntry(Exception):
    """Internal: entry present but failed verification/deserialization."""


def _kernel_sources_digest():
    """sha256 over the kernel sources' names and bytes: a changed kernel
    is a different environment. Read once a process."""
    global _sources_digest
    if _sources_digest is None:
        h = hashlib.sha256()
        paths = glob.glob(os.path.join(_CSRC, "*.cu")) + \
            glob.glob(os.path.join(_CSRC, "*.cuh"))
        for path in sorted(paths):
            h.update(os.path.basename(path).encode() + b"\0")
            with open(path, "rb") as f:
                h.update(f.read())
        _sources_digest = h.hexdigest()
    return _sources_digest


def env_fingerprint(device=None):
    """Everything that silently changes what a stored step means on
    ``device`` (a ``torch.device``; default: the first card when there is
    one, else the CPU): an entry written in another environment is a
    MISS, not a candidate."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else 0
        kind = torch.cuda.get_device_name(index)
        capability = "%d.%d" % torch.cuda.get_device_capability(index)
        count = torch.cuda.device_count()
    else:
        kind, capability, count = "cpu", "", 1
    return {
        "runtime": "torch",
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "",
        "platform": dev.type,
        "device_kind": kind,
        "capability": capability,
        "n_devices": count,
        "kernels": _kernel_sources_digest(),
        "tf32": [bool(torch.backends.cuda.matmul.allow_tf32),
                 bool(torch.backends.cudnn.allow_tf32)],
        "deterministic": bool(torch.are_deterministic_algorithms_enabled()),
    }


def entry_digest(program, skey_parts, device=None):
    """Stable cross-process digest for one executor cache entry.

    ``skey_parts`` is the in-memory cache key minus its process-local
    head (program uid/version), recorded on the entry by the executor;
    the program itself contributes through its serialized content, so a
    program rebuilt by the same user code, or re-read from an exported
    ``__model__``, lands on the same digest."""
    from .serialization import program_to_dict
    doc = {
        "program": program_to_dict(program),
        "sig": repr(skey_parts),
        "env": env_fingerprint(device),
    }
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()


def serialize_compiled(compiled):
    """One self-contained blob for an ``ExportedProgram``
    (``torch.export.save`` into bytes)."""
    buf = io.BytesIO()
    torch.export.save(compiled, buf)
    return buf.getvalue()


def deserialize_compiled(blob):
    """The ``ExportedProgram`` of a :func:`serialize_compiled` blob."""
    return torch.export.load(io.BytesIO(blob))


def sha256_bytes(data):
    return hashlib.sha256(data).hexdigest()


def _write_atomic(path, data, mode="wb"):
    # pid + thread id: two threads storing the same digest must not
    # interleave into one temp file (the loser's os.replace publishes
    # a whole file either way)
    tmp = "%s.tmp.%d.%d" % (path, os.getpid(), threading.get_ident())
    with open(tmp, mode) as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class PersistentCompileCache:
    """Directory of serialized steps, one ``entry_<digest>.bin`` +
    ``entry_<digest>.json`` manifest per compile-cache entry."""

    def __init__(self, dirname, max_bytes=0):
        self.dirname = str(dirname)
        # 0 = unbounded; refreshed from the compile_cache_max_bytes
        # flag by active_cache() so a flag change applies to the
        # already-constructed instance
        self.max_bytes = int(max_bytes or 0)
        self._serialize_unsupported = False  # log the first failure only

    def _bin(self, digest):
        return os.path.join(self.dirname, "entry_%s.bin" % digest)

    def _meta(self, digest):
        return os.path.join(self.dirname, "entry_%s.json" % digest)

    def load(self, digest, device=None):
        """The deserialized ``ExportedProgram`` for ``digest``, or None.

        Never raises: absent and environment-skewed entries (against
        ``device``'s environment) are plain misses; corrupt entries (torn
        manifest, digest mismatch, unloadable blob, injected
        ``cache_corrupt`` fault) are quarantined and reported as misses:
        the caller rebuilds."""
        bin_path, meta_path = self._bin(digest), self._meta(digest)
        if not (os.path.exists(bin_path) and os.path.exists(meta_path)):
            CACHE_MISSES.inc()
            return None
        try:
            from ..resilience import faults as _faults
            _faults.fire_point("cache_corrupt")
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
            except (OSError, ValueError) as e:
                raise _CorruptEntry("unreadable manifest: %r" % (e,))
            if meta.get("env") != env_fingerprint(device):
                # another torch, card or kernel build is SKEW, not
                # damage: leave the entry for the environment that
                # wrote it
                _log.structured("compile_cache_env_skew", digest=digest,
                                entry_env=meta.get("env"))
                CACHE_MISSES.inc()
                return None
            with open(bin_path, "rb") as f:
                blob = f.read()
            if sha256_bytes(blob) != meta.get("sha256"):
                raise _CorruptEntry("blob digest mismatch")
            compiled = deserialize_compiled(blob)
        except Exception as e:
            self._quarantine(digest, repr(e))
            CACHE_MISSES.inc()
            return None
        CACHE_HITS.inc()
        try:
            # LRU touch: a hit entry must outrank write-once-read-never
            # entries when the size cap evicts by mtime
            os.utime(bin_path)
            os.utime(meta_path)
        except OSError:
            pass
        return compiled

    def store(self, digest, compiled, device=None):
        """Serialize + publish one entry (atomic per file; the manifest
        lands last, so a crashed writer leaves an entry without a
        manifest: a plain miss). Best-effort: a step that cannot be
        serialized, or a read-only dir, just means no persistent
        cache."""
        try:
            blob = serialize_compiled(compiled)
        except Exception as e:
            if not self._serialize_unsupported:
                self._serialize_unsupported = True
                _log.structured("compile_cache_serialize_unsupported",
                                error=repr(e))
            return False
        try:
            os.makedirs(self.dirname, exist_ok=True)
            _write_atomic(self._bin(digest), blob)
            _write_atomic(
                self._meta(digest),
                json.dumps({"sha256": sha256_bytes(blob),
                            "bytes": len(blob),
                            "env": env_fingerprint(device)}).encode())
        except OSError as e:
            _log.structured("compile_cache_store_failed", digest=digest,
                            error=repr(e))
            return False
        self._evict_lru(keep_digest=digest)
        return True

    def _evict_lru(self, keep_digest):
        """Bound the dir to ``max_bytes``: drop whole entries (bin +
        manifest together) coldest-mtime first until the cap fits. The
        entry just published is exempt: a cap smaller than one entry
        degrades to a cache of one. Best-effort, like store() itself."""
        if not self.max_bytes:
            return
        try:
            entries = {}  # digest -> [mtime, bytes, paths]
            for fname in os.listdir(self.dirname):
                # skip quarantine evidence (bounded separately) and a
                # concurrent writer's in-flight temp files
                if not fname.startswith("entry_") or ".tmp." in fname:
                    continue
                digest = fname[len("entry_"):].rsplit(".", 1)[0]
                path = os.path.join(self.dirname, fname)
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                ent = entries.setdefault(digest, [0.0, 0, []])
                ent[0] = max(ent[0], st.st_mtime)
                ent[1] += st.st_size
                ent[2].append(path)
            total = sum(e[1] for e in entries.values())
            for digest in sorted(entries, key=lambda d: entries[d][0]):
                if total <= self.max_bytes:
                    break
                if digest == keep_digest:
                    continue
                for path in entries[digest][2]:
                    try:
                        os.remove(path)
                    except OSError:
                        pass
                total -= entries[digest][1]
                CACHE_EVICTIONS.inc()
                _log.structured("compile_cache_evicted", digest=digest,
                                freed_bytes=entries[digest][1])
        except OSError:
            pass

    def _quarantine(self, digest, reason):
        """Move a corrupt entry aside (evidence, like checkpoint
        quarantine) and bound the evidence to the newest 8 entries."""
        moved = False
        for path in (self._bin(digest), self._meta(digest)):
            if not os.path.exists(path):
                continue
            dst = os.path.join(self.dirname,
                               "corrupt_" + os.path.basename(path))
            n = 0
            while os.path.exists(dst):
                n += 1
                dst = os.path.join(self.dirname, "corrupt_%d_%s"
                                   % (n, os.path.basename(path)))
            try:
                os.rename(path, dst)
                moved = True
            except OSError:
                pass
        if moved:
            CACHE_QUARANTINED.inc()
            _log.structured("compile_cache_quarantined", digest=digest,
                            reason=reason)
            try:
                # prune an entry's .bin and .json together
                groups = {}
                for fname in os.listdir(self.dirname):
                    if not fname.startswith("corrupt_"):
                        continue
                    path = os.path.join(self.dirname, fname)
                    stem = os.path.splitext(fname)[0]
                    mtime, paths = groups.setdefault(stem, (0.0, []))
                    groups[stem] = (max(mtime, os.path.getmtime(path)),
                                    paths)
                    paths.append(path)
                for stem in sorted(groups,
                                   key=lambda s: groups[s][0])[:-8]:
                    for path in groups[stem][1]:
                        os.remove(path)
            except OSError:
                pass


_ACTIVE = {}
_ACTIVE_LOCK = threading.Lock()


def active_cache():
    """The PersistentCompileCache for the ``compile_cache_dir`` flag,
    or None when the flag is unset (zero filesystem access)."""
    from .. import config as _config
    dirname = _config.get_flag("compile_cache_dir")
    if not dirname:
        return None
    dirname = os.path.abspath(str(dirname))
    with _ACTIVE_LOCK:
        cache = _ACTIVE.get(dirname)
        if cache is None:
            cache = PersistentCompileCache(dirname)
            _ACTIVE[dirname] = cache
        # store-path-only flag (load never consults it): refresh here
        # so a flag change reaches the cached instance
        cache.max_bytes = int(
            _config.get_flag("compile_cache_max_bytes") or 0)
        return cache
