"""Multi-model fleet paging: residency as fleet state (reference
``paddle_tpu/serving/model_paging.py``). N models share a fleet whose
device memory holds only a hot subset, and a tenant maps to a model,
not just a quota row; the placed resource is a whole weight set:

* :class:`ModelCatalog` / :class:`ModelSpec` — the fleet's model
  table: every model the fleet may page, its artifact
  (``params_path`` for generation workers, ``model_dir`` for engine
  workers), its weights ``tag`` (the version the journal fence sees),
  its catalog-accounted ``bytes`` (the eviction currency), and the
  tenants it serves. Armed by the ``fleet_models`` flag or the
  router's ``models=`` constructor arg.
* :class:`ModelResidencySet` — the router-side view of one member's
  resident models, fenced by the membership generation that reported
  it (a dead incarnation's residency dies with its member row; a
  stale heartbeat's advertisement is ignored exactly like its world
  view). Tracks per-model last use (the LRU clock) and an in-flight
  pin count, the block pool's refcount discipline applied to whole
  weight sets: :meth:`ModelResidencySet.lru_victims` never names a
  pinned model, and the router asserts the invariant again at the
  eviction site.
* :func:`write_weights_manifest` / :func:`verify_weights_manifest` —
  the sha256, byte size and each variable's shape and dtype beside an
  ``.npz`` artifact; a truncated or switched artifact is refused before
  any weight touches a scope. The manifest's JSON is the reference's,
  so it crosses both ways (``serving/deploy.py`` re-exports both).

The router (serving/fleet.py) composes these: residency-affinity
placement, demand paging through the swap gates (the ``page_in`` verb:
manifest-verified staged load, then flip, bounded by
``model_page_timeout_ms`` and charged to the autoscaler's
spawn-failure budget on a wedge), LRU eviction pressure against
``member_resident_bytes``, and journal replay across a page-out: a
journal whose model was paged out re-pages it on the target member
before the re-drive.

Fault sites (resilience/faults.py): ``model_page_in_fail`` (worker
side, indexed by model id: the page-in raises before any weight
lands), ``model_page_in_slow`` (worker side, indexed by model id: arm
a callback sleeping past ``model_page_timeout_ms`` to wedge the
page-in), ``model_evict_race`` (router side, indexed by model id,
fired between victim selection and the page-out: arm a callback that
pins the victim to prove eviction re-checks the in-flight invariant
instead of racing it).

Default flags construct none of this: no catalog, no residency rows,
no paging verbs on any frame. Host code only: the byte counts are the
artifacts' on disk, not a device's.
"""

import hashlib
import json
import os
import time

import numpy as np

from ..observability import metrics as _metrics

__all__ = ["ModelSpec", "ModelCatalog", "ModelResidencySet",
           "PageInError", "write_weights_manifest",
           "verify_weights_manifest"]

PAGE_INS = _metrics.REGISTRY.counter(
    "paddle_fleet_model_page_ins_total",
    "Demand page-ins by outcome (ok; fail: the member rejected or "
    "errored the staged load; timeout: no reply within "
    "model_page_timeout_ms — charged to the autoscaler's "
    "spawn-failure budget like a wedged spawn)",
    labelnames=("outcome",))
PAGE_IN_MS = _metrics.REGISTRY.histogram(
    "paddle_fleet_model_page_in_ms",
    "Demand page-in latency: router decision -> the target member's "
    "flip committed (manifest-verified staged load + canary + flip)",
    buckets=_metrics.LATENCY_MS_BUCKETS)
EVICTIONS = _metrics.REGISTRY.counter(
    "paddle_fleet_model_evictions_total",
    "Resident models paged out under LRU byte pressure (never a "
    "model with in-flight requests — that is an invariant assert, "
    "not a counter)")
RESIDENCY_HITS = _metrics.REGISTRY.counter(
    "paddle_fleet_model_residency_hits_total",
    "Requests whose model was already resident on a live member at "
    "submit (the affinity steady state)")
RESIDENCY_MISSES = _metrics.REGISTRY.counter(
    "paddle_fleet_model_residency_misses_total",
    "Requests that found no live resident member and triggered (or "
    "waited on) a demand page-in")
MODEL_REQUEST_MS = _metrics.REGISTRY.histogram(
    "paddle_fleet_model_request_ms",
    "Router submit -> resolution, one child per model (the per-model "
    "slice of paddle_fleet_request_ms, same discipline as the "
    "per-tenant family); only populated when the router has a model "
    "catalog", labelnames=("model",),
    buckets=_metrics.LATENCY_MS_BUCKETS)
MODEL_DEADLINE = _metrics.REGISTRY.counter(
    "paddle_fleet_model_deadline_total",
    "Deadline-expired fleet requests attributed to one model (feeds "
    "that model's SLO bad count)", labelnames=("model",))
RESIDENT_BYTES = _metrics.REGISTRY.gauge(
    "paddle_fleet_member_resident_bytes",
    "Catalog-accounted bytes of the member's resident model set "
    "(what member_resident_bytes bounds)", labelnames=("member",))


class PageInError(RuntimeError):
    """A demand page-in failed or wedged: the model could not be made
    resident on any eligible member within the paging budget."""


class ModelSpec:
    """One catalog row: where a model's weights live and what they
    cost. ``params_path`` (an ``.npz`` of {name: array}) feeds
    generation-scheduler members, ``model_dir`` feeds stateless
    engine members — exactly the rolling-deploy artifact split.
    ``tag`` is the weights version the member acks after paging this
    model in (the journal fence sees it); ``nbytes`` is the
    catalog-accounted size the eviction budget charges (defaults to
    the artifact's on-disk size); ``tenants`` names the tenants this
    model serves (the submit-side tenant -> model resolution)."""

    __slots__ = ("model_id", "params_path", "model_dir", "tag",
                 "_nbytes", "tenants")

    def __init__(self, model_id, params_path=None, model_dir=None,
                 tag=None, nbytes=None, tenants=()):
        if params_path is None and model_dir is None:
            raise ValueError(
                "model %r needs params_path or model_dir" % model_id)
        self.model_id = str(model_id)
        self.params_path = (None if params_path is None
                            else str(params_path))
        self.model_dir = None if model_dir is None else str(model_dir)
        self.tag = ("%s@v0" % self.model_id) if tag is None else str(tag)
        self._nbytes = None if nbytes is None else int(nbytes)
        self.tenants = tuple(str(t) for t in (tenants or ()))

    def nbytes(self):
        """Catalog-accounted bytes of this model's weight set — the
        explicit size when given, else the artifact's on-disk size
        (computed once; 0 when the artifact is not stat-able, so an
        unknown size can never fake eviction headroom as pressure)."""
        if self._nbytes is None:
            total = 0
            path = self.params_path or self.model_dir
            try:
                if os.path.isdir(path):
                    for root, _dirs, files in os.walk(path):
                        for f in files:
                            total += os.path.getsize(
                                os.path.join(root, f))
                else:
                    total = os.path.getsize(path)
            except OSError:
                total = 0
            self._nbytes = int(total)
        return self._nbytes

    def doc(self):
        return {"tag": self.tag, "bytes": self.nbytes(),
                "artifact": self.params_path or self.model_dir,
                "tenants": list(self.tenants)}


class ModelCatalog:
    """The fleet's model table: id -> :class:`ModelSpec`, plus the
    tenant -> model resolution ``submit`` uses when the caller names
    a tenant but not a model."""

    def __init__(self, specs):
        self._specs = {}
        self._by_tenant = {}
        for spec in specs:
            if spec.model_id in self._specs:
                raise ValueError("duplicate model id %r"
                                 % spec.model_id)
            self._specs[spec.model_id] = spec
            for tid in spec.tenants:
                if tid in self._by_tenant:
                    raise ValueError(
                        "tenant %r mapped to both %r and %r"
                        % (tid, self._by_tenant[tid], spec.model_id))
                self._by_tenant[tid] = spec.model_id

    @classmethod
    def from_value(cls, value):
        """Build from the ``fleet_models`` flag / constructor shape —
        ``{model id: {"params_path"/"model_dir": ..., "tag": ...,
        "bytes": N, "tenants": (...)}}`` — or pass a ready catalog
        through."""
        if isinstance(value, ModelCatalog):
            return value
        specs = []
        for mid, row in dict(value).items():
            row = dict(row)
            specs.append(ModelSpec(
                mid,
                params_path=row.get("params_path"),
                model_dir=row.get("model_dir"),
                tag=row.get("tag"),
                nbytes=row.get("bytes"),
                tenants=row.get("tenants", ())))
        return cls(specs)

    def get(self, model_id):
        spec = self._specs.get(str(model_id))
        if spec is None:
            raise KeyError("model %r is not in the fleet catalog (%s)"
                           % (model_id, sorted(self._specs)))
        return spec

    def __contains__(self, model_id):
        return str(model_id) in self._specs

    def __len__(self):
        return len(self._specs)

    def ids(self):
        return sorted(self._specs)

    def items(self):
        return sorted(self._specs.items())

    def for_tenant(self, tenant):
        """The model serving ``tenant``, or None when no catalog row
        names it (the request then needs an explicit ``model=``, or
        rides model-less like a pre-catalog fleet)."""
        if tenant is None:
            return None
        return self._by_tenant.get(str(tenant))

    def doc(self):
        return {mid: spec.doc() for mid, spec in self.items()}


class _Resident:
    __slots__ = ("last_use", "nbytes")

    def __init__(self, last_use, nbytes):
        self.last_use = last_use
        self.nbytes = nbytes


class ModelResidencySet:
    """Router-side residency of ONE member, fenced by generation.

    The member advertises its resident model ids on REG and on every
    heartbeat; :meth:`update` replaces the set only when the
    advertisement's generation is current (a stale world view's
    residency claim is as untrustworthy as its membership view — the
    same generation fence, applied to the paged resource). Last-use stamps
    survive an update for retained ids, so the LRU clock is not reset
    by every beat. Pins are the in-flight refcount: a model a request
    is currently dispatched against can NEVER be an eviction victim.

    Not self-locking — every mutation happens under the router's
    membership lock, exactly like the _Member fields beside it."""

    __slots__ = ("models", "pins", "generation")

    def __init__(self):
        self.models = {}      # model id -> _Resident
        self.pins = {}        # model id -> in-flight pin count
        self.generation = None

    def update(self, model_ids, generation, catalog=None, now=None):
        """Replace the resident set from a member advertisement made
        at ``generation``. Byte sizes come from the catalog when it
        knows the model (0 otherwise — foreign models never fake
        pressure)."""
        now = time.monotonic() if now is None else now
        fresh = {}
        for mid in model_ids or ():
            mid = str(mid)
            cur = self.models.get(mid)
            nbytes = (catalog.get(mid).nbytes()
                      if catalog is not None and mid in catalog else 0)
            fresh[mid] = cur if cur is not None \
                else _Resident(now, nbytes)
            fresh[mid].nbytes = nbytes
        self.models = fresh
        self.generation = generation

    def add(self, model_id, nbytes=0, now=None):
        """Record one model as resident now (the router's own page-in
        landing, ahead of the member's next advertisement)."""
        mid = str(model_id)
        now = time.monotonic() if now is None else now
        r = self.models.get(mid)
        if r is None:
            self.models[mid] = _Resident(now, int(nbytes))
        else:
            r.last_use = now
            r.nbytes = int(nbytes)

    def resident(self, model_id):
        return str(model_id) in self.models

    def touch(self, model_id, now=None):
        r = self.models.get(str(model_id))
        if r is not None:
            r.last_use = time.monotonic() if now is None else now

    def pin(self, model_id):
        mid = str(model_id)
        self.pins[mid] = self.pins.get(mid, 0) + 1

    def unpin(self, model_id):
        mid = str(model_id)
        n = self.pins.get(mid, 0) - 1
        if n <= 0:
            self.pins.pop(mid, None)
        else:
            self.pins[mid] = n

    def pinned(self, model_id):
        return self.pins.get(str(model_id), 0)

    def drop(self, model_id):
        self.models.pop(str(model_id), None)

    def nbytes(self):
        return sum(r.nbytes for r in self.models.values())

    def lru_victims(self, budget, protect=()):
        """Resident models to evict, LRU-first, until the set fits
        ``budget`` bytes. NEVER a pinned model (in-flight requests),
        never one in ``protect`` (the active model, the model just
        paged in). May return fewer victims than the budget wants —
        pinned residents are simply not evictable, and the caller
        retries pressure after they drain."""
        protect = {str(p) for p in protect}
        over = self.nbytes() - int(budget)
        if over <= 0:
            return []
        victims = []
        for mid, r in sorted(self.models.items(),
                             key=lambda kv: kv[1].last_use):
            if over <= 0:
                break
            if mid in protect or self.pins.get(mid, 0) > 0:
                continue
            victims.append(mid)
            over -= r.nbytes
        return victims

    def doc(self):
        return {"models": sorted(self.models),
                "bytes": self.nbytes(),
                "pins": {m: n for m, n in sorted(self.pins.items())},
                "generation": self.generation}


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
