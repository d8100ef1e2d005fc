"""Serving fleet: routed multi-process inference with membership,
cross-process failover and rolling deploys (reference
``paddle_tpu/serving/fleet.py``; the same classes, wire verbs, metric
names, help texts and labels, so a router of either package fronts
workers of either).

Engine replicas, the generation scheduler, breakers, token-replay
failover and hot swaps live inside one process. This module is the
tier above: one process's death must be an event the fleet absorbs,
not an outage.

* :class:`FleetRouter` — the front door over N engine *processes*:

  - **membership** on the task master's discipline: workers REGister
    and heartbeat over the line protocol; a missed deadline drops the
    member, bumps the fleet *generation*, and fences what the dead
    member still says — a reply landing after its member was declared
    dead is discarded and the request re-driven, never trusted
    (``paddle_fleet_fenced_replies_total``). A genuinely new member
    joining also bumps the generation, so stale world views are always
    fenced into a re-register.
  - **routing**: least-loaded placement over healthy members with a
    per-member :class:`~paddle_tpu_torch.serving.resilience.ReplicaBreaker`
    (the engine's breaker one tier up: closed -> open on consecutive
    failures or a single hang, cooldown-gated trial re-admission),
    member-labelled gauges, and request-latency histograms.
  - **cross-process failover**: the router journals ``prompt ⊕
    tokens-so-far`` per request (workers stream each token back), so a
    killed member's in-flight generations re-drive on a peer by
    re-submitting the journal — the scheduler's replay path, one
    process up: the peer prefills the history and decoding continues
    token for token as in a fault-free run (sampled policies included:
    the router mints the request's decode seed once and re-feeds it on
    every hop). A journal is only reusable on a peer serving the same
    weights version, the same decode-policy fingerprint and the same
    model (acked by each member); across any of them it is discarded
    and the generation restarts from the prompt.
  - **rolling deploys**: drain one member, ``swap`` it (the worker
    applies the push through the scheduler's swap gates), canary-scope
    a fraction of live traffic to it, watch; a watch failure rolls the
    whole fleet back to the prior version and aborts. Clients see zero
    errors either way: canary failures replay onto stable members.

* :class:`EngineWorker` — the process wrapper a member runs: serves a
  local :class:`~paddle_tpu_torch.serving.generation.GenerationScheduler`
  (or a stateless :class:`~paddle_tpu_torch.serving.engine.ServingEngine`)
  over the JSON-line wire (``serving/wire.py``: length-capped reads,
  per-call timeouts, jittered retry), registers with the router,
  heartbeats on ``fleet_heartbeat_ms``, streams tokens as they decode,
  and answers ``swap``/``rollback``/``health``. Cold members warm
  through the persistent compile cache (``compile_cache_dir``), so
  scale-up under load is scale-up to first token.

  No CUDA work runs on the wire's connection threads: a ``generate``
  only submits to the scheduler, whose dispatcher thread owns every
  launch and the per-thread kernel scratch, and tokens come back
  through its ``on_token`` observer; a ``run`` on an engine member
  executes on the replica's bounded worker when the engine has a
  timeout. Tokens cross the wire as Python ints and return to callers
  as int64 numpy arrays, as the reference returns them. Weight
  snapshots (rollback targets, paged-out models) are host copies of
  the scope's tensors, taken after the scheduler has drained the
  streams that read them.

Cross-process tracing: the request envelope carries the router-minted
trace id; the router stamps a ``fleetHop`` span per dispatch and a
``memberRecv`` child from the worker's ack, so one request killed
mid-generation reads router -> dead member -> replay on a peer in a
single ``/debug/trace`` tree.

Multi-tenancy: requests carry a **tenant id** end to end —
``submit(tenant=...)`` -> the generate envelope -> the worker's backend
(signature-gated, like the seed) — and the journal living router-side
means every replay hop re-sends it. With a ``tenants`` table armed (the
``fleet_tenants`` flag, or the constructor arg) the router enforces
per-tenant **admission quotas** (max in-flight; over-quota submits
raise the typed
:class:`~paddle_tpu_torch.serving.batcher.TenantQuotaError` and charge
``paddle_serving_tenant_shed_total{tenant=...}``) and **priority
tiers** (placement under contention yields to strictly higher-priority
waiters). Per-tenant latency histograms feed per-tenant SLOTracker
verdicts under ``/debug/slo`` when both the SLO target and the table
are armed.

Autoscaling (serving/autoscale.py): an attached
:class:`~paddle_tpu_torch.serving.autoscale.FleetAutoscaler` rides the
monitor tick — spawns EngineWorker processes on SLO pressure, drains
and retires them idle (``retire_member``), bounded by
``fleet_members_min``/``fleet_members_max``. The router never
constructs one.

Multi-model paging (serving/model_paging.py): with a model catalog
armed (the ``fleet_models`` flag / the ``models=`` ctor arg) weights
become a paged resource — each member advertises its resident model
set on REG and every heartbeat (generation-fenced like membership
itself), placement gains a residency-affinity term, a request for a
nowhere-resident model demand-pages it onto the least-loaded member
through the worker's swap gates (``page_in``: manifest-verified staged
load, then flip, bounded by ``model_page_timeout_ms`` and charged to
the autoscaler's spawn-failure budget on a wedge), LRU eviction
pressure holds each member's resident-set bytes under
``member_resident_bytes`` (never evicting a model with in-flight
requests), and the replay journal gains the model id as its third
fence: a journal never splices onto the wrong model, and a journal
whose model was paged out re-pages it on the target member before the
re-drive.

Fault sites (resilience/faults.py): ``fleet_member_kill`` (worker
side, indexed by streamed-token count — ``action="kill"`` SIGKILLs the
worker mid-generation), ``fleet_network_partition`` (router side
before dispatch, indexed by member id — and the worker's heartbeat
loop swallows beats under the same site, so one arm simulates both
directions of a partition), ``fleet_slow_member`` (worker side before
serving, indexed by member id — arm a callback sleeping past the
router's call timeout), plus the autoscaler's ``fleet_spawn_fail`` /
``fleet_spawn_slow`` and the paging sites ``model_page_in_fail`` /
``model_page_in_slow`` / ``model_evict_race``.

Default flags construct none of this: no router, no worker, no
sockets, no threads, no autoscaler, no tenant table, no model catalog.
``fleet_heartbeat_ms`` / ``fleet_members_min`` /
``fleet_canary_fraction`` / ``fleet_tenants`` / ``fleet_models`` are
read only inside these constructors (and ``member_resident_bytes`` /
``model_page_timeout_ms`` only when a catalog is armed).
"""

import inspect
import itertools
import os
import queue
import threading
import time
import weakref
from concurrent.futures import Future

import numpy as np

from .. import config as _config
from ..observability import aggregate as _aggregate
from ..observability import flight as _flight
from ..observability import metrics as _metrics
from ..observability import request_trace as _rtrace
from ..observability import slo as _slo
from ..resilience import faults as _faults
from ..utils import log as _log
from . import model_paging as _paging
from . import resilience as _sres
from . import wire as _wire
from .batcher import _WAIT_ALPHA, TenantQuotaError, _resolve
from .decoding.policy import GREEDY_FINGERPRINT, mint_seed
from .resilience import (ReplicaBreaker, ServingDeadlineError,
                         ServingUnavailableError)

__all__ = ["FleetRouter", "EngineWorker", "TenantQuotaError"]

# the families' names, help texts and labels are the reference's,
# verbatim: a fleet's merged exposition reads the same from either
# package's members
_REQUESTS = _metrics.REGISTRY.counter(
    "paddle_fleet_requests_total",
    "Generation requests accepted by a fleet router")
_FAILOVERS = _metrics.REGISTRY.counter(
    "paddle_fleet_failover_total",
    "Requests re-driven on a peer member after a member failure "
    "(journal re-submit — the PR-9 replay path, one process up)")
_DEATHS = _metrics.REGISTRY.counter(
    "paddle_fleet_member_deaths_total",
    "Members dropped for a missed heartbeat deadline")
_FENCED = _metrics.REGISTRY.counter(
    "paddle_fleet_fenced_replies_total",
    "Replies discarded because their member had been declared dead "
    "by the time they landed (generation fencing, serving tier)")
_JOURNAL_RESETS = _metrics.REGISTRY.counter(
    "paddle_fleet_journal_resets_total",
    "Replay journals discarded at a fence, by reason (version: the "
    "only willing peer served different weights; policy: a different "
    "decode-policy fingerprint; model: a different model id — the "
    "generation restarts from the prompt; a spliced response is "
    "never served)", labelnames=("reason",))
_DEPLOYS = _metrics.REGISTRY.counter(
    "paddle_fleet_deploys_total",
    "Rolling deploys by outcome", labelnames=("outcome",))
_ROLLBACKS = _metrics.REGISTRY.counter(
    "paddle_fleet_rollbacks_total",
    "Fleet-wide rollbacks (watch failure or swap failure mid-deploy)")
_GENERATION = _metrics.REGISTRY.gauge(
    "paddle_fleet_generation",
    "Fleet membership generation (bumps on every join/death)",
    labelnames=("router",))
_MEMBERS_LIVE = _metrics.REGISTRY.gauge(
    "paddle_fleet_members_live",
    "Members currently in the routing rotation",
    labelnames=("router",))
_MEMBER_INFLIGHT = _metrics.REGISTRY.gauge(
    "paddle_fleet_member_inflight",
    "Requests currently dispatched to the member (least-loaded "
    "placement key)", labelnames=("member",))
_REQUEST_MS = _metrics.REGISTRY.histogram(
    "paddle_fleet_request_ms",
    "Router submit -> resolution per fleet request (all hops)",
    buckets=_metrics.LATENCY_MS_BUCKETS)
_TENANT_REQUEST_MS = _metrics.REGISTRY.histogram(
    "paddle_fleet_tenant_request_ms",
    "Router submit -> resolution, one child per tenant (the "
    "per-tenant slice of paddle_fleet_request_ms — a separate family "
    "because a registered family's labelnames are immutable); only "
    "populated when the router has a tenant table",
    labelnames=("tenant",), buckets=_metrics.LATENCY_MS_BUCKETS)
_TENANT_DEADLINE = _metrics.REGISTRY.counter(
    "paddle_fleet_tenant_deadline_total",
    "Deadline-expired fleet requests attributed to one tenant "
    "(feeds that tenant's SLO bad count)", labelnames=("tenant",))
_TENANT_ACTIVE = _metrics.REGISTRY.gauge(
    "paddle_fleet_tenant_active",
    "Requests one tenant currently holds in flight at the router "
    "(the quantity its admission quota bounds)",
    labelnames=("tenant",))
_RECOVERY_SECONDS = _metrics.REGISTRY.histogram(
    "paddle_fleet_recovery_seconds",
    "Member failure -> first replayed token streaming from a peer "
    "(kill-to-first-replayed-token)")
_WORKER_DONE = _metrics.REGISTRY.counter(
    "paddle_fleet_worker_done_total",
    "Requests this member process completed (the per-member side of "
    "the fleet conservation ledger: aggregated deltas must equal the "
    "router-observed completions)")

_ROUTER_SEQ = itertools.count()
_WORKER_INCARNATION_SEQ = itertools.count()


class _MemberError(RuntimeError):
    """A member failed a request server-side (error frame, mid-stream
    EOF, or a fenced stale reply) — failover material, charged to the
    member's breaker, never surfaced while replay budget remains."""


class _VersionRetry(Exception):
    """The member's ack revealed a weights version the router's cache
    didn't know (out-of-band swap, second router deploying): the
    journal sent with the hop was generated under OTHER weights, so
    the hop is abandoned and the request retried from the prompt.
    Not a member failure — no breaker charge, no replay burned."""


class _ModelRetry(Exception):
    """The member refused the hop because the request's model is not
    resident there (paged out between placement and dispatch, or the
    router's residency view was stale). Not a member failure — no
    breaker charge, no replay burned; the serve loop corrects its
    residency view and re-drives through ``_ensure_resident``, which
    re-pages the model first."""


class _Member:
    __slots__ = ("id", "addr", "state", "joined_gen", "deadline",
                 "version", "policy", "inflight", "served", "failures",
                 "breaker", "conns", "label", "index", "residency",
                 "active_model", "paging")

    def __init__(self, mid, addr, gen, label, index):
        self.id = mid
        self.addr = tuple(addr)
        self.state = "live"   # live | draining | canary | dead
        self.joined_gen = gen
        self.deadline = None  # monotonic heartbeat deadline
        self.version = None   # last weights tag the member reported
        self.policy = None    # last decode-policy fingerprint reported
        self.inflight = 0
        self.served = 0       # completions since the last swap (watch)
        self.failures = 0     # failures since the last swap (watch)
        self.breaker = None
        self.conns = set()    # open per-request data connections
        self.label = label    # "f<router>:<member>" — gauge namespace
        self.index = index    # dense join order (breaker index)
        # multi-model residency: what this member advertises
        # as paged in, generation-fenced like membership itself
        self.residency = _paging.ModelResidencySet()
        self.active_model = None  # model id the member last acked
        self.paging = False       # a page-in is in flight on it


class _Tenant:
    """One admission-table row: quota (max in-flight at the router,
    0 = unlimited), priority (lower wins placement under contention),
    and the live accounting the quota check reads."""
    __slots__ = ("id", "quota", "priority", "active", "sheds", "label")

    def __init__(self, tid, quota, priority, label):
        self.id = tid
        self.quota = int(quota or 0)
        self.priority = int(priority or 0)
        self.active = 0
        self.sheds = 0
        self.label = label   # "f<router>:<tenant>" — child namespace


class _FleetRequest:
    __slots__ = ("prompt", "tokens", "max_new", "eos_id", "deadline",
                 "future", "meta", "ctx", "replays", "charged",
                 "failed_on", "canary", "tokens_version",
                 "tokens_policy", "seed", "version",
                 "version_start", "member", "fail_t", "t_submit",
                 "tenant", "tenant_entry", "model", "tokens_model",
                 "model_counted", "model_retries")

    def __init__(self, prompt, max_new, eos_id, deadline, meta,
                 seed=0, tenant=None, model=None):
        self.prompt = [int(t) for t in prompt]
        self.tokens = []          # the replay journal's generated half
        self.max_new = max_new
        self.eos_id = eos_id
        self.deadline = deadline  # absolute monotonic, or None
        self.future = Future()
        self.meta = meta
        self.ctx = None
        self.replays = 0
        self.charged = False      # at-most-one breaker charge
        self.failed_on = set()    # member ids this request failed on
        self.canary = None        # pinned canary routing for one hop
        self.tokens_version = None  # weights tag that produced tokens
        self.tokens_policy = None   # decode-policy fp that produced them
        self.seed = int(seed)     # minted ONCE; re-fed on every replay
        self.version = None
        self.version_start = None
        self.member = None
        self.fail_t = None        # failure instant, for recovery hist
        self.t_submit = time.perf_counter()
        # tenant id, carried end-to-end like the seed: submit ->
        # envelope -> (journal lives router-side, so every replay hop
        # re-sends it for free)
        self.tenant = None if tenant is None else str(tenant)
        self.tenant_entry = None  # admission row to release, or None
        # the model this request targets (catalog-armed routers only):
        # carried on every hop's envelope like the seed; the third
        # journal fence beside weights version and decode policy
        self.model = None if model is None else str(model)
        self.tokens_model = None  # model id that produced the journal
        self.model_counted = False  # residency hit/miss counted once
        self.model_retries = 0    # bounded model-residency re-drives

    def journal(self):
        return self.prompt + self.tokens

    def remaining(self):
        if self.max_new is None:
            return None
        return max(0, int(self.max_new) - len(self.tokens))


class FleetRouter:
    """Front-end router over N :class:`EngineWorker` processes.

    Construct it, point workers' ``router_addr`` at :attr:`addr`, and
    ``submit(prompt) -> Future`` routes over whoever is alive. Nothing
    global is touched at defaults — the fleet flags are read here
    and in :class:`EngineWorker` only.

    ``heartbeat_timeout_ms`` (default ``3 x fleet_heartbeat_ms``) is
    the membership deadline; 0 disables reaping (manual membership —
    unit tests drive deaths explicitly). ``breaker_failures`` defaults
    to the ``serving_breaker_failures`` flag (0 = no breakers).
    ``replay_attempts`` bounds cross-process re-drives per request.
    ``canary_fraction`` (default: the ``fleet_canary_fraction`` flag)
    is the share of live traffic a mid-deploy canary member receives;
    ``members_min`` (default: the ``fleet_members_min`` flag) is the
    /healthz liveness threshold and the ``wait_members`` default.
    ``tenants`` (default: the ``fleet_tenants`` flag) arms the
    multi-tenant admission table — ``{tenant: {"quota": N,
    "priority": P}}``, ``"*"`` for the unknown-tenant policy;
    ``member_inflight_limit`` (> 0) caps per-member in-flight so
    placement becomes a contended resource (requests queue at the
    router — what priority tiers and the placement-wait EWMA act on).
    ``models`` (default: the ``fleet_models`` flag) arms the model
    catalog — ``{model id: {"params_path"/"model_dir", "tag",
    "bytes", "tenants"}}`` — and with it residency-affinity routing,
    demand paging, and eviction pressure; ``resident_bytes`` /
    ``page_timeout_ms`` (defaults: the ``member_resident_bytes`` /
    ``model_page_timeout_ms`` flags, read only when a catalog is
    armed) bound a member's resident set and one page-in.
    """

    def __init__(self, host="127.0.0.1", port=0,
                 heartbeat_timeout_ms=None, breaker_failures=None,
                 breaker_cooldown_ms=None, replay_attempts=3,
                 call_timeout=120.0, connect_timeout=5.0,
                 placement_timeout=30.0, canary_fraction=None,
                 members_min=None, metrics_interval_ms=None,
                 slo_target_p99_ms=None, slo_windows=None,
                 tenants=None, member_inflight_limit=0,
                 models=None, resident_bytes=None,
                 page_timeout_ms=None):
        self._rid = next(_ROUTER_SEQ)
        if heartbeat_timeout_ms is None:
            heartbeat_timeout_ms = \
                3.0 * float(_config.get_flag("fleet_heartbeat_ms"))
        self.heartbeat_timeout = float(heartbeat_timeout_ms) / 1e3
        if breaker_failures is None:
            breaker_failures = _config.get_flag(
                "serving_breaker_failures")
        self.breaker_failures = int(breaker_failures or 0)
        if breaker_cooldown_ms is None:
            breaker_cooldown_ms = _config.get_flag(
                "serving_breaker_cooldown_ms")
        self.breaker_cooldown = float(breaker_cooldown_ms) / 1e3
        self.replay_attempts = int(replay_attempts or 0)
        self.call_timeout = float(call_timeout)
        self.connect_timeout = float(connect_timeout)
        self.placement_timeout = float(placement_timeout)
        if canary_fraction is None:
            canary_fraction = _config.get_flag("fleet_canary_fraction")
        self.canary_fraction = float(canary_fraction)
        if members_min is None:
            members_min = _config.get_flag("fleet_members_min")
        self.members_min = int(members_min)
        if tenants is None:
            tenants = _config.get_flag("fleet_tenants")
        # the tenant table: None (default) = single-tenant router, no
        # table, no per-tenant children, submit(tenant=) carried for
        # tracing only. A "*" row is the policy unknown tenants get.
        self._tenants = None
        self._tenant_default = (0, 0)   # (quota, priority) fallback
        self._tenant_slos = {}
        if tenants:
            self._tenants = {}
            for tid, pol in dict(tenants).items():
                if isinstance(pol, dict):
                    quota = pol.get("quota", 0)
                    priority = pol.get("priority", 0)
                else:
                    quota, priority = pol
                if str(tid) == "*":
                    self._tenant_default = (int(quota or 0),
                                            int(priority or 0))
                else:
                    tid = str(tid)
                    self._tenants[tid] = _Tenant(
                        tid, quota, priority,
                        "f%d:%s" % (self._rid, tid))
        # the model catalog: None (default) = single-model fleet —
        # no catalog, no residency routing, no paging verbs, every
        # envelope/heartbeat frame byte-identical. The byte budget
        # and page timeout are read ONLY when a catalog is armed, so
        # default construction reads exactly one extra flag.
        if models is None:
            models = _config.get_flag("fleet_models")
        self._catalog = None
        self._model_slos = {}
        self._paging = {}          # model id -> in-flight page-in Event
        self.resident_bytes = 0
        self.page_timeout = 0.0
        if models:
            self._catalog = _paging.ModelCatalog.from_value(models)
            if resident_bytes is None:
                resident_bytes = _config.get_flag(
                    "member_resident_bytes")
            self.resident_bytes = int(resident_bytes or 0)
            if page_timeout_ms is None:
                page_timeout_ms = _config.get_flag(
                    "model_page_timeout_ms")
            self.page_timeout = float(page_timeout_ms or 0.0) / 1e3
        # per-member in-flight cap: 0 (default) = least-loaded only,
        # members absorb any depth. >0 makes placement a real resource
        # (requests queue AT THE ROUTER when every member is full),
        # which is what gives priority tiers and the placement-wait
        # EWMA something to act on.
        self.member_inflight_limit = int(member_inflight_limit or 0)
        # placement-wait EWMA (the batcher's admission signal, one
        # tier up): an autoscaler reads it as its load-rising input
        self.place_wait_ewma = 0.0
        self._sheds = 0            # router-local sheds (quota refusals)
        self._waiters = {}         # priority -> placement waiters
        self._autoscaler = None    # attached FleetAutoscaler, or None
        if metrics_interval_ms is None:
            metrics_interval_ms = _config.get_flag(
                "fleet_metrics_interval_ms")
        self.metrics_interval = float(metrics_interval_ms or 0.0) / 1e3
        # the aggregator is pure ingest-side state (no threads, no
        # sockets): always constructed, it only grows content when
        # members actually ship snapshots
        self._aggregator = _aggregate.FleetAggregator(
            "f%d" % self._rid, interval_s=self.metrics_interval)
        if slo_target_p99_ms is None:
            slo_target_p99_ms = _config.get_flag("slo_target_p99_ms")
        self.slo = None
        if float(slo_target_p99_ms or 0.0) > 0:
            # the router's SLO view is client-observed: its own
            # submit->resolution histogram plus the shed/deadline
            # counters (NOT the members' server-side latencies)
            self.slo = _slo.SLOTracker(
                label="f%d" % self._rid,
                target_p99_ms=float(slo_target_p99_ms),
                windows=slo_windows,
                source=_slo.local_source(
                    histogram="paddle_fleet_request_ms"))
            if self._tenants:
                # one tracker per NAMED tenant, each reading only its
                # own labeled children — a bursting tenant burns its
                # own budget, the victim's verdict stays green
                for tid, entry in sorted(self._tenants.items()):
                    self._tenant_slos[tid] = _slo.SLOTracker(
                        label=entry.label,
                        target_p99_ms=float(slo_target_p99_ms),
                        windows=slo_windows,
                        source=_slo.labeled_source(
                            histogram="paddle_fleet_tenant_request_ms",
                            bad_counters=(
                                "paddle_serving_tenant_shed_total",
                                "paddle_fleet_tenant_deadline_total"),
                            label="tenant", value=entry.label))
            if self._catalog is not None:
                # one tracker per catalog model (same discipline as
                # the per-tenant slice): /debug/slo answers "which
                # MODEL's p99 is blown" — a paged-out model's churn
                # burns its own budget, its co-resident's stays green
                for model_id in self._catalog.ids():
                    mlabel = "f%d:%s" % (self._rid, model_id)
                    self._model_slos[model_id] = _slo.SLOTracker(
                        label=mlabel,
                        target_p99_ms=float(slo_target_p99_ms),
                        windows=slo_windows,
                        source=_slo.labeled_source(
                            histogram="paddle_fleet_model_request_ms",
                            bad_counters=(
                                "paddle_fleet_model_deadline_total",),
                            label="model", value=mlabel))
        self._members = {}          # member id -> _Member
        self._generation = 0
        self._member_seq = itertools.count()
        self._lock = threading.Lock()
        self._closed = False
        self._canary = None         # member id mid-canary, or None
        self._canary_tick = 0
        self._deploy_lock = threading.Lock()
        self._gauge("generation").set(0)
        self._gauge("live").set(0)
        self._server = _wire.LineServer(
            self._control, host=host, port=port,
            timeout=30.0, name="fleet-router-%d" % self._rid)
        self._monitor_stop = threading.Event()
        self._monitor = None
        if self.heartbeat_timeout > 0:
            self._monitor = threading.Thread(
                target=self._monitor_loop, daemon=True,
                name="fleet-monitor-%d" % self._rid)
            self._monitor.start()
        from ..observability import health as _health
        self._health_name = "fleet%d" % self._rid
        _health.register_health(self._health_name,
                                _router_health(weakref.ref(self)))
        # introspection surfaces (weakref-closed, like health): the
        # merged /metrics view, the /debug/fleet document, the
        # /debug/slo verdict, and the flight-recorder context so a
        # breaker-open bundle carries the fleet state that triggered it
        ref = weakref.ref(self)
        _health.register_provider("metrics", self._health_name,
                                  _router_metrics(ref))
        _health.register_provider("fleet", self._health_name,
                                  _router_fleet(ref))
        if self.slo is not None:
            _health.register_provider("slo", self._health_name,
                                      _router_slo(ref))
        _flight.RECORDER.add_context(self._health_name,
                                     _router_flight_context(ref))

    # -- plumbing ---------------------------------------------------------
    @property
    def addr(self):
        return self._server.addr

    @property
    def generation(self):
        return self._generation

    @property
    def label(self):
        """The router's metric-namespace label ("f<rid>")."""
        return "f%d" % self._rid

    def _gauge(self, which):
        label = "f%d" % self._rid
        fam = _GENERATION if which == "generation" else _MEMBERS_LIVE
        return fam.labels(router=label)

    def _label(self, mid):
        return "f%d:%s" % (self._rid, mid)

    def _live_locked(self):
        return [m for m in self._members.values()
                if m.state in ("live", "draining", "canary")]

    def members_live(self):
        with self._lock:
            return sorted(m.id for m in self._live_locked())

    def member_versions(self):
        with self._lock:
            return {m.id: m.version for m in self._live_locked()}

    def member_loads(self):
        """{member id: inflight} for members in the routing rotation
        (the autoscaler's idle-detection input)."""
        with self._lock:
            return {m.id: m.inflight for m in self._members.values()
                    if m.state in ("live", "canary")}

    def shed_signal(self):
        """Cumulative fleet-wide sheds: router-local quota refusals
        plus the aggregated worker-side shed counter (only non-zero
        when members ship snapshots) — the autoscaler's shed-rate
        input."""
        return float(self._sheds) + self._aggregator.counter_value(
            "paddle_serving_shed_total")

    def attach_autoscaler(self, scaler):
        """Attach (or detach, with None) the capacity controller the
        monitor loop ticks. The router never constructs one — default
        flags construct no autoscaler, and the monitor's gate is one
        attribute-is-None check."""
        self._autoscaler = scaler

    def retire_member(self, mid, drain_timeout=10.0, stop_timeout=5.0):
        """Drain ``mid`` and take it out of the fleet — the scale-down
        path (also an operator verb): stop routing new work to it,
        wait out its in-flight requests, send ``stop`` (a subprocess
        worker's serve_forever unblocks, closes, and unregisters), and
        force-drop if the worker doesn't surrender its lease in time.
        Not a death: no death counter, no flight dump. Returns False
        when the member is unknown or already dead."""
        with self._lock:
            m = self._members.get(mid)
            if m is None or m.state == "dead":
                return False
        self._drain_member(m, drain_timeout)
        self._member_call(m, {"cmd": "stop"}, timeout=stop_timeout)
        deadline = time.monotonic() + stop_timeout
        while time.monotonic() < deadline:
            with self._lock:
                if m.state == "dead":
                    return True
            time.sleep(0.02)
        self._drop_member(mid, reason="retired", death=False)
        return True

    def fleet_doc(self):
        """The ``/debug/fleet`` document: membership, generation,
        per-member breaker/load state, and telemetry snapshot ages in
        one JSON-ready dict."""
        with self._lock:
            members = {}
            for m in self._members.values():
                members[m.id] = {
                    "state": m.state,
                    "version": m.version,
                    "addr": list(m.addr),
                    "joined_generation": m.joined_gen,
                    "inflight": m.inflight,
                    "served": m.served,
                    "failures": m.failures,
                    "breaker": None if m.breaker is None
                    else m.breaker.state,
                }
                if m.residency.models or m.active_model is not None:
                    members[m.id]["residency"] = m.residency.doc()
                    members[m.id]["active_model"] = m.active_model
            doc = {
                "router": "f%d" % self._rid,
                "generation": self._generation,
                "live": len(self._live_locked()),
                "members_min": self.members_min,
                "canary": self._canary,
                "closed": self._closed,
                "members": members,
            }
            if self._tenants is not None:
                doc["tenants"] = {
                    t.id: {"quota": t.quota, "priority": t.priority,
                           "active": t.active, "sheds": t.sheds}
                    for t in self._tenants.values()}
                doc["sheds"] = self._sheds
            if self.member_inflight_limit:
                doc["member_inflight_limit"] = \
                    self.member_inflight_limit
            if self._catalog is not None:
                doc["models"] = self._catalog.doc()
                doc["resident_bytes_budget"] = self.resident_bytes
                doc["paging"] = sorted(self._paging)
        scaler = self._autoscaler
        if scaler is not None:
            doc["autoscale"] = scaler.doc()
        telemetry = self._aggregator.fleet_doc()
        for mid, tstate in telemetry["members"].items():
            members.setdefault(mid, {"state": "retired"})[
                "telemetry"] = tstate
        doc["telemetry"] = {k: v for k, v in telemetry.items()
                            if k != "members"}
        if self.slo is not None:
            doc["slo"] = {"alerting": self.slo.alerting,
                          "violation_seconds":
                          round(self.slo.violation_seconds, 3)}
        return doc

    def wait_members(self, n=None, timeout=30.0):
        """Block until ``n`` members (default ``members_min``) are in
        rotation — the bring-up rendezvous, fleet tier."""
        n = self.members_min if n is None else int(n)
        deadline = time.monotonic() + timeout
        while True:
            live = self.members_live()
            if len(live) >= n:
                return live
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    "fleet rendezvous timed out: %d of %d members "
                    "joined (%r)" % (len(live), n, live))
            time.sleep(0.02)

    # -- membership (control plane) ---------------------------------------
    def _control(self, conn, msg):
        cmd = msg.get("cmd")
        if cmd == "reg":
            conn.send(self._register(msg))
        elif cmd == "hb":
            conn.send(self._heartbeat(msg))
        elif cmd == "unreg":
            conn.send(self._unregister(msg))
        elif cmd == "metrics":
            conn.send(self._ingest_metrics(msg))
        elif cmd == "members":
            with self._lock:
                conn.send({"ok": True, "generation": self._generation,
                           "members": sorted(
                               m.id for m in self._live_locked())})
        else:
            conn.send({"ok": False, "error": "unknown cmd %r" % cmd})

    def _register(self, msg):
        mid = str(msg.get("member"))
        addr = msg.get("addr")
        if not mid or not addr:
            return {"ok": False, "error": "reg needs member and addr"}
        with self._lock:
            if self._closed:
                return {"ok": False, "error": "router closed"}
            cur = self._members.get(mid)
            if cur is not None and cur.state != "dead" \
                    and cur.addr == tuple(addr):
                # re-register (restarted heartbeat / GENMISMATCH
                # recovery): membership unchanged, no bump
                cur.deadline = time.monotonic() + self.heartbeat_timeout
                gen = self._generation
                member = cur
                fresh = False
            else:
                # a genuinely new member (or a dead id returning, or a
                # relocated address — a new process either way) bumps
                # the generation so stale world views are fenced
                self._generation += 1
                gen = self._generation
                member = _Member(mid, addr, gen, self._label(mid),
                                 next(self._member_seq))
                member.deadline = time.monotonic() + \
                    self.heartbeat_timeout
                member.version = msg.get("version")
                if self.breaker_failures:
                    member.breaker = ReplicaBreaker(
                        member.index, self.breaker_failures,
                        self.breaker_cooldown, label=member.label)
                self._members[mid] = member
                fresh = True
            # residency advertisement rides the REG like the version:
            # a model-less worker sends no "models" field at all, so
            # legacy frames stay byte-identical
            if msg.get("models") is not None:
                member.residency.update(msg.get("models"), gen,
                                        self._catalog)
                if msg.get("active_model") is not None:
                    member.active_model = str(msg["active_model"])
                resident_bytes = member.residency.nbytes()
            else:
                resident_bytes = None
            live = len(self._live_locked())
            self._gauge("generation").set(self._generation)
            self._gauge("live").set(live)
        _MEMBER_INFLIGHT.labels(member=member.label).set(
            member.inflight)
        if resident_bytes is not None:
            _paging.RESIDENT_BYTES.labels(member=member.label).set(
                resident_bytes)
        if fresh:
            _log.structured("fleet_member_joined", member=mid,
                            generation=gen, live=live,
                            addr=list(member.addr))
            _rtrace.global_event("fleetMemberJoin", member=mid,
                                 generation=gen)
        return {"ok": True, "generation": gen, "live": live}

    def _heartbeat(self, msg):
        mid = str(msg.get("member"))
        gen = msg.get("generation")
        with self._lock:
            m = self._members.get(mid)
            if m is None or m.state == "dead":
                # a restarted router (or a reaped member): re-register
                return {"ok": False, "genmismatch": self._generation}
            # a GENMISMATCH beat still refreshes liveness (the master's rule:
            # the beat proves the process is alive; the fence only
            # says its world view is stale)
            m.deadline = time.monotonic() + self.heartbeat_timeout
            known = True
            mismatch = gen != self._generation
            generation = self._generation
            # residency rides the beat, fenced by generation exactly
            # like the world view it belongs to: a stale beat's
            # advertisement is ignored (the member re-registers and
            # re-advertises at the current generation)
            resident_bytes = None
            if not mismatch and msg.get("models") is not None:
                m.residency.update(msg.get("models"), generation,
                                   self._catalog)
                if msg.get("active_model") is not None:
                    m.active_model = str(msg["active_model"])
                resident_bytes = m.residency.nbytes()
            label = m.label
        if resident_bytes is not None:
            _paging.RESIDENT_BYTES.labels(member=label).set(
                resident_bytes)
        # piggybacked registry snapshot: ingested outside the router
        # lock (the aggregator has its own), and even on a fenced
        # beat — a stale world view does not stale the numbers
        snap = msg.get("metrics")
        if known and snap is not None:
            try:
                self._aggregator.ingest(mid, msg.get("incarnation"),
                                        snap)
            except ValueError:
                pass  # unreadable snapshot; the beat itself counted
        if mismatch:
            return {"ok": False, "genmismatch": generation}
        return {"ok": True, "generation": generation}

    def _ingest_metrics(self, msg):
        """The standalone ``metrics`` verb: an out-of-band snapshot
        push (a closing worker's final ship, probes, tests)."""
        mid = str(msg.get("member"))
        with self._lock:
            m = self._members.get(mid)
            if m is None:
                return {"ok": False,
                        "error": "unknown member %r" % mid}
        try:
            merged = self._aggregator.ingest(
                mid, msg.get("incarnation"), msg.get("snapshot"))
        except ValueError as exc:
            return {"ok": False, "error": repr(exc)[:200]}
        if m.state == "dead":
            # a final ship from an already-dropped member: the counts
            # land (conservation), the staleness clock stays running
            self._aggregator.mark_dead(mid)
        return {"ok": True, "families": merged}

    def _unregister(self, msg):
        mid = str(msg.get("member"))
        self._drop_member(mid, reason="unregister", death=False)
        return {"ok": True, "generation": self._generation}

    def _monitor_loop(self):
        tick = min(0.5, max(0.01, self.heartbeat_timeout / 4.0))
        while not self._monitor_stop.wait(tick):
            burn = None
            if self.slo is not None:
                # the tracker is pull-based; the membership monitor is
                # its clock (verdict() also ticks, so a pull-only
                # router without a monitor thread still works)
                burn = self.slo.tick()
                for tracker in self._tenant_slos.values():
                    tracker.tick()
                for tracker in self._model_slos.values():
                    tracker.tick()
            scaler = self._autoscaler
            if scaler is not None:
                # the capacity control loop rides the membership
                # monitor (no thread of its own); its spawns/retires
                # run on daemon threads, so a wedged launch can never
                # stall heartbeat reaping
                try:
                    scaler.tick(burn=burn)
                except Exception as exc:
                    _log.structured("autoscale_tick_error",
                                    error=repr(exc)[:200])
            if self.resident_bytes > 0:
                # re-apply eviction pressure to members still over
                # the byte budget: the page-in-time pass skips pinned
                # victims (in-flight requests), so the monitor is
                # where pressure lands once the pins drain
                with self._lock:
                    over = [m for m in self._members.values()
                            if m.state in ("live", "canary") and
                            m.residency.nbytes() > self.resident_bytes]
                for m in over:
                    self._evict_pressure(m)
            now = time.monotonic()
            with self._lock:
                overdue = [m.id for m in self._members.values()
                           if m.state != "dead" and m.deadline
                           is not None and now >= m.deadline]
            for mid in overdue:
                self._drop_member(mid, reason="heartbeat_timeout")

    def _drop_member(self, mid, reason, death=True):
        """Declare ``mid`` dead: bump the generation, retire its
        gauges (the stale-label sweep), and shut its open request
        connections down so blocked request threads fail over NOW
        instead of waiting out their read timeout."""
        with self._lock:
            m = self._members.get(mid)
            if m is None or m.state == "dead":
                return
            m.state = "dead"
            self._generation += 1
            gen = self._generation
            conns = list(m.conns)
            m.conns.clear()
            live = len(self._live_locked())
            self._gauge("generation").set(gen)
            self._gauge("live").set(live)
        if death:
            _DEATHS.inc()
        # telemetry: its snapshot stays, staleness-labeled, for a
        # bounded number of windows (conservation already banked)
        self._aggregator.mark_dead(mid)
        if m.breaker is not None:
            m.breaker.retired = True  # no gauge resurrection
        # stale-label hygiene: every family labelled on this member —
        # breaker health ("replica") and inflight ("member") — retires
        # in one sweep per labelname (the scheduler-close rule)
        _metrics.REGISTRY.remove_labeled("replica", value=m.label)
        _metrics.REGISTRY.remove_labeled("member", value=m.label)
        _log.structured("fleet_member_dropped", member=mid,
                        reason=reason, generation=gen, live=live)
        _rtrace.global_event("fleetMemberDeath", member=mid,
                             reason=reason, generation=gen)
        if death:
            _flight.RECORDER.trigger_async("fleet_member_death",
                                           member=mid, cause=reason)
        for conn in conns:
            conn.close()  # SHUT_RDWR: recv-blocked threads unblock

    # -- request plane ----------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               deadline_ms=None, meta=False, seed=None, tenant=None,
               model=None):
        """Route one generation request over the fleet; returns a
        Future of the generated ids (int64 array), or — with
        ``meta=True`` — of ``{"tokens", "version", "version_start",
        "member", "replays"}`` (the deploy-proof surface: a response
        is served by exactly one weights version). ``seed`` keys a
        sampled decode policy on the members; minted here when None —
        ALWAYS, because the router cannot know which policy members
        run, and an unseeded sampled journal could never re-drive
        bit-identically after a member death.

        ``tenant`` names the submitting tenant: with a tenant table
        armed it is admission-checked against that tenant's quota
        (:class:`TenantQuotaError` when over — ITS traffic sheds, not
        the fleet's) and carried end-to-end on every hop's envelope;
        without a table it rides along for tracing only.

        ``model`` names the catalog model this request targets
        (catalog-armed routers only; defaults to the tenant's catalog
        mapping). The request routes residency-first and demand-pages
        the model onto a member when nobody holds it."""
        if self._closed:
            raise RuntimeError("router is closed")
        if self._catalog is not None:
            if model is not None:
                model = str(model)
                if model not in self._catalog:
                    raise ValueError(
                        "model %r is not in the fleet catalog (%s)"
                        % (model, self._catalog.ids()))
            else:
                model = self._catalog.for_tenant(tenant)
        elif model is not None:
            raise ValueError(
                "submit(model=...) needs a model catalog "
                "(the fleet_models flag or FleetRouter(models=...))")
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        deadline = None
        if deadline_ms:
            budget = float(deadline_ms) / 1e3
            if budget < 0:
                _sres.DEADLINE_EXCEEDED.inc()
                raise ServingDeadlineError(
                    "deadline budget %.1f ms already spent"
                    % float(deadline_ms))
            deadline = time.monotonic() + budget
        req = _FleetRequest(prompt, max_new_tokens, eos_id, deadline,
                            meta,
                            seed=mint_seed() if seed is None else seed,
                            tenant=tenant, model=model)
        if self._tenants is not None:
            req.tenant_entry = self._admit_tenant(req.tenant)
        mint_kw = {}
        if req.tenant is not None:
            mint_kw["tenant"] = req.tenant
        if req.model is not None:
            mint_kw["model"] = req.model
        req.ctx = _rtrace.mint("fleet.submit",
                               prompt_len=int(prompt.size),
                               router=self._rid, **mint_kw)
        _REQUESTS.inc()
        threading.Thread(target=self._serve, args=(req,), daemon=True,
                         name="fleet-request").start()
        return req.future

    def _admit_tenant(self, tenant):
        """Quota admission against the tenant table (table armed ==
        caller guaranteed ``self._tenants is not None``). Unknown
        tenants get a row lazily under the ``"*"`` policy, so every
        tenant is metered whether or not the operator named it.
        Raises :class:`TenantQuotaError` — typed, so callers can tell
        "you are bursting" from "the fleet is full" — and charges the
        shed to THIS tenant's counters plus the fleet-wide shed total
        (a quota refusal IS fleet SLO pressure: it feeds the
        autoscaler's shed-rate signal)."""
        tid = "default" if tenant is None else str(tenant)
        with self._lock:
            entry = self._tenants.get(tid)
            if entry is None:
                quota, priority = self._tenant_default
                entry = _Tenant(tid, quota, priority,
                                "f%d:%s" % (self._rid, tid))
                self._tenants[tid] = entry
            shed = entry.quota > 0 and entry.active >= entry.quota
            if shed:
                entry.sheds += 1
                self._sheds += 1
            else:
                entry.active += 1
                active = entry.active
        if shed:
            _sres.SHED.inc()
            _sres.TENANT_SHED.labels(tenant=entry.label).inc()
            raise TenantQuotaError(
                tid, "tenant %r over its in-flight quota (%d)"
                % (tid, entry.quota))
        _TENANT_ACTIVE.labels(tenant=entry.label).set(active)
        return entry

    def _tenant_done(self, req):
        """Release the admission slot a resolved request held."""
        entry = req.tenant_entry
        if entry is None:
            return
        req.tenant_entry = None
        with self._lock:
            entry.active = max(0, entry.active - 1)
            active = entry.active
        _TENANT_ACTIVE.labels(tenant=entry.label).set(active)

    def _resolve_ok(self, req):
        toks = req.tokens
        if req.eos_id is not None and toks and toks[-1] == req.eos_id:
            toks = toks[:-1]
        e2e = time.perf_counter() - req.t_submit
        _REQUEST_MS.observe(e2e * 1e3)
        if req.tenant_entry is not None:
            _TENANT_REQUEST_MS.labels(
                tenant=req.tenant_entry.label).observe(e2e * 1e3)
        if req.model is not None and self._catalog is not None:
            _paging.MODEL_REQUEST_MS.labels(
                model="f%d:%s" % (self._rid, req.model)).observe(
                e2e * 1e3)
        self._tenant_done(req)
        if req.ctx is not None:
            _rtrace.event(req.ctx, "resolve", tokens=len(toks),
                          member=req.member, replays=req.replays,
                          dur_ms=e2e * 1e3)
        arr = np.asarray(toks, np.int64)
        if req.meta:
            _resolve(req.future, result={
                "tokens": arr, "version": req.version,
                "version_start": req.version_start,
                "member": req.member, "replays": req.replays})
        else:
            _resolve(req.future, result=arr)

    def _resolve_err(self, req, exc):
        if req.tenant_entry is not None and \
                isinstance(exc, ServingDeadlineError):
            # the per-tenant bad count (the global DEADLINE_EXCEEDED
            # was already charged at the expiry site)
            _TENANT_DEADLINE.labels(
                tenant=req.tenant_entry.label).inc()
        if req.model is not None and self._catalog is not None and \
                isinstance(exc, ServingDeadlineError):
            _paging.MODEL_DEADLINE.labels(
                model="f%d:%s" % (self._rid, req.model)).inc()
        self._tenant_done(req)
        if req.ctx is not None:
            _rtrace.event(req.ctx, "resolveError",
                          error=repr(exc)[:200],
                          error_type=type(exc).__name__)
        _resolve(req.future, exception=exc)

    def _serve(self, req):
        last_exc = None
        while True:
            if req.deadline is not None and \
                    time.monotonic() >= req.deadline:
                _sres.DEADLINE_EXCEEDED.inc()
                if req.ctx is not None:
                    _rtrace.event(req.ctx, "deadlineExpired",
                                  replays=req.replays)
                self._resolve_err(req, ServingDeadlineError(
                    "fleet deadline expired after %.1f ms"
                    % ((time.perf_counter() - req.t_submit) * 1e3)))
                return
            # a member died between streaming EOS and its done frame:
            # the journal already ends the generation — serve it
            # without another hop
            if req.eos_id is not None and req.tokens and \
                    req.tokens[-1] == req.eos_id:
                self._resolve_ok(req)
                return
            if req.remaining() == 0:
                self._resolve_ok(req)
                return
            if req.model is not None and self._catalog is not None:
                # residency-or-page-in BEFORE placement — this runs
                # on every loop iteration, so a journal whose model
                # was paged out (or whose only resident member was
                # SIGKILL'd mid-generation) re-pages the model on the
                # target member before the re-drive
                try:
                    if not self._ensure_resident(req):
                        self._resolve_err(req, _paging.PageInError(
                            "model %r could not be paged onto any "
                            "member" % req.model))
                        return
                except ServingDeadlineError as exc:
                    self._resolve_err(req, exc)
                    return
            m = self._acquire_member(req)
            if m is None:
                self._resolve_err(
                    req, last_exc if last_exc is not None
                    else ServingUnavailableError(
                        "no healthy fleet member"))
                return
            try:
                done = self._run_hop(req, m)
            except _VersionRetry:
                # router-side cache staleness, not a member failure:
                # the journal was reset, retry (from the prompt) with
                # no breaker charge and no replay burned
                continue
            except _ModelRetry:
                # the member no longer holds the request's model
                # (evicted between placement and dispatch): correct
                # the residency view and re-drive — _ensure_resident
                # re-pages first. Not a member failure: no breaker
                # charge, no replay burned, but bounded so a
                # pathological member can't spin the loop forever.
                with self._lock:
                    m.residency.drop(req.model)
                    if m.active_model == req.model:
                        m.active_model = None
                req.model_retries += 1
                if req.model_retries > max(3, self.replay_attempts):
                    self._resolve_err(req, _paging.PageInError(
                        "model %r kept vanishing from members that "
                        "advertised it" % req.model))
                    return
                continue
            except Exception as exc:
                # a read past call_timeout is a hang (socket.timeout
                # is TimeoutError): instant breaker open, the engine's rule
                hang = isinstance(exc, TimeoutError)
                self._member_failed(req, m, exc, hang=hang)
                last_exc = exc
                if req.replays >= self.replay_attempts:
                    self._resolve_err(req, exc)
                    return
                req.replays += 1
                req.fail_t = time.perf_counter()
                _FAILOVERS.inc()
                if req.ctx is not None:
                    _rtrace.event(req.ctx, "failoverRequeue",
                                  from_member=m.id,
                                  replays=req.replays,
                                  journal_len=len(req.journal()),
                                  error=repr(exc)[:200])
                continue
            if done:
                return

    # -- model paging -----------------------------------------------------
    def _ensure_resident(self, req):
        """Make ``req.model`` resident on at least one live member,
        demand-paging it when nobody holds it. Returns True once a
        resident member exists (placement affinity takes it from
        there), False when paging failed within its budget.

        Exactly one page-in per model runs fleet-wide at a time: the
        first request through becomes the leader (an Event in
        ``self._paging`` is the election), peers wait on it — a burst
        of cold requests for one model costs one staged load, not a
        stampede of them."""
        model = req.model
        spec = self._catalog.get(model)
        attempts = 0
        budget = self.page_timeout if self.page_timeout > 0 else 30.0
        while True:
            if req.deadline is not None and \
                    time.monotonic() >= req.deadline:
                _sres.DEADLINE_EXCEEDED.inc()
                raise ServingDeadlineError(
                    "deadline expired waiting for model %r to page "
                    "in" % model)
            leader = False
            target = None
            with self._lock:
                if self._closed:
                    return False
                live = [m for m in self._members.values()
                        if m.state in ("live", "canary")]
                # a member this request already FAILED on may still
                # advertise residency (SIGKILL'd but not yet swept by
                # the heartbeat timeout): never count it — affinity
                # must not trap a replay on a corpse
                resident = [m for m in live
                            if m.residency.resident(model) and
                            m.id not in req.failed_on]
                if not req.model_counted:
                    req.model_counted = True
                    (_paging.RESIDENCY_HITS if resident
                     else _paging.RESIDENCY_MISSES).inc()
                if resident:
                    return True
                evt = self._paging.get(model)
                if evt is None:
                    # leader election: page onto the least-loaded
                    # member with no page-in already in flight —
                    # exactly the spawn-target discipline, but the
                    # capacity being added is a weight set, not a
                    # process
                    cands = sorted(
                        (m for m in live if not m.paging),
                        key=lambda m: (m.id in req.failed_on,
                                       m.inflight, m.index))
                    if cands:
                        target = cands[0]
                        target.paging = True
                        evt = threading.Event()
                        self._paging[model] = evt
                        leader = True
            if leader:
                try:
                    ok = self._page_in(target, model, spec)
                finally:
                    with self._lock:
                        target.paging = False
                        evt = self._paging.pop(model, None)
                    if evt is not None:
                        evt.set()
                if ok:
                    self._evict_pressure(target)
                    return True
                attempts += 1
                if attempts >= 2:
                    return False
                continue
            if evt is not None:
                # follower: ride the leader's page-in, then re-check
                evt.wait(budget)
                continue
            # nobody to page onto (no live members / all mid-page):
            # wait out the placement window like _acquire_member does
            attempts += 1
            if attempts >= max(4, int(budget / 0.05)):
                return False
            time.sleep(0.05)

    def _page_in(self, m, model, spec):
        """One demand page-in on ``m``: the worker stages the
        artifact through its swap gates (manifest-verified load ->
        flip), bounded by ``model_page_timeout_ms``. A wedge or
        failure is charged to the autoscaler's spawn-failure budget —
        paging is capacity provisioning, and a wedging artifact must
        halt the control loop before it thrashes the fleet."""
        msg = {"cmd": "page_in", "model": model, "tag": spec.tag}
        if spec.params_path is not None:
            msg["params_path"] = spec.params_path
        if spec.model_dir is not None:
            msg["model_dir"] = spec.model_dir
        timeout = self.page_timeout if self.page_timeout > 0 else 30.0
        t0 = time.perf_counter()
        rep = self._member_call(m, msg, timeout=timeout)
        elapsed = time.perf_counter() - t0
        if rep.get("ok"):
            with self._lock:
                m.residency.add(model, spec.nbytes())
                m.active_model = str(rep.get("model") or model)
                m.version = rep.get("version", m.version)
                resident_bytes = m.residency.nbytes()
            _paging.RESIDENT_BYTES.labels(member=m.label).set(
                resident_bytes)
            _paging.PAGE_INS.labels(outcome="ok").inc()
            _paging.PAGE_IN_MS.observe(elapsed * 1e3)
            _log.structured("fleet_model_paged_in", member=m.id,
                            model=model, ms=round(elapsed * 1e3, 1))
            _rtrace.global_event("fleetModelPageIn", member=m.id,
                                 model=model)
            return True
        outcome = "timeout" if elapsed >= timeout else "fail"
        _paging.PAGE_INS.labels(outcome=outcome).inc()
        _log.structured("fleet_model_page_in_failed", member=m.id,
                        model=model, outcome=outcome,
                        error=str(rep.get("error"))[:200])
        scaler = self._autoscaler
        if scaler is not None:
            # the spawn budget: a wedged/failed page-in spends one
            # spawn failure — enough of them halts provisioning and
            # dumps a flight bundle instead of thrashing
            scaler.charge_failure("page_in")
        return False

    def _evict_pressure(self, m):
        """LRU page-outs until ``m``'s resident-set bytes fit the
        ``member_resident_bytes`` budget. NEVER a model with
        in-flight requests (the pin refcount — an invariant assert,
        not a counter) and never the active model; a fully-pinned
        over-budget set simply stays over budget until something
        drains."""
        if self.resident_bytes <= 0:
            return
        with self._lock:
            protect = ((m.active_model,)
                       if m.active_model is not None else ())
            victims = m.residency.lru_victims(self.resident_bytes,
                                              protect=protect)
        for victim in victims:
            try:
                # the race window under test: between victim
                # selection and the page-out, a request can pin the
                # victim — eviction must re-check, not race
                _faults.fire_point("model_evict_race", index=victim)
            except Exception:
                return  # injected abort: no page-out this round
            with self._lock:
                if victim == m.active_model or \
                        m.residency.pinned(victim) > 0:
                    continue  # pinned since selection: not a victim
                # the eviction invariant, asserted at the last gate
                # before the page-out leaves the router
                assert m.residency.pinned(victim) == 0, \
                    "evicting model %r with in-flight requests" \
                    % victim
                entry = m.residency.models.get(victim)
                nbytes = 0 if entry is None else entry.nbytes
                # drop from the routing view FIRST: from this instant
                # no new request can pin the victim on this member
                m.residency.drop(victim)
            rep = self._member_call(
                m, {"cmd": "page_out", "model": victim}, timeout=10.0)
            if not rep.get("ok"):
                with self._lock:
                    m.residency.add(victim, nbytes)
                continue
            with self._lock:
                resident_bytes = m.residency.nbytes()
            _paging.RESIDENT_BYTES.labels(member=m.label).set(
                resident_bytes)
            _paging.EVICTIONS.inc()
            _log.structured("fleet_model_evicted", member=m.id,
                            model=victim, resident_bytes=resident_bytes)
            _rtrace.global_event("fleetModelEvict", member=m.id,
                                 model=victim)

    def _acquire_member(self, req):
        """A member to dispatch to (inflight already counted), or
        None when nothing can take the request within the placement
        window. Least-loaded among eligible (live, breaker closed —
        or a cooldown-elapsed trial when nothing fitting is closed);
        members this request already failed on are last resort; a
        mid-deploy canary member receives only its traffic fraction.

        With a tenant table armed, placement is priority-tiered: a
        waiter yields while any STRICTLY higher-priority (lower
        number) waiter is queued, so under contention (a per-member
        inflight cap, or every breaker open) the high tier places
        first. No starvation guarantee beyond the waiter's own
        placement/deadline window — that is what priority means here.

        Every acquisition (and every placement timeout) folds its
        wait into ``place_wait_ewma`` — the batcher's queue-wait
        signal one tier up, and the autoscaler's load-rising input."""
        t_enter = time.monotonic()
        deadline = t_enter + self.placement_timeout
        if req.deadline is not None:
            deadline = min(deadline, req.deadline)
        prio = (0 if req.tenant_entry is None
                else req.tenant_entry.priority)
        with self._lock:
            self._waiters[prio] = self._waiters.get(prio, 0) + 1
        try:
            while True:
                if self._closed:
                    return None
                with self._lock:
                    behind = any(
                        p < prio and n > 0
                        for p, n in self._waiters.items())
                    m = None if behind else self._pick_locked(req)
                    if m is not None:
                        m.inflight += 1
                        if req.model is not None:
                            # the in-flight pin: from here to release
                            # this model can NEVER be an eviction
                            # victim on this member (BlockPool's
                            # refcount rule, weight-set sized)
                            m.residency.pin(req.model)
                            m.residency.touch(req.model)
                        _MEMBER_INFLIGHT.labels(member=m.label).set(
                            m.inflight)
                        return m
                    anyone = bool(self._live_locked())
                if self._closed and not anyone:
                    return None
                if time.monotonic() >= deadline:
                    return None
                # a breaker cooldown, a draining member, or a
                # scale-up registration can make someone eligible in
                # finite time
                time.sleep(0.02)
        finally:
            wait = time.monotonic() - t_enter
            with self._lock:
                n = self._waiters.get(prio, 1) - 1
                if n <= 0:
                    self._waiters.pop(prio, None)
                else:
                    self._waiters[prio] = n
                self.place_wait_ewma += _WAIT_ALPHA * (
                    wait - self.place_wait_ewma)

    def _pick_locked(self, req):
        live = [m for m in self._members.values()
                if m.state in ("live", "canary")]
        if self.member_inflight_limit > 0:
            # a full member is simply not a candidate — the request
            # queues at the router (measured by place_wait_ewma)
            # until someone drains or a scale-up joins
            live = [m for m in live
                    if m.inflight < self.member_inflight_limit]
        if not live:
            return None
        if req.model is not None:
            # residency affinity: members already holding the
            # request's model win placement outright (prefix
            # affinity, keyed on model id) — falling back to the full
            # set only when nobody holds it (the hop then pages in on
            # demand or errs kind="model" and re-drives)
            resident = [m for m in live
                        if m.residency.resident(req.model) and
                        m.id not in req.failed_on]
            live = resident or live
        canary = self._canary
        if canary is not None:
            if req.canary is None:
                # one routing decision per request: every k-th live
                # submission is canary-scoped (fraction-approximate,
                # deterministic — no RNG in the dispatch path)
                self._canary_tick += 1
                k = max(1, int(round(1.0 / max(self.canary_fraction,
                                               1e-6))))
                req.canary = (self._canary_tick % k) == 0
            if req.canary and canary not in req.failed_on:
                live = [m for m in live if m.id == canary] or live
            else:
                rest = [m for m in live if m.id != canary]
                live = rest or live
        cands = sorted(live, key=lambda m: (m.id in req.failed_on,
                                            m.inflight, m.index))
        if not cands:
            return None
        now = time.monotonic()
        # a cooldown-elapsed open breaker gets THIS request as its
        # trial even while healthy members exist — there is no
        # background prober at the fleet tier, so live traffic is how
        # an open member re-enters rotation (at most one trial per
        # cooldown window: a failed trial re-opens with a fresh one).
        # Never a request that already failed there.
        for m in cands:
            b = m.breaker
            if b is not None and b.state == "open" \
                    and b.ready_to_probe(now) \
                    and m.id not in req.failed_on:
                b.to_half_open()  # the dispatch IS the trial
                return m
        for m in cands:
            if m.breaker is None or m.breaker.state == "closed":
                return m
        for m in cands:
            if m.breaker.state == "half_open":
                return m  # nothing closed: trial traffic rides along
        return None

    def _release_member(self, m, model=None):
        with self._lock:
            m.inflight = max(0, m.inflight - 1)
            if model is not None:
                m.residency.unpin(model)
            inflight = m.inflight
            dead = m.state == "dead"
        if not dead:
            _MEMBER_INFLIGHT.labels(member=m.label).set(inflight)

    def _member_failed(self, req, m, exc, hang=False):
        b = m.breaker
        if b is not None:
            was_trial = b.state == "half_open"
            if hang or was_trial or not req.charged:
                # at most one charge per request across its replays —
                # a poison prompt cannot black out the fleet;
                # hangs and trial failures always record
                b.record_failure(hang=hang)
                req.charged = True
        req.failed_on.add(m.id)
        req.canary = False  # a failed canary pin replays on the stable set
        with self._lock:
            m.failures += 1
        _log.structured("fleet_member_failed", member=m.id,
                        error=repr(exc)[:200], hang=hang,
                        replays=req.replays)

    def _run_hop(self, req, m):
        """One dispatch to ``m``: stream tokens into the journal until
        done. Returns True when the request was RESOLVED (success or a
        client-shaped error); raises on member failure (failover
        material). The inflight count is released either way."""
        try:
            _faults.fire_point("fleet_network_partition", index=m.id,
                               default_exc=ConnectionError)
            # when the hop names a model the member holds but isn't
            # serving, the worker activates it before acking — the
            # cached version/model say nothing about THIS hop, so the
            # pre-hop fences stand down and the ack checks decide
            will_activate = (req.model is not None and
                             m.active_model is not None and
                             m.active_model != req.model)
            if req.tokens and req.tokens_model is not None and \
                    req.model is None and \
                    m.active_model is not None and \
                    req.tokens_model != m.active_model:
                # the model fence, cached side: a journal generated
                # on one model must never splice onto another — a
                # two-model fleet serving model-less requests resets
                # here instead of mixing models in one response
                _JOURNAL_RESETS.labels(reason="model").inc()
                if req.ctx is not None:
                    _rtrace.event(req.ctx, "journalReset",
                                  from_model=req.tokens_model,
                                  to_model=m.active_model,
                                  discarded=len(req.tokens))
                req.tokens = []
            if req.tokens and not will_activate and \
                    req.tokens_version != m.version:
                # the journal was generated under different weights:
                # re-driving it here would splice two versions into
                # one response. Discard and restart from the prompt —
                # determinism makes the restart exact, versioning
                # makes it honest.
                _JOURNAL_RESETS.labels(reason="version").inc()
                if req.ctx is not None:
                    _rtrace.event(req.ctx, "journalReset",
                                  from_version=req.tokens_version,
                                  to_version=m.version,
                                  discarded=len(req.tokens))
                req.tokens = []
            if req.tokens and m.policy is not None and \
                    req.tokens_policy != m.policy:
                # same rule, decode semantics instead of weights: a
                # journal minted under one decode policy must never
                # resume under another (a greedy prefix spliced onto
                # a sampled continuation is neither policy's answer).
                # m.policy None = member never acked yet; the ack
                # recheck below covers that hop.
                _JOURNAL_RESETS.labels(reason="policy").inc()
                if req.ctx is not None:
                    _rtrace.event(req.ctx, "journalReset",
                                  from_policy=req.tokens_policy,
                                  to_policy=m.policy,
                                  discarded=len(req.tokens))
                req.tokens = []
            gen_at_dispatch = self._generation
            hop_span = None
            if req.ctx is not None:
                hop_span = _rtrace.event(
                    req.ctx, "fleetHop", member=m.id,
                    generation=gen_at_dispatch, attempt=req.replays,
                    journal_len=len(req.journal()))
            conn = _wire.LineConn.connect(m.addr,
                                          timeout=self.connect_timeout)
            conn.settimeout(self.call_timeout)
            with self._lock:
                if m.state == "dead":
                    conn.close()
                    raise _MemberError("member %s died before "
                                       "dispatch" % m.id)
                m.conns.add(conn)
            try:
                remaining_ms = None
                if req.deadline is not None:
                    remaining_ms = max(
                        1.0, (req.deadline - time.monotonic()) * 1e3)
                env = {"cmd": "generate",
                       "prompt": req.journal(),
                       "max_new": req.remaining(),
                       "eos_id": req.eos_id,
                       "seed": req.seed,
                       "deadline_ms": remaining_ms,
                       "trace_id": None if req.ctx is None
                       else req.ctx.trace_id}
                if req.tenant is not None:
                    # the tenant rides every hop like the seed: a
                    # replay lands on the peer still attributed to
                    # its tenant (worker-side sheds, traces)
                    env["tenant"] = req.tenant
                if req.model is not None:
                    # the model rides every hop too: the worker
                    # activates it (resident) or refuses the hop
                    # (kind="model" -> re-page and re-drive) — a
                    # journal never lands on the wrong weights
                    env["model"] = req.model
                conn.send(env)
                hop_start = len(req.tokens)
                ack_model = None
                while True:
                    msg = conn.recv()
                    if msg is None:
                        raise _MemberError(
                            "member %s closed mid-request (journal "
                            "at %d tokens)" % (m.id, len(req.tokens)))
                    ev = msg.get("ev")
                    if ev == "ack":
                        # the version this (possibly replay) hop
                        # STARTS under; the done frame must match it
                        # — the exactly-one-version proof surface
                        ack_version = msg.get("version")
                        ack_policy = msg.get("policy",
                                             GREEDY_FINGERPRINT)
                        ack_model = msg.get("model")
                        req.version_start = ack_version
                        if req.eos_id is None and \
                                msg.get("eos_id") is not None:
                            req.eos_id = int(msg["eos_id"])
                        with self._lock:
                            m.version = ack_version or m.version
                            m.policy = ack_policy or m.policy
                            if ack_model is not None:
                                m.active_model = str(ack_model)
                                if m.residency.resident(ack_model):
                                    m.residency.touch(ack_model)
                                else:
                                    nb = 0
                                    if self._catalog is not None and \
                                            str(ack_model) in \
                                            self._catalog:
                                        nb = self._catalog.get(
                                            ack_model).nbytes()
                                    m.residency.add(ack_model, nb)
                        if req.tokens and \
                                req.tokens_model is not None and \
                                ack_model is not None and \
                                req.tokens_model != str(ack_model):
                            # the model fence, authoritative side:
                            # the ack names the model this hop will
                            # actually decode under. A journal from
                            # another model is discarded BEFORE any
                            # of this hop's tokens land — counted
                            # under reason="model", and the request
                            # restarts from the prompt.
                            _JOURNAL_RESETS.labels(
                                reason="model").inc()
                            if req.ctx is not None:
                                _rtrace.event(
                                    req.ctx, "journalReset",
                                    from_model=req.tokens_model,
                                    to_model=str(ack_model),
                                    discarded=len(req.tokens),
                                    at="ack")
                            del req.tokens[:]
                            raise _VersionRetry()
                        if req.tokens and \
                                req.tokens_policy != ack_policy:
                            # the authoritative decode-policy check:
                            # the cached check above can miss a
                            # member whose policy the router never
                            # learned (fresh join, restart). Same
                            # abandon-and-retry as a version skew —
                            # no spliced-policy response, ever.
                            _JOURNAL_RESETS.labels(
                                reason="policy").inc()
                            if req.ctx is not None:
                                _rtrace.event(
                                    req.ctx, "journalReset",
                                    from_policy=req.tokens_policy,
                                    to_policy=ack_policy,
                                    discarded=len(req.tokens),
                                    at="ack")
                            del req.tokens[:]
                            raise _VersionRetry()
                        if req.tokens and \
                                req.tokens_version != ack_version:
                            # the pre-hop check used the router's
                            # CACHED member version; the ack is
                            # authoritative (an out-of-band swap can
                            # stale the cache). The journal already
                            # went out under the wrong assumption —
                            # abandon the hop before any of its
                            # tokens land and retry from the prompt:
                            # a mixed-version response is never
                            # served, whoever swapped the member.
                            _JOURNAL_RESETS.labels(
                                reason="version").inc()
                            if req.ctx is not None:
                                _rtrace.event(
                                    req.ctx, "journalReset",
                                    from_version=req.tokens_version,
                                    to_version=ack_version,
                                    discarded=len(req.tokens),
                                    at="ack")
                            del req.tokens[:]
                            raise _VersionRetry()
                        if req.ctx is not None:
                            _rtrace.event(req.ctx, "memberRecv",
                                          parent=hop_span,
                                          member=msg.get("member"),
                                          pid=msg.get("pid"),
                                          version=msg.get("version"))
                    elif ev == "tok":
                        if req.fail_t is not None:
                            # kill-to-first-replayed-token: the fleet
                            # recovery number
                            _RECOVERY_SECONDS.observe(
                                time.perf_counter() - req.fail_t)
                            req.fail_t = None
                        req.tokens.append(int(msg["t"]))
                        req.tokens_version = m.version
                        req.tokens_policy = m.policy
                        req.tokens_model = (str(ack_model)
                                            if ack_model is not None
                                            else req.model)
                    elif ev == "done":
                        with self._lock:
                            fenced = m.state == "dead"
                        if fenced:
                            # the member was declared dead while this
                            # reply was in flight (partition healed):
                            # a dead member's word is never trusted —
                            # its streamed tokens go with it, and the
                            # request re-drives on a live peer (greedy
                            # determinism makes the re-drive exact)
                            del req.tokens[hop_start:]
                            _FENCED.inc()
                            if req.ctx is not None:
                                _rtrace.event(req.ctx, "fencedReply",
                                              member=m.id)
                            raise _MemberError(
                                "stale reply from dead member %s "
                                "fenced" % m.id)
                        # the done frame is authoritative for this
                        # hop's tokens (the stream includes an EOS the
                        # scheduler then strips; done does not)
                        req.tokens[hop_start:] = [
                            int(t) for t in msg.get("tokens", ())]
                        req.version = msg.get("version", m.version)
                        req.member = m.id
                        req.tokens_version = req.version
                        req.tokens_policy = m.policy
                        req.tokens_model = (str(ack_model)
                                            if ack_model is not None
                                            else req.model)
                        with self._lock:
                            m.served += 1
                            m.version = req.version
                        if m.breaker is not None:
                            m.breaker.record_success()
                        self._resolve_ok(req)
                        return True
                    elif ev == "err":
                        kind = msg.get("kind")
                        if kind == "deadline":
                            # the worker's deadline check fired: same
                            # condition, same exception type and
                            # counter as a router-side expiry
                            _sres.DEADLINE_EXCEEDED.inc()
                            if req.ctx is not None:
                                _rtrace.event(req.ctx,
                                              "deadlineExpired",
                                              where="member",
                                              member=m.id)
                            self._resolve_err(
                                req, ServingDeadlineError(
                                    msg.get("error", "")))
                            return True
                        if kind == "client":
                            # the request's fault (bucket/length):
                            # never charges the member, never replays
                            self._resolve_err(
                                req, ValueError(msg.get("error", "")))
                            return True
                        if kind == "model":
                            # the model isn't resident there after
                            # all (evicted between placement and
                            # dispatch): not a member failure — the
                            # serve loop re-pages and re-drives
                            raise _ModelRetry(msg.get("error", ""))
                        raise _MemberError(
                            "member %s failed the request: %s"
                            % (m.id, msg.get("error", "")))
            finally:
                with self._lock:
                    m.conns.discard(conn)
                conn.close()
        finally:
            self._release_member(m, req.model)

    # -- rolling deploy ---------------------------------------------------
    def _drain_member(self, m, timeout):
        with self._lock:
            if m.state == "dead":
                return False
            m.state = "draining"
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if m.state == "dead":
                    return False
                if m.inflight == 0:
                    return True
            time.sleep(0.01)
        return False

    def _member_call(self, m, msg, timeout=60.0):
        try:
            return _wire.call_once(m.addr, msg, timeout=timeout,
                                   retries=1)
        except (ConnectionError, OSError, _wire.WireError) as exc:
            return {"ok": False, "error": repr(exc)[:200]}

    def _rollback_members(self, mids, drain_timeout):
        _ROLLBACKS.inc()
        restored = []
        for mid in reversed(mids):
            with self._lock:
                m = self._members.get(mid)
            if m is None or m.state == "dead":
                continue
            self._drain_member(m, drain_timeout)
            rep = self._member_call(m, {"cmd": "rollback"})
            with self._lock:
                if m.state != "dead":
                    m.state = "live"
                    if rep.get("ok"):
                        m.version = rep.get("version", m.version)
            if rep.get("ok"):
                restored.append(mid)
                if m.breaker is not None and not m.breaker.retired:
                    # the rollback restored the version that was
                    # serving fine — failures charged to the bad push
                    # must not keep the healed member benched for a
                    # full cooldown
                    m.breaker.record_success()
            _log.structured("fleet_member_rolled_back", member=mid,
                            ok=bool(rep.get("ok")))
        return restored

    def rolling_deploy(self, params_path=None, tag=None,
                       model_dir=None, canary_requests=6,
                       watch_failures=2, watch_timeout=30.0,
                       drain_timeout=30.0, swap_timeout=120.0,
                       model_id=None):
        """Roll a weights push through the fleet, one member at a
        time: drain -> swap (the worker's swap gates apply) ->
        canary-scope ``canary_fraction`` of live traffic to it ->
        watch. ``watch_failures`` member-level failures during the
        watch (clients see none — canary failures replay onto stable
        members) roll the WHOLE fleet back to the prior version and
        abort. Returns a result dict; ``rolled_back`` tells the story.

        ``params_path`` (an ``.npz`` of {name: array}) feeds
        generation-scheduler workers; ``model_dir`` feeds stateless
        engine workers (``ServingEngine.swap_weights``).

        ``model_id`` scopes the deploy to one catalog model: only
        members RESIDENT for that model drain/swap/canary (each
        activates the model before applying the push), and other
        models' traffic rides on untouched — a multi-model fleet
        deploys one model without draining the others' members."""
        if not self._deploy_lock.acquire(blocking=False):
            raise RuntimeError("a rolling deploy is already running")
        try:
            model_id = None if model_id is None else str(model_id)
            with self._lock:
                order = sorted(
                    m.id for m in self._members.values()
                    if m.state == "live" and
                    (model_id is None or
                     m.residency.resident(model_id) or
                     m.active_model == model_id))
            if not order:
                return {"ok": False, "reason": "no live members"
                        if model_id is None else
                        "no live members resident for model %r"
                        % model_id,
                        "rolled_back": False, "swapped": []}
            swapped = []
            swap_msg = {"cmd": "swap", "tag": tag}
            if params_path is not None:
                swap_msg["params_path"] = str(params_path)
            if model_dir is not None:
                swap_msg["model_dir"] = str(model_dir)
            if model_id is not None:
                swap_msg["model"] = model_id
            _log.structured("fleet_deploy_start", tag=tag,
                            members=order, model=model_id)
            for mid in order:
                with self._lock:
                    m = self._members.get(mid)
                if m is None or m.state == "dead":
                    continue  # died mid-deploy: the survivors roll on
                if not self._drain_member(m, drain_timeout):
                    self._rollback_members(swapped, drain_timeout)
                    _DEPLOYS.labels(outcome="rolled_back").inc()
                    return {"ok": False, "rolled_back": True,
                            "reason": "drain timeout on %s" % mid,
                            "failed_member": mid, "swapped": swapped}
                rep = self._member_call(m, swap_msg,
                                        timeout=swap_timeout)
                if not rep.get("ok"):
                    with self._lock:
                        if m.state == "draining":
                            m.state = "live"
                    self._rollback_members(swapped, drain_timeout)
                    _DEPLOYS.labels(outcome="rolled_back").inc()
                    return {"ok": False, "rolled_back": True,
                            "reason": "swap rejected on %s: %s"
                            % (mid, rep.get("error")),
                            "failed_member": mid, "swapped": swapped}
                with self._lock:
                    m.version = rep.get("version", tag)
                    m.served = 0
                    m.failures = 0
                    m.state = "canary"
                    self._canary = mid
                    if model_id is not None:
                        # the worker activated model_id to apply the
                        # push — the router's view follows
                        m.active_model = model_id
                        m.residency.touch(model_id)
                swapped.append(mid)
                ok = self._watch_canary(m, canary_requests,
                                        watch_failures, watch_timeout)
                with self._lock:
                    self._canary = None
                    if m.state == "canary":
                        m.state = "live"
                if not ok:
                    self._rollback_members(swapped, drain_timeout)
                    _DEPLOYS.labels(outcome="rolled_back").inc()
                    _log.structured("fleet_deploy_rolled_back",
                                    tag=tag, failed_member=mid)
                    _flight.RECORDER.trigger_async(
                        "fleet_deploy_rollback", tag=str(tag),
                        member=mid)
                    return {"ok": False, "rolled_back": True,
                            "reason": "canary watch failed on %s"
                            % mid,
                            "failed_member": mid, "swapped": swapped}
            _DEPLOYS.labels(outcome="committed").inc()
            if model_id is not None and self._catalog is not None \
                    and tag is not None and \
                    model_id in self._catalog:
                # future page-ins of this model must land the pushed
                # version, not the pre-deploy artifact's tag
                self._catalog.get(model_id).tag = str(tag)
                if params_path is not None:
                    self._catalog.get(model_id).params_path = \
                        str(params_path)
                if model_dir is not None:
                    self._catalog.get(model_id).model_dir = \
                        str(model_dir)
            _log.structured("fleet_deploy_committed", tag=tag,
                            members=swapped)
            return {"ok": True, "rolled_back": False, "version": tag,
                    "swapped": swapped}
        finally:
            self._deploy_lock.release()

    def _watch_canary(self, m, canary_requests, watch_failures,
                      watch_timeout):
        """Watch the freshly-swapped member take its canary share:
        fail on ``watch_failures`` member-level failures (or its
        death), pass once ``canary_requests`` completions land — or
        at the watch timeout with zero failures (a quiet fleet can't
        prove more than 'nothing broke')."""
        deadline = time.monotonic() + watch_timeout
        while True:
            with self._lock:
                dead = m.state == "dead"
                served, failures = m.served, m.failures
            if dead or failures >= max(1, int(watch_failures)):
                return False
            if served >= int(canary_requests):
                return True
            if time.monotonic() >= deadline:
                return failures == 0
            time.sleep(0.02)

    # -- shutdown ---------------------------------------------------------
    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns = [c for m in self._members.values()
                     for c in m.conns]
            for m in self._members.values():
                m.conns.clear()
                if m.breaker is not None:
                    m.breaker.retired = True
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
        self._server.close()
        for conn in conns:
            conn.close()
        # router-namespace gauge sweep: every member-labelled child
        # ("f<rid>:*") across every family, plus the router's own
        # gauges — redeploy cycles must not accumulate stale labels
        prefix = "f%d:" % self._rid
        _metrics.REGISTRY.remove_labeled("replica", prefix=prefix)
        _metrics.REGISTRY.remove_labeled("member", prefix=prefix)
        _metrics.REGISTRY.remove_labeled("router",
                                         value="f%d" % self._rid)
        if self.slo is not None:
            self.slo.close()
        for tracker in self._tenant_slos.values():
            tracker.close()
        self._tenant_slos = {}
        for tracker in self._model_slos.values():
            tracker.close()
        self._model_slos = {}
        if self._tenants is not None:
            # per-tenant children share the router's label namespace
            _metrics.REGISTRY.remove_labeled("tenant", prefix=prefix)
        if self._catalog is not None:
            # per-model children share it too
            _metrics.REGISTRY.remove_labeled("model", prefix=prefix)
        scaler = self._autoscaler
        if scaler is not None:
            scaler.close()   # detaches itself; reaps pending spawns
        from ..observability import health as _health
        _health.unregister_health(self._health_name)
        for kind in ("metrics", "fleet", "slo"):
            _health.unregister_provider(kind, self._health_name)
        _flight.RECORDER.remove_context(self._health_name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _router_health(ref):
    def snapshot():
        router = ref()
        if router is None:
            return None
        with router._lock:
            members = {
                m.id: {"state": m.state, "version": m.version,
                       "inflight": m.inflight,
                       "breaker": None if m.breaker is None
                       else m.breaker.state}
                for m in router._members.values()}
            live = [m for m in router._members.values()
                    if m.state in ("live", "draining", "canary")]
            healthy_members = [
                m for m in live
                if m.breaker is None or m.breaker.state != "open"]
            return {"healthy": not router._closed and
                    len(healthy_members) >= router.members_min,
                    "generation": router._generation,
                    "live": len(live), "members": members}
    return snapshot


def _router_metrics(ref):
    """The /metrics provider: the fleet-merged exposition (or one
    member's drill-down; "" for an unknown member — None is reserved
    for "router gone", the lazy-unregister signal)."""
    def provider(member=None):
        router = ref()
        if router is None:
            return None
        text = router._aggregator.merged_text(member)
        if member and text is None:
            return ""
        return text
    return provider


def _router_fleet(ref):
    def provider():
        router = ref()
        return None if router is None else router.fleet_doc()
    return provider


def _router_slo(ref):
    def provider():
        router = ref()
        if router is None or router.slo is None:
            return None
        doc = router.slo.verdict()
        if router._tenant_slos:
            # per-tenant verdicts alongside the fleet one: /debug/slo
            # answers "whose p99 is blown" — the burster's, not the
            # victim's
            doc["tenants"] = {
                tid: tracker.verdict() for tid, tracker
                in sorted(router._tenant_slos.items())}
        if router._model_slos:
            # per-model verdicts too: paging churn on one model must
            # not paint its co-resident's verdict red
            doc["models"] = {
                model_id: tracker.verdict() for model_id, tracker
                in sorted(router._model_slos.items())}
        return doc
    return provider


def _router_flight_context(ref):
    """Flight-recorder context: a breaker-open / client-error bundle
    dumped at the router carries the fleet membership + SLO state
    that surrounded it."""
    def context():
        router = ref()
        if router is None:
            return None
        doc = {"fleet": router.fleet_doc()}
        if router.slo is not None:
            doc["slo"] = router.slo.verdict()
        return doc
    return context


def _load_npz(path):
    """{name: array} of an ``.npz`` weights artifact, read whole and the
    file closed (a push or a page-in payload)."""
    with np.load(path) as data:
        return {k: np.asarray(v) for k, v in data.items()}


class EngineWorker:
    """One fleet member: serves a local backend over the JSON-line
    wire and keeps its membership lease with the router.

    ``backend`` is a :class:`GenerationScheduler` (``generate``
    requests, token streaming, ``.npz`` weight swaps with host-side
    rollback snapshots) or a :class:`ServingEngine` (stateless
    ``run`` requests, ``model_dir`` swaps through the engine's gates).
    With ``router_addr`` set, the worker registers and heartbeats
    every ``heartbeat_ms`` (default: the ``fleet_heartbeat_ms`` flag)
    on a daemon thread — a ``genmismatch`` reply re-registers, a
    connection error is absorbed (the router may be restarting).
    ``fail_after_swap_tag`` is the chaos hook for deploy tests: a
    swap landing that tag arms a persistent ``generation_step_fail``
    (the stand-in for a broken weights push), disarmed again by the
    rollback that restores the prior version.

    ``model`` names the catalog model this worker starts resident
    for (multi-model fleets). A model-named worker advertises
    its resident set + active model on REG and every heartbeat,
    answers ``page_in`` (manifest-verified staged load through the
    swap gates; the paged model becomes active) and ``page_out``
    (drops a non-active resident model's host snapshot), activates
    the model a ``generate`` envelope names (resident -> fast swap
    from the host snapshot; non-resident -> ``kind="model"`` error,
    the router re-pages and re-drives), and acks the model id — the
    router's third journal fence. ``model=None`` (default) sends
    none of these fields: legacy frames stay byte-identical.
    """

    def __init__(self, backend, host="127.0.0.1", port=0,
                 member_id=None, router_addr=None, heartbeat_ms=None,
                 version="v0", fail_after_swap_tag=None,
                 autostart=True, metrics_interval_ms=None,
                 model=None):
        self.backend = backend
        self._kind = ("generation" if hasattr(backend, "sessions")
                      else "engine")
        # the decode-policy fingerprint this member acks with: the
        # router gates journal reuse on it exactly as it gates on the
        # weights version. Computed once — the policy is immutable
        # for the scheduler's lifetime.
        fp = getattr(backend, "policy_fingerprint", None)
        self._policy_fp = fp() if callable(fp) else GREEDY_FINGERPRINT
        # seed forwarding is signature-gated: the router mints a seed
        # on EVERY request (it can't know member policies), but a
        # backend whose submit() predates decode policies (engines,
        # test fakes) must keep working untouched.
        try:
            params = inspect.signature(backend.submit).parameters
            self._accepts_seed = "seed" in params
            # tenant forwarding is gated the same way: a backend that
            # understands tenants gets the envelope's id (worker-side
            # shed attribution), older backends keep working untouched
            self._accepts_tenant = "tenant" in params
        except (TypeError, ValueError, AttributeError):
            self._accepts_seed = False
            self._accepts_tenant = False
        if self._kind == "engine":
            # the pre-deploy artifact dir IS the first swap's
            # rollback target — without it a failed first push has
            # nothing to roll back to
            self._cur_dir = getattr(backend, "model_dir", None)
        self.member_id = member_id or "w-%d" % os.getpid()
        self.router_addr = (tuple(router_addr)
                            if router_addr is not None else None)
        if heartbeat_ms is None:
            heartbeat_ms = _config.get_flag("fleet_heartbeat_ms")
        self.heartbeat = float(heartbeat_ms) / 1e3
        if metrics_interval_ms is None:
            metrics_interval_ms = _config.get_flag(
                "fleet_metrics_interval_ms")
        self.metrics_interval = float(metrics_interval_ms or 0.0) / 1e3
        # the delta-accounting identity: a restarted process carries a
        # fresh incarnation, so its zeroed totals re-base instead of
        # double-counting or regressing the fleet accumulators
        self.incarnation = "%d-%d" % (os.getpid(),
                                      next(_WORKER_INCARNATION_SEQ))
        self._next_ship = 0.0      # monotonic; 0 = first beat ships
        self.version = str(version)
        self.fail_after_swap_tag = fail_after_swap_tag
        self._prev = None          # (version, params/model_dir) snapshot
        self._armed_bad = False
        self._swap_lock = threading.Lock()
        # in-flight generation streams: a model activation (page-in,
        # demand activation, model-scoped deploy) drains this count
        # to zero under _swap_lock before swapping weights, so no
        # stream ever finishes its tokens on another model's weights
        self._gen_cv = threading.Condition()
        self._gen_active = 0
        # multi-model residency: model id -> {"tag",
        # "params" (host snapshot, generation kind; None while the
        # weights live only in the scope), "model_dir" (engine
        # kind)}. The ACTIVE model's weights are in the backend; a
        # paged-but-inactive model is a host-side snapshot waiting
        # for a fast activation swap.
        self.model = None if model is None else str(model)
        self._resident = {}
        if self.model is not None:
            self._resident[self.model] = {
                "tag": self.version, "params": None,
                "model_dir": getattr(self, "_cur_dir", None)}
        self.generation = 0
        self._host, self._port = host, port
        self._server = None
        self._hb_stop = threading.Event()
        self._hb_thread = None
        self._stop_evt = threading.Event()
        if autostart:
            self.start()

    @property
    def addr(self):
        return self._server.addr

    def start(self):
        if self._server is not None:
            return self
        self._server = _wire.LineServer(
            self._handle, host=self._host, port=self._port,
            timeout=None, name="fleet-worker-%s" % self.member_id)
        if self.router_addr is not None:
            try:
                self._register()
            except BaseException:
                # a refused/unreachable registration must not leak
                # the accept thread + bound socket out of a failed
                # constructor (autostart callers never get a handle
                # to close)
                self._server.close()
                self._server = None
                raise
            self._hb_thread = threading.Thread(
                target=self._hb_loop, daemon=True,
                name="fleet-hb-%s" % self.member_id)
            self._hb_thread.start()
        return self

    # -- membership -------------------------------------------------------
    def _residency_fields(self, msg):
        """Stamp the residency advertisement onto a REG/HB frame —
        only for model-named workers, so legacy frames stay
        byte-identical. Lock-free on purpose (the heartbeat must
        never stall behind a long page-in): a beat that races a
        mutation just skips the fields until the next one."""
        if self.model is None:
            return msg
        try:
            msg["models"] = sorted(self._resident)
            msg["active_model"] = self.model
        except RuntimeError:
            pass  # resident set mutating mid-iteration: next beat
        return msg

    def _register(self):
        rep = _wire.call_once(
            self.router_addr,
            self._residency_fields(
                {"cmd": "reg", "member": self.member_id,
                 "addr": list(self.addr), "version": self.version}),
            timeout=5.0, retries=5)
        if not rep.get("ok"):
            raise RuntimeError("fleet registration refused: %r" % rep)
        self.generation = int(rep["generation"])
        return self.generation

    def _hb_loop(self):
        beats = 0
        while not self._hb_stop.wait(self.heartbeat):
            beats += 1
            if _faults.should_fire("fleet_network_partition",
                                   self.member_id):
                continue  # injected partition: the beat never leaves
            msg = self._residency_fields(
                {"cmd": "hb", "member": self.member_id,
                 "generation": self.generation})
            if self.metrics_interval > 0:
                now = time.monotonic()
                if now >= self._next_ship:
                    # piggyback a registry snapshot, bounded so the
                    # frame NEVER breaches MAX_LINE — an oversize
                    # registry degrades the snapshot, not the beat
                    msg["metrics"] = _aggregate.build_snapshot(
                        max_bytes=_wire.MAX_LINE - 1024)
                    msg["incarnation"] = self.incarnation
                    self._next_ship = now + self.metrics_interval
            try:
                rep = _wire.call_once(self.router_addr, msg,
                                      timeout=2.0, retries=1)
            except (ConnectionError, OSError, _wire.WireError):
                continue  # router restarting/unreachable: keep beating
            if rep.get("ok"):
                continue
            if rep.get("genmismatch") is not None:
                # the fleet resized (or a restarted router forgot us):
                # re-register at the current generation
                try:
                    self._register()
                except (RuntimeError, ConnectionError, OSError):
                    pass

    # -- the wire ---------------------------------------------------------
    def _handle(self, conn, msg):
        cmd = msg.get("cmd")
        if cmd == "generate":
            return self._handle_generate(conn, msg)
        if cmd == "run":
            return self._handle_run(conn, msg)
        if cmd == "swap":
            conn.send(self._handle_swap(msg))
        elif cmd == "page_in":
            conn.send(self._handle_page_in(msg))
        elif cmd == "page_out":
            conn.send(self._handle_page_out(msg))
        elif cmd == "rollback":
            conn.send(self._handle_rollback())
        elif cmd == "health":
            rep = {"ok": True, "member": self.member_id,
                   "version": self.version, "pid": os.getpid()}
            if self.model is not None:
                rep["model"] = self.model
                rep["models"] = sorted(self._resident)
            conn.send(rep)
        elif cmd == "stop":
            conn.send({"ok": True})
            self._stop_evt.set()
        else:
            conn.send({"ok": False, "error": "unknown cmd %r" % cmd})

    def _handle_generate(self, conn, msg):
        # the slow-member site fires before ANY reply leaves — a
        # wedged member is silent, not chatty
        _faults.fire_point("fleet_slow_member", index=self.member_id)
        if self._kind != "generation":
            conn.send({"ev": "err", "kind": "client",
                       "error": "this member serves a stateless "
                       "engine — use cmd=run"})
            return
        trace_id = msg.get("trace_id")
        # adopt the ROUTER's trace id (wire propagation): when this
        # process has tracing armed, its own store grows the same
        # tree; either way the ack below carries the memberRecv info
        # back for the router's tree
        ctx = _rtrace.adopt(trace_id, "fleet.memberServe",
                            member=self.member_id) \
            if trace_id else None
        if ctx is not None:
            _rtrace.event(ctx, "memberRecv", member=self.member_id,
                          pid=os.getpid(), version=self.version)
        env_model = msg.get("model")
        with self._swap_lock:
            if env_model is not None:
                env_model = str(env_model)
                if env_model != self.model:
                    if env_model not in self._resident:
                        # paged out between the router's placement
                        # and this dispatch (the evict race): refuse
                        # — the router re-pages and re-drives, never
                        # decodes on the wrong weights
                        conn.send({
                            "ev": "err", "kind": "model",
                            "error": "model %r not resident on %s "
                            "(resident: %s)" % (
                                env_model, self.member_id,
                                sorted(self._resident))})
                        return
                    try:
                        # demand activation: fast swap from the host
                        # snapshot, through the same gates a deploy
                        # push takes
                        self._activate_locked(env_model)
                    except Exception as exc:
                        conn.send({"ev": "err", "kind": "model",
                                   "error": repr(exc)[:300]})
                        return
            # count this stream in while still under the swap lock:
            # an activation drains the count to zero before swapping
            # weights, and no new stream can pass this gate while an
            # activator holds the lock — a stream's tokens all come
            # from the model that was active when it was admitted
            with self._gen_cv:
                self._gen_active += 1
        try:
            self._stream_generation(conn, msg, ctx)
        finally:
            with self._gen_cv:
                self._gen_active -= 1
                self._gen_cv.notify_all()

    def _stream_generation(self, conn, msg, ctx):
        """The streaming half of a generate request, counted in
        ``_gen_active`` by the caller (:meth:`_handle_generate`)."""
        eos_id = msg.get("eos_id")
        if eos_id is None:
            eos_id = int(self.backend.sessions[0].spec.eos_id)
        ack = {"ev": "ack", "member": self.member_id,
               "pid": os.getpid(), "version": self.version,
               "policy": self._policy_fp,
               "eos_id": int(eos_id)}
        if self.model is not None:
            # the model id the router fences journals on: absent for
            # model-less workers, so legacy acks stay byte-identical
            ack["model"] = self.model
        conn.send(ack)
        tokq = queue.Queue()
        version_start = self.version
        kw = {}
        if self._accepts_seed and msg.get("seed") is not None:
            # the router-minted decode seed: re-fed verbatim on every
            # replay hop so a sampled generation resumes its exact
            # key schedule
            kw["seed"] = int(msg["seed"])
        if self._accepts_tenant and msg.get("tenant") is not None:
            kw["tenant"] = str(msg["tenant"])
        try:
            with _rtrace.activate(ctx):
                fut = self.backend.submit(
                    msg["prompt"], max_new_tokens=msg.get("max_new"),
                    eos_id=msg.get("eos_id"),
                    deadline_ms=msg.get("deadline_ms"),
                    on_token=tokq.put, **kw)
        except ServingDeadlineError as exc:
            conn.send({"ev": "err", "kind": "deadline",
                       "error": repr(exc)[:300]})
            return
        except ValueError as exc:
            conn.send({"ev": "err", "kind": "client",
                       "error": repr(exc)[:300]})
            return
        except Exception as exc:
            conn.send({"ev": "err", "kind": "server",
                       "error": repr(exc)[:300]})
            return
        streamed = 0
        try:
            while True:
                try:
                    t = tokq.get(timeout=0.05)
                except queue.Empty:
                    if fut.done() and tokq.empty():
                        break
                    continue
                streamed += 1
                # chaos: SIGKILL this member after streaming token N —
                # the deterministic mid-generation process death
                _faults.fire_point("fleet_member_kill", index=streamed)
                conn.send({"ev": "tok", "t": int(t)})
        except OSError:
            return  # client (router) went away mid-stream
        try:
            tokens = [int(t) for t in fut.result(timeout=0)]
        except Exception as exc:
            # "deadline" keeps its type across the wire (the router
            # re-raises ServingDeadlineError — the contract every
            # serving caller catches); "client" is the request's own
            # fault (never charged, never replayed)
            if isinstance(exc, ServingDeadlineError):
                kind = "deadline"
            elif isinstance(exc, ValueError):
                kind = "client"
            else:
                kind = "server"
            try:
                conn.send({"ev": "err", "kind": kind,
                           "error": repr(exc)[:300]})
            except OSError:
                pass
            return
        _WORKER_DONE.inc()  # this member's side of the ledger
        try:
            conn.send({"ev": "done", "tokens": tokens,
                       "member": self.member_id,
                       "version": self.version,
                       "version_start": version_start,
                       "streamed": streamed})
        except OSError:
            pass

    def _handle_run(self, conn, msg):
        _faults.fire_point("fleet_slow_member", index=self.member_id)
        if self._kind != "engine":
            conn.send({"ev": "err", "kind": "client",
                       "error": "this member serves a generation "
                       "scheduler — use cmd=generate"})
            return
        try:
            feed = {name: np.asarray(spec["data"],
                                     dtype=spec["dtype"])
                    for name, spec in msg["feed"].items()}
            outs = self.backend.run(
                feed, deadline_ms=msg.get("deadline_ms"))
            _WORKER_DONE.inc()
            conn.send({"ev": "done", "member": self.member_id,
                       "version": self.version,
                       "outputs": [{"data": np.asarray(o).tolist(),
                                    "dtype": str(np.asarray(o).dtype)}
                                   for o in outs]})
        except ValueError as exc:
            conn.send({"ev": "err", "kind": "client",
                       "error": repr(exc)[:300]})
        except Exception as exc:
            conn.send({"ev": "err", "kind": "server",
                       "error": repr(exc)[:300]})

    # -- model paging -----------------------------------------------------
    def _activate_locked(self, model):
        """Make ``model`` (already resident) the active one: snapshot
        the outgoing model's live weights host-side, then swap the
        incoming snapshot in through the backend's gates. Caller
        holds ``_swap_lock``."""
        entry = self._resident[model]
        if self._kind == "generation":
            # drain in-flight streams first: the scheduler's swap
            # lands between decode steps, so without this a stream
            # admitted under the OUTGOING model would finish its
            # remaining tokens on the incoming model's weights —
            # cross-model output the version fence can't unmix
            with self._gen_cv:
                deadline = time.monotonic() + 60.0
                while self._gen_active:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise RuntimeError(
                            "activating %r timed out draining %d "
                            "in-flight generation stream(s)"
                            % (model, self._gen_active))
                    self._gen_cv.wait(left)
            params = entry["params"]
            if params is None:
                raise RuntimeError(
                    "model %r resident without a host snapshot"
                    % model)
            # the outgoing model keeps its weights: a host copy of the
            # live values of exactly the vars about to be overwritten
            # (paged models share the program's parameter set — the
            # same contract a rolling-deploy push has), read by the
            # scheduler's dispatcher now that no stream is in flight
            cur = self._resident.get(self.model)
            if cur is not None:
                cur["params"] = self.backend.snapshot_weights(list(params))
            self.backend.swap_weights(params)
        else:
            if entry.get("model_dir") is None:
                raise RuntimeError(
                    "model %r resident without an artifact dir"
                    % model)
            self.backend.swap_weights(entry["model_dir"])
            self._cur_dir = entry["model_dir"]
        self.model = model
        self.version = str(entry["tag"])

    def _handle_page_in(self, msg):
        model = str(msg.get("model"))
        tag = msg.get("tag") or "%s@v0" % model
        with self._swap_lock:
            inserted = False
            try:
                # chaos first: a wedged/failing page-in must look
                # exactly like a wedged staged load to the router
                _faults.fire_point("model_page_in_slow", index=model)
                _faults.fire_point("model_page_in_fail", index=model)
                if model == self.model:
                    pass  # already active: idempotent success
                elif model in self._resident:
                    # already resident (router raced itself or a
                    # stale view): just activate the snapshot
                    self._activate_locked(model)
                elif self._kind == "generation":
                    path = msg["params_path"]
                    # the manifest gate: a truncated or switched
                    # artifact is refused BEFORE any weight lands
                    _paging.verify_weights_manifest(path)
                    params = _load_npz(path)
                    self._resident[model] = {"tag": str(tag),
                                             "params": params,
                                             "model_dir": None}
                    inserted = True
                    self._activate_locked(model)
                else:
                    self._resident[model] = {
                        "tag": str(tag), "params": None,
                        "model_dir": msg["model_dir"]}
                    inserted = True
                    self._activate_locked(model)
            except Exception as exc:
                if inserted:
                    self._resident.pop(model, None)
                return {"ok": False, "error": repr(exc)[:300],
                        "version": self.version, "model": self.model}
        _log.structured("fleet_worker_paged_in",
                        member=self.member_id, model=model,
                        version=self.version,
                        resident=sorted(self._resident))
        return {"ok": True, "version": self.version,
                "model": self.model,
                "models": sorted(self._resident)}

    def _handle_page_out(self, msg):
        model = str(msg.get("model"))
        with self._swap_lock:
            if model == self.model:
                # the active model's weights live in the backend —
                # paging it out would leave the member serving
                # nothing (the router protects the active model, so
                # reaching this is a bug or a raced view)
                return {"ok": False, "version": self.version,
                        "error": "model %r is active" % model}
            if self._resident.pop(model, None) is None:
                return {"ok": False, "version": self.version,
                        "error": "model %r not resident" % model}
        _log.structured("fleet_worker_paged_out",
                        member=self.member_id, model=model,
                        resident=sorted(self._resident))
        return {"ok": True, "version": self.version,
                "models": sorted(self._resident)}

    # -- deploys ----------------------------------------------------------
    def _handle_swap(self, msg):
        tag = str(msg.get("tag"))
        with self._swap_lock:
            swap_model = msg.get("model")
            if swap_model is not None and \
                    str(swap_model) != self.model:
                # a model-scoped deploy lands on the named model, not
                # whatever happens to be active: activate it first
                # (resident members only — the router already scoped
                # the deploy order to them)
                swap_model = str(swap_model)
                if swap_model not in self._resident:
                    return {"ok": False, "version": self.version,
                            "error": "model %r not resident on %s"
                            % (swap_model, self.member_id)}
                try:
                    self._activate_locked(swap_model)
                except Exception as exc:
                    return {"ok": False, "error": repr(exc)[:300],
                            "version": self.version}
            try:
                if self._kind == "generation":
                    # host-side rollback snapshot of exactly the
                    # params the push names, taken BEFORE the swap (on
                    # the scheduler's dispatcher, between steps)
                    params = _load_npz(msg["params_path"])
                    snapshot = self.backend.snapshot_weights(list(params))
                    self.backend.swap_weights(params)
                else:
                    # engine members roll back by re-swapping the
                    # prior artifact dir (the swap gates both ways)
                    snapshot = getattr(self, "_cur_dir", None)
                    self.backend.swap_weights(msg["model_dir"])
                    self._cur_dir = msg["model_dir"]
            except Exception as exc:
                return {"ok": False, "error": repr(exc)[:300],
                        "version": self.version}
            self._prev = (self.version, snapshot)
            prev_tag = self.version
            self.version = tag
            if self.model is not None:
                # the active model's resident entry tracks the push:
                # paging away and back must restore the PUSHED
                # weights, not the pre-deploy snapshot
                entry = self._resident.get(self.model)
                if entry is not None:
                    entry["tag"] = tag
                    if self._kind == "generation":
                        entry["params"] = params
                    else:
                        entry["model_dir"] = msg["model_dir"]
            if self._armed_bad:
                _faults.disarm("generation_step_fail")
                self._armed_bad = False
            if self.fail_after_swap_tag is not None and \
                    tag == str(self.fail_after_swap_tag):
                # deploy-chaos hook: this push is "broken" — every
                # decode step on it fails until a rollback restores
                # the prior version
                _faults.arm("generation_step_fail", times=None)
                self._armed_bad = True
            _log.structured("fleet_worker_swapped",
                            member=self.member_id, version=tag,
                            prev=prev_tag)
            return {"ok": True, "version": self.version}

    def _handle_rollback(self):
        with self._swap_lock:
            if self._prev is None:
                return {"ok": False, "error": "nothing to roll back",
                        "version": self.version}
            prev_tag, snapshot = self._prev
            if snapshot is None:
                return {"ok": False, "version": self.version,
                        "error": "no prior weights snapshot"}
            try:
                self.backend.swap_weights(snapshot)
            except Exception as exc:
                return {"ok": False, "error": repr(exc)[:300],
                        "version": self.version}
            self.version = prev_tag
            self._prev = None
            if self.model is not None:
                # the rollback restored the prior weights: the
                # active model's resident entry follows
                entry = self._resident.get(self.model)
                if entry is not None:
                    entry["tag"] = prev_tag
                    if self._kind == "generation":
                        entry["params"] = snapshot
                    else:
                        entry["model_dir"] = snapshot
            if self._armed_bad:
                _faults.disarm("generation_step_fail")
                self._armed_bad = False
            _log.structured("fleet_worker_rolled_back",
                            member=self.member_id, version=prev_tag)
            return {"ok": True, "version": self.version}

    # -- lifecycle --------------------------------------------------------
    def serve_forever(self):
        """Block until a ``stop`` command (or :meth:`close`) — the
        child-process entry point."""
        self._stop_evt.wait()
        self.close()

    def close(self):
        self._stop_evt.set()
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
            self._hb_thread = None
        if self.router_addr is not None:
            if self.metrics_interval > 0:
                # final ship: the counts earned since the last beat
                # land before the membership lease is surrendered
                try:
                    _wire.call_once(
                        self.router_addr,
                        {"cmd": "metrics", "member": self.member_id,
                         "incarnation": self.incarnation,
                         "snapshot": _aggregate.build_snapshot(
                             max_bytes=_wire.MAX_LINE - 1024)},
                        timeout=2.0, retries=1)
                except (ConnectionError, OSError, _wire.WireError):
                    pass
            try:
                _wire.call_once(self.router_addr,
                                {"cmd": "unreg",
                                 "member": self.member_id},
                                timeout=1.0, retries=1)
            except (ConnectionError, OSError, _wire.WireError):
                pass
        if self._armed_bad:
            _faults.disarm("generation_step_fail")
            self._armed_bad = False
        if self._server is not None:
            self._server.close()
            self._server = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
