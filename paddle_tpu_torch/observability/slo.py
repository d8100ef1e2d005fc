"""Windowed SLO tracking (reference ``paddle_tpu/observability/slo.py``):
sliding percentiles and multi-window error-budget burn rates over the
always-on request telemetry.

The tracker is the signal an autoscaler reads. It is pull-based and
thread-free: each :meth:`SLOTracker.tick`
samples a *source* (cumulative latency-histogram totals plus
bad-event counter totals — by default ``paddle_request_e2e_ms`` and
the shed/deadline counters straight out of the local registry), keeps
a ring of samples spanning the slow window, and computes per-window

* p50/p95/p99 by bucket-delta linear interpolation,
* the bad fraction — observations above ``target_p99_ms`` plus
  shed/deadline deltas, over hist-count + shed/deadline deltas,
* the burn rate ``bad_fraction / (1 - objective)`` (the SRE
  multi-window convention: > 1.0 means the error budget is burning
  faster than it accrues).

The fast window (~5 s) is the alert trigger; the slow window (~60 s)
is the sustained view. ``paddle_slo_burn_rate{tracker,window}``
gauges and ``paddle_slo_violation_seconds_total{tracker}`` (seconds
spent with the fast window alerting) update on every tick, and
:meth:`verdict` renders the machine-readable ``/debug/slo`` document.

Flags (``slo_target_p99_ms``, ``slo_windows``) are read only at
construction, and nothing constructs unless a caller builds a tracker.
"""

import threading
import time
from collections import deque

from .. import config
from . import metrics as _metrics

__all__ = ["SLOTracker", "local_source", "labeled_source",
           "DEFAULT_BAD_COUNTERS"]

DEFAULT_HISTOGRAM = "paddle_request_e2e_ms"
DEFAULT_BAD_COUNTERS = ("paddle_serving_shed_total",
                        "paddle_serving_deadline_exceeded_total")

_BURN = _metrics.REGISTRY.gauge(
    "paddle_slo_burn_rate",
    "Error-budget burn rate per window (1.0 = budget burning exactly "
    "as fast as it accrues)", labelnames=("tracker", "window"))
_VIOLATION = _metrics.REGISTRY.counter(
    "paddle_slo_violation_seconds_total",
    "Seconds spent with the fast-window burn rate above 1.0",
    labelnames=("tracker",))

_TRACKER_SEQ = iter(range(1, 1 << 30))


def local_source(histogram=DEFAULT_HISTOGRAM,
                 bad_counters=DEFAULT_BAD_COUNTERS, registry=None):
    """A tracker source reading cumulative totals out of a registry:
    one consistent snapshot per call, summed across every labeled
    child of the named families."""
    reg = registry if registry is not None else _metrics.REGISTRY
    bad_counters = tuple(bad_counters)

    def source():
        buckets, counts, count, bad = (), None, 0, 0.0
        for name, kind, _help, b, children in reg.snapshot():
            if name == histogram and kind == "histogram":
                buckets = tuple(b or ())
                for _labels, payload in children:
                    ccounts, ccount, _sum, _mn, _mx = payload
                    if counts is None:
                        counts = [0] * len(ccounts)
                    if len(ccounts) == len(counts):
                        for i, c in enumerate(ccounts):
                            counts[i] += int(c)
                    count += int(ccount)
            elif name in bad_counters and kind == "counter":
                for _labels, payload in children:
                    bad += float(payload)
        nslots = len(buckets) + 1 if buckets else 0
        return {"buckets": buckets,
                "counts": counts if counts is not None else [0] * nslots,
                "count": count, "bad": bad}

    return source


def labeled_source(histogram=DEFAULT_HISTOGRAM,
                   bad_counters=DEFAULT_BAD_COUNTERS,
                   label=None, value=None, registry=None):
    """:func:`local_source` restricted to ONE labeled child per
    family: only children whose ``label`` equals ``value`` are summed.
    This is how per-tenant SLO verdicts slice the shared families:
    one tracker per tenant, each reading its own
    ``paddle_fleet_tenant_request_ms{tenant=...}`` child and the
    matching shed/deadline children, so a bursting tenant burns its
    own budget while another tenant's verdict stays green; per-model
    verdicts slice ``paddle_fleet_model_request_ms{model=...}`` the
    same way."""
    reg = registry if registry is not None else _metrics.REGISTRY
    bad_counters = tuple(bad_counters)
    label = str(label)
    value = str(value)

    def source():
        buckets, counts, count, bad = (), None, 0, 0.0
        for name, kind, _help, b, children in reg.snapshot():
            if name == histogram and kind == "histogram":
                buckets = tuple(b or ())
                for labels, payload in children:
                    if labels.get(label) != value:
                        continue
                    ccounts, ccount, _sum, _mn, _mx = payload
                    if counts is None:
                        counts = [0] * len(ccounts)
                    if len(ccounts) == len(counts):
                        for i, c in enumerate(ccounts):
                            counts[i] += int(c)
                    count += int(ccount)
            elif name in bad_counters and kind == "counter":
                for labels, payload in children:
                    if labels.get(label) != value:
                        continue
                    bad += float(payload)
        nslots = len(buckets) + 1 if buckets else 0
        return {"buckets": buckets,
                "counts": counts if counts is not None else [0] * nslots,
                "count": count, "bad": bad}

    return source


class _Sample:
    __slots__ = ("t", "count", "bad", "counts", "buckets")

    def __init__(self, t, count, bad, counts, buckets):
        self.t = t
        self.count = count
        self.bad = bad
        self.counts = counts
        self.buckets = buckets


class SLOTracker:
    """Sliding-window SLO verdicts over cumulative telemetry totals.

    ``target_p99_ms``/``windows`` default from the flags (read here,
    at construction, only). ``objective`` is the availability target
    the budget is cut from (0.99 → 1% budget). ``source`` defaults to
    the local registry's ``paddle_request_e2e_ms`` + shed/deadline
    counters; the fleet router points it at its client-observed
    ``paddle_fleet_request_ms`` instead.
    """

    def __init__(self, label=None, target_p99_ms=None, windows=None,
                 objective=0.99, source=None, registry=None):
        if target_p99_ms is None:
            target_p99_ms = float(config.get_flag("slo_target_p99_ms"))
        if windows is None:
            windows = config.get_flag("slo_windows")
        windows = tuple(float(w) for w in windows)
        if not windows or any(w <= 0 for w in windows):
            raise ValueError("slo_windows must be positive: %r"
                             % (windows,))
        self.label = str(label) if label is not None \
            else "slo%d" % next(_TRACKER_SEQ)
        self.target = float(target_p99_ms)
        self.windows = tuple(sorted(windows))
        self.objective = float(objective)
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        self._budget = 1.0 - self.objective
        self._source = source if source is not None \
            else local_source(registry=registry)
        self._lock = threading.Lock()
        self._ring = deque()
        # seed a delta base with the source's totals as of
        # construction: traffic that lands entirely before the first
        # tick still shows up in the first windows, while history
        # accumulated before this tracker existed stays excluded.
        # t=-inf keeps the seed clock-agnostic (callers may tick with
        # their own monotonic base); it is trimmed by the normal
        # horizon sweep once real samples can serve as the base.
        tot = self._source()
        self._ring.append(_Sample(
            float("-inf"), int(tot.get("count", 0)),
            float(tot.get("bad", 0.0)),
            tuple(int(c) for c in (tot.get("counts") or ())),
            tuple(tot.get("buckets") or ())))
        self._last_t = None
        self._alerting = False
        self._violation_s = 0.0
        self._closed = False
        self._gauges = {}
        for name in self.window_names():
            self._gauges[name] = _BURN.labels(
                tracker=self.label, window=name)

    def window_names(self):
        """Window display names: the canonical 2-window config reads
        ``fast``/``slow``; anything else is named by its width."""
        if len(self.windows) == 2:
            return ("fast", "slow")
        return tuple("w%gs" % w for w in self.windows)

    # -- sampling ---------------------------------------------------------
    def tick(self, now=None):
        """Sample the source, roll the ring, refresh the burn gauges
        and the violation-seconds counter. Returns the fast-window
        burn rate. Thread-safe; pass ``now`` (monotonic seconds) for
        deterministic tests/benches."""
        now = time.monotonic() if now is None else float(now)
        tot = self._source()
        with self._lock:
            if self._closed:
                return 0.0
            self._ring.append(_Sample(
                now, int(tot.get("count", 0)),
                float(tot.get("bad", 0.0)),
                tuple(int(c) for c in (tot.get("counts") or ())),
                tuple(tot.get("buckets") or ())))
            horizon = now - self.windows[-1]
            # keep one sample at/older than the slow horizon as the
            # delta base for a full window
            while len(self._ring) > 2 and self._ring[1].t <= horizon:
                self._ring.popleft()
            burns = {name: self._burn_locked(now, w)
                     for name, w in zip(self.window_names(),
                                        self.windows)}
            fast = burns[self.window_names()[0]]
            alerting = fast > 1.0
            if self._alerting and self._last_t is not None:
                dt = max(0.0, now - self._last_t)
                if dt:
                    self._violation_s += dt
                    _VIOLATION.labels(tracker=self.label).inc(dt)
            self._alerting = alerting
            self._last_t = now
            for name, g in self._gauges.items():
                g.set(burns[name])
            return fast

    def _bounds_locked(self, now, window):
        """(base, latest) samples bracketing ``window``: the newest
        sample at/older than the window start (or the oldest held)."""
        if not self._ring:
            return None, None
        latest = self._ring[-1]
        start = now - window
        base = None
        for s in self._ring:
            if s.t <= start:
                base = s
            else:
                break
        if base is None:
            base = self._ring[0]
        return base, latest

    def _delta_locked(self, now, window):
        base, latest = self._bounds_locked(now, window)
        if latest is None or base is latest:
            return 0, 0.0, None, ()
        dcount = max(0, latest.count - base.count)
        dbad = max(0.0, latest.bad - base.bad)
        dcounts = None
        if latest.buckets == base.buckets and \
                len(latest.counts) == len(base.counts):
            dcounts = [max(0, n - o) for n, o in
                       zip(latest.counts, base.counts)]
        return dcount, dbad, dcounts, latest.buckets

    def _window_stats_locked(self, now, window):
        """(requests, bad, bad_fraction, burn, dcounts, buckets) for
        one window. The request universe is hist observations plus
        pure-bad events (shed/deadline never reach the histogram);
        bad is over-target observations plus those events, clamped to
        the universe."""
        dcount, dextra, dcounts, buckets = \
            self._delta_locked(now, window)
        over = 0.0
        if self.target > 0 and dcounts and buckets:
            over = self._over_target(dcounts, buckets)
        total = dcount + dextra
        bad = min(float(total), over + dextra)
        frac = (bad / total) if total else 0.0
        return total, bad, frac, frac / self._budget, dcounts, buckets

    def _burn_locked(self, now, window):
        return self._window_stats_locked(now, window)[3]

    def _over_target(self, dcounts, buckets):
        """Observations strictly above the target: everything in
        buckets whose lower bound is at/above the smallest bound >=
        target (bucket granularity — the resolution the shared
        LATENCY_MS_BUCKETS gives us)."""
        over = 0
        for i, ub in enumerate(buckets):
            if ub > self.target and i < len(dcounts):
                over += dcounts[i]
        if len(dcounts) > len(buckets):
            over += dcounts[len(buckets)]  # overflow bucket
        return float(over)

    @staticmethod
    def _percentile(dcounts, buckets, q, dtotal):
        if not dtotal or not dcounts:
            return None
        rank = q * dtotal
        cum = 0
        lo = 0.0
        for i, ub in enumerate(buckets):
            nxt = cum + dcounts[i]
            if nxt >= rank and dcounts[i] > 0:
                frac = (rank - cum) / dcounts[i]
                return lo + frac * (ub - lo)
            cum = nxt
            lo = ub
        # overflow bucket: the largest finite bound is the best claim
        return buckets[-1] if buckets else None

    # -- verdicts ---------------------------------------------------------
    def verdict(self, now=None):
        """Tick, then render the machine-readable ``/debug/slo``
        document: per-window burn rates and percentiles, the alert
        bit, and the violation-seconds total."""
        now = time.monotonic() if now is None else float(now)
        self.tick(now)
        with self._lock:
            windows = {}
            for name, w in zip(self.window_names(), self.windows):
                total, bad, frac, burn, dcounts, buckets = \
                    self._window_stats_locked(now, w)
                pct = {}
                if dcounts:
                    dtotal = sum(dcounts)
                    for q in (0.50, 0.95, 0.99):
                        v = self._percentile(dcounts, buckets, q,
                                             dtotal)
                        pct["p%d" % int(q * 100)] = \
                            None if v is None else round(v, 3)
                windows[name] = {
                    "window_s": w,
                    "requests": total,
                    "bad": round(bad, 3),
                    "bad_fraction": round(frac, 6),
                    "burn_rate": round(burn, 4),
                    "percentiles_ms": pct,
                }
            fast_name = self.window_names()[0]
            return {
                "tracker": self.label,
                "target_p99_ms": self.target,
                "objective": self.objective,
                "alerting": windows[fast_name]["burn_rate"] > 1.0,
                "violation_seconds": round(self._violation_s, 3),
                "samples": len(self._ring),
                "windows": windows,
            }

    @property
    def alerting(self):
        with self._lock:
            return self._alerting

    @property
    def violation_seconds(self):
        with self._lock:
            return self._violation_s

    def close(self):
        """Retire this tracker's gauge/counter children (the same
        label-sweep discipline the fleet router uses)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._ring.clear()
        _metrics.REGISTRY.remove_labeled("tracker", value=self.label)
