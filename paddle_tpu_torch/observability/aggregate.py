"""Mergeable registry snapshots and pull-side fleet aggregation
(reference ``paddle_tpu/observability/aggregate.py``): local collection,
aggregation where the scrape is pulled.

* **snapshots**: :func:`snapshot_registry` encodes one consistent
  :meth:`~.metrics.Registry.snapshot` as a compact, versioned wire
  document (label names once per family, raw bucket counts, no help
  text), byte-identical to the reference's for a registry of the same
  contents. :func:`build_snapshot` bounds the encoding under a byte
  budget (``serving/wire.py``'s :data:`MAX_LINE` frame cap less the
  heartbeat envelope): an oversized snapshot degrades to a summary frame by
  dropping whole families, histograms first and counters (the
  conservation-critical data) last, counted in
  ``paddle_fleet_snapshot_truncated_total``; the heartbeat carrying it
  is never dropped.
* **delta accounting**: :class:`FleetAggregator.ingest` folds each
  member's monotonic counter totals into fleet-wide accumulators keyed
  per (member, incarnation): a restarted member reports a fresh
  incarnation, which resets its delta base, so the restart neither
  double-counts its old totals nor drives a fleet counter backwards.
  Histograms merge bucket-wise over the shared ``LATENCY_MS_BUCKETS``
  (the same delta discipline per bucket); gauges are point-in-time and
  re-labeled ``f<router>:<member>``.
* **staleness**: a dead member's last snapshot is retained but labeled
  ``stale="1"`` in the merged exposition, then retired after
  ``retain_windows`` metric windows. Its accumulated counter and
  histogram deltas persist: the fleet total is the sum of every delta
  ever observed, not the sum of who is still alive.

Nothing here makes threads or sockets: the aggregator is pure
ingest-side state its owner pushes into and pulls from.
"""

import json
import math
import threading
import time

from . import metrics as _metrics
from ..serving.wire import MAX_LINE

__all__ = ["SNAPSHOT_VERSION", "MAX_LINE", "snapshot_registry",
           "encode_snapshot", "encoded_size", "build_snapshot",
           "FleetAggregator"]

SNAPSHOT_VERSION = 1

_SNAPSHOT_TRUNCATED = _metrics.REGISTRY.counter(
    "paddle_fleet_snapshot_truncated_total",
    "Metric families dropped from a fleet snapshot to fit the wire "
    "frame budget (the heartbeat carrying it is never dropped)")

# drop order under a byte budget: histograms are the bulkiest and the
# most reconstructible, counters are the conservation-critical data
_DROP_PRIORITY = {"histogram": 0, "gauge": 1, "counter": 2}


def snapshot_registry(registry=None):
    """One consistent registry snapshot as the compact wire document:
    ``{"v": 1, "fams": {name: {"k": kind, "ln": [labelnames],
    "b": [buckets]?, "ch": [[[labelvalues], payload], ...]}}}``.
    Counter/gauge payload is the float total; histogram payload is
    ``[bucket_counts, count, sum, min|None, max|None]`` (raw per-bucket
    counts; min/max None while empty — the wire stays JSON-clean)."""
    reg = registry if registry is not None else _metrics.REGISTRY
    fams = {}
    for name, kind, _help, buckets, children in reg.snapshot():
        if not children:
            continue
        ln = None
        ch = []
        for labels, payload in children:
            if ln is None:
                ln = list(labels)
            values = [labels[n] for n in ln]
            if kind == "histogram":
                counts, count, vsum, vmin, vmax = payload
                payload = [counts, count, vsum,
                           None if count == 0 else vmin,
                           None if count == 0 else vmax]
            ch.append([values, payload])
        fam = {"k": kind, "ln": ln or [], "ch": ch}
        if kind == "histogram" and buckets:
            fam["b"] = list(buckets)
        fams[name] = fam
    return {"v": SNAPSHOT_VERSION, "fams": fams}


def encode_snapshot(snap):
    """Compact JSON bytes — what the wire frame actually carries."""
    return json.dumps(snap, separators=(",", ":")).encode()


def encoded_size(snap):
    return len(encode_snapshot(snap))


def build_snapshot(max_bytes=None, registry=None):
    """A wire snapshot bounded to ``max_bytes`` encoded. Over budget,
    whole families are dropped (largest first within
    histogram -> gauge -> counter priority) and counted — both in the
    frame (``"truncated": N``) and in the local
    ``paddle_fleet_snapshot_truncated_total``; the degenerate floor is
    a pure summary frame ``{"v": 1, "fams": {}, "truncated": N}``,
    which always fits. The carrying heartbeat is never dropped."""
    snap = snapshot_registry(registry)
    if not max_bytes:
        return snap
    if encoded_size(snap) <= max_bytes:
        return snap
    sizes = {name: len(json.dumps(fam, separators=(",", ":")))
             for name, fam in snap["fams"].items()}
    dropped = 0
    while snap["fams"] and encoded_size(snap) > max_bytes:
        name = max(snap["fams"],
                   key=lambda n: (-_DROP_PRIORITY[snap["fams"][n]["k"]],
                                  sizes[n]))
        del snap["fams"][name]
        dropped += 1
        snap["truncated"] = dropped
    if dropped:
        _SNAPSHOT_TRUNCATED.inc(dropped)
    return snap


class _HistAcc:
    """Fleet-accumulated histogram: bucket-wise delta sums."""

    __slots__ = ("buckets", "counts", "count", "sum", "vmin", "vmax")

    def __init__(self, buckets, nslots):
        self.buckets = tuple(buckets)
        self.counts = [0] * nslots
        self.count = 0
        self.sum = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf


class _MemberState:
    """Per-member ingest state: delta bases keyed by the incarnation
    that produced them, plus the last raw snapshot (drill-down and
    gauge exposition)."""

    __slots__ = ("id", "incarnation", "last", "snap", "t", "dead_t",
                 "truncated", "ingests")

    def __init__(self, mid):
        self.id = mid
        self.incarnation = None
        self.last = {}        # name -> {childkey: last totals}
        self.snap = None      # last raw wire snapshot
        self.t = None         # monotonic last-ingest time
        self.dead_t = None    # monotonic death time, or None
        self.truncated = 0
        self.ingests = 0


class FleetAggregator:
    """Router-side merge of member registry snapshots.

    ``label`` is the router's gauge namespace (``"f<rid>"``) — member
    gauges re-label as ``member="f<rid>:<mid>"``. ``interval_s`` is
    the expected snapshot cadence (the staleness/retirement clock;
    <= 0 falls back to 60 s windows). No threads, no sockets: callers
    push via :meth:`ingest` and pull via :meth:`merged_text` /
    :meth:`fleet_doc`.
    """

    def __init__(self, label, interval_s=0.0, retain_windows=3,
                 registry=None):
        self.label = str(label)
        self.interval = float(interval_s or 0.0)
        self.retain_windows = max(1, int(retain_windows))
        self._registry = registry if registry is not None \
            else _metrics.REGISTRY
        self._lock = threading.Lock()
        self._counters = {}   # name -> {childkey: accumulated delta}
        self._hists = {}      # name -> {childkey: _HistAcc}
        self._meta = {}       # name -> (kind, labelnames)
        self._members = {}    # mid -> _MemberState
        self.ingests = 0

    # -- clocks -----------------------------------------------------------
    def window(self):
        return self.interval if self.interval > 0 else 60.0

    def _stale_locked(self, st, now):
        if st.dead_t is not None:
            return True
        return st.t is not None and (now - st.t) > 2.0 * self.window()

    def _gc_locked(self, now):
        horizon = self.retain_windows * self.window()
        for mid in [mid for mid, st in self._members.items()
                    if st.dead_t is not None
                    and now - st.dead_t > horizon]:
            # retire the dead member's SNAPSHOT (gauges, drill-down);
            # its accumulated counter/histogram deltas persist —
            # conservation outlives membership
            del self._members[mid]

    # -- ingest -----------------------------------------------------------
    def ingest(self, member, incarnation, snap, now=None):
        """Fold one member snapshot in; returns the number of families
        merged. Raises ValueError on a snapshot this version cannot
        read (the caller replies an error frame, the heartbeat itself
        already succeeded)."""
        if not isinstance(snap, dict) or \
                snap.get("v") != SNAPSHOT_VERSION:
            raise ValueError("unreadable snapshot version %r (want %d)"
                             % (None if not isinstance(snap, dict)
                                else snap.get("v"), SNAPSHOT_VERSION))
        now = time.monotonic() if now is None else now
        mid = str(member)
        merged = 0
        with self._lock:
            st = self._members.get(mid)
            if st is None:
                st = self._members[mid] = _MemberState(mid)
            if st.incarnation != incarnation:
                # a restarted process: its totals restarted from zero,
                # so its delta bases restart WITH it — the old
                # incarnation's deltas are already banked (no
                # double-count) and the fresh low totals never
                # subtract (no going backwards)
                st.incarnation = incarnation
                st.last = {}
            st.t = now
            st.dead_t = None  # a reporting member is not dead
            st.snap = snap
            st.truncated = int(snap.get("truncated", 0) or 0)
            st.ingests += 1
            self.ingests += 1
            for name, fam in snap.get("fams", {}).items():
                kind = fam.get("k")
                ln = tuple(fam.get("ln") or ())
                self._meta.setdefault(name, (kind, ln))
                if kind == "counter":
                    self._ingest_counter_locked(st, name, ln, fam)
                elif kind == "histogram":
                    self._ingest_hist_locked(st, name, ln, fam)
                # gauges are point-in-time: exposed straight off
                # st.snap, nothing accumulates
                merged += 1
            self._gc_locked(now)
        return merged

    def _ingest_counter_locked(self, st, name, ln, fam):
        acc = self._counters.setdefault(name, {})
        last = st.last.setdefault(name, {})
        for values, payload in fam.get("ch", ()):
            key = (ln, tuple(str(v) for v in values))
            total = float(payload)
            delta = total - last.get(key, 0.0)
            if delta > 0:
                acc[key] = acc.get(key, 0.0) + delta
            # a lower total without an incarnation bump is a buggy
            # report: re-base on it (never subtract from the fleet)
            last[key] = total

    def _ingest_hist_locked(self, st, name, ln, fam):
        buckets = tuple(fam.get("b") or ())
        acc = self._hists.setdefault(name, {})
        last = st.last.setdefault(name, {})
        for values, payload in fam.get("ch", ()):
            counts, count, vsum, vmin, vmax = payload
            key = (ln, tuple(str(v) for v in values))
            prev = last.get(key)
            if prev is not None and prev[0] == buckets \
                    and len(prev[1]) == len(counts) \
                    and count >= prev[2]:
                dcounts = [max(0, int(n) - int(o))
                           for n, o in zip(counts, prev[1])]
                dcount = count - prev[2]
                dsum = vsum - prev[3]
            else:
                # first report this incarnation (or re-bucketed /
                # non-monotonic): take the totals whole
                dcounts, dcount, dsum = counts, count, vsum
            cur = acc.get(key)
            if cur is None:
                cur = acc[key] = _HistAcc(buckets, len(counts))
            if cur.buckets == buckets and \
                    len(cur.counts) == len(dcounts):
                for i, d in enumerate(dcounts):
                    cur.counts[i] += int(d)
            # mismatched bounds can't bin — count/sum still conserve
            cur.count += int(dcount)
            cur.sum += float(dsum)
            if vmin is not None:
                cur.vmin = min(cur.vmin, float(vmin))
            if vmax is not None:
                cur.vmax = max(cur.vmax, float(vmax))
            last[key] = (buckets, [int(c) for c in counts], count,
                         float(vsum))

    def mark_dead(self, member):
        """Membership hook: the member was dropped. Its snapshot stays,
        staleness-labeled, for ``retain_windows`` windows."""
        with self._lock:
            st = self._members.get(str(member))
            if st is not None and st.dead_t is None:
                st.dead_t = time.monotonic()

    # -- exposition -------------------------------------------------------
    def _member_label(self, mid):
        return "%s:%s" % (self.label, mid)

    @staticmethod
    def _wire_to_snapshot(snap):
        """A raw wire snapshot in ``Registry.snapshot`` shape (the
        per-member drill-down render)."""
        out = []
        for name in sorted(snap.get("fams", {})):
            fam = snap["fams"][name]
            kind = fam.get("k")
            ln = list(fam.get("ln") or ())
            buckets = tuple(fam.get("b") or ()) or None
            children = []
            for values, payload in fam.get("ch", ()):
                labels = dict(zip(ln, values))
                if kind == "histogram":
                    counts, count, vsum, vmin, vmax = payload
                    payload = (counts, count, vsum,
                               math.inf if vmin is None else vmin,
                               -math.inf if vmax is None else vmax)
                children.append((labels, payload))
            out.append((name, kind, "", buckets, children))
        return out

    def merged_snapshot(self, now=None):
        """The fleet-merged registry in ``Registry.snapshot`` shape:
        the local registry plus accumulated member counter/histogram
        deltas, plus member gauges re-labeled (and staleness-labeled
        when their member is dead or silent past two windows)."""
        local = self._registry.snapshot()
        now = time.monotonic() if now is None else now
        with self._lock:
            self._gc_locked(now)
            counters = {n: dict(m) for n, m in self._counters.items()}
            hists = {n: dict(m) for n, m in self._hists.items()}
            meta = dict(self._meta)
            member_gauges = []
            for mid in sorted(self._members):
                st = self._members[mid]
                if st.snap is None:
                    continue
                stale = self._stale_locked(st, now)
                for name, fam in st.snap.get("fams", {}).items():
                    if fam.get("k") == "gauge":
                        member_gauges.append((mid, stale, name, fam))
        byname = {}
        order = []
        for name, kind, help_text, buckets, children in local:
            keyed = {}
            for labels, payload in children:
                keyed[tuple(sorted(labels.items()))] = [labels, payload]
            byname[name] = [kind, help_text, buckets, keyed]
            order.append(name)
        # counters: fleet deltas add onto the local child (or grow a
        # fleet-only child)
        for name, acc in sorted(counters.items()):
            ent = self._entry(byname, order, name, meta, "counter")
            keyed = ent[3]
            for (ln, values), delta in sorted(acc.items()):
                labels = dict(zip(ln, values))
                k = tuple(sorted(labels.items()))
                if k in keyed:
                    keyed[k][1] = float(keyed[k][1]) + delta
                else:
                    keyed[k] = [labels, delta]
        # histograms: bucket-wise merge when the bounds line up (they
        # do — both sides run this code over LATENCY_MS_BUCKETS);
        # count/sum/min/max conserve either way
        for name, acc in sorted(hists.items()):
            ent = self._entry(byname, order, name, meta, "histogram")
            keyed = ent[3]
            for (ln, values), h in sorted(acc.items()):
                labels = dict(zip(ln, values))
                k = tuple(sorted(labels.items()))
                if ent[2] is None and h.buckets:
                    ent[2] = h.buckets
                if k in keyed:
                    counts, count, vsum, vmin, vmax = keyed[k][1]
                    if tuple(ent[2] or ()) == h.buckets and \
                            len(counts) == len(h.counts):
                        counts = [a + b for a, b in
                                  zip(counts, h.counts)]
                    keyed[k][1] = (counts, count + h.count,
                                   vsum + h.sum, min(vmin, h.vmin),
                                   max(vmax, h.vmax))
                else:
                    keyed[k] = [labels, (list(h.counts), h.count,
                                         h.sum, h.vmin, h.vmax)]
        # gauges: point-in-time per member, re-labeled
        # member="f<rid>:<mid>" (origin= when the family already
        # labels on member), stale="1" past the staleness horizon
        for mid, stale, name, fam in member_gauges:
            ent = self._entry(byname, order, name, meta, "gauge")
            keyed = ent[3]
            ln = list(fam.get("ln") or ())
            relabel = "origin" if "member" in ln else "member"
            for values, payload in fam.get("ch", ()):
                labels = dict(zip(ln, values))
                labels[relabel] = self._member_label(mid)
                if stale:
                    labels["stale"] = "1"
                keyed[tuple(sorted(labels.items()))] = [labels, payload]
        out = []
        for name in sorted(order):
            kind, help_text, buckets, keyed = byname[name]
            children = [(labels, tuple(p) if isinstance(p, list)
                         else p) for labels, p in
                        (keyed[k] for k in sorted(keyed))]
            out.append((name, kind, help_text, buckets, children))
        return out

    @staticmethod
    def _entry(byname, order, name, meta, kind):
        ent = byname.get(name)
        if ent is None:
            ent = byname[name] = [kind, "", None, {}]
            order.append(name)
        return ent

    def merged_text(self, member=None):
        """The fleet ``/metrics`` payload: merged exposition, or one
        member's raw last snapshot (``?member=`` drill-down — accepts
        the bare id or the ``f<rid>:<mid>`` label). None for an
        unknown member. With no member data ever ingested this is
        byte-identical to ``Registry.expose_text()``."""
        if member:
            mid = str(member)
            if mid.startswith(self.label + ":"):
                mid = mid[len(self.label) + 1:]
            with self._lock:
                st = self._members.get(mid)
                snap = None if st is None else st.snap
            if snap is None:
                return None
            return _metrics.format_snapshot_text(
                self._wire_to_snapshot(snap))
        with self._lock:
            untouched = not self._members and not self._counters \
                and not self._hists
        if untouched:
            return self._registry.expose_text()
        return _metrics.format_snapshot_text(self.merged_snapshot())

    def fleet_doc(self, now=None):
        """Snapshot ages + ingest accounting for ``/debug/fleet``."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._gc_locked(now)
            members = {}
            for mid, st in sorted(self._members.items()):
                members[mid] = {
                    "incarnation": st.incarnation,
                    "snapshot_age_s": None if st.t is None
                    else round(now - st.t, 3),
                    "stale": self._stale_locked(st, now),
                    "dead": st.dead_t is not None,
                    "truncated_families": st.truncated,
                    "ingests": st.ingests,
                }
            return {"window_s": self.window(),
                    "retain_windows": self.retain_windows,
                    "ingests": self.ingests,
                    "members": members}

    def counter_children(self, name, label):
        """The fleet-accumulated totals of one counter family, split
        by ONE label's values: ``{label value: total}``. The
        per-tenant drill: ``counter_children(
        "paddle_serving_tenant_shed_total", "tenant")`` answers
        "which tenant's traffic shed, fleet-wide" from the deltas
        every member shipped — the isolation proof the autoscale
        chaos probe asserts on."""
        label = str(label)
        out = {}
        with self._lock:
            acc = self._counters.get(name)
            if not acc:
                return out
            for (ln, values), v in acc.items():
                child = dict(zip(ln, values))
                if label in child:
                    key = child[label]
                    out[key] = out.get(key, 0.0) + v
        return out

    def counter_value(self, name, **labels):
        """The fleet-accumulated delta total for one counter child
        (conservation asserts in tests/probes read this)."""
        with self._lock:
            acc = self._counters.get(name)
            if not acc:
                return 0.0
            if not labels:
                return sum(acc.values())
            want = {str(k): str(v) for k, v in labels.items()}
            total = 0.0
            for (ln, values), v in acc.items():
                child = dict(zip(ln, values))
                if all(child.get(k) == w for k, w in want.items()):
                    total += v
            return total
