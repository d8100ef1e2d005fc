"""Metrics registry: counters, gauges and fixed-bucket histograms
(reference ``paddle_tpu/observability/metrics.py``).

Every metric is a named family with typed children per label set,
exposable as Prometheus text (``expose_text``) or JSON (``dump``). The
port registers its families under the reference's names, labels and
help text, so one scrape reads the same series from either package.

Recording is lock-cheap (one registry RLock around dict and float
updates) and allocation-free after the first ``labels()`` resolution:
hot paths hold the child rather than resolving labels per event.
"""

import json
import math
import threading

__all__ = ["Registry", "Counter", "Gauge", "Histogram",
           "REGISTRY", "default_registry", "DEFAULT_TIME_BUCKETS",
           "LATENCY_MS_BUCKETS", "format_snapshot_text"]

# Latency buckets in seconds: 500 us .. 60 s, the reference's, wide
# enough for a CPU test step and a full-width step alike.
DEFAULT_TIME_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                        0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# Serving-stage latency buckets in milliseconds, log-spaced from sub-ms
# (a warmed decode step) to 60 s (a deadline-bounded replay riding out a
# breaker cooldown): the per-stage request histograms
# (observability/request_trace.py) use these.
LATENCY_MS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                      10000.0, 30000.0, 60000.0)


def _format_value(v):
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer():
        return "%d" % int(v)
    return repr(float(v))


def _escape_label(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
                 .replace("\n", "\\n")


def _label_suffix(labels, extra=None):
    items = list(labels.items()) + list((extra or {}).items())
    if not items:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (k, _escape_label(v))
                             for k, v in items)


class Counter:
    """Monotonic count; ``inc`` only."""

    __slots__ = ("labels_dict", "_value", "_lock")

    def __init__(self, labels, lock):
        self.labels_dict = labels
        self._value = 0.0
        self._lock = lock

    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError("counters only go up (inc %r)" % (amount,))
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value


class Gauge:
    """Point-in-time value; ``set``/``inc``/``dec``."""

    __slots__ = ("labels_dict", "_value", "_lock")

    def __init__(self, labels, lock):
        self.labels_dict = labels
        self._value = 0.0
        self._lock = lock

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount=1.0):
        self.inc(-amount)

    @property
    def value(self):
        return self._value


class Histogram:
    """Fixed-bucket histogram; also tracks min and max."""

    __slots__ = ("labels_dict", "buckets", "bucket_counts", "count", "sum",
                 "vmin", "vmax", "_lock")

    def __init__(self, labels, lock, buckets):
        self.labels_dict = labels
        self.buckets = buckets  # sorted upper bounds, +Inf implicit
        self.bucket_counts = [0] * (len(buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._lock = lock

    def observe(self, value):
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    self.bucket_counts[i] += 1
                    return
            self.bucket_counts[-1] += 1

    def cumulative_buckets(self):
        """[(upper_bound, cumulative_count)] ending with (+Inf, count)."""
        out, running = [], 0
        for ub, c in zip(self.buckets, self.bucket_counts):
            running += c
            out.append((ub, running))
        out.append((math.inf, running + self.bucket_counts[-1]))
        return out


class Family:
    """One named metric with typed children per label-values tuple."""

    def __init__(self, name, kind, help_text, labelnames, lock,
                 buckets=None, registry=None):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(buckets)) if buckets else None
        self._lock = lock
        self._registry = registry
        self._children = {}

    def _make_child(self, labels):
        if self.kind == "counter":
            return Counter(labels, self._lock)
        if self.kind == "gauge":
            return Gauge(labels, self._lock)
        return Histogram(labels, self._lock, self.buckets)

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError("metric %r takes labels %s, got %s"
                             % (self.name, self.labelnames, sorted(kv)))
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                reg = self._registry
                cap = reg.label_cardinality_cap if reg is not None \
                    else 0
                # 0/None = unbounded, the repo-wide "off" convention
                if cap and self.labelnames and \
                        len(self._children) >= cap:
                    # Cardinality backstop: per-request/per-session
                    # labels (the "g<N>:*" / "e<N>:*" pattern) must
                    # not grow a family without bound when a caller
                    # forgets the retirement sweep. Dropping the
                    # OLDEST child loses its history — counted, so an
                    # operator sees the leak instead of the OOM.
                    oldest = next(iter(self._children))
                    del self._children[oldest]
                    reg._label_evictions += 1
                    if self.name != _LABEL_EVICTIONS_NAME:
                        reg.counter(
                            _LABEL_EVICTIONS_NAME,
                            "Labeled children evicted by the registry "
                            "cardinality cap (a leak signal: some "
                            "per-request label set is not being "
                            "retired)").inc()
                child = self._make_child(dict(zip(self.labelnames, key)))
                self._children[key] = child
            return child

    def children(self):
        with self._lock:
            return dict(self._children)

    def remove(self, **kv):
        """Drop children whose labels match every given key=value."""
        with self._lock:
            for key in [k for k, c in self._children.items()
                        if all(c.labels_dict.get(n) == str(v)
                               for n, v in kv.items())]:
                del self._children[key]

    # label-less families act as their own single child
    def _default(self):
        return self.labels()

    def inc(self, amount=1.0):
        self._default().inc(amount)

    def set(self, value):
        self._default().set(value)

    def dec(self, amount=1.0):
        self._default().dec(amount)

    def observe(self, value):
        self._default().observe(value)

    @property
    def value(self):
        return self._default().value


_LABEL_EVICTIONS_NAME = "paddle_metrics_label_evictions_total"

# families may legitimately key on per-replica/per-session labels, but
# anything past this many live children of ONE family is a retirement
# bug, not a deployment shape (override via REGISTRY attribute)
DEFAULT_LABEL_CARDINALITY_CAP = 1024


class Registry:
    """Named families; idempotent creation, mismatched re-creation raises."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families = {}
        # bumped by reset(); holders of cached children compare it to
        # drop stale references
        self.generation = 0
        # per-family bound on live labeled children (see Family.labels)
        self.label_cardinality_cap = DEFAULT_LABEL_CARDINALITY_CAP
        self._label_evictions = 0

    def _get_or_create(self, name, kind, help_text, labelnames, buckets):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        "metric %r re-registered as %s%s (was %s%s)"
                        % (name, kind, tuple(labelnames), fam.kind,
                           fam.labelnames))
                if kind == "histogram" and buckets is not None and \
                        tuple(sorted(buckets)) != fam.buckets:
                    self._override_buckets(fam, buckets)
                return fam
            if kind == "histogram" and buckets is None:
                buckets = DEFAULT_TIME_BUCKETS
            fam = Family(name, kind, help_text, labelnames, self._lock,
                         buckets=buckets, registry=self)
            self._families[name] = fam
            return fam

    def _override_buckets(self, fam, buckets):
        """Per-metric bucket override: re-registering a histogram with
        different boundaries re-buckets it — legal only while no child
        has observations (cumulative counts cannot be re-binned), so
        call sites override at arm-time, before traffic."""
        if any(c.count for c in fam._children.values()):
            raise ValueError(
                "histogram %r already holds observations — bucket "
                "override %s must happen before traffic (was %s)"
                % (fam.name, tuple(sorted(buckets)), fam.buckets))
        fam.buckets = tuple(sorted(buckets))
        for child in fam._children.values():
            child.buckets = fam.buckets
            child.bucket_counts = [0] * (len(fam.buckets) + 1)

    def set_buckets(self, name, buckets):
        """Explicit bucket override for a registered (still-unused)
        histogram — the arm-time hook for serving-appropriate
        boundaries on metrics declared with library defaults."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                raise KeyError("no histogram %r registered" % name)
            if fam.kind != "histogram":
                raise ValueError("metric %r is a %s, not a histogram"
                                 % (name, fam.kind))
            if tuple(sorted(buckets)) != fam.buckets:
                self._override_buckets(fam, buckets)
            return fam

    def remove_labeled(self, label, value=None, prefix=None):
        """Sweep EVERY family, dropping children whose ``label`` equals
        ``value`` or starts with ``prefix``: the ``g<N>:*``
        retirement pattern: one call retires a whole
        scheduler's/engine's namespace of per-replica children across
        all the families that labelled on it. Returns the number of
        children removed."""
        if (value is None) == (prefix is None):
            raise ValueError("pass exactly one of value= / prefix=")
        removed = 0
        with self._lock:
            for fam in self._families.values():
                if label not in fam.labelnames:
                    continue
                for key in [k for k, c in fam._children.items()
                            if (c.labels_dict.get(label) == str(value)
                                if value is not None else
                                str(c.labels_dict.get(label, ""))
                                .startswith(prefix))]:
                    del fam._children[key]
                    removed += 1
        return removed

    @property
    def label_evictions(self):
        return self._label_evictions

    def counter(self, name, help_text="", labelnames=()):
        return self._get_or_create(name, "counter", help_text, labelnames,
                                   None)

    def gauge(self, name, help_text="", labelnames=()):
        return self._get_or_create(name, "gauge", help_text, labelnames,
                                   None)

    def histogram(self, name, help_text="", labelnames=(), buckets=None):
        """``buckets=None`` = don't care: DEFAULT_TIME_BUCKETS at
        creation, and a later fetch never re-buckets an existing
        family. Explicit ``buckets`` on an existing family is a
        per-metric override (legal while unused — see set_buckets)."""
        return self._get_or_create(name, "histogram", help_text,
                                   labelnames, buckets)

    def families(self):
        with self._lock:
            return dict(self._families)

    def reset(self):
        """Drop every child (families stay registered, handles stay valid
        for label-less access; held children keep counting into dropped
        objects, so re-resolve after a reset — ``generation`` is bumped
        so caching holders can detect this)."""
        with self._lock:
            for fam in self._families.values():
                fam._children.clear()
            self.generation += 1

    # -- exposition ------------------------------------------------------
    def snapshot(self):
        """One CONSISTENT point-in-time copy of every family, taken
        under a single hold of the registry lock (children share it, so
        no recorder can move a value mid-walk):
        ``[(name, kind, help, buckets, [(labels_dict, payload), ...])]``
        sorted by name and label key. Payload is a float for
        counters/gauges, ``(bucket_counts, count, sum, vmin, vmax)``
        for histograms (raw per-bucket counts, NOT cumulative).

        Formatting (``expose_text``/``dump``) reads this, then works
        outside the lock: a scrape concurrent with labeled-child
        creation can never render a half-updated family."""
        with self._lock:
            out = []
            for name in sorted(self._families):
                fam = self._families[name]
                children = []
                for key in sorted(fam._children):
                    c = fam._children[key]
                    if fam.kind == "histogram":
                        payload = (list(c.bucket_counts), c.count,
                                   c.sum, c.vmin, c.vmax)
                    else:
                        payload = c._value
                    children.append((dict(c.labels_dict), payload))
                out.append((name, fam.kind, fam.help, fam.buckets,
                            children))
            return out

    @staticmethod
    def _cumulative(buckets, bucket_counts):
        """[(upper_bound, cumulative_count)] ending with (+Inf, total)
        — the snapshot-payload analog of
        :meth:`Histogram.cumulative_buckets`."""
        out, running = [], 0
        for ub, c in zip(buckets, bucket_counts):
            running += c
            out.append((ub, running))
        out.append((math.inf, running + bucket_counts[-1]))
        return out

    def expose_text(self):
        """Prometheus text exposition format 0.0.4 — formatted from
        one consistent :meth:`snapshot`, outside the registry lock."""
        return format_snapshot_text(self.snapshot())

    def dump(self):
        """JSON-ready dict: {name: {type, help, samples: [...]}} —
        built from one consistent :meth:`snapshot`."""
        out = {}
        for name, kind, help_text, buckets, children in self.snapshot():
            samples = []
            for labels, payload in children:
                if kind == "histogram":
                    counts, count, vsum, vmin, vmax = payload
                    samples.append({
                        "labels": labels,
                        "count": count,
                        "sum": vsum,
                        "min": None if count == 0 else vmin,
                        "max": None if count == 0 else vmax,
                        "buckets": {_format_value(ub): cum for ub, cum
                                    in self._cumulative(buckets,
                                                        counts)},
                    })
                else:
                    samples.append({"labels": labels,
                                    "value": payload})
            out[name] = {"type": kind, "help": help_text,
                         "samples": samples}
        return out

    def dump_json(self, indent=None):
        return json.dumps(self.dump(), indent=indent, sort_keys=True)


def format_snapshot_text(snap, help_texts=None):
    """Prometheus text 0.0.4 from a :meth:`Registry.snapshot`-shaped
    structure. ``help_texts`` optionally overrides/provides HELP lines
    by family name."""
    lines = []
    for name, kind, help_text, buckets, children in snap:
        if not children:
            continue
        if help_texts is not None and name in help_texts:
            help_text = help_texts[name]
        if help_text:
            lines.append("# HELP %s %s" % (name, help_text))
        lines.append("# TYPE %s %s" % (name, kind))
        for labels, payload in children:
            if kind == "histogram":
                counts, count, vsum, _vmin, _vmax = payload
                for ub, cum in Registry._cumulative(buckets, counts):
                    lines.append("%s_bucket%s %d" % (
                        name, _label_suffix(labels,
                                            {"le": _format_value(ub)}),
                        cum))
                lines.append("%s_sum%s %s" % (
                    name, _label_suffix(labels), repr(float(vsum))))
                lines.append("%s_count%s %d" % (
                    name, _label_suffix(labels), count))
            else:
                lines.append("%s%s %s" % (
                    name, _label_suffix(labels),
                    _format_value(payload)))
    return "\n".join(lines) + "\n"


REGISTRY = Registry()


def default_registry():
    return REGISTRY
