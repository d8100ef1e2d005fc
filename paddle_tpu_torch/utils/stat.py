"""Stat timers: spans aggregated into a printable report (reference
``paddle_tpu/utils/stat.py``).

Parity with the legacy ``REGISTER_TIMER*`` / ``StatSet`` machinery
(``paddle/utils/Stat.h:114,230-263``): named spans accumulate count/total/
min/max and print a sorted summary table.

A ``StatSet`` is a *view* over the metrics registry
(``observability/metrics.py``): each ``add`` observes into the
``paddle_stat_span_seconds`` histogram labeled by (set, stat), each
gauge lands in ``paddle_stat_gauge``, so the legacy ``report()`` table
and the Prometheus/JSON expositions read the same numbers. Spans also
record a host trace event when tracing is armed (config flag
``telemetry`` or an explicit ``tracing.start()``).
"""

import time

from ..observability import metrics as _metrics
from ..observability import tracing as _tracing

__all__ = ["timer", "stat_set", "StatSet"]


class _SpanCtx:
    """Timer span: one perf_counter pair, optional trace event, one
    histogram observe. Cheaper than a contextlib generator on the step
    hot path."""

    __slots__ = ("_stat_set", "_key", "_t0")

    def __init__(self, stat_set_, key):
        self._stat_set = stat_set_
        self._key = key

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tracer = _tracing._TRACER
        if tracer.enabled:
            tracer._record(self._key, self._t0, t1, None)
        self._stat_set.add(self._key, t1 - self._t0)
        return False


class StatSet:
    def __init__(self, name="GlobalStatInfo", registry=None):
        self.name = name
        self._registry = registry or _metrics.REGISTRY
        self._spans = self._registry.histogram(
            "paddle_stat_span_seconds",
            "Host-side stat timer spans (legacy StatSet view)",
            labelnames=("set", "stat"))
        self._gauges_fam = self._registry.gauge(
            "paddle_stat_gauge",
            "Point-in-time stat gauges (legacy StatSet view)",
            labelnames=("set", "gauge"))
        # per-key child cache: hot spans skip labels() resolution and
        # its registry lock (GIL-safe dict ops; see metrics.py header);
        # dropped wholesale when the registry generation moves (reset)
        self._span_children = {}
        self._gen = self._registry.generation

    def add(self, key, dt):
        if self._gen != self._registry.generation:
            self._span_children = {}
            self._gen = self._registry.generation
        child = self._span_children.get(key)
        if child is None:
            child = self._spans.labels(set=self.name, stat=key)
            self._span_children[key] = child
        child.observe(dt)

    def span(self, key):
        return _SpanCtx(self, key)

    def reset(self):
        self._span_children = {}
        self._spans.remove(set=self.name)
        self._gauges_fam.remove(set=self.name)

    def set_gauges(self, gauges):
        """Record point-in-time values (e.g. arena peak bytes)."""
        for key, v in gauges.items():
            child = self._gauges_fam.labels(set=self.name, gauge=key)
            try:
                child.set(v)
            except (TypeError, ValueError):
                child.set(1.0 if v else 0.0)  # non-numeric: truthiness

    def _own(self, family):
        return {c.labels_dict["stat" if "stat" in c.labels_dict
                              else "gauge"]: c
                for c in family.children().values()
                if c.labels_dict.get("set") == self.name}

    def gauges(self):
        return {k: c.value for k, c in self._own(self._gauges_fam).items()}

    def report(self):
        """Sorted summary (total desc), like StatSet::printAllStatus."""
        lines = ["======= StatSet: [%s] status ======" % self.name,
                 "%-32s %8s %12s %12s %12s %12s" %
                 ("Stat", "count", "total(ms)", "avg(ms)", "max(ms)",
                  "min(ms)")]
        stats = self._own(self._spans)
        for key, s in sorted(stats.items(), key=lambda kv: -kv[1].sum):
            lines.append("%-32s %8d %12.2f %12.3f %12.3f %12.3f" % (
                key, s.count, s.sum * 1e3,
                s.sum / s.count * 1e3 if s.count else 0.0,
                s.vmax * 1e3 if s.count else 0.0,
                s.vmin * 1e3 if s.count else 0.0))
        for key, c in sorted(self._own(self._gauges_fam).items()):
            v = c.value
            lines.append("%-32s %s" % (
                key, int(v) if float(v).is_integer() else v))
        return "\n".join(lines)

    def items(self):
        return {k: (s.count, s.sum) for k, s in
                self._own(self._spans).items()}


stat_set = StatSet()


def timer(key):
    """``with timer("forwardBackward"): ...`` — REGISTER_TIMER analog."""
    return stat_set.span(key)
