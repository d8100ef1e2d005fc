"""Telemetry of the port (reference ``paddle_tpu/observability``):
the metrics registry, host spans, request-scoped traces and the flight
recorder.

* ``metrics``  — counters, gauges and histograms with labels, under the
  reference's metric names, labels and help text; Prometheus text
  (``metrics.REGISTRY.expose_text()``) and JSON
  (``metrics.REGISTRY.dump_json()``).
* ``tracing``  — nestable host spans -> Chrome trace-event JSON
  (``tracing.emit_chrome_trace(path)``), armed by the ``telemetry``
  flag.
* ``request_trace`` and ``flight`` — per-request span trees and the
  post-mortem ring, armed by the ``request_tracing`` flag.
* ``health``   — the component health and introspection-provider
  registries a scheduler registers itself in.
* ``slo``      — windowed SLO tracking: percentiles and multi-window
  burn rates over the request telemetry (``SLOTracker``).
* ``aggregate`` — mergeable registry snapshots and the fleet-side
  aggregator with per-(member, incarnation) delta accounting.
* ``http``     — the ``telemetry_port`` server: ``/metrics``,
  ``/healthz`` and ``/debug/*``; imported only once the flag is set.

The flags are synced into module state by :func:`_on_flags_changed`, a
``config._on_change`` hook, so no call site reads them per request.

Recovery events are always on, not gated by ``telemetry``: the
resilience counters (``paddle_resilience_*``, ``resilience/
supervisor.py``; ``paddle_checkpoint_*``, ``io.py``) and the elastic
ones (``paddle_elastic_*``) fire on rare events, never per step.
"""

from . import flight  # noqa: F401
from . import health  # noqa: F401
from . import metrics  # noqa: F401
from . import request_trace  # noqa: F401
from . import tracing  # noqa: F401


def enabled():
    """The ``telemetry`` config-flag state (metric hooks armed?)."""
    from .. import config
    return bool(config.get_flag("telemetry"))


# last-synced (request_tracing, sample_rate, telemetry_port): the hook
# runs on every set_flags (fault arming flips fault_injection constantly
# in chaos tests), so the sync work is skipped when nothing of these
# changed
_last_sync = [None]
_http_started = [False]


def _on_flags_changed(flags):
    tracing._TRACER.set_flag(flags.get("telemetry", False))
    state = (bool(flags.get("request_tracing", False)),
             float(flags.get("trace_sample_rate", 1.0) or 0.0),
             int(flags.get("telemetry_port", 0) or 0))
    armed, rate, port = state
    if state != _last_sync[0]:
        _last_sync[0] = state
        request_trace._TRACER.set_flag(armed, sample_rate=rate)
        flight.RECORDER.set_armed(armed)
    # the port sync is not deduplicated: a bind can fail (the port is
    # taken) and the same set_flags again must retry it. _sync_port_flag
    # does nothing when the server is bound already, and http.server is
    # imported only by a process that sets telemetry_port
    if port or _http_started[0]:
        from . import http as _http
        _http._sync_port_flag(port)
        _http_started[0] = bool(port)


def _install_config_hook():
    from .. import config
    if _on_flags_changed not in config._on_change:
        config._on_change.append(_on_flags_changed)
    _on_flags_changed(config._flags)


_install_config_hook()
