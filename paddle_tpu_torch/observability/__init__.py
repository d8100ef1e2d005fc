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
* ``health``   — the component health registry a scheduler registers
  itself in.

The flags are synced into module state by :func:`_on_flags_changed`, a
``config._on_change`` hook, so no call site reads them per request. The
reference's HTTP exposition (``observability/http.py``) is not ported
yet (ROADMAP Queue A, "Resilience, deploy, observability"): a nonzero
``telemetry_port`` raises NotImplementedError.
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


# last-synced (request_tracing, sample_rate): the hook runs on every
# set_flags (fault arming flips fault_injection constantly in chaos
# tests), so the sync work is skipped when nothing of these changed
_last_sync = [None]


def _on_flags_changed(flags):
    tracing._TRACER.set_flag(flags.get("telemetry", False))
    if int(flags.get("telemetry_port", 0) or 0):
        # refused, not half-applied: the flag goes back to 0, so later
        # set_flags calls are not refused for it
        flags["telemetry_port"] = 0
        raise NotImplementedError(
            "telemetry_port: the HTTP exposition (/metrics, /healthz, "
            "/debug/*) is not ported yet (ROADMAP Queue A, \"Resilience, "
            "deploy, observability\")")
    state = (bool(flags.get("request_tracing", False)),
             float(flags.get("trace_sample_rate", 1.0) or 0.0))
    if state != _last_sync[0]:
        _last_sync[0] = state
        armed, rate = state
        request_trace._TRACER.set_flag(armed, sample_rate=rate)
        flight.RECORDER.set_armed(armed)


def _install_config_hook():
    from .. import config
    if _on_flags_changed not in config._on_change:
        config._on_change.append(_on_flags_changed)
    _on_flags_changed(config._flags)


_install_config_hook()
