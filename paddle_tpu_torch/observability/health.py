"""Component health registry (reference
``paddle_tpu/observability/health.py``, without its introspection
providers, which only the reference's HTTP pages read): the data source
of the reference's ``/healthz``, kept free of any web server so serving
constructors (a generation scheduler registers itself here) pay nothing
for it.

Components register a zero-arg callable returning a dict with at least
``{"healthy": bool}``; a callable returning None (its owner was garbage
collected: registrants close over a weakref) is dropped lazily.
Callables must not block.
"""

import threading

__all__ = ["register_health", "unregister_health", "health_snapshot"]

_HEALTH = {}
_HEALTH_LOCK = threading.Lock()


def register_health(name, fn):
    """Register component ``name``'s health callable (idempotent —
    latest wins)."""
    with _HEALTH_LOCK:
        _HEALTH[name] = fn


def unregister_health(name):
    with _HEALTH_LOCK:
        _HEALTH.pop(name, None)


def health_snapshot():
    """Aggregate health: ``{"status": "ok"|"degraded", "components":
    {...}}`` — degraded when ANY component reports unhealthy or its
    callable raises; stale (None-returning) components drop out."""
    with _HEALTH_LOCK:
        items = list(_HEALTH.items())
    components, healthy = {}, True
    for name, fn in items:
        try:
            state = fn()
        except Exception as exc:
            state = {"healthy": False, "error": repr(exc)[:200]}
        if state is None:  # owner gone: lazy unregister
            unregister_health(name)
            continue
        components[name] = state
        if not state.get("healthy", True):
            healthy = False
    return {"status": "ok" if healthy else "degraded",
            "components": components}
