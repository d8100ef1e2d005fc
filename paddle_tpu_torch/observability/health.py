"""Component health and introspection-provider registries (reference
``paddle_tpu/observability/health.py``): the data sources of
``/healthz``, ``/metrics``, ``/debug/fleet`` and ``/debug/slo``
(``http.py``), kept free of any web server so serving constructors (a
generation scheduler registers itself here) pay nothing for it.

Components register a zero-arg callable returning a dict with at least
``{"healthy": bool}``; a callable returning None (its owner was garbage
collected: registrants close over a weakref) is dropped lazily.
Callables must not block: they run on the scrape thread.

A provider is a callable registered under a *kind* (``"metrics"``:
fn(member=None) -> exposition text; ``"fleet"`` / ``"slo"``: fn() -> a
JSON-ready dict) and a name; a None result means its owner is gone and
unregisters it, as for health.
"""

import threading

__all__ = ["register_health", "unregister_health", "health_snapshot",
           "register_provider", "unregister_provider", "providers",
           "provider_snapshot"]

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


# -- introspection providers --------------------------------------------
_PROVIDERS = {}  # kind -> {name: fn}
_PROVIDERS_LOCK = threading.Lock()


def register_provider(kind, name, fn):
    """Register an introspection provider (idempotent: latest wins)."""
    with _PROVIDERS_LOCK:
        _PROVIDERS.setdefault(kind, {})[name] = fn


def unregister_provider(kind, name):
    with _PROVIDERS_LOCK:
        _PROVIDERS.get(kind, {}).pop(name, None)


def providers(kind):
    """{name: fn} for ``kind`` (a copy: call outside the lock)."""
    with _PROVIDERS_LOCK:
        return dict(_PROVIDERS.get(kind, {}))


def provider_snapshot(kind, *args, **kwargs):
    """Call every ``kind`` provider: {name: result}. A raising provider
    contributes its error; a None result drops the provider (its owner
    is gone)."""
    out = {}
    for name, fn in sorted(providers(kind).items()):
        try:
            res = fn(*args, **kwargs)
        except Exception as exc:
            out[name] = {"error": repr(exc)[:200]}
            continue
        if res is None:
            unregister_provider(kind, name)
            continue
        out[name] = res
    return out
