"""Live-introspection HTTP server, stdlib only (reference
``paddle_tpu/observability/http.py``).

It serves the registry, the request traces and the flight recorder's
bundles, off by default through the
``telemetry_port`` config flag (0 = no server, no socket, nothing
imported on the serving paths):

=====================  ==============================================
endpoint               payload
=====================  ==============================================
``/metrics``           Prometheus text exposition 0.0.4. With a
                       FleetRouter in-process its fleet-merged view
                       is served instead (``?member=`` drills into
                       one member's raw snapshot); otherwise
                       ``metrics.REGISTRY.expose_text()``
``/healthz``           aggregate component health, 200/503 —
                       engines and generation schedulers register
                       themselves via :func:`register_health`
``/debug/trace?id=X``  one request's span tree
                       (``request_trace.span_tree``); without ``id``,
                       the known trace ids (oldest first); with
                       ``&fmt=chrome``, the Perfetto-loadable
                       chrome-trace rendering
``/debug/fleet``       fleet membership/generation/breaker/load +
                       telemetry snapshot ages (the "fleet"
                       introspection providers)
``/debug/slo``         the SLO tracker's machine-readable verdict
``/debug/flight``      the latest flight-recorder bundle
=====================  ==============================================

``start_server(port)`` binds 127.0.0.1 (introspection is a local/
sidecar surface, not a public API; front a real ingress if you need
one) on a daemon thread; ``port=0`` asks the OS for an ephemeral port
(tests, probes). The observability config hook starts/stops the
module-level server when the ``telemetry_port`` flag changes, so
``config.set_flags(telemetry_port=9100)`` is the whole deployment
story.

Health components register a zero-arg callable returning a dict with
at least ``{"healthy": bool}``; a callable returning None (its owner
was garbage collected: registrants close over a weakref) is dropped
lazily. Callables must not block: they run on the request thread.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from . import flight as _flight
from . import metrics as _metrics
from . import request_trace as _rtrace
# the registry itself lives in observability/health.py (no web-server
# imports there — serving constructors register without paying for
# http.server); re-exported here for the scrape-side callers
from .health import (health_snapshot, providers,  # noqa: F401
                     provider_snapshot, register_health,
                     unregister_health, unregister_provider)

__all__ = ["TelemetryServer", "start_server", "stop_server",
           "active_server", "register_health", "unregister_health",
           "health_snapshot"]


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle-tpu-telemetry/1.0"

    def log_message(self, fmt, *args):  # stay out of stderr
        from ..utils import log as _log
        _log.vlog(2, "telemetry-http: " + fmt % args)

    def _send(self, code, body, ctype="application/json"):
        data = body.encode("utf-8") if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _metrics_text(self, member):
        """The /metrics payload. With a fleet-merged provider
        registered (a FleetRouter lives here), the fleet view wins —
        ``?member=`` drills into one member's raw snapshot (None =
        unknown member, a 404). Providers whose owner is gone
        unregister lazily and the local registry takes back over."""
        for name, fn in sorted(providers("metrics").items()):
            try:
                text = fn(member)
            except Exception:
                continue
            if text is None:
                unregister_provider("metrics", name)
                continue
            if member and text == "":
                return None  # provider alive, member unknown
            return text
        if member:
            return None
        return _metrics.REGISTRY.expose_text()

    def do_GET(self):
        try:
            url = urlparse(self.path)
            qs = parse_qs(url.query)
            if url.path == "/metrics":
                member = (qs.get("member") or [None])[0]
                text = self._metrics_text(member)
                if text is None:
                    self._send(404, json.dumps(
                        {"error": "unknown member %r" % member}))
                else:
                    self._send(200, text,
                               ctype="text/plain; version=0.0.4")
            elif url.path == "/healthz":
                snap = health_snapshot()
                self._send(200 if snap["status"] == "ok" else 503,
                           json.dumps(snap, sort_keys=True))
            elif url.path == "/debug/trace":
                tid = (qs.get("id") or [None])[0]
                fmt = (qs.get("fmt") or [None])[0]
                if tid is None:
                    self._send(200, json.dumps(
                        {"traces": _rtrace.trace_ids()}))
                elif fmt == "chrome":
                    doc = _rtrace.chrome_trace(tid)
                    if doc is None:
                        self._send(404, json.dumps(
                            {"error": "unknown trace %r" % tid}))
                    else:
                        self._send(200, json.dumps(doc))
                else:
                    tree = _rtrace.span_tree(tid)
                    if tree is None:
                        self._send(404, json.dumps(
                            {"error": "unknown trace %r" % tid}))
                    else:
                        self._send(200, json.dumps(tree))
            elif url.path == "/debug/fleet":
                docs = provider_snapshot("fleet")
                if not docs:
                    self._send(404, json.dumps(
                        {"error": "no fleet router in this process"}))
                elif len(docs) == 1:
                    self._send(200, json.dumps(next(iter(
                        docs.values()))))
                else:
                    self._send(200, json.dumps(docs))
            elif url.path == "/debug/slo":
                docs = provider_snapshot("slo")
                if not docs:
                    self._send(404, json.dumps(
                        {"error": "no SLO tracker in this process"}))
                elif len(docs) == 1:
                    self._send(200, json.dumps(next(iter(
                        docs.values()))))
                else:
                    self._send(200, json.dumps(docs))
            elif url.path == "/debug/flight":
                bundle = _flight.RECORDER.latest()
                if bundle is None:
                    self._send(404, json.dumps(
                        {"error": "no flight-recorder dump yet"}))
                else:
                    self._send(200, json.dumps(bundle))
            else:
                self._send(404, json.dumps(
                    {"error": "unknown path %r" % url.path,
                     "endpoints": ["/metrics", "/healthz",
                                   "/debug/trace?id=",
                                   "/debug/fleet", "/debug/slo",
                                   "/debug/flight"]}))
        except BrokenPipeError:
            pass
        except Exception as exc:
            try:
                self._send(500, json.dumps({"error": repr(exc)[:300]}))
            except Exception:
                pass


class TelemetryServer:
    """ThreadingHTTPServer on a daemon thread; ``.port`` is the bound
    port (useful with port=0)."""

    def __init__(self, port=0, host="127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.host = host
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="telemetry-http-%d" % self.port, daemon=True)
        self._thread.start()

    @property
    def url(self):
        return "http://%s:%d" % (self.host, self.port)

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


_SERVER = None
_SERVER_LOCK = threading.Lock()


def start_server(port=0):
    """Start (or return) the module-level server. A running server on
    a different port is restarted."""
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is not None:
            if port in (0, _SERVER.port):
                return _SERVER
            _SERVER.stop()
            _SERVER = None
        _SERVER = TelemetryServer(port=port)
        return _SERVER


def stop_server():
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is not None:
            _SERVER.stop()
            _SERVER = None


def active_server():
    return _SERVER


def _sync_port_flag(port):
    """Config-hook entry: ``telemetry_port`` changed. 0 stops the
    module server; N starts/moves it. Binding failures are logged,
    never raised — a taken port must not break set_flags."""
    try:
        if not port:
            stop_server()
        elif _SERVER is None or _SERVER.port != int(port):
            start_server(int(port))
    except (OSError, OverflowError, ValueError) as exc:
        # a taken port, an out-of-range port (OverflowError from
        # socket.bind), or junk must log — never break set_flags
        from ..utils import log as _log
        _log.structured("telemetry_http_bind_failed", port=port,
                        error=repr(exc))
