"""Thin line-protocol transport for the serving fleet (reference
``paddle_tpu/serving/wire.py``; frames are byte-identical to its frames
for the same message, so a router of either package talks to a worker
of either).

The reference system's distributed runtime speaks newline-framed
messages over plain TCP (the task master of ``native/task_master.cc``);
this module is that discipline for the serving tier, JSON instead of
positional verbs, stdlib sockets only:

* **framing** — one JSON object per ``\\n``-terminated line.
  :func:`send_msg` / :class:`LineConn` cap every read at
  :data:`MAX_LINE` bytes, so a corrupt or malicious peer can burn at
  most one bounded buffer, never the process (:class:`WireError`).
* **per-call timeouts** — every blocking socket op inherits the
  connection's timeout; a peer that stops talking is a
  ``socket.timeout`` (an OSError) after a bounded wait, not a hang.
* **retry with jittered exponential backoff** — :func:`call_once`
  retries transient connect/IO failures the way the master client
  does (uniform jitter over [d/2, d] decorrelates a reconnect herd
  after a router restart).
* **prompt teardown** — :class:`LineServer.close` and
  :meth:`LineConn.close` issue ``shutdown(SHUT_RDWR)`` before
  ``close()``: a peer blocked in ``recv`` unblocks now instead of
  waiting out its full read timeout.

Envelope notes: a fleet ``generate`` request carries the router-minted
decode ``seed`` (re-fed verbatim on every replay hop so sampled
generations re-drive bit-identically), and each worker ack carries the
member's decode-policy fingerprint ``policy``: the router gates
replay-journal reuse on it exactly as it gates on the weights
``version``. The optional ``tenant`` field follows the same
discipline: stamped once at the router's front door, re-sent on every
replay hop (the journal lives router-side), absent entirely for
single-tenant traffic so tenant-less frames stay byte-identical. The
optional ``model`` field too: the generate envelope names the catalog
model the hop must decode under (the worker activates it or refuses
with ``kind="model"``), the ack carries the member's active model id
(the router's third journal-reuse fence beside ``version`` and
``policy``), and ``reg``/``hb`` frames from model-named workers carry
``models`` (the resident set) and ``active_model``; model-less workers
send none of these.
Control verbs: ``reg``/``hb``/``unreg`` (membership), ``swap``/
``rollback`` (deploys), ``page_in``/``page_out`` (multi-model weight
paging: manifest-verified staged load through the swap gates, or
resident-snapshot drop; serving/model_paging.py), ``health``,
``metrics`` (final snapshot ship), and ``stop``, the drain-then-exit
verb the autoscaler's retire path sends (a subprocess worker's
``serve_forever`` unblocks, closes, and unregisters).

Nothing here is constructed by default flags: the module has no
import-time side effects beyond defining classes. It is host code
only; no frame carries a tensor (every token, length and seed is a
Python ``int`` before it is framed).
"""

import json
import random
import socket
import threading
import time

__all__ = ["WireError", "MAX_LINE", "send_msg", "encoded_size",
           "LineConn", "LineServer", "call_once", "retry_delay"]

# One framed message may carry a whole replay journal (prompt plus
# every generated token as JSON ints) or a packed feed — 8 MiB bounds
# the read buffer without constraining any realistic request.
MAX_LINE = 8 << 20


class WireError(RuntimeError):
    """Protocol-level failure: over-long line, non-JSON frame, or a
    reply that is not the shape the caller asked for."""


def send_msg(sock, obj):
    """One JSON object as one newline-terminated line (compact
    separators: the token-stream path sends thousands of these)."""
    data = json.dumps(obj, separators=(",", ":")).encode() + b"\n"
    if len(data) > MAX_LINE:
        raise WireError("message of %d bytes exceeds the %d-byte "
                        "frame cap" % (len(data), MAX_LINE))
    sock.sendall(data)


def encoded_size(obj):
    """The exact on-wire byte count ``send_msg`` would frame ``obj``
    as (newline included) — how snapshot shippers budget against
    :data:`MAX_LINE` without paying a throwaway send."""
    return len(json.dumps(obj, separators=(",", ":")).encode()) + 1


def retry_delay(attempt, backoff=0.05, cap=2.0):
    """Jittered exponential backoff (MasterClient discipline): uniform
    over [d/2, d] with d = min(cap, backoff * 2**attempt)."""
    d = min(cap, backoff * (2 ** attempt))
    return d * (0.5 + 0.5 * random.random())


class LineConn:
    """One framed connection: ``send(obj)`` / ``recv() -> obj|None``
    (None = orderly EOF). Not thread-safe; give each thread its own,
    or split send/recv between exactly two threads (socket objects
    support one reader + one writer concurrently, which is how the
    worker streams tokens while watching for a client reset)."""

    def __init__(self, sock, timeout=None):
        if timeout is not None:
            sock.settimeout(timeout)
        self.sock = sock
        self._rfile = sock.makefile("rb")

    @classmethod
    def connect(cls, addr, timeout=10.0):
        return cls(socket.create_connection(tuple(addr),
                                            timeout=timeout),
                   timeout=timeout)

    def settimeout(self, timeout):
        self.sock.settimeout(timeout)

    def send(self, obj):
        send_msg(self.sock, obj)

    def recv(self):
        """Next decoded message, or None on EOF. Raises WireError on
        an over-long or non-JSON line, socket.timeout (OSError) on a
        silent peer."""
        line = self._rfile.readline(MAX_LINE + 1)
        if not line:
            return None
        if len(line) > MAX_LINE:
            raise WireError("peer sent a line past the %d-byte cap"
                            % MAX_LINE)
        try:
            return json.loads(line)
        except ValueError as exc:
            raise WireError("bad frame: %r" % line[:80]) from exc

    def close(self):
        """shutdown(SHUT_RDWR) then close: the peer's blocked recv
        returns immediately instead of waiting out its timeout."""
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        for f in (self._rfile, self.sock):
            try:
                f.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def call_once(addr, obj, timeout=5.0, retries=3, backoff=0.05):
    """One request/reply round trip on a fresh connection, with
    jittered-backoff retries on transient connect/IO failures — the
    control-plane shape (register, heartbeat, swap). Raises
    ConnectionError when every attempt failed, WireError on a framing
    violation (not retried: the peer is speaking, just wrongly)."""
    last = None
    for attempt in range(retries):
        try:
            with LineConn.connect(addr, timeout=timeout) as conn:
                conn.send(obj)
                reply = conn.recv()
            if reply is None:
                raise ConnectionError("peer closed before replying")
            return reply
        except WireError:
            raise
        except (OSError, ConnectionError) as exc:
            last = exc
        if attempt + 1 < retries:
            # back off only when another attempt remains: the final
            # failure raises immediately instead of sleeping dead
            # latency into every failover/rollback/teardown path
            time.sleep(retry_delay(attempt, backoff=backoff))
    raise ConnectionError("no reply from %s:%d after %d attempts: %r"
                          % (tuple(addr) + (retries, last)))


class LineServer:
    """Threaded accept loop: ``handler(conn, msg)`` per received
    message, one daemon thread per connection. ``close()`` shuts the
    listener AND every live connection down (SHUT_RDWR first), so
    peers blocked in recv unblock promptly and the accept thread
    joins bounded."""

    def __init__(self, handler, host="127.0.0.1", port=0,
                 timeout=None, name="line-server"):
        self.handler = handler
        self.timeout = timeout
        self.name = name
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()
        self._closed = False
        self._conns = set()
        self._lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name=name)
        self._accept_thread.start()

    @property
    def addr(self):
        return (self.host, self.port)

    def _accept_loop(self):
        while not self._closed:
            try:
                sock, _peer = self._sock.accept()
            except OSError:
                return  # listener closed
            conn = LineConn(sock, timeout=self.timeout)
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name="%s-conn" % self.name).start()

    def _serve_conn(self, conn):
        try:
            while True:
                try:
                    msg = conn.recv()
                except (WireError, OSError, ValueError):
                    # ValueError: close() closed the file under a
                    # blocked read (teardown), not a protocol fault
                    return
                if msg is None:
                    return
                try:
                    if self.handler(conn, msg) is False:
                        return  # handler took ownership / closed
                except Exception:
                    # a handler bug must not kill the accept fabric;
                    # best-effort error frame, then drop the conn
                    try:
                        conn.send({"ok": False,
                                   "error": "internal handler error"})
                    except OSError:
                        pass
                    return
        finally:
            conn.close()
            with self._lock:
                self._conns.discard(conn)

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns = list(self._conns)
        # a thread blocked in accept() is NOT reliably woken by
        # close() alone on Linux — shutdown first, and kick it with a
        # throwaway self-connect as the portable fallback
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            kick = socket.create_connection((self.host, self.port),
                                            timeout=0.2)
            kick.close()
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        for conn in conns:
            conn.close()  # SHUT_RDWR: blocked peers unblock NOW
        self._accept_thread.join(timeout=2.0)
