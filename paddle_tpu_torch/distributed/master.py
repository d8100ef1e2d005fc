"""Client and launcher of the elastic task master (reference
``paddle_tpu/distributed/master.py``).

The master is the reference's daemon, ``native/task_master.cc``, built
unchanged by ``native.task_master_binary``: task leases with epochs,
timeout requeue, a failure budget, a disk snapshot it restarts from, and
the cluster membership (REG/HB/MEMBERS) the elastic runtime fences
with. The client speaks its line protocol, so the port's client and the
reference's talk to one master. ``ElasticDataDispatcher`` serves
RecordIO chunks (``reader/recordio.py``) as the master's tasks.
"""

import os
import random
import socket
import subprocess
import time

from .. import native

__all__ = ["MasterServer", "MasterClient", "ElasticDataDispatcher",
           "GenerationMismatch"]


class GenerationMismatch(RuntimeError):
    """A call carried a stale cluster generation (the caller belongs to
    a membership epoch that a worker death has since superseded). The
    current generation rides along so the caller can re-register."""

    def __init__(self, current_generation, message=None):
        super().__init__(message or
                         "stale cluster generation (current is %d)"
                         % current_generation)
        self.current_generation = current_generation


class MasterServer:
    """Spawns the task_master daemon on localhost (built at first use).

    ``heartbeat_timeout_ms`` is the membership deadline: a worker that
    REGistered and then misses heartbeats for this long is declared
    dead (generation bump and immediate re-lease of its chunks).
    Workers that never register are unaffected.
    """

    def __init__(self, snapshot_path, port=0, timeout_sec=30,
                 failure_max=3, heartbeat_timeout_ms=10000):
        binary = native.task_master_binary()
        self.proc = subprocess.Popen(
            [binary, str(port), snapshot_path, str(timeout_sec),
             str(failure_max), str(int(heartbeat_timeout_ms))],
            stdout=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline().strip()
        if not line.startswith("LISTENING"):
            raise RuntimeError("task_master failed to start: %r" % line)
        self.port = int(line.split()[1])
        self.snapshot_path = snapshot_path

    def stop(self, graceful=True):
        """Stop the daemon. ``graceful`` sends SHUTDOWN and waits: the
        master answers every client line already on the wire (including
        lines queued behind the SHUTDOWN itself) before its connection
        threads close — in-flight work drains instead of dying with a
        reset socket."""
        if self.proc.poll() is not None:
            return
        if graceful:
            try:
                MasterClient(self.port).shutdown()
                self.proc.wait(timeout=5)
                return
            except Exception:
                pass
        self.proc.kill()
        self.proc.wait()

    def kill(self):
        """Hard-kill (for failover tests)."""
        self.proc.kill()
        self.proc.wait()


class MasterClient:
    """One line-protocol connection. Not thread-safe: give each thread
    (a heartbeat thread, say) its own client."""

    def __init__(self, port, host="127.0.0.1", retries=3,
                 backoff=0.1, backoff_cap=2.0):
        self.addr = (host, port)
        self.retries = retries
        self.backoff = backoff
        self.backoff_cap = backoff_cap
        self._sock = None
        self._file = None

    def _connect(self):
        s = socket.create_connection(self.addr, timeout=10)
        self._file = s.makefile("r")
        self._sock = s

    def _close(self):
        """Release the socket and its makefile wrapper: dropping the
        references without close() would leak both descriptors on every
        reconnect or failure until the collector runs."""
        for f in (self._file, self._sock):
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass
        self._file = None
        self._sock = None

    def _retry_delay(self, attempt):
        """Jittered exponential backoff, uniform over [d/2, d]: workers
        cut off together do not reconnect to a restarting master in
        lockstep."""
        d = min(self.backoff_cap, self.backoff * (2 ** attempt))
        return d * (0.5 + 0.5 * random.random())

    def _call(self, line):
        for attempt in range(self.retries):
            try:
                if self._sock is None:
                    self._connect()
                self._sock.sendall((line + "\n").encode())
                resp = self._file.readline()
                if resp:
                    return resp.strip()
            except OSError:
                pass
            self._close()
            time.sleep(self._retry_delay(attempt))
        raise ConnectionError("master unreachable at %s:%d" % self.addr)

    @staticmethod
    def _fence_check(resp):
        if resp.startswith("GENMISMATCH"):
            raise GenerationMismatch(int(resp.split()[1]))
        return resp

    @staticmethod
    def _gen_suffix(generation):
        return "" if generation is None else " %d" % generation

    def ping(self):
        return self._call("PING") == "PONG"

    def add_task(self, task_id, payload=""):
        return self._call("ADD %s %s" % (task_id, payload))

    def get_task(self, worker_id="w0", generation=None):
        """Returns (task_id, epoch, payload) or None (retry later) or
        'ALLDONE'. With ``generation``, the call is fenced: a stale
        generation raises GenerationMismatch instead of leasing."""
        resp = self._fence_check(self._call(
            "GET %s%s" % (worker_id, self._gen_suffix(generation))))
        if resp == "NONE":
            return None
        if resp == "ALLDONE":
            return "ALLDONE"
        parts = resp.split(" ", 3)
        return (parts[1], int(parts[2]),
                parts[3] if len(parts) > 3 else "")

    def task_finished(self, task_id, epoch, generation=None):
        return self._fence_check(self._call(
            "FIN %s %d%s" % (task_id, epoch,
                             self._gen_suffix(generation))))

    def task_failed(self, task_id, epoch, generation=None):
        return self._fence_check(self._call(
            "FAIL %s %d%s" % (task_id, epoch,
                              self._gen_suffix(generation))))

    # -- cluster membership (elastic multi-host) --------------------------
    def register(self, worker_id):
        """(Re-)register as a live member at the current generation.
        Returns (generation, n_live)."""
        resp = self._call("REG %s" % worker_id)
        if not resp.startswith("GEN "):
            raise ConnectionError("bad REG response %r" % resp)
        _, gen, n_live = resp.split()
        return int(gen), int(n_live)

    def heartbeat(self, worker_id, generation):
        """One liveness beat. Returns the current generation on match;
        raises GenerationMismatch when the cluster resized (or a
        restarted master forgot us) — re-register and rebuild."""
        resp = self._call("HB %s %d" % (worker_id, generation))
        self._fence_check(resp)
        return int(resp.split()[1])

    def cluster(self):
        """{'generation', 'live', 'deaths'} — the membership view."""
        parts = self._call("CLUSTER").split()
        return {"generation": int(parts[1]), "live": int(parts[2]),
                "deaths": int(parts[3])}

    def members(self):
        """(generation, sorted live worker ids) in ONE consistent
        snapshot: any membership change after it bumps the generation,
        so a stale view is always fenced rather than silently wrong.
        Rank = index in the sorted list."""
        parts = self._call("MEMBERS").split()
        n = int(parts[2])
        return int(parts[1]), parts[3:3 + n]

    def reset_pass(self):
        return self._call("RESET")

    def stats(self):
        parts = self._call("STATS").split()
        return {"todo": int(parts[1]), "pending": int(parts[2]),
                "done": int(parts[3]), "failed": int(parts[4])}

    def shutdown(self):
        return self._call("SHUTDOWN")


class ElasticDataDispatcher:
    """Dataset as a task queue: RecordIO chunks dispatched through the
    master; a worker's reader pulls chunk leases and yields samples."""

    def __init__(self, client, recordio_path, worker_id="w0",
                 generation=None):
        """``recordio_path``: one path, a glob pattern, or a list of
        paths.

        ``generation``: fence every lease call with this cluster
        generation (elastic runtime): after a resize, a dispatcher
        built for the old generation raises GenerationMismatch instead
        of silently corrupting the lease table."""
        self.client = client
        self.generation = generation
        if isinstance(recordio_path, (list, tuple)):
            self.paths = list(recordio_path)
        elif any(ch in recordio_path for ch in "*?["):
            import glob
            self.paths = sorted(glob.glob(recordio_path))
        else:
            self.paths = [recordio_path]
        if not self.paths:
            raise ValueError("no recordio files match %r" % recordio_path)
        self.worker_id = worker_id

    def register_dataset(self):
        from ..reader import recordio as rio
        total = 0
        for pi, path in enumerate(self.paths):
            n = rio.num_chunks(path)
            for i in range(n):
                self.client.add_task("chunk-%d-%d" % (pi, i),
                                     "%d:%d" % (pi, i))
            total += n
        return total

    def reader(self, poll_interval=0.2, deserialize=None):
        """Yield samples from leased chunks until the pass completes.
        Chunk completion is reported per-lease; a crash mid-chunk means
        the chunk is re-dispatched after the timeout: at-least-once, as
        in the reference."""
        from ..reader import recordio as rio
        import pickle
        de = deserialize or pickle.loads

        from ..resilience import faults as _faults

        def gen():
            leases = 0
            while True:
                # chaos hook "kill the master mid-pass": arm with a
                # callback that kills (and restarts) the MasterServer;
                # the client's retries and the master's disk snapshot
                # carry the pass across the outage
                _faults.fire_point("master_kill", leases)
                leases += 1
                task = self.client.get_task(self.worker_id,
                                            generation=self.generation)
                if task == "ALLDONE":
                    return
                if task is None:
                    time.sleep(poll_interval)
                    continue
                task_id, epoch, payload = task
                if ":" in payload:
                    pi, chunk = (int(v) for v in payload.split(":"))
                else:  # single-file payloads from older snapshots
                    pi, chunk = 0, int(payload)
                try:
                    for sample in rio.chunked_reader(
                            self.paths[pi], [chunk], deserialize=de)():
                        yield sample
                except Exception:
                    self.client.task_failed(task_id, epoch,
                                            generation=self.generation)
                    continue
                self.client.task_finished(task_id, epoch,
                                          generation=self.generation)
        return gen
