"""The port's task-master client and launcher
(``paddle_tpu_torch/distributed/master.py``) against the reference's, on
the CPU.

The daemon is the reference's ``native/task_master.cc``, built unchanged
by the port (``native.task_master_binary``, into the git-ignored
``paddle_tpu_torch/build/``) and spawned by the port's ``MasterServer``.
The port's and the reference's ``MasterClient`` then drive one daemon:
each protocol scenario (membership, a death's re-lease, fencing, the
graceful drain, the restart from the snapshot) runs once with each
client and must give the same answers, and one scenario interleaves
both clients on one daemon. The client's jittered backoff and socket
closing, the dispatcher's fencing and the ``master_kill`` failover are
the reference's tests on the port's client.
"""

import os
import socket
import time

import pytest

from paddle_tpu.distributed import master as ref_master
from paddle_tpu_torch import native
from paddle_tpu_torch.distributed import master as port_master
from paddle_tpu_torch.distributed.master import (ElasticDataDispatcher,
                                                 GenerationMismatch,
                                                 MasterClient, MasterServer)
from paddle_tpu_torch.reader import recordio
from paddle_tpu_torch.resilience import faults

pytestmark = pytest.mark.multihost

CLIENTS = {"port": port_master, "reference": ref_master}
MISMATCH = (port_master.GenerationMismatch, ref_master.GenerationMismatch)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()


def test_task_master_built_from_the_reference_source():
    path = native.task_master_binary()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, "paddle_tpu_torch", "build",
                                "task_master")
    assert os.access(path, os.X_OK)
    assert os.path.getmtime(path) >= os.path.getmtime(
        os.path.join(root, "native", "task_master.cc"))
    # reused, not rebuilt, while newer than its source
    mtime = os.path.getmtime(path)
    assert native.task_master_binary() == path
    assert os.path.getmtime(path) == mtime


def _beat_until_mismatch(c, worker, gen, others=(), limit=10.0):
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline:
        try:
            c.heartbeat(worker, gen)
            for w in others:
                c.heartbeat(w, gen)
        except MISMATCH:
            return True
        time.sleep(0.05)
    return False


def _membership(mod, tmp_path):
    """Register, join-bump, fencing and MEMBERS; returns the answers."""
    srv = MasterServer(str(tmp_path / "snap"), heartbeat_timeout_ms=60_000)
    try:
        c = mod.MasterClient(srv.port)
        out = [c.register("w0"), c.register("w1")]
        with pytest.raises(mod.GenerationMismatch):
            c.heartbeat("w0", out[0][0])      # stale after the join
        out += [c.register("w0"), c.heartbeat("w0", 2), c.cluster(),
                c.members(), c.ping()]
        with pytest.raises(mod.GenerationMismatch) as ei:
            c.heartbeat("ghost", 2)
        out.append(ei.value.current_generation)
        return out
    finally:
        srv.stop()


def test_membership_answers_equal(tmp_path):
    port = _membership(port_master, tmp_path / "a")
    ref = _membership(ref_master, tmp_path / "b")
    assert port == ref == [
        (1, 1), (2, 2), (2, 2), 2,
        {"generation": 2, "live": 2, "deaths": 0}, (2, ["w0", "w1"]),
        True, 2]


def _death_and_fencing(mod, tmp_path):
    """A silent worker's death re-leases its task with a bumped epoch;
    its stale generation is fenced on every call."""
    srv = MasterServer(str(tmp_path / "snap"), timeout_sec=300,
                       heartbeat_timeout_ms=500)
    try:
        c = mod.MasterClient(srv.port)
        c.register("live")
        gen, _ = c.register("doomed")
        c.add_task("t0", "p")
        got = c.get_task("doomed", generation=gen)
        pending = c.stats()["pending"]
        assert _beat_until_mismatch(c, "live", gen)
        cl, stats = c.cluster(), c.stats()
        fenced = []
        for call in (lambda: c.heartbeat("doomed", gen),
                     lambda: c.task_finished(got[0], got[1],
                                             generation=gen),
                     lambda: c.task_failed(got[0], got[1],
                                           generation=gen),
                     lambda: c.get_task("doomed", generation=gen)):
            with pytest.raises(mod.GenerationMismatch) as ei:
                call()
            fenced.append(ei.value.current_generation)
        t2 = c.get_task("live", generation=gen + 1)
        fin = c.task_finished(t2[0], t2[1], generation=gen + 1)
        return [got, pending, cl, stats, fenced, t2, fin, c.stats()]
    finally:
        srv.stop()


def test_death_release_and_fencing_equal(tmp_path):
    port = _death_and_fencing(port_master, tmp_path / "a")
    ref = _death_and_fencing(ref_master, tmp_path / "b")
    assert port == ref
    got, pending, cl, stats, fenced, t2, fin, final = port
    assert pending == 1 and cl == {"generation": 3, "live": 1,
                                   "deaths": 1}
    assert stats["pending"] == 0 and stats["todo"] == 1
    assert fenced == [3] * 4
    assert t2[0] == "t0" and t2[1] == got[1] + 1 and fin == "OK"
    assert final["done"] == 1


def test_both_clients_on_one_daemon(tmp_path):
    """The port's client leases what the reference's added, and the
    reference's client finishes what the port's leased: one lease
    table, one line protocol."""
    srv = MasterServer(str(tmp_path / "snap"), timeout_sec=300,
                       heartbeat_timeout_ms=60_000)
    try:
        p = port_master.MasterClient(srv.port)
        r = ref_master.MasterClient(srv.port)
        assert r.register("ref-worker") == (1, 1)
        assert p.register("port-worker") == (2, 2)
        assert r.members() == p.members() == (2, ["port-worker",
                                                  "ref-worker"])
        for i in range(3):
            (r if i % 2 else p).add_task("t%d" % i, "payload %d" % i)
        a = p.get_task("port-worker", generation=2)
        b = r.get_task("ref-worker", generation=2)
        assert (a[0], a[2], b[0], b[2]) == ("t0", "payload 0",
                                            "t1", "payload 1")
        assert r.task_finished(a[0], a[1], generation=2) == "OK"
        assert p.task_failed(b[0], b[1], generation=2) == "OK"
        assert p.stats() == r.stats() == {"todo": 2, "pending": 0,
                                          "done": 1, "failed": 0}
        with pytest.raises(ref_master.GenerationMismatch):
            r.get_task("ref-worker", generation=1)
        with pytest.raises(port_master.GenerationMismatch):
            p.get_task("port-worker", generation=1)
        assert p.cluster() == r.cluster()
    finally:
        srv.stop()


def test_graceful_stop_drains_inflight_lines(tmp_path):
    srv = MasterServer(str(tmp_path / "snap"))
    s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
    f = s.makefile("r")
    try:
        s.sendall(b"PING\nADD t0 p\nSHUTDOWN\nSTATS\nCLUSTER\n")
        assert f.readline().strip() == "PONG"
        assert f.readline().strip() == "OK"
        assert f.readline().strip() == "OK"          # SHUTDOWN ack
        assert f.readline().strip().startswith("STATS 1")
        assert f.readline().strip().startswith("CLUSTER 1")
        srv.proc.wait(timeout=10)
        assert srv.proc.returncode == 0
    finally:
        f.close()
        s.close()
        srv.stop(graceful=False)


@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_master_restart_is_generation_stable(tmp_path, client):
    """Membership survives a master restart through the snapshot: the
    survivors' beats go on at the same generation; a worker lost in the
    outage is reaped one fresh deadline later."""
    mod = CLIENTS[client]
    snap = str(tmp_path / "snap")
    srv = MasterServer(snap, timeout_sec=300, heartbeat_timeout_ms=600)
    try:
        c = mod.MasterClient(srv.port)
        c.register("w0")
        c.register("w1")
        mod.MasterClient(srv.port).register("doomed")
        gen, live = c.register("w1")
        assert live == 3
    finally:
        srv.stop()
    srv2 = MasterServer(snap, timeout_sec=300, heartbeat_timeout_ms=600)
    try:
        c = mod.MasterClient(srv2.port)
        assert c.heartbeat("w0", gen) == gen
        assert c.heartbeat("w1", gen) == gen
        assert c.cluster() == {"generation": gen, "live": 3, "deaths": 0}
        assert _beat_until_mismatch(c, "w0", gen, others=("w1",))
        assert c.cluster() == {"generation": gen + 1, "live": 2,
                               "deaths": 1}
    finally:
        srv2.stop()


@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_client_jittered_exponential_backoff(monkeypatch, client):
    mod = CLIENTS[client]
    import random as _random
    delays = []
    monkeypatch.setattr(time, "sleep", lambda d: delays.append(d))
    rvals = iter([0.0, 1.0, 0.5, 0.0, 1.0])
    monkeypatch.setattr(_random, "random", lambda: next(rvals))
    c = mod.MasterClient(1, retries=4, backoff=0.1, backoff_cap=0.5)
    with pytest.raises(ConnectionError):
        c.ping()
    assert delays == pytest.approx([0.05, 0.2, 0.3, 0.25])


class _FakeSock:
    def __init__(self, fail=True):
        self.closed = False
        self.fail = fail
        self.file = None

    def sendall(self, data):
        if self.fail:
            raise OSError("connection reset")

    def makefile(self, mode):
        self.file = _FakeFile()
        return self.file

    def close(self):
        self.closed = True


class _FakeFile:
    def __init__(self):
        self.closed = False

    def readline(self):
        return "PONG\n"

    def close(self):
        self.closed = True


def test_client_closes_socket_and_file_on_failure():
    c = MasterClient(0, retries=2)
    made = []

    def fake_connect():
        s = _FakeSock(fail=True)
        c._sock = s
        c._file = s.makefile("r")
        made.append(s)

    c._connect = fake_connect
    with pytest.raises(ConnectionError):
        c._call("PING")
    assert len(made) == 2
    for s in made:
        assert s.closed and s.file.closed
    assert c._sock is None and c._file is None


def test_client_close_then_reuse():
    c = MasterClient(0, retries=2)
    sequence = [_FakeSock(fail=True), _FakeSock(fail=False)]

    def fake_connect():
        s = sequence.pop(0)
        c._sock = s
        c._file = s.makefile("r")

    c._connect = fake_connect
    assert c._call("PING") == "PONG"
    assert sequence == []


def _dataset(tmp_path, n=96):
    d = tmp_path / "ds"
    d.mkdir()
    for f in range(3):
        recordio.write_recordio(
            str(d / ("lin-%05d" % f)),
            ((i, [float(i)] * 4, [float(i)])
             for i in range(f * n // 3, (f + 1) * n // 3)),
            max_chunk_bytes=1 << 10)
    return str(d / "lin-*")


def test_stale_dispatcher_reader_is_fenced(tmp_path):
    ds_glob = _dataset(tmp_path)
    srv = MasterServer(str(tmp_path / "snap"), timeout_sec=300,
                       heartbeat_timeout_ms=300)
    try:
        c = MasterClient(srv.port)
        gen, _ = c.register("w0")
        ElasticDataDispatcher(c, ds_glob).register_dataset()
        MasterClient(srv.port).register("peer")   # joins, then dies
        _beat_until_mismatch(c, "w0", gen)
        stale = ElasticDataDispatcher(c, ds_glob, worker_id="w0",
                                      generation=gen)
        with pytest.raises(GenerationMismatch):
            next(iter(stale.reader()()))
    finally:
        srv.stop()


def test_dispatcher_reads_the_reference_dataset_once(tmp_path):
    """Chunks registered by the reference's dispatcher on one daemon
    are read by the port's reader: every sample once, every chunk
    done."""
    ds_glob = _dataset(tmp_path)
    srv = MasterServer(str(tmp_path / "snap"), timeout_sec=300)
    try:
        n = ref_master.ElasticDataDispatcher(
            ref_master.MasterClient(srv.port), ds_glob).register_dataset()
        c = MasterClient(srv.port)
        got = [s[0] for s in ElasticDataDispatcher(c, ds_glob).reader()()]
        assert sorted(got) == list(range(96))
        assert c.stats() == {"todo": 0, "pending": 0, "done": n,
                             "failed": 0}
    finally:
        srv.stop()


def test_master_killed_mid_pass_recovers_from_snapshot(tmp_path):
    """``master_kill``: the master dies after two leases and restarts on
    the same port from its snapshot; the client retries through the
    outage and the pass completes with every sample (at-least-once)."""
    path = str(tmp_path / "ds.rec")
    recordio.write_recordio(path, list(range(200)), max_chunk_bytes=128)
    snap = str(tmp_path / "snap")
    servers = [MasterServer(snap, timeout_sec=30)]
    port = servers[0].port

    def kill_and_restart():
        servers[-1].kill()
        servers.append(MasterServer(snap, port=port, timeout_sec=30))

    try:
        c = MasterClient(port)
        disp = ElasticDataDispatcher(c, path, "w0")
        n_chunks = disp.register_dataset()
        assert n_chunks > 2
        faults.arm("master_kill", at=2, action="callback",
                   callback=kill_and_restart)
        got = list(disp.reader()())
        assert len(servers) == 2
        assert set(got) == set(range(200))
        assert MasterClient(port).stats()["done"] >= n_chunks
    finally:
        for s in servers:
            s.stop(graceful=False)
