"""The fleet tier of the port (``paddle_tpu_torch/serving/{wire,fleet}.py``)
against the reference's, on the CPU.

* **Wire**: the frames both packages' ``send_msg`` make are byte-equal
  for a fixed set of envelopes, and for the frames the two routers and
  workers really send (a ``generate`` with seed, tenant and model; an
  ack with policy, version and model; ``reg``/``hb`` with and without
  ``models``); ``MAX_LINE`` refuses alike; each package's ``call_once``
  talks to the other's ``LineServer``.
* **Cross-package fleets**: a reference ``FleetRouter`` fronts two port
  ``EngineWorker`` s and a port router two reference workers; both give
  the reference's in-process scheduler's greedy tokens for
  ``chaos_prompts(12, seed=5)`` exactly. A mixed fleet (one member of
  each package) with one member's stream failed at token 4 (the
  package's own ``fleet_member_kill``, armed to raise) re-drives the
  journal onto the other package's member: the fault-free tokens, 0
  journal resets, in each direction under each package's router.
* **Metrics**: every ``paddle_fleet_*``, autoscale and paging family has
  the reference's name, type, labels and help text.
* The CPU classes of the reference's ``tests/test_fleet.py`` against the
  port's router (``TestWire``, ``TestMembership``, ``TestRouting``,
  ``TestTracePropagation``, ``TestWorkerInProcess``,
  ``TestDefaultsOffHotPath``), over fake members speaking the worker
  protocol (a deterministic "greedy LM": the next token a pure function
  of the history), and one real port worker over the tiny LM of
  ``probes/fleet_worker.py``.
* ``slow``: the reference's subprocess chaos (SIGKILL of one of three
  member processes mid-generation, greedy and sampled, and a rolling
  deploy under traffic with a bad push rolled back) over
  ``python -m paddle_tpu_torch.probes.fleet_worker --device cpu``.
"""

import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import fleet_worker_child as child
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu.serving import wire as ref_wire
from paddle_tpu.serving.fleet import EngineWorker as RefWorker
from paddle_tpu.serving.fleet import FleetRouter as RefRouter
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch.observability import metrics, request_trace
from paddle_tpu_torch.probes import fleet_worker as fw
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import wire
from paddle_tpu_torch.serving.fleet import EngineWorker, FleetRouter
from paddle_tpu_torch.serving.resilience import (ServingDeadlineError,
                                                 ServingUnavailableError)

pytestmark = pytest.mark.fleet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    ref_faults.disarm()


def counter(name):
    # sum across labeled children (e.g. the journal-resets family is
    # labeled by reason)
    return sum(
        s["value"]
        for s in metrics.REGISTRY.dump().get(name, {}).get("samples", ()))


def fake_next(hist):
    """The fake members' 'greedy LM': a pure function of the history,
    never the EOS id — re-driving a journal anywhere reproduces the
    fault-free continuation exactly, like real greedy decode."""
    return (sum(hist) * 7 + 3) % 60 + 2


def fake_oracle(prompt, n):
    hist = list(prompt)
    out = []
    for _ in range(n):
        t = fake_next(hist)
        hist.append(t)
        out.append(t)
    return out


class FakeMember:
    """A LineServer speaking the EngineWorker protocol without a model:
    configurable weights version (the version SHIFTS the token
    function, like real weights would), per-request die-after-K
    streaming, artificial latency, and fail-every-request mode."""

    def __init__(self, version="v0", die_after=None, delay=0.0,
                 fail=False, shift=None):
        self.version = version
        self.die_after = die_after
        self.fail = fail
        self.delay = delay
        self.shift = (0 if shift is None
                      else shift)  # version-dependent token offset
        self.requests = []  # prompts received, in arrival order
        self.server = wire.LineServer(self._handle,
                                      name="fake-member")

    @property
    def addr(self):
        return self.server.addr

    def close(self):
        self.server.close()

    def register(self, router, mid, version=None):
        rep = wire.call_once(
            router.addr, {"cmd": "reg", "member": mid,
                          "addr": list(self.addr),
                          "version": version or self.version})
        assert rep["ok"], rep
        return rep["generation"]

    def _handle(self, conn, msg):
        if msg.get("cmd") != "generate":
            conn.send({"ok": False, "error": "fake member"})
            return
        self.requests.append(list(msg["prompt"]))
        if self.delay:
            time.sleep(self.delay)
        if self.fail:
            conn.send({"ev": "err", "kind": "server",
                       "error": "injected member failure"})
            return
        conn.send({"ev": "ack", "member": "fake", "pid": os.getpid(),
                   "version": self.version, "eos_id": 1})
        hist = list(msg["prompt"])
        out = []
        n = msg.get("max_new") or 4
        for i in range(n):
            t = fake_next(hist) + self.shift
            hist.append(t)
            out.append(t)
            conn.send({"ev": "tok", "t": t})
            if self.die_after is not None and i + 1 == self.die_after:
                return False  # close the conn: death mid-stream
        conn.send({"ev": "done", "tokens": out,
                   "version": self.version,
                   "version_start": self.version})


def make_router(**kw):
    kw.setdefault("heartbeat_timeout_ms", 0)  # manual membership
    kw.setdefault("replay_attempts", 3)
    return FleetRouter(**kw)


# -- the wire: frames byte-equal to the reference's -------------------------

ENVELOPES = {
    "generate": {"cmd": "generate", "prompt": [0, 5, 9, 33],
                 "max_new": 10, "eos_id": -1, "seed": 2 ** 40 + 7,
                 "deadline_ms": 1234.5, "trace_id": "t00000000deadbeef",
                 "tenant": "acme", "model": "A"},
    "generate-bare": {"cmd": "generate", "prompt": [0, 5], "max_new": 3,
                      "eos_id": None, "seed": 0, "deadline_ms": None,
                      "trace_id": None},
    "ack": {"ev": "ack", "member": "m0", "pid": 4242, "version": "v1",
            "policy": "sample-5f1c", "eos_id": 1, "model": "A"},
    "tok": {"ev": "tok", "t": 17},
    "done": {"ev": "done", "tokens": [3, 9, 1], "member": "m0",
             "version": "A@v0", "version_start": "A@v0", "streamed": 3},
    "reg": {"cmd": "reg", "member": "m0", "addr": ["127.0.0.1", 4000],
            "version": "v0"},
    "reg-models": {"cmd": "reg", "member": "m0",
                   "addr": ["127.0.0.1", 4000], "version": "A@v0",
                   "models": ["A", "B"], "active_model": "A"},
    "hb": {"cmd": "hb", "member": "m0", "generation": 3},
    "hb-models": {"cmd": "hb", "member": "m0", "generation": 3,
                  "models": ["A"], "active_model": "A",
                  "incarnation": "99-0", "metrics": {"v": 1, "f": []}},
    "unicode": {"ev": "err", "kind": "client",
                "error": "prompt ⊕ tokens — café"},
}


def _frame(mod, obj):
    a, b = socket.socketpair()
    try:
        mod.send_msg(a, obj)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            c = b.recv(65536)
            if not c:
                return b"".join(chunks)
            chunks.append(c)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("name", sorted(ENVELOPES))
def test_frames_byte_equal_the_reference(name):
    obj = ENVELOPES[name]
    ours = _frame(wire, obj)
    assert ours == _frame(ref_wire, obj)
    assert wire.encoded_size(obj) == ref_wire.encoded_size(obj) == \
        len(ours)
    # and each side decodes the other's frame to the same message
    a, b = socket.socketpair()
    try:
        conn = wire.LineConn(a, timeout=5)
        b.sendall(_frame(ref_wire, obj))
        assert conn.recv() == obj
    finally:
        conn.close()
        b.close()


def test_max_line_refuses_alike(monkeypatch):
    assert wire.MAX_LINE == ref_wire.MAX_LINE == 8 << 20
    big = {"x": "a" * wire.MAX_LINE}
    msgs = []
    for mod in (wire, ref_wire):
        with pytest.raises(mod.WireError) as err:
            mod.send_msg(socket.socket(), big)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    # a reader past the cap errors in both (the cap shrunk so the test
    # does not push 8 MiB through a socketpair)
    for mod in (wire, ref_wire):
        monkeypatch.setattr(mod, "MAX_LINE", 1024)
        a, b = socket.socketpair()
        conn = mod.LineConn(a, timeout=5)
        try:
            b.sendall(b"x" * 2048 + b"\n")
            with pytest.raises(mod.WireError):
                conn.recv()
        finally:
            conn.close()
            b.close()


@pytest.mark.parametrize("client,server", [(wire, ref_wire),
                                           (ref_wire, wire)],
                         ids=["port-to-reference", "reference-to-port"])
def test_call_once_across_packages(client, server):
    srv = server.LineServer(lambda conn, msg: conn.send(
        {"echo": msg["x"], "ok": True}))
    try:
        assert client.call_once(srv.addr, {"x": [1, "é", None]}) == \
            {"echo": [1, "é", None], "ok": True}
    finally:
        srv.close()


class _RawMember:
    """One connection's first line, raw, then an ack and a done frame:
    what a router puts on the wire for a hop."""

    def __init__(self):
        self.lines = []
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.addr = self.sock.getsockname()
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            try:
                s, _ = self.sock.accept()
            except OSError:
                return
            f = s.makefile("rb")
            self.lines.append(f.readline())
            conn = wire.LineConn(s, timeout=5)
            conn.send({"ev": "ack", "member": "raw", "pid": 1,
                       "version": "A@v0", "eos_id": 1, "model": "A"})
            conn.send({"ev": "done", "tokens": [7, 8], "version": "A@v0"})
            f.close()
            conn.close()


def test_routers_send_the_same_generate_frame():
    """A catalog-armed router's hop with a seed, a tenant and a model:
    the same bytes from both packages' routers."""
    got = []
    for cls, mod in ((FleetRouter, wire), (RefRouter, ref_wire)):
        router = cls(heartbeat_timeout_ms=0, models={
            "A": {"params_path": "A.npz", "tag": "A@v0", "bytes": 1,
                  "tenants": ("acme",)}})
        raw = _RawMember()
        try:
            rep = mod.call_once(router.addr, {
                "cmd": "reg", "member": "m0", "addr": list(raw.addr),
                "version": "A@v0", "models": ["A"], "active_model": "A"})
            assert rep["ok"], rep
            out = router.submit([0, 5, 9], max_new_tokens=2, eos_id=-1,
                                seed=2 ** 40 + 7, tenant="acme",
                                meta=True).result(timeout=10)
            assert out["tokens"].tolist() == [7, 8]
            got.append(raw.lines[0])
        finally:
            router.close()
            raw.sock.close()
    assert got[0] == got[1]
    assert b'"tenant":"acme","model":"A"' in got[0]


def test_workers_send_the_same_ack_reg_and_hb_frames():
    """The first frame of a worker's reply to a generate (its ack), and
    its reg and hb frames with and without a model: the same bytes from
    both packages' workers (one process, so the same pid)."""
    acks = []
    for cls, mod, sched in ((EngineWorker, wire, _Fake()),
                            (RefWorker, ref_wire, _Fake())):
        w = cls(sched, member_id="m0", version="A@v0", model="A")
        try:
            s = socket.create_connection(w.addr, timeout=5)
            mod.send_msg(s, {"cmd": "generate", "prompt": [0, 5],
                             "max_new": 1, "eos_id": 1})
            acks.append(s.makefile("rb").readline())
            s.close()
        finally:
            w.close()
    assert acks[0] == acks[1]
    for model in (None, "A"):
        frames = []
        for cls, mod in ((EngineWorker, wire), (RefWorker, ref_wire)):
            w = cls(_Fake(), member_id="m0", autostart=False, model=model)
            frames.append([_frame(mod, w._residency_fields(dict(base)))
                           for base in ({"cmd": "reg", "member": "m0",
                                         "addr": ["127.0.0.1", 1],
                                         "version": "v0"},
                                        {"cmd": "hb", "member": "m0",
                                         "generation": 2})])
        assert frames[0] == frames[1]


class _Fake:
    """A backend with the scheduler's surface and no model: one token."""

    class _Spec:
        eos_id = 1

    class _Sess:
        pass

    def __init__(self):
        self.sessions = [self._Sess()]
        self.sessions[0].spec = self._Spec()

    def policy_fingerprint(self):
        return "greedy"

    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               deadline_ms=None, on_token=None, seed=None, tenant=None):
        from concurrent.futures import Future
        fut = Future()
        on_token(3)
        fut.set_result(np.array([3], np.int64))
        return fut


# -- cross-package fleets -------------------------------------------------

PROMPTS = child.chaos_prompts(12, seed=5)
NEW = 10


@pytest.fixture(scope="module")
def members():
    """Two reference and two port schedulers over the seed-7 tiny LM,
    and the reference's in-process greedy tokens for PROMPTS."""
    port = [fw.make_scheduler(fw.build_scope(7)) for _ in range(2)]
    ref = [child.make_scheduler(child.build_scope(7)) for _ in range(2)]
    futs = [ref[0].submit(p, max_new_tokens=NEW, eos_id=-1)
            for p in PROMPTS]
    base = [[int(t) for t in f.result(timeout=120)] for f in futs]
    yield {"port": port, "ref": ref, "base": base}
    for s in port + ref:
        s.close()


def _ref_counter(name, **labels):
    return sum(s["value"] for s in ref_metrics.REGISTRY.dump().get(
        name, {}).get("samples", ()) if all(
            s["labels"].get(k) == v for k, v in labels.items()))


def _serve(router, prompts):
    futs = [router.submit(p, max_new_tokens=NEW, eos_id=-1, meta=True)
            for p in prompts]
    return [f.result(timeout=120) for f in futs]


@pytest.mark.parametrize("router_pkg", ["reference", "port"])
def test_cross_package_fleet_gives_the_reference_tokens(members,
                                                        router_pkg):
    """A reference router over two port workers, a port router over two
    reference workers: the reference scheduler's greedy tokens."""
    if router_pkg == "reference":
        router, wcls, scheds = RefRouter(heartbeat_timeout_ms=0), \
            EngineWorker, members["port"]
    else:
        router, wcls, scheds = FleetRouter(heartbeat_timeout_ms=0), \
            RefWorker, members["ref"]
    workers = [wcls(s, member_id="m%d" % i, router_addr=router.addr,
                    heartbeat_ms=100) for i, s in enumerate(scheds)]
    try:
        out = _serve(router, PROMPTS)
        assert [o["tokens"].tolist() for o in out] == members["base"]
        assert {o["member"] for o in out} == {"m0", "m1"}
        assert all(o["version"] == "v0" and o["replays"] == 0
                   for o in out)
    finally:
        for w in workers:
            w.close()
        router.close()


@pytest.mark.parametrize("router_pkg,failing", [
    ("port", "port"), ("port", "reference"),
    ("reference", "port"), ("reference", "reference")])
def test_mixed_fleet_failover_crosses_packages(members, router_pkg,
                                               failing):
    """One member of each package; the failing package's member fails a
    stream at token 4 (its own ``fleet_member_kill``, armed to raise):
    the journal re-drives onto the other package's member, the tokens
    are the fault-free run's and no journal is reset (both ack the
    reference's ``"greedy"`` fingerprint)."""
    router = (FleetRouter if router_pkg == "port" else RefRouter)(
        heartbeat_timeout_ms=0, replay_attempts=3)
    reg = metrics.REGISTRY if router_pkg == "port" else ref_metrics.REGISTRY

    def count(name):
        return sum(s["value"] for s in reg.dump().get(name, {}).get(
            "samples", ()))
    resets0 = count("paddle_fleet_journal_resets_total")
    fail0 = count("paddle_fleet_failover_total")
    rec0 = sum(s["count"] for s in reg.dump()[
        "paddle_fleet_recovery_seconds"]["samples"])
    workers = [EngineWorker(members["port"][0], member_id="port",
                            router_addr=router.addr, heartbeat_ms=100),
               RefWorker(members["ref"][0], member_id="ref",
                         router_addr=router.addr, heartbeat_ms=100)]
    (faults if failing == "port" else ref_faults).arm(
        "fleet_member_kill", at=4, times=1)
    try:
        out = _serve(router, PROMPTS)
        assert [o["tokens"].tolist() for o in out] == members["base"]
        replayed = [o for o in out if o["replays"]]
        other = "ref" if failing == "port" else "port"
        assert len(replayed) == 1 and replayed[0]["member"] == other
        assert count("paddle_fleet_failover_total") == fail0 + 1
        assert count("paddle_fleet_journal_resets_total") == resets0
        assert sum(s["count"] for s in reg.dump()[
            "paddle_fleet_recovery_seconds"]["samples"]) == rec0 + 1
    finally:
        for w in workers:
            w.close()
        router.close()


def test_worker_snapshots_run_on_the_dispatcher_thread(members, tmp_path,
                                                      monkeypatch):
    """A swap's rollback snapshot is read by the scheduler's dispatcher
    (where every launch of the scheduler runs), not on the wire's
    connection thread, and is a host copy: the rollback restores the
    bits the push replaced."""
    from paddle_tpu_torch.serving import generation
    sched = members["port"][1]
    seen = []
    orig = generation._host_weights

    def spy(sessions, names):
        seen.append(threading.current_thread() is sched._thread)
        out = orig(sessions, names)
        assert all(t.device.type == "cpu" for t in out.values())
        return out
    monkeypatch.setattr(generation, "_host_weights", spy)
    scope = sched.sessions[0].scope
    before = {n: scope.find_var(n).clone() for n in scope.var_names()
              if not n.startswith(("@", "kv_session"))}
    push = {n: (v * 1.01).numpy() for n, v in before.items()}
    np.savez(str(tmp_path / "v1.npz"), **push)
    worker = EngineWorker(sched, member_id="m0")
    try:
        rep = wire.call_once(worker.addr, {
            "cmd": "swap", "tag": "v1",
            "params_path": str(tmp_path / "v1.npz")}, timeout=60)
        assert rep == {"ok": True, "version": "v1"}
        assert seen == [True]
        rep = wire.call_once(worker.addr, {"cmd": "rollback"}, timeout=60)
        assert rep == {"ok": True, "version": "v0"}
        for n, v in before.items():
            assert torch.equal(scope.find_var(n), v), n
    finally:
        worker.close()


def test_build_scope_and_pushes_equal_the_references():
    """``probes.fleet_worker.build_scope(seed)`` holds the reference
    child's weights name for name and bit for bit (every float variable
    of its scope; the reference's scope holds its startup's RNG state
    besides), and a push (``model_params``, scaled) is the reference's
    to the bit."""
    ours, theirs = fw.build_scope(11), child.build_scope(11)
    floats = sorted(n for n in theirs.var_names() if np.issubdtype(
        np.asarray(theirs.find_var(n)).dtype, np.floating))
    assert sorted(ours.var_names()) == floats
    assert set(theirs.var_names()) - set(floats) == {"@RNG_STATE@"}
    for n in floats:
        want = np.asarray(theirs.find_var(n))
        got = ours.find_var(n).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), n
    a, b = fw.model_params(ours, 1.01), child.model_params(theirs, 1.01)
    assert sorted(a) == sorted(b)
    assert all(a[n].dtype == b[n].dtype and np.array_equal(a[n], b[n])
               for n in a)


def test_load_scope_takes_only_a_manifested_npz(tmp_path):
    from paddle_tpu_torch.serving import model_paging
    params = fw.model_params(fw.build_scope(7))
    path = str(tmp_path / "w.npz")
    np.savez(path, **params)
    with pytest.raises(ValueError, match="no weights manifest"):
        fw.load_scope(path)
    model_paging.write_weights_manifest(path, params)
    scope = fw.load_scope(path)
    for n, v in params.items():
        assert np.array_equal(scope.find_var(n).numpy(), v), n
    short = dict(params)
    short.pop(sorted(short)[0])
    np.savez(str(tmp_path / "s.npz"), **short)
    model_paging.write_weights_manifest(str(tmp_path / "s.npz"), short)
    with pytest.raises(ValueError, match="names 28 arrays"):
        fw.load_scope(str(tmp_path / "s.npz"))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_push_from_either_package_lands_on_both_workers(members,
                                                          tmp_path,
                                                          writer):
    """A deploy push written by either package (``np.savez`` and
    ``write_weights_manifest``) is accepted by both packages' workers,
    and each then serves what the other serves on it."""
    from paddle_tpu.serving import model_paging as ref_mp
    from paddle_tpu_torch.serving import model_paging
    path = str(tmp_path / "push.npz")
    # another seed's weights: a push whose tokens differ from v0's
    if writer == "port":
        push = fw.model_params(fw.build_scope(11))
        np.savez(path, **push)
        model_paging.write_weights_manifest(path, push)
    else:
        push = child.model_params(child.build_scope(11))
        np.savez(path, **push)
        ref_mp.write_weights_manifest(path, push)
    outs = []
    for cls, mod, sched in ((EngineWorker, wire, members["port"][1]),
                            (RefWorker, ref_wire, members["ref"][1])):
        w = cls(sched, member_id="m0")
        try:
            rep = mod.call_once(w.addr, {"cmd": "swap", "tag": "v1",
                                         "params_path": path}, timeout=60)
            assert rep == {"ok": True, "version": "v1"}, rep
            outs.append([int(t) for t in sched.submit(
                PROMPTS[0], max_new_tokens=NEW,
                eos_id=-1).result(timeout=60)])
            rep = mod.call_once(w.addr, {"cmd": "rollback"}, timeout=60)
            assert rep == {"ok": True, "version": "v0"}, rep
        finally:
            w.close()
    assert outs[0] == outs[1]
    assert outs[0] != members["base"][0]


def test_line_server_ends_a_connection_closed_under_its_read():
    """A read of a file closed under it (a teardown racing the
    connection's thread) ends that connection quietly: ValueError is
    not a protocol fault."""
    srv = wire.LineServer(lambda conn, msg: None)
    a, b = socket.socketpair()
    try:
        conn = wire.LineConn(a, timeout=5)
        conn._rfile.close()
        srv._serve_conn(conn)     # returns; the conn is closed
        assert conn.sock.fileno() == -1
    finally:
        b.close()
        srv.close()


def test_fleet_families_equal_the_reference():
    """Every fleet, autoscale and paging family: the reference's name,
    type, labels and help text."""
    import paddle_tpu.serving.autoscale  # noqa: F401
    import paddle_tpu_torch.serving.autoscale  # noqa: F401
    ours, theirs = metrics.REGISTRY.families(), \
        ref_metrics.REGISTRY.families()
    names = sorted(n for n in theirs if n.startswith(
        ("paddle_fleet_", "paddle_autoscale_")))
    assert len(names) >= 30
    assert sorted(n for n in ours if n.startswith(
        ("paddle_fleet_", "paddle_autoscale_"))) == names
    dump, ref_dump = metrics.REGISTRY.dump(), ref_metrics.REGISTRY.dump()
    for n in names:
        assert (dump[n]["type"], dump[n]["help"]) == \
            (ref_dump[n]["type"], ref_dump[n]["help"]), n
        assert ours[n].labelnames == theirs[n].labelnames, n


# -- the reference's CPU classes, against the port's router ----------------

class TestWire:
    def test_roundtrip_and_length_cap(self, monkeypatch):
        def handler(conn, msg):
            conn.send({"echo": msg["x"]})
        srv = wire.LineServer(handler)
        try:
            rep = wire.call_once(srv.addr, {"x": [1, 2, 3]})
            assert rep == {"echo": [1, 2, 3]}
        finally:
            srv.close()
        # an over-long frame is refused at the SENDER
        with pytest.raises(wire.WireError):
            wire.send_msg(socket.socket(), {"x": "a" * wire.MAX_LINE})
        # and a peer streaming past the cap errors the READER instead
        # of growing the buffer without bound (cap shrunk so the test
        # doesn't push 8 MiB through a socketpair)
        monkeypatch.setattr(wire, "MAX_LINE", 1024)
        a, b = socket.socketpair()
        try:
            conn = wire.LineConn(a, timeout=5)
            b.sendall(b"x" * 2048 + b"\n")
            with pytest.raises(wire.WireError):
                conn.recv()
            # non-JSON within the cap is a WireError too
            a2, b2 = socket.socketpair()
            conn2 = wire.LineConn(a2, timeout=5)
            b2.sendall(b"not json\n")
            with pytest.raises(wire.WireError):
                conn2.recv()
            conn2.close()
            b2.close()
        finally:
            conn.close()
            b.close()

    def test_retry_delay_jitter_bounds(self):
        for attempt in range(6):
            for _ in range(50):
                d = wire.retry_delay(attempt, backoff=0.05, cap=2.0)
                lo = min(2.0, 0.05 * 2 ** attempt)
                assert lo / 2 <= d <= lo

    def test_server_close_unblocks_blocked_client(self):
        """The teardown discipline (the task master's, wire tier): a
        client blocked in recv unblocks when the server closes —
        promptly, not after its full socket timeout."""
        srv = wire.LineServer(lambda conn, msg: None)
        c = wire.LineConn.connect(srv.addr, timeout=10.0)
        res = {}

        def blocked():
            try:
                res["msg"] = c.recv()
            except Exception as exc:  # noqa: BLE001
                res["exc"] = exc
        th = threading.Thread(target=blocked, daemon=True)
        th.start()
        time.sleep(0.1)
        t0 = time.perf_counter()
        srv.close()
        th.join(3.0)
        elapsed = time.perf_counter() - t0
        assert not th.is_alive()
        assert elapsed < 1.5, "client sat %.2fs after close" % elapsed
        c.close()



class TestMembership:
    def test_join_bumps_generation_reregister_does_not(self):
        router = make_router()
        fm = FakeMember()
        try:
            gen = fm.register(router, "m0")
            assert gen == 1 and router.members_live() == ["m0"]
            # same member, same address: a heartbeat-thread
            # re-register, not a new process — no bump
            assert fm.register(router, "m0") == 1
            fm2 = FakeMember()
            try:
                assert fm2.register(router, "m1") == 2
                assert router.members_live() == ["m0", "m1"]
            finally:
                fm2.close()
        finally:
            router.close()
            fm.close()

    def test_stale_heartbeat_fenced_but_refreshes(self):
        router = make_router()
        fm = FakeMember()
        fm2 = FakeMember()
        try:
            fm.register(router, "m0")
            fm2.register(router, "m1")  # bumps to gen 2
            rep = wire.call_once(router.addr,
                                 {"cmd": "hb", "member": "m0",
                                  "generation": 1})
            assert not rep["ok"] and rep["genmismatch"] == 2
            rep = wire.call_once(router.addr,
                                 {"cmd": "hb", "member": "m0",
                                  "generation": 2})
            assert rep["ok"]
            # an unknown member's beat says re-register
            rep = wire.call_once(router.addr,
                                 {"cmd": "hb", "member": "ghost",
                                  "generation": 2})
            assert not rep["ok"] and rep["genmismatch"] == 2
        finally:
            router.close()
            fm.close()
            fm2.close()

    def test_missed_deadline_drops_member_and_retires_gauges(self):
        deaths0 = counter("paddle_fleet_member_deaths_total")
        router = FleetRouter(heartbeat_timeout_ms=250,
                             breaker_failures=2)
        fm = FakeMember()
        try:
            fm.register(router, "m0")
            label = "f%d:m0" % router._rid
            gen0 = router.generation
            inflight = metrics.REGISTRY.dump()[
                "paddle_fleet_member_inflight"]["samples"]
            assert any(s["labels"].get("member") == label
                       for s in inflight)
            deadline = time.monotonic() + 5
            while router.members_live() and \
                    time.monotonic() < deadline:
                time.sleep(0.02)
            assert router.members_live() == []
            assert router.generation == gen0 + 1
            assert counter("paddle_fleet_member_deaths_total") == \
                deaths0 + 1
            # the stale-label sweep: every family labelled on the
            # dead member is gone (breaker health AND inflight)
            dump = metrics.REGISTRY.dump()
            for fam in ("paddle_fleet_member_inflight",
                        "paddle_serving_replica_healthy"):
                assert not any(
                    label in s["labels"].values()
                    for s in dump.get(fam, {}).get("samples", ())), fam
        finally:
            router.close()
            fm.close()

    def test_router_close_sweeps_member_labels(self):
        router = make_router(breaker_failures=2)
        fm = FakeMember()
        try:
            fm.register(router, "m0")
            prefix = "f%d:" % router._rid
        finally:
            router.close()
            fm.close()
        dump = metrics.REGISTRY.dump()
        for fam in ("paddle_fleet_member_inflight",
                    "paddle_serving_replica_healthy",
                    "paddle_fleet_generation",
                    "paddle_fleet_members_live"):
            for s in dump.get(fam, {}).get("samples", ()):
                assert not any(str(v).startswith(prefix)
                               for v in s["labels"].values()), fam

    def test_healthz_aggregates_member_health(self):
        from paddle_tpu_torch.observability import health
        router = make_router(members_min=2, breaker_failures=1)
        fm0, fm1 = FakeMember(), FakeMember()
        try:
            fm0.register(router, "m0")
            snap = health.health_snapshot()
            comp = snap["components"]["fleet%d" % router._rid]
            assert not comp["healthy"]  # 1 live < members_min=2
            fm1.register(router, "m1")
            comp = health.health_snapshot()[
                "components"]["fleet%d" % router._rid]
            assert comp["healthy"] and comp["live"] == 2
            assert comp["members"]["m0"]["breaker"] == "closed"
        finally:
            router.close()
            fm0.close()
            fm1.close()


class TestRouting:
    def test_least_loaded_placement(self):
        router = make_router()
        slow = FakeMember(delay=0.6)
        idle = FakeMember()
        try:
            slow.register(router, "m0")
            idle.register(router, "m1")
            f1 = router.submit([5], max_new_tokens=2, meta=True)
            time.sleep(0.15)  # m0 (lowest index) is now occupied
            f2 = router.submit([6], max_new_tokens=2, meta=True)
            assert f2.result(timeout=10)["member"] == "m1"
            assert f1.result(timeout=10)["member"] == "m0"
        finally:
            router.close()
            slow.close()
            idle.close()

    def test_journal_redrive_bit_identical(self):
        """A member dying mid-stream re-drives the journal on a peer:
        the peer receives prompt ⊕ tokens-so-far and the final output
        is token-for-token the fault-free continuation."""
        failovers0 = counter("paddle_fleet_failover_total")
        router = make_router()
        dying = FakeMember(die_after=2)
        peer = FakeMember()
        try:
            dying.register(router, "m0")
            peer.register(router, "m1")
            out = router.submit([5, 6], max_new_tokens=6,
                                meta=True).result(timeout=10)
            want = fake_oracle([5, 6], 6)
            assert out["tokens"].tolist() == want
            assert out["member"] == "m1" and out["replays"] == 1
            assert peer.requests[-1] == [5, 6] + want[:2]
            assert counter("paddle_fleet_failover_total") == \
                failovers0 + 1
            # kill-to-first-replayed-token landed in the histogram
            sample = metrics.REGISTRY.dump()[
                "paddle_fleet_recovery_seconds"]["samples"][0]
            assert sample["count"] >= 1
        finally:
            router.close()
            dying.close()
            peer.close()

    def test_cross_version_journal_reset(self):
        """A journal generated under one weights version is never
        spliced with another: re-driving on a different-version peer
        discards the partial and restarts from the prompt."""
        resets0 = counter("paddle_fleet_journal_resets_total")
        router = make_router()
        dying = FakeMember(version="v0", die_after=2)
        peer = FakeMember(version="v1", shift=1)
        try:
            dying.register(router, "m0")
            peer.register(router, "m1")
            out = router.submit([5, 6], max_new_tokens=6,
                                meta=True).result(timeout=10)
            # the full v1 generation, not v0-prefix + v1-suffix
            hist, want = [5, 6], []
            for _ in range(6):
                t = fake_next(hist) + 1
                hist.append(t)
                want.append(t)
            assert out["tokens"].tolist() == want
            assert out["version"] == "v1"
            assert peer.requests[-1] == [5, 6]  # journal discarded
            assert counter("paddle_fleet_journal_resets_total") == \
                resets0 + 1
        finally:
            router.close()
            dying.close()
            peer.close()

    def test_breaker_opens_and_trial_readmits(self):
        router = make_router(breaker_failures=1,
                             breaker_cooldown_ms=150.0)
        bad = FakeMember(fail=True)
        good = FakeMember()
        try:
            bad.register(router, "m0")
            good.register(router, "m1")
            out = router.submit([7], max_new_tokens=3,
                                meta=True).result(timeout=10)
            assert out["member"] == "m1" and out["replays"] == 1
            with router._lock:
                breaker = router._members["m0"].breaker
            assert breaker.state == "open"
            # while open and cooling, traffic avoids m0 entirely
            out = router.submit([8], max_new_tokens=3,
                                meta=True).result(timeout=10)
            assert out["member"] == "m1" and out["replays"] == 0
            # heal the member; after the cooldown a trial dispatch
            # re-admits it (the dispatch IS the probe)
            bad.fail = False
            time.sleep(0.2)
            deadline = time.monotonic() + 5
            served_by_m0 = False
            while time.monotonic() < deadline and not served_by_m0:
                got = router.submit([9], max_new_tokens=2,
                                    meta=True).result(timeout=10)
                served_by_m0 = got["member"] == "m0"
            assert served_by_m0 and breaker.state == "closed"
        finally:
            router.close()
            bad.close()
            good.close()

    def test_ack_version_fence_beats_stale_router_cache(self):
        """The router's cached member version can lie (out-of-band
        swap, a second router deploying): the worker's ACK is
        authoritative. A journal re-driven onto a member whose ack
        reveals different weights is reset BEFORE any of that hop's
        tokens land — no breaker charge, no replay burned, and the
        response is entirely one version."""
        resets0 = counter("paddle_fleet_journal_resets_total")
        router = make_router()
        dying = FakeMember(version="v0", die_after=2)
        peer = FakeMember(version="v1", shift=1)
        try:
            dying.register(router, "m0")
            # the cache lies: the peer registered as v0 but its acks
            # say v1 (it was swapped behind this router's back)
            peer.register(router, "m1", version="v0")
            out = router.submit([5, 6], max_new_tokens=6,
                                meta=True).result(timeout=10)
            hist, want = [5, 6], []
            for _ in range(6):
                t = fake_next(hist) + 1
                hist.append(t)
                want.append(t)
            assert out["tokens"].tolist() == want
            assert out["version"] == "v1" == out["version_start"]
            # one replay (the death); the version retry burned none
            assert out["replays"] == 1
            # the stale journal DID go out on the first peer hop (the
            # cache said v0), was reset at ack, and the retry hop
            # carried the bare prompt
            assert peer.requests[0][:2] == [5, 6] and \
                len(peer.requests[0]) == 4
            assert peer.requests[-1] == [5, 6]
            assert counter("paddle_fleet_journal_resets_total") == \
                resets0 + 1
        finally:
            router.close()
            dying.close()
            peer.close()

    def test_hang_past_call_timeout_opens_instantly(self):
        """A member silent past the per-call timeout is a hang: the
        breaker opens on the single event (the engine's rule: a wedged
        process is not worth N more victims) and the request fails
        over. ``fleet_slow_member`` armed in a worker process
        produces exactly this shape."""
        router = make_router(breaker_failures=5, call_timeout=0.3,
                             breaker_cooldown_ms=60000.0)
        wedged = FakeMember(delay=1.2)
        peer = FakeMember()
        try:
            wedged.register(router, "m0")
            peer.register(router, "m1")
            out = router.submit([5], max_new_tokens=3,
                                meta=True).result(timeout=10)
            assert out["member"] == "m1" and out["replays"] == 1
            with router._lock:
                breaker = router._members["m0"].breaker
            assert breaker.state == "open"  # 1 hang << threshold 5
        finally:
            router.close()
            wedged.close()
            peer.close()

    def test_poison_request_charges_one_breaker(self):
        """A request that fails on EVERY member charges at most one
        breaker across its replays — it cannot black out the fleet
        (the scheduler's discipline, promoted one tier up)."""
        router = make_router(breaker_failures=1,
                             breaker_cooldown_ms=60000.0,
                             replay_attempts=2)
        bad0, bad1 = FakeMember(fail=True), FakeMember(fail=True)
        try:
            bad0.register(router, "m0")
            bad1.register(router, "m1")
            with pytest.raises(Exception):
                router.submit([7], max_new_tokens=3).result(timeout=10)
            with router._lock:
                states = [router._members[m].breaker.state
                          for m in ("m0", "m1")]
            assert states.count("open") == 1, states
        finally:
            router.close()
            bad0.close()
            bad1.close()

    def test_fenced_stale_reply(self):
        """A reply landing after its member was declared dead is
        fenced — discarded and re-driven on a live peer, never
        trusted (the generation-fencing discipline, serving tier)."""
        fenced0 = counter("paddle_fleet_fenced_replies_total")
        router = make_router()
        zombie = FakeMember(delay=0.5)
        peer = FakeMember()
        try:
            zombie.register(router, "m0")
            peer.register(router, "m1")
            fut = router.submit([5, 6], max_new_tokens=4, meta=True)
            time.sleep(0.2)  # in flight on m0, reply not yet sent
            # the partition-heal race: the member is declared dead
            # while its reply is still in the pipe (white-box: state
            # flips without the conn sweep that normally accompanies
            # a drop)
            with router._lock:
                router._members["m0"].state = "dead"
                router._generation += 1
            out = fut.result(timeout=10)
            assert out["member"] == "m1"
            assert out["tokens"].tolist() == fake_oracle([5, 6], 4)
            assert counter("paddle_fleet_fenced_replies_total") == \
                fenced0 + 1
        finally:
            router.close()
            zombie.close()
            peer.close()

    def test_network_partition_fault_site(self):
        router = make_router()
        fm0, fm1 = FakeMember(), FakeMember()
        try:
            fm0.register(router, "m0")
            fm1.register(router, "m1")
            faults.arm("fleet_network_partition", at="m0", times=1)
            out = router.submit([4], max_new_tokens=3,
                                meta=True).result(timeout=10)
            assert out["member"] == "m1" and out["replays"] == 1
        finally:
            faults.disarm()
            router.close()
            fm0.close()
            fm1.close()

    def test_client_error_never_charges_or_replays(self):
        router = make_router(breaker_failures=1)

        def h(conn, msg):
            conn.send({"ev": "err", "kind": "client",
                       "error": "prompt exceeds every bucket"})
        srv = wire.LineServer(h)
        try:
            wire.call_once(router.addr,
                           {"cmd": "reg", "member": "m0",
                            "addr": list(srv.addr), "version": "v0"})
            with pytest.raises(ValueError):
                router.submit([4], max_new_tokens=3).result(timeout=10)
            with router._lock:
                assert router._members["m0"].breaker.state == "closed"
        finally:
            router.close()
            srv.close()

    def test_deadline_and_unavailable(self):
        router = make_router(placement_timeout=0.2)
        try:
            with pytest.raises(ServingDeadlineError):
                router.submit([4], deadline_ms=-1)
            fut = router.submit([4], max_new_tokens=2)
            with pytest.raises(ServingUnavailableError):
                fut.result(timeout=10)  # no members at all
        finally:
            router.close()


class TestTracePropagation:
    def test_single_tree_across_kill_and_replay(self, monkeypatch):
        """One request killed mid-generation reads router -> dead
        member -> replay-on-peer in a single span tree: two fleetHop
        spans, the dead hop's and the peer's memberRecv children, and
        the failoverRequeue edge between them."""
        port_config.set_flags(request_tracing=True,
                              trace_sample_rate=1.0)
        router = make_router()
        dying = FakeMember(die_after=2)
        peer = FakeMember()
        try:
            dying.register(router, "m0")
            peer.register(router, "m1")
            out = router.submit([5, 6], max_new_tokens=5,
                                meta=True).result(timeout=10)
            assert out["replays"] == 1
            tid = request_trace.trace_ids()[-1]
            events = request_trace.trace_events(tid)
            names = [e["name"] for e in events]
            hops = [e for e in events if e["name"] == "fleetHop"]
            assert len(hops) == 2
            assert [h["attrs"]["member"] for h in hops] == ["m0", "m1"]
            assert "failoverRequeue" in names
            assert "resolve" in names
            recvs = [e for e in events if e["name"] == "memberRecv"]
            # both members acked before the death: two memberRecv
            # children, each parented under its own hop span
            assert len(recvs) == 2
            assert {r["parent_id"] for r in recvs} == \
                {h["span_id"] for h in hops}
            tree = request_trace.span_tree(tid)
            assert tree["root"]["name"] == "request"
        finally:
            port_config.set_flags(request_tracing=False)
            request_trace.clear()
            router.close()
            dying.close()
            peer.close()

    def test_adopt_joins_remote_trace(self):
        port_config.set_flags(request_tracing=True,
                              trace_sample_rate=1.0)
        try:
            ctx = request_trace.adopt("t00000000deadbeef",
                                      "fleet.memberServe", member="m0")
            assert ctx is not None
            request_trace.event(ctx, "memberRecv", member="m0")
            events = request_trace.trace_events("t00000000deadbeef")
            assert [e["name"] for e in events] == \
                ["fleet.memberServe", "memberRecv"]
        finally:
            port_config.set_flags(request_tracing=False)
            request_trace.clear()
        # off: adopt is inert
        assert request_trace.adopt("t1", "x") is None



@pytest.mark.generation
class TestWorkerInProcess:
    """One real EngineWorker (tiny LM) in-process: serve, swap,
    rollback, version reporting — the wire end to end without
    subprocess cost."""

    def test_serve_swap_rollback(self, tmp_path):
        scope = fw.build_scope(seed=7)
        v1 = fw.model_params(scope, 1.01)
        sched = fw.make_scheduler(scope)
        router = FleetRouter(heartbeat_timeout_ms=900,
                             replay_attempts=2)
        worker = EngineWorker(sched, member_id="m0",
                              router_addr=router.addr,
                              heartbeat_ms=100)
        try:
            router.wait_members(1, timeout=10)
            prompt = [fw.BOS, 5, 9]
            out = router.submit(prompt, max_new_tokens=8, eos_id=-1,
                                meta=True).result(timeout=120)
            want = [int(t) for t in
                    sched.submit(prompt, max_new_tokens=8,
                                 eos_id=-1).result(timeout=120)]
            assert out["tokens"].tolist() == want
            assert out["version"] == "v0" == out["version_start"]

            np.savez(str(tmp_path / "v1.npz"), **v1)
            res = router.rolling_deploy(
                params_path=str(tmp_path / "v1.npz"), tag="v1",
                canary_requests=1, watch_timeout=10)
            assert res["ok"] and not res["rolled_back"], res
            out1 = router.submit(prompt, max_new_tokens=8, eos_id=-1,
                                 meta=True).result(timeout=120)
            assert out1["version"] == "v1" == out1["version_start"]
            assert router.member_versions() == {"m0": "v1"}

            rep = wire.call_once(worker.addr, {"cmd": "rollback"})
            assert rep["ok"] and rep["version"] == "v0"
            out2 = router.submit(prompt, max_new_tokens=8, eos_id=-1,
                                 meta=True).result(timeout=120)
            assert out2["tokens"].tolist() == want, \
                "rollback must restore v0 tokens"
        finally:
            worker.close()
            router.close()
            sched.close()


class TestDefaultsOffHotPath:
    def test_fleet_flags_read_only_at_construction(self, monkeypatch):
        """Default flags construct no router/sockets/threads, and the
        fleet flags are consulted only inside the fleet constructors
        — a routed submit afterwards reads no config at all at the
        router tier."""
        calls = []
        orig = port_config.get_flag

        def counting(name):
            calls.append(name)
            return orig(name)
        monkeypatch.setattr(port_config, "get_flag", counting)
        router = make_router()
        fm = FakeMember()
        try:
            fm.register(router, "m0")
            assert [c for c in calls
                    if c.startswith(("fleet_", "slo_", "autoscale_"))] \
                == ["fleet_canary_fraction", "fleet_members_min",
                    "fleet_tenants", "fleet_models",
                    "fleet_metrics_interval_ms",
                    "slo_target_p99_ms"]
            # the paging sizing flags are gated behind an armed model
            # catalog: defaults never touch them
            assert "member_resident_bytes" not in calls
            assert "model_page_timeout_ms" not in calls
            # the windows flag is gated behind a nonzero SLO target:
            # defaults never touch it
            assert "slo_windows" not in calls
            # default routers build no tenant table and attach no
            # autoscaler: the autoscale flags are read only
            # inside FleetAutoscaler's constructor
            assert router._tenants is None
            assert router._autoscaler is None
            assert not [c for c in calls
                        if c.startswith("autoscale_")]
            calls.clear()
            out = router.submit([3], max_new_tokens=3,
                                meta=True).result(timeout=10)
            assert len(out["tokens"]) == 3
            assert not [c for c in calls
                        if c.startswith(("fleet_", "slo_",
                                         "autoscale_"))]
        finally:
            router.close()
            fm.close()

    def test_worker_reads_heartbeat_flag_at_construction(
            self, monkeypatch):
        calls = []
        orig = port_config.get_flag

        def counting(name):
            calls.append(name)
            return orig(name)
        monkeypatch.setattr(port_config, "get_flag", counting)
        # an unstarted worker around a dummy backend: the flag read
        # happens in the constructor, nowhere else
        worker = EngineWorker(object(), autostart=False)
        assert calls.count("fleet_heartbeat_ms") == 1
        assert calls.count("fleet_metrics_interval_ms") == 1
        assert worker.heartbeat == orig("fleet_heartbeat_ms") / 1e3
        assert worker.metrics_interval == \
            orig("fleet_metrics_interval_ms") / 1e3
        router = FleetRouter(heartbeat_timeout_ms=None)
        try:
            assert router.heartbeat_timeout == \
                3.0 * orig("fleet_heartbeat_ms") / 1e3
            assert calls.count("fleet_heartbeat_ms") == 2
        finally:
            router.close()


def _spawn_child(router, mid, *extra):
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.probes.fleet_worker",
         "--router", "%s:%d" % router.addr, "--member", mid,
         "--heartbeat-ms", "150", "--device", "cpu"] + list(extra),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=ROOT)
    line = proc.stdout.readline().strip()
    assert line.startswith("READY"), line
    return proc


def _stop_children(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


@pytest.mark.slow
@pytest.mark.chaos
class TestFleetChaosSubprocess:
    def test_sigkill_one_of_three_mid_generation(self):
        """Chaos acceptance: 3 engine-worker PROCESSES, >= 24
        concurrent generation requests, SIGKILL of one worker
        mid-decode — zero client-visible errors and every output
        token-identical to the fault-free baseline (the journals
        re-drive on peers)."""
        prompts = fw.chaos_prompts(24)
        # fault-free oracle: the same weights, in-process
        scope = fw.build_scope(seed=7)
        sched = fw.make_scheduler(scope, slots=4)
        futs = [sched.submit(p, max_new_tokens=12, eos_id=-1)
                for p in prompts]
        baseline = [[int(t) for t in f.result(timeout=300)]
                    for f in futs]
        sched.close()

        deaths0 = counter("paddle_fleet_member_deaths_total")
        # telemetry plane rides along: members ship snapshots every
        # 100ms; the router-side window is deliberately long (30s) so
        # the dead member's retained-but-stale snapshot is still
        # observable when we assert on it
        router = FleetRouter(heartbeat_timeout_ms=700,
                             replay_attempts=6, breaker_failures=2,
                             breaker_cooldown_ms=60000.0,
                             metrics_interval_ms=30000.0)
        ship = ("--metrics-interval-ms", "100")
        procs = []
        try:
            procs.append(_spawn_child(router, "m0",
                                      "--kill-at-token", "4", *ship))
            procs.append(_spawn_child(router, "m1", *ship))
            procs.append(_spawn_child(router, "m2", *ship))
            router.wait_members(3, timeout=120)
            futs = [router.submit(p, max_new_tokens=12, eos_id=-1,
                                  meta=True) for p in prompts]
            results, errors = [], []
            for i, f in enumerate(futs):
                try:
                    results.append(f.result(timeout=300))
                except Exception as exc:  # noqa: BLE001
                    results.append(None)
                    errors.append("req %d: %r" % (i, exc))
            assert not errors, errors
            mism = [i for i, (got, want)
                    in enumerate(zip(results, baseline))
                    if got["tokens"].tolist() != want]
            assert not mism, mism
            assert procs[0].poll() is not None, \
                "worker m0 should have SIGKILLed itself"
            assert any(r["replays"] > 0 for r in results)
            # membership: the monitor reaps m0 one heartbeat deadline
            # after the kill (requests finished faster than that)
            deadline = time.monotonic() + 10
            while "m0" in router.members_live() and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            assert "m0" not in router.members_live()
            assert counter("paddle_fleet_member_deaths_total") >= \
                deaths0 + 1

            # -- telemetry conservation across the kill ------------
            # every completed request incremented exactly one
            # member's done counter; m0 died before completing any
            # (the kill fires at streamed token 4 of 12), so the
            # fleet-aggregated total must converge on EXACTLY the
            # request count — nothing lost, nothing double-counted
            def _fleet_done():
                return router._aggregator.counter_value(
                    "paddle_fleet_worker_done_total")
            expected = float(len(prompts))
            deadline = time.monotonic() + 30
            while _fleet_done() < expected and \
                    time.monotonic() < deadline:
                time.sleep(0.1)
            assert _fleet_done() == expected, \
                "fleet done %.0f != %d completed requests" \
                % (_fleet_done(), len(prompts))
            # the dead member's snapshot is retained but flagged
            doc = router.fleet_doc()
            assert doc["members"]["m0"]["state"] == "dead"
            tele = doc["members"]["m0"].get("telemetry")
            assert tele is not None and tele["ingests"] >= 1
            assert tele["dead"] is True and tele["stale"] is True
            assert doc["members"]["m1"]["telemetry"]["stale"] is False

            # -- restart: same id, new incarnation -----------------
            # the respawned m0 reports fresh small totals under a new
            # (member, incarnation) key: they fold in whole — the
            # no-double-count side of the conservation ledger
            procs.append(_spawn_child(router, "m0", *ship))
            router.wait_members(3, timeout=120)
            futs = [router.submit(p, max_new_tokens=6, eos_id=-1)
                    for p in prompts[:6]]
            for f in futs:
                f.result(timeout=300)
            expected += 6
            deadline = time.monotonic() + 30
            while _fleet_done() < expected and \
                    time.monotonic() < deadline:
                time.sleep(0.1)
            assert _fleet_done() == expected
            # let a few more ships land: the total must HOLD (re-
            # delivered snapshots are idempotent, no drift)
            time.sleep(0.5)
            assert _fleet_done() == expected
        finally:
            router.close()
            _stop_children(procs)

    def test_sigkill_under_sampled_decode_bit_identical(self):
        """Chaos acceptance, sampled: 3 SAMPLED members,
        explicit per-request seeds, SIGKILL one mid-decode — zero
        client-visible errors and every output bit-identical to the
        fault-free sampled oracle. The router-minted seed rides the
        envelope on every hop, so the replayed journal resumes its
        exact counter-key schedule on the peer."""
        prompts = fw.chaos_prompts(12, seed=5)
        seeds = [2000 + 13 * i for i in range(len(prompts))]
        scope = fw.build_scope(seed=7)
        sched = fw.make_scheduler(
            scope, slots=4, decode_policy=fw.sampled_policy())
        futs = [sched.submit(p, max_new_tokens=12, eos_id=-1, seed=s)
                for p, s in zip(prompts, seeds)]
        baseline = [[int(t) for t in f.result(timeout=300)]
                    for f in futs]
        sched.close()
        assert len(set(map(tuple, baseline))) > 1

        router = FleetRouter(heartbeat_timeout_ms=700,
                             replay_attempts=6, breaker_failures=2,
                             breaker_cooldown_ms=60000.0)
        pol = ("--decode-policy", "sample")
        procs = []
        try:
            procs.append(_spawn_child(router, "s0",
                                      "--kill-at-token", "4", *pol))
            procs.append(_spawn_child(router, "s1", *pol))
            procs.append(_spawn_child(router, "s2", *pol))
            router.wait_members(3, timeout=120)
            futs = [router.submit(p, max_new_tokens=12, eos_id=-1,
                                  meta=True, seed=s)
                    for p, s in zip(prompts, seeds)]
            results, errors = [], []
            for i, f in enumerate(futs):
                try:
                    results.append(f.result(timeout=300))
                except Exception as exc:  # noqa: BLE001
                    results.append(None)
                    errors.append("req %d: %r" % (i, exc))
            assert not errors, errors
            mism = [i for i, (got, want)
                    in enumerate(zip(results, baseline))
                    if got["tokens"].tolist() != want]
            assert not mism, mism
            assert procs[0].poll() is not None, \
                "worker s0 should have SIGKILLed itself"
            assert any(r["replays"] > 0 for r in results)
        finally:
            router.close()
            _stop_children(procs)

    def test_cross_policy_failover_resets_journal(self):
        """A journal minted under GREEDY must never resume under a
        SAMPLED member: the decode-policy fingerprint gate (the
        weights-version rule extended to decode semantics) discards
        it and restarts from the prompt, so the client receives the
        pure sampled-from-scratch answer — never a greedy prefix
        spliced onto a sampled continuation."""
        prompt = [fw.BOS, 9, 23, 4]
        seed = 4242
        scope = fw.build_scope(seed=7)
        sched = fw.make_scheduler(
            scope, slots=2, decode_policy=fw.sampled_policy())
        oracle = [int(t) for t in
                  sched.submit(prompt, max_new_tokens=10, eos_id=-1,
                               seed=seed).result(timeout=300)]
        sched.close()
        gsched = fw.make_scheduler(scope, slots=2)
        greedy = [int(t) for t in
                  gsched.submit(prompt, max_new_tokens=10,
                                eos_id=-1).result(timeout=300)]
        gsched.close()
        assert oracle != greedy  # the splice would be visible

        resets0 = counter("paddle_fleet_journal_resets_total")
        # breaker_failures=1: the dead member's breaker opens on its
        # first failure, so the request PARKS in placement (instead
        # of burning its replay budget on refused connections) until
        # the sampled member registers
        router = FleetRouter(heartbeat_timeout_ms=700,
                             replay_attempts=6, breaker_failures=1,
                             breaker_cooldown_ms=60000.0,
                             placement_timeout=120.0)
        procs = []
        try:
            # the only member is GREEDY and kills itself after
            # streaming 4 tokens of the journal
            procs.append(_spawn_child(router, "g0",
                                      "--kill-at-token", "4"))
            router.wait_members(1, timeout=120)
            fut = router.submit(prompt, max_new_tokens=10, eos_id=-1,
                                meta=True, seed=seed)
            deadline = time.monotonic() + 120
            while procs[0].poll() is None and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            assert procs[0].poll() is not None
            # failover target: a SAMPLED member — the partial greedy
            # journal reaching it must be reset, not resumed
            procs.append(_spawn_child(router, "s1",
                                      "--decode-policy", "sample"))
            out = fut.result(timeout=300)
            assert out["tokens"].tolist() == oracle, \
                (out["tokens"].tolist(), oracle, greedy)
            assert out["replays"] >= 1
            assert counter("paddle_fleet_journal_resets_total") >= \
                resets0 + 1
        finally:
            router.close()
            _stop_children(procs)

    def test_rolling_deploy_under_traffic_and_bad_push_rollback(
            self, tmp_path):
        """Rolling deploy across 3 members under concurrent traffic:
        every response is served by exactly one weights version and
        the deploy commits; then an injected BAD push fails its
        canary watch and the whole fleet rolls back — still zero
        client-visible errors."""
        scope = fw.build_scope(seed=7)
        np.savez(str(tmp_path / "v1.npz"),
                 **fw.model_params(scope, 1.01))
        np.savez(str(tmp_path / "bad.npz"),
                 **fw.model_params(scope, 0.99))
        router = FleetRouter(heartbeat_timeout_ms=900,
                             replay_attempts=6,
                             canary_fraction=0.34)
        procs = []
        stop = threading.Event()
        responses, errors = [], []

        def traffic():
            rs = np.random.RandomState(3)
            while not stop.is_set():
                p = [fw.BOS] + [int(t) for t in
                                   rs.randint(2, fw.VOCAB, 3)]
                try:
                    out = router.submit(
                        p, max_new_tokens=6, eos_id=-1,
                        meta=True).result(timeout=120)
                    responses.append(out)
                except Exception as exc:  # noqa: BLE001
                    errors.append(repr(exc))
        try:
            for mid in ("m0", "m1", "m2"):
                procs.append(_spawn_child(
                    router, mid, "--fail-after-swap", "bad"))
            router.wait_members(3, timeout=120)
            threads = [threading.Thread(target=traffic, daemon=True)
                       for _ in range(4)]
            for t in threads:
                t.start()
            time.sleep(1.0)
            res = router.rolling_deploy(
                params_path=str(tmp_path / "v1.npz"), tag="v1",
                canary_requests=2, watch_timeout=60)
            assert res["ok"] and not res["rolled_back"], res
            assert set(router.member_versions().values()) == {"v1"}

            bad = router.rolling_deploy(
                params_path=str(tmp_path / "bad.npz"), tag="bad",
                canary_requests=4, watch_failures=2,
                watch_timeout=60)
            assert bad["rolled_back"], bad
            assert set(router.member_versions().values()) == {"v1"}, \
                "fleet-wide rollback must restore the prior version"
            time.sleep(0.5)
            stop.set()
            for t in threads:
                t.join(timeout=120)
            assert not errors, errors[:5]
            assert responses
            # THE deploy invariant: a response is served by exactly
            # one weights version, start to finish
            mixed = [r for r in responses
                     if r["version_start"] != r["version"]]
            assert not mixed, mixed[:5]
            assert {r["version"] for r in responses} <= {"v0", "v1"}
            assert any(r["version"] == "v1" for r in responses)
        finally:
            stop.set()
            router.close()
            _stop_children(procs)
