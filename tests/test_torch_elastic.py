"""The port's elastic runtime (``paddle_tpu_torch/distributed/elastic.py``)
against the reference's contract (``tests/test_elastic.py``), on the CPU.

Two gloo ranks of one ``RankPool`` (a module fixture, ranks without a
group of their own) run what needs a real process group: an all-reduce
that one rank never joins is ended by the watchdog's escalation within
the group's bounded timeout and a group comes up again at the next
generation; and two ``ElasticTrainerLoop`` workers over a gloo
coordinator survive one of them being declared dead mid-pass. The rest
runs in this process as the reference's tests do: rendezvous sizing,
the quorum timeout, a quorum wait that does not read as a death, the
bounded register retry, a peer's death, the hang escalation (its
generations and master stats equal to the reference's loop's on the
same scenario), a user's Ctrl-C, the trainer's stop/restart flags, and
the single-process path untouched. The subprocess SIGKILL chaos test
is ``slow``, as the reference's is.
"""

import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu as ptpu
from paddle_tpu import layers as ref_layers
from paddle_tpu.data_feeder import DataFeeder as RefFeeder
from paddle_tpu.distributed import ElasticTrainerLoop as RefLoop
from paddle_tpu.resilience import RecoveryPolicy as RefPolicy
from paddle_tpu.resilience import ResilientTrainer as RefTrainer
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import core, layers, optimizer
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.distributed import (ElasticDataDispatcher,
                                          ElasticTrainerLoop,
                                          MasterClient, MasterServer,
                                          MembershipHeartbeat, launch)
from paddle_tpu_torch.distributed import elastic as el
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.reader import recordio
from paddle_tpu_torch.resilience import (RecoveryPolicy, ResilientTrainer,
                                         faults)
from paddle_tpu_torch.trainer import EndIteration, EndPass, Trainer

from torch_ranks import RankPool, _free_port

pytestmark = pytest.mark.multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2, init=False)
    yield p
    p.close()


@pytest.fixture(autouse=True)
def _restore():
    yield
    faults.disarm()
    ref_faults.disarm()
    port_config.set_flags(fault_injection=False, nonfinite_guard=False)
    ptpu.config.set_flags(fault_injection=False, nonfinite_guard=False)


def _metric(name):
    fam = metrics.REGISTRY.families().get(name)
    if fam is None:
        return 0.0
    return sum(c.value for c in fam.children().values())


def _make_dataset(tmp_path, n=96, seed=0, files=3):
    """``files`` RecordIO files of (i, x, y) samples, small chunks."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 4).astype("float32")
    Y = (X.sum(1, keepdims=True) * 0.5).astype("float32")
    d = tmp_path / "ds"
    d.mkdir()
    per = n // files
    for f in range(files):
        recordio.write_recordio(
            str(d / ("lin-%05d" % f)),
            ((i, X[i].tolist(), Y[i].tolist())
             for i in range(f * per, (f + 1) * per)),
            max_chunk_bytes=1 << 10)
    return str(d / "lin-*")


def _regressor(ref=False):
    if ref:
        main, startup = ptpu.Program(), ptpu.Program()
        with ptpu.unique_name.guard(), ptpu.program_guard(main, startup):
            xv = ref_layers.data("x", shape=[4])
            yv = ref_layers.data("y", shape=[1])
            pred = ref_layers.fc(xv, 1, bias_attr=False,
                                 param_attr="w_lin")
            loss = ref_layers.mean(ref_layers.square_error_cost(pred, yv))
            ptpu.optimizer.SGD(learning_rate=0.05).minimize(
                loss, startup_program=startup)
        return main, startup, loss, xv, yv
    main, startup = core.Program(), core.Program()
    with core.unique_name.guard(), core.program_guard(main, startup):
        xv = layers.data("x", shape=[4])
        yv = layers.data("y", shape=[1])
        pred = layers.fc(xv, 1, bias_attr=False, param_attr="w_lin")
        loss = layers.mean(layers.square_error_cost(pred, yv))
        optimizer.SGD(learning_rate=0.05).minimize(loss, startup)
    return main, startup, loss, xv, yv


def _build_factory(tmp_path, ds_glob, sleep=0.0, deadline=None,
                   ref=False):
    """ElasticTrainerLoop build(): the regressor over a fenced
    dispatcher, in either package."""
    def build(world):
        main, startup, loss, xv, yv = _regressor(ref)
        if ref:
            trainer = RefTrainer(
                loss, feeder=RefFeeder([xv, yv]), main_program=main,
                startup_program=startup,
                checkpoint_dir=str(tmp_path / "ckpt_ref"),
                checkpoint_every_n_steps=1,
                policy=RefPolicy(step_deadline_sec=deadline or 0))
            from paddle_tpu.distributed import ElasticDataDispatcher as D
        else:
            trainer = ResilientTrainer(
                loss, feeder=DataFeeder([xv, yv]), main_program=main,
                startup_program=startup,
                checkpoint_dir=str(tmp_path / "ckpt"),
                checkpoint_every_n_steps=1, device="cpu",
                policy=RecoveryPolicy(step_deadline_sec=deadline or 0))
            D = ElasticDataDispatcher
        disp = D(world.client, ds_glob, worker_id=world.worker_id,
                 generation=world.generation)

        def reader():
            batch = []
            for s in disp.reader(poll_interval=0.05)():
                batch.append((np.asarray(s[1], "float32"),
                              np.asarray(s[2], "float32")))
                if sleep:
                    time.sleep(sleep)
                if len(batch) == 8:
                    yield batch
                    batch = []
            if batch:
                yield batch
        return trainer, reader
    return build


# -- on gloo ranks -------------------------------------------------------


def test_gloo_hang_abort_is_bounded_and_the_group_comes_back(pool):
    """A peer that never joins an all-reduce: the watchdog (0.5 s)
    escalates through collective_abort; gloo cannot cancel the running
    wait, so it ends at the group's bounded timeout (3 s), not gloo's
    30-minute default; a group at the next generation reduces."""
    out = pool.run("elastic_hang_abort", _free_port(), 0.5, 3)
    assert [o["first"] for o in out] == [[2.0, 2.0]] * 2
    assert [o["second"] for o in out] == [[3.0, 3.0]] * 2
    r0 = out[0]
    assert r0["aborted"] == [True]          # the escalation aborted it
    assert r0["unblocked_by"] in ("interrupt", "error")
    assert 2.0 < r0["seconds"] < 15.0, r0["seconds"]


def test_gloo_elastic_loop_survives_a_declared_death(pool, tmp_path):
    """Two workers over a gloo coordinator; worker w1 drops 12
    heartbeats (1.2 s against a 0.7 s deadline), so the master declares
    it dead mid-pass. Both rebuild at later generations, every
    bring-up's group reduces over the live world, and the pass ends
    with every chunk done."""
    ds_glob = _make_dataset(tmp_path, n=192)
    srv = MasterServer(str(tmp_path / "snap"), timeout_sec=5,
                       heartbeat_timeout_ms=700)
    try:
        c = MasterClient(srv.port)
        n_chunks = ElasticDataDispatcher(c, ds_glob).register_dataset()
        outs = pool.run("elastic_loop_ranks", srv.port, _free_port(),
                        ds_glob, str(tmp_path / "ckpt"), {1: 12}, 10)
        for o in outs:
            assert o["result"] is None
            assert o["generations"] == sorted(o["generations"])
            assert o["generations"][-1] > o["generations"][0]
            assert o["restarts"] >= 1
            for gen, live, value in o["reduced"]:
                assert value == live, o["reduced"]
            assert o["losses"] and np.isfinite(o["losses"]).all()
        # the last bring-up of both is the same two-worker generation
        assert outs[0]["reduced"][-1] == outs[1]["reduced"][-1]
        assert outs[0]["reduced"][-1][1] == 2
        stats = c.stats()
        assert stats == {"todo": 0, "pending": 0, "done": n_chunks,
                         "failed": 0}
        assert c.cluster()["deaths"] >= 1
    finally:
        srv.stop()


# -- membership (in process) -------------------------------------------


def test_heartbeat_thread_keeps_worker_alive_and_survives_drop(tmp_path):
    srv = MasterServer(str(tmp_path / "snap"), heartbeat_timeout_ms=600)
    changes = []
    hb = None
    try:
        c = MasterClient(srv.port)
        gen, _ = c.register("w0")
        hb = MembershipHeartbeat(
            srv.port, "w0", gen, interval_sec=0.1,
            on_change=lambda old, new, live:
                changes.append((old, new, live))).start()
        time.sleep(1.5)  # ~2.5 deadline windows
        assert c.cluster() == {"generation": 1, "live": 1, "deaths": 0}
        faults.arm("heartbeat_drop", times=10)
        deadline = time.monotonic() + 10
        while not changes and time.monotonic() < deadline:
            time.sleep(0.05)
        faults.disarm()
        assert changes and changes[0][:2] == (1, 2)
        assert hb.generation == 2
        assert c.cluster() == {"generation": 2, "live": 1, "deaths": 1}
    finally:
        if hb is not None:
            hb.stop()
        faults.disarm()
        srv.stop()


# -- the elastic loop (in process) -------------------------------------


def test_elastic_loop_restart_on_peer_death(tmp_path):
    ds_glob = _make_dataset(tmp_path)
    srv = MasterServer(str(tmp_path / "snap"), timeout_sec=5,
                       heartbeat_timeout_ms=700)
    try:
        c = MasterClient(srv.port)
        ElasticDataDispatcher(c, ds_glob).register_dataset()
        MasterClient(srv.port).register("silent-peer")
        r0 = _metric("paddle_elastic_restarts_total")
        d0 = _metric("paddle_elastic_worker_deaths_total")
        h0 = metrics.REGISTRY.families()["paddle_elastic_resume_seconds"]
        n0 = sum(ch.count for ch in h0.children().values())
        with core.scope_guard(core.Scope()):
            loop = ElasticTrainerLoop(
                _build_factory(tmp_path, ds_glob, sleep=0.02), srv.port,
                worker_id="w-main", heartbeat_interval_sec=0.15)
            loop.run(num_passes=1)
        assert loop.restarts >= 1
        assert loop.generations[0] == 2 and loop.generations[-1] >= 3
        assert _metric("paddle_elastic_restarts_total") > r0
        assert _metric("paddle_elastic_worker_deaths_total") > d0
        assert sum(ch.count for ch in h0.children().values()) > n0
        assert _metric("paddle_elastic_generation") >= 2
        stats = c.stats()
        assert stats["todo"] == 0 and stats["pending"] == 0
        assert stats["done"] > 0
    finally:
        srv.stop()


def _hang_scenario(tmp_path, ref):
    """The hang escalation on one package: collective_hang at step 2
    under a 0.6 s deadline. Returns (generations, restarts, stats,
    seconds)."""
    sub = tmp_path / ("ref" if ref else "port")
    sub.mkdir()
    ds_glob = _make_dataset(sub)
    srv = MasterServer(str(sub / "snap"), timeout_sec=5,
                       heartbeat_timeout_ms=60_000)
    try:
        c = MasterClient(srv.port)
        ElasticDataDispatcher(c, ds_glob).register_dataset()
        (ref_faults if ref else faults).arm("collective_hang", at=2)
        t0 = time.monotonic()
        build = _build_factory(sub, ds_glob, deadline=0.6, ref=ref)
        if ref:
            with ptpu.scope_guard(ptpu.Scope()):
                loop = RefLoop(build, srv.port, worker_id="w-hang",
                               heartbeat_interval_sec=0.5)
                loop.run(num_passes=1)
        else:
            with core.scope_guard(core.Scope()):
                loop = ElasticTrainerLoop(build, srv.port,
                                          worker_id="w-hang",
                                          heartbeat_interval_sec=0.5)
                loop.run(num_passes=1)
        return (loop.generations, loop.restarts, c.stats(),
                time.monotonic() - t0)
    finally:
        faults.disarm()
        ref_faults.disarm()
        srv.stop()


def test_collective_hang_escalation_bounded_abort(tmp_path):
    s0 = _metric("paddle_resilience_watchdog_stalls_total")
    gens, restarts, stats, seconds = _hang_scenario(tmp_path, ref=False)
    assert restarts == 1
    assert seconds < 60, "hang was not aborted in bounded time"
    assert _metric("paddle_resilience_watchdog_stalls_total") >= s0 + 1
    assert stats["todo"] == 0 and stats["pending"] == 0
    # the reference's loop on the same scenario
    ref_gens, ref_restarts, ref_stats, _ = _hang_scenario(tmp_path,
                                                          ref=True)
    assert (gens, restarts, stats) == (ref_gens, ref_restarts, ref_stats)


def test_rendezvous_sizes_world_from_membership(tmp_path, monkeypatch):
    calls = []

    def fake_init(addr, num_processes=None, process_id=None,
                  initialization_timeout_sec=None, device=None,
                  generation=None):
        calls.append((addr, num_processes, process_id, generation))
        return process_id, num_processes

    monkeypatch.setattr(el, "init_multihost", fake_init)
    srv = MasterServer(str(tmp_path / "snap"), heartbeat_timeout_ms=60_000)
    try:
        class FakeTrainer:
            policy = None

            def startup(self):
                pass

            def request_restart(self, reason):
                pass

            def train(self, *a, **k):
                return None

        worlds = []

        def build(world):
            worlds.append(world)
            return FakeTrainer(), None

        peer = MasterClient(srv.port)
        timer = threading.Timer(0.5, lambda: peer.register("w0"))
        timer.start()
        loop = ElasticTrainerLoop(build, srv.port, worker_id="w1",
                                  coordinator_address="127.0.0.1:1",
                                  num_processes=2,
                                  heartbeat_interval_sec=5.0)
        loop.run(num_passes=1)
        timer.join()
        (_, nproc, pid, gen), = calls
        assert (nproc, pid) == (2, 1)  # sorted ranks: w0=0, w1=1
        # the group rendezvouses under this bring-up's store prefix
        assert gen == "%d.0" % loop.generations[0]
        (world,) = worlds
        assert world.num_processes == 2 and world.process_id == 1
        assert world.n_live == 2
    finally:
        srv.stop()


def test_rendezvous_settle_keeps_a_silent_peer_out(tmp_path, monkeypatch):
    """With ``settle_sec`` past the master's deadline, a registered peer
    that never beats is reaped before the world is sized: the group is
    brought up for the one live worker (the reference, settling nothing,
    would size it for two)."""
    calls = []
    monkeypatch.setattr(el, "init_multihost",
                        lambda addr, num_processes=None, process_id=None,
                        **kw: calls.append((num_processes, process_id))
                        or (process_id, num_processes))
    srv = MasterServer(str(tmp_path / "snap"), heartbeat_timeout_ms=300)
    try:
        MasterClient(srv.port).register("zz-silent")
        worlds = []

        class Done:
            policy = None

            def startup(self):
                pass

            def request_restart(self, reason):
                pass

            def train(self, *a, **k):
                return None

        loop = ElasticTrainerLoop(
            lambda world: worlds.append(world) or (Done(), None), srv.port,
            worker_id="w0", coordinator_address="127.0.0.1:1",
            heartbeat_interval_sec=0.1, settle_sec=0.6)
        loop.run(num_passes=1)
        assert calls == [(1, 0)]
        assert worlds[0].n_live == 1
        assert MasterClient(srv.port).cluster()["deaths"] == 1
    finally:
        srv.stop()


def test_rendezvous_quorum_timeout(tmp_path):
    srv = MasterServer(str(tmp_path / "snap"), heartbeat_timeout_ms=60_000)
    try:
        loop = ElasticTrainerLoop(
            lambda world: (None, None), srv.port, worker_id="w0",
            min_workers=3, rendezvous_timeout_sec=0.7)
        with pytest.raises(RuntimeError, match="1 of 3"):
            loop.run(num_passes=1)
    finally:
        srv.stop()


def test_rendezvous_wait_does_not_read_as_death(tmp_path):
    srv = MasterServer(str(tmp_path / "snap"), timeout_sec=300,
                       heartbeat_timeout_ms=300)
    try:
        loop = ElasticTrainerLoop(
            lambda world: (None, None), srv.port, worker_id="w0",
            min_workers=2, rendezvous_timeout_sec=30.0)
        out = {}

        def rdv():
            out["result"] = loop._rendezvous()

        t = threading.Thread(target=rdv, daemon=True)
        t.start()
        time.sleep(1.2)  # four heartbeat deadlines at the barrier
        c = MasterClient(srv.port)
        assert c.cluster()["deaths"] == 0
        c.register("w1")
        t.join(timeout=10)
        assert not t.is_alive()
        gen, members = out["result"]
        assert members == ["w0", "w1"]
        assert c.cluster()["deaths"] == 0
    finally:
        srv.stop()


def test_bring_up_register_retry_bounded():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
    loop = ElasticTrainerLoop(lambda world: (None, None), dead_port,
                              worker_id="w0", master_reconnect_sec=0.6)
    t0 = time.monotonic()
    with pytest.raises(ConnectionError):
        loop.run(num_passes=1)
    assert time.monotonic() - t0 >= 0.5


def test_user_interrupt_propagates_not_restarts(tmp_path):
    srv = MasterServer(str(tmp_path / "snap"), timeout_sec=5,
                       heartbeat_timeout_ms=60_000)
    try:
        class CtrlCTrainer:
            policy = None

            def startup(self):
                pass

            def request_restart(self, reason):
                pass

            def train(self, *a, **k):
                raise KeyboardInterrupt

        loop = ElasticTrainerLoop(
            lambda world: (CtrlCTrainer(), None), srv.port,
            worker_id="w-ctrlc", heartbeat_interval_sec=5.0)
        with pytest.raises(KeyboardInterrupt):
            loop.run(num_passes=1)
        assert loop.restarts == 0
    finally:
        srv.stop()


def test_collective_error_without_escalation_propagates(tmp_path):
    """An error from train() with no watchdog escalation before it is
    the trainer's, not an abort: it propagates (the port's path for an
    aborted group's error restarts only after on_hang ran)."""
    srv = MasterServer(str(tmp_path / "snap"), timeout_sec=5,
                       heartbeat_timeout_ms=60_000)
    try:
        class Broken:
            policy = None

            def startup(self):
                pass

            def request_restart(self, reason):
                pass

            def train(self, *a, **k):
                raise RuntimeError("collective failed")

        loop = ElasticTrainerLoop(lambda world: (Broken(), None),
                                  srv.port, worker_id="w-err",
                                  heartbeat_interval_sec=5.0)
        with pytest.raises(RuntimeError, match="collective failed"):
            loop.run(num_passes=1)
        assert loop.restarts == 0
    finally:
        srv.stop()


def _tiny_trainer(tmp_path, every=100):
    main, startup, loss, xv, yv = _regressor()
    return Trainer(loss, feeder=DataFeeder([xv, yv]), main_program=main,
                   startup_program=startup,
                   checkpoint_dir=str(tmp_path / "ck"),
                   checkpoint_every_n_steps=every, device="cpu"), \
        (main, startup, loss, xv, yv)


def _tiny_reader(n):
    rs = np.random.RandomState(0)

    def reader():
        for _ in range(n):
            x = rs.randn(8, 4).astype("float32")
            yield [(x[i], x[i].sum(keepdims=True)) for i in range(8)]
    return reader


def test_trainer_request_restart_returns_record(tmp_path):
    from paddle_tpu_torch import io as port_io
    with core.scope_guard(core.Scope()):
        tr, (main, startup, loss, xv, yv) = _tiny_trainer(tmp_path)

        def handler(e):
            if isinstance(e, EndIteration) and e.batch_id == 2:
                tr.request_restart("unit_test")

        rec = tr.train(_tiny_reader(20), num_passes=1,
                       event_handler=handler, prefetch=0, staging=False)
    assert rec == {"restart": True, "reason": "unit_test", "pass_id": 0,
                   "batch_id": 2, "step": 3}
    meta = port_io.load_checkpoint_meta(str(tmp_path / "ck"))
    assert meta["restart"] is True and meta["step"] == 3
    with core.scope_guard(core.Scope()):
        tr2 = Trainer(loss, feeder=DataFeeder([xv, yv]), main_program=main,
                      startup_program=startup,
                      checkpoint_dir=str(tmp_path / "ck"), device="cpu")
        tr2.startup()
    assert tr2.step_id == 3


def test_stop_and_restart_in_same_window_leaks_neither(tmp_path):
    with core.scope_guard(core.Scope()):
        tr, _ = _tiny_trainer(tmp_path)

        def handler(e):
            if isinstance(e, EndIteration) and e.batch_id == 1:
                tr.request_stop("preempt")
                tr.request_restart("peer_death")

        rec = tr.train(_tiny_reader(6), num_passes=1,
                       event_handler=handler, prefetch=0, staging=False)
        assert rec.get("preempted") is True
        assert tr._stop_reason is None and tr._restart_reason is None
        rec2 = tr.train(_tiny_reader(6), num_passes=1, prefetch=0,
                        staging=False)
    assert not (rec2 and rec2.get("restart"))


def test_late_request_after_final_batch_does_not_leak(tmp_path):
    with core.scope_guard(core.Scope()):
        tr, _ = _tiny_trainer(tmp_path)

        def handler(e):
            if isinstance(e, EndPass):
                tr.request_restart("late_generation_bump")
                tr.request_stop("late_sigterm")

        rec = tr.train(_tiny_reader(3), num_passes=1,
                       event_handler=handler, prefetch=0, staging=False)
        assert rec is None
        assert tr._stop_reason is None and tr._restart_reason is None
        assert tr.train(_tiny_reader(3), num_passes=1, prefetch=0,
                        staging=False) is None


def test_abort_without_a_group_is_a_noop():
    assert not launch.multihost_active()
    assert launch.abort_multihost() is False
    assert el.collective_abort("nothing") is False


def test_single_process_default_path_untouched(tmp_path, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_COORDINATOR", raising=False)
    monkeypatch.setattr(
        "torch.distributed.init_process_group",
        lambda *a, **kw: pytest.fail("init_process_group on no-op path"))
    assert launch.init_multihost() == (0, 1)
    names = ("paddle_elastic_restarts_total",
             "paddle_elastic_worker_deaths_total",
             "paddle_elastic_heartbeats_total")
    before = [_metric(n) for n in names]
    with core.scope_guard(core.Scope()):
        tr, _ = _tiny_trainer(tmp_path)
        tr.train(_tiny_reader(3), num_passes=1, prefetch=0, staging=False)
    assert tr._restart_reason is None
    assert [_metric(n) for n in names] == before


@pytest.mark.slow
@pytest.mark.chaos
def test_elastic_chaos_sigkill_one_of_three(tmp_path):
    """SIGKILL 1 of 3 local CPU workers mid-pass (each its own process,
    importing the port only): the survivors detect the loss through the
    heartbeat deadline, rebuild at G+1, restore their newest intact
    checkpoint and finish the pass with finite losses; the subprocess
    timeout is the no-hang bound."""
    import json
    N = 240
    rs = np.random.RandomState(3)
    X = rs.randn(N, 4).astype("float32")
    Y = (X.sum(1, keepdims=True) * 0.5).astype("float32")
    d = tmp_path / "ds"
    d.mkdir()
    for f in range(6):
        recordio.write_recordio(
            str(d / ("lin-%05d" % f)),
            ((i, X[i].tolist(), Y[i].tolist())
             for i in range(f * 40, (f + 1) * 40)),
            max_chunk_bytes=1 << 10)
    ds_glob = str(d / "lin-*")
    srv = MasterServer(str(tmp_path / "snap"), timeout_sec=5,
                       heartbeat_timeout_ms=1200)
    worker = os.path.join(ROOT, "tests", "torch_elastic_child.py")
    procs = []
    try:
        client = MasterClient(srv.port)
        n_chunks = ElasticDataDispatcher(client, ds_glob).register_dataset()
        for idx in range(3):
            procs.append(subprocess.Popen(
                [sys.executable, worker, ROOT, str(srv.port), ds_glob,
                 str(tmp_path / ("ckpt_w%d" % idx)),
                 str(tmp_path / ("out_w%d.json" % idx)), str(idx),
                 str(3 if idx == 1 else 0), "3"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=420)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate(timeout=10)
                pytest.fail("worker hung:\n" + out[-3000:])
            outs.append(out)
        assert procs[1].returncode == -9, outs[1][-2000:]
        assert procs[0].returncode == 0, outs[0][-3000:]
        assert procs[2].returncode == 0, outs[2][-3000:]
        for idx in (0, 2):
            with open(tmp_path / ("out_w%d.json" % idx)) as f:
                s = json.load(f)
            assert max(s["generations"]) > s["generations"][0]
            assert s["restarts"] >= 1 and s["losses"]
            assert np.isfinite(s["losses"]).all()
        stats = client.stats()
        assert stats["todo"] == 0 and stats["pending"] == 0
        assert stats["done"] == n_chunks
        assert client.cluster()["deaths"] >= 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        srv.stop()
