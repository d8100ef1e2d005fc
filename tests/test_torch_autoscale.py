"""The autoscaler and the tenant tier of the port
(``paddle_tpu_torch/serving/autoscale.py``, ``fleet.py``) against the
reference's, on the CPU.

* **Parity**: one scripted ``tick(now=..., burn=...)`` sequence (burn,
  joins, a spawn that exits before registering, a wedged spawn swept at
  its deadline, the failure budget's halt and reset, idle retirements
  down to ``members_min``) through both packages' ``FleetAutoscaler``
  over the same stub router: equal launches, retirements and ``doc()``
  after every tick.
* The reference's CPU classes (``tests/test_autoscale.py``) against the
  port: the control loop on a simulated clock over a stub router, the
  flags read at construction only, and the tenant tier (quota sheds,
  tenants on every hop, priority tiers, per-tenant SLOs) over the fake
  members of ``tests/test_torch_fleet.py``.
* ``slow``: a burst spawns a real ``probes.fleet_worker`` process
  (``--device cpu``) that serves and is drained back out.
"""

import os
import subprocess
import sys
import threading
import time

import pytest

from paddle_tpu.serving.autoscale import FleetAutoscaler as RefAutoscaler
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch.observability import metrics, slo
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving.autoscale import FleetAutoscaler
from paddle_tpu_torch.serving.batcher import ServingOverloadError
from paddle_tpu_torch.serving.fleet import TenantQuotaError

from test_torch_fleet import FakeMember, counter, make_router
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = [pytest.mark.autoscale, pytest.mark.usefixtures("one_thread")]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()


class StubHandle:
    """poll()/kill() — the slice of Popen the autoscaler needs."""

    def __init__(self, exit_code=None):
        self.exit_code = exit_code
        self.killed = False

    def poll(self):
        return self.exit_code

    def kill(self):
        self.killed = True
        self.exit_code = -9


class StubRouter:
    """The router surface the control loop reads: membership, loads,
    the shed/wait signals, and the retire verb. Spawned members
    'join' when the test moves them from handles into ``live``."""

    def __init__(self, members_min=1):
        self.members_min = members_min
        self.label = "stub"
        self.live = []            # member ids in the rotation
        self.loads = {}           # mid -> inflight
        self.place_wait_ewma = 0.0
        self.sheds = 0.0
        self.retired = []
        self._autoscaler = None

    def members_live(self):
        return list(self.live)

    def member_loads(self):
        return {mid: self.loads.get(mid, 0) for mid in self.live}

    def shed_signal(self):
        return self.sheds

    def attach_autoscaler(self, scaler):
        self._autoscaler = scaler

    def retire_member(self, mid, drain_timeout=10.0):
        self.retired.append(mid)
        self.live.remove(mid)
        self.loads.pop(mid, None)
        return True


def make_scaler(router, spawned=None, **kw):
    """An autoscaler whose spawn callable records launches and hands
    back StubHandles the test controls."""
    spawned = [] if spawned is None else spawned

    def spawn(mid):
        handle = StubHandle()
        spawned.append((mid, handle))
        return handle

    kw.setdefault("members_max", 4)
    kw.setdefault("burn_threshold", 1.0)
    kw.setdefault("cooldown_ms", 1000.0)
    kw.setdefault("idle_ms", 2000.0)
    kw.setdefault("spawn_timeout_ms", 5000.0)
    kw.setdefault("spawn_failure_budget", 3)
    kw.setdefault("member_prefix", "as")
    return FleetAutoscaler(router, kw.pop("spawn", spawn), **kw), spawned


def settle(scaler, timeout=2.0):
    """Wait out the short-lived spawn/retire daemon threads (the
    simulated clock drives decisions; only the launches are real)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        alive = [t for t in threading.enumerate()
                 if t.name.startswith(("autoscale-spawn",
                                       "autoscale-retire"))]
        if not alive:
            return
        time.sleep(0.01)


class TestControlLoop:
    def test_spawn_on_burn_then_join(self):
        router = StubRouter(members_min=1)
        router.live = ["m0"]
        scaler, spawned = make_scaler(router)
        try:
            before = counter("paddle_autoscale_scale_ups_total")
            scaler.tick(now=0.0, burn=2.0)
            settle(scaler)
            assert len(spawned) == 1
            mid, _handle = spawned[0]
            assert mid.startswith("as-")
            assert scaler.doc(now=0.0)["pending"] == [mid]
            # the REG lands (the stub test's stand-in): next tick
            # sweeps pending -> joined and records the join latency
            router.live.append(mid)
            scaler.tick(now=0.5, burn=0.0)
            doc = scaler.doc(now=0.5)
            assert doc["pending"] == []
            assert doc["spawned"] == [mid]
            assert counter("paddle_autoscale_scale_ups_total") \
                == before + 1
        finally:
            scaler.close()

    def test_one_action_per_cooldown(self):
        """Hysteresis: sustained pressure spawns once per cooldown
        window, never a thundering herd of processes."""
        router = StubRouter()
        router.live = ["m0"]
        scaler, spawned = make_scaler(router, cooldown_ms=1000.0)
        try:
            scaler.tick(now=0.0, burn=5.0)
            settle(scaler)
            router.live.append(spawned[0][0])
            # pressure stays high through the whole cooldown window:
            # pending is resolved but the window still gates
            for t in (0.1, 0.4, 0.8, 0.99):
                scaler.tick(now=t, burn=5.0)
            settle(scaler)
            assert len(spawned) == 1
            scaler.tick(now=1.05, burn=5.0)
            settle(scaler)
            assert len(spawned) == 2
        finally:
            scaler.close()

    def test_no_action_while_spawn_pending(self):
        router = StubRouter()
        router.live = ["m0"]
        scaler, spawned = make_scaler(router, cooldown_ms=10.0)
        try:
            scaler.tick(now=0.0, burn=5.0)
            settle(scaler)
            # cooldown expired but the spawn has not REGed yet: the
            # in-flight action blocks the next one, not the clock
            scaler.tick(now=1.0, burn=5.0)
            settle(scaler)
            assert len(spawned) == 1
        finally:
            scaler.close()

    def test_shed_rate_trigger_requires_rising_wait(self):
        """The second signal: sheds alone (a quota refusal burst on an
        otherwise idle fleet) do not spawn — sheds WITH a rising
        placement wait do."""
        router = StubRouter()
        router.live = ["m0"]
        scaler, spawned = make_scaler(router)
        try:
            scaler.tick(now=0.0, burn=0.0)     # baseline signals
            router.sheds = 3.0                  # sheds, wait flat
            scaler.tick(now=0.1, burn=0.0)
            settle(scaler)
            assert spawned == []
            router.sheds = 6.0                  # sheds AND wait rising
            router.place_wait_ewma = 0.050
            scaler.tick(now=0.2, burn=0.0)
            settle(scaler)
            assert len(spawned) == 1
            assert scaler.doc()["pending"] or scaler.doc()["spawned"]
        finally:
            scaler.close()

    def test_members_max_bound(self):
        router = StubRouter()
        router.live = ["m0", "m1"]
        scaler, spawned = make_scaler(router, members_max=2)
        try:
            scaler.tick(now=0.0, burn=9.0)
            settle(scaler)
            assert spawned == []
            assert scaler.request_scale_up(now=0.1) is None
        finally:
            scaler.close()

    def test_retire_idle_prefers_own_newest_and_stops_at_min(self):
        router = StubRouter(members_min=1)
        router.live = ["m0"]
        scaler, spawned = make_scaler(
            router, cooldown_ms=100.0, idle_ms=500.0)
        try:
            # grow to 3: two autoscaler spawns join
            for t in (0.0, 0.2):
                scaler.tick(now=t, burn=5.0)
                settle(scaler)
                router.live.append(spawned[-1][0])
            assert router.live == ["m0", "as-1", "as-2"]
            # idle clock starts at the first pressure-free tick; the
            # retire fires only after idle_ms of CONTINUOUS zero load
            scaler.tick(now=1.0, burn=0.0)
            scaler.tick(now=1.3, burn=0.0)
            settle(scaler)
            assert router.retired == []
            scaler.tick(now=1.6, burn=0.0)   # 0.6s idle > 0.5s
            settle(scaler)
            assert router.retired == ["as-2"]   # last hired, first out
            scaler.tick(now=2.5, burn=0.0)
            settle(scaler)
            assert router.retired == ["as-2", "as-1"]
            # m0 survives: capacity is at members_min
            scaler.tick(now=9.0, burn=0.0)
            settle(scaler)
            assert router.live == ["m0"]
            assert counter("paddle_autoscale_scale_downs_total") >= 2
        finally:
            scaler.close()

    def test_busy_member_is_not_idle(self):
        router = StubRouter(members_min=1)
        router.live = ["m0", "as-x"]
        scaler, _ = make_scaler(router, idle_ms=500.0)
        try:
            router.loads = {"m0": 1, "as-x": 2}
            scaler.tick(now=0.0, burn=0.0)
            scaler.tick(now=5.0, burn=0.0)   # way past idle_ms
            settle(scaler)
            assert router.retired == []
            # as-x drains -> ITS idle clock starts NOW, not at t=0
            router.loads = {"m0": 1, "as-x": 0}
            scaler.tick(now=6.0, burn=0.0)
            scaler.tick(now=6.2, burn=0.0)
            settle(scaler)
            assert router.retired == []
            scaler.tick(now=6.7, burn=0.0)
            settle(scaler)
            assert router.retired == ["as-x"]
        finally:
            scaler.close()

    def test_spawn_exit_before_reg_charged(self):
        router = StubRouter()
        router.live = ["m0"]
        scaler, spawned = make_scaler(router, cooldown_ms=10.0)
        try:
            before = counter("paddle_autoscale_spawn_failures_total")
            scaler.tick(now=0.0, burn=5.0)
            settle(scaler)
            spawned[0][1].exit_code = 1    # died before its REG
            scaler.tick(now=0.5, burn=0.0)
            assert scaler.spawn_failures == 1
            assert scaler.doc()["pending"] == []
            assert counter("paddle_autoscale_spawn_failures_total") \
                == before + 1
        finally:
            scaler.close()

    def test_wedged_spawn_swept_at_deadline(self):
        router = StubRouter()
        router.live = ["m0"]
        scaler, spawned = make_scaler(
            router, cooldown_ms=10.0, spawn_timeout_ms=3000.0)
        try:
            scaler.tick(now=0.0, burn=5.0)
            settle(scaler)
            handle = spawned[0][1]
            scaler.tick(now=2.9, burn=0.0)   # inside the bound
            assert not handle.killed
            scaler.tick(now=3.1, burn=0.0)   # past it: kill + charge
            assert handle.killed
            assert scaler.spawn_failures == 1
        finally:
            scaler.close()

    def test_failure_budget_halts_then_resets(self):
        router = StubRouter()
        router.live = ["m0"]

        def bad_spawn(mid):
            raise OSError("no such binary")

        scaler = FleetAutoscaler(
            router, bad_spawn, members_max=4, burn_threshold=1.0,
            cooldown_ms=10.0, idle_ms=2000.0, spawn_timeout_ms=5000.0,
            spawn_failure_budget=2, member_prefix="bad")
        try:
            for t in (0.0, 1.0, 2.0, 3.0):
                scaler.tick(now=t, burn=5.0)
                settle(scaler)
            assert scaler.halted
            assert scaler.spawn_failures == 2   # budget, not tick count
            assert scaler.request_scale_up(now=4.0) is None
            scaler.reset_spawn_budget()
            assert not scaler.halted
            scaler.tick(now=5.0, burn=5.0)
            settle(scaler)
            assert scaler.spawn_failures == 1   # spawning re-armed
        finally:
            scaler.close()

    def test_fault_site_fleet_spawn_fail(self):
        """The armed ``fleet_spawn_fail`` site IS a spawn that dies
        before REG: charged to the budget, monitor never blocked."""
        router = StubRouter()
        router.live = ["m0"]
        scaler, spawned = make_scaler(router, cooldown_ms=10.0)
        try:
            faults.arm("fleet_spawn_fail", times=1)
            scaler.tick(now=0.0, burn=5.0)
            settle(scaler)
            assert spawned == []       # the fault fired before spawn()
            assert scaler.spawn_failures == 1
            # the next window's spawn is clean
            scaler.tick(now=1.0, burn=5.0)
            settle(scaler)
            assert len(spawned) == 1
        finally:
            faults.disarm()
            scaler.close()

    def test_fault_site_fleet_spawn_slow(self):
        """``fleet_spawn_slow`` wedges the launch thread past the
        spawn bound; the sweep kills and charges it without the tick
        ever waiting on the wedged thread."""
        router = StubRouter()
        router.live = ["m0"]
        release = threading.Event()
        scaler, spawned = make_scaler(
            router, cooldown_ms=10.0, spawn_timeout_ms=1000.0)
        try:
            faults.arm("fleet_spawn_slow", times=1, action="callback",
                       callback=lambda spec: release.wait(5.0))
            t0 = time.monotonic()
            scaler.tick(now=0.0, burn=5.0)
            assert time.monotonic() - t0 < 0.5   # tick never blocked
            deadline = time.monotonic() + 2.0
            while not spawned and time.monotonic() < deadline:
                time.sleep(0.01)
            handle = spawned[0][1]
            scaler.tick(now=1.5, burn=0.0)   # past the 1s bound
            assert scaler.spawn_failures == 1
            # the kill lands on whichever side lost the race (the
            # sweep, or the launch thread finding itself swept)
            deadline = time.monotonic() + 2.0
            while not handle.killed and time.monotonic() < deadline:
                time.sleep(0.01)
            assert handle.killed
        finally:
            release.set()
            faults.disarm()
            settle(scaler)
            scaler.close()

    def test_request_scale_up_bypasses_pressure_not_bounds(self):
        router = StubRouter()
        router.live = ["m0"]
        scaler, spawned = make_scaler(router, members_max=2)
        try:
            mid = scaler.request_scale_up(now=0.0)
            assert mid is not None
            settle(scaler)
            assert [s[0] for s in spawned] == [mid]
            # one spawn in flight -> a second manual ask is refused
            assert scaler.request_scale_up(now=0.1) is None
        finally:
            scaler.close()

    def test_close_kills_pending_and_detaches(self):
        router = StubRouter()
        router.live = ["m0"]
        scaler, spawned = make_scaler(router)
        scaler.tick(now=0.0, burn=5.0)
        settle(scaler)
        assert router._autoscaler is scaler
        scaler.close()
        assert router._autoscaler is None
        assert spawned[0][1].killed
        # the scaler's labeled gauges are swept from the registry
        for fam in ("paddle_autoscale_pending_spawns",
                    "paddle_autoscale_pressure"):
            samples = metrics.REGISTRY.dump().get(fam, {}) \
                .get("samples", ())
            assert not [s for s in samples
                        if s["labels"].get("scaler") == scaler.label]


class TestAutoscaleFlags:
    def test_flags_read_only_at_construction(self, monkeypatch):
        calls = []
        orig = port_config.get_flag

        def counting(name):
            calls.append(name)
            return orig(name)
        monkeypatch.setattr(port_config, "get_flag", counting)
        router = StubRouter()
        router.live = ["m0"]
        scaler = FleetAutoscaler(router, lambda mid: StubHandle())
        try:
            assert [c for c in calls
                    if c.startswith(("fleet_", "autoscale_"))] \
                == ["fleet_members_max", "autoscale_burn_threshold",
                    "autoscale_cooldown_ms", "autoscale_idle_ms",
                    "autoscale_spawn_timeout_ms",
                    "autoscale_spawn_failures"]
            assert scaler.members_min == router.members_min
            calls.clear()
            for t in (0.0, 1.0, 2.0):
                scaler.tick(now=t, burn=0.0)
            assert not [c for c in calls
                        if c.startswith(("fleet_", "autoscale_"))]
        finally:
            scaler.close()

    def test_flag_values_land(self):
        router = StubRouter()
        names = ("fleet_members_max", "autoscale_burn_threshold",
                 "autoscale_cooldown_ms", "autoscale_idle_ms",
                 "autoscale_spawn_timeout_ms",
                 "autoscale_spawn_failures")
        saved = {n: port_config.get_flag(n) for n in names}
        port_config.set_flags(fleet_members_max=6,
                              autoscale_burn_threshold=2.5,
                              autoscale_cooldown_ms=750.0,
                              autoscale_idle_ms=4000.0,
                              autoscale_spawn_timeout_ms=9000.0,
                              autoscale_spawn_failures=5)
        try:
            scaler = FleetAutoscaler(router, lambda mid: StubHandle())
            assert scaler.members_max == 6
            assert scaler.burn_threshold == 2.5
            assert scaler.cooldown == 0.75
            assert scaler.idle == 4.0
            assert scaler.spawn_timeout == 9.0
            assert scaler.spawn_failure_budget == 5
            scaler.close()
        finally:
            port_config.set_flags(**saved)


class RecordingMember(FakeMember):
    """FakeMember that also keeps the raw generate envelopes, so
    tenant propagation (and its ABSENCE for single-tenant traffic)
    is asserted on the wire, not on router internals."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.envelopes = []

    def _handle(self, conn, msg):
        if msg.get("cmd") == "generate":
            self.envelopes.append(dict(msg))
        return super()._handle(conn, msg)


class TestTenancy:
    def test_quota_shed_is_typed_and_isolated(self):
        """Tenant a bursts past its quota: ITS submits shed with a
        typed TenantQuotaError, tenant b (and the table's "*" row)
        keeps being served, and the shed lands on a's counter only."""
        router = make_router(
            tenants={"a": {"quota": 1, "priority": 0},
                     "b": {"quota": 4, "priority": 0},
                     "*": {"quota": 2, "priority": 1}})
        fm = FakeMember(delay=0.25)
        try:
            fm.register(router, "m0")
            label_a = "f%d:a" % router._rid

            def shed_count(label):
                for s in metrics.REGISTRY.dump().get(
                        "paddle_serving_tenant_shed_total",
                        {}).get("samples", ()):
                    if s["labels"].get("tenant") == label:
                        return s["value"]
                return 0.0

            before = shed_count(label_a)
            f1 = router.submit([3], max_new_tokens=2, tenant="a")
            time.sleep(0.05)   # a's slot is held in flight
            with pytest.raises(TenantQuotaError) as ei:
                router.submit([4], max_new_tokens=2, tenant="a")
            assert ei.value.tenant == "a"
            assert isinstance(ei.value, ServingOverloadError)
            # the victim and a lazily-created "*" tenant still land
            f2 = router.submit([5], max_new_tokens=2, tenant="b")
            f3 = router.submit([6], max_new_tokens=2,
                               tenant="stranger")
            assert len(f1.result(timeout=10)) == 2
            assert len(f2.result(timeout=10)) == 2
            assert len(f3.result(timeout=10)) == 2
            assert shed_count(label_a) == before + 1
            assert shed_count("f%d:b" % router._rid) == 0.0
            doc = router.fleet_doc()
            assert doc["tenants"]["a"]["sheds"] == 1
            assert doc["tenants"]["b"]["sheds"] == 0
            assert doc["tenants"]["stranger"]["quota"] == 2
            # slots released after resolution: a admits again
            assert len(router.submit([7], max_new_tokens=2,
                                     tenant="a").result(timeout=10)) \
                == 2
        finally:
            router.close()
            fm.close()

    def test_tenant_rides_every_envelope_and_replay_hop(self):
        """The tenant id is stamped once at submit and re-sent on the
        failover re-drive envelope; tenantless traffic has NO tenant
        key at all (pre-tenant frames stay byte-identical)."""
        dying = RecordingMember(die_after=2)
        healthy = RecordingMember()
        router = make_router(
            tenants={"a": {"quota": 8, "priority": 0}})
        try:
            # first-registered wins the idle tie: the request lands on
            # the dying member, dies after 2 tokens, re-drives on the
            # peer (the test_fleet failover pattern)
            dying.register(router, "m0")
            healthy.register(router, "m1")
            out = router.submit([11], max_new_tokens=4, tenant="a",
                                meta=True).result(timeout=10)
            assert out["replays"] == 1 and out["member"] == "m1"
            assert len(out["tokens"]) == 4
            hops = dying.envelopes + healthy.envelopes
            assert len(hops) >= 2   # the original AND the replay hop
            assert all(m.get("tenant") == "a" for m in hops)
            # single-tenant path: the key is absent, not null
            router.submit([13], max_new_tokens=2).result(timeout=10)
            bare = [m for m in dying.envelopes + healthy.envelopes
                    if m["prompt"] == [13]]
            assert bare and all("tenant" not in m for m in bare)
        finally:
            router.close()
            dying.close()
            healthy.close()

    def test_priority_tiers_order_contended_placement(self):
        """With a per-member in-flight cap, placement is a queue — a
        waiting priority-0 tenant is served before an earlier-arrived
        priority-1 tenant."""
        router = make_router(
            tenants={"hi": {"quota": 0, "priority": 0},
                     "lo": {"quota": 0, "priority": 1}},
            member_inflight_limit=1)
        fm = FakeMember(delay=0.15)
        try:
            fm.register(router, "m0")
            filler = router.submit([3], max_new_tokens=1, tenant="lo")
            time.sleep(0.05)             # filler occupies the slot
            lo = router.submit([4], max_new_tokens=1, tenant="lo")
            time.sleep(0.05)             # lo queues first...
            hi = router.submit([5], max_new_tokens=1, tenant="hi")
            for f in (filler, lo, hi):
                f.result(timeout=10)
            assert fm.requests.index([5]) < fm.requests.index([4])
            assert router.place_wait_ewma > 0.0
        finally:
            router.close()
            fm.close()

    def test_per_tenant_slo_trackers_and_sweep(self):
        """A nonzero SLO target + a tenant table builds one tracker
        per NAMED tenant reading only its own labeled children; close
        sweeps every per-tenant label off the registry."""
        router = make_router(
            slo_target_p99_ms=500.0,
            tenants={"a": {"quota": 0, "priority": 0},
                     "b": {"quota": 0, "priority": 0}})
        fm = FakeMember()
        rid = router._rid
        try:
            fm.register(router, "m0")
            assert sorted(router._tenant_slos) == ["a", "b"]
            for _ in range(3):
                router.submit([3], max_new_tokens=2,
                              tenant="a").result(timeout=10)
            router.submit([4], max_new_tokens=2,
                          tenant="b").result(timeout=10)
            # the labeled source splits good events by tenant
            assert router._tenant_slos["a"]._source()["count"] == 3
            assert router._tenant_slos["b"]._source()["count"] == 1
            for tracker in router._tenant_slos.values():
                tracker.tick()
            verdict = router._tenant_slos["a"].verdict()
            assert verdict["target_p99_ms"] == 500.0
        finally:
            router.close()
            fm.close()
        dump = metrics.REGISTRY.dump()
        prefix = "f%d:" % rid
        for fam, doc in dump.items():
            for s in doc.get("samples", ()):
                assert not str(s["labels"].get("tenant",
                                               "")).startswith(prefix), \
                    (fam, s["labels"])

    def test_labeled_source_filters_bad_counters(self):
        """slo.labeled_source: the bad-event count for one tenant
        label never includes another tenant's sheds."""
        from paddle_tpu_torch.serving.resilience import TENANT_SHED
        TENANT_SHED.labels(tenant="ls:x").inc()
        TENANT_SHED.labels(tenant="ls:x").inc()
        TENANT_SHED.labels(tenant="ls:y").inc()
        src = slo.labeled_source(
            histogram="paddle_fleet_tenant_request_ms",
            bad_counters=("paddle_serving_tenant_shed_total",),
            label="tenant", value="ls:x")
        assert src()["bad"] == 2.0
        metrics.REGISTRY.remove_labeled("tenant", prefix="ls:")


@pytest.mark.slow
@pytest.mark.chaos
class TestAutoscaleSubprocess:
    def test_burst_spawns_member_that_serves_then_drains(self):
        """Acceptance: an empty fleet under burst pressure -> the
        autoscaler spawns a REAL engine-worker process -> it REGs and
        serves the first tokens -> the burst ends and the idle member
        drains back out, capacity returning to members_min."""
        router = make_router(members_min=0, placement_timeout=60.0)
        procs = []

        def spawn(mid):
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "paddle_tpu_torch.probes.fleet_worker",
                 "--router", "%s:%d" % router.addr,
                 "--member", mid, "--heartbeat-ms", "150",
                 "--device", "cpu"],
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL, cwd=ROOT)
            procs.append(proc)
            return proc

        scaler = FleetAutoscaler(
            router, spawn, members_min=0, members_max=2,
            burn_threshold=1.0, cooldown_ms=200.0, idle_ms=400.0,
            spawn_timeout_ms=60000.0, spawn_failure_budget=2,
            member_prefix="asx", drain_timeout=5.0)
        try:
            scaler.tick(burn=3.0)      # the burst signal
            assert scaler.doc()["pending"], "no spawn launched"
            deadline = time.monotonic() + 60.0
            while not router.members_live() \
                    and time.monotonic() < deadline:
                time.sleep(0.1)
                scaler.tick(burn=3.0)
            assert router.members_live() == ["asx-1"]
            out = router.submit([5, 6, 7], max_new_tokens=4,
                                meta=True).result(timeout=60)
            assert out["member"] == "asx-1"
            assert len(out["tokens"]) == 4
            assert scaler.spawn_failures == 0
            # burst over: ticks with no pressure drain it back
            deadline = time.monotonic() + 30.0
            while router.members_live() \
                    and time.monotonic() < deadline:
                scaler.tick(burn=0.0)
                time.sleep(0.1)
            assert router.members_live() == []
            assert len(router.members_live()) == scaler.members_min
            deadline = time.monotonic() + 10.0
            while procs[0].poll() is None \
                    and time.monotonic() < deadline:
                time.sleep(0.1)
            assert procs[0].poll() is not None   # stop verb honored
        finally:
            scaler.close()
            router.close()
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()


# -- parity with the reference's controller --------------------------------

def _script(cls):
    """Drive one controller through a scripted simulated-clock sequence;
    the record after every tick: (launched ids, retired ids, doc())."""
    router = StubRouter(members_min=1)
    router.live = ["m0"]
    handles = {}

    def spawn(mid):
        h = StubHandle()
        handles[mid] = h
        return h
    scaler = cls(router, spawn, members_max=3, burn_threshold=1.0,
                 cooldown_ms=1000.0, idle_ms=2000.0,
                 spawn_timeout_ms=5000.0, spawn_failure_budget=2,
                 member_prefix="as")
    record = []

    def tick(now, burn, join=(), exit_=(), busy=None):
        for mid in join:
            router.live.append(mid)
        for mid in exit_:
            handles[mid].exit_code = 1
        if busy is not None:
            router.loads = dict(busy)
        scaler.tick(now=now, burn=burn)
        settle(scaler)
        record.append((sorted(handles), list(router.retired),
                       scaler.doc(now=now)))
    try:
        tick(0.0, 2.0)                        # burn: launch as-1
        tick(0.5, 2.0)                        # pending: no action
        tick(1.0, 2.0, join=["as-1"])         # joins
        tick(1.5, 2.0)                        # cooldown
        tick(2.5, 2.0)                        # launch as-2
        tick(3.0, 2.0, exit_=["as-2"])        # exits before REG: charged
        tick(4.0, 2.0)                        # launch as-3
        tick(9.5, 2.0)                        # wedged past 5 s: charged
        tick(11.0, 2.0)                       # budget spent: halted
        scaler.reset_spawn_budget()
        tick(12.0, 0.0, busy={"m0": 1})       # calm; m0 busy
        tick(13.0, 0.0)                       # idle clocks start
        tick(15.5, 0.0)                       # as-1 idle 2.5 s: retired
        tick(17.0, 0.0)                       # at members_min: stays
        tick(18.0, 3.0)                       # burn again: launch as-4
        tick(18.5, 3.0, join=["as-4"])
    finally:
        scaler.close()
    return record


def test_tick_sequence_equals_the_reference():
    ours, theirs = _script(FleetAutoscaler), _script(RefAutoscaler)
    assert ours == theirs
    launched, retired, doc = ours[-1]
    assert launched == ["as-1", "as-2", "as-3", "as-4"]
    assert retired == ["as-1"]
    assert doc["spawned"] == ["as-4"] and not doc["halted"]
    # halted from the second charge (9.5 s) until the reset after 11 s
    assert [r[2]["halted"] for r in ours] == [False] * 7 + [True] * 2 + \
        [False] * 6


def test_a_member_that_joins_before_its_spawn_returns_lives():
    """A spawn callable that blocks until its member is up (as a process
    launcher waiting for READY does) returns after the member
    registered: when a tick swept the join first, the member is the
    fleet's and is not killed (the reference's launch thread kills it,
    taking the emptied pending entry for a charged one)."""
    router = StubRouter(members_min=1)
    router.live = ["m0"]
    joined, handles = threading.Event(), []

    def spawn(mid):
        router.live.append(mid)     # REGistered ...
        joined.wait(5.0)            # ... before the callable returns
        h = StubHandle()
        handles.append(h)
        return h
    for cls in (FleetAutoscaler, RefAutoscaler):
        router.live, joined, handles[:] = ["m0"], threading.Event(), []
        scaler = cls(router, spawn, members_max=3, burn_threshold=1.0,
                     cooldown_ms=1000.0, idle_ms=2000.0,
                     spawn_timeout_ms=5000.0, spawn_failure_budget=2,
                     member_prefix="as")
        try:
            mid = scaler.request_scale_up(now=0.0)
            deadline = time.monotonic() + 5
            while mid not in router.live and time.monotonic() < deadline:
                time.sleep(0.005)
            scaler.tick(now=0.5, burn=0.0)      # the sweep sees the join
            assert scaler.doc(now=0.5)["spawned"] == [mid]
            joined.set()
            settle(scaler)
            killed = handles[0].killed
        finally:
            scaler.close()
        assert killed == (cls is RefAutoscaler), cls

