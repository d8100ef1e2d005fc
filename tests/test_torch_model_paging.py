"""Multi-model paging of the port (``paddle_tpu_torch/serving/
model_paging.py`` and the router's and worker's paging halves in
``fleet.py``) against the reference's, on the CPU.

* **Parity**: ``ModelCatalog.from_value`` (ids, tenant resolution,
  ``doc()``, the errors) and ``ModelResidencySet`` (``update``, ``add``,
  ``touch``, ``pin``/``unpin``, ``drop`` and ``lru_victims``) equal the
  reference's on random sequences (hypothesis).
* **Real workers**: a catalog-armed port router over two port workers on
  the tiny LM, models A (seed 7) and B (seed 11), a resident budget of
  1.5 models: the first B request pages B in and evicts A from its
  member, mixed traffic then hits the resident members, and every
  stream equals its model's reference in-process scheduler's.
* The reference's CPU classes (``tests/test_model_paging.py``) against
  the port: the catalog units, residency-affinity routing, demand
  page-in (one staged load for a burst, failures charged to the spawn
  budget), LRU eviction with the in-flight pin invariant and the evict
  race, the model journal fence, model-scoped deploys, one real port
  worker paging a second weight set in and back, and the paging flags
  read only with a catalog.
"""

import os
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import fleet_worker_child as child
from paddle_tpu.serving import model_paging as ref_mp
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.probes import fleet_worker as fw
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import model_paging as mp
from paddle_tpu_torch.serving import wire
from paddle_tpu_torch.serving.fleet import EngineWorker, FleetRouter

from test_torch_fleet import FakeMember, counter, fake_next, make_router

pytestmark = pytest.mark.paging


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()


def labeled(name, **labels):
    """Sum of a family's samples whose labels include ``labels``."""
    total = 0.0
    for s in metrics.REGISTRY.dump().get(name, {}).get("samples", ()):
        if all(s.get("labels", {}).get(k) == v
               for k, v in labels.items()):
            total += s["value"]
    return total


def model_oracle(prompt, n, shift=0):
    """The fault-free generation of the fake members' per-model LM."""
    hist = list(prompt)
    out = []
    for _ in range(n):
        t = fake_next(hist) + shift
        hist.append(t)
        out.append(t)
    return out


class FakeModelMember(FakeMember):
    """A FakeMember that holds a resident-model set: advertises it on
    REG, answers page_in/page_out/model-scoped swap, activates the
    model a generate envelope names (or refuses kind="model"), and
    acks the active model id + its per-model version."""

    def __init__(self, active, resident=(), shifts=None,
                 page_delay=0.0, refuse_page=False, **kw):
        self.active = str(active)
        self.resident_models = {self.active} | {
            str(r) for r in resident}
        self.versions = {m: "%s@v0" % m for m in self.resident_models}
        self.shifts = {str(k): int(v)
                       for k, v in (shifts or {}).items()}
        self.page_delay = float(page_delay)
        self.refuse_page = refuse_page
        self.page_ins = []
        self.page_outs = []
        self.swaps = []
        kw.setdefault("version", self.versions[self.active])
        super().__init__(**kw)

    def register(self, router, mid, version=None):
        rep = wire.call_once(
            router.addr,
            {"cmd": "reg", "member": mid, "addr": list(self.addr),
             "version": version or self.versions[self.active],
             "models": sorted(self.resident_models),
             "active_model": self.active})
        assert rep["ok"], rep
        return rep["generation"]

    def _handle(self, conn, msg):
        cmd = msg.get("cmd")
        if cmd == "page_in":
            model = str(msg["model"])
            if self.page_delay:
                time.sleep(self.page_delay)
            if self.refuse_page:
                conn.send({"ok": False,
                           "error": "injected page-in refusal"})
                return
            self.page_ins.append(model)
            self.resident_models.add(model)
            self.versions[model] = str(msg.get("tag")
                                       or "%s@v0" % model)
            self.active = model
            conn.send({"ok": True, "version": self.versions[model],
                       "model": model,
                       "models": sorted(self.resident_models)})
            return
        if cmd == "page_out":
            model = str(msg["model"])
            if model == self.active:
                conn.send({"ok": False,
                           "error": "model %r is active" % model})
                return
            if model not in self.resident_models:
                conn.send({"ok": False, "error": "not resident"})
                return
            self.page_outs.append(model)
            self.resident_models.discard(model)
            conn.send({"ok": True,
                       "models": sorted(self.resident_models)})
            return
        if cmd == "swap":
            tag = str(msg.get("tag"))
            model = msg.get("model")
            if model is not None:
                model = str(model)
                if model not in self.resident_models:
                    conn.send({"ok": False, "error": "not resident"})
                    return
                self.active = model
            self.swaps.append((model, tag))
            self.versions[self.active] = tag
            conn.send({"ok": True, "version": tag})
            return
        if cmd != "generate":
            conn.send({"ok": False, "error": "fake model member"})
            return
        self.requests.append(list(msg["prompt"]))
        env_model = msg.get("model")
        if env_model is not None:
            env_model = str(env_model)
            if env_model != self.active:
                if env_model not in self.resident_models:
                    conn.send({"ev": "err", "kind": "model",
                               "error": "model %r not resident"
                               % env_model})
                    return
                self.active = env_model
        # the weights this request decodes under are fixed at
        # dispatch: a concurrent page-in activating another model
        # must not switch the token function mid-request
        active = self.active
        version = self.versions[active]
        shift = self.shifts.get(active, 0)
        if self.delay:
            time.sleep(self.delay)
        if self.fail:
            conn.send({"ev": "err", "kind": "server",
                       "error": "injected member failure"})
            return
        conn.send({"ev": "ack", "member": "fake", "pid": os.getpid(),
                   "version": version, "eos_id": 1,
                   "model": active})
        hist = list(msg["prompt"])
        out = []
        n = msg.get("max_new") or 4
        for i in range(n):
            t = fake_next(hist) + shift
            hist.append(t)
            out.append(t)
            conn.send({"ev": "tok", "t": t})
            if self.die_after is not None and i + 1 == self.die_after:
                return False  # close the conn: death mid-stream
        conn.send({"ev": "done", "tokens": out, "version": version,
                   "version_start": version})


CATALOG = {
    "A": {"params_path": "/nonexistent/A.npz", "bytes": 100,
          "tenants": ("acme",)},
    "B": {"params_path": "/nonexistent/B.npz", "bytes": 100,
          "tenants": ("bravo",)},
}


def make_model_router(**kw):
    kw.setdefault("models", CATALOG)
    kw.setdefault("page_timeout_ms", 5000.0)
    return make_router(**kw)


# -- parity with the reference's catalog and residency set -----------------

_IDS = ("A", "B", "C", "D")
_TENANTS = ("acme", "bravo", "corp", "dyn")


def _both(fn):
    """(outcome, outcome) of ``fn(mod)`` over the port's and the
    reference's module: ("ok", value) or ("raise", type name, text)."""
    out = []
    for mod in (mp, ref_mp):
        try:
            out.append(("ok", fn(mod)))
        except Exception as exc:  # noqa: BLE001 — compared below
            out.append(("raise", type(exc).__name__, str(exc)))
    return out


_rows = st.fixed_dictionaries(
    {"artifact": st.sampled_from(("params_path", "model_dir", None))},
    optional={"tag": st.text("abv0@", min_size=1, max_size=4),
              "bytes": st.integers(0, 10 ** 9),
              "tenants": st.lists(st.sampled_from(_TENANTS), max_size=2)})


@settings(max_examples=60, deadline=None)
@given(st.dictionaries(st.sampled_from(_IDS), _rows, max_size=4))
def test_catalog_from_value_equals_the_reference(table):
    value = {}
    for mid, row in table.items():
        row = dict(row)
        kind = row.pop("artifact")
        if kind is not None:
            row[kind] = "/nonexistent/%s.%s" % (mid, kind)
        value[mid] = row

    def view(mod):
        cat = mod.ModelCatalog.from_value(value)
        return (cat.ids(), len(cat), cat.doc(),
                [cat.for_tenant(t) for t in _TENANTS + (None,)],
                [m in cat for m in _IDS],
                mod.ModelCatalog.from_value(cat) is cat)
    ours, theirs = _both(view)
    assert ours == theirs


_ops = st.lists(st.one_of(
    st.tuples(st.just("update"), st.lists(st.sampled_from(_IDS),
                                          max_size=4),
              st.integers(0, 3)),
    st.tuples(st.just("add"), st.sampled_from(_IDS),
              st.integers(0, 500)),
    st.tuples(st.just("touch"), st.sampled_from(_IDS)),
    st.tuples(st.just("pin"), st.sampled_from(_IDS)),
    st.tuples(st.just("unpin"), st.sampled_from(_IDS)),
    st.tuples(st.just("drop"), st.sampled_from(_IDS)),
    st.tuples(st.just("victims"), st.integers(0, 1200),
              st.lists(st.sampled_from(_IDS), max_size=2))),
    max_size=30)


@settings(max_examples=80, deadline=None)
@given(_ops)
def test_residency_set_equals_the_reference(ops):
    catalog = {"A": {"params_path": "a", "bytes": 300},
               "B": {"params_path": "b", "bytes": 500},
               "C": {"model_dir": "c", "bytes": 200}}

    def run(mod):
        cat = mod.ModelCatalog.from_value(catalog)
        res = mod.ModelResidencySet()
        trace = []
        for t, op in enumerate(ops):
            now = float(t)
            if op[0] == "update":
                res.update(op[1], op[2], cat, now=now)
            elif op[0] == "add":
                res.add(op[1], op[2], now=now)
            elif op[0] == "touch":
                res.touch(op[1], now=now)
            elif op[0] == "victims":
                trace.append(res.lru_victims(op[1], protect=op[2]))
            else:
                getattr(res, op[0])(op[1])
            trace.append((res.doc(), res.nbytes(),
                          [res.resident(m) for m in _IDS],
                          [res.pinned(m) for m in _IDS]))
        return trace
    ours, theirs = _both(run)
    assert ours == theirs


def test_lru_victims_never_pinned_nor_protected():
    res = mp.ModelResidencySet()
    for t, (mid, n) in enumerate((("A", 300), ("B", 300), ("C", 300))):
        res.add(mid, n, now=float(t))
    res.pin("A")
    assert res.lru_victims(300, protect=("C",)) == ["B"]
    res.unpin("A")
    assert res.lru_victims(300, protect=("C",)) == ["A", "B"]


# -- real workers: paging under the byte budget ----------------------------

@pytest.mark.generation
def test_real_workers_page_and_evict_under_the_budget(tmp_path):
    """Two port workers resident for A, a budget of 1.5 models: the first
    B request pages B onto one member and evicts A there; mixed traffic
    then routes by residency (no second page-in) and every stream equals
    its model's reference scheduler's."""
    paths = {}
    for mid, seed in (("A", 7), ("B", 11)):
        paths[mid] = str(tmp_path / ("%s.npz" % mid))
        np.savez(paths[mid], **fw.model_params(fw.build_scope(seed)))
        mp.write_weights_manifest(paths[mid])
    nbytes = os.path.getsize(paths["A"])
    prompts = child.chaos_prompts(6, seed=3)
    want = {}
    for mid, seed in (("A", 7), ("B", 11)):
        ref = child.make_scheduler(child.build_scope(seed))
        want[mid] = [[int(t) for t in ref.submit(
            p, max_new_tokens=6, eos_id=-1).result(timeout=120)]
            for p in prompts]
        ref.close()
    scheds = [fw.make_scheduler(fw.build_scope(7)) for _ in range(2)]
    router = FleetRouter(
        heartbeat_timeout_ms=0, replay_attempts=2,
        models={m: {"params_path": paths[m], "tag": "%s@v0" % m,
                    "bytes": nbytes, "tenants": (t,)}
                for m, t in (("A", "acme"), ("B", "bravo"))},
        resident_bytes=int(nbytes * 1.5), page_timeout_ms=60000.0)
    workers = [EngineWorker(s, member_id="m%d" % i,
                            router_addr=router.addr, heartbeat_ms=100,
                            version="A@v0", model="A")
               for i, s in enumerate(scheds)]
    page0 = counter("paddle_fleet_model_page_ins_total")
    evict0 = counter("paddle_fleet_model_evictions_total")
    try:
        out = router.submit(prompts[0], max_new_tokens=6, eos_id=-1,
                            tenant="bravo", meta=True).result(timeout=120)
        assert out["tokens"].tolist() == want["B"][0]
        assert out["version"] == "B@v0"
        assert counter("paddle_fleet_model_page_ins_total") == page0 + 1
        assert counter("paddle_fleet_model_evictions_total") == evict0 + 1
        doc = router.fleet_doc()["members"]
        held = sorted(tuple(d["residency"]["models"]) for d in doc.values())
        assert held == [("A",), ("B",)]
        assert all(d["residency"]["bytes"] <= nbytes * 1.5
                   for d in doc.values())
        futs = [(m, i, router.submit(p, max_new_tokens=6, eos_id=-1,
                                     tenant=t))
                for i, p in enumerate(prompts)
                for m, t in (("A", "acme"), ("B", "bravo"))]
        for m, i, f in futs:
            assert [int(t) for t in f.result(timeout=120)] == want[m][i]
        assert counter("paddle_fleet_model_page_ins_total") == page0 + 1
    finally:
        for w in workers:
            w.close()
        router.close()
        for s in scheds:
            s.close()


# -- the reference's CPU classes, against the port --------------------------

class TestCatalogUnits:
    def test_spec_and_catalog_shapes(self, tmp_path):
        cat = mp.ModelCatalog.from_value(CATALOG)
        assert cat.ids() == ["A", "B"]
        assert "A" in cat and "C" not in cat
        assert cat.get("A").tag == "A@v0"
        assert cat.get("A").nbytes() == 100
        assert cat.for_tenant("acme") == "A"
        assert cat.for_tenant("bravo") == "B"
        assert cat.for_tenant("nobody") is None
        assert cat.for_tenant(None) is None
        with pytest.raises(KeyError):
            cat.get("C")
        # a ready catalog passes through from_value untouched
        assert mp.ModelCatalog.from_value(cat) is cat
        # on-disk size when bytes not given
        p = tmp_path / "w.npz"
        np.savez(str(p), w=np.zeros(16, np.float32))
        spec = mp.ModelSpec("D", params_path=str(p))
        assert spec.nbytes() == os.path.getsize(str(p))

    def test_catalog_rejects_duplicates(self):
        with pytest.raises(ValueError):
            mp.ModelCatalog([
                mp.ModelSpec("A", params_path="x"),
                mp.ModelSpec("A", params_path="y")])
        with pytest.raises(ValueError):
            mp.ModelCatalog([
                mp.ModelSpec("A", params_path="x", tenants=("t",)),
                mp.ModelSpec("B", params_path="y", tenants=("t",))])
        with pytest.raises(ValueError):
            mp.ModelSpec("A")  # no artifact at all

    def test_residency_set_lru_and_pins(self):
        rs = mp.ModelResidencySet()
        rs.update(["A", "B", "C"], 1, now=0.0)
        for mid, nb, t in (("A", 100, 1.0), ("B", 100, 2.0),
                           ("C", 100, 3.0)):
            rs.models[mid].nbytes = nb
            rs.models[mid].last_use = t
        assert rs.nbytes() == 300
        # LRU order: A first (oldest), until the set fits
        assert rs.lru_victims(250) == ["A"]
        assert rs.lru_victims(150) == ["A", "B"]
        assert rs.lru_victims(300) == []
        # pinned models are NEVER victims; protected ones neither
        rs.pin("A")
        assert rs.lru_victims(150) == ["B", "C"]
        assert rs.lru_victims(150, protect=("B",)) == ["C"]
        rs.unpin("A")
        assert rs.pinned("A") == 0
        assert rs.lru_victims(150) == ["A", "B"]
        # update at a new generation keeps retained last_use stamps
        rs.update(["B", "C"], 2, now=9.0)
        assert not rs.resident("A")
        assert rs.models["B"].last_use == 2.0
        assert rs.generation == 2

    def test_manifest_roundtrip_and_tamper(self, tmp_path):
        p = str(tmp_path / "w.npz")
        params = {"fc.w": np.arange(6, dtype=np.float32),
                  "fc.b": np.zeros(3, np.float32)}
        np.savez(p, **params)
        mpath = mp.write_weights_manifest(p)
        assert os.path.exists(mpath)
        man = mp.verify_weights_manifest(p)
        assert sorted(man["vars"]) == ["fc.b", "fc.w"]
        assert man["vars"]["fc.w"]["dtype"] == "float32"
        # unmanifested artifact: None, never an error
        p2 = str(tmp_path / "bare.npz")
        np.savez(p2, **params)
        assert mp.verify_weights_manifest(p2) is None
        # truncation is refused before any weight lands
        with open(p, "r+b") as f:
            f.truncate(os.path.getsize(p) - 8)
        with pytest.raises(ValueError):
            mp.verify_weights_manifest(p)
        # switched artifact (same size, different bytes) too
        np.savez(p2, **{k: v + 1 for k, v in params.items()})
        sz = int(man["bytes"])
        with open(p2, "r+b") as f:
            f.truncate(sz)
        os.replace(p2, p)
        assert os.path.getsize(p) == sz
        with pytest.raises(ValueError):
            mp.verify_weights_manifest(p)


class TestResidencyRouting:
    def test_affinity_places_on_resident_member(self):
        router = make_model_router()
        ma = FakeModelMember("A", shifts={"A": 0, "B": 5})
        mb = FakeModelMember("B", shifts={"A": 0, "B": 5})
        try:
            ma.register(router, "m0")
            mb.register(router, "m1")
            hits0 = counter(
                "paddle_fleet_model_residency_hits_total")
            outb = router.submit([5, 6], max_new_tokens=4, model="B",
                                 meta=True).result(timeout=10)
            # m0 has the lower index — only affinity explains m1
            assert outb["member"] == "m1"
            assert outb["tokens"].tolist() == \
                model_oracle([5, 6], 4, shift=5)
            outa = router.submit([5, 6], max_new_tokens=4,
                                 tenant="acme",
                                 meta=True).result(timeout=10)
            assert outa["member"] == "m0"
            assert outa["tokens"].tolist() == model_oracle([5, 6], 4)
            assert counter(
                "paddle_fleet_model_residency_hits_total") == \
                hits0 + 2
            assert not ma.page_ins and not mb.page_ins
            doc = router.fleet_doc()
            assert doc["models"]["A"]["tenants"] == ["acme"]
            assert doc["members"]["m1"]["residency"]["models"] == \
                ["B"]
        finally:
            router.close()
            ma.close()
            mb.close()

    def test_cold_page_in_on_miss(self):
        router = make_model_router()
        ma = FakeModelMember("A", shifts={"B": 5})
        try:
            ma.register(router, "m0")
            misses0 = counter(
                "paddle_fleet_model_residency_misses_total")
            pages0 = labeled("paddle_fleet_model_page_ins_total",
                             outcome="ok")
            out = router.submit([3], max_new_tokens=4, model="B",
                                meta=True).result(timeout=10)
            assert out["tokens"].tolist() == \
                model_oracle([3], 4, shift=5)
            assert out["version"] == "B@v0"
            assert ma.page_ins == ["B"]
            assert counter(
                "paddle_fleet_model_residency_misses_total") == \
                misses0 + 1
            assert labeled("paddle_fleet_model_page_ins_total",
                           outcome="ok") == pages0 + 1
            # the router's view learned the landing without a beat
            with router._lock:
                m = router._members["m0"]
                assert m.residency.resident("B")
                assert m.active_model == "B"
        finally:
            router.close()
            ma.close()

    def test_page_in_burst_is_one_staged_load(self):
        """A burst of cold requests for one model costs ONE page-in
        (the leader election), not a stampede of staged loads."""
        router = make_model_router()
        ma = FakeModelMember("A", shifts={"B": 5}, page_delay=0.2)
        try:
            ma.register(router, "m0")
            futs = [router.submit([3], max_new_tokens=3, model="B")
                    for _ in range(6)]
            for f in futs:
                assert f.result(timeout=15).tolist() == \
                    model_oracle([3], 3, shift=5)
            assert ma.page_ins == ["B"]
        finally:
            router.close()
            ma.close()

    def test_submit_model_validation(self):
        router = make_model_router()
        try:
            with pytest.raises(ValueError):
                router.submit([3], max_new_tokens=2, model="nope")
        finally:
            router.close()
        plain = make_router()
        try:
            with pytest.raises(ValueError):
                plain.submit([3], max_new_tokens=2, model="A")
        finally:
            plain.close()

    def test_page_in_failure_charges_autoscale_budget(self):
        """A failed/wedged page-in spends the spawn-failure
        budget — paging is capacity provisioning."""
        router = make_model_router(replay_attempts=1)
        ma = FakeModelMember("A", refuse_page=True)

        class StubScaler:
            def __init__(self):
                self.charged = []

            def charge_failure(self, cause):
                self.charged.append(cause)
        scaler = StubScaler()
        router._autoscaler = scaler
        try:
            ma.register(router, "m0")
            fails0 = labeled("paddle_fleet_model_page_ins_total",
                             outcome="fail")
            with pytest.raises(mp.PageInError):
                router.submit([3], max_new_tokens=2,
                              model="B").result(timeout=15)
            assert labeled("paddle_fleet_model_page_ins_total",
                           outcome="fail") == fails0 + 2
            assert scaler.charged == ["page_in", "page_in"]
            assert not ma.page_ins
        finally:
            router._autoscaler = None
            router.close()
            ma.close()

    def test_real_autoscaler_charge_halts_on_budget(self):
        from paddle_tpu_torch.serving.autoscale import FleetAutoscaler
        router = make_router()
        try:
            scaler = FleetAutoscaler(
                router, lambda mid: None, members_max=1,
                spawn_failure_budget=2, member_prefix="pg")
            try:
                scaler.charge_failure("page_in")
                assert not scaler.halted
                scaler.charge_failure("page_in")
                assert scaler.halted
                assert scaler.spawn_failures == 2
            finally:
                scaler.close()
        finally:
            router.close()


class TestEviction:
    def test_lru_eviction_under_byte_budget(self):
        """Paging a third model onto a member over the byte budget
        pages out the LRU resident — never the active model."""
        router = make_model_router(
            models={
                "A": {"params_path": "/nx/A.npz", "bytes": 100,
                      "tenants": ("acme",)},
                "B": {"params_path": "/nx/B.npz", "bytes": 100,
                      "tenants": ("bravo",)},
                "C": {"params_path": "/nx/C.npz", "bytes": 100},
            },
            resident_bytes=250)
        ma = FakeModelMember("A", shifts={"B": 5, "C": 9})
        try:
            ma.register(router, "m0")
            ev0 = counter("paddle_fleet_model_evictions_total")
            # A resident (100) -> page in B (200) -> page in C (300):
            # over the 250 budget, A is the LRU victim (B was used
            # more recently; C is active)
            outb = router.submit([4], max_new_tokens=3, model="B",
                                 meta=True).result(timeout=10)
            assert outb["tokens"].tolist() == \
                model_oracle([4], 3, shift=5)
            outc = router.submit([4], max_new_tokens=3, model="C",
                                 meta=True).result(timeout=10)
            assert outc["tokens"].tolist() == \
                model_oracle([4], 3, shift=9)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and not ma.page_outs:
                time.sleep(0.02)
            assert ma.page_outs == ["A"]
            assert counter("paddle_fleet_model_evictions_total") == \
                ev0 + 1
            with router._lock:
                m = router._members["m0"]
                assert not m.residency.resident("A")
                assert m.residency.nbytes() <= 250
        finally:
            router.close()
            ma.close()

    def test_evict_race_fault_aborts_round(self):
        """The model_evict_race site fires between victim selection
        and the page-out: an armed raise aborts the eviction round —
        the victim stays resident, nothing is paged out."""
        router = make_model_router(
            models={
                "A": {"params_path": "/nx/A.npz", "bytes": 100},
                "B": {"params_path": "/nx/B.npz", "bytes": 100},
            },
            resident_bytes=100)
        ma = FakeModelMember("A", shifts={"B": 5})
        try:
            ma.register(router, "m0")
            faults.arm("model_evict_race", times=1)
            out = router.submit([4], max_new_tokens=3, model="B",
                                meta=True).result(timeout=10)
            assert out["tokens"].tolist() == \
                model_oracle([4], 3, shift=5)
            time.sleep(0.2)
            assert not ma.page_outs
            with router._lock:
                assert router._members["m0"].residency.resident("A")
        finally:
            faults.disarm("model_evict_race")
            router.close()
            ma.close()

    def test_inflight_pin_is_never_a_victim(self):
        """A model with an in-flight request is pinned: eviction
        pressure while it serves can never page it out (the invariant
        assert's happy path)."""
        router = make_model_router(
            models={
                "A": {"params_path": "/nx/A.npz", "bytes": 100},
                "B": {"params_path": "/nx/B.npz", "bytes": 100},
            },
            resident_bytes=100)
        # A's generation is slow: it is mid-flight (pinned) when B's
        # page-in applies eviction pressure
        ma = FakeModelMember("A", shifts={"B": 5}, delay=0.8)
        try:
            ma.register(router, "m0")
            fa = router.submit([4], max_new_tokens=3, model="A",
                               meta=True)
            time.sleep(0.2)  # fa dispatched: A is pinned
            with router._lock:
                assert router._members["m0"].residency.pinned("A") \
                    == 1
            fb = router.submit([4], max_new_tokens=3, model="B",
                               meta=True)
            outa = fa.result(timeout=15)
            outb = fb.result(timeout=15)
            assert outa["tokens"].tolist() == model_oracle([4], 3)
            assert outb["tokens"].tolist() == \
                model_oracle([4], 3, shift=5)
            # A was pinned at pressure time: it must NOT have been
            # paged out under it
            assert "A" not in ma.page_outs
        finally:
            router.close()
            ma.close()


class TestJournalModelFence:
    def test_modelless_journal_never_splices_models(self):
        """A model-less request on a two-model fleet: a journal
        generated under model A resets (reason="model") before
        re-driving on a member whose active model is B."""
        router = make_model_router()
        dying = FakeModelMember("A", die_after=2,
                                shifts={"A": 0, "B": 5})
        peer = FakeModelMember("B", shifts={"A": 0, "B": 5})
        try:
            dying.register(router, "m0")
            peer.register(router, "m1")
            resets0 = labeled("paddle_fleet_journal_resets_total",
                              reason="model")
            out = router.submit([5, 6], max_new_tokens=6,
                                meta=True).result(timeout=10)
            # the full model-B generation, never A-prefix + B-suffix
            assert out["tokens"].tolist() == \
                model_oracle([5, 6], 6, shift=5)
            assert peer.requests[-1] == [5, 6]  # journal discarded
            assert labeled("paddle_fleet_journal_resets_total",
                           reason="model") == resets0 + 1
        finally:
            router.close()
            dying.close()
            peer.close()

    def test_replay_with_re_page_bit_identical(self):
        """THE chaos shape: the only member resident for model B dies
        mid-generation. The survivors don't hold B — the journal
        re-pages B onto a peer BEFORE re-driving, and the final
        output is token-for-token the fault-free generation. Zero
        journal resets: same model, same version, same policy."""
        router = make_model_router()
        dying = FakeModelMember("B", die_after=2, shifts={"B": 5})
        peer = FakeModelMember("A", shifts={"A": 0, "B": 5})
        try:
            dying.register(router, "m0")
            peer.register(router, "m1")
            resets0 = counter("paddle_fleet_journal_resets_total")
            out = router.submit([5, 6], max_new_tokens=6, model="B",
                                meta=True).result(timeout=15)
            want = model_oracle([5, 6], 6, shift=5)
            assert out["tokens"].tolist() == want
            assert out["member"] == "m1" and out["replays"] == 1
            # the peer was paged BEFORE the re-drive, and the re-drive
            # carried the journal (prompt + the 2 streamed tokens)
            assert peer.page_ins == ["B"]
            assert peer.requests[-1] == [5, 6] + want[:2]
            assert counter("paddle_fleet_journal_resets_total") == \
                resets0
            # model A's traffic still lands on the survivor untouched
            outa = router.submit([7], max_new_tokens=3, model="A",
                                 meta=True).result(timeout=10)
            assert outa["tokens"].tolist() == model_oracle([7], 3)
        finally:
            router.close()
            dying.close()
            peer.close()

    def test_eviction_between_placement_and_dispatch_redrives(self):
        """A member that advertised a model but paged it out refuses
        the hop kind="model": not a member failure — the router
        corrects its view, re-pages, and re-drives."""
        router = make_model_router()
        ma = FakeModelMember("A", resident=("B",), shifts={"B": 5})
        try:
            ma.register(router, "m0")
            # the member pages B out behind the router's back
            ma.resident_models.discard("B")
            out = router.submit([5], max_new_tokens=4, model="B",
                                meta=True).result(timeout=10)
            assert out["tokens"].tolist() == \
                model_oracle([5], 4, shift=5)
            # the refusal triggered a real page-in, not a failover
            assert ma.page_ins == ["B"]
            assert out["replays"] == 0
        finally:
            router.close()
            ma.close()


class TestModelScopedDeploy:
    def test_deploy_touches_only_resident_members(self):
        router = make_model_router()
        ma = FakeModelMember("A", shifts={"A": 0, "B": 5})
        mb = FakeModelMember("B", shifts={"A": 0, "B": 5})
        try:
            ma.register(router, "m0")
            mb.register(router, "m1")
            res = router.rolling_deploy(
                params_path="/nx/A2.npz", tag="A@v1", model_id="A",
                canary_requests=0, watch_timeout=0.2)
            assert res["ok"] and not res["rolled_back"], res
            assert res["swapped"] == ["m0"]
            # the victim-isolation proof: m1 never saw the deploy
            assert ma.swaps == [("A", "A@v1")]
            assert not mb.swaps
            # B's traffic rode along untouched
            out = router.submit([5], max_new_tokens=3, model="B",
                                meta=True).result(timeout=10)
            assert out["member"] == "m1"
            assert out["tokens"].tolist() == \
                model_oracle([5], 3, shift=5)
            # committed: future page-ins land the pushed version
            assert router._catalog.get("A").tag == "A@v1"
            assert router._catalog.get("A").params_path == \
                "/nx/A2.npz"
        finally:
            router.close()
            ma.close()
            mb.close()

    def test_deploy_unknown_model_refused(self):
        router = make_model_router()
        ma = FakeModelMember("A")
        try:
            ma.register(router, "m0")
            res = router.rolling_deploy(params_path="/nx/x.npz",
                                        tag="v9", model_id="C")
            assert not res["ok"] and not res["rolled_back"]
            assert "C" in res["reason"]
            assert not ma.swaps
        finally:
            router.close()
            ma.close()


@pytest.mark.generation
class TestRealWorkerPaging:
    """One real EngineWorker (tiny LM): page a second weight set in
    through the manifest gate, serve it, page back — outputs are
    bit-identical to each model's fault-free generation."""

    def test_page_in_activate_and_back(self, tmp_path):
        scope = fw.build_scope(seed=7)
        params_a = fw.model_params(scope, 1.0)
        # model B is a genuinely different weight set (same var
        # names/shapes — paged models share the program's parameter
        # set), not a scaled copy a greedy attractor could hide
        params_b = fw.model_params(fw.build_scope(seed=11))
        path_a = str(tmp_path / "A.npz")
        path_b = str(tmp_path / "B.npz")
        np.savez(path_a, **params_a)
        np.savez(path_b, **params_b)
        mp.write_weights_manifest(path_a)
        mp.write_weights_manifest(path_b)
        sched = fw.make_scheduler(scope)
        router = FleetRouter(
            heartbeat_timeout_ms=900, replay_attempts=2,
            models={"A": {"params_path": path_a, "tag": "A@v0"},
                    "B": {"params_path": path_b, "tag": "B@v0"}},
            page_timeout_ms=60000.0)
        worker = EngineWorker(sched, member_id="m0",
                              router_addr=router.addr,
                              heartbeat_ms=100, version="A@v0",
                              model="A")
        try:
            router.wait_members(1, timeout=10)
            prompt = [fw.BOS, 5, 9]
            base = router.submit(prompt, max_new_tokens=6, eos_id=-1,
                                 meta=True).result(timeout=120)
            assert base["version"] == "A@v0"
            outb = router.submit(prompt, max_new_tokens=6, eos_id=-1,
                                 model="B",
                                 meta=True).result(timeout=120)
            assert outb["version"] == "B@v0"
            assert outb["tokens"].tolist() != base["tokens"].tolist()
            # back to A: activation from the host snapshot restores
            # the exact weights — bit-identical to the first pass
            outa = router.submit(prompt, max_new_tokens=6, eos_id=-1,
                                 model="A",
                                 meta=True).result(timeout=120)
            assert outa["version"] == "A@v0"
            assert outa["tokens"].tolist() == base["tokens"].tolist()
            rep = wire.call_once(worker.addr, {"cmd": "health"})
            assert rep["model"] == "A"
            assert rep["models"] == ["A", "B"]
            # page_out drops the inactive snapshot; the active model
            # refuses
            rep = wire.call_once(worker.addr,
                                 {"cmd": "page_out", "model": "B"})
            assert rep["ok"] and rep["models"] == ["A"]
            rep = wire.call_once(worker.addr,
                                 {"cmd": "page_out", "model": "A"})
            assert not rep["ok"]
        finally:
            worker.close()
            router.close()
            sched.close()

    def test_manifest_gate_refuses_torn_artifact(self, tmp_path):
        scope = fw.build_scope(seed=7)
        params_b = fw.model_params(scope, 1.05)
        path_b = str(tmp_path / "B.npz")
        np.savez(path_b, **params_b)
        mp.write_weights_manifest(path_b)
        with open(path_b, "r+b") as f:
            f.truncate(os.path.getsize(path_b) - 16)
        sched = fw.make_scheduler(scope)
        worker = EngineWorker(sched, member_id="m0", version="A@v0",
                              model="A")
        try:
            rep = wire.call_once(
                worker.addr, {"cmd": "page_in", "model": "B",
                              "tag": "B@v0", "params_path": path_b})
            assert not rep["ok"]
            # nothing landed: still serving A, B not resident
            assert rep["model"] == "A"
            hp = wire.call_once(worker.addr, {"cmd": "health"})
            assert hp["models"] == ["A"]
        finally:
            worker.close()
            sched.close()


class TestFlagsDefaultOff:
    def test_paging_flags_read_only_when_catalog_armed(
            self, monkeypatch):
        calls = []
        orig = port_config.get_flag

        def counting(name):
            calls.append(name)
            return orig(name)
        monkeypatch.setattr(port_config, "get_flag", counting)
        router = make_router()
        try:
            assert router._catalog is None
            assert "fleet_models" in calls
            assert "member_resident_bytes" not in calls
            assert "model_page_timeout_ms" not in calls
        finally:
            router.close()
        calls.clear()
        armed = make_router(models=CATALOG)
        try:
            assert armed._catalog is not None
            assert calls.count("member_resident_bytes") == 1
            assert calls.count("model_page_timeout_ms") == 1
            assert armed.page_timeout == 30.0  # flag default
        finally:
            armed.close()
