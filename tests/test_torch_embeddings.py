"""The port's sharded embedding tables (``paddle_tpu_torch.embeddings``)
against the reference's (``tests/test_embeddings.py``): the merge and the
layout bitwise, the two-hop lookup on 2 and 4 gloo ranks
(``torch_ranks.RankPool``) against the reference's on its host devices,
wide&deep with row-sharded tables against the reference's single device,
the checkpoint reshard, the telemetry and the defaults."""

import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as ptpu
from paddle_tpu import embeddings as rembeddings
from paddle_tpu import layers, parallel
from paddle_tpu.models.wide_deep import wide_deep
from paddle_tpu.ops.sparse_ops import merge_duplicate_rows as rmerge

import torch
from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch import core as tcore
from paddle_tpu_torch import embeddings as tembeddings
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.embeddings import sharded as tsharded
from paddle_tpu_torch.ops.sparse_ops import merge_duplicate_rows

from torch_ranks import RankPool
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

N = 4
V, SLOTS, DDIM = 1000, 4, 8


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N)
    yield p
    p.close()


def _ref_flags(**kw):
    prev = {k: ptpu.config.get_flag(k) for k in kw}
    ptpu.config.set_flags(**kw)
    return prev


# -- merge_duplicate_rows --------------------------------------------------

@pytest.mark.parametrize("rows", [
    [], [7, 7, 7, 7, 7], [2], [5, 1, 5, 1, 9],
    list(np.random.RandomState(0).randint(0, 6, 40))])
def test_merge_matches_the_reference_bitwise(rows):
    vocab = 10
    r = np.asarray(rows, np.int32)
    v = np.random.RandomState(1).randn(len(rows), 3).astype("float32")
    want_r, want_v = jax.jit(lambda a, b: rmerge(a, b, vocab))(
        jnp.asarray(r), jnp.asarray(v))
    got_r, got_v = merge_duplicate_rows(torch.from_numpy(r),
                                        torch.from_numpy(v), vocab)
    assert got_r.dtype == torch.int32 and got_r.shape == (len(rows),)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# -- storage layout --------------------------------------------------------

def test_padded_vocab_multiple():
    for v in (1, 64, 65, 1000):
        assert tembeddings.padded_vocab(v) == rembeddings.padded_vocab(v)
    assert tembeddings.PAD_MULTIPLE == rembeddings.PAD_MULTIPLE


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_major_roundtrip(n):
    t = np.random.RandomState(n).randn(64, 3).astype("float32")
    sm = tembeddings.to_shard_major(t, n)
    np.testing.assert_array_equal(sm, rembeddings.to_shard_major(t, n))
    np.testing.assert_array_equal(tembeddings.to_logical(sm, n), t)
    arr = tembeddings.reshard_array(tembeddings.to_shard_major(t, 4), 4, n)
    np.testing.assert_array_equal(tembeddings.to_logical(arr, n), t)


def test_int8_wire_rows_and_scales_bitwise():
    """The reference's quantize of the row hop as its step compiles it
    (jit: XLA turns ``amax / 127.0`` into ``amax * f32(1/127)``)."""
    rows = np.random.RandomState(3).randn(4, 16, 8).astype("float32")
    rows[0, 3] = 0.0                      # an all-zero (sentinel) row

    @jax.jit
    def quantize(rows):
        amax = jnp.max(jnp.abs(rows), axis=-1, keepdims=True)
        scale = jnp.where(amax > 0.0, amax / 127.0, jnp.ones_like(amax))
        q = jnp.clip(jnp.rint(rows / scale), -127.0, 127.0)
        return q.astype(jnp.int8), scale
    q, scale = quantize(rows)
    got_q, got_s = tsharded.quantize_rows(torch.from_numpy(rows))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(scale))


# -- the lookup on the ranks -----------------------------------------------

class TestDistLookup:
    vocab, dim = 100, 6

    def _case(self, padding_idx=None):
        rs = np.random.RandomState(4)
        logical = rs.randn(rembeddings.padded_vocab(self.vocab),
                           self.dim).astype("float32")
        ids = rs.randint(0, self.vocab, (8, 5)).astype("int64")
        if padding_idx is not None:
            ids[0, :2] = padding_idx
        return logical, ids

    def _reference(self, n, a2a, logical, ids, padding_idx=None,
                   wire=None):
        prev = _ref_flags(embedding_shard_rows=n > 1, embedding_a2a=a2a,
                          embedding_wire_dtype=wire)
        try:
            with ptpu.unique_name.guard():
                main, startup = ptpu.Program(), ptpu.Program()
                with ptpu.program_guard(main, startup):
                    x = layers.data("ids", shape=[5], dtype="int64")
                    out = layers.embedding(x, size=[self.vocab, self.dim],
                                           param_attr="table",
                                           is_distributed=True,
                                           padding_idx=padding_idx)
            exe = ptpu.Executor(strategy=parallel.DataParallel(
                n_devices=n) if n > 1 else None)
            with ptpu.scope_guard(ptpu.Scope()):
                exe.run(startup)
                ptpu.global_scope().set_var(
                    "table", rembeddings.to_shard_major(logical, n))
                return np.asarray(exe.run(main, feed={"ids": ids},
                                          fetch_list=[out])[0])
        finally:
            _ref_flags(**prev)

    def test_single_process_dense_gather(self):
        import torch_ranks
        logical, ids = self._case()
        got = torch_ranks.dist_lookup(None, self.vocab, self.dim, logical,
                                      ids, False, False)
        want = self._reference(1, False, logical, ids)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("axes,n", [({"data": 2, "rep": 2}, 2),
                                        ({"data": N}, N)])
    def test_a2a_matches_the_reference(self, pool, axes, n):
        logical, ids = self._case()
        want = self._reference(n, True, logical, ids)
        np.testing.assert_allclose(
            want, logical[ids.reshape(-1)].reshape(8, 5, self.dim),
            rtol=1e-6, atol=0)
        for got in pool.run("dist_lookup", axes, self.vocab, self.dim,
                            rembeddings.to_shard_major(logical, n), ids,
                            True, True):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)

    def test_gspmd_gather_mode_matches(self, pool):
        logical, ids = self._case()
        want = self._reference(N, False, logical, ids)
        for got in pool.run("dist_lookup", {"data": N}, self.vocab,
                            self.dim, rembeddings.to_shard_major(logical, N),
                            ids, True, False):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)

    def test_padding_idx_zeroed_under_a2a(self, pool):
        logical, ids = self._case(padding_idx=3)
        want = self._reference(N, True, logical, ids, padding_idx=3)
        assert (want[0, :2] == 0).all()
        for got in pool.run("dist_lookup", {"data": N}, self.vocab,
                            self.dim, rembeddings.to_shard_major(logical, N),
                            ids, True, True, 3):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)

    def test_int8_wire_matches_the_reference_bitwise(self, pool):
        logical, ids = self._case()
        want = self._reference(N, True, logical, ids, wire="int8")
        for got in pool.run("dist_lookup", {"data": N}, self.vocab,
                            self.dim, rembeddings.to_shard_major(logical, N),
                            ids, True, True, None, "int8"):
            np.testing.assert_array_equal(got, want)


# -- wide&deep with row-sharded tables -------------------------------------

def _build_wide_deep(dist, opt_factory, seed=7):
    main, startup = ptpu.Program(), ptpu.Program()
    main.random_seed = startup.random_seed = seed
    with ptpu.program_guard(main, startup):
        ids = layers.data("ids", shape=[SLOTS], dtype="int64")
        dense = layers.data("dense", shape=[DDIM])
        label = layers.data("label", shape=[1])
        loss, _, _ = wide_deep(ids, dense, label, V, SLOTS, emb_dim=8,
                               hidden=(16,), is_sparse=not dist,
                               is_distributed=dist)
        opt_factory().minimize(loss, startup_program=startup)
    return main, startup, loss


def _feeds(n, batch=16, seed=0):
    rs = np.random.RandomState(seed)
    return [{"ids": rs.randint(0, V, (batch, SLOTS)).astype("int64"),
             "dense": rs.randn(batch, DDIM).astype("float32"),
             "label": rs.randint(0, 2, (batch, 1)).astype("float32")}
            for _ in range(n)]


def _reference_wide_deep(opt_factory, feeds):
    """The reference's single-device run of the is_sparse program."""
    with ptpu.unique_name.guard():
        main, startup, loss = _build_wide_deep(False, opt_factory)
    exe = ptpu.Executor()
    with ptpu.scope_guard(ptpu.Scope()):
        exe.run(startup)
        init = {k: np.asarray(v).copy()
                for k, v in ptpu.global_scope().items()
                if not k.startswith("@")}
        losses = [float(exe.run(main, feed=f, fetch_list=[loss])[0])
                  for f in feeds]
        tables = {k: np.asarray(ptpu.global_scope().find_var(k)).copy()
                  for k in ("deep_embedding", "wide_embedding")}
    return init, losses, tables


_ARMED = dict(embedding_shard_rows=True, embedding_a2a=True)


def test_loss_parity_sharded_memory_and_sparse_grads(pool):
    """20 steps on 4 ranks: per-step |delta loss| <= 1e-4 against the
    reference's single device, each rank holding a quarter of the table,
    and the backward sparse end to end."""
    feeds = _feeds(20)
    init, ref, ref_tables = _reference_wide_deep(
        lambda: ptpu.optimizer.SGD(0.1), feeds)
    vp = rembeddings.padded_vocab(V)
    for out in pool.run("wide_deep_steps", {"data": N}, True,
                        ("SGD", (0.1,)), init, feeds, V, SLOTS, DDIM,
                        _ARMED):
        deltas = np.abs(np.array(ref) - np.array(out["losses"]))
        assert len(deltas) >= 20 and deltas.max() <= 1e-4, deltas
        np.testing.assert_allclose(out["tables"]["deep_embedding"],
                                   ref_tables["deep_embedding"],
                                   rtol=2e-4, atol=1e-6)
        assert out["local"]["deep_embedding"] == (vp // N, 8)
        # every (Rows, Values) a rank made holds what its shard received:
        # n buckets of its 16 ids, never a table-sized gradient
        assert out["shapes"]
        for rows_shape, vals_shape in out["shapes"]:
            assert rows_shape == (16 * SLOTS,) and vals_shape[0] < vp
        for dense, sparse in out["grads"].values():
            assert not dense and sparse


def test_adam_slots_shard_alongside(pool):
    feeds = _feeds(3)
    init, _, _ = _reference_wide_deep(lambda: ptpu.optimizer.Adam(1e-2),
                                      feeds)
    vp = rembeddings.padded_vocab(V)
    for out in pool.run("wide_deep_steps", {"data": N}, True,
                        ("Adam", (1e-2,)), init, feeds, V, SLOTS, DDIM,
                        _ARMED):
        assert out["slots"] == ["deep_embedding_moment1_acc_0",
                                "deep_embedding_moment2_acc_0"]
        for n in out["slots"]:
            assert out["local"][n] == (vp // N, 8)
        assert out["local"]["deep_embedding_beta1_pow_acc_0"] == (1,)


def test_vocab_shard_rules_on_the_model_axis(pool):
    """The is_sparse regime under dp x tp with vocab_shard_rules: each
    rank holds half of each table (and its moment) and the losses are
    the reference's."""
    feeds = _feeds(3)
    init, ref, _ = _reference_wide_deep(
        lambda: ptpu.optimizer.Adagrad(0.1), feeds)
    for out in pool.run("wide_deep_steps", {"data": 2, "model": 2}, False,
                        ("Adagrad", (0.1,)), init, feeds, V, SLOTS, DDIM,
                        None, False, "vocab"):
        np.testing.assert_allclose(out["losses"], ref, rtol=2e-4,
                                   atol=1e-6)
        assert out["local"]["deep_embedding"] == (V // 2, 8)
        assert out["local"]["deep_embedding_moment_acc_0"] == (V // 2, 8)


def test_dist_program_defaults_stay_dense_and_replicated(pool):
    feeds = _feeds(2)
    init, ref, _ = _reference_wide_deep(lambda: ptpu.optimizer.SGD(0.1),
                                        feeds)
    vp = rembeddings.padded_vocab(V)
    for out in pool.run("wide_deep_steps", {"data": N}, True,
                        ("SGD", (0.1,)), init, feeds, V, SLOTS, DDIM):
        np.testing.assert_allclose(out["losses"], ref, rtol=1e-5,
                                   atol=1e-6)
        assert out["local"]["deep_embedding"] == (vp, 8)


# -- checkpoint reshard ----------------------------------------------------

@pytest.mark.parametrize("axes", [{"data": 2, "rep": 2}, None],
                         ids=["2-shards", "1-process"])
def test_save_4_restore_on_n(pool, tmp_path, axes):
    ckpt = str(tmp_path / "ckpt")
    out = pool.run("checkpoint_reshard", {"data": N}, axes, ckpt,
                   _feeds(3, seed=2), _feeds(1, seed=5)[0], V, SLOTS, DDIM)
    vp = rembeddings.padded_vocab(V)
    for want, got, moved, step, saved, loss, local in out:
        assert step == 3 and saved == N
        assert moved == 6   # both tables and their two Adam moments
        for name, logical in want.items():
            np.testing.assert_array_equal(got[name], logical)  # row-exact
        assert np.isfinite(loss)
        assert local == ((vp // 2, 8) if axes else (vp, 8))


def test_same_shard_count_is_identity():
    vp = tembeddings.padded_vocab(V)
    meta = {"embedding_layout": {"deep_embedding": {
        "num_shards": 1, "vocab": V, "padded": vp, "dim": 8,
        "slot_of": None}}}
    scope = tcore.Scope()
    arr = np.random.RandomState(0).randn(vp, 8).astype("float32")
    scope.set_var("deep_embedding", arr.copy())
    assert tembeddings.reshard_scope(scope, meta, strategy=None) == 0
    np.testing.assert_array_equal(np.asarray(scope.find_var(
        "deep_embedding")), arr)


# -- telemetry -------------------------------------------------------------

def test_counters_move_with_telemetry_armed(pool):
    feeds = _feeds(2, seed=9)
    init, _, _ = _reference_wide_deep(lambda: ptpu.optimizer.SGD(0.1),
                                      feeds)
    outs = pool.run("wide_deep_steps", {"data": N}, True, ("SGD", (0.1,)),
                    init, feeds, V, SLOTS, DDIM, _ARMED, True)
    # two tables x batch*slots ids x 2 steps, each rank its rows
    assert sum(o["counters"][0] for o in outs) == 2 * 16 * SLOTS * 2
    for o in outs:
        assert o["counters"][1] > 0 and o["counters"][2] > 0
        assert 0.0 < o["counters"][3] <= 1.0
    quiet = pool.run("wide_deep_steps", {"data": N}, True,
                     ("SGD", (0.1,)), init, feeds[:1], V, SLOTS, DDIM,
                     _ARMED, False)
    assert all(o["counters"][:3] == (0.0, 0.0, 0.0) for o in quiet)


def test_metric_families_keep_their_names():
    for fam in ("_LOOKUP_ROWS", "_A2A_BYTES", "_UNIQUE_RATIO"):
        from paddle_tpu.embeddings import sharded as rsharded
        ref, got = getattr(rsharded, fam), getattr(tsharded, fam)
        assert (got.name, got.help) == (ref.name, ref.help)


# -- defaults --------------------------------------------------------------

def test_flag_defaults():
    for flag in ("embedding_shard_rows", "embedding_a2a",
                 "embedding_wire_dtype"):
        assert tconfig.get_flag(flag) == ptpu.config.get_flag(flag)
    assert tconfig.get_flag("embedding_shard_rows") is False


def test_plain_program_reads_no_embedding_flags(monkeypatch):
    from paddle_tpu_torch import optimizer as topt
    reads = []
    orig = tconfig.get_flag
    main, startup = tcore.Program(), tcore.Program()
    with tcore.unique_name.guard(), tcore.program_guard(main, startup):
        x = tlayers.data("x", shape=[4])
        loss = tlayers.mean(tlayers.fc(x, 3))
        topt.SGD(0.1).minimize(loss, startup)
    exe = tcore.Executor(device="cpu")
    scope = tcore.Scope()
    exe.run(startup, scope=scope)
    monkeypatch.setattr(tconfig, "get_flag",
                        lambda name: reads.append(name) or orig(name))
    exe.run(main, feed={"x": np.zeros((2, 4), "float32")},
            fetch_list=[loss], scope=scope)
    assert reads and not any(r.startswith("embedding_") for r in reads)


# -- shared tables ---------------------------------------------------------

def _shared_program(build_layers, dist, ptpu_mod, opt_mod):
    main, startup = ptpu_mod.Program(), ptpu_mod.Program()
    main.random_seed = startup.random_seed = 13
    with ptpu_mod.program_guard(main, startup):
        a = build_layers.data("a", shape=[3], dtype="int64")
        b = build_layers.data("b", shape=[2], dtype="int64")
        lbl = build_layers.data("lbl", shape=[1])
        ea = build_layers.embedding(a, size=[V, 8], param_attr="shared",
                                    is_sparse=not dist,
                                    is_distributed=dist)
        eb = build_layers.embedding(b, size=[V, 8], param_attr="shared",
                                    is_sparse=not dist,
                                    is_distributed=dist)
        pooled = build_layers.elementwise_add(
            build_layers.reduce_sum(ea, dim=1),
            build_layers.reduce_sum(eb, dim=1))
        loss = build_layers.mean(build_layers.square_error_cost(
            build_layers.fc(pooled, 1), lbl))
        opt_mod.SGD(0.1).minimize(loss, startup)
    return main, startup, loss


def test_shared_table_grad_is_sparse_and_matches_dense(pool):
    from paddle_tpu_torch import optimizer as topt
    rs = np.random.RandomState(8)
    feeds = [{"a": rs.randint(0, V, (8, 3)).astype("int64"),
              "b": rs.randint(0, V, (8, 2)).astype("int64"),
              "lbl": rs.randn(8, 1).astype("float32")} for _ in range(5)]
    with ptpu.unique_name.guard():
        main, startup, loss = _shared_program(layers, False, ptpu,
                                              ptpu.optimizer)
    exe = ptpu.Executor()
    with ptpu.scope_guard(ptpu.Scope()):
        exe.run(startup)
        init = {k: np.asarray(v).copy()
                for k, v in ptpu.global_scope().items()
                if not k.startswith("@")}
        ref = [float(exe.run(main, feed=f, fetch_list=[loss])[0])
               for f in feeds]
        ref_table = np.asarray(ptpu.global_scope().find_var("shared"))
    # the port's program: per-lookup pairs concatenated, no dense grad
    with tcore.unique_name.guard():
        tmain, _, _ = _shared_program(tlayers, True, tcore, topt)
    block = tmain.global_block()
    assert not block.has_var("shared@GRAD")
    assert block.has_var("shared@GRAD@VALUES@CAT")
    assert sum(op.type == "lookup_table_dist_grad"
               for op in block.ops) == 2
    for losses, table in pool.run("shared_table_steps", {"data": N}, init,
                                  feeds, V):
        np.testing.assert_allclose(losses, ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(table, ref_table, rtol=1e-4, atol=1e-6)


def test_non_lookup_consumer_warns_and_falls_back_dense():
    from paddle_tpu_torch import optimizer as topt
    records = []

    class _Capture(logging.Handler):
        def emit(self, record):
            records.append(record)
    lg = logging.getLogger("paddle_tpu_torch")
    cap = _Capture()
    lg.addHandler(cap)
    try:
        with tcore.unique_name.guard():
            main, startup = tcore.Program(), tcore.Program()
            with tcore.program_guard(main, startup):
                ids = tlayers.data("ids", shape=[2], dtype="int64")
                lbl = tlayers.data("lbl", shape=[1])
                e = tlayers.embedding(ids, size=[100, 4],
                                      param_attr="tied",
                                      is_distributed=True)
                w = main.global_block().var("tied")
                proj = tlayers.matmul(tlayers.reduce_sum(e, dim=1), w,
                                      transpose_y=True)
                loss = tlayers.mean(tlayers.square_error_cost(
                    tlayers.reduce_sum(proj, dim=1, keep_dim=True), lbl))
                topt.SGD(0.1).minimize(loss, startup)
    finally:
        lg.removeHandler(cap)
    assert any("DENSE" in r.getMessage() for r in records)
    exe = tcore.Executor(device="cpu")
    scope = tcore.Scope()
    exe.run(startup, scope=scope)
    out = exe.run(main, feed={"ids": np.array([[1, 2]], "int64"),
                              "lbl": np.zeros((1, 1), "float32")},
                  fetch_list=[loss], scope=scope)
    assert np.isfinite(out[0]).all()
