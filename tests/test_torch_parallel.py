"""The port's distribution (``paddle_tpu_torch.parallel``) against the
reference's SPMD tests (``tests/test_parallel.py``): the reference runs in
this process on the 8 host devices, the port on 4 gloo ranks
(``torch_ranks.RankPool``, one pool for the module), every rank fed the
global batch and fetching the global value."""

import numpy as np
import pytest

import jax

import paddle_tpu as ptpu
from paddle_tpu import layers
from paddle_tpu import parallel as rparallel

import torch
from paddle_tpu_torch import core as tcore
from paddle_tpu_torch import parallel as tparallel

from torch_ranks import RankPool
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

N = 4


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N)
    yield p
    p.close()


def _state():
    return {k: np.asarray(v).copy() for k, v in ptpu.global_scope().items()
            if not k.startswith("@")}


def _build_mlp():
    main, startup = ptpu.Program(), ptpu.Program()
    with ptpu.program_guard(main, startup):
        x = layers.data("x", shape=[8])
        y = layers.data("y", shape=[1], dtype="int64")
        h = layers.fc(x, 16, act="relu",
                      param_attr=ptpu.ParamAttr(name="w1"))
        logits = layers.fc(h, 4, param_attr=ptpu.ParamAttr(name="w2"))
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
        ptpu.optimizer.SGD(learning_rate=0.1).minimize(
            loss, startup_program=startup)
    return main, startup, loss


def _data(n=64):
    rs = np.random.RandomState(0)
    xv = rs.randn(n, 8).astype("float32")
    yv = (xv[:, 0] > 0).astype("int64").reshape(-1, 1)
    return xv, yv


def _reference_mlp(feeds):
    with ptpu.unique_name.guard():
        main, startup, loss = _build_mlp()
    exe = ptpu.Executor()
    with ptpu.scope_guard(ptpu.Scope()):
        exe.run(startup)
        init = _state()
        losses = [float(exe.run(main, feed=f, fetch_list=[loss])[0])
                  for f in feeds]
        return init, losses, _state()


def test_ranks_join_one_gloo_group(pool):
    assert pool.run("rank_info") == [(r, N, "gloo") for r in range(N)]


def test_data_parallel_matches_single_device(pool):
    xv, yv = _data()
    feeds = [{"x": xv, "y": yv}] * 5
    init, ref, after = _reference_mlp(feeds)
    for losses, state, local in pool.run("mlp_steps", {"data": N}, None,
                                         init, feeds, ("w1",)):
        np.testing.assert_allclose(losses, ref, rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(state["w1"], after["w1"], rtol=2e-3,
                                   atol=2e-5)
        assert local["w1"] == (8, 16)   # replicated


def test_data_parallel_feed_is_sharded(pool):
    xv, _ = _data(16)
    rows = pool.run("shard_feed_rows", {"data": N}, xv)
    # 16 rows / 4 ranks = 4 rows a rank, in rank order
    assert [r.shape for r in rows] == [(4, 8)] * N
    np.testing.assert_array_equal(np.concatenate(rows), xv)


def test_feeds_of_other_leading_dims_are_replicated(pool):
    """Feeds whose leading dims differ are not one batch: neither is
    split, and the global sums come out on every rank."""
    rs = np.random.RandomState(3)
    x = rs.randn(8, 4).astype("float32")
    t = rs.randn(12, 4).astype("float32")
    want = x.sum(0) + t.sum(0)
    for got in pool.run("ragged_feeds", {"data": N}, x, t):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_startup_gives_identical_replicas(pool):
    got = pool.run("startup_replicas", {"data": N})
    for r in got[1:]:
        for k in ("w1", "w2"):
            np.testing.assert_array_equal(r[k], got[0][k])


def test_model_parallel_param_rule(pool):
    xv, yv = _data(32)
    feeds = [{"x": xv, "y": yv}] * 2
    init, ref, _ = _reference_mlp(feeds[:1])
    for losses, state, local in pool.run(
            "mlp_steps", {"data": 2, "model": 2},
            [(r"^w2", (None, "model"))], init, feeds, ("w2",)):
        assert losses[1] < losses[0] * 1.01   # trains under dp+tp
        np.testing.assert_allclose(losses[0], ref[0], rtol=2e-4)
        # each rank holds its column half of w2
        assert local["w2"] == (16, 2) and state["w2"].shape == (16, 4)


class TestTransformerUnderMesh:
    """The LM program under dp x tp: Megatron-style rules shard the qkv,
    out and ffn weights (their Adam moments inherit it) and B2 runs per
    shard, on each rank's rows and its share of the heads."""

    B, T, V, D, H = 8, 16, 64, 32, 4

    def _reference(self, steps=2, dropout=0.0):
        from paddle_tpu.models.transformer import transformer_lm
        with ptpu.scope_guard(ptpu.Scope()), ptpu.unique_name.guard():
            main, startup = ptpu.Program(), ptpu.Program()
            main.random_seed = startup.random_seed = 11
            with ptpu.program_guard(main, startup):
                tok = layers.data("tok", shape=[self.T], dtype="int64")
                lbl = layers.data("lbl", shape=[self.T], dtype="int64")
                loss, _ = transformer_lm(tok, lbl, self.V, d_model=self.D,
                                         num_heads=self.H,
                                         d_ff=self.D * 2, num_layers=2,
                                         dropout_prob=dropout)
                ptpu.optimizer.Adam(1e-3).minimize(
                    loss, startup_program=startup)
            exe = ptpu.Executor()
            exe.run(startup)
            init = _state()
            rng = np.asarray(ptpu.global_scope().find_var("@RNG_STATE@")) \
                if ptpu.global_scope().has_var("@RNG_STATE@") else None
            feed = self._feed()
            losses = [float(exe.run(main, feed=feed,
                                    fetch_list=[loss])[0])
                      for _ in range(steps)]
        return init, rng, losses

    def _feed(self):
        rs = np.random.RandomState(5)
        tok = rs.randint(2, self.V, (self.B, self.T)).astype("int64")
        return {"tok": tok, "lbl": np.roll(tok, -1, axis=1)}

    def test_dp_tp_matches_single_device(self, pool):
        init, _, ref = self._reference()
        for losses, local in pool.run(
                "lm_steps", {"data": 2, "model": 2}, "tp", init,
                self._feed(), (self.T, self.V, self.D, self.H), 2, 0.0,
                None, (".qkv_q.w",)):
            np.testing.assert_allclose(losses, ref, rtol=2e-3, atol=2e-4)
            # the qkv weight is column-sharded over 'model', and its Adam
            # moments INHERIT the sharding (unanchored rules)
            assert local["mha_0.qkv_q.w"] == (self.D, self.D // 2)
            assert local["mha_0.qkv_q.w_moment1_acc_0"] == (self.D,
                                                             self.D // 2)
            assert local["mha_0.qkv_q.w_beta1_pow_acc_0"] == (1,)

    def test_dropout_draws_the_global_mask(self, pool):
        """Each rank takes its rows of the global batch's mask, drawn from
        the op's key: the reference's masks, so its losses."""
        init, rng, ref = self._reference(steps=2, dropout=0.1)
        for losses, _ in pool.run(
                "lm_steps", {"data": N}, None, init, self._feed(),
                (self.T, self.V, self.D, self.H), 2, 0.1, rng, ()):
            np.testing.assert_allclose(losses, ref, rtol=2e-4, atol=2e-5)

    @pytest.mark.parametrize("axes", [{"data": N},
                                      {"data": 2, "model": 2}])
    def test_segment_mask_per_shard(self, pool, axes):
        """multi_head_attention with KeyLength on a sharded batch (and
        the heads split over 'model') == the reference's single device."""
        from paddle_tpu.layers.attention import multi_head_attention
        rs = np.random.RandomState(2)
        feed = {"x": rs.randn(8, 16, 32).astype("float32"),
                "len": np.array([16, 12, 8, 4] * 2, "int64")}
        with ptpu.scope_guard(ptpu.Scope()), ptpu.unique_name.guard():
            main, startup = ptpu.Program(), ptpu.Program()
            main.random_seed = startup.random_seed = 3
            with ptpu.program_guard(main, startup):
                x = layers.data("x", shape=[16, 32])
                ln = layers.data("len", shape=[], dtype="int64")
                out = layers.mean(multi_head_attention(
                    x, x, x, 32, 4, causal=True, key_length=ln))
            exe = ptpu.Executor()
            exe.run(startup)
            init = _state()
            ref = float(exe.run(main, feed=feed, fetch_list=[out])[0])
        for got in pool.run("attention_mean", axes, init, feed):
            np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5)


class TestRingAttention:
    """Ring (sequence-parallel) attention over a 4-rank axis: forward and
    gradients against the reference's dense attention."""

    def _qkv(self, b=2, t=16, h=2, d=8, seed=0):
        rs = np.random.RandomState(seed)
        return [rs.randn(b, t, h, d).astype("float32") * 0.5
                for _ in range(3)]

    def test_forward_and_grads_match_dense(self, pool):
        q, k, v = self._qkv(seed=4)
        for causal in (False, True):
            def loss_dense(q, k, v):
                o = rparallel.dense_attention(q, k, v, causal=causal)
                return (o * o).sum()
            ref = np.asarray(rparallel.dense_attention(q, k, v,
                                                       causal=causal))
            grads = jax.grad(loss_dense, argnums=(0, 1, 2))(q, k, v)
            for o, gq, gk, gv in pool.run("ring", {"data": N}, "data",
                                          q, k, v, causal):
                np.testing.assert_allclose(o, ref, rtol=2e-4, atol=2e-5)
                for a, b in zip((gq, gk, gv), grads):
                    np.testing.assert_allclose(a, np.asarray(b),
                                               rtol=2e-3, atol=2e-4)

    def test_sharded_inputs_stay_sharded(self, pool):
        """Each rank passes its chunk of T and gets its chunk back."""
        q, k, v = self._qkv(t=32, seed=7)
        ref = np.asarray(rparallel.dense_attention(q, k, v, causal=True))
        outs = pool.run("ring", {"data": N}, "data", q, k, v, True, True)
        for r, (o, _, _, _) in enumerate(outs):
            assert o.shape == (2, 8, 2, 8)
            np.testing.assert_allclose(o, ref[:, 8 * r:8 * (r + 1)],
                                       rtol=2e-4, atol=2e-5)

    def test_one_process_ring_is_dense(self):
        q, k, v = (torch.tensor(a) for a in self._qkv())
        mesh = tparallel.make_mesh({"sp": 1})
        out = tparallel.ring_attention(q, k, v, mesh, axis_name="sp",
                                       causal=True)
        ref = rparallel.dense_attention(*(a.numpy() for a in (q, k, v)),
                                        causal=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("fused", [False, True],
                         ids=["batch_norm", "conv2d_bn"])
def test_batch_norm_stats_are_global(pool, fused):
    """Cross-rank batch norm: the running mean of a sharded batch equals
    the single device's; the fused conv2d_bn op all-reduces its sums
    before the finish."""
    rs = np.random.RandomState(1)
    xv = rs.randn(16, 3, 4, 4).astype("float32")
    with ptpu.unique_name.guard():
        main, startup = ptpu.Program(), ptpu.Program()
        with ptpu.program_guard(main, startup):
            x = layers.data("x", shape=[3, 4, 4])
            bn = layers.fused_conv_bn(x, num_filters=4, filter_size=1,
                                      stride=1, padding=0) if fused \
                else layers.batch_norm(x, name="bn0")
            layers.mean(bn)
    exe = ptpu.Executor()
    with ptpu.scope_guard(ptpu.Scope()):
        exe.run(startup)
        init = _state()
        exe.run(main, feed={"x": xv})
        # batch_norm's running mean, or conv2d_bn's (its "global_0")
        ref = next(np.asarray(v) for k, v in ptpu.global_scope().items()
                   if k.endswith((".mean", ".global_0")))
    for got in pool.run("bn_running_mean", {"data": N}, init, xv, fused):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


def test_metric_is_global(pool):
    """accuracy over a sharded batch is the global batch's."""
    xv, yv = _data()
    with ptpu.unique_name.guard():
        main, startup = ptpu.Program(), ptpu.Program()
        with ptpu.program_guard(main, startup):
            x = layers.data("x", shape=[8])
            y = layers.data("y", shape=[1], dtype="int64")
            h = layers.fc(x, 16, act="relu",
                          param_attr=ptpu.ParamAttr(name="w1"))
            logits = layers.fc(h, 4, param_attr=ptpu.ParamAttr(name="w2"))
            acc = layers.accuracy(layers.softmax(logits), y)
    exe = ptpu.Executor()
    with ptpu.scope_guard(ptpu.Scope()):
        exe.run(startup)
        init = _state()
        ref = float(exe.run(main, feed={"x": xv, "y": yv},
                            fetch_list=[acc])[0])
    assert pool.run("mlp_accuracy", {"data": N}, init,
                    {"x": xv, "y": yv}) == [ref] * N


def test_staged_batches_carry_this_ranks_rows(pool):
    """StagedReader(strategy=) packs 4 rows a batch and each rank copies
    its own; the steps equal the reference's single device."""
    xv, yv = _data()
    feeds = [{"x": xv, "y": yv}] * 3
    init, ref, _ = _reference_mlp(feeds)
    for r, (losses, starts) in enumerate(pool.run(
            "staged_mlp", {"data": N}, init, feeds)):
        np.testing.assert_allclose(losses, ref, rtol=2e-4, atol=1e-6)
        assert all(s == r and shape[0] == 1 for s, shape in starts)


def test_trainer_under_a_strategy(pool):
    xv, yv = _data()
    feeds = [{"x": xv, "y": yv}] * 3
    init, ref, _ = _reference_mlp(feeds)
    for losses, _ in pool.run("staged_mlp", {"data": N}, init, feeds,
                              True):
        np.testing.assert_allclose(losses, ref, rtol=2e-4, atol=1e-6)


def test_resize_strategy_keeps_the_model_axis(pool):
    for shape, fresh, rules, daxis in pool.run(
            "resize", {"data": 2, "model": 2}, [0, 1, 2, 3]):
        assert shape == {"data": 2, "model": 2} and fresh
        assert rules == ["^w"] and daxis == "data"
    for shape, _, _, _ in pool.run("resize", {"data": N}, [0, 1]):
        assert shape == {"data": 2}


def test_one_process_strategy_is_not_captured():
    """A step under a strategy is refused capture, with the reason; one
    process needs no process group."""
    main, startup = tcore.Program(), tcore.Program()
    from paddle_tpu_torch import layers as tlayers
    with tcore.unique_name.guard(), tcore.program_guard(main, startup):
        x = tlayers.data("x", shape=[4])
        out = tlayers.mean(tlayers.fc(x, 3))
    st = tparallel.DataParallel(n_devices=1)
    assert tparallel.current_strategy() is None
    exe = tcore.Executor(device="cpu", strategy=st)
    scope = tcore.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed={"x": np.ones((2, 4), "float32")}, fetch_list=[out],
            scope=scope)
    stats = exe.capture_stats()
    assert stats["refused"] == 2
    assert all("distribution strategy" in r
               for r in stats["refused_reasons"].values())
    assert repr(tparallel.P("data", None)) == "P('data', None)"
    with pytest.raises(ValueError, match="mesh wants 2 devices"):
        tparallel.make_mesh({"data": 2})
