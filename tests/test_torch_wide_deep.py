"""The port's wide&deep (``paddle_tpu_torch.models.wide_deep``, BASELINE
config 5) against the reference's, in both table regimes: ``is_sparse``
tables with (rows, values) gradients, and ``is_distributed`` tables on one
process (the identity layout's gather). Same program, same weights (the
reference's startup crossed through ``io.scope_from_jax``), same batches."""

import numpy as np
import pytest

import paddle_tpu as ptpu
from paddle_tpu import layers
from paddle_tpu.models import wide_deep as rwide_deep

from paddle_tpu_torch import core as tcore
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import wide_deep as twide_deep

V, SLOTS, DDIM, STEPS = 500, 6, 8, 3


def _build(pkg_layers, core, model, opt, dist):
    main, startup = core.Program(), core.Program()
    main.random_seed = startup.random_seed = 7
    with core.program_guard(main, startup):
        ids = pkg_layers.data("ids", shape=[SLOTS], dtype="int64")
        dense = pkg_layers.data("dense", shape=[DDIM])
        label = pkg_layers.data("label", shape=[1])
        loss, pred, _ = model.wide_deep(ids, dense, label, V, SLOTS,
                                        emb_dim=8, hidden=(16, 8),
                                        is_sparse=not dist,
                                        is_distributed=dist)
        opt().minimize(loss, startup)
    return main, startup, loss, pred


def _feeds():
    rs = np.random.RandomState(7)
    return [{"ids": rs.randint(0, V, (32, SLOTS)).astype("int64"),
             "dense": rs.randn(32, DDIM).astype("float32"),
             "label": rs.randint(0, 2, (32, 1)).astype("float32")}
            for _ in range(STEPS)]


@pytest.mark.parametrize("dist", [False, True],
                         ids=["is_sparse", "is_distributed"])
@pytest.mark.parametrize("opt", ["Adagrad", "SGD"])
def test_wide_deep_trains_as_the_reference(dist, opt):
    args = (0.05,)
    with ptpu.unique_name.guard():
        main, startup, loss, pred = _build(
            layers, ptpu, rwide_deep,
            lambda: getattr(ptpu.optimizer, opt)(*args), dist)
    exe = ptpu.Executor()
    with ptpu.scope_guard(ptpu.Scope()):
        exe.run(startup)
        init = {k: np.asarray(v).copy()
                for k, v in ptpu.global_scope().items()}
        ref = [exe.run(main, feed=f, fetch_list=[loss, pred])
               for f in _feeds()]
        ref_tables = {k: np.asarray(ptpu.global_scope().find_var(k))
                      for k in ("deep_embedding", "wide_embedding")}

    with tcore.unique_name.guard():
        tmain, tstartup, tloss, tpred = _build(
            tlayers, tcore, twide_deep,
            lambda: getattr(topt, opt)(*args), dist)
    # the same program, op for op
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in main.global_block().ops]
    exe_t = tcore.Executor(device="cpu")
    scope = tio.scope_from_jax(init, device="cpu")
    got = [exe_t.run(tmain, feed=f, fetch_list=[tloss, tpred], scope=scope)
           for f in _feeds()]
    for (rl, rp), (gl, gp) in zip(ref, got):
        np.testing.assert_allclose(gl, rl, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gp, rp, rtol=1e-5, atol=1e-6)
    for k, want in ref_tables.items():
        np.testing.assert_allclose(scope.find_var(k).numpy(), want,
                                   rtol=1e-5, atol=1e-6)


def test_vocab_shard_rules_are_the_references():
    ref = rwide_deep.vocab_shard_rules("model")
    got = twide_deep.vocab_shard_rules("model")
    assert [(p, tuple(s)) for p, s in got] == \
        [(p, tuple(s)) for p, s in ref]
