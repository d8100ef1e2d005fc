"""The port's sparse (SelectedRows) embedding gradients and row-wise
updates against the reference's (``tests/test_sparse_embedding.py``):
sgd, adagrad, adam and momentum on an ``is_sparse`` table, from the same
table, ids and labels, never a dense table gradient, and the padding
rows dropped."""

import numpy as np
import pytest

import paddle_tpu as ptpu
from paddle_tpu import layers

import torch
from paddle_tpu_torch import core as tcore
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import optimizer as topt

VOCAB, DIM = 50, 6


def _model(pkg_layers, core, opt, is_sparse, vocab=VOCAB, dim=DIM,
           padding_idx=None, width=4):
    main, startup = core.Program(), core.Program()
    with core.program_guard(main, startup):
        ids = pkg_layers.data("ids", shape=[width], dtype="int64")
        label = pkg_layers.data("label", shape=[dim])
        emb = pkg_layers.embedding(ids, size=[vocab, dim],
                                   param_attr="table", is_sparse=is_sparse,
                                   padding_idx=padding_idx)
        pooled = pkg_layers.reduce_sum(emb, dim=1)
        loss = pkg_layers.mean(pkg_layers.square_error_cost(pooled, label))
        opt().minimize(loss, startup)
    return main, startup, loss


def _data(steps):
    rs = np.random.RandomState(3)
    table0 = (rs.randn(VOCAB, DIM) * 0.1).astype("float32")
    ids = rs.randint(0, VOCAB, (steps, 8, 4)).astype("int64")
    ids[0, 0] = ids[0, 1]          # guaranteed duplicates
    labels = rs.randn(steps, 8, DIM).astype("float32")
    return table0, ids, labels


def _reference(opt, table0, ids, labels):
    with ptpu.unique_name.guard():
        main, startup, loss = _model(layers, ptpu, opt, True)
    exe = ptpu.Executor()
    with ptpu.scope_guard(ptpu.Scope()):
        exe.run(startup)
        ptpu.global_scope().set_var("table", table0)
        losses = [float(exe.run(main, feed={"ids": i, "label": lb},
                                fetch_list=[loss])[0])
                  for i, lb in zip(ids, labels)]
        return losses, np.asarray(ptpu.global_scope().find_var("table"))


def _port(opt, table0, ids, labels):
    with tcore.unique_name.guard():
        main, startup, loss = _model(tlayers, tcore, opt, True)
    exe = tcore.Executor(device="cpu")
    scope = tcore.Scope()
    exe.run(startup, scope=scope)
    scope.set_var("table", torch.from_numpy(table0.copy()))
    losses = [float(exe.run(main, feed={"ids": i, "label": lb},
                            fetch_list=[loss], scope=scope)[0])
              for i, lb in zip(ids, labels)]
    return losses, scope.find_var("table").numpy(), main


@pytest.mark.parametrize("name,steps,ref_opt,port_opt", [
    ("sgd", 3, lambda: ptpu.optimizer.SGD(learning_rate=0.1),
     lambda: topt.SGD(learning_rate=0.1)),
    ("adagrad", 3, lambda: ptpu.optimizer.Adagrad(learning_rate=0.1),
     lambda: topt.Adagrad(learning_rate=0.1)),
    ("adam", 3, lambda: ptpu.optimizer.Adam(learning_rate=0.05),
     lambda: topt.Adam(learning_rate=0.05)),
    ("momentum", 3,
     lambda: ptpu.optimizer.Momentum(learning_rate=0.1, momentum=0.9),
     lambda: topt.Momentum(learning_rate=0.1, momentum=0.9)),
])
def test_sparse_update_matches_the_reference(name, steps, ref_opt,
                                             port_opt):
    table0, ids, labels = _data(steps)
    ref_losses, ref_table = _reference(ref_opt, table0, ids, labels)
    losses, table, main = _port(port_opt, table0, ids, labels)
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(table, ref_table, rtol=2e-4, atol=1e-6)
    # the update op read the sparse pair, never a dense gradient
    upd = [op for op in main.global_block().ops if op.type == name]
    assert upd and "Rows" in upd[0].inputs


def test_sparse_grad_never_dense():
    with tcore.unique_name.guard():
        main, _, _ = _model(tlayers, tcore, lambda: topt.SGD(0.1), True,
                            vocab=1000, dim=8)
    types = [op.type for op in main.global_block().ops]
    assert "lookup_table_sparse_grad" in types
    assert not main.global_block().has_var("table@GRAD")
    assert main.global_block().has_var("table@GRAD@VALUES")


def test_padding_idx_rows_dropped():
    """padding_idx rows receive no update (their forward output is 0)."""
    vocab, dim = 10, 4
    table0 = np.ones((vocab, dim), dtype="float32")
    with tcore.unique_name.guard():
        main, startup, _ = _model(tlayers, tcore, lambda: topt.SGD(0.5),
                                  True, vocab=vocab, dim=dim,
                                  padding_idx=0, width=3)
    exe = tcore.Executor(device="cpu")
    scope = tcore.Scope()
    exe.run(startup, scope=scope)
    scope.set_var("table", torch.from_numpy(table0.copy()))
    exe.run(main, feed={"ids": np.array([[0, 2, 3]], "int64"),
                        "label": np.zeros((1, dim), "float32")},
            scope=scope)
    table = scope.find_var("table").numpy()
    np.testing.assert_array_equal(table[0], table0[0])   # pad frozen
    assert not np.allclose(table[2], table0[2])           # real row moved


def test_an_update_rule_without_a_sparse_form_refuses():
    with tcore.unique_name.guard(), pytest.raises(
            NotImplementedError, match="no sparse"):
        _model(tlayers, tcore, lambda: topt.Adamax(0.01), True)
