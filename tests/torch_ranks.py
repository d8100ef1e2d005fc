"""A pool of gloo ranks for the port's multi-rank parity tests, and the
port-side bodies those tests run on it.

Each rank is a fresh ``python`` process that imports torch and
``paddle_tpu_torch`` only (never jax or ``paddle_tpu``), joins one gloo
process group through ``distributed.init_multihost(..., device="cpu")``
and then runs bodies (module-level functions of this file) as the test
process sends them, one at a time, every rank the same body. A test
module starts one pool (a module-scoped fixture) and sends it one body a
test, so the ranks' start-up (~4 s) is paid once a module.

The reference side of each comparison runs in the test process; weights
and feeds cross as numpy arrays.
"""

import os
import socket
import subprocess
import sys
import traceback
from multiprocessing.connection import Client, Listener

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class RankPool:
    """``n`` gloo ranks. ``run(body, *args)`` runs ``body`` (a function
    of this module, by name) on every rank and returns the ranks'
    results in rank order; a rank's exception is raised here with its
    traceback."""

    def __init__(self, n, timeout=180.0):
        self.n = n
        self.timeout = timeout
        self._listener = Listener(("localhost", 0), authkey=b"ranks")
        port = _free_port()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT, _HERE] + ([env["PYTHONPATH"]]
                              if env.get("PYTHONPATH") else []))
        env["OMP_NUM_THREADS"] = "1"
        addr = "%s:%d" % self._listener.address
        self._procs = [subprocess.Popen(
            [sys.executable, "-c",
             "import torch_ranks; torch_ranks._serve(%r, %d, %d, %d)"
             % (addr, r, n, port)], env=env, cwd=_ROOT)
            for r in range(n)]
        self._conns = [None] * n
        for _ in range(n):
            c = self._listener.accept()
            self._conns[c.recv()] = c

    def run(self, body, *args, **kwargs):
        for c in self._conns:
            c.send((body, args, kwargs))
        out, errors = [], []
        for r, c in enumerate(self._conns):
            if not c.poll(self.timeout):
                self.close()
                raise TimeoutError("rank %d did not finish %s in %.0f s"
                                   % (r, body, self.timeout))
            ok, value = c.recv()
            (out if ok else errors).append(value)
        if errors:
            raise RuntimeError("%s failed on a rank:\n%s"
                               % (body, errors[0]))
        return out

    def close(self):
        for c in self._conns:
            try:
                c.send(None)
            except Exception:
                pass
        for p in self._procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self._listener.close()


def _serve(addr, rank, n, port):
    import torch
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import init_multihost
    host, p = addr.rsplit(":", 1)
    conn = Client((host, int(p)), authkey=b"ranks")
    conn.send(rank)
    init_multihost("localhost:%d" % port, n, rank, device="cpu",
                   initialization_timeout_sec=60)
    while True:
        item = conn.recv()
        if item is None:
            break
        body, args, kwargs = item
        try:
            conn.send((True, globals()[body](*args, **kwargs)))
        except BaseException:
            conn.send((False, "rank %d: %s" % (rank,
                                               traceback.format_exc())))


# -- helpers of the bodies --------------------------------------------------

def _fresh():
    from paddle_tpu_torch import core
    return core.Scope(), core.unique_name.guard()


def _load(scope, weights):
    import torch
    for k, v in (weights or {}).items():
        scope.set_var(k, torch.from_numpy(np.array(v)))


def _global(exe, scope, name, program):
    """A state's global value (gathered over its sharded dims)."""
    return np.asarray(exe.global_state(scope, [name], program)[name]).copy()


def _strategy(axes, rules=None):
    from paddle_tpu_torch import parallel
    mesh = parallel.make_mesh(axes)
    rules = [(p, parallel.P(*s)) for p, s in (rules or [])]
    return parallel.DistStrategy(mesh, data_axis="data", param_rules=rules)


# -- bodies: test_torch_parallel.py ----------------------------------------

def rank_info():
    import torch.distributed as dist
    return dist.get_rank(), dist.get_world_size(), dist.get_backend()


def build_mlp():
    from paddle_tpu_torch import core, layers, optimizer
    from paddle_tpu_torch.param_attr import ParamAttr
    main, startup = core.Program(), core.Program()
    with core.program_guard(main, startup):
        x = layers.data("x", shape=[8])
        y = layers.data("y", shape=[1], dtype="int64")
        h = layers.fc(x, 16, act="relu", param_attr=ParamAttr(name="w1"))
        logits = layers.fc(h, 4, param_attr=ParamAttr(name="w2"))
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
        optimizer.SGD(learning_rate=0.1).minimize(loss, startup)
    return main, startup, loss


def mlp_steps(axes, rules, weights, feeds, fetch_state=()):
    """Steps of the MLP under a strategy on ``axes``; returns the losses,
    the global values of ``fetch_state`` and their local shapes."""
    from paddle_tpu_torch import core
    scope, guard = _fresh()
    with guard:
        main, startup, loss = build_mlp()
    exe = core.Executor(device="cpu", strategy=_strategy(axes, rules))
    exe.run(startup, scope=scope)
    _load(scope, weights)
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in feeds]
    return (losses, {n: _global(exe, scope, n, main) for n in fetch_state},
            {n: tuple(scope.find_var(n).shape) for n in fetch_state})


def startup_replicas(axes):
    """The startup's weights on this rank (no weights loaded)."""
    from paddle_tpu_torch import core
    scope, guard = _fresh()
    with guard:
        main, startup, loss = build_mlp()
    exe = core.Executor(device="cpu", strategy=_strategy(axes))
    exe.run(startup, scope=scope)
    return {n: np.asarray(scope.find_var(n)).copy()
            for n in ("w1", "w2")}


def shard_feed_rows(axes, x):
    st = _strategy(axes)
    return st.shard_feed("x", x).numpy().copy()


def lm_steps(axes, rules, weights, feed, dims, steps=2, dropout=0.0,
             rng=None, fetch_state=()):
    """Adam steps of the transformer LM program under a strategy."""
    import torch
    from paddle_tpu_torch import core, layers, optimizer
    from paddle_tpu_torch.models.transformer import (transformer_lm,
                                                     transformer_tp_rules)
    t, v, d, h = dims
    scope, guard = _fresh()
    with guard:
        main, startup = core.Program(), core.Program()
        main.random_seed = startup.random_seed = 11
        with core.program_guard(main, startup):
            tok = layers.data("tok", shape=[t], dtype="int64")
            lbl = layers.data("lbl", shape=[t], dtype="int64")
            loss, _ = transformer_lm(tok, lbl, v, d_model=d, num_heads=h,
                                     d_ff=d * 2, num_layers=2,
                                     dropout_prob=dropout)
            optimizer.Adam(1e-3).minimize(loss, startup)
    if rules == "tp":
        rules = [(p, tuple(s)) for p, s in transformer_tp_rules("model")]
    exe = core.Executor(device="cpu", strategy=_strategy(axes, rules))
    exe.run(startup, scope=scope)
    _load(scope, weights)
    if rng is not None:
        scope.set_var("@RNG_STATE@", torch.from_numpy(
            np.asarray(rng).astype(np.int64)))
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    names = sorted(n for n in scope.var_names() if any(
        n.endswith(s) or s in n for s in fetch_state))
    return losses, {n: tuple(scope.find_var(n).shape) for n in names}


def attention_mean(axes, weights, feed):
    """mean(multi_head_attention(x, x, x, key_length=len)) under a
    strategy (the reference's segment-mask-under-mesh program)."""
    from paddle_tpu_torch import core, layers
    from paddle_tpu_torch.layers.attention import multi_head_attention
    scope, guard = _fresh()
    with guard:
        main, startup = core.Program(), core.Program()
        main.random_seed = startup.random_seed = 3
        with core.program_guard(main, startup):
            x = layers.data("x", shape=[16, 32])
            ln = layers.data("len", shape=[], dtype="int64")
            out = layers.mean(multi_head_attention(
                x, x, x, 32, 4, causal=True, key_length=ln))
    exe = core.Executor(device="cpu", strategy=_strategy(axes)
                        if axes else None)
    exe.run(startup, scope=scope)
    _load(scope, weights)
    return float(exe.run(main, feed=feed, fetch_list=[out],
                         scope=scope)[0])


def ring(axes, axis, q, k, v, causal, local=False):
    """ring_attention forward and the gradients of sum(o * o)."""
    import torch
    from paddle_tpu_torch import parallel
    mesh = parallel.make_mesh(axes)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    if local:
        n, c = mesh.size(axis), mesh.coord(axis)
        tc = q.shape[1] // n
        sl = slice(c * tc, (c + 1) * tc)
        qt, kt, vt = (torch.tensor(a[:, sl], requires_grad=True)
                      for a in (q, k, v))
    o = parallel.ring_attention(qt, kt, vt, mesh, axis_name=axis,
                                causal=causal, local=local)
    (o * o).sum().backward()
    return tuple(t.detach().numpy().copy()
                 for t in (o, qt.grad, kt.grad, vt.grad))


def bn_running_mean(axes, weights, x, fused=False):
    """The running mean after one step of batch_norm (or, ``fused``, of
    one conv2d_bn op: a 1x1 convolution and its statistics)."""
    from paddle_tpu_torch import core, layers
    scope, guard = _fresh()
    with guard:
        main, startup = core.Program(), core.Program()
        with core.program_guard(main, startup):
            xv = layers.data("x", shape=[3, 4, 4])
            bn = layers.fused_conv_bn(xv, num_filters=4, filter_size=1,
                                      stride=1, padding=0) if fused \
                else layers.batch_norm(xv, name="bn0")
            layers.mean(bn)
    exe = core.Executor(device="cpu", strategy=_strategy(axes))
    exe.run(startup, scope=scope)
    _load(scope, weights)
    exe.run(main, feed={"x": x}, scope=scope)
    name = next(n for n in scope.var_names()
                if n.endswith((".mean", ".global_0")))
    return np.asarray(scope.find_var(name)).copy()


# -- bodies: test_torch_embeddings.py --------------------------------------

def _flags(**kw):
    from paddle_tpu_torch import config
    prev = {k: config.get_flag(k) for k in kw}
    config.set_flags(**kw)
    return prev


def dist_lookup(axes, vocab, dim, table, ids, shard_rows, a2a,
                padding_idx=None, wire=None):
    """The global output of an is_distributed lookup of ``ids`` on the
    shard-major ``table``."""
    import torch
    from paddle_tpu_torch import core, layers
    prev = _flags(embedding_shard_rows=shard_rows, embedding_a2a=a2a,
                  embedding_wire_dtype=wire)
    try:
        scope, guard = _fresh()
        with guard:
            main, startup = core.Program(), core.Program()
            with core.program_guard(main, startup):
                x = layers.data("ids", shape=[ids.shape[1]], dtype="int64")
                out = layers.embedding(x, size=[vocab, dim],
                                       param_attr="table",
                                       is_distributed=True,
                                       padding_idx=padding_idx)
        exe = core.Executor(device="cpu", strategy=_strategy(axes)
                            if axes else None)
        exe.run(startup, scope=scope)
        scope.set_var("table", torch.from_numpy(table.copy()))
        return exe.run(main, feed={"ids": ids}, fetch_list=[out],
                       scope=scope)[0]
    finally:
        _flags(**prev)


def build_wide_deep(dist, opt, vocab, slots, ddim, seed=7):
    from paddle_tpu_torch import core, layers, optimizer
    from paddle_tpu_torch.models.wide_deep import wide_deep
    kind, args = opt
    main, startup = core.Program(), core.Program()
    main.random_seed = startup.random_seed = seed
    with core.program_guard(main, startup):
        ids = layers.data("ids", shape=[slots], dtype="int64")
        dense = layers.data("dense", shape=[ddim])
        label = layers.data("label", shape=[1])
        loss, _, _ = wide_deep(ids, dense, label, vocab, slots, emb_dim=8,
                               hidden=(16,), is_sparse=not dist,
                               is_distributed=dist)
        getattr(optimizer, kind)(*args).minimize(loss, startup)
    return main, startup, loss


_TABLES = ("deep_embedding", "wide_embedding")


def _dist_state(scope, init, info, shards):
    """The reference's dense weights into a distributed program's scope:
    the tables padded and laid out shard-major for ``shards``."""
    import torch
    from paddle_tpu_torch import embeddings
    for k, v in init.items():
        if not scope.has_var(k):
            continue
        have = tuple(scope.find_var(k).shape)
        if k in info or (v.ndim and have[0] != v.shape[0]):
            # a table, or a slot of one: padded, laid out shard-major
            padded = np.zeros(have, v.dtype)
            padded[:v.shape[0]] = v
            v = embeddings.to_shard_major(padded, shards)
        scope.set_var(k, torch.from_numpy(np.array(v)))


def wide_deep_steps(axes, dist, opt, init, feeds, vocab, slots, ddim,
                    flags=None, telemetry=False, rules=None):
    """Steps of wide&deep under a strategy on ``axes`` (None: one
    process) from the reference's weights. Returns the losses, the
    tables in logical order, the shapes of every (Rows, Values) the
    distributed gradient op made on this rank, the local shapes of the
    tables and their slots, and the registry's slots."""
    from paddle_tpu_torch import core, embeddings
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.embeddings import sharded
    prev = _flags(**dict(flags or {}, telemetry=telemetry))
    opdef = registry.get_op_def("lookup_table_dist_grad")
    orig, shapes = opdef.compute, []

    def recording(ctx):
        out = orig(ctx)
        shapes.append((tuple(out["Rows"].shape),
                       tuple(out["Values"].shape)))
        return out
    opdef.compute = recording
    counters0 = (sharded._LOOKUP_ROWS.value,
                 sharded._A2A_BYTES.labels(direction="ids").value,
                 sharded._A2A_BYTES.labels(direction="rows").value)
    try:
        scope, guard = _fresh()
        with guard:
            main, startup, loss = build_wide_deep(dist, opt, vocab, slots,
                                                  ddim)
        info = embeddings.dist_tables(main) or {}
        if rules == "vocab":
            from paddle_tpu_torch.models.wide_deep import vocab_shard_rules
            rules = [(p, tuple(s)) for p, s in vocab_shard_rules("model")]
        strat = _strategy(axes, rules) if axes else None
        shards = embeddings.active_shards(strat, embeddings.padded_vocab(
            vocab))[0] if dist else 1
        exe = core.Executor(device="cpu", strategy=strat)
        exe.run(startup, scope=scope)
        if dist:
            _dist_state(scope, init, info, shards)
        else:
            _load(scope, init)
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0]) for f in feeds]
        tables = {}
        for t in _TABLES:
            g = _global(exe, scope, t, main) if strat is not None \
                else np.asarray(scope.find_var(t)).copy()
            tables[t] = embeddings.to_logical(g, shards)[:vocab]
        local = {n: tuple(scope.find_var(n).shape) for n in scope.var_names()
                 if n.startswith(_TABLES)}
        block = main.global_block()
        grads = {t: (block.has_var(t + "@GRAD"),
                     block.has_var(t + "@GRAD@VALUES")) for t in _TABLES}
        counters = (sharded._LOOKUP_ROWS.value - counters0[0],
                    sharded._A2A_BYTES.labels(direction="ids").value
                    - counters0[1],
                    sharded._A2A_BYTES.labels(direction="rows").value
                    - counters0[2], sharded._UNIQUE_RATIO.value)
        slots_of = sorted(n for n, i in info.items()
                          if i.get("slot_of") == "deep_embedding")
        return dict(losses=losses, tables=tables, shapes=shapes,
                    local=local, grads=grads, counters=counters,
                    slots=slots_of)
    finally:
        opdef.compute = orig
        _flags(**prev)


def checkpoint_reshard(axes_save, axes_load, ckpt, feeds, feed_after,
                       vocab, slots, ddim):
    """Train 3 Adam steps under ``axes_save``, save a checkpoint with the
    layout, restore it under ``axes_load`` (None: one process), reshard
    and take one more step. Returns (the logical rows at save, the
    logical rows after the reshard, arrays moved, step, the saved shard
    count, the new loss, the table's local shape)."""
    from paddle_tpu_torch import core, embeddings, io
    prev = _flags(embedding_shard_rows=True, embedding_a2a=True)
    try:
        scope, guard = _fresh()
        with guard:
            main, startup, loss = build_wide_deep(
                True, ("Adam", (1e-2,)), vocab, slots, ddim, seed=3)
        info = embeddings.dist_tables(main)
        st4 = _strategy(axes_save)
        n4 = embeddings.active_shards(st4, info["deep_embedding"][
            "padded"])[0]
        exe = core.Executor(device="cpu", strategy=st4)
        exe.run(startup, scope=scope)
        for f in feeds:
            exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        io.save_checkpoint(exe, ckpt, step=3, main_program=main,
                           scope=scope,
                           extra_meta=embeddings.layout_meta(main, st4))
        want = {n: embeddings.to_logical(_global(exe, scope, n, main), n4)
                for n in info}
        meta = io.load_checkpoint_meta(ckpt)
        stn = _strategy(axes_load) if axes_load else None
        exe2 = core.Executor(device="cpu", strategy=stn)
        scope2 = core.Scope()
        exe2.run(startup, scope=scope2)
        step = io.load_checkpoint(exe2, ckpt, main_program=main,
                                  scope=scope2)
        moved = embeddings.reshard_scope(scope2, meta, strategy=stn)
        nn = embeddings.active_shards(stn, info["deep_embedding"][
            "padded"])[0]
        got = {n: embeddings.to_logical(
            np.asarray(scope2.find_var(n)), nn).copy() for n in info}
        out = exe2.run(main, feed=feed_after, fetch_list=[loss],
                       scope=scope2)
        return (want, got, moved, step,
                meta["embedding_layout"]["deep_embedding"]["num_shards"],
                float(out[0]), tuple(scope2.find_var(
                    "deep_embedding").shape))
    finally:
        _flags(**prev)


def shared_table_steps(axes, init, feeds, vocab):
    """The reference's shared-table program (two distributed lookups of
    one table) under a strategy from the dense weights; returns the
    losses and the table in logical order."""
    import torch
    from paddle_tpu_torch import core, embeddings, layers, optimizer
    prev = _flags(embedding_shard_rows=True, embedding_a2a=True)
    try:
        scope, guard = _fresh()
        with guard:
            main, startup = core.Program(), core.Program()
            main.random_seed = startup.random_seed = 13
            with core.program_guard(main, startup):
                a = layers.data("a", shape=[3], dtype="int64")
                b = layers.data("b", shape=[2], dtype="int64")
                lbl = layers.data("lbl", shape=[1])
                ea = layers.embedding(a, size=[vocab, 8],
                                      param_attr="shared",
                                      is_distributed=True)
                eb = layers.embedding(b, size=[vocab, 8],
                                      param_attr="shared",
                                      is_distributed=True)
                pooled = layers.elementwise_add(
                    layers.reduce_sum(ea, dim=1),
                    layers.reduce_sum(eb, dim=1))
                loss = layers.mean(layers.square_error_cost(
                    layers.fc(pooled, 1), lbl))
                optimizer.SGD(0.1).minimize(loss, startup)
        info = embeddings.dist_tables(main)
        st = _strategy(axes)
        n = embeddings.active_shards(st, info["shared"]["padded"])[0]
        exe = core.Executor(device="cpu", strategy=st)
        exe.run(startup, scope=scope)
        padded = np.zeros((info["shared"]["padded"], 8), "float32")
        padded[:vocab] = init["shared"]
        scope.set_var("shared", torch.from_numpy(
            embeddings.to_shard_major(padded, n)))
        _load(scope, {k: v for k, v in init.items() if k != "shared"})
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0]) for f in feeds]
        table = embeddings.to_logical(_global(exe, scope, "shared", main),
                                      n)[:vocab]
        return losses, table
    finally:
        _flags(**prev)


def all_reduce_sum(x):
    import torch
    import torch.distributed as dist
    t = torch.from_numpy(np.asarray(x) * (dist.get_rank() + 1))
    dist.all_reduce(t)
    return t.numpy()


def resize(axes, devices):
    from paddle_tpu_torch import parallel
    st = _strategy(axes, [(r"^w", (None, "model"))]
                   if "model" in axes else None)
    new = parallel.resize_strategy(st, devices)
    return (dict(new.mesh.shape), new._uid != st._uid,
            [p.pattern for p, _ in new.param_rules], new.data_axis)


def staged_mlp(axes, weights, feeds, trainer=False):
    """The MLP's steps with batches through ``StagedReader(strategy=)``
    (packed: one copy of this rank's rows), or through ``Trainer(
    strategy=)``; returns the losses and the staging counts."""
    from paddle_tpu_torch import core, trainer as _trainer
    from paddle_tpu_torch.reader.staging import StagedReader
    scope, guard = _fresh()
    with guard:
        main, startup, loss = build_mlp()
    st = _strategy(axes)
    if trainer:
        from paddle_tpu_torch.core import scope as _scope
        losses = []
        with _scope.scope_guard(scope):
            tr = _trainer.Trainer(loss, main_program=main,
                                  startup_program=startup, strategy=st,
                                  device="cpu")
            tr.startup()
            _load(scope, weights)
            prev = _flags(packed_feeds=True)
            try:
                tr.train(lambda: iter(feeds), num_passes=1,
                         event_handler=lambda e: losses.append(
                             float(np.asarray(e.metrics["loss"])))
                         if isinstance(e, _trainer.EndIteration) else None)
            finally:
                _flags(**prev)
        return losses, None
    exe = core.Executor(device="cpu", strategy=st)
    exe.run(startup, scope=scope)
    _load(scope, weights)
    reader = StagedReader(lambda: iter(feeds), strategy=st, pack=True,
                          device="cpu", program=main)
    losses, starts = [], []
    try:
        for batch in reader():
            starts.append((batch.shard_start, tuple(batch.buffer.shape)))
            losses.append(float(exe.run(main, feed=batch,
                                         fetch_list=[loss],
                                         scope=scope)[0]))
    finally:
        reader.close()
    return losses, starts


def mlp_accuracy(axes, weights, feed):
    """The MLP's forward with ``accuracy`` (a metric over the batch)."""
    from paddle_tpu_torch import core, layers
    from paddle_tpu_torch.param_attr import ParamAttr
    scope, guard = _fresh()
    with guard:
        main, startup = core.Program(), core.Program()
        with core.program_guard(main, startup):
            x = layers.data("x", shape=[8])
            y = layers.data("y", shape=[1], dtype="int64")
            h = layers.fc(x, 16, act="relu", param_attr=ParamAttr(name="w1"))
            logits = layers.fc(h, 4, param_attr=ParamAttr(name="w2"))
            acc = layers.accuracy(layers.softmax(logits), y)
    exe = core.Executor(device="cpu", strategy=_strategy(axes))
    exe.run(startup, scope=scope)
    _load(scope, weights)
    return float(exe.run(main, feed=feed, fetch_list=[acc],
                         scope=scope)[0])


def ragged_feeds(axes, x, table):
    """A [B, 4] feed beside a [T, 4] one of another leading dim: neither
    is sharded, the program runs replicated; returns the fetch."""
    import torch
    from paddle_tpu_torch import core, layers
    scope, guard = _fresh()
    with guard:
        main, startup = core.Program(), core.Program()
        with core.program_guard(main, startup):
            xv = layers.data("x", shape=[4])
            tv = layers.data("t", shape=[4])
            out = layers.elementwise_add(layers.reduce_sum(xv, dim=0),
                                         layers.reduce_sum(tv, dim=0))
    exe = core.Executor(device="cpu", strategy=_strategy(axes))
    return exe.run(main, feed={"x": x, "t": table}, fetch_list=[out],
                   scope=scope)[0]
