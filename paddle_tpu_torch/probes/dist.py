"""The strategy route across cards: the distribution slice's multi-rank
paths over NCCL, each held against one process on the same card.

    python3 -m paddle_tpu_torch.probes.dist [--ranks N] [--timeout S]

Starts N ranks (default: every visible card), one process a card, joined
through ``distributed.init_multihost`` (NCCL). Every rank runs each case
under its strategy and, on the same card from the same weights, without
one; rank 0 prints one JSON object a case:

* ``mlp``: a 2-layer MLP, SGD, batch 64, 5 steps under
  ``DataParallel(N)``: the losses' largest relative difference.
* ``lm``: the transformer LM program (vocab 1024, d_model 256, 4 heads,
  d_ff 512, 2 layers, batch 8 x T 128, Adam, f32) under
  ``{"data": N / 2, "model": 2}`` with ``transformer_tp_rules``: 2 steps'
  relative difference, B2's launches and those through the per-shard
  route.
* ``wide_deep``: ``bench.py`` ``bench_recsys``'s on-card configuration
  with N row-sharded tables (vocab 200,000, 26 slots, emb_dim 32, global
  batch 4096, Adagrad(0.05), ``embedding_shard_rows`` and
  ``embedding_a2a`` on): 3 steps against one process on the identity
  layout, the int8 wire's 3 steps beside, then one warm and 30 timed
  steps through ``StagedReader(strategy=)`` (each rank copies its row of
  the packed batch): ``recsys_examples_per_sec`` and
  ``embedding_lookup_rows_per_sec`` of the global batch.
* ``ring``: ring attention over the N ranks at [2, 1024, 16, 128],
  causal, against dense attention: forward and gradients.

The parent kills every rank and exits nonzero when one fails or the run
passes ``--timeout``.

    python3 -m paddle_tpu_torch.probes.dist elastic [--ranks N]
        [--timeout S] [--device cuda|cpu]

runs the ``elastic`` case alone: the task master and a RecordIO dataset
(52 chunks of 12 samples, one a rank's step) in the parent, N workers
(default: every card), each an ``ElasticTrainerLoop`` over the
coordinator's NCCL group (gloo with ``--device cpu``) training a
DataParallel MLP as a ResilientTrainer over a generation-fenced
dispatcher, a checkpoint every step (one directory, written by the
mesh's first rank). Worker w2 SIGKILLs itself before
step 4 (``worker_kill``) while the others sit in the step's all-reduce:
their watchdogs (4 s) abort the group (``collective_abort``), the master
declares w2 dead (1 s deadline), and they rebuild at the survivors'
world, restore their checkpoints and finish the pass. One JSON object:
each survivor's generations, bring-ups, kill-to-resumed-step seconds and
``paddle_elastic_*`` counters, and the master's final view. The
subprocess timeout is the check that no survivor hangs; the exit code is
nonzero unless every survivor resumed and every chunk is done.
"""

import argparse
import faulthandler
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import torch

_CHILD = "--rank"


def _copy_scope(scope, tables=(), shards=1):
    """A copy of ``scope``'s tensors; ``tables`` (names) laid out
    shard-major for ``shards``."""
    from .. import core
    from ..embeddings import to_shard_major
    out = core.Scope()
    for n, v in scope.items():
        if n in tables and shards > 1:
            v = torch.from_numpy(to_shard_major(v.cpu().numpy(), shards)) \
                .to(v.device)
        out.set_var(n, v.detach().clone())
    return out


def _rel(a, b):
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def _pair(main, startup, loss, feeds, strategy, tables=(), shards=1):
    """(losses without a strategy, losses under ``strategy``) from one
    startup."""
    from .. import core
    init = core.Scope()
    core.Executor().run(startup, scope=init)
    out = []
    for st in (None, strategy):
        scope = _copy_scope(init, tables if st is not None else (), shards)
        exe = core.Executor(strategy=st)
        out.append([float(exe.run(main, feed=f, fetch_list=[loss],
                                  scope=scope)[0]) for f in feeds])
    return out


def case_mlp(n):
    from .. import core, layers, optimizer, parallel
    main, startup = core.Program(), core.Program()
    with core.unique_name.guard(), core.program_guard(main, startup):
        x = layers.data("x", shape=[8])
        y = layers.data("y", shape=[1], dtype="int64")
        h = layers.fc(x, 16, act="relu")
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.fc(h, 4), y))
        optimizer.SGD(0.1).minimize(loss, startup)
    rs = np.random.RandomState(0)
    xv = rs.randn(64, 8).astype("float32")
    feeds = [{"x": xv, "y": (xv[:, :1] > 0).astype("int64")}] * 5
    plain, dp = _pair(main, startup, loss, feeds,
                      parallel.DataParallel(n_devices=n))
    return {"case": "mlp", "ranks": n, "plain": plain, "strategy": dp,
            "rel_err": _rel(dp, plain)}


def case_lm(n):
    from .. import core, layers, optimizer, parallel
    from ..models.transformer import transformer_lm, transformer_tp_rules
    from ..ops import flash_attention as fa
    from ..ops.attention_ops import sharded_attention
    t, b = 128, 8
    main, startup = core.Program(), core.Program()
    main.random_seed = startup.random_seed = 11
    with core.unique_name.guard(), core.program_guard(main, startup):
        tok = layers.data("tok", shape=[t], dtype="int64")
        lbl = layers.data("lbl", shape=[t], dtype="int64")
        loss, _ = transformer_lm(tok, lbl, 1024, d_model=256, num_heads=4,
                                 d_ff=512, num_layers=2)
        optimizer.Adam(1e-3).minimize(loss, startup)
    ids = np.random.RandomState(5).randint(2, 1024, (b, t))
    feeds = [{"tok": ids, "lbl": np.roll(ids, -1, axis=1)}] * 2
    model = 2 if n % 2 == 0 else 1
    mesh = parallel.make_mesh({"data": n // model, "model": model})
    st = parallel.DistStrategy(mesh, param_rules=transformer_tp_rules())
    launches0 = fa.flash_attention.launches
    sharded_attention.per_shard = 0
    plain, dp = _pair(main, startup, loss, feeds, st)
    return {"case": "lm", "mesh": dict(mesh.shape), "plain": plain,
            "strategy": dp, "rel_err": _rel(dp, plain),
            "b2_launches": fa.flash_attention.launches - launches0,
            "per_shard": sharded_attention.per_shard}


def case_wide_deep(n, steps=30):
    from .. import config, core, embeddings, layers, optimizer, parallel
    from ..models.wide_deep import wide_deep
    from ..reader.staging import StagedReader
    vocab, slots, dim, batch = 200_000, 26, 32, 4096
    main, startup = core.Program(), core.Program()
    with core.unique_name.guard(), core.program_guard(main, startup):
        ids = layers.data("ids", shape=[slots], dtype="int64")
        dense = layers.data("dense", shape=[8])
        label = layers.data("label", shape=[1])
        loss, _, _ = wide_deep(ids, dense, label, vocab, slots,
                               emb_dim=dim, hidden=(64, 32),
                               is_distributed=True)
        optimizer.Adagrad(0.05).minimize(loss, startup)
    rs = np.random.RandomState(7)
    batches = [{"ids": rs.randint(0, vocab, (batch, slots)).astype("int32"),
                "dense": rs.randn(batch, 8).astype("float32"),
                "label": rs.randint(0, 2, (batch, 1)).astype("float32")}
               for _ in range(3)]
    tables = tuple(embeddings.dist_tables(main))
    st = parallel.DataParallel(n_devices=n)
    prev = {k: config.get_flag(k) for k in (
        "embedding_shard_rows", "embedding_a2a", "embedding_wire_dtype",
        "packed_feeds")}
    config.set_flags(embedding_shard_rows=True, embedding_a2a=True,
                     packed_feeds=True)
    try:
        plain, dp = _pair(main, startup, loss, batches, st, tables, n)
        config.set_flags(embedding_wire_dtype="int8")
        _, int8 = _pair(main, startup, loss, batches, st, tables, n)
        config.set_flags(embedding_wire_dtype=None)
        init = core.Scope()
        core.Executor().run(startup, scope=init)
        scope = _copy_scope(init, tables, n)
        exe = core.Executor(strategy=st)

        def reader(k):
            def gen():
                for i in range(k):
                    yield dict(batches[i % len(batches)])
            return gen
        sr = StagedReader(reader(1), strategy=st, program=main)
        for staged in sr():
            exe.run(main, feed=staged, fetch_list=[loss], scope=scope)
        sr.close()
        torch.cuda.synchronize()
        sr = StagedReader(reader(steps), strategy=st, program=main)
        t0 = time.perf_counter()
        starts = set()
        for staged in sr():
            starts.add(staged.shard_start)
            last = exe.run(main, feed=staged, fetch_list=[loss],
                           scope=scope, return_numpy=False)[0]
        final = float(last)
        elapsed = time.perf_counter() - t0
        sr.close()
        local = tuple(scope.find_var("deep_embedding").shape)
    finally:
        config.set_flags(**prev)
    return {"case": "wide_deep", "shards": n, "plain": plain,
            "strategy": dp, "rel_err": _rel(dp, plain), "int8_wire": int8,
            "int8_rel_err": _rel(int8, plain), "local_table": list(local),
            "shard_starts": sorted(s for s in starts if s is not None),
            "steps": steps, "seconds": elapsed, "final_loss": final,
            "recsys_examples_per_sec": batch * steps / elapsed,
            "embedding_lookup_rows_per_sec":
                2 * batch * slots * steps / elapsed}


def case_ring(n):
    from .. import parallel
    mesh = parallel.make_mesh({"sp": n})
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (0.5 * torch.randn((2, 1024, 16, 128), device="cuda",
                                 generator=g) for _ in range(3))
    outs = []
    for ring in (True, False):
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        o = parallel.ring_attention(qs, ks, vs, mesh, axis_name="sp",
                                    causal=True) if ring else \
            parallel.dense_attention(qs, ks, vs, causal=True)
        (o * o).sum().backward()
        outs.append((o.detach(), qs.grad, ks.grad, vs.grad))
    errs = [float((a - b).abs().max()) for a, b in zip(*outs)]
    return {"case": "ring", "ranks": n, "forward_max_abs": errs[0],
            "grad_max_abs": errs[1:]}


# -- elastic: a rank killed mid-pass, the survivors resume ------------------

ELASTIC_PROBE = dict(batch=12, dim=32, hidden=64, chunks=52, kill_rank=2,
                     kill_at=4, hb_timeout_ms=3000, hb_interval_s=0.2,
                     settle_s=3.5, deadline_s=4.0, lease_timeout_s=2,
                     init_timeout_s=60)


def _elastic_dataset(path, cfg, seed=0):
    """``chunks`` RecordIO chunks of ``batch`` (x, y) regression samples:
    one chunk a rank's step."""
    from ..reader import recordio
    rs = np.random.RandomState(seed)
    n = cfg["chunks"] * cfg["batch"]
    x = rs.randn(n, cfg["dim"]).astype("float32")
    y = (x.sum(1, keepdims=True) * 0.1).astype("float32")
    rec = len(pickle.dumps((x[0], y[0])))
    recordio.write_recordio(path, zip(x, y),
                            max_chunk_bytes=cfg["batch"] * rec - rec // 2)
    return recordio.num_chunks(path)


def _elastic_child(args):
    """One worker ``w<rank>`` of the elastic case: an ElasticTrainerLoop
    over the coordinator's NCCL group (gloo with ``--device cpu``), a
    DataParallel MLP over the world's ranks as a ResilientTrainer over a
    generation-fenced dispatcher, a checkpoint every step into one
    directory (the mesh's first rank writes it, every rank reads it); the
    rank ``kill_rank`` SIGKILLs itself before step ``kill_at``. Writes its
    record to ``<dir>/w<rank>.json``."""
    from .. import core, layers, optimizer, parallel
    from ..distributed import ElasticDataDispatcher, ElasticTrainerLoop
    from ..observability import metrics
    from ..resilience import RecoveryPolicy, ResilientTrainer, faults
    from ..distributed import elastic
    from ..trainer import EndIteration
    from ..utils import log
    cfg = ELASTIC_PROBE
    rank, out = args.elastic_rank, args.dir
    # the parent's SIGUSR1 before a timeout's kill: every thread's stack
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    real_abort = elastic.abort_multihost

    def timed_abort(*a, **kw):
        t0 = time.time()
        done = real_abort(*a, **kw)
        log.structured("probe_abort_returned", worker="w%d" % rank,
                       aborted=done, seconds=round(time.time() - t0, 4))
        return done

    elastic.abort_multihost = timed_abort
    wid = "w%d" % rank
    device = None if args.device == "cuda" else args.device
    if rank == cfg["kill_rank"]:
        def die():
            with open(os.path.join(out, wid + ".killed"), "w") as f:
                f.write(repr(time.time()))
            os.kill(os.getpid(), signal.SIGKILL)
        faults.arm("worker_kill", at=cfg["kill_at"], action="callback",
                   callback=die)
    ds = os.path.join(out, "data.rio")
    record = {"worker": wid, "steps": [], "bring_ups": [], "restored": []}

    def build(world):
        main, startup = core.Program(), core.Program()
        with core.unique_name.guard(), core.program_guard(main, startup):
            x = layers.data("x", shape=[cfg["dim"]])
            y = layers.data("y", shape=[1])
            h = layers.fc(x, cfg["hidden"], act="relu")
            loss = layers.mean(layers.square_error_cost(layers.fc(h, 1),
                                                        y))
            optimizer.SGD(0.05).minimize(loss, startup)
        record["bring_ups"].append((world.generation, world.n_live,
                                    world.process_id, time.time()))
        tr = ResilientTrainer(
            loss, main_program=main, startup_program=startup,
            strategy=parallel.DataParallel(n_devices=world.num_processes),
            checkpoint_dir=os.path.join(out, "ckpt"),
            checkpoint_every_n_steps=1, device=device,
            policy=RecoveryPolicy(step_deadline_sec=cfg["deadline_s"]))
        disp = ElasticDataDispatcher(world.client, ds, worker_id=wid,
                                     generation=world.generation)
        real = tr.startup

        def startup():
            first = not tr._initialized
            real()
            if first:
                record["restored"].append(tr.step_id)
        tr.startup = startup

        def reader():
            xs, ys = [], []
            for xv, yv in disp.reader(poll_interval=0.02)():
                xs.append(xv)
                ys.append(yv)
                if len(xs) == cfg["batch"]:
                    yield {"x": np.stack(xs), "y": np.stack(ys)}
                    xs, ys = [], []
        return tr, reader

    def handler(e):
        if isinstance(e, EndIteration):
            record["steps"].append((loop.restarts, e.step_id,
                                    float(np.asarray(e.cost)), time.time()))

    loop = ElasticTrainerLoop(
        build, args.master_port, worker_id=wid,
        heartbeat_interval_sec=cfg["hb_interval_s"],
        coordinator_address=args.addr, num_processes=args.ranks,
        initialization_timeout_sec=cfg["init_timeout_s"],
        settle_sec=cfg["settle_s"], device=device)
    with core.scope_guard(core.Scope()):
        record["result"] = loop.run(num_passes=1, event_handler=handler)
    fams = metrics.REGISTRY.families()
    record.update(
        generations=loop.generations, restarts=loop.restarts,
        counters={n: (sum(c.value for c in fams[n].children().values())
                      if fams[n].kind != "histogram" else
                      [sum(c.count for c in fams[n].children().values()),
                       sum(c.sum for c in fams[n].children().values())])
                  for n in sorted(fams) if n.startswith("paddle_elastic_")})
    from ..distributed import shutdown_multihost
    shutdown_multihost()
    with open(os.path.join(out, wid + ".json"), "w") as f:
        json.dump(record, f)
    # the record is out: leave without the interpreter's teardown
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_elastic(n, timeout, device):
    """The elastic case's parent: the task master and the dataset, ``n``
    workers, then one JSON object with what each survivor saw."""
    import shutil
    import tempfile
    from ..distributed import (ElasticDataDispatcher, MasterClient,
                               MasterServer)
    cfg = ELASTIC_PROBE
    out = tempfile.mkdtemp(prefix="elastic_probe_")
    chunks = _elastic_dataset(os.path.join(out, "data.rio"), cfg)
    srv = MasterServer(os.path.join(out, "snap"),
                       timeout_sec=cfg["lease_timeout_s"],
                       heartbeat_timeout_ms=cfg["hb_timeout_ms"])
    with socket.socket() as s:
        s.bind(("localhost", 0))
        addr = "localhost:%d" % s.getsockname()[1]
    procs = []
    t0 = time.time()
    try:
        client = MasterClient(srv.port)
        ElasticDataDispatcher(client, os.path.join(out, "data.rio")) \
            .register_dataset()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.probes.dist",
             "elastic", "--ranks", str(n), "--elastic-rank", str(r),
             "--addr", addr, "--master-port", str(srv.port), "--dir", out,
             "--device", device], env=dict(os.environ))
            for r in range(n)]
        rc, deadline = 0, t0 + timeout
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=max(1.0, deadline - time.time())))
            except subprocess.TimeoutExpired:
                codes.append(None)
                rc = 124
        if rc:
            # stacks of the ranks still running, then the kill below
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGUSR1)
            time.sleep(3)
        records = {}
        for r in range(n):
            path = os.path.join(out, "w%d.json" % r)
            if os.path.exists(path):
                with open(path) as f:
                    records["w%d" % r] = json.load(f)
        killed_path = os.path.join(out, "w%d.killed" % cfg["kill_rank"])
        killed = float(open(killed_path).read()) \
            if os.path.exists(killed_path) else None
        survivors = {}
        for w, rec in records.items():
            resumed = [t for restarts, _, _, t in rec["steps"] if restarts]
            survivors[w] = {
                "generations": rec["generations"],
                "restarts": rec["restarts"],
                "bring_ups": [b[:3] for b in rec["bring_ups"]],
                "restored_steps": rec["restored"],
                "kill_to_resumed_step_s": None if killed is None or
                not resumed else resumed[0] - killed,
                "steps": len(rec["steps"]),
                "last_loss": rec["steps"][-1][2] if rec["steps"] else None,
                "counters": rec["counters"]}
        doc = {"case": "elastic", "ranks": n, "device": device,
               "killed": "w%d" % cfg["kill_rank"],
               "kill_at_step": cfg["kill_at"], "exit_codes": codes,
               "chunks": chunks, "master": client.stats(),
               "cluster": client.cluster(), "survivors": survivors,
               "seconds": time.time() - t0, "config": cfg}
        if device == "cuda":
            doc["card"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip().splitlines()[0]
        print(json.dumps(doc), flush=True)
        ok = (rc == 0 and len(survivors) == n - 1 and
              codes[cfg["kill_rank"]] == -signal.SIGKILL and
              all(c == 0 for r, c in enumerate(codes)
                  if r != cfg["kill_rank"]) and
              doc["master"]["todo"] == 0 and doc["master"]["pending"] == 0
              and all(s["restarts"] >= 1 and s["kill_to_resumed_step_s"]
                      is not None for s in survivors.values()))
        return rc or (0 if ok else 1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        srv.stop()
        shutil.rmtree(out, ignore_errors=True)


def _child(addr, rank, n):
    from ..distributed import init_multihost, shutdown_multihost
    from ..place import resolve_device
    init_multihost(addr, n, rank, initialization_timeout_sec=120)
    resolve_device(None)
    try:
        for case in (case_mlp, case_lm, case_wide_deep, case_ring):
            out = case(n)
            if rank == 0:
                out["card"] = subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, timeout=60).stdout.strip().splitlines()[0]
                print(json.dumps(out), flush=True)
    finally:
        shutdown_multihost()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument(_CHILD, type=int, default=None)
    ap.add_argument("--addr", default=None)
    ap.add_argument("cases", nargs="*", default=[],
                    help="'elastic' runs the elastic case alone; nothing "
                    "runs the others")
    ap.add_argument("--elastic-rank", type=int, default=None)
    ap.add_argument("--master-port", type=int, default=None)
    ap.add_argument("--dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, the default) or cpu (gloo), for the "
                    "elastic case")
    args = ap.parse_args(argv)
    if args.rank is not None:
        _child(args.addr, args.rank, args.ranks)
        return 0
    if args.elastic_rank is not None:
        _elastic_child(args)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if "elastic" in args.cases:
        return run_elastic(args.ranks or (torch.cuda.device_count()
                                          if args.device == "cuda" else 4),
                           args.timeout, args.device)
    n = args.ranks or torch.cuda.device_count()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        addr = "localhost:%d" % s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.probes.dist", "--ranks",
         str(n), _CHILD, str(r), "--addr", addr], env=dict(os.environ))
        for r in range(n)]
    deadline = time.time() + args.timeout
    rc = 0
    for p in procs:
        try:
            rc = rc or p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            rc = 124
            break
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())
