"""The executor's captured steps, on the CPU, under an emulated CUDA graph.

The CPU has no CUDA graphs, so these tests stand one in: a capture
records every ATen op the step dispatches (``TorchDispatchMode``), with
the very tensors it read and wrote, and a replay runs the recorded ops
again and copies each result into the tensor the capture recorded, so a
replay writes the same memory a CUDA graph's would and runs no Python of
the step. ``core.executor.graphs_on`` is patched to say the CPU
captures, and ``torch.cuda``'s graph, pool and stream calls and the
cuBLAS/cuDNN handle warm-up are stubbed.
The card runs the real thing (``chip_smoke.py``).

* Generation sessions (dense, paged with prefix hits and copy on write,
  int8 weights with bfloat16 pools, speculative): every program entry
  is captured at its second run and replayed after; the streams equal
  the uncaptured session's token for token, and the program route's
  replays give the same streams as its first, op-by-op runs.
* Launch counts: a replay adds what its capture counted, the capture
  itself nothing (a counting kernel stand-in on the CPU).
* The engine: warmup leaves every bucket of every replica captured; a
  swap installs new tensors and the next batch recaptures (counted in
  ``compile_stats`` as a recompile) and serves the new weights; the
  canary runs on its own scope without touching the graph; answers equal
  the uncaptured engine's.
* A capture that raises (an op that would wait on the host) logs
  ``executor_capture_failed`` and the entry runs op by op for good.
* Scratch: each graph keeps the buffers its capture took.
* Closing a program session or an engine drops its executors' graphs,
  which hold the caches and weights it let go.
"""

import contextlib
import shutil

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as ptpu
from paddle_tpu import layers as ref_layers
from paddle_tpu.models.transformer import transformer_lm as ref_lm
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers
from paddle_tpu_torch.core import executor as port_exe
from paddle_tpu_torch.models import transformer as port_tf
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.serving import GenerationSession, ServingEngine
from paddle_tpu_torch.serving.decoding import DecodePolicy
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

V, MAXLEN, SLOTS = 64, 32, 4
KW = dict(d_model=32, num_heads=2, d_ff=64, num_layers=2)
IN, OUT = 12, 5


class _Recorder(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


_REPLAYING = [False]


class _FakeGraph:
    """A CUDA graph's memory semantics on the CPU: see the module
    docstring."""

    def __init__(self):
        self.ops = []
        self._mode = None

    def capture_begin(self, pool=None, capture_error_mode=None):
        self._mode = _Recorder(self.ops)
        self._mode.__enter__()

    def capture_end(self):
        self._mode.__exit__(None, None, None)

    def replay(self):
        _REPLAYING[0] = True
        try:
            with torch.no_grad():
                for func, args, kwargs, out in self.ops:
                    new = func(*args, **kwargs)
                    for o, n in zip(pytree.tree_leaves(out),
                                    pytree.tree_leaves(new)):
                        if isinstance(o, torch.Tensor) and o is not n and \
                                o.data_ptr() != n.data_ptr():
                            o.copy_(n)
        finally:
            _REPLAYING[0] = False


class _Stream:
    def wait_stream(self, other):
        pass


def _emulate(m):
    """Captures on the CPU, through _FakeGraph, under the monkeypatch
    ``m``; returns the list of graphs made."""
    made = []

    def graph():
        made.append(_FakeGraph())
        return made[-1]
    m.setattr(port_exe, "graphs_on", lambda device: True)
    m.setattr(port_exe, "_warm_handles", lambda device: None)
    m.setattr(torch.cuda, "CUDAGraph", graph)
    m.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    m.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    m.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    m.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    return made


@pytest.fixture
def graphs(monkeypatch):
    return _emulate(monkeypatch)


@pytest.fixture
def counting(monkeypatch):
    """B4's and B5's CPU implementations count a launch, as their CUDA
    ones do (a replay's re-run of the recorded op does not). The counts
    go back to what they were after the test: they are process-wide, and
    other files on the worker expect none on the CPU."""
    for name, plain in (("decode_attention_plain", fa.decode_attention),
                        ("_decode_paged_reference",
                         fa.decode_attention_paged)):
        monkeypatch.setattr(plain, "launches", plain.launches)
        real = getattr(fa, name)

        def counted(*a, _real=real, _wrapper=plain, **k):
            if not _REPLAYING[0]:
                _wrapper.launches += 1
            return _real(*a, **k)
        monkeypatch.setattr(fa, name, counted)


def _named():
    with ptpu.unique_name.guard():
        main, startup = ptpu.Program(), ptpu.Program()
        with ptpu.program_guard(main, startup):
            toks = ref_layers.data("toks", shape=[1, MAXLEN], dtype="int64",
                                   append_batch_size=False)
            ref_lm(toks, toks, vocab_size=V, is_test=True, **KW)
    scope = ptpu.Scope()
    with ptpu.scope_guard(scope):
        ptpu.Executor().run(startup)
    rs = np.random.RandomState(7)
    return {n: rs.standard_normal(np.asarray(scope.find_var(n)).shape)
            .astype(np.float32) for n in sorted(scope.var_names())}


@pytest.fixture(scope="module")
def named():
    return _named()


def _session(named, arm=False, **kw):
    spec = port_tf.transformer_lm_session(
        V, device="cpu", max_len=MAXLEN, slots=SLOTS, prompt_buckets=(8, 16),
        bos_id=0, eos_id=1, block_size=4, **dict(KW, **kw))
    return GenerationSession(spec, port_io.scope_from_jax(named,
                                                          device="cpu"),
                             arm_quant=arm)


PROMPTS = ([0, 5, 7], [2, 3, 4, 5, 6, 7, 8, 9, 10], [2, 3, 4, 5, 6, 7, 8],
           [2, 3, 4, 5, 6, 7, 8, 11], [0, 5, 7])
CELLS = {"dense": dict(paged=False),
         "paged": dict(paged=True, prefix_cache=True),
         "int8-bf16": dict(paged=True, prefix_cache=True, dtype="bfloat16",
                           arm=True),
         "speculative": dict(paged=True, prefix_cache=True,
                             decode_policy=DecodePolicy(speculate_k=3))}


def _streams(named, cell):
    sess = _session(named, **CELLS[cell])
    try:
        out = [[int(t) for t in sess.generate(p, max_new_tokens=6,
                                              eos_id=-1)]
               for p in PROMPTS]
        # the speculative session's draft has an executor of its own
        exes = [sess.exe] + ([sess.draft.exe] if sess.draft is not None
                             else [])
        stats = {k: sum(e.capture_stats()[k] for e in exes)
                 for k in exes[0].capture_stats()}
        return out, stats, [e.compile_stats() for e in exes]
    finally:
        sess.close()


@pytest.mark.parametrize("cell", list(CELLS))
def test_captured_sessions_equal_the_uncaptured(named, monkeypatch, cell):
    want, plain_stats, plain_compiles = _streams(named, cell)
    assert plain_stats["captures"] == 0
    with monkeypatch.context() as m:
        made = _emulate(m)
        got, stats, compiles = _streams(named, cell)
    assert got == want
    # every entry that ran twice was captured once and replayed after
    assert stats["captures"] == len(made) > 0
    assert stats["failed"] == stats["recaptures"] == 0
    assert stats["replays"] > stats["captures"]
    assert compiles == plain_compiles


def test_replays_add_the_launches_their_capture_counted(named, graphs,
                                                        counting):
    sess = _session(named, paged=False)
    try:
        sess.admit([0, 5, 7])
        counts = []
        for _ in range(4):
            before = fa.decode_attention.launches
            sess.step()
            counts.append(fa.decode_attention.launches - before)
        stats = sess.exe.capture_stats()
    finally:
        sess.close()
    # step 1 op by op, step 2 captured (nothing) and replayed, then
    # replays: one launch a layer every step
    assert counts == [KW["num_layers"]] * 4
    assert stats["captures"] >= 1 and stats["replays"] >= 3


def test_each_graph_keeps_its_scratch(named, graphs, monkeypatch):
    taken = []
    real = _build.scratch

    def scratch(device, stream, nbytes):
        buf = real(device, stream, nbytes)
        taken.append(buf)
        return buf
    monkeypatch.setattr(_build, "scratch", scratch)
    with _build.capture_buffers() as bufs:
        a = _build.scratch(torch.device("cpu"), 1, 64)
        assert _build.scratch(torch.device("cpu"), 1, 32) is a
    assert list(bufs.values())[0][0] is a
    # the thread's own buffers are not the capture's
    assert _build.scratch(torch.device("cpu"), 1, 64) is not a


def _export(d, seed=0):
    main, startup = pc.Program(), pc.Program()
    with pc.unique_name.guard(), pc.program_guard(main, startup):
        x = layers.data("x", shape=[IN])
        h = layers.fc(x, 32, act="relu")
        out = layers.fc(h, OUT, act="softmax")
    exe, scope = pc.Executor(device="cpu"), pc.Scope()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(seed)
    for n in sorted(scope.var_names()):
        cur = scope.find_var(n)
        scope.set_var(n, torch.from_numpy(
            rs.standard_normal(tuple(cur.shape)).astype(np.float32) * 0.3))
    port_io.save_inference_model(d, ["x"], [out], exe, main_program=main,
                                 scope=scope)
    return d


def test_engine_warmup_captures_and_a_swap_recaptures(tmp_path,
                                                      monkeypatch):
    d0, d1 = _export(str(tmp_path / "a"), 0), _export(str(tmp_path / "b"), 1)
    feed = np.random.RandomState(3).randn(4, IN).astype(np.float32)
    plain = [ServingEngine(d, buckets=(2, 4), device="cpu")
             for d in (d0, d1)]
    want = [e.run({"x": feed[:3]})[0] for e in plain]
    for e in plain:
        e.close()
    _emulate(monkeypatch)
    # the emulated card: warmup runs each bucket twice
    eng = ServingEngine(d0, buckets=(2, 4), replicas=2, device="cpu")
    for rep in eng.replicas:
        assert rep.exe.capture_stats()["captures"] == 2
        assert all(e.graph is not None for e in rep.exe._cache.values())
    np.testing.assert_array_equal(eng.run({"x": feed[:3]})[0], want[0])
    compiles = [rep.exe.compile_stats()["compiles"] for rep in eng.replicas]
    eng.swap_weights(d1, watch_requests=0)
    outs = [eng.run({"x": feed[:3]})[0] for _ in eng.replicas]
    for out in outs:
        np.testing.assert_array_equal(out, want[1])
    for rep, c in zip(eng.replicas, compiles):
        stats = rep.exe.capture_stats()
        # the canary ran op by op on its own scope; the next batch on
        # each replica recaptured bucket 4
        assert stats["recaptures"] == 1 and stats["failed"] == 0
        assert rep.exe.compile_stats()["compiles"] == c + 1
    eng.close()
    shutil.rmtree(d0)
    shutil.rmtree(d1)


def test_a_failed_capture_runs_op_by_op(named, graphs, monkeypatch):
    logged = []
    monkeypatch.setattr(port_exe._log, "structured",
                        lambda event, **kw: logged.append(event))

    class Refusing(_FakeGraph):
        def capture_begin(self, pool=None, capture_error_mode=None):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Refusing)
    want, _, _ = _streams(named, "dense")
    monkeypatch.setattr(port_exe, "graphs_on", lambda device: False)
    plain, _, _ = _streams(named, "dense")
    assert want == plain
    assert "executor_capture_failed" in logged


def test_closing_releases_the_captured_steps(named, graphs, tmp_path):
    """A closed program session's captured steps would hold the caches
    it erased from its scope, and a closed engine's its weights: both
    drop their executors' graphs."""
    sess = _session(named, paged=True, prefix_cache=True)
    sess.generate(PROMPTS[0], max_new_tokens=4, eos_id=-1)
    pool = sess.scope.find_var(sess.spec.cache_vars[0][0])
    held = [e for e in sess.exe._cache.values() if e.graph is not None]
    assert held and any(t is pool for e in held
                        for t in e.graph.state.values())
    sess.close()
    assert all(e.graph is None for e in sess.exe._cache.values())
    eng = ServingEngine(_export(str(tmp_path / "m")), buckets=(2,),
                        device="cpu")
    exe = eng.replicas[0].exe
    assert [e.graph is not None for e in exe._cache.values()] == [True]
    eng.close()
    assert [e.graph for e in exe._cache.values()] == [None]
