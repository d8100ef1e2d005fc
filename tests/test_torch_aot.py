"""Exported steps and AOT serving artifacts on the CPU.

* The kernels as torch ops: ``torch.library.opcheck`` of B2's forward,
  B4, B5 and B3's product (``paddle_tpu_torch::``), and an exported step
  holds each op as one node, not its plain version's arithmetic.
* Parity: a step exported (``Executor.lower``), saved, loaded and run is
  ``torch.equal`` to the executor's op-by-op run on the same inputs, in
  its fetches and in the state it writes: the LM forward (f32, and armed
  int8), and every program the generation sessions run (dense and paged
  prefill and decode, the block copy, the speculative verify; int8
  weights with bfloat16 pools). A small LM (vocab 64, d_model 32, 2
  heads, d_ff 64, 2 layers) on seed-7 standard-normal weights crossed in
  through ``io.scope_from_jax``.
* AOT artifacts (the port's counterparts of the reference's
  ``tests/test_deploy.py`` ``TestAOTExport`` and
  ``test_merged_artifact_serves_embedded_aot``): ``export_compiled_buckets``
  writes a verified index, an engine primes every bucket of every
  replica from it with no fallback and serves the plain engine's
  answers; a corrupt blob, a digest skew, a missing digest and
  ``use_exported=False`` each run the program, counted; a merged file
  carries ``compiled/``; an int8 artifact exports as the
  ``serving_quant_compute`` engine serves it.
* Crossing artifacts: the reference engine serves the port's
  ``compiled/`` artifact by a counted fallback on every bucket and
  replica, within the engine tests' tolerance of the reference's
  answers (the port's engine on a reference artifact:
  ``test_torch_serving_engine.py``).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import layers as ref_layers
from paddle_tpu.models.transformer import transformer_lm as ref_lm
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu.serving import ServingEngine as RefEngine
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers
from paddle_tpu_torch.core import compile_cache as cc
from paddle_tpu_torch.core import executor as port_exe
from paddle_tpu_torch.models import transformer as port_tf
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import quant_ops
from paddle_tpu_torch.serving import GenerationSession, ServingEngine
from paddle_tpu_torch.serving import deploy
from paddle_tpu_torch.serving import quant as port_quant
from paddle_tpu_torch.serving.decoding import DecodePolicy
from paddle_tpu_torch.utils import merge_model
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

V, MAXLEN, SLOTS = 64, 32, 4
KW = dict(d_model=32, num_heads=2, d_ff=64, num_layers=2)
T = MAXLEN
IN, OUT = 12, 5


@pytest.fixture(autouse=True)
def _flags():
    yield
    port_config.set_flags(serving_quant_compute=False)


def _counter(name):
    return metrics.REGISTRY.counter(name).value


# -- the kernels as torch ops ------------------------------------------------

def _op_cases():
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)
    lengths = torch.tensor([3, 16, 1], dtype=torch.int32)
    pool = rnd(6, 4, 16)
    return {
        "flash_attention_fwd": (rnd(1, 2, 16, 8), rnd(1, 2, 16, 8),
                                rnd(1, 2, 16, 8), None, True),
        "decode_attention": (rnd(3, 16), rnd(3, 16, 16), rnd(3, 16, 16),
                             lengths, 2),
        "decode_attention_paged": (rnd(3, 16), pool, pool * 0.5, lengths,
                                   torch.tensor([[0, 1, 2, 3], [4, 5, 0, 1],
                                                 [2, 2, 2, 2]],
                                                dtype=torch.int32), 2),
        "int8_matmul": (rnd(5, 24), torch.randint(-127, 128, (24, 7),
                                                  generator=g).to(torch.int8),
                        rnd(7).abs()),
    }


@pytest.mark.parametrize("name", ["flash_attention_fwd", "decode_attention",
                                  "decode_attention_paged", "int8_matmul"])
def test_opcheck(name):
    op = getattr(torch.ops.paddle_tpu_torch, name)
    args = _op_cases()[name]
    torch.library.opcheck(op.default, args)
    launches = {fn: fn.launches for fn in (
        fa.flash_attention, fa.decode_attention, fa.decode_attention_paged,
        quant_ops.quant_matmul_2d)}
    plain = {"flash_attention_fwd": lambda q, k, v, s, c:
             fa.flash_attention_plain(q, k, v, c, s),
             "decode_attention": fa.decode_attention_plain,
             "decode_attention_paged": fa._decode_paged_reference,
             "int8_matmul": quant_ops.int8_matmul_plain}[name]
    assert torch.equal(op(*args), plain(*args))
    # the CPU implementation is the plain version: no launch counted
    assert all(fn.launches == n for fn, n in launches.items())


# -- parity of exported steps ------------------------------------------------

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
    out = {}
    for n in sorted(scope.var_names()):
        cur = np.asarray(scope.find_var(n))
        out[n] = rs.standard_normal(cur.shape).astype(cur.dtype)
    return out


@pytest.fixture(scope="module")
def named():
    return _named()


def _clone(d):
    return {n: t.clone() for n, t in d.items()}


class _Checking(pc.Executor):
    """An executor that, at the first run of each cache entry, exports the
    step, saves and loads it, runs the loaded program on copies of the
    run's inputs and holds its fetches and written state to the op-by-op
    run's, ``torch.equal``. Records the programs' labels checked."""

    checked = []

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, donate_state=True):
        n0 = len(self._cache)
        call = self._prepare(program, feed, fetch_list, scope,
                             donate_state, count_cache=False)
        if len(self._cache) == n0:
            return super().run(program, feed, fetch_list, scope,
                               return_numpy, donate_state)
        ep = cc.deserialize_compiled(cc.serialize_compiled(
            port_exe._export(call.entry.fn, call.args, self.device)))
        ops = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
        state_rw = _clone(call.state_rw)
        new_state, fetches, _, _ = ep.module()(state_rw, call.state_ro,
                                               call.feed)
        want = super().run(program, feed, fetch_list, scope, False,
                           donate_state)
        assert len(fetches) == len(want)
        for a, b in zip(fetches, want):
            assert torch.equal(a, b)
        for n in call.state_rw:
            got = new_state.get(n, state_rw[n])
            assert torch.equal(got, scope.find_var(n)), n
        _Checking.checked.append(
            (sorted(o.split("paddle_tpu_torch.")[1].split(".")[0]
                    for o in ops if "paddle_tpu_torch" in o),
             program.global_block().ops[-1].type))
        return [port_exe._to_numpy(v) for v in want] if return_numpy \
            else want


def _session(named, monkeypatch, **kw):
    from paddle_tpu_torch.serving import generation as port_gen
    monkeypatch.setattr(port_gen, "Executor", _Checking)
    arm = kw.pop("arm_quant", False)
    spec = port_tf.transformer_lm_session(
        V, device="cpu", max_len=MAXLEN, slots=SLOTS, prompt_buckets=(8, 16),
        bos_id=0, eos_id=1, block_size=4, **dict(KW, **kw))
    return GenerationSession(spec, port_io.scope_from_jax(named,
                                                          device="cpu"),
                             arm_quant=arm)


PROMPTS = ([0, 5, 7], [2, 3, 4, 5, 6, 7, 8, 9, 10], [2, 3, 4, 5, 6, 7, 8],
           [2, 3, 4, 5, 6, 7, 8, 11])


@pytest.mark.parametrize("cell", ["dense", "paged", "int8-bf16",
                                  "speculative"])
def test_generation_programs_export_bitwise(named, monkeypatch, cell):
    kw = {"dense": dict(paged=False),
          "paged": dict(paged=True, prefix_cache=True),
          "int8-bf16": dict(paged=True, prefix_cache=True, dtype="bfloat16",
                            arm_quant=True),
          "speculative": dict(paged=True, prefix_cache=True,
                              decode_policy=DecodePolicy(speculate_k=3))}[cell]
    _Checking.checked = []
    sess = _session(named, monkeypatch, **kw)
    try:
        for p in PROMPTS:
            sess.generate(p, max_new_tokens=5, eos_id=-1)
    finally:
        sess.close()
    ops = [o for o, _ in _Checking.checked]
    kernels = {k for o in ops for k in o}
    want = {"dense": {"flash_attention_fwd", "decode_attention"},
            "paged": {"decode_attention_paged"},
            "int8-bf16": {"decode_attention_paged", "int8_matmul"},
            "speculative": {"decode_attention_paged",
                            "flash_attention_fwd",
                            "decode_attention"}}[cell]
    assert want <= kernels, kernels
    # every prefill bucket and the decode step; paged: the block copy
    # (prefix hits copy on write); speculative: the verify and the draft's
    assert len(ops) >= {"dense": 3, "paged": 4, "int8-bf16": 4,
                        "speculative": 6}[cell]


def _lm_forward(arm):
    main, startup = pc.Program(), pc.Program()
    with pc.unique_name.guard(), pc.program_guard(main, startup):
        toks = layers.data("toks", shape=[T], dtype="int64")
        lbls = layers.data("lbls", shape=[T], dtype="int64")
        loss, logits = port_tf.transformer_lm(toks, lbls, vocab_size=V,
                                              is_test=True, **KW)
    return main, loss, logits


@pytest.mark.parametrize("arm", [False, True])
def test_lm_forward_exports_bitwise(named, arm):
    main, loss, logits = _lm_forward(arm)
    scope = port_io.scope_from_jax(
        {n: v for n, v in named.items()}, device="cpu")
    if arm:
        port_quant.arm_quant_compute([main], scope)
    rs = np.random.RandomState(3)
    feed = {"toks": rs.randint(2, V, (2, T)).astype("int64"),
            "lbls": rs.randint(2, V, (2, T)).astype("int64")}
    exe = _Checking(device="cpu")
    _Checking.checked = []
    exe.run(main, feed=feed, fetch_list=[loss, logits], scope=scope)
    (ops, _), = _Checking.checked
    assert "flash_attention_fwd" in ops
    assert ("int8_matmul" in ops) == arm
    # the loaded program is what runs under the persistent cache
    ep = exe.lower(main, feed=feed, fetch_list=[loss, logits], scope=scope)
    blob = cc.serialize_compiled(ep)
    exe2 = pc.Executor(device="cpu")
    want = exe2.run(main, feed=feed, fetch_list=[loss, logits], scope=scope)
    exe2.prime_aot(main, feed, [loss, logits], scope,
                   cc.deserialize_compiled(blob),
                   expect_digest=exe.cache_digest(main, feed=feed,
                                                  fetch_list=[loss, logits],
                                                  scope=scope))
    got = exe2.run(main, feed=feed, fetch_list=[loss, logits], scope=scope)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# -- AOT serving artifacts ---------------------------------------------------

def _export(d, seed=0, quantize=None, export_compiled=True,
            buckets=(2, 4)):
    """An fc net built and exported by the port on the CPU: (dir, feed,
    the program's own outputs on the feed)."""
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
                                 scope=scope, quantize=quantize,
                                 export_compiled=export_compiled,
                                 export_buckets=buckets)
    feed = np.random.RandomState(3).randn(8, IN).astype(np.float32)
    want, = exe.run(main, feed={"x": feed}, fetch_list=[out], scope=scope)
    return d, feed, want


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    root = tmp_path_factory.mktemp("aot")
    return _export(str(root / "f32"))


def _copy(art, tmp_path):
    d = str(tmp_path / "m")
    shutil.copytree(art[0], d)
    return d


def _fallbacks_loads():
    return (_counter("paddle_deploy_aot_fallbacks_total"),
            _counter("paddle_deploy_aot_loads_total"))


def _bucket_compiles():
    fam = metrics.REGISTRY._families["paddle_serving_bucket_compiles_total"]
    return sum(c.value for c in fam.children().values())


def test_export_compiled_writes_verified_index(art):
    d = art[0]
    index = deploy.load_compiled_index(d)
    assert set(index["buckets"]) == {"2", "4"}
    assert index["env"] == cc.env_fingerprint(torch.device("cpu"))
    assert index["env"]["runtime"] == "torch"
    assert index["feed_names"] == ["x"] and len(index["fetch_names"]) == 1
    for entry in index["buckets"].values():
        blob = deploy.read_compiled_blob(d, entry)
        assert cc.sha256_bytes(blob) == entry["sha256"]
        assert len(blob) == entry["nbytes"] and len(entry["digest"]) == 64
    assert port_io.verify_model_artifact(d, skip_compiled=False) == \
        (True, "ok")


def test_cold_start_primes_every_bucket_of_every_replica(art):
    d, feed, want = art
    f0, l0 = _fallbacks_loads()
    c0 = _bucket_compiles()
    eng = ServingEngine(d, buckets=(2, 4), replicas=2, device="cpu")
    assert _fallbacks_loads() == (f0, l0 + 4)
    assert _bucket_compiles() == c0
    for rep in eng.replicas:
        entries = list(rep.exe._cache.values())
        assert len(entries) == 2 and all(e.aot is not None for e in entries)
    plain = ServingEngine(d, buckets=(2, 4), device="cpu",
                          use_exported=False)
    assert _fallbacks_loads() == (f0, l0 + 4)
    for n in (1, 2, 3, 4):
        got, = eng.run({"x": feed[:n]})
        ref, = plain.run({"x": feed[:n]})
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_allclose(got, want[:n], rtol=1e-5, atol=1e-6)
    assert metrics.REGISTRY.gauge(
        "paddle_deploy_cold_start_seconds").value > 0.0
    eng.close()
    plain.close()


def _engine_falls_back(d, feed, want, n_fallbacks):
    f0, l0 = _fallbacks_loads()
    eng = ServingEngine(d, buckets=(4,), device="cpu")
    assert _fallbacks_loads() == (f0 + n_fallbacks, l0)
    got, = eng.run({"x": feed[:3]})
    np.testing.assert_allclose(got, want[:3], rtol=1e-5, atol=1e-6)
    eng.close()


def test_corrupt_blob_degrades_to_the_program(art, tmp_path):
    d = _copy(art, tmp_path)
    fname = deploy.load_compiled_index(d)["buckets"]["4"]["file"]
    with open(os.path.join(d, "compiled", fname), "wb") as f:
        f.write(b"garbage")
    _engine_falls_back(d, art[1], art[2], 1)


@pytest.mark.parametrize("edit", ["digest", "no-digest", "env"])
def test_index_skew_degrades_to_the_program(art, tmp_path, edit):
    d = _copy(art, tmp_path)
    index = deploy.load_compiled_index(d)
    if edit == "digest":
        index["buckets"]["4"]["digest"] = "0" * 64
    elif edit == "no-digest":
        del index["buckets"]["4"]["digest"]
    else:
        index["env"]["torch"] = "0.0.0-somebody-elses"
    with open(os.path.join(d, "compiled", "index.json"), "w") as f:
        json.dump(index, f)
    port_io.write_artifact_manifest(d)
    _engine_falls_back(d, art[1], art[2], 1)


def test_use_exported_false_and_reexport(art, tmp_path):
    d = _copy(art, tmp_path)
    f0, l0 = _fallbacks_loads()
    eng = ServingEngine(d, buckets=(4,), device="cpu", use_exported=False)
    assert _fallbacks_loads() == (f0, l0)
    eng.close()
    # a re-export without AOT drops the stale compiled/ members
    d, feed, want = _export(d, export_compiled=False)
    assert not os.path.isdir(os.path.join(d, "compiled"))
    assert deploy.load_compiled_index(d) is None
    assert port_io.verify_model_artifact(d, skip_compiled=False) == \
        (True, "ok")


def test_merged_artifact_serves_embedded_aot(art, tmp_path):
    d, feed, want = art
    merged = merge_model.merge_inference_model(d, str(tmp_path / "m.ptpu"))
    out = merge_model.unpack_merged_model(merged)
    assert os.path.exists(os.path.join(out, "compiled", "index.json"))
    shutil.rmtree(out)
    f0, l0 = _fallbacks_loads()
    eng = ServingEngine(merged, buckets=(4,), device="cpu")
    assert _fallbacks_loads() == (f0, l0 + 1)
    got, = eng.run({"x": feed[:3]})
    np.testing.assert_allclose(got, want[:3], rtol=1e-5, atol=1e-6)
    unpacked = eng._unpacked_dir
    assert unpacked and os.path.isdir(unpacked)
    eng.close()
    assert not os.path.exists(unpacked)


def test_int8_artifact_exports_as_the_int8_engine_serves(tmp_path):
    port_config.set_flags(serving_quant_compute=True)
    d, feed, _ = _export(str(tmp_path / "int8"), quantize="int8",
                         buckets=(4,))
    index = deploy.load_compiled_index(d)
    blob = deploy.read_compiled_blob(d, index["buckets"]["4"])
    ep = cc.deserialize_compiled(blob)
    assert any("int8_matmul" in str(n.target) for n in ep.graph.nodes)
    f0, l0 = _fallbacks_loads()
    eng = ServingEngine(d, buckets=(4,), device="cpu")
    assert _fallbacks_loads() == (f0, l0 + 1)
    got, = eng.run({"x": feed[:3]})
    plain = ServingEngine(d, buckets=(4,), device="cpu", use_exported=False)
    np.testing.assert_array_equal(got, plain.run({"x": feed[:3]})[0])
    eng.close()
    plain.close()


def test_reference_engine_falls_back_on_a_port_artifact(art):
    """The reference's engine given the port's ``compiled/`` artifact:
    every bucket of every replica is a counted fallback (its
    deserializer refuses the blob, or its device gate the replica), and
    it serves the program within the engine tests' tolerance."""
    d, feed, want = art

    def val(name):
        return ref_metrics.REGISTRY.counter(name).value
    f0 = val("paddle_deploy_aot_fallbacks_total")
    l0 = val("paddle_deploy_aot_loads_total")
    eng = RefEngine(d, buckets=(2, 4), replicas=2)
    assert val("paddle_deploy_aot_fallbacks_total") == f0 + 4
    assert val("paddle_deploy_aot_loads_total") == l0
    got, = eng.run({"x": feed[:3]})
    eng.close()
    np.testing.assert_allclose(got, want[:3], rtol=1e-5, atol=1e-6)
