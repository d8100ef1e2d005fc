"""The port's narrow-wire ingest (``paddle_tpu_torch/core/ingest.py``, the
executor's ingest prologue and packed feed, ``layers.data``'s wire
arguments) against the reference's, on the CPU.

Packed layouts and buffers are byte-equal to the reference's, unpacked
feeds and ``scale`` widening equal to the bit; with ``mean``/``std`` the
port is bitwise the reference's ``widen`` run op by op, and the
reference's compiled prologue (XLA on the CPU) contracts ``x * s - m``
into one FMA and divides by ``std`` as a multiply by ``f32(1 / std)``
(the test models it bit for bit), where torch rounds the product, the
difference and the quotient: there each element is held within those
roundings, an ulp of ``x * s`` (divided by ``std``) plus three ulp of
the result. A small ResNet program run from a packed uint8 batch
is bitwise the same program run from the batch widened on the host, and
within the program-path tolerance (``test_torch_program_resnet.py``,
1e-4) of the reference's run of the same packed batch.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as ptpu
from paddle_tpu import layers as ref_layers
from paddle_tpu.core import ingest as ref_ingest
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.core import ingest
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.models import resnet as port_resnet
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SCALE = 1.0 / 255.0
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
F32_RTOL = 1e-4
RES, BATCH, LR = 16, 4, 0.01


def _multi_feed(batch=8, seed=0):
    rs = np.random.RandomState(seed)
    return {"img": rs.randint(0, 256, (batch, 3, 5, 7)).astype("uint8"),
            "ids": rs.randint(0, 1000, (batch, 11)).astype("int32"),
            "lbl": rs.randint(0, 10, (batch, 1)).astype("int64"),
            "x": rs.randn(batch, 13).astype("float32"),
            "h": rs.randn(batch, 3).astype("float16")}


def _triple(pkg, batch=6, nnz=17, seed=2):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 100, nnz).astype("int64")
    cuts = np.sort(rs.randint(0, nnz, batch - 1))
    offsets = np.concatenate([[0], cuts, [nnz]]).astype("int64")
    values = rs.randn(nnz).astype("float32")
    return pkg.SparseTriple(ids, offsets, values)


def _zeros(n):
    # padding bytes between slots are left as the block had them: start
    # both packers from zeros so the whole block compares
    return np.zeros(n, np.uint8), None


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


FEEDS = {
    "dense": lambda pkg: _multi_feed(),
    "sparse": lambda pkg: {"x": np.random.RandomState(0).randn(6, 4)
                           .astype("float32"), "bag": _triple(pkg)},
    "one": lambda pkg: {"img": np.arange(24, dtype=np.uint8)
                        .reshape(2, 3, 4)},
}


@pytest.mark.parametrize("kind,shards", [("dense", 1), ("dense", 2),
                                         ("dense", 4), ("sparse", 1),
                                         ("one", 1)])
def test_plan_layout_and_pack_feed_equal_the_reference(kind, shards):
    ref = ref_ingest.plan_layout(FEEDS[kind](ref_ingest), shards)
    got = ingest.plan_layout(FEEDS[kind](ingest), shards)
    assert [tuple(s) for s in got[1]] == [tuple(s) for s in ref[1]]
    assert got[2:] == ref[2:]
    for slot in got[1]:
        assert slot.offset % 64 == 0
    rpb, _ = ref_ingest.pack_feed(FEEDS[kind](ref_ingest), shards,
                                  alloc=_zeros)
    pb, _ = ingest.pack_feed(FEEDS[kind](ingest), shards, alloc=_zeros)
    assert pb.buffer.shape == rpb.buffer.shape
    assert pb.buffer.tobytes() == rpb.buffer.tobytes()
    assert (pb.batch_size, pb.shards, pb.shard_nbytes, pb.nbytes) == \
        (rpb.batch_size, rpb.shards, rpb.shard_nbytes, rpb.nbytes)
    assert [tuple(s) for s in pb.signature()[0]] == \
        [tuple(s) for s in rpb.signature()[0]]
    assert pb.signature()[1:] == rpb.signature()[1:]


@pytest.mark.parametrize("kind,shards", [("dense", 1), ("dense", 4),
                                         ("sparse", 1)])
def test_unpack_equals_the_reference_to_the_bit(kind, shards):
    pb, _ = ingest.pack_feed(FEEDS[kind](ingest), shards, alloc=_zeros)
    got = ingest.unpack(torch.from_numpy(pb.buffer.copy()), pb.layout)
    want = ref_ingest.unpack(jnp.asarray(pb.buffer), pb.layout)
    assert sorted(got) == sorted(want)
    for name in want:
        w = np.asarray(want[name])
        g = got[name].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


def test_unpack_views_the_buffer_without_a_copy():
    pb, _ = ingest.pack_feed(_multi_feed())
    buf = torch.from_numpy(pb.buffer)
    out = ingest.unpack(buf, pb.layout)
    for t in out.values():
        assert t.untyped_storage().data_ptr() == \
            buf.untyped_storage().data_ptr()


def test_int64_crosses_the_wire_as_int32():
    feed = {"lbl": np.array([[2 ** 31 - 1], [-5]], np.int64),
            "w": np.array([1.5, 2.5], np.float64)}
    pb, _ = ingest.pack_feed(feed)
    slots = {s.name: s for s in pb.layout}
    assert slots["lbl"].dtype == "int32" and slots["lbl"].nbytes == 8
    assert slots["w"].dtype == "float32"
    out = ingest.unpack(torch.from_numpy(pb.buffer), pb.layout)
    assert out["lbl"].dtype == torch.int32
    np.testing.assert_array_equal(out["lbl"].numpy(), feed["lbl"])
    rpb, _ = ref_ingest.pack_feed(feed)
    assert [tuple(s) for s in pb.layout] == [tuple(s) for s in rpb.layout]


def test_unpackable_batches_are_refused_as_the_reference_refuses():
    rs = np.random.RandomState(0)
    for feed, shards in (({"a": rs.randn(4, 3), "b": rs.randn(5, 3)}, 1),
                         ({"a": rs.randn(6, 3)}, 4), ({}, 1),
                         ({"a": np.zeros((0, 3))}, 1)):
        assert ingest.pack_feed(feed, shards) is None
        assert ref_ingest.pack_feed(feed, shards) is None
    feed = {"x": np.zeros((8, 2), "float32"),
            "bag": _triple(ingest, batch=8)}
    assert ingest.plan_layout(feed, shards=2) is None


def test_explode_sparse_equals_the_reference():
    feed = {"x": np.ones((2, 2), "float32")}
    assert ingest.explode_sparse(feed) is feed
    got = ingest.explode_sparse({"bag": _triple(ingest, batch=2, nnz=5),
                                 "x": np.ones((2, 2), "float32")})
    want = ref_ingest.explode_sparse({"bag": _triple(ref_ingest, batch=2,
                                                     nnz=5),
                                      "x": np.ones((2, 2), "float32")})
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name])
    assert got["bag"].shape == (64,) and (got["bag"][5:] == 0).all()


@pytest.mark.parametrize("scale", [SCALE, 0.5, (0.1, 0.2, 0.3)])
def test_widen_by_scale_is_bitwise_the_reference(scale):
    u8 = np.random.RandomState(1).randint(0, 256, (4, 3, 5, 6)) \
        .astype(np.uint8)
    got = ingest.widen(torch.from_numpy(u8), "float32", scale=scale)
    eager = np.asarray(ref_ingest.widen(jnp.asarray(u8), "float32",
                                        scale=scale))
    jitted = np.asarray(jax.jit(lambda x: ref_ingest.widen(
        x, "float32", scale=scale))(jnp.asarray(u8)))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == eager.tobytes() == jitted.tobytes()


def _channels(v):
    v = np.asarray(v, np.float32)
    return v.reshape(1, -1, 1, 1) if v.ndim else v


def _compiled(u8, kw):
    """XLA's prologue on the CPU: fma(x, scale, -mean) rounded once, then
    times f32(1 / std)."""
    scale = np.float64(np.float32(kw.get("scale", 1.0)))
    fma = (u8.astype(np.float64) * scale
           - _channels(kw.get("mean", 0.0)).astype(np.float64)) \
        .astype(np.float32)
    if "std" not in kw:
        return fma
    return fma * (np.float32(1.0) / _channels(kw["std"]))


def _roundings(u8, kw, out):
    """Per element: an ulp of the product x * scale (what the FMA saves
    rounding) carried through the division by std, and three ulp of the
    result ``out`` (the difference's rounding, the reciprocal's and the
    last one)."""
    x = u8.astype(np.float32) * np.float32(kw.get("scale", 1.0))
    std = _channels(kw.get("std", 1.0))
    return np.spacing(np.abs(x)) / std + 3 * np.spacing(np.abs(out))


@pytest.mark.parametrize("kw", [dict(mean=MEAN), dict(std=STD),
                                dict(scale=SCALE, mean=MEAN, std=STD),
                                dict(scale=SCALE, mean=0.5)])
def test_widen_with_mean_and_std_within_the_compiled_roundings(kw):
    u8 = np.random.RandomState(2).randint(0, 256, (4, 3, 5, 6)) \
        .astype(np.uint8)
    got = ingest.widen(torch.from_numpy(u8), "float32", **kw).numpy()
    eager = np.asarray(ref_ingest.widen(jnp.asarray(u8), "float32", **kw))
    jitted = np.asarray(jax.jit(lambda x: ref_ingest.widen(
        x, "float32", **kw))(jnp.asarray(u8)))
    # eager JAX rounds each op, as torch does
    assert got.tobytes() == eager.tobytes()
    if "scale" in kw:
        assert jitted.tobytes() == _compiled(u8, kw).tobytes()
    assert (np.abs(got - jitted) <= _roundings(u8, kw, jitted)).all()


def test_widen_casts_ids_and_leaves_the_wire_dtype():
    ids = torch.tensor([[3], [7]], dtype=torch.int32)
    assert ingest.widen(ids, "int32") is not None
    assert ingest.widen(ids, "int64").dtype == torch.int32  # demoted
    assert ingest.widen(ids, "float32").dtype == torch.float32
    assert ingest.canon_norm(None) is None
    assert ingest.canon_norm(2) == ref_ingest.canon_norm(2) == 2.0
    assert ingest.canon_norm(MEAN) == ref_ingest.canon_norm(MEAN)


def test_layers_data_wire_arguments_as_the_reference():
    got, want = {}, {}
    for pkg, layers, fw, out in ((None, port_layers, pc, got),
                                 (1, ref_layers, ptpu, want)):
        main = fw.Program()
        with fw.program_guard(main, fw.Program()):
            img = layers.data("img", shape=[3, 4, 4], wire_dtype="uint8",
                              scale=SCALE, mean=MEAN, std=STD)
            lbl = layers.data("lbl", shape=[1], dtype="int64",
                              wire_dtype="int32")
            plain = layers.data("x", shape=[2])
        out.update(img=(str(img.wire_dtype), img.ingest),
                   lbl=(str(lbl.wire_dtype), lbl.ingest),
                   x=(plain.wire_dtype, plain.ingest), main=main)
    for k in ("img", "lbl", "x"):
        assert got[k] == want[k], k
    # the wire fields are not serialized: the program's JSON is the
    # reference's, both ways
    port_json = json.dumps(port_ser.program_to_dict(got["main"]),
                           sort_keys=True)
    ref_json = json.dumps(ref_ser.program_to_dict(want["main"]),
                          sort_keys=True)
    assert port_json == ref_json


def _build(pkg):
    ref = pkg == "ref"
    fw = ptpu if ref else pc
    layers = ref_layers if ref else port_layers
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 0
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        img = layers.data("img", shape=[3, RES, RES], wire_dtype="uint8",
                          scale=SCALE)
        label = layers.data("label", shape=[1], dtype="int64",
                            wire_dtype="int32")
        if ref:
            loss = ref_resnet.resnet_cifar10(img, label, depth=8)[0]
            ptpu.optimizer.Momentum(LR, 0.9).minimize(loss, startup)
        else:
            loss = port_resnet.resnet_cifar10(img, label, depth=8)[0]
            port_opt.Momentum(LR, 0.9).minimize(loss, startup)
    return main, startup, loss.name


def _batches():
    rs = np.random.RandomState(7)
    return [{"img": rs.randint(0, 256, (BATCH, 3, RES, RES))
             .astype(np.uint8),
             "label": rs.randint(0, 10, (BATCH, 1)).astype(np.int32)}
            for _ in range(2)]


@pytest.fixture(scope="module")
def reference_packed():
    """The reference's startup scope and its losses over two packed
    batches."""
    main, startup, loss = _build("ref")
    scope = ptpu.Scope()
    exe = ptpu.Executor()
    with ptpu.scope_guard(scope):
        exe.run(startup)
        init = {n: np.array(scope.find_var(n)) for n in scope.var_names()}
        losses = [float(exe.run(main, feed=ref_ingest.pack_feed(b)[0],
                                fetch_list=[loss])[0])
                  for b in _batches()]
    return init, losses


def _port_run(init, feeds):
    main, _, loss = _build("port")
    scope = port_io.scope_from_jax(init, device="cpu")
    exe = pc.Executor(device="cpu")
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in feeds]
    return losses, {n: v.clone() for n, v in scope.items()}


def test_executor_packed_batch_equals_the_widened_feed_and_the_reference(
        reference_packed):
    init, ref_losses = reference_packed
    packed = [ingest.pack_feed(b)[0] for b in _batches()]
    wire = [dict(b) for b in _batches()]
    host = [{"img": b["img"].astype(np.float32) * np.float32(SCALE),
             "label": b["label"].astype(np.int64)} for b in _batches()]
    p_losses, p_state = _port_run(init, packed)
    w_losses, w_state = _port_run(init, wire)
    h_losses, h_state = _port_run(init, host)
    assert p_losses == w_losses == h_losses
    for name in h_state:
        assert torch.equal(p_state[name], h_state[name]), name
        assert torch.equal(w_state[name], h_state[name]), name
    for got, want in zip(p_losses, ref_losses):
        assert abs(got - want) <= F32_RTOL * abs(want)


def test_executor_consumes_a_staged_buffer():
    main, startup = pc.Program(), pc.Program()
    with pc.unique_name.guard(), pc.program_guard(main, startup):
        img = port_layers.data("img", shape=[3], wire_dtype="uint8",
                               scale=0.5, mean=1.0)
        ids = port_layers.data("ids", shape=[2], dtype="int64",
                               wire_dtype="int32")
        out = port_layers.reduce_sum(img)
    exe = pc.Executor(device="cpu")
    feed = {"img": np.array([[2, 4, 6], [8, 10, 12]], np.uint8),
            "ids": np.array([[1, 2], [3, 4]], np.int32)}
    pb, _ = ingest.pack_feed(feed)
    host, = exe.run(main, feed=pb, fetch_list=[out, ], scope=pc.Scope())
    # a host (numpy) buffer stays; a staged tensor buffer is consumed
    assert pb.buffer is not None
    staged = ingest.pack_feed(feed)[0]
    staged.buffer = torch.from_numpy(staged.buffer.copy())
    got, got_ids = exe.run(main, feed=staged, fetch_list=[out, ids],
                           scope=pc.Scope())
    assert staged.buffer is None
    assert float(got) == float(host) == float(
        (feed["img"].astype(np.float32) * 0.5 - 1.0).sum())
    assert got_ids.dtype == np.int32
    np.testing.assert_array_equal(got_ids, feed["ids"])
    with pytest.raises(RuntimeError, match="consumed"):
        exe.run(main, feed=staged, fetch_list=[out], scope=pc.Scope())


def test_executor_widens_a_wire_dict_feed_and_passes_a_widened_one():
    main, startup = pc.Program(), pc.Program()
    with pc.unique_name.guard(), pc.program_guard(main, startup):
        img = port_layers.data("img", shape=[3], wire_dtype="uint8",
                               scale=SCALE, mean=MEAN[0])
        out = port_layers.mean(img)
    exe = pc.Executor(device="cpu")
    u8 = np.array([[0, 128, 255]], np.uint8)
    wire, = exe.run(main, feed={"img": u8}, fetch_list=[out, ])
    want = (u8.astype(np.float32) * np.float32(SCALE)
            - np.float32(MEAN[0])).mean()
    assert abs(float(wire) - float(want)) <= 1e-7
    # an already-widened feed takes the plain path: no normalize
    widened, = exe.run(main, feed={"img": u8.astype(np.float32)},
                       fetch_list=[out])
    assert float(widened) == float(u8.astype(np.float32).mean())
    with pytest.raises(TypeError, match="PackedBatch"):
        exe.run(main, feed=[u8], fetch_list=[out])


def test_packed_feeds_flag_matches_the_reference():
    assert port_config.get_flag("packed_feeds") is \
        ptpu.config.get_flag("packed_feeds") is False
