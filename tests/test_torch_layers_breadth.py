"""The front end of the LeNet-5/MNIST slice: every layer function whose
op types the slice ports (``layers/{nn,tensor,ops}.py``), the
``nets.py`` composites and ``NumpyArrayInitializer``, called alike in
both packages, build programs that serialize byte for byte as the
reference's (startup included); run by each package's executor from the
same startup, the fetched outputs agree within 1e-5 of their
magnitude (float32, sums in other orders; transcendentals within a few
ulp) and the integer ones exactly."""

import json

import numpy as np
import pytest

import paddle_tpu as ptpu
from paddle_tpu import initializer as ref_init
from paddle_tpu import layers as ref_layers
from paddle_tpu import nets as ref_nets
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import nets as port_nets
from paddle_tpu_torch.core import serialization as port_ser
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-5

_UNARY = ("sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink",
          "softshrink", "abs", "ceil", "floor", "round", "square",
          "softplus", "softsign", "brelu", "leaky_relu", "soft_relu", "elu",
          "relu6", "stanh", "hard_shrink", "thresholded_relu",
          "hard_sigmoid", "swish", "silu", "sign")


def _build(pkg):
    """(main, startup, {name: fetched variable}) of one program calling
    every layer of the slice."""
    fw, L, nets, init, param_attr = (
        (ptpu, ref_layers, ref_nets, ref_init, ptpu.ParamAttr)
        if pkg == "ref" else
        (pc, port_layers, port_nets, port_init, None))
    if param_attr is None:
        from paddle_tpu_torch.param_attr import ParamAttr as param_attr
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 11
    outs = {}
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        img = L.data("img", shape=[3, 8, 8])
        vol = L.data("vol", shape=[2, 4, 4, 4])
        vec = L.data("vec", shape=[6])
        pos = L.data("pos", shape=[6])
        lab = L.data("lab", shape=[1], dtype="int64")
        seq = L.data("seq", shape=[5, 6])
        bin_lab = L.data("binlab", shape=[1])
        filt = L.data("filt", shape=[4, 3, 3, 3])
        for name in _UNARY:
            outs[name] = getattr(L, name)(vec)
        outs["sqrt"] = L.sqrt(pos)
        outs["log"] = L.log(pos)
        outs["reciprocal"] = L.reciprocal(pos)
        outs["pow"] = L.pow(pos, factor=1.5)
        outs["scale"] = L.scale(vec, scale=2.0, bias=0.5)
        outs["prelu"] = L.prelu(img, mode="channel")
        for op in ("sub", "max", "min"):
            outs["ew_" + op] = getattr(L, "elementwise_" + op)(vec, pos)
        outs["ew_pow"] = L.elementwise_pow(pos, vec)
        for r in ("mean", "max", "min", "prod"):
            outs["reduce_" + r] = getattr(L, "reduce_" + r)(img, dim=[2, 3])
        outs["reduce_all"] = L.reduce_mean(vec)
        outs["clip"] = L.clip(vec, -0.5, 0.5)
        outs["clip_by_norm"] = L.clip_by_norm(vec, 1.0)
        outs["cos_sim"] = L.cos_sim(vec, pos)
        outs["bilinear"] = L.bilinear_tensor_product(vec, pos, 3)
        outs["fm"] = L.factorization_machine(vec, 4)
        outs["conv_t"] = L.conv2d_transpose(img, 4, 3, stride=2, padding=1)
        outs["conv3d"] = L.conv3d(vol, 3, 3, padding=1)
        outs["conv3d_t"] = L.conv3d_transpose(vol, 2, 2, stride=2)
        outs["batch_conv"] = L.batch_conv2d(img, filt, padding=1)
        outs["pool3d"] = L.pool3d(vol, 2, "avg", 2)
        outs["lrn"] = L.lrn(img, n=3)
        outs["maxout"] = L.maxout(L.conv2d(img, 4, 1), groups=2)
        outs["l2n"] = L.l2_normalize(vec, axis=1)
        outs["im2seq"] = L.im2sequence(img, filter_size=3, stride=2)
        outs["spp"] = L.spp(img, pyramid_height=2)
        outs["row_conv"] = L.row_conv(seq, 2)
        outs["conv_shift"] = L.conv_shift(vec, L.slice(pos, [1], [0], [3]))
        outs["one_hot"] = L.one_hot(lab, 10)
        outs["xent"] = L.cross_entropy(L.softmax(L.fc(vec, 10)), lab)
        outs["sig_xent"] = L.sigmoid_cross_entropy_with_logits(
            L.fc(vec, 1), bin_lab)
        outs["sq_err"] = L.square_error_cost(L.fc(vec, 1), bin_lab)
        outs["smooth_l1"] = L.smooth_l1(vec, pos, sigma=2.0)
        prob = L.sigmoid(L.fc(vec, 1))
        outs["log_loss"] = L.log_loss(prob, bin_lab)
        outs["huber"] = L.huber_loss(L.fc(vec, 1), bin_lab, delta=0.5)
        outs["hinge"] = L.hinge_loss(L.fc(vec, 1), bin_lab)
        outs["rank"] = L.rank_loss(bin_lab, L.fc(vec, 1), L.fc(pos, 1))
        outs["margin_rank"] = L.margin_rank_loss(
            L.scale(bin_lab, scale=2.0, bias=-1.0), L.fc(vec, 1),
            L.fc(pos, 1))
        outs["hsigmoid"] = L.hsigmoid(vec, lab, 10)
        outs["nce"] = L.nce(vec, lab, 10, num_neg_samples=4)
        outs["auc"] = L.auc(L.softmax(L.fc(vec, 2)), lab)
        outs["topk"] = L.topk(vec, k=2)[1]
        attn = nets.scaled_dot_product_attention(seq, seq, seq)
        outs["sdpa"] = attn
        outs["glu"] = nets.glu(vec, dim=1)
        outs["conv_group"] = nets.img_conv_group(
            img, [4, 4], 2, conv_act="relu", conv_with_batchnorm=[True,
                                                                 False],
            pool_stride=2)
        outs["conv_pool"] = nets.simple_img_conv_pool(
            img, 4, 3, 2, 2, act="relu")
        # tensor layers
        outs["cast"] = L.cast(vec, "int32")
        outs["concat"] = L.concat([vec, pos], axis=1)
        outs["sums"] = L.sums([vec, pos, vec])
        outs["assign"] = L.assign(vec)
        outs["fill_bs"] = L.fill_constant_batch_size_like(vec, [-1, 3],
                                                          "float32", 1.5)
        outs["ones"] = L.ones([2, 3])
        outs["zeros"] = L.zeros([4], dtype="int64")
        outs["flip"] = L.flip(img, 2)
        a, b = L.split(vec, [2, 4], dim=1)
        outs["split_a"], outs["split_b"] = a, b
        outs["expand"] = L.expand(vec, [1, 2])
        outs["scatter"] = L.scatter(L.ones([6, 6]), L.cast(
            L.argmin(pos, axis=1), "int64"), vec)
        outs["pad"] = L.pad(vec, [0, 0, 1, 2], pad_value=-1.0)
        outs["crop"] = L.crop(img, [0, 1, 2, 2], [-1, 2, 4, 4])
        outs["argmin"] = L.argmin(vec, axis=1)
        outs["stack"] = L.stack([vec, pos], axis=1)
        outs["shape"] = L.shape(img)
        counter = L.fill_constant([1], "float32", 3.0)
        outs["increment"] = L.increment(counter, 2.0, in_place=False)
        outs["multiplex"] = L.multiplex([vec, pos], L.cast(
            L.argmin(L.concat([L.slice(vec, [1], [0], [1]),
                               L.slice(pos, [1], [0], [1])], axis=1),
                     axis=1), "int64"))
        w = L.fc(vec, 2, param_attr=param_attr(
            initializer=init.NumpyArrayInitializer(
                np.arange(12, dtype=np.float32).reshape(6, 2) / 10.0)))
        outs["numpy_init"] = w
    return main, startup, outs


def _feed():
    rs = np.random.RandomState(3)
    return {"img": rs.randn(2, 3, 8, 8).astype(np.float32),
            "vol": rs.randn(2, 2, 4, 4, 4).astype(np.float32),
            "vec": rs.randn(2, 6).astype(np.float32),
            "pos": rs.uniform(0.2, 2.0, (2, 6)).astype(np.float32),
            "lab": rs.randint(0, 10, (2, 1)).astype(np.int64),
            "seq": rs.randn(2, 5, 6).astype(np.float32),
            "binlab": rs.randint(0, 2, (2, 1)).astype(np.float32),
            "filt": rs.randn(2, 4, 3, 3, 3).astype(np.float32)}


@pytest.fixture(scope="module")
def built():
    return {pkg: _build(pkg) for pkg in ("ref", "port")}


@pytest.mark.parametrize("which", [0, 1], ids=["main", "startup"])
def test_programs_serialize_byte_identical(built, which):
    ref = json.dumps(ref_ser.program_to_dict(built["ref"][which]))
    port = json.dumps(port_ser.program_to_dict(built["port"][which]))
    assert port == ref


def test_outputs_match_reference(built):
    names = sorted(built["ref"][2])
    feed = _feed()
    ref_main, ref_startup, ref_outs = built["ref"]
    exe = ptpu.Executor()
    with ptpu.scope_guard(ptpu.Scope()):
        exe.run(ref_startup)
        want = exe.run(ref_main, feed=feed,
                       fetch_list=[ref_outs[n] for n in names])
    main, startup, outs = built["port"]
    pexe, scope = pc.Executor(device="cpu"), pc.Scope()
    pexe.run(startup, scope=scope)
    got = pexe.run(main, feed=feed, fetch_list=[outs[n] for n in names],
                   scope=scope)
    for n, g, w in zip(names, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (n, g.dtype,
                                                           w.dtype)
        if np.issubdtype(w.dtype, np.floating):
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= RTOL * scale, n
        else:
            np.testing.assert_array_equal(g, w, err_msg=n)


def _scope_copy(scope):
    out = pc.Scope()
    for n, v in scope.items():
        out.set_var(n, v.clone())
    return out


def test_forward_exports_and_runs_equal(built, monkeypatch):
    """The program of every layer exports through ``torch.export``
    (``Executor.lower``, serialized and loaded back, as the compile
    cache stores a forward step) and the loaded program's outputs equal
    the op-by-op run's from the same state, the RNG key included."""
    from paddle_tpu_torch.core import compile_cache as cc
    main, startup, outs = built["port"]
    names = sorted(outs)
    fetch = [outs[n] for n in names]
    feed = _feed()
    exe, init = pc.Executor(device="cpu"), pc.Scope()
    exe.run(startup, scope=init)
    want = exe.run(main, feed=feed, fetch_list=fetch,
                   scope=_scope_copy(init))
    scope = _scope_copy(init)
    blob = cc.serialize_compiled(exe.lower(main, feed=feed,
                                           fetch_list=fetch, scope=scope))
    aot = pc.Executor(device="cpu")
    aot.prime_aot(main, feed, fetch, scope, cc.deserialize_compiled(blob),
                  expect_digest=exe.cache_digest(main, feed=feed,
                                                 fetch_list=fetch,
                                                 scope=scope))
    # the loaded program runs, not the ops one by one
    from paddle_tpu_torch.core import executor
    monkeypatch.setattr(executor, "run_block", None)
    got = aot.run(main, feed=feed, fetch_list=fetch, scope=scope)
    for n, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g, w, err_msg=n)


def _arrays_and_recurrent_nets(pkg):
    """A program of the tensor-array layers (an index past the end
    clamped) and the recurrent ``nets.py`` composites."""
    fw, L, nets = (ptpu, ref_layers, ref_nets) if pkg == "ref" else \
        (pc, port_layers, port_nets)
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 2
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        x = L.data("x", shape=[2, 5, 3], append_batch_size=False)
        length = L.data("len", shape=[2], dtype="int64",
                        append_batch_size=False)
        arr = L.create_array(4, [2, 3])
        step = L.reshape(L.slice(x, [1], [1], [2]), [-1, 3])
        at = L.fill_constant([1], "int32", 9)
        arr = L.array_write(step, at, arr)
        outs = [arr, L.array_read(arr, at),
                nets.simple_lstm(x, 4, length=length),
                nets.bidirectional_gru(x, 3, length=length),
                nets.bidirectional_lstm(x, 2, length=length,
                                        return_concat=False)[1],
                nets.sequence_conv_pool(x, 4, 3, length=length)]
        proj = L.fc(x, 6, num_flatten_dims=2)
        state = L.fc(L.reshape(L.slice(x, [1], [0], [1]), [-1, 3]), 6)
        outs += list(nets.simple_attention(x, proj, state, length=length))
    return main, startup, outs


def test_tensor_array_layers_cite_their_item():
    """The tensor-array layers and the recurrent composites (which raised
    before the sequence ops were ported) build the reference's program
    and fetch its outputs from the same startup."""
    feed = {"x": np.random.RandomState(3).randn(2, 5, 3).astype(np.float32),
            "len": np.array([5, 2], np.int32)}
    main, startup, outs = _arrays_and_recurrent_nets("ref")
    pmain, pstartup, pouts = _arrays_and_recurrent_nets("port")
    for a, b in ((main, pmain), (startup, pstartup)):
        assert json.dumps(port_ser.program_to_dict(b)) == \
            json.dumps(ref_ser.program_to_dict(a))
    exe, scope = ptpu.Executor(), ptpu.Scope()
    exe.run(startup, scope=scope)
    want = exe.run(main, feed=feed, fetch_list=outs, scope=scope)
    pexe, pscope = pc.Executor(device="cpu"), pc.Scope()
    pexe.run(pstartup, scope=pscope)
    got = pexe.run(pmain, feed=feed, fetch_list=pouts, scope=pscope)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert float(np.abs(g - w).max()) <= \
            RTOL * max(float(np.abs(w).max()), 1e-30)
