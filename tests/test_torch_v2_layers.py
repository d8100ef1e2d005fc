"""The v2 layer DSL of the port (``paddle_tpu_torch/v2/layer.py``) against
the reference's (``paddle_tpu/v2/layer.py``), family by family as
``tests/test_v2_layers_full.py`` and the v2 parts of
``tests/test_sparse_float_input.py`` exercise them: dense and projection
layers with ``mixed``, image, detection, sequence, recurrent groups, beam
search, costs, misc, the review regressions and the sparse and
sub-sequence input types.

Each family builds one program in both packages (the same names), runs
the reference's startup initializers drawn in numpy (``numpy_startup``:
it skips the reference's startup compile), copies that scope, the RNG
key included, into the port's, and runs one step of each. Every output
of the family is a case of its own; each family is built and run once a
module. Tolerances: outputs within rtol 1e-5 and atol 1e-6 (f32 sums in
another order), a step's parameters within rtol 1e-5 and atol 1e-6,
integer outputs and random draws exact. The book-style scripts train
through ``SGD.train`` in both packages from one tar (``SGD.test`` runs
each package's startup, ``init_from_tar`` loads the reference's values
into the port): every step's cost within rtol 1e-4 (tens of steps of
f32 rounding apart).
"""

import io
import types

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
import paddle_tpu.v2 as ref_v2
from paddle_tpu import layers as ref_fl
from paddle_tpu.data_feeder import _pad_nested, _pad_sparse
import paddle_tpu_torch.v2 as port_v2
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import layers as port_fl
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.core import framework as port_framework
from paddle_tpu_torch.core import scope as port_scope
from paddle_tpu_torch.data_feeder import _pad_nested as port_pad_nested
from paddle_tpu_torch.data_feeder import _pad_sparse as port_pad_sparse

from test_torch_image_models import numpy_startup
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL, ATOL = 1e-5, 1e-6
SCRIPT_RTOL = 1e-4


def _ns(v2, fl, guard):
    return types.SimpleNamespace(v2=v2, L=v2.layer, act=v2.activation,
                                 pool=v2.pooling, dt=v2.data_type, fl=fl,
                                 guard=guard)


REF = _ns(ref_v2, ref_fl, ptpu.unique_name.guard)
PORT = _ns(port_v2, port_fl, pc.unique_name.guard)


@pytest.fixture(autouse=True)
def _port_defaults():
    """Fresh default programs and scope of the port for each test, as
    ``conftest.py`` gives the reference's, and the v2 device on the
    CPU."""
    prev_main = port_framework.switch_main_program(pc.Program())
    prev_startup = port_framework.switch_startup_program(pc.Program())
    prev_scope = port_scope._global_scope
    port_scope._global_scope = pc.Scope()
    port_v2.init(device="cpu")
    yield
    port_framework.switch_main_program(prev_main)
    port_framework.switch_startup_program(prev_startup)
    port_scope._global_scope = prev_scope


# -- the families: build(P) -> (fetches, feed) -----------------------------

def _dense_mixed(P):
    rs = np.random.RandomState(0)
    L, dt = P.L, P.dt
    xv = L.data("x", dt.dense_vector(8))
    iv = L.data("ids", dt.integer_value(10))
    m = L.mixed(8, input=[L.full_matrix_projection(xv),
                          L.table_projection(iv),
                          L.identity_projection(xv, offset=0, size=8)],
                act=P.act.Tanh())
    lbl = L.data("lbl", dt.integer_value(3))
    sm = L.fc(m, 3, act=P.act.Softmax())
    cost = L.classification_cost(sm, lbl)
    return [cost, m, sm], {
        "x": rs.randn(4, 8).astype("float32"),
        "ids": rs.randint(0, 10, (4, 1)).astype("int64"),
        "lbl": rs.randint(0, 3, (4, 1)).astype("int64")}


def _conv_operator(P):
    rs = np.random.RandomState(31)
    B, C, H, O, K = 2, 2, 5, 3, 3
    L, dt = P.L, P.dt
    iv = L.data("img", dt.dense_vector(C * H * H))
    fv = L.data("filt", dt.dense_vector(O * C * K * K))
    m = L.mixed(O * H * H, input=[L.conv_operator(
        iv, fv, filter_size=K, num_filters=O, num_channels=C, padding=1)],
        bias_attr=False)
    fgen = L.fc(iv, O * C * K * K, act=P.act.Tanh())
    m2 = L.mixed(O * H * H, input=[L.conv_operator(
        iv, fgen, filter_size=K, num_filters=O, num_channels=C,
        padding=1)], bias_attr=False)
    return [L.sum_cost(m2), m, m2], {
        "img": rs.randn(B, C * H * H).astype("float32"),
        "filt": (rs.randn(B, O * C * K * K) * 0.3).astype("float32")}


def _conv_operator_asym(P):
    rs = np.random.RandomState(32)
    B, C, H, W, O = 2, 1, 6, 7, 2
    KH, KW, SY, SX, PY, PX = 2, 3, 2, 1, 1, 0
    OH = (H + 2 * PY - KH) // SY + 1
    OW = (W + 2 * PX - KW) // SX + 1
    L, dt = P.L, P.dt
    iv = L.data("img", dt.dense_vector(C * H * W))
    fv = L.data("filt", dt.dense_vector(O * C * KH * KW))
    x4 = P.fl.reshape(iv, [-1, C, H, W])
    m = L.mixed(O * OH * OW, input=[L.conv_operator(
        x4, fv, filter_size=KW, num_filters=O, num_channels=C, stride=SX,
        padding=PX, filter_size_y=KH, stride_y=SY, padding_y=PY)],
        bias_attr=False)
    return [m], {"img": rs.randn(B, C * H * W).astype("float32"),
                 "filt": (rs.randn(B, O * C * KH * KW) * 0.5).astype(
                     "float32")}


def _projections(P):
    rs = np.random.RandomState(1)
    L = P.L
    xv = L.data("x", P.dt.dense_vector(8))
    return [L.mixed(4, input=[L.identity_projection(xv, offset=2, size=4)],
                    bias_attr=False),
            L.mixed(8, input=[L.slice_projection(xv, [(0, 4), (4, 8)])],
                    bias_attr=False),
            L.mixed(8, input=[L.scaling_projection(xv)], bias_attr=False),
            L.mixed(8, input=[L.dotmul_projection(xv)], bias_attr=False),
            L.mixed(8, input=[L.dotmul_operator(xv, xv, scale=2.0)],
                    bias_attr=False),
            L.mixed(6, input=[L.trans_full_matrix_projection(xv)],
                    bias_attr="trans_fm_b")], {
        "x": rs.randn(3, 8).astype("float32")}


def _elementwise(P):
    rs = np.random.RandomState(2)
    L, dt = P.L, P.dt
    xv = L.data("x", dt.dense_vector(5))
    yv = L.data("y", dt.dense_vector(5))
    wv = L.data("w", dt.dense_vector(1))
    return [L.addto([xv, yv]), L.interpolation([xv, yv], wv),
            L.scaling(xv, wv), L.slope_intercept(xv, 3.0, -1.0),
            L.dot_prod(xv, yv), L.cos_sim(xv, yv, scale=5),
            L.l2_distance(xv, yv), L.sum_to_one_norm(L.clip(xv, 0.1, 9.9)),
            L.row_l2_norm(yv), L.trans(xv), L.power(L.clip(xv, 0.1, 9.9),
                                                    wv),
            L.concat([xv, yv], act=P.act.Relu())], {
        "x": rs.randn(3, 5).astype("float32"),
        "y": rs.randn(3, 5).astype("float32"),
        "w": rs.rand(3, 1).astype("float32")}


def _image(P):
    rs = np.random.RandomState(3)
    L, pool = P.L, P.pool
    iv = L.data("img", P.dt.dense_vector(3 * 8 * 8))
    x = P.fl.reshape(iv, [-1, 3, 8, 8])
    c = L.img_conv(x, filter_size=3, num_filters=4, padding=1,
                   act=P.act.Relu())
    c = L.batch_norm(c, act=P.act.Relu())
    c = L.img_cmrnorm(c, size=3)
    p = L.img_pool(c, pool_size=2, stride=2, pool_type=pool.Max())
    pa = L.img_pool(c, pool_size=2, stride=2, pool_type=pool.Avg())
    mo = L.maxout(L.img_conv(x, 3, 4, padding=1), groups=2)
    sp = L.spp(c, pyramid_height=2)
    pd = L.pad(x, pad_c=[0, 1], pad_h=[1, 1], pad_w=[0, 0])
    cr = L.crop(pd, offset=[0, 0, 1, 0], shape=[-1, 3, 8, 8])
    bi = L.bilinear_interp(x, out_size_x=12, out_size_y=10)
    ro = L.rotate(iv, height=8, width=8 * 3)
    sw = L.switch_order(x, reshape_order=[0, 2, 3, 1])
    be = L.block_expand(x, block_x=4, block_y=4, stride_x=4, stride_y=4)
    bp = L.block_expand(x, block_x=3, block_y=3, padding_x=1,
                        padding_y=1)
    rz = L.resize(iv, size=16)
    ss = L.scale_shift(x)
    return [c, p, pa, mo, sp, pd, cr, bi, ro, sw, be, bp, rz, ss], {
        "img": rs.randn(2, 3 * 8 * 8).astype("float32")}


def _conv3d(P):
    rs = np.random.RandomState(4)
    L = P.L
    iv = L.data("vol", P.dt.dense_vector(2 * 4 * 4 * 4))
    x = P.fl.reshape(iv, [-1, 2, 4, 4, 4])
    c = L.img_conv3d(x, filter_size=3, num_filters=3, padding=1,
                     act=P.act.Relu())
    return [c, L.img_pool3d(c, pool_size=2, stride=2)], {
        "vol": rs.randn(1, 2 * 4 * 4 * 4).astype("float32")}


def _detection(P):
    rs = np.random.RandomState(5)
    fl, L = P.fl, P.L
    feat = fl.data("feat", shape=[4, 2, 2], append_batch_size=True)
    img = fl.data("img", shape=[3, 16, 16])
    pb, pv = L.priorbox(feat, img, min_size=[4.0], max_size=[8.0],
                        aspect_ratio=[2.0])
    rois = fl.data("rois", shape=[5], append_batch_size=True)
    x = fl.data("x", shape=[2, 8, 8])
    return [pb, pv, L.roi_pool(x, rois, pooled_width=2, pooled_height=2),
            L.cross_channel_norm(x)], {
        "feat": rs.randn(1, 4, 2, 2).astype("float32"),
        "img": rs.randn(1, 3, 16, 16).astype("float32"),
        "rois": np.array([[0, 0, 0, 7, 7]], "float32"),
        "x": rs.randn(1, 2, 8, 8).astype("float32")}


def _ssd_heads(P):
    rs = np.random.RandomState(21)
    fl, L = P.fl, P.L
    feat = fl.data("feat", shape=[4, 2, 2])
    img = fl.data("img", shape=[3, 16, 16])
    pb = L.priorbox(feat, img, min_size=[4.0], max_size=[8.0],
                    aspect_ratio=[2.0])
    n_priors = 2 * 2 * 4
    loc = fl.data("loc", shape=[n_priors, 4])
    conf = fl.data("conf", shape=[n_priors, 3])
    gt_box = fl.data("gt", shape=[2, 4])
    gt_lbl = fl.data("gl", shape=[2], dtype="int64")
    gt_cnt = fl.data("gc", shape=[], dtype="int64")
    loss, _, _ = L.multibox_loss(loc, conf, pb, gt_box, gt_lbl, gt_cnt,
                                 num_classes=3)
    det = L.detection_output(loc, fl.softmax(conf), pb, num_classes=3,
                             keep_top_k=4)
    return [loss, det], {
        "feat": rs.randn(1, 4, 2, 2).astype("float32"),
        "img": rs.randn(1, 3, 16, 16).astype("float32"),
        "loc": rs.randn(1, n_priors, 4).astype("float32") * .1,
        "conf": rs.randn(1, n_priors, 3).astype("float32"),
        "gt": np.array([[[.1, .1, .4, .4], [.5, .5, .9, .9]]], "float32"),
        "gl": np.array([[1, 2]], "int64"), "gc": np.array([2], "int64")}


def _seq_feed(rs, B=3, T=6, V=20):
    return (rs.randint(1, V, (B, T)).astype("int64"),
            np.array([T, T - 2, T - 3], dtype="int64"))


def _recurrent_pipeline(P):
    rs = np.random.RandomState(6)
    ids, lens = _seq_feed(rs)
    L, dt = P.L, P.dt
    tok = L.data("tok", dt.integer_value_sequence(20))
    lbl = L.data("lbl", dt.integer_value(2))
    emb = L.embedding(tok, 8)
    lg = L.lstmemory(L.fc(emb, 24), size=6)
    gg = L.grumemory(L.fc(emb, 18), size=6, reverse=True)
    pooled = L.pooling(lg, pooling_type=P.pool.Max())
    lastg, firstg = L.last_seq(gg), L.first_seq(gg)
    sm = L.fc(L.concat([pooled, lastg, firstg]), 2, act=P.act.Softmax())
    cost = L.classification_cost(sm, lbl)
    return [cost, pooled, lastg, firstg, lg, gg], {
        "tok": ids, "tok@len": lens,
        "lbl": rs.randint(0, 2, (3, 1)).astype("int64")}


def _recurrent_group(P):
    rs = np.random.RandomState(7)
    L = P.L
    xv = P.fl.data("x", shape=[5, 4])

    def step(x_t):
        prev = L.memory(size=3)
        h = L.fc([x_t, prev], 3, act=P.act.Tanh())
        L.update_memory(prev, h)
        return h
    return [L.recurrent_group(step, xv), L.recurrent(xv, act=P.act.Tanh()),
            L.recurrent(xv, reverse=True),
            L.mixed(12, input=[L.context_projection(xv, context_len=3)],
                    bias_attr=False)], {
        "x": rs.randn(2, 5, 4).astype("float32") * 0.3}


def _lstm_gru_steps(P):
    rs = np.random.RandomState(8)
    L = P.L
    xv = P.fl.data("x", shape=[4, 6])

    def step(x_t):
        cell = L.memory(size=5)
        return L.lstm_step(L.fc(x_t, 4 * 5, bias_attr=False), cell, size=5)

    def gstep(x_t):
        hid = L.memory(size=5)
        return L.gru_step(L.fc(x_t, 3 * 5, bias_attr=False), hid, size=5)
    return [L.recurrent_group(step, xv), L.recurrent_group(gstep, xv)], {
        "x": rs.randn(2, 4, 6).astype("float32") * 0.3}


def _seq_shape(P):
    rs = np.random.RandomState(9)
    ids, lens = _seq_feed(rs)
    L = P.L
    tok = L.data("tok", P.dt.integer_value_sequence(20))
    emb = L.embedding(tok, 6)
    return [L.seq_reshape(emb, reshape_size=12),
            L.seq_slice(emb, starts=1, ends=4),
            L.expand(L.pooling(emb, pooling_type=P.pool.Avg()), emb),
            L.kmax_seq_score(L.fc(emb, 1), beam_size=2),
            L.seq_concat(emb, emb),
            L.pooling(emb, pooling_type=P.pool.Sum()),
            L.lstmemory_group(emb, 4), L.gru_group(emb, 4, reverse=True),
            L.row_conv(emb, context_len=3, act=P.act.Relu())], {
        "tok": ids, "tok@len": lens}


def _maxid_eos_sampling(P):
    rs = np.random.RandomState(10)
    L = P.L
    xv = L.data("p", P.dt.dense_vector(7))
    return [L.maxid(xv), L.eos(xv, eos_id=3), L.sampling_id(xv)], {
        "p": np.abs(rs.rand(3, 7).astype("float32")) + 0.01}


def _beam_search(P):
    fl, L = P.fl, P.L
    anchor = fl.data("anchor", shape=[1], dtype="int64")

    def step(tok, ctx):
        emb = fl.embedding(tok, size=[12, 8], param_attr="gen_emb")
        return fl.fc(fl.fc(emb, 12, act="tanh"), 12)
    ids, lengths, scores = L.beam_search(
        step, input=[L.StaticInput(anchor)], bos_id=0, eos_id=1,
        beam_size=3, max_length=5)
    return [ids, lengths, scores], {"anchor": np.zeros((2, 1), "int64")}


def _beam_search_memory(P):
    rs = np.random.RandomState(23)
    fl, L = P.fl, P.L
    ctx = fl.data("ctx", shape=[6])

    def step(tok, ctx_state):
        h_prev = L.memory(size=6)
        emb = fl.embedding(tok, size=[10, 6], param_attr="bs_emb")
        h = fl.fc([emb, h_prev, ctx_state], 6, act="tanh")
        L.update_memory(h_prev, h)
        return fl.fc(h, 10)
    ids, lengths, scores = L.beam_search(
        step, input=[L.StaticInput(ctx)], bos_id=0, eos_id=1, beam_size=2,
        max_length=4)
    return [ids, lengths, scores], {"ctx": rs.randn(2, 6).astype("float32")}


def _costs(P):
    rs = np.random.RandomState(12)
    B, C = 4, 5
    probs = np.abs(rs.rand(B, C).astype("float32")) + 0.01
    L, dt = P.L, P.dt
    lv = L.data("logits", dt.dense_vector(C))
    pv = L.data("probs", dt.dense_vector(C))
    yv = L.data("lbl", dt.integer_value(C))
    mv = L.data("multi", dt.dense_vector(C))
    rv = L.data("reg", dt.dense_vector(3))
    tv = L.data("tgt", dt.dense_vector(3))
    bv = L.data("bin", dt.dense_vector(1))
    return [L.classification_cost(lv, yv), L.cross_entropy(pv, yv),
            L.cross_entropy_with_selfnorm(pv, yv),
            L.multi_binary_label_cross_entropy(pv, mv),
            L.regression_cost(rv, tv), L.square_error_cost(rv, tv),
            L.sum_cost(rv), L.huber_regression_cost(rv, tv),
            L.huber_classification_cost(L.fc(rv, 1, bias_attr=False), bv),
            L.smooth_l1_cost(rv, tv),
            L.rank_cost(L.fc(rv, 1), L.fc(tv, 1), bv)], {
        "logits": rs.randn(B, C).astype("float32"),
        "probs": probs / probs.sum(1, keepdims=True),
        "lbl": rs.randint(0, C, (B, 1)).astype("int64"),
        "multi": (rs.rand(B, C) > 0.5).astype("float32"),
        "reg": rs.randn(B, 3).astype("float32"),
        "tgt": rs.randn(B, 3).astype("float32"),
        "bin": np.sign(rs.randn(B, 1)).astype("float32")}


def _structured_costs(P):
    rs = np.random.RandomState(13)
    B, T, C = 2, 5, 4
    fl, L = P.fl, P.L
    ev = fl.data("em", shape=[T, C])
    tv = fl.data("tags", shape=[T], dtype="int64")
    ev._v2_length = fl.data("len", shape=[], dtype="int64")
    labels = fl.data("ctc_l", shape=[3], dtype="int64")
    ctc_logits = fl.fc(ev, C + 1, num_flatten_dims=2)
    llen = fl.data("llen", shape=[], dtype="int64")
    return [L.crf(ev, tv), L.crf_decoding(ev, param_attr="crf_w"),
            L.ctc(ctc_logits, labels, label_length=llen)], {
        "em": rs.randn(B, T, C).astype("float32"),
        "tags": rs.randint(0, C, (B, T)).astype("int64"),
        "len": np.array([T, T - 1], dtype="int64"),
        "ctc_l": rs.randint(1, C, (B, 3)).astype("int64"),
        "llen": np.array([3, 2], "int64")}


def _sampled_hier(P):
    rs = np.random.RandomState(14)
    L, dt = P.L, P.dt
    xv = L.data("x", dt.dense_vector(6))
    yv = L.data("y", dt.integer_value(10))
    return [L.hsigmoid(xv, yv, num_classes=10),
            L.nce(xv, yv, num_classes=10, num_neg_samples=3)], {
        "x": rs.randn(4, 6).astype("float32"),
        "y": rs.randint(0, 10, (4, 1)).astype("int64")}


def _misc(P):
    rs = np.random.RandomState(15)
    L, dt = P.L, P.dt
    av = L.data("a", dt.dense_vector(6))
    bv = L.data("b", dt.dense_vector(5))
    fv = L.data("f", dt.dense_vector(3))
    idx = L.data("idx", dt.integer_value(2))
    return [L.tensor(av, bv, size=4), L.selective_fc(av, 10),
            L.gated_unit(av, 7, act=P.act.Tanh()), L.conv_shift(av, fv),
            L.out_prod(av, bv), L.linear_comb(L.fc(av, 2), L.fc(av, 8),
                                              size=4),
            L.multiplex([idx, av, av]),
            L.factorization_machine(av, factor_size=3),
            L.dropout(av, 0.0), L.prelu(av), L.repeat(bv, 2),
            L.printer(fv)], {
        "a": rs.randn(3, 6).astype("float32"),
        "b": rs.randn(3, 5).astype("float32"),
        "f": rs.randn(3, 3).astype("float32"),
        "idx": np.zeros((3, 1), "int64")}


def _expand_ragged(P):
    rs = np.random.RandomState(20)
    L = P.L
    tok = L.data("tok", P.dt.integer_value_sequence(9))
    emb = L.embedding(tok, 3)
    return [L.expand(L.pooling(emb, pooling_type=P.pool.Avg()), emb)], {
        "tok": rs.randint(1, 9, (2, 4)).astype("int64"),
        "tok@len": np.array([4, 2], dtype="int64")}


def _switch_order(P):
    xv = P.fl.data("x", shape=[2, 3, 4])
    nhwc = P.L.switch_order(xv, reshape_order=[0, 2, 3, 1])
    return [nhwc, P.L.switch_order(nhwc, reshape_order=[0, 3, 1, 2])], {
        "x": np.arange(24, dtype="float32").reshape(1, 2, 3, 4)}


def _sub_nested_seq(P):
    rs = np.random.RandomState(22)
    xv = P.fl.data("x", shape=[3, 4, 5])
    sv = P.fl.data("sel", shape=[2], dtype="int64")
    out = P.L.sub_nested_seq(xv, sv)
    return [out[0] if isinstance(out, (list, tuple)) else out], {
        "x": rs.randn(2, 3, 4, 5).astype("float32"),
        "sel": np.array([[2, 0], [1, -1]], dtype="int64")}


def _sparse_float(P):
    DIM = 12
    rows = [[(1, 0.5), (7, -1.25)], [(0, 2.0)],
            [(3, 1.0), (4, 0.5), (11, -0.5)]]
    ids, vals = _pad_sparse(rows, 0)
    L = P.L
    xv = L.data("x", P.dt.sparse_float_vector(DIM))
    dv = L.data("d", P.dt.dense_vector(3))
    return [L.fc(xv, 4, bias_attr=False, param_attr="sparse_w"),
            L.fc([xv, dv], 4, act=P.act.Tanh()),
            L.mixed(5, input=[L.table_projection(xv)], bias_attr=False)], {
        "x": ids, "x@value": vals,
        "d": np.random.RandomState(40).randn(3, 3).astype("float32")}


def _sparse_float_sequence(P):
    DIM = 10
    seqs = [[[(1, 1.0)], [(2, 0.5), (3, 0.5)]], [[(4, 2.0)]]]
    ids, vals, lens = _pad_sparse(seqs, 1)
    L = P.L
    xv = L.data("x", P.dt.sparse_float_vector_sequence(DIM))
    h = L.fc(xv, 6, act=P.act.Tanh())
    return [h, L.pooling(h, pooling_type=P.pool.Sum()),
            L.pooling(h, pooling_type=P.pool.Avg())], {
        "x": ids, "x@value": vals, "x@len": lens}


def _sub_sequences(P):
    L, dt, pool = P.L, P.dt, P.pool
    docs = [[[1, 2, 3], [4, 5]], [[7, 8, 9, 10], [11], [6, 7]]]
    data, lens, subl = _pad_nested(docs, "int64")
    dense = [[[np.ones(3), np.zeros(3)], [np.ones(3) * 2]],
             [[np.ones(3) * 3]]]
    ddata, dlens, dsubl = _pad_nested(dense, "float32")
    sdocs = [[[[(1, 1.0)], [(2, 2.0)]], [[(3, 3.0)]]]]
    sids, svals, slens, ssubl = _pad_sparse(sdocs, 2)
    dv = L.data("docs", dt.integer_value_sub_sequence(12))
    emb = L.embedding(dv, 4, param_attr="nest_emb")
    sent = L.pooling(emb, pooling_type=pool.Avg())
    ddv = L.data("d", dt.dense_vector_sub_sequence(3))
    sv = L.data("s", dt.sparse_float_vector_sub_sequence(9))
    sh = L.fc(sv, 4, bias_attr=False)
    return [sent, L.pooling(sent, pooling_type=pool.Max()),
            L.pooling(ddv, pooling_type=pool.Sum()), sh,
            L.pooling(sh, pooling_type=pool.Sum())], {
        "docs": data, "docs@len": lens, "docs@sublen": subl,
        "d": ddata, "d@len": dlens, "d@sublen": dsubl,
        "s": sids, "s@value": svals, "s@len": slens, "s@sublen": ssubl}


# family -> (build, output names, the cost index a step trains on, or None)
FAMILIES = {
    "dense_mixed": (_dense_mixed, ["cost", "mixed", "softmax"], 0),
    "conv_operator": (_conv_operator, ["sum_cost", "data_filter",
                                       "layer_filter"], 0),
    "conv_operator_asym": (_conv_operator_asym, ["conv"], None),
    "projections": (_projections, ["identity", "slice", "scaling",
                                   "dotmul", "dotmul_operator",
                                   "trans_full_matrix"], None),
    "elementwise": (_elementwise, ["addto", "interpolation", "scaling",
                                   "slope_intercept", "dot_prod", "cos_sim",
                                   "l2_distance", "sum_to_one_norm",
                                   "row_l2_norm", "trans", "power",
                                   "concat"], None),
    "image": (_image, ["conv_bn_cmrnorm", "pool_max", "pool_avg", "maxout",
                       "spp", "pad", "crop", "bilinear_interp", "rotate",
                       "switch_order", "block_expand", "block_expand_pad",
                       "resize", "scale_shift"], None),
    "conv3d": (_conv3d, ["conv3d", "pool3d"], None),
    "detection": (_detection, ["priorbox", "variances", "roi_pool",
                               "cross_channel_norm"], None),
    "ssd_heads": (_ssd_heads, ["multibox_loss", "detection_output"], None),
    "recurrent_pipeline": (_recurrent_pipeline, [
        "cost", "pooled_lstm", "last_gru", "first_gru", "lstmemory",
        "grumemory"], 0),
    "recurrent_group": (_recurrent_group, ["group", "recurrent",
                                           "recurrent_reverse",
                                           "context_projection"], None),
    "lstm_gru_steps": (_lstm_gru_steps, ["lstm_step", "gru_step"], None),
    "seq_shape": (_seq_shape, ["seq_reshape", "seq_slice", "expand",
                               "kmax_seq_score", "seq_concat", "sum_pool",
                               "lstmemory_group", "gru_group", "row_conv"],
                  None),
    "maxid_eos_sampling": (_maxid_eos_sampling, ["maxid", "eos",
                                                 "sampling_id"], None),
    "beam_search": (_beam_search, ["ids", "lengths", "scores"], None),
    "beam_search_memory": (_beam_search_memory, ["ids", "lengths",
                                                 "scores"], None),
    "costs": (_costs, ["classification", "cross_entropy", "selfnorm",
                       "multi_binary", "regression", "square_error",
                       "sum", "huber_regression", "huber_classification",
                       "smooth_l1", "rank"], None),
    "structured_costs": (_structured_costs, ["crf", "crf_decoding",
                                             "ctc"], None),
    "sampled_hier": (_sampled_hier, ["hsigmoid", "nce"], None),
    "misc": (_misc, ["tensor", "selective_fc", "gated_unit", "conv_shift",
                     "out_prod", "linear_comb", "multiplex",
                     "factorization_machine", "dropout", "prelu", "repeat",
                     "printer"], None),
    "expand_ragged": (_expand_ragged, ["expand"], None),
    "switch_order": (_switch_order, ["nhwc", "back"], None),
    "sub_nested_seq": (_sub_nested_seq, ["selected"], None),
    "sparse_float": (_sparse_float, ["fc", "fc_sparse_dense",
                                     "table_projection"], None),
    "sparse_float_sequence": (_sparse_float_sequence, [
        "fc", "sum_pool", "avg_pool"], None),
    "sub_sequences": (_sub_sequences, ["inner_pool", "outer_pool",
                                       "dense_inner_sum", "sparse_fc",
                                       "sparse_inner_sum"], None),
}
CASES = [(fam, i, name) for fam, (_, names, _) in FAMILIES.items()
         for i, name in enumerate(names)]
_RUNS = {}


def _np(value):
    return np.array(value.cpu() if isinstance(value, torch.Tensor) else
                    value)


def _values(scope, names):
    return {n: _np(scope.find_var(n)) for n in names}


def _load(scope, values):
    """The reference's scope values into a port scope: the RNG key as the
    port's int64 words of the same uint32 values."""
    for name, value in values.items():
        scope.set_var(name, value.astype(np.int64) if name == "@RNG_STATE@"
                      else value.copy())


def _ref_run(fam):
    build, _, train = FAMILIES[fam]
    scope = ptpu.Scope()
    with ptpu.scope_guard(scope), ptpu.unique_name.guard():
        main, startup = ptpu.Program(), ptpu.Program()
        with ptpu.program_guard(main, startup):
            fetches, feed = build(REF)
            if train is not None:
                ptpu.optimizer.SGD(learning_rate=0.1).minimize(
                    fetches[train], startup_program=startup)
        numpy_startup(startup, scope)
        start = _values(scope, scope.var_names())
        outs = ptpu.Executor().run(main, feed=feed, fetch_list=fetches)
        after = _values(scope, scope.var_names())
    return start, [np.asarray(o) for o in outs], after


def _port_run(fam, start):
    build, _, train = FAMILIES[fam]
    scope = pc.Scope()
    with pc.scope_guard(scope), pc.unique_name.guard():
        main, startup = pc.Program(), pc.Program()
        with pc.program_guard(main, startup):
            fetches, feed = build(PORT)
            if train is not None:
                port_opt.SGD(learning_rate=0.1).minimize(fetches[train],
                                                         startup)
        _load(scope, start)
        outs = pc.Executor(device="cpu").run(main, feed=feed,
                                             fetch_list=fetches)
        after = _values(scope, start)
    return [np.asarray(o) for o in outs], after


def _family(fam):
    """(reference outputs, port outputs, reference state after the run,
    port state after) of ``fam``, built and run once a module."""
    if fam not in _RUNS:
        start, ref_outs, ref_after = _ref_run(fam)
        port_outs, port_after = _port_run(fam, start)
        _RUNS[fam] = (ref_outs, port_outs, ref_after, port_after)
    return _RUNS[fam]


# outputs drawn at random: the port's key stream equals the reference's
# (``random_ops``), so these are exact too
EXACT = {("maxid_eos_sampling", "maxid"), ("maxid_eos_sampling", "eos"),
         ("maxid_eos_sampling", "sampling_id"),
         ("structured_costs", "crf_decoding"), ("beam_search", "ids"),
         ("beam_search", "lengths"), ("beam_search_memory", "ids"),
         ("beam_search_memory", "lengths")}


@pytest.mark.parametrize("fam,index,name", CASES,
                         ids=["%s-%s" % (f, n) for f, _, n in CASES])
def test_layer_output_equals_reference(fam, index, name):
    ref_outs, port_outs, _, _ = _family(fam)
    want, got = ref_outs[index], port_outs[index]
    assert got.shape == want.shape, (got.shape, want.shape)
    if (fam, name) in EXACT or not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fam", [f for f, (_, _, t) in FAMILIES.items()
                                 if t is not None])
def test_one_sgd_step_updates_equal_reference(fam):
    """The families that train: every persistable after one SGD step."""
    _, _, ref_after, port_after = _family(fam)
    moved = 0
    for name, want in ref_after.items():
        if name == "@RNG_STATE@":
            continue
        np.testing.assert_allclose(port_after[name], want, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        moved += 1
    assert moved


# -- the surface ------------------------------------------------------------

def test_layer_names_equal_reference():
    """Every public name of the reference's v2 layer module, the
    ``*_layer`` spellings included, is in the port's, and no other."""
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and n not in ("np",)}
    assert public(port_v2.layer) == public(ref_v2.layer)
    for mod in ("activation", "pooling", "data_type"):
        assert public(getattr(port_v2, mod)) == \
            public(getattr(ref_v2, mod)), mod


@pytest.mark.parametrize("typ", sorted(ref_v2.data_type.__all__[1:]))
def test_input_types_equal_reference(typ):
    ref_t = getattr(ref_v2.data_type, typ)(7)
    port_t = getattr(port_v2.data_type, typ)(7)
    assert vars(port_t) == vars(ref_t)
    for prop in ("is_seq", "is_nested", "is_sparse_float",
                 "is_sparse_pair"):
        assert getattr(port_t, prop) == getattr(ref_t, prop)


def test_switch_order_refuses_other_orders():
    for P, pkg in ((REF, ptpu), (PORT, pc)):
        with P.guard(), pkg.program_guard(pkg.Program(), pkg.Program()):
            y = P.fl.data("y", shape=[2, 3, 4])
            with pytest.raises(ValueError):
                P.L.switch_order(y, reshape_order=[3, 2, 1, 0])


def test_memory_outside_a_group_refused():
    for P in (REF, PORT):
        with pytest.raises(RuntimeError):
            P.L.memory(size=3)
        with pytest.raises(RuntimeError):
            P.L.update_memory(None, None)


@pytest.mark.parametrize("form", ["pairs", "ids-values", "ids",
                                  "pair-tuple", "sequence", "sub-sequence"])
def test_sparse_padding_equals_reference(form):
    col, depth = {
        "pairs": ([[(3, 1.5), (7, -2.0)], [(1, 0.5)]], 0),
        "ids-values": ([([1, 2, 4], [0.5, 0.25, 4.0])], 0),
        "ids": ([[5], [1, 2]], 0),
        "pair-tuple": ([((3, 1.5), (7, -2.0))], 0),
        "sequence": ([[[(1, 1.0)], [(2, 2.0), (3, 3.0)]], [[(4, 4.0)]]],
                     1),
        "sub-sequence": ([[[[(1, 1.0)], [(2, 2.0)]], [[(3, 3.0)]]],
                          [[[(4, 4.0), (5, 5.0)]]]], 2)}[form]
    for got, want in zip(port_pad_sparse(col, depth),
                         _pad_sparse(col, depth)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(port_pad_nested([[[1, 2, 3], [4]], [[5, 6]]],
                                         "int64"),
                         _pad_nested([[[1, 2, 3], [4]], [[5, 6]]],
                                     "int64")):
        np.testing.assert_array_equal(got, want)


# -- the book-style scripts through SGD.train, both packages --------------

def _sentiment_script(P):
    rs = np.random.RandomState(0)
    V, T, B, N = 30, 8, 8, 48
    seqs = []
    for i in range(N):
        lo, hi = (1, V // 2) if i % 2 == 0 else (V // 2, V)
        seqs.append((list(rs.randint(lo, hi, (T - (i % 3),))), i % 2))

    def reader():
        for i in range(0, N, B):
            yield [(s[0], np.int64(s[1])) for s in seqs[i:i + B]]
    L = P.L
    data = L.data("words", P.dt.integer_value_sequence(V))
    lbl = L.data("label", P.dt.integer_value(2))
    lstm = L.lstmemory(L.fc(L.embedding(data, 16), 32), size=8)
    output = L.fc(L.pooling(lstm, pooling_type=P.pool.Max()), 2,
                  act=P.act.Softmax())
    return (L.classification_cost(output, lbl),
            P.v2.optimizer.Adam(learning_rate=0.05), reader,
            {"words": 0, "label": 1}, 4)


def _ctr_script(P):
    DIM, N, B = 32, 96, 16
    rs = np.random.RandomState(7)
    w_true = rs.randn(DIM).astype("float32")
    data = []
    for _ in range(N):
        k = rs.randint(1, 6)
        idx = rs.choice(DIM, size=k, replace=False)
        w = rs.rand(k).astype("float32") * 2
        x = np.zeros(DIM, "float32")
        x[idx] = w
        data.append((list(zip(idx.tolist(), w.tolist())),
                     int(x @ w_true > 0)))

    def reader():
        for i in range(0, N, B):
            yield data[i:i + B]
    L = P.L
    feats = L.data("feats", P.dt.sparse_float_vector(DIM))
    lbl = L.data("lbl", P.dt.integer_value(2))
    pred = L.fc(L.fc(feats, 16, act=P.act.Relu()), 2, act=P.act.Softmax())
    return (L.classification_cost(pred, lbl),
            P.v2.optimizer.Adam(learning_rate=0.05), reader,
            {"feats": 0, "lbl": 1}, 3)


def _sub_sequence_script(P):
    V, N, B = 20, 48, 8
    rs = np.random.RandomState(9)
    data = []
    for _ in range(N):
        cls = rs.randint(0, 2)
        lo, hi = (1, V // 2) if cls == 0 else (V // 2, V)
        data.append(([rs.randint(lo, hi, rs.randint(2, 5)).tolist()
                      for _ in range(rs.randint(1, 4))], int(cls)))

    def reader():
        for i in range(0, N, B):
            yield data[i:i + B]
    L, pool = P.L, P.pool
    docs = L.data("docs", P.dt.integer_value_sub_sequence(V))
    lbl = L.data("lbl", P.dt.integer_value(2))
    sent = L.pooling(L.embedding(docs, 8), pooling_type=pool.Avg())
    pred = L.fc(L.pooling(sent, pooling_type=pool.Max()), 2,
                act=P.act.Softmax())
    return (L.classification_cost(pred, lbl),
            P.v2.optimizer.Adam(learning_rate=0.1), reader,
            {"docs": 0, "lbl": 1}, 2)


def _script_costs(P, script, tar=None):
    """Build ``script`` in ``P``'s package, start it (``SGD.test`` over its
    first batch runs the startup), load ``tar`` when given, train its
    passes. Returns (the tar of its start, its costs)."""
    with P.guard():
        cost, opt, reader, feeding, passes = script(P)
        params = P.v2.parameters.create(cost)
        sgd = P.v2.trainer.SGD(cost=cost, parameters=params,
                               update_equation=opt)
    sgd.test(lambda: iter([next(iter(reader()))]), feeding=feeding)
    if tar is not None:
        params.init_from_tar(io.BytesIO(tar))
    start = io.BytesIO()
    params.to_tar(start)
    costs = []
    sgd.train(reader, num_passes=passes, feeding=feeding,
              event_handler=lambda e: costs.append(e.cost) if isinstance(
                  e, P.v2.event.EndIteration) else None)
    return start.getvalue(), costs


@pytest.mark.parametrize("script", [_sentiment_script, _ctr_script,
                                    _sub_sequence_script],
                         ids=["sentiment_lstm", "ctr_sparse_float",
                              "integer_sub_sequence"])
def test_book_script_trains_as_reference(script):
    tar, want = _script_costs(REF, script)
    got_tar, got = _script_costs(PORT, script, tar)
    assert got_tar == tar           # the same start, byte for byte
    np.testing.assert_allclose(got, want, rtol=SCRIPT_RTOL)
    assert np.mean(got[-3:]) < np.mean(got[:3])


def test_ranking_lambda_cost_trains_as_reference():
    """mq2007-style LTR: a shared fc scorer over a document list and
    ``lambda_cost`` (its NDCG value), 10 Adam steps in both packages from
    the reference's start."""
    rs = np.random.RandomState(1)
    B, Ld, D = 4, 6, 5
    w_true = rs.randn(D).astype("float32")
    feeds = []
    for _ in range(10):
        F = rs.randn(B, Ld, D).astype("float32")
        feeds.append({"feats": F, "rel": np.clip(np.round(F @ w_true), 0,
                                                 4).astype("float32")})

    def build(P, minimize):
        feats = P.fl.data("feats", shape=[Ld, D])
        rel = P.fl.data("rel", shape=[Ld])
        score = P.fl.reshape(P.fl.fc(feats, 1, num_flatten_dims=2,
                                     bias_attr=False), [-1, Ld])
        ndcg = P.L.lambda_cost(score, rel, NDCG_num=3)
        minimize(ndcg)
        return ndcg

    scope = ptpu.Scope()
    with ptpu.scope_guard(scope), ptpu.unique_name.guard():
        main, startup = ptpu.Program(), ptpu.Program()
        with ptpu.program_guard(main, startup):
            ndcg = build(REF, lambda v: ptpu.optimizer.Adam(
                learning_rate=0.05).minimize(v, startup_program=startup))
        numpy_startup(startup, scope)
        start = _values(scope, scope.var_names())
        exe = ptpu.Executor()
        want = [float(np.asarray(exe.run(main, feed=f,
                                         fetch_list=[ndcg])[0]))
                for f in feeds]
    pscope = pc.Scope()
    with pc.scope_guard(pscope), pc.unique_name.guard():
        main, startup = pc.Program(), pc.Program()
        with pc.program_guard(main, startup):
            ndcg = build(PORT, lambda v: port_opt.Adam(
                learning_rate=0.05).minimize(v, startup))
        _load(pscope, start)
        exe = pc.Executor(device="cpu")
        got = [float(np.asarray(exe.run(main, feed=f,
                                        fetch_list=[ndcg])[0]))
               for f in feeds]
    np.testing.assert_allclose(got, want, rtol=SCRIPT_RTOL)
