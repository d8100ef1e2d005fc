"""The legacy layer tail of the program front end (reference
``paddle_tpu/layers/legacy.py``): six layers over the ops of
``ops/legacy_tail_ops.py`` (``bilinear_interp``, ``selective_fc``,
``data_norm``, ``mdlstm``, ``lambda_cost``, ``cross_entropy_over_beam``)
and nineteen compositions over ops the port already has
(``interpolation``, ``linear_comb``, ..., ``featmap_expand``), each with
the reference's signature, defaults and naming, so a program serializes
as the reference's does."""

import numpy as np

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .nn import _single, fc
from . import control_flow as _cf
from . import nn as _nn
from . import ops as _opsmod
from . import tensor as _tensormod


class _Flat:
    """Flat layer-namespace resolver (the composition bodies read like
    the public ``layers.*`` surface regardless of which submodule a
    function lives in)."""

    def __getattr__(self, name):
        for m in (_nn, _opsmod, _tensormod, _cf):
            if hasattr(m, name):
                return getattr(m, name)
        raise AttributeError(name)


_ops = _tensor = _Flat()

__all__ = [
    "bilinear_interp", "selective_fc", "data_norm", "mdlstm",
    "lambda_cost", "cross_entropy_over_beam", "interpolation",
    "linear_comb", "slope_intercept", "repeat", "rotate", "out_prod",
    "gated_unit", "power", "trans", "l2_distance", "sum_to_one_norm",
    "row_l2_norm", "eos", "cross_entropy_with_selfnorm",
    "multi_binary_label_cross_entropy", "sum_cost",
    "cos_sim_vec_mat", "featmap_expand", "convex_comb",
]


def bilinear_interp(input, out_h, out_w, name=None, **kwargs):
    """Corner-aligned bilinear resize of NCHW maps (reference
    BilinearInterpLayer.cpp)."""
    helper = LayerHelper("bilinear_interp", name=name, **kwargs)
    return _single(helper, "bilinear_interp", {"X": [input.name]},
                   {"out_h": int(out_h), "out_w": int(out_w)})


def selective_fc(input, size, select=None, param_attr=None,
                 bias_attr=None, act=None, name=None, **kwargs):
    """FC computing only the selected output columns (reference
    SelectiveFullyConnectedLayer.cpp). ``select`` is an int tensor
    [B, K] of output-column ids (-1 = padding -> 0); without it this is
    the reference's full_output path (plain fc)."""
    helper = LayerHelper("selective_fc", act=act, name=name, **kwargs)
    w = helper.create_parameter(param_attr,
                                shape=[input.shape[-1], size],
                                dtype=input.dtype)
    inputs = {"X": [input.name], "W": [w.name]}
    if bias_attr is not False:
        b = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                    shape=[size], dtype=input.dtype,
                                    is_bias=True)
        inputs["Bias"] = [b.name]
    if select is not None:
        inputs["Sel"] = [select.name]
    return _single(helper, "selective_fc", inputs, {}, act=True)


def data_norm(input, mode="z-score", stats=None, name=None, **kwargs):
    """Per-feature data normalization (reference DataNormLayer.cpp):
    z-score | min-max | decimal-scaling. ``stats`` supplies the
    normalization statistics as numpy arrays keyed by mean/std/min/max;
    they become non-trainable persistable vars (the analog of the
    reference's static data-meta parameter)."""
    from ..initializer import NumpyArrayInitializer
    helper = LayerHelper("data_norm", name=name, **kwargs)
    stats = stats or {}
    d = input.shape[-1]
    needed = {"z-score": ("mean", "std"), "min-max": ("min", "max"),
              "decimal-scaling": ("max",)}[mode]
    inputs = {"X": [input.name]}
    for key in needed:
        arr = np.asarray(stats[key], dtype="float32")
        if arr.shape != (d,):
            raise ValueError("data_norm stat %r must have shape (%d,)"
                             % (key, d))
        var = helper.create_parameter(
            ParamAttr(name="%s_%s" % (helper.name, key),
                      initializer=NumpyArrayInitializer(arr),
                      trainable=False),
            shape=[d], dtype="float32")
        inputs[key.capitalize()] = [var.name]
    return _single(helper, "data_norm", inputs, {"mode": mode})


def mdlstm(input, num_blocks, directions=(True, True), param_attr=None,
           bias_attr=None, name=None, **kwargs):
    """2-D multi-dimensional LSTM over an NHWC grid (reference
    MDLstmLayer.cpp). input: [B, H, W, C]. Returns [B, H, W,
    num_blocks]. directions[d]=False scans that axis backwards."""
    helper = LayerHelper("mdlstm", name=name, **kwargs)
    c_in = input.shape[-1]
    nb = num_blocks
    wx = helper.create_parameter(param_attr, shape=[c_in, 5 * nb],
                                 dtype=input.dtype)
    # recurrent weight / peephole get auto-generated distinct names
    # (a named param_attr only pins the x-projection weight)
    wh = helper.create_parameter(None, shape=[nb, 5 * nb],
                                 dtype=input.dtype)
    bias = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                   shape=[5 * nb], dtype=input.dtype,
                                   is_bias=True)
    peep = helper.create_parameter(None, shape=[4 * nb],
                                   dtype=input.dtype, is_bias=True)
    # x projection: one matmul over the whole grid; the recurrence
    # consumes the precomputed gate pre-activations
    flat = _tensor.reshape(input, [-1, c_in])
    gx = fc(flat, 5 * nb, param_attr=ParamAttr(name=wx.name),
            bias_attr=(ParamAttr(name=bias.name)
                       if bias is not None else False),
            name=helper.name + "_gx")
    b_, h_, w_, _ = input.shape
    gx = _tensor.reshape(gx, [-1, h_, w_, 5 * nb])
    return _single(helper, "mdlstm",
                   {"GatesX": [gx.name], "WeightH": [wh.name],
                    "Peephole": [peep.name]},
                   {"directions": tuple(bool(d) for d in directions)})


def lambda_cost(input, score, length=None, NDCG_num=5,
                max_sort_size=-1, name=None, **kwargs):
    """LambdaRank cost (reference CostLayer.cpp LambdaCost /
    lambda_cost DSL). input: model scores [B, L]; score: true relevance
    [B, L]; length: valid lengths [B] (padded-batch LoD analog).
    max_sort_size: accepted for signature parity; this implementation
    always full-sorts (the reference's partial sort is a CPU cost
    optimization with identical results when >= list size)."""
    helper = LayerHelper("lambda_cost", name=name, **kwargs)
    inputs = {"X": [input.name], "Score": [score.name]}
    if length is None:
        # dynamic batch: [-1] leading dim -> batch-size-like fill
        length = _tensor.fill_constant_batch_size_like(
            input, [-1], "int64", input.shape[-1])
    inputs["Length"] = [length.name]
    return _single(helper, "lambda_cost", inputs,
                   {"NDCG_num": int(NDCG_num),
                    "max_sort_size": int(max_sort_size)})


def cross_entropy_over_beam(beams, name=None, **kwargs):
    """Globally-normalized CE over beam expansions (reference
    CrossEntropyOverBeam.cpp / cross_entropy_over_beam DSL). ``beams``:
    list of (scores [B,S], ids [B,R,W] int, gold [B] int) triples, one
    per expansion step — the padded analogs of the reference's
    BeamInput nested-LoD triples. Returns cost [B, 1]."""
    helper = LayerHelper("cross_entropy_over_beam", name=name, **kwargs)
    scores, ids, gold = zip(*beams)
    return _single(helper, "cross_entropy_over_beam",
                   {"Scores": [s.name for s in scores],
                    "Ids": [i.name for i in ids],
                    "Gold": [g.name for g in gold]}, {})


# ---- compositions ----------------------------------------------------

def interpolation(input, input2, weight, name=None):
    """y = w*x1 + (1-w)*x2, per-row scalar weight [B, 1] (reference
    InterpolationLayer.cpp / interpolation_layer DSL)."""
    return _ops.elementwise_add(
        _ops.elementwise_mul(input, weight),
        _ops.elementwise_mul(input2,
                             _ops.scale(weight, scale=-1.0, bias=1.0)))


def linear_comb(weights, vectors, size, name=None):
    """z = x^T Y per sample: weights [B, M], vectors [B, M*size]
    (reference LinearCombLayer / linear_comb_layer DSL)."""
    m = weights.shape[-1]
    y = _tensor.reshape(vectors, [-1, m, size])
    w = _tensor.reshape(weights, [-1, 1, m])
    return _tensor.reshape(_ops.matmul(w, y), [-1, size])


def slope_intercept(input, slope=1.0, intercept=0.0, name=None):
    """y = slope*x + intercept (reference SlopeInterceptLayer)."""
    return _ops.scale(input, scale=slope, bias=intercept)


def repeat(input, num_repeats, as_row_vector=True, name=None):
    """Repeat each row's features (reference RepeatLayer):
    as_row_vector: y = [x1..xn, x1..xn, ...]; else y = [x1,x1,..,xn,xn]
    (each element repeated)."""
    d = input.shape[-1]
    if as_row_vector:
        return _tensor.concat([input] * num_repeats, axis=-1)
    x3 = _tensor.reshape(input, [-1, d, 1])
    tiled = _tensor.concat([x3] * num_repeats, axis=-1)
    return _tensor.reshape(tiled, [-1, d * num_repeats])


def rotate(input, height, width, name=None):
    """Rotate each sample's [C, H, W] maps 90 deg clockwise:
    y(j, i) = x(M-i-1, j) (reference RotateLayer / rotate_layer DSL,
    flattened rows [B, C*H*W])."""
    c = (input.shape[-1] // (height * width)
         if len(input.shape) == 2 else input.shape[1])
    x = _tensor.reshape(input, [-1, c, height, width])
    # clockwise 90deg = flip rows then transpose H<->W
    out = _ops.transpose(_ops.flip(x, axis=2), perm=[0, 1, 3, 2])
    return _tensor.reshape(out, [-1, c * height * width])


def out_prod(input1, input2, name=None):
    """Per-sample outer product: [B,M] x [B,N] -> [B, M*N] (reference
    OuterProdLayer / out_prod_layer DSL)."""
    m, n = input1.shape[-1], input2.shape[-1]
    a = _tensor.reshape(input1, [-1, m, 1])
    b = _tensor.reshape(input2, [-1, 1, n])
    return _tensor.reshape(_ops.matmul(a, b), [-1, m * n])


def gated_unit(input, size, act=None, gate_param_attr=None,
               gate_bias_attr=None, inproj_param_attr=None,
               inproj_bias_attr=None, name=None):
    """y = act(X.W + b) * sigmoid(X.V + c) (reference gated_unit_layer
    DSL; Dauphin et al. gated linear unit)."""
    proj = fc(input, size, act=act, param_attr=inproj_param_attr,
              bias_attr=inproj_bias_attr)
    gate = fc(input, size, act="sigmoid", param_attr=gate_param_attr,
              bias_attr=gate_bias_attr)
    return _ops.elementwise_mul(proj, gate)


def power(input, weight, name=None):
    """y = x^w with per-row scalar exponent [B, 1] (reference
    PowerLayer / power_layer DSL)."""
    return _ops.elementwise_pow(input, weight)


def trans(input, name=None):
    """Transpose the whole [B, D] data matrix to [D, B] (reference
    TransLayer, used for weight sharing tricks)."""
    return _ops.transpose(input, perm=[1, 0])


def l2_distance(x, y, name=None):
    """Per-row euclidean distance [B, 1] (reference L2DistanceLayer)."""
    d = _ops.elementwise_sub(x, y)
    s = _ops.reduce_sum(_ops.square(d), dim=-1, keep_dim=True)
    return _ops.sqrt(s)


def sum_to_one_norm(input, name=None):
    """Row-normalize to sum 1 (reference SumToOneNormLayer)."""
    s = _ops.reduce_sum(input, dim=-1, keep_dim=True)
    return _ops.elementwise_div(input, s)


def row_l2_norm(input, name=None):
    """Row-normalize to unit L2 norm (reference RowL2NormLayer)."""
    return _ops.l2_normalize(input, axis=-1)


def eos(input, eos_id, name=None):
    """1.0 where the max-id equals eos_id (reference EosIdCheckLayer):
    input is a probability/score row; output [B, 1] indicator."""
    from . import nn as _nn
    _, idx = _nn.topk(input, k=1)
    return _ops.cast(_ops.equal(
        idx, _tensor.fill_constant([1], "int64", eos_id)), "float32")


def cross_entropy_with_selfnorm(input, label, softmax_selfnorm_alpha=0.1,
                                name=None):
    """CE + alpha * log(Z)^2 self-normalization (reference
    cross_entropy_with_selfnorm DSL): input is softmax output; the
    self-norm term pushes each row's partition toward 1."""
    ce = _ops.cross_entropy(input, label)
    z = _ops.reduce_sum(input, dim=-1, keep_dim=True)
    logz = _ops.log(z)
    return _ops.elementwise_add(
        ce, _ops.scale(_ops.square(logz),
                       scale=float(softmax_selfnorm_alpha)))


def multi_binary_label_cross_entropy(input, label, name=None):
    """Sum of per-class binary CE with probability input and multi-hot
    labels (reference MultiBinaryLabelCrossEntropy)."""
    eps = 1e-8
    one = _ops.scale(input, scale=-1.0, bias=1.0)
    loss = _ops.elementwise_add(
        _ops.elementwise_mul(label,
                             _ops.scale(_ops.log(
                                 _ops.scale(input, bias=eps)), -1.0)),
        _ops.elementwise_mul(_ops.scale(label, scale=-1.0, bias=1.0),
                             _ops.scale(_ops.log(
                                 _ops.scale(one, bias=eps)), -1.0)))
    return _ops.reduce_sum(loss, dim=-1, keep_dim=True)


def sum_cost(input, name=None):
    """Sum of the input as a scalar cost (reference SumCostLayer)."""
    return _ops.reduce_sum(input)


def cos_sim_vec_mat(vec, mat, scale=1.0, name=None):
    """cos_vm (reference CosSimVecMatLayer, 'used in NEURAL TURING
    MACHINE'): out[b, i] = scale * cos(vec[b], mat[b, i*D:(i+1)*D]).
    vec: [B, D]; mat: [B, M*D] -> [B, M]."""
    d = vec.shape[-1]
    m3 = _tensor.reshape(mat, [-1, mat.shape[-1] // d, d])
    v3 = _tensor.reshape(vec, [-1, 1, d])
    dots = _ops.reduce_sum(_ops.elementwise_mul(m3, v3), dim=-1)
    vn = _ops.sqrt(_ops.reduce_sum(_ops.square(vec), dim=-1,
                                   keep_dim=True))
    mn = _ops.sqrt(_ops.reduce_sum(_ops.square(m3), dim=-1))
    eps = 1e-12  # the cos_sim op's epsilon (ops/math_ops.py) — one
    # convention for every cosine path
    cos = _ops.elementwise_div(
        dots, _ops.scale(_ops.elementwise_mul(mn, vn), bias=eps))
    return _ops.scale(cos, scale=float(scale)) if scale != 1.0 else cos


def featmap_expand(input, num_filters, as_row_vector=True, name=None):
    """FeatureMapExpandLayer: tile the feature row num_filters times —
    y.row[i] = x.row[i mod width] (identical math to repeat with
    as_row_vector=True; registered under the reference's name)."""
    return repeat(input, num_filters, as_row_vector=as_row_vector)


convex_comb = linear_comb  # reference REGISTER_LAYER(convex_comb, ...)
