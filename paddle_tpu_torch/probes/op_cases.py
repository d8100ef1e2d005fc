"""The op cases of the LeNet-5/MNIST slice (``CASES``: for each of the
118 op types the slice ports), of the RNN and seq2seq slice
(``RNN_CASES``: its 31 op types outside sub-blocks) and of the op tail
(``TAIL_CASES``: its 17 detection, misc and legacy op types): the inputs
(numpy, from a seed of the case's name), attributes and tolerance of one
or more op descriptions. The CPU tests hold each case against the
reference's op (``tests/test_torch_ops_*.py``; the other slices' in their
own files) and
``chip_smoke.py``'s ``[ops]`` runs each on the card against the CPU.
Numpy and torch only: nothing here imports the reference.

A case's tolerance is on ``max|port - ref| / max(max|ref|, 1e-30)``
against the reference on the CPU (0 is bitwise):

* ``EXACT``: plumbing, comparisons, integer and selection ops, and
  elementwise arithmetic that rounds once (+, -, *, /, sqrt) in the same
  order as the reference;
* ``ULP4`` (4 float32 ulp at the largest magnitude): one transcendental
  (``exp``, ``log``, ``tanh``, ``log1p``, ``pow``, ``erf_inv`` ...),
  whose float32 versions in XLA and torch are different approximations;
* ``SUM``: reductions, norms and products, which sum in another order
  than XLA's; ``CONV``: convolutions; ``RNN``: the time loops.
"""

import types

import numpy as np
import torch

__all__ = ["EXACT", "ULP4", "SUM", "CONV", "RNN", "Case", "CASES",
           "SLICE_OPS", "RNN_CASES", "RNN_OPS", "RNN_FAMILIES",
           "TAIL_CASES", "TAIL_FAMILIES", "TAIL_OPS", "tail_family",
           "RNN_BLOCK_OPS", "KEY_WORDS", "UPDATE_RULES", "UPDATE_OUTPUTS",
           "FAMILIES", "family", "rnn_family", "op_desc", "to_torch"]

EXACT = 0.0
ULP4 = 4 * 2.0 ** -23
SUM = 2e-6
CONV = 1e-5

def _rs(seed):
    return np.random.RandomState(seed)


def _f(rs, *shape, lo=None, hi=None):
    if lo is not None:
        return rs.uniform(lo, hi, shape).astype(np.float32)
    return rs.standard_normal(shape).astype(np.float32)


def _i(rs, hi, *shape, lo=0):
    return rs.randint(lo, hi, shape).astype(np.int32)


class Case:
    """One op description: ``inputs`` maps a slot to an array or a list
    of arrays (made by ``make(rs)``), ``attrs`` its attributes, ``tol``
    its tolerance, ``grad`` whether its float inputs take a gradient
    check, ``key`` whether it needs the op's random key."""

    def __init__(self, op_type, make, attrs=(), tol=EXACT, grad=True,
                 key=False, name=""):
        self.op_type = op_type
        self.make = make
        self.attrs = dict(attrs)
        self.tol = tol
        self.grad = grad
        self.key = key
        self.id = op_type + ("-" + name if name else "")

    def inputs(self):
        return self.make(_rs(sum(map(ord, self.id))))


# -- the cases, by reference module -----------------------------------------

_ACT = {
    "sigmoid": ({}, ULP4), "logsigmoid": ({}, ULP4), "exp": ({}, ULP4),
    "tanh": ({}, ULP4), "tanh_shrink": ({}, ULP4),
    "softshrink": ({"lambda": 0.3}, EXACT), "sqrt": ({}, EXACT),
    "abs": ({}, EXACT), "ceil": ({}, EXACT), "floor": ({}, EXACT),
    "round": ({}, EXACT), "reciprocal": ({}, EXACT), "log": ({}, ULP4),
    "square": ({}, EXACT), "softplus": ({}, ULP4), "softsign": ({}, EXACT),
    "brelu": ({"t_min": -1.0, "t_max": 1.5}, EXACT),
    "leaky_relu": ({"alpha": 0.1}, EXACT),
    "soft_relu": ({"threshold": 2.0}, ULP4), "elu": ({"alpha": 0.7}, ULP4),
    "relu6": ({"threshold": 1.0}, EXACT), "stanh": ({}, ULP4),
    "hard_shrink": ({"threshold": 0.3}, EXACT),
    "thresholded_relu": ({"threshold": 0.2}, EXACT),
    "hard_sigmoid": ({"slope": 0.3, "offset": 0.4}, EXACT),
    "swish": ({"beta": 1.5}, ULP4), "silu": ({}, ULP4),
}
_POSITIVE = ("sqrt", "log", "reciprocal")

CASES = []
for _t, (_a, _tol) in _ACT.items():
    if _t in _POSITIVE:
        CASES.append(Case(_t, lambda rs: {"X": _f(rs, 3, 5, lo=0.1, hi=3)},
                          _a, _tol))
    else:
        CASES.append(Case(_t, lambda rs: {"X": 2 * _f(rs, 3, 5)}, _a, _tol))

CASES += [
    Case("prelu", lambda rs: {"X": _f(rs, 2, 3, 4), "Alpha":
                              _f(rs, 1, lo=0.1, hi=0.5)}, name="all"),
    Case("prelu", lambda rs: {"X": _f(rs, 2, 3, 4), "Alpha":
                              _f(rs, 3, 1, lo=0.1, hi=0.5)},
         name="channel"),
]

# math_ops
CASES += [
    Case("elementwise_sub", lambda rs: {"X": _f(rs, 2, 3, 4),
                                        "Y": _f(rs, 3)}, {"axis": 1}),
    Case("elementwise_max", lambda rs: {"X": _f(rs, 2, 3, 4),
                                        "Y": _f(rs, 4)}),
    Case("elementwise_min", lambda rs: {"X": _f(rs, 2, 3, 4),
                                        "Y": _f(rs, 2, 3, 4)}),
    Case("elementwise_pow", lambda rs: {"X": _f(rs, 2, 3, lo=0.2, hi=2),
                                        "Y": _f(rs, 3, lo=-1, hi=2)},
         tol=ULP4),
    Case("elementwise_pow", lambda rs: {"X": _i(rs, 5, 2, 3, lo=-4),
                                        "Y": _i(rs, 4, 3)}, grad=False,
         name="int"),
    Case("scale", lambda rs: {"X": _f(rs, 3, 4)},
         {"scale": 1.7, "bias": -0.3}),
    Case("minus", lambda rs: {"X": _f(rs, 3, 4), "Y": _f(rs, 3, 4)}),
]
for _r in ("mean", "max", "min", "prod"):
    _mk = (lambda rs: {"X": _f(rs, 2, 3, 4, lo=0.5, hi=1.5)}) \
        if _r == "prod" else (lambda rs: {"X": _f(rs, 2, 3, 4)})
    CASES += [
        Case("reduce_" + _r, _mk, {"dim": [1], "keep_dim": True},
             tol=SUM, name="dim1"),
        Case("reduce_" + _r, _mk, {"dim": [0, 2], "keep_dim": False},
             tol=SUM, name="dims02"),
        Case("reduce_" + _r, _mk, {"dim": None, "reduce_all": True},
             tol=SUM, name="all"),
    ]
CASES += [
    Case("reduce_mean", lambda rs: {"X": _i(rs, 9, 3, 4)},
         {"dim": [1]}, tol=SUM, grad=False, name="int"),
    Case("clip", lambda rs: {"X": _f(rs, 3, 5)}, {"min": -0.5, "max": 0.7}),
    Case("clip_by_norm", lambda rs: {"X": _f(rs, 4, 5)}, {"max_norm": 1.0},
         tol=SUM, name="clipped"),
    Case("clip_by_norm", lambda rs: {"X": _f(rs, 4, 5)},
         {"max_norm": 100.0}, tol=SUM, name="kept"),
    Case("sign", lambda rs: {"X": np.concatenate(
        [_f(rs, 7), np.zeros(1, np.float32)])}),
    Case("squared_l2_norm", lambda rs: {"X": _f(rs, 4, 5)}, tol=SUM),
    Case("squared_l2_distance", lambda rs: {"X": _f(rs, 4, 3),
                                            "Y": _f(rs, 4, 3)}, tol=SUM),
    Case("squared_l2_distance", lambda rs: {"X": _f(rs, 4, 2, 3),
                                            "Y": _f(rs, 1, 2, 3)}, tol=SUM,
         name="row"),
    Case("l1_norm", lambda rs: {"X": _f(rs, 4, 5)}, tol=SUM),
    Case("cos_sim", lambda rs: {"X": _f(rs, 4, 5), "Y": _f(rs, 4, 5)},
         tol=SUM),
    Case("cos_sim", lambda rs: {"X": _f(rs, 4, 5), "Y": _f(rs, 1, 5)},
         tol=SUM, name="row"),
    Case("bilinear_tensor_product", lambda rs: {
        "X": _f(rs, 3, 4), "Y": _f(rs, 3, 5), "Weight": _f(rs, 2, 4, 5),
        "Bias": _f(rs, 2)}, tol=SUM),
    Case("pow", lambda rs: {"X": _f(rs, 3, 4, lo=0.1, hi=2)},
         {"factor": 2.5}, tol=ULP4),
    Case("pow", lambda rs: {"X": _i(rs, 6, 3, 4, lo=-5)}, {"factor": 3},
         grad=False, name="int"),
]
for _l in ("and", "or", "xor"):
    CASES.append(Case("logical_" + _l, lambda rs: {
        "X": rs.rand(3, 4) > 0.5, "Y": rs.rand(3, 4) > 0.5}, grad=False))
CASES.append(Case("logical_not", lambda rs: {"X": rs.rand(3, 4) > 0.5},
                  grad=False))


def _ties(rs):
    x = _f(rs, 3, 4).round(0)
    y = _f(rs, 3, 4).round(0)
    return {"X": x, "Y": y}


for _c in ("less_than", "less_equal", "greater_than", "greater_equal",
           "equal", "not_equal"):
    CASES.append(Case(_c, _ties, grad=False))

# tensor_ops
CASES += [
    Case("cast", lambda rs: {"X": 3 * _f(rs, 3, 4)}, {"out_dtype": "int32"},
         grad=False, name="f2i"),
    Case("cast", lambda rs: {"X": _f(rs, 3, 4)}, {"out_dtype": "float16"},
         name="f2h"),
    Case("cast", lambda rs: {"X": _i(rs, 9, 3, 4, lo=-9)},
         {"out_dtype": "float32"}, name="i2f"),
    Case("cast", lambda rs: {"X": rs.rand(3, 4) > 0.5},
         {"out_dtype": "int64"}, name="b2l"),
    Case("concat", lambda rs: {"X": [_f(rs, 2, 1), _f(rs, 2, 3),
                                     _f(rs, 2, 2)]}, {"axis": 1}),
    Case("split", lambda rs: {"X": _f(rs, 4, 3)},
         {"sections": [1, 2], "axis": 1}, name="sections"),
    Case("split", lambda rs: {"X": _f(rs, 4, 3)}, {"num": 2, "axis": 0},
         name="num"),
    Case("flip", lambda rs: {"X": _f(rs, 3, 4)}, {"axis": 1}),
    Case("pad", lambda rs: {"X": _f(rs, 2, 3)},
         {"paddings": [1, 0, 2, 3], "pad_value": 0.5}),
    Case("crop", lambda rs: {"X": _f(rs, 4, 5)},
         {"offsets": [1, 2], "shape": [2, -1]}),
    Case("expand", lambda rs: {"X": _f(rs, 2, 3)},
         {"expand_times": [2, 1]}),
    Case("expand", lambda rs: {"X": _f(rs, 2, 3)},
         {"expand_times": [3]}, name="trailing"),
    Case("scatter", lambda rs: {"X": _f(rs, 5, 3),
                                "Index": np.array([1, 3, 1], np.int32),
                                "Updates": _f(rs, 3, 3)}, name="repeats"),
    Case("multiplex", lambda rs: {
        "X": [_f(rs, 4, 2), _f(rs, 4, 2), _f(rs, 4, 2)],
        "Ids": np.array([[0], [2], [1], [0]], np.int32)}),
    Case("fill_zeros_like", lambda rs: {"X": _f(rs, 3, 2)}, grad=False),
    Case("fill_constant_batch_size_like", lambda rs: {"Input": _f(rs, 6, 3)},
         {"shape": [-1, 4], "value": 2.5, "dtype": "float32"}, grad=False),
    Case("fill_constant_batch_size_like", lambda rs: {"Input": _f(rs, 2, 5)},
         {"shape": [3, -1], "value": 7, "dtype": "int64",
          "input_dim_idx": 1, "output_dim_idx": 1}, grad=False,
         name="idx"),
    Case("assign", lambda rs: {"X": _f(rs, 3, 2)}),
    Case("assign_value", lambda rs: {}, {
        "shape": [2, 3], "dtype": "float32",
        "values": [0.5, -1.25, 3.0, 1e-3, 7.0, -2.0]}, grad=False),
    Case("assign_value", lambda rs: {}, {
        "shape": [3], "dtype": "int32", "values": [4, -1, 9]}, grad=False,
        name="int"),
    Case("increment", lambda rs: {"X": _f(rs, 1)}, {"step": 1.0},
         grad=False),
    Case("increment", lambda rs: {"X": np.array([5], np.int32)},
         {"step": 2.0}, grad=False, name="int"),
    Case("is_empty", lambda rs: {"X": _f(rs, 0, 3)}, grad=False),
    Case("is_empty", lambda rs: {"X": _f(rs, 2, 3)}, grad=False,
         name="full"),
    Case("one_hot", lambda rs: {"X": np.array([[1], [4], [0], [7]],
                                              np.int32)}, {"depth": 5},
         grad=False),
    Case("shape", lambda rs: {"Input": _f(rs, 2, 3, 4)}, grad=False),
    Case("arg_min", lambda rs: {"X": _f(rs, 3, 5)}, {"axis": 1},
         grad=False),
    Case("stack", lambda rs: {"X": [_f(rs, 2, 3), _f(rs, 2, 3),
                                    _f(rs, 2, 3)]}, {"axis": 1}),
    Case("unstack", lambda rs: {"X": _f(rs, 2, 3, 4)}, {"axis": 1}),
]

# nn_ops
CASES += [
    Case("batch_conv2d", lambda rs: {"Input": _f(rs, 2, 3, 6, 6),
                                     "Filter": _f(rs, 2, 4, 3, 3, 3)},
         {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1]},
         tol=CONV),
    Case("conv3d", lambda rs: {"Input": _f(rs, 2, 2, 5, 5, 5),
                               "Filter": _f(rs, 3, 2, 3, 3, 3)},
         {"strides": [1, 2, 1], "paddings": [1, 1, 0],
          "dilations": [1, 1, 1], "groups": 1}, tol=CONV),
    Case("conv2d_transpose", lambda rs: {"Input": _f(rs, 2, 3, 5, 5),
                                         "Filter": _f(rs, 3, 4, 3, 3)},
         {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1]},
         tol=CONV),
    Case("conv3d_transpose", lambda rs: {"Input": _f(rs, 1, 2, 3, 3, 3),
                                         "Filter": _f(rs, 2, 3, 2, 2, 2)},
         {"strides": [2, 2, 2], "paddings": [0, 0, 0],
          "dilations": [1, 1, 1]}, tol=CONV),
    Case("factorization_machine", lambda rs: {"X": _f(rs, 4, 6),
                                              "V": _f(rs, 6, 3)}, tol=SUM),
    Case("pool3d", lambda rs: {"X": _f(rs, 2, 2, 5, 5, 5)},
         {"ksize": [2, 2, 2], "strides": [2, 2, 2], "paddings": [0, 0, 0],
          "pooling_type": "max"}, name="max"),
    Case("pool3d", lambda rs: {"X": _f(rs, 2, 2, 5, 5, 5)},
         {"ksize": [3, 3, 3], "strides": [2, 2, 2], "paddings": [1, 1, 1],
          "pooling_type": "avg", "exclusive": True}, tol=SUM, name="avg"),
    Case("pool3d", lambda rs: {"X": _f(rs, 1, 2, 4, 5, 3)},
         {"ksize": [2, 2, 2], "pooling_type": "avg", "global_pooling": True,
          "exclusive": False}, tol=SUM, name="global"),
    # no gradient: the reference's reduce_window over (value, index)
    # pairs has none
    Case("pool2d_with_index", lambda rs: {"X": _f(rs, 2, 3, 6, 6)},
         {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]},
         grad=False),
    Case("pool2d_with_index", lambda rs: {"X": _f(rs, 2, 3, 7, 6)},
         {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]},
         grad=False, name="padded"),
    Case("lrn", lambda rs: {"X": _f(rs, 2, 7, 3, 3)},
         {"n": 5, "k": 2.0, "alpha": 1e-2, "beta": 0.75}, tol=ULP4),
    Case("maxout", lambda rs: {"X": _f(rs, 2, 6, 3, 3)}, {"groups": 2}),
    Case("norm", lambda rs: {"X": _f(rs, 2, 4, 3, 3), "Scale": _f(rs, 4)},
         tol=SUM),
    Case("l2_normalize", lambda rs: {"X": _f(rs, 3, 5)}, {"axis": 1},
         tol=SUM),
    Case("conv_shift", lambda rs: {"X": _f(rs, 3, 7), "Y": _f(rs, 3, 3)},
         tol=SUM),
    Case("row_conv", lambda rs: {"X": _f(rs, 2, 5, 4),
                                 "Filter": _f(rs, 3, 4)}, tol=EXACT),
    Case("spp", lambda rs: {"X": _f(rs, 2, 3, 5, 7)},
         {"pyramid_height": 3, "pooling_type": "max"}, name="max"),
    Case("spp", lambda rs: {"X": _f(rs, 2, 3, 5, 7)},
         {"pyramid_height": 3, "pooling_type": "avg"}, tol=SUM, name="avg"),
    Case("unpool", lambda rs: {
        "X": _f(rs, 2, 3, 3, 3),
        "Indices": (np.arange(9).reshape(3, 3) * 2 % 36 +
                    rs.randint(0, 2, (2, 3, 3, 3))).astype(np.int32)},
         {"unpooled_height": 6, "unpooled_width": 6}),
    Case("im2sequence", lambda rs: {"X": _f(rs, 2, 3, 5, 6)},
         {"kernels": [2, 3], "strides": [1, 2]}),
]


def _probs(rs, n, d):
    p = rs.uniform(0.05, 1.0, (n, d)).astype(np.float32)
    return (p / p.sum(1, keepdims=True)).astype(np.float32)


# loss_ops
CASES += [
    Case("cross_entropy", lambda rs: {"X": _probs(rs, 4, 5),
                                      "Label": _i(rs, 5, 4, 1)}, tol=ULP4),
    Case("cross_entropy", lambda rs: {"X": _probs(rs, 4, 5),
                                      "Label": _probs(rs, 4, 5)},
         {"soft_label": True}, tol=ULP4, name="soft"),
    Case("softmax_with_cross_entropy", lambda rs: {
        "Logits": _f(rs, 4, 5), "Label": _probs(rs, 4, 5)},
        {"soft_label": True}, tol=ULP4, name="soft"),
    Case("sigmoid_cross_entropy_with_logits", lambda rs: {
        "X": 2 * _f(rs, 4, 5), "Label": _f(rs, 4, 5, lo=0, hi=1)}, tol=ULP4),
    Case("square_error_cost", lambda rs: {"X": _f(rs, 4, 1),
                                          "Y": _f(rs, 4, 1)}),
    Case("hinge_loss", lambda rs: {"Logits": _f(rs, 6, 1), "Labels":
                                   _i(rs, 2, 6, 1).astype(np.float32)}),
    Case("huber_loss", lambda rs: {"X": _f(rs, 6, 1), "Y": _f(rs, 6, 1)},
         {"delta": 0.5}),
    Case("log_loss", lambda rs: {"Predicted": _f(rs, 6, 1, lo=0.05, hi=0.95),
                                 "Labels": _i(rs, 2, 6, 1).astype(
                                     np.float32)}, {"epsilon": 1e-4},
         tol=ULP4),
    Case("margin_rank_loss", lambda rs: {
        "X1": _f(rs, 6, 1), "X2": _f(rs, 6, 1),
        "Label": (2 * _i(rs, 2, 6, 1) - 1).astype(np.float32)},
        {"margin": 0.1}),
    Case("modified_huber_loss", lambda rs: {
        "X": 2 * _f(rs, 8, 1),
        "Y": _i(rs, 2, 8, 1).astype(np.float32)}),
    Case("rank_loss", lambda rs: {"Left": _f(rs, 6, 1), "Right":
                                  _f(rs, 6, 1), "Label":
                                  _f(rs, 6, 1, lo=0, hi=1)}, tol=ULP4),
    Case("smooth_l1_loss", lambda rs: {"X": _f(rs, 4, 3), "Y": _f(rs, 4, 3)},
         {"sigma": 2.0}, tol=SUM),
    Case("smooth_l1_loss", lambda rs: {
        "X": _f(rs, 4, 3), "Y": _f(rs, 4, 3),
        "InsideWeight": _f(rs, 4, 3, lo=0, hi=2),
        "OutsideWeight": _f(rs, 4, 3, lo=0, hi=2)}, {"sigma": 1.0},
        tol=SUM, name="weighted"),
    Case("nce", lambda rs: {"Input": _f(rs, 4, 6),
                            "Label": _i(rs, 20, 4, 1),
                            "Weight": _f(rs, 20, 6),
                            "Bias": _f(rs, 20, 1)},
         {"num_neg_samples": 5, "num_total_classes": 20}, tol=SUM,
         key=True),
    Case("hsigmoid", lambda rs: {"X": _f(rs, 5, 6), "W": _f(rs, 6, 6),
                                 "Label": _i(rs, 7, 5, 1),
                                 "Bias": _f(rs, 6)},
         {"num_classes": 7}, tol=SUM),
]


def _opt_inputs(rs, slots, positive=()):
    out = {"Param": _f(rs, 3, 4), "Grad": _f(rs, 3, 4),
           "LearningRate": np.array([0.1], np.float32)}
    for s in slots:
        out[s] = _f(rs, 3, 4, lo=0.01, hi=1.0) if s in positive \
            else _f(rs, 3, 4)
    return out


# optimizer_ops (the functional form; test_torch_optimizers.py runs
# three steps of each, in place and not)
CASES += [
    Case("adamax", lambda rs: dict(
        _opt_inputs(rs, ("Moment", "InfNorm"), ("InfNorm",)),
        Beta1Pow=np.array([0.9 ** 3], np.float32)), tol=ULP4, grad=False),
    Case("adagrad", lambda rs: _opt_inputs(rs, ("Moment",), ("Moment",)),
         tol=ULP4, grad=False),
    Case("decayed_adagrad", lambda rs: _opt_inputs(rs, ("Moment",),
                                                   ("Moment",)),
         {"decay": 0.9}, tol=ULP4, grad=False),
    Case("adadelta", lambda rs: {
        k: v for k, v in _opt_inputs(
            rs, ("AvgSquaredGrad", "AvgSquaredUpdate"),
            ("AvgSquaredGrad", "AvgSquaredUpdate")).items()
        if k != "LearningRate"}, tol=ULP4, grad=False),
    Case("rmsprop", lambda rs: _opt_inputs(rs, ("MeanSquare", "Moment"),
                                           ("MeanSquare",)),
         {"momentum": 0.5}, tol=ULP4, grad=False),
    Case("proximal_gd", lambda rs: _opt_inputs(rs, ()),
         {"l1": 0.05, "l2": 0.1}, tol=ULP4, grad=False),
    Case("proximal_adagrad", lambda rs: _opt_inputs(rs, ("Moment",),
                                                    ("Moment",)),
         {"l1": 0.05, "l2": 0.1}, tol=ULP4, grad=False),
    Case("ftrl", lambda rs: _opt_inputs(
        rs, ("SquaredAccumulator", "LinearAccumulator"),
        ("SquaredAccumulator",)), {"l1": 0.05, "l2": 0.1}, tol=ULP4,
        grad=False),
    Case("ftrl", lambda rs: _opt_inputs(
        rs, ("SquaredAccumulator", "LinearAccumulator"),
        ("SquaredAccumulator",)), {"l1": 0.05, "l2": 0.1, "lr_power": -0.7},
        tol=ULP4, grad=False, name="power"),
]

# metric_ops
CASES += [
    Case("auc", lambda rs: {"Out": _probs(rs, 40, 2),
                            "Label": _i(rs, 2, 40, 1)},
         {"num_thresholds": 200}, tol=SUM, grad=False),
    Case("auc", lambda rs: {"Out": _f(rs, 30, lo=0, hi=1),
                            "Label": _i(rs, 2, 30, 1)},
         {"num_thresholds": 17}, tol=SUM, grad=False, name="flat"),
    Case("precision_recall", lambda rs: {
        "MaxProbs": _f(rs, 12, 1, lo=0, hi=1), "Indices": _i(rs, 4, 12, 1),
        "Labels": _i(rs, 4, 12, 1)}, {"class_number": 4}, tol=SUM,
        grad=False),
    Case("positive_negative_pair", lambda rs: {
        "Score": _f(rs, 12, 1).round(0), "Label": _i(rs, 3, 12, 1),
        "QueryID": _i(rs, 3, 12, 1)}, grad=False),
]

# random_ops (bitwise; test_torch_ops_random.py covers the draws at
# every dtype and through programs)
CASES += [
    Case("randint", lambda rs: {}, {"shape": [3, 4], "low": -3,
                                    "high": 17}, grad=False, key=True),
    Case("sampling_id", lambda rs: {"X": _probs(rs, 5, 8)}, grad=False,
         key=True),
    Case("gaussian_random", lambda rs: {}, {"shape": [4, 5], "mean": 0.5,
                                            "std": 0.02,
                                            "dtype": "float16"},
         grad=False, key=True, name="f16"),
    Case("uniform_random", lambda rs: {}, {"shape": [4, 5], "min": -3.0,
                                           "max": 7.5,
                                           "dtype": "bfloat16"},
         grad=False, key=True, name="bf16"),
]

# the 118 op types this slice registers
SLICE_OPS = sorted({c.op_type for c in CASES} -
                   {"softmax_with_cross_entropy", "gaussian_random",
                    "uniform_random"})

KEY_WORDS = (0, 42)



# -- the RNN and seq2seq slice: the op types outside sub-blocks -------------
#
# ``RNN`` is their forward tolerance on max|port - ref| / max|ref|: the
# time loops chain products and transcendentals over the steps. The
# sub-block ops (static_rnn, while, cond, dynamic_beam_search) run in
# programs: tests/test_torch_control_flow.py, test_torch_beam_search.py
# and chip_smoke.py's [control-flow] and [lm-generate].

RNN = 1e-5


def _len(rs, hi, n, lo=0):
    return rs.randint(lo, hi + 1, (n,)).astype(np.int32)


def _gru_in(rs, b, t, h):
    return {"Input": _f(rs, b, t, 3 * h), "Weight": 0.5 * _f(rs, h, 3 * h),
            "Bias": 0.1 * _f(rs, 1, 3 * h),
            "Length": np.array([t, 2, 0][:b], np.int32)}


def _lstm_in(rs, b, t, h, peep=False):
    return {"Input": _f(rs, b, t, 4 * h), "Weight": 0.5 * _f(rs, h, 4 * h),
            "Bias": 0.1 * _f(rs, 1, (7 if peep else 4) * h),
            "Length": np.array([t, 3, 0][:b], np.int32)}


def _decoder_in(rs, b=2, t=5, t2=4, e=3, h=4, v=9):
    return {"EncOut": _f(rs, b, t, h),
            "EncMask": (np.arange(t)[None] < np.array([t, 3])[:b, None])
            .astype(np.float32),
            "TrgEmb": _f(rs, b, t2, e), "H0": _f(rs, b, h),
            "WIn": 0.5 * _f(rs, e + h, 3 * h), "WH": 0.5 * _f(rs, h, 3 * h),
            "Bias": 0.1 * _f(rs, 3 * h), "WAtt": 0.5 * _f(rs, h, h),
            "WOut": _f(rs, h, v), "BOut": 0.1 * _f(rs, v)}


def _generate_in(rs):
    d = _decoder_in(rs)
    del d["TrgEmb"]
    d["Embedding"] = _f(rs, 9, 3)
    return d


def _beam_in(rs):
    done = np.array([[False, True, False], [False, False, False]])
    return {"PreScores": np.where(done, -2.0, _f(rs, 2, 3, lo=-3, hi=-1))
            .astype(np.float32), "Logits": _f(rs, 6, 7), "Done": done}


def _tags(rs, n, t, types):
    return rs.randint(0, 2 * types + 1, (n, t)).astype(np.int32)


RNN_CASES = []
for _p in ("average", "sum", "sqrt", "max", "first", "last"):
    RNN_CASES.append(Case(
        "sequence_pool", lambda rs: {"X": _f(rs, 3, 5, 4),
                                     "Length": np.array([5, 2, 0],
                                                        np.int32)},
        {"pool_type": _p}, tol=SUM, name=_p))
RNN_CASES += [
    Case("sequence_pool", lambda rs: {"X": _f(rs, 3, 5, 4)},
         {"pool_type": "last"}, name="last-nolength"),
    Case("sequence_softmax", lambda rs: {"X": _f(rs, 3, 5), "Length":
                                         np.array([5, 2, 1], np.int32)},
         tol=SUM),
    Case("sequence_expand", lambda rs: {"X": _f(rs, 3, 4),
                                        "Y": _f(rs, 3, 5, 2),
                                        "Length": np.array([5, 2, 0],
                                                           np.int32)}),
    Case("sequence_reverse", lambda rs: {"X": _f(rs, 3, 5, 2), "Length":
                                         np.array([5, 2, 0], np.int32)}),
    Case("sequence_reverse", lambda rs: {"X": _f(rs, 3, 5, 2)},
         name="nolength"),
    Case("sequence_erase", lambda rs: {"X": _i(rs, 6, 3, 7),
                                       "Length": np.array([7, 4, 0],
                                                          np.int32)},
         {"tokens": [2, 5]}, grad=False),
    Case("sequence_conv", lambda rs: {"X": _f(rs, 2, 5, 3),
                                      "Filter": _f(rs, 9, 4)},
         {"contextLength": 3, "contextStart": -1}, tol=SUM),
    Case("sequence_conv", lambda rs: {"X": _f(rs, 2, 5, 3),
                                      "Filter": _f(rs, 12, 4)},
         {"contextLength": 4, "contextStart": 0}, tol=SUM, name="ahead"),
    Case("dynamic_lstm", lambda rs: _lstm_in(rs, 3, 6, 4), tol=RNN),
    Case("dynamic_lstm", lambda rs: dict(_lstm_in(rs, 3, 6, 4, peep=True),
                                         H0=_f(rs, 3, 4), C0=_f(rs, 3, 4)),
         {"use_peepholes": True, "is_reverse": True}, tol=RNN,
         name="peep-reverse"),
    Case("dynamic_gru", lambda rs: _gru_in(rs, 3, 6, 4), tol=RNN),
    Case("dynamic_gru", lambda rs: dict(_gru_in(rs, 3, 6, 4),
                                        H0=_f(rs, 3, 4)),
         {"is_reverse": True}, tol=RNN, name="reverse"),
    Case("gru_unit", lambda rs: {"Input": _f(rs, 3, 12),
                                 "HiddenPrev": _f(rs, 3, 4),
                                 "Weight": 0.5 * _f(rs, 4, 12),
                                 "Bias": 0.1 * _f(rs, 1, 12)}, tol=RNN),
    Case("lstm_unit", lambda rs: {"X": _f(rs, 3, 16), "C_prev":
                                  _f(rs, 3, 4)}, {"forget_bias": 1.0},
         tol=RNN),
    Case("sequence_reshape", lambda rs: {"X": _f(rs, 2, 4, 6), "Length":
                                         np.array([4, 2], np.int32)},
         {"new_dim": 3}),
    Case("lod_reset", lambda rs: {"X": _f(rs, 2, 5, 3), "Length":
                                  np.array([7, 2], np.int32),
                                  "OrigLength": np.array([4, 5],
                                                         np.int32)}),
    Case("max_sequence_len", lambda rs: {"Length": _len(rs, 9, 4)},
         grad=False),
    Case("sequence_concat_packed", lambda rs: {
        "A": _f(rs, 2, 3, 2), "B": _f(rs, 2, 4, 2),
        "LenA": np.array([3, 1], np.int32),
        "LenB": np.array([2, 4], np.int32)}),
    # beam search
    Case("beam_search", _beam_in, {"eos_id": 1}, tol=ULP4, grad=False),
    Case("beam_search_decode", lambda rs: {
        "StepTokens": _i(rs, 7, 4, 2, 3),
        "StepParents": _i(rs, 3, 4, 2, 3),
        "FinalScores": _f(rs, 2, 3, lo=-5, hi=-1)},
        {"eos_id": 1}, grad=False),
    # the attention-GRU decoder
    Case("attention_gru_decoder", _decoder_in, tol=RNN),
    Case("attention_gru_greedy_decode", _generate_in,
         {"max_len": 6, "bos_id": 0, "eos_id": 1}, tol=RNN, grad=False),
    Case("attention_gru_beam_decode", _generate_in,
         {"max_len": 6, "beam_size": 3, "bos_id": 0, "eos_id": 1},
         tol=RNN, grad=False),
    # nested sequences
    Case("nested_sequence_mask", lambda rs: {
        "SeqLen": np.array([3, 1], np.int32),
        "SubLen": np.array([[4, 0, 2], [3, 1, 2]], np.int32)},
        {"max_sub": 3, "maxlen": 4}, grad=False),
]
for _p in ("average", "sum", "sqrt", "max", "first", "last"):
    RNN_CASES.append(Case(
        "nested_sequence_pool", lambda rs: {
            "X": _f(rs, 2, 3, 4, 2),
            "SubLen": np.array([[4, 0, 2], [3, 1, 2]], np.int32)},
        {"pool_type": _p}, tol=SUM, name=_p))
RNN_CASES += [
    Case("sub_seq", lambda rs: {"X": _f(rs, 3, 6, 2),
                                "Offset": np.array([1, 4, -1], np.int32),
                                "Size": np.array([3, 4, 2], np.int32)},
         {"max_size": 4}),
    Case("sub_nested_seq", lambda rs: {
        "X": _f(rs, 2, 3, 4, 2),
        "SubLen": np.array([[4, 0, 2], [3, 1, 2]], np.int32),
        "Selected": np.array([[2, -1], [0, 1]], np.int32)}),
    # CRF and CTC
    Case("linear_chain_crf", lambda rs: {
        "Emission": _f(rs, 3, 5, 4), "Label": _i(rs, 4, 3, 5),
        "Length": np.array([5, 3, 1], np.int32),
        "Transition": 0.5 * _f(rs, 6, 4)}, tol=RNN),
    Case("crf_decoding", lambda rs: {
        "Emission": _f(rs, 3, 5, 4), "Transition": 0.5 * _f(rs, 6, 4),
        "Length": np.array([5, 3, 1], np.int32)}, grad=False),
    Case("warpctc", lambda rs: {
        "Logits": _f(rs, 3, 7, 5), "Label": _i(rs, 5, 3, 3, lo=1),
        "LogitsLength": np.array([7, 5, 4], np.int32),
        "LabelLength": np.array([3, 2, 0], np.int32)},
        {"blank": 0}, tol=RNN),
    Case("warpctc", lambda rs: {
        "Logits": _f(rs, 2, 6, 4), "Label": np.array([[1, 1, 2], [3, 2, 2]],
                                                     np.int32),
        "LogitsLength": np.array([6, 6], np.int32),
        "LabelLength": np.array([3, 3], np.int32)},
        {"blank": 0, "norm_by_times": True}, tol=RNN, name="repeats"),
    Case("ctc_align", lambda rs: {
        "Input": np.array([[0, 1, 1, 0, 2, 2, 3, 0], [2, 2, 0, 0, 2, 1, 1, 4],
                           [0, 0, 0, 0, 0, 0, 0, 0]], np.int32),
        "Length": np.array([8, 6, 3], np.int32)}, {"blank": 0}, grad=False),
    Case("edit_distance", lambda rs: {
        "Hyps": _i(rs, 4, 3, 5), "Refs": _i(rs, 4, 3, 6),
        "HypsLength": np.array([5, 2, 0], np.int32),
        "RefsLength": np.array([6, 3, 4], np.int32)},
        {"normalized": False}, grad=False),
    Case("edit_distance", lambda rs: {
        "Hyps": _i(rs, 3, 4, 6), "Refs": _i(rs, 3, 4, 5),
        "HypsLength": np.array([6, 4, 3, 1], np.int32),
        "RefsLength": np.array([5, 5, 0, 2], np.int32)},
        {"normalized": True}, grad=False, name="normalized"),
    Case("chunk_eval_counts", lambda rs: {
        "Inference": _tags(rs, 3, 10, 2), "Label": _tags(rs, 3, 10, 2),
        "Length": np.array([10, 7, 4], np.int32)},
        {"num_chunk_types": 2}, grad=False),
    # the tensor arrays, their index clamped into bounds
]
for _name, _idx in (("in", 2), ("minus1", -1), ("max-len", 4),
                    ("below", -6)):
    RNN_CASES += [
        Case("array_write", lambda rs, i=_idx: {
            "Array": _f(rs, 4, 3), "X": _f(rs, 3),
            "I": np.array([i], np.int32)}, name=_name),
        Case("array_read", lambda rs, i=_idx: {
            "Array": _f(rs, 4, 3), "I": np.array([i], np.int32)},
            name=_name),
    ]

# the op types of the RNN and seq2seq slice by reference module; with the
# sub-block ops, 35
RNN_FAMILIES = {
    "sequence": ("sequence_pool", "sequence_softmax", "sequence_expand",
                 "sequence_reverse", "sequence_erase", "sequence_conv",
                 "dynamic_lstm", "dynamic_gru", "gru_unit", "lstm_unit",
                 "sequence_reshape", "lod_reset", "max_sequence_len",
                 "sequence_concat_packed"),
    "beam": ("beam_search", "beam_search_decode"),
    "seq2seq": ("attention_gru_decoder", "attention_gru_greedy_decode",
                "attention_gru_beam_decode"),
    "nested": ("nested_sequence_mask", "nested_sequence_pool", "sub_seq",
               "sub_nested_seq"),
    "crf_ctc": ("linear_chain_crf", "crf_decoding", "warpctc", "ctc_align",
                "edit_distance"),
    "metric": ("chunk_eval_counts",),
    "tensor": ("array_write", "array_read"),
}
RNN_BLOCK_OPS = ("static_rnn", "while", "cond", "dynamic_beam_search")
RNN_OPS = sorted({c.op_type for c in RNN_CASES} | set(RNN_BLOCK_OPS))


# -- the op tail: detection, misc and the legacy layer ops -----------------
#
# The 17 op types of ``ops/{detection,misc,legacy_tail}_ops.py``, by family
# (``TAIL_FAMILIES``). ``print`` prints at every run, the one op of the
# port that reads back to the host: the card's check reads its line.


def _corners(rs, n, lo=0.0, hi=0.7, size=(0.05, 0.3)):
    """``n`` corner boxes [n, 4] inside the unit square."""
    xy = rs.uniform(lo, hi, (n, 2))
    wh = rs.uniform(size[0], size[1], (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _grid_priors(rows=4, cols=6, size=0.3):
    """A [rows * cols, 4] grid of square priors of side ``size``."""
    cy, cx = np.meshgrid((np.arange(rows) + 0.5) / rows,
                         (np.arange(cols) + 0.5) / cols, indexing="ij")
    c = np.stack([cx.ravel(), cy.ravel()], axis=1)
    return np.concatenate([c - size / 2, c + size / 2], 1).astype(np.float32)


_VAR = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), (24, 1))


def _multibox_in(rs, n=2, g=3, c=4):
    priors = _grid_priors()
    # ground truth near some priors: IoU above 0.5 with them
    pick = rs.choice(len(priors), (n, g), replace=False)
    gt = priors[pick] + rs.uniform(-0.02, 0.02, (n, g, 4)).astype(
        np.float32)
    return {"Loc": 0.5 * _f(rs, n, len(priors), 4),
            "Conf": _f(rs, n, len(priors), c), "PriorBox": priors,
            "PriorBoxVar": _VAR, "GtBox": gt.astype(np.float32),
            "GtLabel": _i(rs, c, n, g, lo=1),
            "GtCount": np.array([2, 3][:n], np.int32)}


def _detect_in(rs, n=2, c=4):
    priors = _grid_priors()
    logits = 2 * _f(rs, n, len(priors), c)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return {"Loc": 0.5 * _f(rs, n, len(priors), 4),
            "Scores": (e / e.sum(-1, keepdims=True)).astype(np.float32),
            "PriorBox": priors, "PriorBoxVar": _VAR}


def _beam_xent_in(rs):
    """Two expansion steps of beam width 2 over 3 sequences: gold on the
    beam to the end (0), falling off at step 1 (1), at step 0 (2)."""
    return {"Scores": [_f(rs, 3, 5), _f(rs, 3, 6)],
            "Ids": [np.array([[[1, 3]], [[0, 2]], [[1, 4]]], np.int32),
                    np.array([[[0, 2], [4, 5]], [[1, -1], [3, 4]],
                              [[0, 1], [2, 3]]], np.int32)],
            "Gold": [np.array([3, 0, 2], np.int32),
                     np.array([5, 3, 0], np.int32)]}


def _mdlstm_in(rs, b=2, h=3, w=4, nb=2):
    return {"GatesX": _f(rs, b, h, w, 5 * nb),
            "WeightH": 0.5 * _f(rs, nb, 5 * nb),
            "Peephole": 0.5 * _f(rs, 4 * nb)}


TAIL_CASES = [
    # detection
    Case("prior_box", lambda rs: {"Input": _f(rs, 2, 8, 4, 5),
                                  "Image": _f(rs, 2, 3, 32, 40)},
         {"min_sizes": [4.0, 8.0], "max_sizes": [12.0],
          "aspect_ratios": [2.0, 3.0], "variances": [0.1, 0.1, 0.2, 0.2],
          "flip": True, "clip": True, "step_w": 0.0, "step_h": 0.0,
          "offset": 0.5}, grad=False),
    Case("prior_box", lambda rs: {"Input": _f(rs, 1, 4, 3, 3),
                                  "Image": _f(rs, 1, 3, 30, 30)},
         {"min_sizes": [30.0], "max_sizes": [], "aspect_ratios": [2.0, 1.0],
          "variances": [0.1, 0.2, 0.3, 0.4], "flip": False, "clip": False,
          "step_w": 7.0, "step_h": 9.0, "offset": 0.3}, grad=False,
         name="steps-noclip"),
    Case("box_coder", lambda rs: {"PriorBox": _corners(rs, 6),
                                  "PriorBoxVar": _VAR[:6],
                                  "TargetBox": 0.5 * _f(rs, 2, 6, 4)},
         {"code_type": "decode_center_size"}, tol=ULP4),
    Case("box_coder", lambda rs: {"PriorBox": _corners(rs, 6),
                                  "PriorBoxVar": _VAR[:6],
                                  "TargetBox": _corners(rs, 12).reshape(
                                      2, 6, 4)},
         {"code_type": "encode_center_size"}, tol=ULP4, name="encode"),
    Case("multibox_loss", _multibox_in,
         {"overlap_threshold": 0.5, "neg_pos_ratio": 3.0,
          "background_label": 0}, tol=SUM),
    Case("detection_output", _detect_in,
         {"background_label": 0, "confidence_threshold": 0.2,
          "nms_threshold": 0.45, "nms_top_k": 8, "keep_top_k": 10},
         tol=ULP4, grad=False),
    Case("detection_output", _detect_in,
         {"background_label": 2, "confidence_threshold": 0.01,
          "nms_threshold": 0.3, "nms_top_k": 6, "keep_top_k": 24},
         tol=ULP4, grad=False, name="padded"),
    # misc
    Case("print", lambda rs: {"X": _f(rs, 2, 3)}, {"message": "probe"}),
    Case("roi_pool", lambda rs: {
        "X": _f(rs, 2, 3, 8, 10),
        "ROIs": np.array([[0, 2, 2, 12, 9], [1, 0, 0, 19, 15],
                          [1, 15, 3, 30, 20], [0, 9, 9, 5, 5]],
                         np.float32)},
        {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.5}),
    Case("switch_order", lambda rs: {"X": _f(rs, 2, 3, 4, 5)},
         {"to_nhwc": True}),
    Case("switch_order", lambda rs: {"X": _f(rs, 2, 4, 5, 3)},
         {"to_nhwc": False}, name="nchw"),
    # the compiled reference contracts x * w + b into one rounding
    Case("scale_shift", lambda rs: {"X": _f(rs, 3, 4), "Scale": _f(rs, 1),
                                    "Bias": _f(rs, 1)}, tol=ULP4),
    Case("scale_shift", lambda rs: {"X": _f(rs, 3, 4), "Scale": _f(rs, 1)},
         name="nobias"),
    Case("resize", lambda rs: {"X": _f(rs, 2, 6, 4)}, {"size": 3}),
    Case("kmax_seq_score", lambda rs: {
        "X": rs.randint(0, 3, (3, 6)).astype(np.float32),
        "Length": np.array([6, 2, 0], np.int32)}, {"beam_size": 4},
        grad=False),
    Case("kmax_seq_score", lambda rs: {"X": _f(rs, 2, 3, 2)},
         {"beam_size": 8}, grad=False, name="past-t"),
    Case("scale_sub_region", lambda rs: {
        "X": _f(rs, 2, 3, 4, 5),
        "Indices": np.array([[1, 2, 2, 3, 1, 5], [3, 3, 1, 4, 2, 2]],
                            np.int32)}, {"value": 2.5}),
    # the legacy layer tail
    Case("bilinear_interp", lambda rs: {"X": _f(rs, 2, 3, 4, 5)},
         {"out_h": 7, "out_w": 3}, tol=ULP4),
    Case("bilinear_interp", lambda rs: {"X": _f(rs, 1, 2, 3, 3)},
         {"out_h": 1, "out_w": 5}, tol=ULP4, name="one-row"),
    Case("selective_fc", lambda rs: {
        "X": _f(rs, 3, 5), "W": _f(rs, 5, 9), "Bias": _f(rs, 9),
        "Sel": np.array([[0, 4, 8], [2, -1, 2], [-1, -1, 7]], np.int32)},
        tol=SUM),
    Case("selective_fc", lambda rs: {"X": _f(rs, 3, 5), "W": _f(rs, 5, 9),
                                     "Bias": _f(rs, 9)}, tol=SUM,
         name="full"),
    Case("data_norm", lambda rs: {"X": _f(rs, 4, 3),
                                  "Mean": _f(rs, 3),
                                  "Std": _f(rs, 3, lo=0.5, hi=2)},
         {"mode": "z-score"}),
    Case("data_norm", lambda rs: {"X": _f(rs, 4, 3), "Min": _f(rs, 3) - 2,
                                  "Max": _f(rs, 3) + 2},
         {"mode": "min-max"}, name="min-max"),
    Case("data_norm", lambda rs: {"X": 50 * _f(rs, 4, 3),
                                  "Max": _f(rs, 3, lo=0.05, hi=500)},
         {"mode": "decimal-scaling"}, tol=ULP4, name="decimal"),
    Case("lambda_cost", lambda rs: {
        "X": _f(rs, 3, 6),
        "Score": rs.randint(0, 4, (3, 6)).astype(np.float32),
        "Length": np.array([6, 4, 1], np.int32)}, {"NDCG_num": 3},
        tol=SUM),
    Case("cross_entropy_over_beam", _beam_xent_in, tol=SUM),
]
for _name, _dirs in (("", (True, True)), ("rev-h", (False, True)),
                     ("rev-w", (True, False)), ("rev-hw", (False, False))):
    TAIL_CASES.append(Case("mdlstm", _mdlstm_in, {"directions": _dirs},
                           tol=RNN, name=_name))

TAIL_FAMILIES = {
    "detection": ("prior_box", "box_coder", "multibox_loss",
                  "detection_output"),
    "misc": ("print", "roi_pool", "switch_order", "scale_shift", "resize",
             "kmax_seq_score", "scale_sub_region"),
    "legacy": ("bilinear_interp", "selective_fc", "data_norm", "mdlstm",
               "lambda_cost", "cross_entropy_over_beam"),
}
TAIL_OPS = sorted(t for types_ in TAIL_FAMILIES.values() for t in types_)


def tail_family(op_type):
    """The family of an op type of the op tail."""
    return next(f for f, types_ in TAIL_FAMILIES.items()
                if op_type in types_)

# input slot -> output slot of each update rule (``minimize`` names the
# same variable in both: the update runs in place)
UPDATE_OUTPUTS = {
    "Param": "ParamOut", "Moment": "MomentOut", "InfNorm": "InfNormOut",
    "Beta1Pow": "Beta1PowOut", "AvgSquaredGrad": "AvgSquaredGradOut",
    "AvgSquaredUpdate": "AvgSquaredUpdateOut",
    "MeanSquare": "MeanSquareOut", "SquaredAccumulator": "SquaredAccumOut",
    "LinearAccumulator": "LinearAccumOut"}
UPDATE_RULES = ("adamax", "adagrad", "decayed_adagrad", "adadelta",
                "rmsprop", "proximal_gd", "proximal_adagrad", "ftrl")

# the op types of the slice by the reference module that registers them
FAMILIES = {
    "activation": tuple(_ACT) + ("prelu",),
    "math": ("elementwise_sub", "elementwise_max", "elementwise_min",
             "elementwise_pow", "scale", "minus", "reduce_mean",
             "reduce_max", "reduce_min", "reduce_prod", "clip",
             "clip_by_norm", "sign", "squared_l2_norm",
             "squared_l2_distance", "l1_norm", "cos_sim",
             "bilinear_tensor_product", "pow", "logical_and", "logical_or",
             "logical_xor", "logical_not", "less_than", "less_equal",
             "greater_than", "greater_equal", "equal", "not_equal"),
    "tensor": ("cast", "concat", "split", "flip", "pad", "crop", "expand",
               "scatter", "multiplex", "fill_zeros_like",
               "fill_constant_batch_size_like", "assign", "assign_value",
               "increment", "is_empty", "one_hot", "shape", "arg_min",
               "stack", "unstack"),
    "nn": ("batch_conv2d", "conv3d", "conv2d_transpose",
           "conv3d_transpose", "factorization_machine", "pool3d",
           "pool2d_with_index", "lrn", "maxout", "norm", "l2_normalize",
           "conv_shift", "row_conv", "spp", "unpool", "im2sequence"),
    "loss": ("cross_entropy", "sigmoid_cross_entropy_with_logits",
             "square_error_cost", "hinge_loss", "huber_loss", "log_loss",
             "margin_rank_loss", "modified_huber_loss", "rank_loss",
             "smooth_l1_loss", "nce", "hsigmoid",
             "softmax_with_cross_entropy"),
    "optimizer": UPDATE_RULES,
    "metric": ("auc", "precision_recall", "positive_negative_pair"),
    "random": ("randint", "sampling_id", "gaussian_random",
               "uniform_random"),
}


def family(op_type):
    """The reference module (by its family name) of an op type."""
    return next(f for f, types_ in FAMILIES.items() if op_type in types_)


def rnn_family(op_type):
    """The family of an op type of the RNN and seq2seq slice."""
    return next(f for f, types_ in RNN_FAMILIES.items() if op_type in types_)


def op_desc(op_type, inputs, attrs):
    """An op description whose input names are its slots (a list slot
    names its elements ``<slot>#<i>``); no output names."""
    names = {}
    for k, v in inputs.items():
        names[k] = ["%s#%d" % (k, i) for i in range(len(v))] \
            if isinstance(v, list) else [k]
    return types.SimpleNamespace(type=op_type, attrs=dict(attrs),
                                 inputs=names, outputs={})


def to_torch(a, device):
    """A copy of a numpy array as a tensor on ``device`` (an update rule
    run in place writes into it, not into the case's array; a bfloat16
    array, which numpy holds as ``ml_dtypes.bfloat16``, through
    float32)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a).to(device)
