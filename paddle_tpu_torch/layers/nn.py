"""Core NN layers of the program front end (reference
``paddle_tpu/layers/nn.py``), each with the reference's signature,
defaults and ``LayerHelper`` naming, so a program serializes as the
reference's does, byte for byte.

Each layer appends ops to the current program; output shapes and dtypes
are inferred by running the op's torch compute on meta tensors
(``core/registry.py`` ``infer_shape``).
"""

import numpy as np

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from ..initializer import ConstantInitializer, NormalInitializer

__all__ = [
    "fc", "embedding", "conv2d", "batch_conv2d", "conv3d",
    "conv2d_transpose", "conv3d_transpose", "factorization_machine",
    "switch_order", "scale_shift", "resize", "kmax_seq_score",
    "scale_sub_region", "pool2d", "pool3d", "batch_norm", "fused_conv_bn", "layer_norm",
    "dropout", "cross_entropy", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "square_error_cost", "accuracy",
    "auc", "topk", "matmul", "reduce_sum", "reduce_mean", "reduce_max",
    "reduce_min", "reduce_prod", "lrn", "maxout", "l2_normalize",
    "im2sequence", "one_hot", "clip", "clip_by_norm", "mean", "mul",
    "dot_product_attention", "cos_sim", "hsigmoid", "nce", "row_conv",
    "conv_shift", "prelu", "smooth_l1", "log_loss", "huber_loss",
    "hinge_loss", "rank_loss", "margin_rank_loss",
    "bilinear_tensor_product", "spp", "elementwise_add", "elementwise_sub",
    "elementwise_mul", "elementwise_div", "elementwise_max",
    "elementwise_min", "elementwise_pow", "linear_chain_crf",
    "crf_decoding", "warpctc", "edit_distance", "ctc_greedy_decoder",
]


def _single(helper, op_type, inputs, attrs=None, out_slot="Out", dtype=None,
            act=False):
    out = helper.create_tmp_variable(dtype or
                                     helper.block.var(
                                         next(iter(inputs.values()))[0]
                                     ).dtype)
    helper.append_op(type=op_type, inputs=inputs,
                     outputs={out_slot: [out.name]}, attrs=attrs or {})
    return helper.append_activation(out) if act else out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None, **kwargs):
    """Fully-connected layer (reference fluid/layers/nn.py fc; legacy
    FullyConnectedLayer). Multiple inputs sum their projections."""
    helper = LayerHelper("fc", act=act, name=name, **kwargs)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    param_attrs = ParamAttr.to_attr(param_attr)
    if not isinstance(param_attrs, list):
        param_attrs = [param_attrs] * len(inputs)
    mul_results = []
    for inp, pattr in zip(inputs, param_attrs):
        in_dim = int(np.prod(inp.shape[num_flatten_dims:]))
        w = helper.create_parameter(pattr, shape=[in_dim, size],
                                    dtype=inp.dtype)
        out = helper.create_tmp_variable(inp.dtype)
        helper.append_op(type="mul",
                         inputs={"X": [inp.name], "Y": [w.name]},
                         outputs={"Out": [out.name]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(out)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_tmp_variable(mul_results[0].dtype)
        helper.append_op(type="sum",
                         inputs={"X": [v.name for v in mul_results]},
                         outputs={"Out": [pre_bias.name]})
    pre_act = helper.append_bias_op(pre_bias, bias_attr
                                    if bias_attr is not None else
                                    ParamAttr(), dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32", name=None,
              keep_dims=False, is_distributed=False, **kwargs):
    """Embedding lookup (reference lookup_table_op): a [vocab, dim] table
    initialized normal(0, 1/sqrt(dim)). Its gradient is a dense
    scatter-add; with ``is_sparse`` a (rows, values) pair, never a dense
    [V, D] buffer, which SGD/Momentum/Adagrad/Adam apply row by row
    (``ops/sparse_ops.py``).

    ``is_distributed`` creates a distributed table
    (``embeddings/sharded.py``): one [padded_vocab, dim] array in the
    mod-interleaved layout, which a strategy row-shards over its data
    axis (flag ``embedding_shard_rows``), looked up by the two-hop
    ``all_to_all`` (flag ``embedding_a2a``), its gradient always the
    sparse (rows, values) form. On one process, or with the flags off,
    it is a plain gather with the same numbers."""
    helper = LayerHelper("embedding", name=name, **kwargs)
    if is_distributed:
        from ..embeddings import sharded as _sharded
        vocab, dim = int(size[0]), int(size[1])
        vp = _sharded.padded_vocab(vocab)
        w = helper.create_parameter(
            param_attr, shape=[vp, dim], dtype=dtype,
            default_initializer=NormalInitializer(0.0,
                                                  1.0 / np.sqrt(dim)))
        _sharded.register_table(helper.main_program, w.name,
                                vocab=vocab, padded=vp, dim=dim)
        out = helper.create_tmp_variable(dtype)
        helper.append_op(type="lookup_table_dist",
                         inputs={"W": [w.name], "Ids": [input.name]},
                         outputs={"Out": [out.name]},
                         attrs={"padding_idx": padding_idx,
                                "vocab_size": vocab,
                                "padded_vocab": vp,
                                "keep_dims": bool(keep_dims)})
        return out
    w = helper.create_parameter(param_attr, shape=list(size), dtype=dtype,
                                default_initializer=NormalInitializer(
                                    0.0, 1.0 / np.sqrt(size[1])))
    out = helper.create_tmp_variable(dtype)
    helper.append_op(type="lookup_table",
                     inputs={"W": [w.name], "Ids": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"padding_idx": padding_idx,
                            "is_sparse": bool(is_sparse),
                            "keep_dims": bool(keep_dims)})
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None,
           **kwargs):
    helper = LayerHelper("conv2d", act=act, name=name, **kwargs)
    num_channels = input.shape[1]
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    stride = [stride, stride] if isinstance(stride, int) else list(stride)
    padding = [padding, padding] if isinstance(padding, int) \
        else list(padding)
    dilation = [dilation, dilation] if isinstance(dilation, int) \
        else list(dilation)
    fan_in = num_channels * int(np.prod(filter_size)) // (groups or 1)
    w = helper.create_parameter(
        param_attr,
        shape=[num_filters, num_channels // (groups or 1)] +
        list(filter_size),
        dtype=input.dtype,
        default_initializer=NormalInitializer(0.0,
                                              float(np.sqrt(2.0 / fan_in))))
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="conv2d",
                     inputs={"Input": [input.name], "Filter": [w.name]},
                     outputs={"Output": [out.name]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups or 1})
    if bias_attr is not False:
        bias = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                       shape=[num_filters],
                                       dtype=input.dtype, is_bias=True)
        tmp = helper.create_tmp_variable(input.dtype)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out.name], "Y": [bias.name]},
                         outputs={"Out": [tmp.name]}, attrs={"axis": 1})
        out = tmp
    return helper.append_activation(out)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, name=None, **kwargs):
    helper = LayerHelper("pool2d", name=name, **kwargs)
    ps = [pool_size] * 2 if isinstance(pool_size, int) else list(pool_size)
    st = [pool_stride] * 2 if isinstance(pool_stride, int) \
        else list(pool_stride)
    pd = [pool_padding] * 2 if isinstance(pool_padding, int) \
        else list(pool_padding)
    return _single(helper, "pool2d", {"X": [input.name]},
                   {"ksize": ps, "strides": st, "paddings": pd,
                    "pooling_type": pool_type,
                    "global_pooling": global_pooling,
                    "ceil_mode": ceil_mode, "exclusive": exclusive})


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, **kwargs):
    """BatchNorm with persistable running stats updated in-graph (reference
    batch_norm_op.cc; cross-replica sync handled by the data-parallel
    executor via mean-gradient + local stats, see parallel/)."""
    helper = LayerHelper("batch_norm", act=act, name=name, **kwargs)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        param_attr, shape=[c], dtype=input.dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, shape=[c], dtype=input.dtype,
                                   is_bias=True)
    mean = helper.create_global_variable(
        shape=[c], dtype=input.dtype, persistable=True,
        name=helper.name + ".mean" if name else None,
        initializer=ConstantInitializer(0.0))
    variance = helper.create_global_variable(
        shape=[c], dtype=input.dtype, persistable=True,
        name=helper.name + ".variance" if name else None,
        initializer=ConstantInitializer(1.0))
    out = helper.create_tmp_variable(input.dtype)
    saved_mean = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    saved_var = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    helper.append_op(type="batch_norm",
                     inputs={"X": [input.name], "Scale": [scale.name],
                             "Bias": [bias.name], "Mean": [mean.name],
                             "Variance": [variance.name]},
                     outputs={"Y": [out.name], "MeanOut": [mean.name],
                              "VarianceOut": [variance.name],
                              "SavedMean": [saved_mean.name],
                              "SavedVariance": [saved_var.name]},
                     attrs={"momentum": momentum, "epsilon": epsilon,
                            "is_test": is_test,
                            "data_layout": data_layout})
    return helper.append_activation(out)


def fused_conv_bn(input, num_filters, filter_size, stride=1, padding=0,
                  dilation=1, groups=1, act=None, is_test=False,
                  momentum=0.9, epsilon=1e-5, param_attr=None,
                  bn_param_attr=None, bn_bias_attr=None, name=None,
                  **kwargs):
    """conv2d (bias-free) + batch_norm as ONE ``conv2d_bn`` op
    (ops/pallas_conv_bn.py): the conv output is written once with its
    batch moments accumulated in the same pass instead of re-read by a
    separate batch_norm. Parameter/initializer layout matches the
    unfused pair (conv filter with He init, BN scale/bias, persistable
    running mean/variance), so checkpoints interchange."""
    helper = LayerHelper("conv2d_bn", act=act, name=name, **kwargs)
    num_channels = input.shape[1]
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    stride = [stride, stride] if isinstance(stride, int) else list(stride)
    padding = [padding, padding] if isinstance(padding, int) \
        else list(padding)
    dilation = [dilation, dilation] if isinstance(dilation, int) \
        else list(dilation)
    fan_in = num_channels * int(np.prod(filter_size)) // (groups or 1)
    w = helper.create_parameter(
        param_attr,
        shape=[num_filters, num_channels // (groups or 1)] +
        list(filter_size),
        dtype=input.dtype,
        default_initializer=NormalInitializer(0.0,
                                              float(np.sqrt(2.0 / fan_in))))
    scale = helper.create_parameter(
        bn_param_attr, shape=[num_filters], dtype=input.dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bn_bias_attr, shape=[num_filters],
                                   dtype=input.dtype, is_bias=True)
    mean = helper.create_global_variable(
        shape=[num_filters], dtype=input.dtype, persistable=True,
        name=helper.name + ".mean" if name else None,
        initializer=ConstantInitializer(0.0))
    variance = helper.create_global_variable(
        shape=[num_filters], dtype=input.dtype, persistable=True,
        name=helper.name + ".variance" if name else None,
        initializer=ConstantInitializer(1.0))
    out = helper.create_tmp_variable(input.dtype)
    saved_mean = helper.create_tmp_variable(input.dtype,
                                            stop_gradient=True)
    saved_var = helper.create_tmp_variable(input.dtype,
                                           stop_gradient=True)
    helper.append_op(type="conv2d_bn",
                     inputs={"Input": [input.name], "Filter": [w.name],
                             "Scale": [scale.name], "Bias": [bias.name],
                             "Mean": [mean.name],
                             "Variance": [variance.name]},
                     outputs={"Y": [out.name], "MeanOut": [mean.name],
                              "VarianceOut": [variance.name],
                              "SavedMean": [saved_mean.name],
                              "SavedVariance": [saved_var.name]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups or 1,
                            "momentum": momentum, "epsilon": epsilon,
                            "is_test": is_test})
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None, **kwargs):
    helper = LayerHelper("layer_norm", act=act, name=name, **kwargs)
    norm_shape = list(input.shape[begin_norm_axis:])
    inputs = {"X": [input.name]}
    if scale:
        s = helper.create_parameter(
            param_attr, shape=norm_shape, dtype=input.dtype,
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s.name]
    if shift:
        b = helper.create_parameter(bias_attr, shape=norm_shape,
                                    dtype=input.dtype, is_bias=True)
        inputs["Bias"] = [b.name]
    out = helper.create_tmp_variable(input.dtype)
    mean = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    var = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": [out.name], "Mean": [mean.name],
                              "Variance": [var.name]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def dropout(x, dropout_prob=0.5, is_test=False, name=None, **kwargs):
    helper = LayerHelper("dropout", name=name, **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    mask = helper.create_tmp_variable(x.dtype, stop_gradient=True)
    helper.append_op(type="dropout", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Mask": [mask.name]},
                     attrs={"dropout_prob": dropout_prob,
                            "is_test": is_test})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False, name=None,
                               **kwargs):
    helper = LayerHelper("softmax_with_cross_entropy", name=name, **kwargs)
    softmax = helper.create_tmp_variable(logits.dtype)
    loss = helper.create_tmp_variable(logits.dtype)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits.name],
                             "Label": [label.name]},
                     outputs={"Softmax": [softmax.name],
                              "Loss": [loss.name]},
                     attrs={"soft_label": soft_label})
    return loss


def accuracy(input, label, k=1, name=None, **kwargs):
    """Batch accuracy from predictions (reference accuracy_op +
    fluid/layers accuracy): runs top_k then compares."""
    helper = LayerHelper("accuracy", name=name, **kwargs)
    topk_out = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    topk_idx = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op(type="top_k", inputs={"X": [input.name]},
                     outputs={"Out": [topk_out.name],
                              "Indices": [topk_idx.name]},
                     attrs={"k": k})
    acc = helper.create_tmp_variable("float32", stop_gradient=True)
    correct = helper.create_tmp_variable("int64", stop_gradient=True)
    total = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op(type="accuracy",
                     inputs={"Indices": [topk_idx.name],
                             "Label": [label.name]},
                     outputs={"Accuracy": [acc.name],
                              "Correct": [correct.name],
                              "Total": [total.name]})
    return acc


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None,
           **kwargs):
    helper = LayerHelper("matmul", name=name, **kwargs)
    return _single(helper, "matmul", {"X": [x.name], "Y": [y.name]},
                   {"transpose_X": transpose_x, "transpose_Y": transpose_y,
                    "alpha": alpha})


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None, **kwargs):
    helper = LayerHelper("mul", name=name, **kwargs)
    return _single(helper, "mul", {"X": [x.name], "Y": [y.name]},
                   {"x_num_col_dims": x_num_col_dims,
                    "y_num_col_dims": y_num_col_dims})


def _make_reduce(op_name):
    def layer(input, dim=None, keep_dim=False, name=None, **kwargs):
        helper = LayerHelper(op_name, name=name, **kwargs)
        return _single(helper, op_name, {"X": [input.name]},
                       {"dim": dim, "keep_dim": keep_dim,
                        "reduce_all": dim is None})
    layer.__name__ = op_name
    return layer


reduce_sum = _make_reduce("reduce_sum")
reduce_mean = _make_reduce("reduce_mean")
reduce_max = _make_reduce("reduce_max")
reduce_min = _make_reduce("reduce_min")
reduce_prod = _make_reduce("reduce_prod")


def mean(x, name=None, **kwargs):
    helper = LayerHelper("mean", name=name, **kwargs)
    return _single(helper, "mean", {"X": [x.name]})


def _make_elementwise(op_name):
    def layer(x, y, axis=-1, act=None, name=None, **kwargs):
        helper = LayerHelper(op_name, act=act, name=name, **kwargs)
        return _single(helper, op_name,
                       {"X": [x.name], "Y": [y.name]}, {"axis": axis},
                       act=True)
    layer.__name__ = op_name
    return layer


elementwise_add = _make_elementwise("elementwise_add")
elementwise_sub = _make_elementwise("elementwise_sub")
elementwise_mul = _make_elementwise("elementwise_mul")
elementwise_div = _make_elementwise("elementwise_div")
elementwise_max = _make_elementwise("elementwise_max")
elementwise_min = _make_elementwise("elementwise_min")
elementwise_pow = _make_elementwise("elementwise_pow")


def batch_conv2d(input, filter, stride=1, padding=0, dilation=1,
                 name=None, **kwargs):
    """Conv with a DATA-DEPENDENT filter: ``filter`` is another
    variable's output, [B, O, C, kh, kw] — each batch row of ``input``
    [B, C, H, W] is convolved with its own filter (reference
    ConvOperator, gserver/layers/ConvOperator.cpp:59)."""
    helper = LayerHelper("batch_conv2d", name=name, **kwargs)
    stride = [stride, stride] if isinstance(stride, int) else list(stride)
    padding = [padding, padding] if isinstance(padding, int) \
        else list(padding)
    dilation = [dilation, dilation] if isinstance(dilation, int) \
        else list(dilation)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="batch_conv2d",
                     inputs={"Input": [input.name],
                             "Filter": [filter.name]},
                     outputs={"Output": [out.name]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation})
    return out


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None,
           **kwargs):
    helper = LayerHelper("conv3d", act=act, name=name, **kwargs)
    num_channels = input.shape[1]
    fs = [filter_size] * 3 if isinstance(filter_size, int) \
        else list(filter_size)
    stride = [stride] * 3 if isinstance(stride, int) else list(stride)
    padding = [padding] * 3 if isinstance(padding, int) else list(padding)
    w = helper.create_parameter(
        param_attr, shape=[num_filters, num_channels // (groups or 1)] + fs,
        dtype=input.dtype)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="conv3d",
                     inputs={"Input": [input.name], "Filter": [w.name]},
                     outputs={"Output": [out.name]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": [1, 1, 1], "groups": groups or 1})
    if bias_attr is not False:
        bias = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                       shape=[num_filters],
                                       dtype=input.dtype, is_bias=True)
        tmp = helper.create_tmp_variable(input.dtype)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out.name], "Y": [bias.name]},
                         outputs={"Out": [tmp.name]}, attrs={"axis": 1})
        out = tmp
    return helper.append_activation(out)


def conv2d_transpose(input, num_filters, filter_size, stride=1, padding=0,
                     dilation=1, param_attr=None, bias_attr=None, act=None,
                     name=None, **kwargs):
    helper = LayerHelper("conv2d_transpose", act=act, name=name, **kwargs)
    num_channels = input.shape[1]
    fs = [filter_size] * 2 if isinstance(filter_size, int) \
        else list(filter_size)
    stride = [stride] * 2 if isinstance(stride, int) else list(stride)
    padding = [padding] * 2 if isinstance(padding, int) else list(padding)
    dilation = [dilation] * 2 if isinstance(dilation, int) \
        else list(dilation)
    w = helper.create_parameter(param_attr,
                                shape=[num_channels, num_filters] + fs,
                                dtype=input.dtype)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="conv2d_transpose",
                     inputs={"Input": [input.name], "Filter": [w.name]},
                     outputs={"Output": [out.name]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation})
    if bias_attr is not False:
        out = helper.append_bias_op(out, ParamAttr.to_attr(bias_attr),
                                    dim_start=1, dim_end=2)
    return helper.append_activation(out)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, name=None, **kwargs):
    helper = LayerHelper("pool3d", name=name, **kwargs)
    ps = [pool_size] * 3 if isinstance(pool_size, int) else list(pool_size)
    st = [pool_stride] * 3 if isinstance(pool_stride, int) \
        else list(pool_stride)
    pd = [pool_padding] * 3 if isinstance(pool_padding, int) \
        else list(pool_padding)
    return _single(helper, "pool3d", {"X": [input.name]},
                   {"ksize": ps, "strides": st, "paddings": pd,
                    "pooling_type": pool_type,
                    "global_pooling": global_pooling})


def cross_entropy(input, label, soft_label=False, name=None, **kwargs):
    helper = LayerHelper("cross_entropy", name=name, **kwargs)
    return _single(helper, "cross_entropy",
                   {"X": [input.name], "Label": [label.name]},
                   {"soft_label": soft_label}, out_slot="Y",
                   dtype=input.dtype)


def sigmoid_cross_entropy_with_logits(x, label, name=None, **kwargs):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name,
                         **kwargs)
    return _single(helper, "sigmoid_cross_entropy_with_logits",
                   {"X": [x.name], "Label": [label.name]})


def square_error_cost(input, label, name=None, **kwargs):
    helper = LayerHelper("square_error_cost", name=name, **kwargs)
    return _single(helper, "square_error_cost",
                   {"X": [input.name], "Y": [label.name]})


def auc(input, label, num_thresholds=200, name=None, **kwargs):
    helper = LayerHelper("auc", name=name, **kwargs)
    out = helper.create_tmp_variable("float32", stop_gradient=True)
    helper.append_op(type="auc",
                     inputs={"Out": [input.name], "Label": [label.name]},
                     outputs={"AUC": [out.name]},
                     attrs={"num_thresholds": num_thresholds})
    return out


def topk(input, k=1, name=None, **kwargs):
    helper = LayerHelper("top_k", name=name, **kwargs)
    out = helper.create_tmp_variable(input.dtype)
    idx = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op(type="top_k", inputs={"X": [input.name]},
                     outputs={"Out": [out.name], "Indices": [idx.name]},
                     attrs={"k": k})
    return out, idx


def lrn(input, n=5, k=2.0, alpha=1e-4, beta=0.75, name=None, **kwargs):
    helper = LayerHelper("lrn", name=name, **kwargs)
    out = helper.create_tmp_variable(input.dtype)
    mid = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    helper.append_op(type="lrn", inputs={"X": [input.name]},
                     outputs={"Out": [out.name], "MidOut": [mid.name]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def maxout(x, groups, name=None, **kwargs):
    helper = LayerHelper("maxout", name=name, **kwargs)
    return _single(helper, "maxout", {"X": [x.name]}, {"groups": groups})


def l2_normalize(x, axis=-1, epsilon=1e-12, name=None, **kwargs):
    helper = LayerHelper("l2_normalize", name=name, **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    norm = helper.create_tmp_variable(x.dtype, stop_gradient=True)
    helper.append_op(type="l2_normalize", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Norm": [norm.name]},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def im2sequence(input, filter_size=1, stride=1, name=None, **kwargs):
    helper = LayerHelper("im2sequence", name=name, **kwargs)
    fs = [filter_size] * 2 if isinstance(filter_size, int) \
        else list(filter_size)
    st = [stride] * 2 if isinstance(stride, int) else list(stride)
    return _single(helper, "im2sequence", {"X": [input.name]},
                   {"kernels": fs, "strides": st})


def one_hot(input, depth, name=None, **kwargs):
    helper = LayerHelper("one_hot", name=name, **kwargs)
    return _single(helper, "one_hot", {"X": [input.name]},
                   {"depth": depth}, dtype="float32")


def clip(x, min, max, name=None, **kwargs):
    helper = LayerHelper("clip", name=name, **kwargs)
    return _single(helper, "clip", {"X": [x.name]},
                   {"min": min, "max": max})


def clip_by_norm(x, max_norm, name=None, **kwargs):
    helper = LayerHelper("clip_by_norm", name=name, **kwargs)
    return _single(helper, "clip_by_norm", {"X": [x.name]},
                   {"max_norm": max_norm})


def cos_sim(x, y, name=None, **kwargs):
    helper = LayerHelper("cos_sim", name=name, **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    xn = helper.create_tmp_variable(x.dtype, stop_gradient=True)
    yn = helper.create_tmp_variable(x.dtype, stop_gradient=True)
    helper.append_op(type="cos_sim",
                     inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name], "XNorm": [xn.name],
                              "YNorm": [yn.name]})
    return out


def dot_product_attention(querys, keys, values, name=None, **kwargs):
    """Scaled dot-product attention (reference fluid/nets.py
    scaled_dot_product_attention)."""
    helper = LayerHelper("dot_product_attention", name=name, **kwargs)
    logits = matmul(querys, keys, transpose_y=True,
                    alpha=1.0 / np.sqrt(keys.shape[-1]), **kwargs)
    weights = _single(helper, "softmax", {"X": [logits.name]})
    ctx = matmul(weights, values, **kwargs)
    return ctx, weights


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, **kwargs):
    """Hierarchical sigmoid over a complete binary tree (reference
    hierarchical_sigmoid / MatrixBitCode), computed densely."""
    helper = LayerHelper("hsigmoid", name=name, **kwargs)
    w = helper.create_parameter(param_attr,
                                shape=[num_classes - 1, input.shape[-1]],
                                dtype=input.dtype)
    inputs = {"X": [input.name], "W": [w.name], "Label": [label.name]}
    if bias_attr is not False:
        bias = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                       shape=[num_classes - 1],
                                       dtype=input.dtype, is_bias=True)
        inputs["Bias"] = [bias.name]
    return _single(helper, "hsigmoid", inputs,
                   {"num_classes": num_classes}, dtype=input.dtype)


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        **kwargs):
    helper = LayerHelper("nce", name=name, **kwargs)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr,
                                shape=[num_total_classes, dim],
                                dtype=input.dtype)
    inputs = {"Input": [input.name], "Label": [label.name],
              "Weight": [w.name]}
    if bias_attr is not False:
        b = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                    shape=[num_total_classes, 1],
                                    dtype=input.dtype, is_bias=True)
        inputs["Bias"] = [b.name]
    cost = helper.create_tmp_variable(input.dtype)
    logits = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    labels = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op(type="nce", inputs=inputs,
                     outputs={"Cost": [cost.name],
                              "SampleLogits": [logits.name],
                              "SampleLabels": [labels.name]},
                     attrs={"num_neg_samples": num_neg_samples,
                            "num_total_classes": num_total_classes})
    return cost


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None, **kwargs):
    helper = LayerHelper("row_conv", act=act, name=name, **kwargs)
    w = helper.create_parameter(param_attr,
                                shape=[future_context_size + 1,
                                       input.shape[-1]],
                                dtype=input.dtype)
    return _single(helper, "row_conv",
                   {"X": [input.name], "Filter": [w.name]}, act=True)


def prelu(x, param_attr=None, mode="all", name=None, **kwargs):
    helper = LayerHelper("prelu", name=name, **kwargs)
    if mode == "all":
        shape = [1]
    elif mode == "channel":
        shape = [x.shape[1]] + [1] * (len(x.shape) - 2)
    else:
        shape = list(x.shape[1:])
    alpha = helper.create_parameter(
        param_attr, shape=shape, dtype=x.dtype,
        default_initializer=ConstantInitializer(0.25))
    return _single(helper, "prelu",
                   {"X": [x.name], "Alpha": [alpha.name]})


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=1.0,
              name=None, **kwargs):
    helper = LayerHelper("smooth_l1", name=name, **kwargs)
    inputs = {"X": [x.name], "Y": [y.name]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight.name]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight.name]
    out = helper.create_tmp_variable(x.dtype)
    diff = helper.create_tmp_variable(x.dtype, stop_gradient=True)
    helper.append_op(type="smooth_l1_loss", inputs=inputs,
                     outputs={"Out": [out.name], "Diff": [diff.name]},
                     attrs={"sigma": sigma})
    return out


def log_loss(input, label, epsilon=1e-4, name=None, **kwargs):
    helper = LayerHelper("log_loss", name=name, **kwargs)
    return _single(helper, "log_loss",
                   {"Predicted": [input.name], "Labels": [label.name]},
                   {"epsilon": epsilon}, out_slot="Loss",
                   dtype=input.dtype)


def huber_loss(input, label, delta=1.0, name=None, **kwargs):
    helper = LayerHelper("huber_loss", name=name, **kwargs)
    out = helper.create_tmp_variable(input.dtype)
    resid = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    helper.append_op(type="huber_loss",
                     inputs={"X": [input.name], "Y": [label.name]},
                     outputs={"Out": [out.name], "Residual": [resid.name]},
                     attrs={"delta": delta})
    return out


def hinge_loss(input, label, name=None, **kwargs):
    helper = LayerHelper("hinge_loss", name=name, **kwargs)
    return _single(helper, "hinge_loss",
                   {"Logits": [input.name], "Labels": [label.name]},
                   out_slot="Loss", dtype=input.dtype)


def conv_shift(x, y, name=None, **kwargs):
    """Circular 1-D correlation (reference conv_shift_op / v2
    conv_shift_layer): out[b, i] = sum_j x[b, (i+j-M/2) mod N] * y[b, j]."""
    helper = LayerHelper("conv_shift", name=name, **kwargs)
    return _single(helper, "conv_shift",
                   {"X": [x.name], "Y": [y.name]}, {})


def rank_loss(left, right, label, name=None, **kwargs):
    helper = LayerHelper("rank_loss", name=name, **kwargs)
    return _single(helper, "rank_loss",
                   {"Left": [left.name], "Right": [right.name],
                    "Label": [label.name]}, dtype=left.dtype)


def margin_rank_loss(label, left, right, margin=0.1, name=None, **kwargs):
    helper = LayerHelper("margin_rank_loss", name=name, **kwargs)
    out = helper.create_tmp_variable(left.dtype)
    act = helper.create_tmp_variable(left.dtype, stop_gradient=True)
    helper.append_op(type="margin_rank_loss",
                     inputs={"X1": [left.name], "X2": [right.name],
                             "Label": [label.name]},
                     outputs={"Out": [out.name], "Activated": [act.name]},
                     attrs={"margin": margin})
    return out


def bilinear_tensor_product(x, y, size, param_attr=None, bias_attr=None,
                            act=None, name=None, **kwargs):
    helper = LayerHelper("bilinear_tensor_product", act=act, name=name,
                         **kwargs)
    w = helper.create_parameter(param_attr,
                                shape=[size, x.shape[-1], y.shape[-1]],
                                dtype=x.dtype)
    inputs = {"X": [x.name], "Y": [y.name], "Weight": [w.name]}
    if bias_attr is not False:
        b = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                    shape=[size], dtype=x.dtype,
                                    is_bias=True)
        inputs["Bias"] = [b.name]
    return _single(helper, "bilinear_tensor_product", inputs, act=True,
                   dtype=x.dtype)


def spp(input, pyramid_height=3, pool_type="max", name=None, **kwargs):
    helper = LayerHelper("spp", name=name, **kwargs)
    return _single(helper, "spp", {"X": [input.name]},
                   {"pyramid_height": pyramid_height,
                    "pooling_type": pool_type})


def linear_chain_crf(input, label, length=None, param_attr=None,
                     name=None, **kwargs):
    """CRF negative log-likelihood cost (reference
    fluid/layers linear_chain_crf). input: [N,T,C] emissions."""
    helper = LayerHelper("linear_chain_crf", name=name, **kwargs)
    num_classes = input.shape[-1]
    transition = helper.create_parameter(
        param_attr, shape=[num_classes + 2, num_classes],
        dtype=input.dtype,
        default_initializer=NormalInitializer(0.0, 0.1))
    inputs = {"Emission": [input.name], "Label": [label.name],
              "Transition": [transition.name]}
    if length is not None:
        inputs["Length"] = [length.name]
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="linear_chain_crf", inputs=inputs,
                     outputs={"LogLikelihood": [out.name]})
    return out


def crf_decoding(input, param_attr, length=None, name=None, **kwargs):
    """Viterbi decode using a trained CRF transition parameter."""
    helper = LayerHelper("crf_decoding", name=name, **kwargs)
    transition = helper.create_parameter(
        ParamAttr.to_attr(param_attr),
        shape=[input.shape[-1] + 2, input.shape[-1]], dtype=input.dtype)
    inputs = {"Emission": [input.name], "Transition": [transition.name]}
    if length is not None:
        inputs["Length"] = [length.name]
    out = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [out.name]})
    return out


def warpctc(input, label, logits_length, label_length, blank=0,
            norm_by_times=False, name=None, **kwargs):
    """CTC loss (reference warpctc layer). input: [N,T,C] logits."""
    helper = LayerHelper("warpctc", name=name, **kwargs)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="warpctc",
                     inputs={"Logits": [input.name],
                             "Label": [label.name],
                             "LogitsLength": [logits_length.name],
                             "LabelLength": [label_length.name]},
                     outputs={"Loss": [out.name]},
                     attrs={"blank": blank,
                            "norm_by_times": norm_by_times})
    return out


def edit_distance(input, label, input_length, label_length,
                  normalized=True, name=None, **kwargs):
    helper = LayerHelper("edit_distance", name=name, **kwargs)
    out = helper.create_tmp_variable("float32", stop_gradient=True)
    seq_num = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op(type="edit_distance",
                     inputs={"Hyps": [input.name], "Refs": [label.name],
                             "HypsLength": [input_length.name],
                             "RefsLength": [label_length.name]},
                     outputs={"Out": [out.name],
                              "SequenceNum": [seq_num.name]},
                     attrs={"normalized": normalized})
    return out, seq_num


def ctc_greedy_decoder(input, blank, length, name=None, **kwargs):
    """argmax over classes then CTC-align (merge repeats, drop blanks)."""
    helper = LayerHelper("ctc_greedy_decoder", name=name, **kwargs)
    ids = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op(type="arg_max", inputs={"X": [input.name]},
                     outputs={"Out": [ids.name]}, attrs={"axis": -1})
    out = helper.create_tmp_variable("int64", stop_gradient=True)
    out_len = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op(type="ctc_align",
                     inputs={"Input": [ids.name],
                             "Length": [length.name]},
                     outputs={"Output": [out.name],
                              "OutputLength": [out_len.name]},
                     attrs={"blank": blank})
    return out, out_len


def conv3d_transpose(input, num_filters, filter_size, stride=1, padding=0,
                     dilation=1, param_attr=None, bias_attr=None, act=None,
                     name=None, **kwargs):
    """3-D transposed conv (reference conv3d_transpose /
    conv_transpose_op.cc)."""
    helper = LayerHelper("conv3d_transpose", act=act, name=name, **kwargs)
    num_channels = input.shape[1]
    fs = [filter_size] * 3 if isinstance(filter_size, int) \
        else list(filter_size)
    stride = [stride] * 3 if isinstance(stride, int) else list(stride)
    padding = [padding] * 3 if isinstance(padding, int) else list(padding)
    dilation = [dilation] * 3 if isinstance(dilation, int) \
        else list(dilation)
    w = helper.create_parameter(param_attr,
                                shape=[num_channels, num_filters] + fs,
                                dtype=input.dtype)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="conv3d_transpose",
                     inputs={"Input": [input.name], "Filter": [w.name]},
                     outputs={"Output": [out.name]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation})
    if bias_attr is not False:
        out = helper.append_bias_op(out, ParamAttr.to_attr(bias_attr),
                                    dim_start=1, dim_end=2)
    return helper.append_activation(out)


def factorization_machine(input, factor_size, param_attr=None, act=None,
                          name=None, **kwargs):
    """Second-order factorization machine interaction term (reference
    FactorizationMachineLayer.cpp): out[n] = 0.5 * sum_k((x@V)_k^2 -
    (x^2@V^2)_k). Combine with an fc for the linear term."""
    helper = LayerHelper("factorization_machine", act=act, name=name,
                         **kwargs)
    dim = input.shape[-1]
    v = helper.create_parameter(param_attr, shape=[dim, factor_size],
                                dtype=input.dtype)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="factorization_machine",
                     inputs={"X": [input.name], "V": [v.name]},
                     outputs={"Out": [out.name]})
    return helper.append_activation(out)


def switch_order(input, to_nhwc=True, name=None, **kwargs):
    """NCHW <-> NHWC layout switch (reference SwitchOrderLayer)."""
    helper = LayerHelper("switch_order", name=name, **kwargs)
    return _single(helper, "switch_order", {"X": [input.name]},
                   {"to_nhwc": to_nhwc})


def scale_shift(input, param_attr=None, bias_attr=None, name=None,
                **kwargs):
    """y = w*x + b with trainable scalar w (and b unless bias_attr is
    False) — reference ScaleShiftLayer."""
    helper = LayerHelper("scale_shift", name=name, **kwargs)
    w = helper.create_parameter(param_attr, shape=[1], dtype=input.dtype)
    inputs = {"X": [input.name], "Scale": [w.name]}
    if bias_attr is not False:
        b = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                    shape=[1], dtype=input.dtype,
                                    is_bias=True)
        inputs["Bias"] = [b.name]
    return _single(helper, "scale_shift", inputs, {})


def resize(input, size, name=None, **kwargs):
    """Reshape rows to trailing ``size`` (reference ResizeLayer)."""
    helper = LayerHelper("resize", name=name, **kwargs)
    return _single(helper, "resize", {"X": [input.name]},
                   {"size": size})


def kmax_seq_score(input, length=None, beam_size=1, name=None,
                   **kwargs):
    """Top-k score indices per padded sequence (reference
    KmaxSeqScoreLayer); -1 marks slots past a sequence's k."""
    helper = LayerHelper("kmax_seq_score", name=name, **kwargs)
    inputs = {"X": [input.name]}
    if length is not None:
        inputs["Length"] = [length.name]
    out = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op(type="kmax_seq_score", inputs=inputs,
                     outputs={"Out": [out.name]},
                     attrs={"beam_size": beam_size})
    return out


def scale_sub_region(input, indices, value=1.0, name=None, **kwargs):
    """Scale a per-sample NCHW sub-region by ``value`` (reference
    ScaleSubRegionLayer; indices [N,6] 1-based inclusive
    (c1,c2,h1,h2,w1,w2))."""
    helper = LayerHelper("scale_sub_region", name=name, **kwargs)
    return _single(helper, "scale_sub_region",
                   {"X": [input.name], "Indices": [indices.name]},
                   {"value": value})
