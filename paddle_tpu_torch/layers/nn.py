"""Core NN layers of the program front end (reference
``paddle_tpu/layers/nn.py``): the ones ResNet and transformer LM
programs use, ``fc``, ``embedding``, ``conv2d``, ``pool2d``,
``batch_norm``, ``fused_conv_bn``, ``layer_norm``, ``dropout``,
``softmax_with_cross_entropy``, ``accuracy``, ``matmul``, ``mul``,
``reduce_sum``, ``mean`` and ``elementwise_add``, ``_mul`` and ``_div``.

Each layer appends ops to the current program; output shapes and dtypes
are inferred by running the op's torch compute on meta tensors
(``core/registry.py`` ``infer_shape``). The rest of the reference's
layers are not ported yet (ROADMAP Queue A, "LeNet-5/MNIST slice").
"""

import numpy as np

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from ..initializer import ConstantInitializer, NormalInitializer

__all__ = ["fc", "embedding", "conv2d", "pool2d", "batch_norm",
           "fused_conv_bn", "layer_norm", "dropout",
           "softmax_with_cross_entropy", "accuracy", "matmul", "mul",
           "reduce_sum", "mean", "elementwise_add", "elementwise_mul",
           "elementwise_div"]


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
    initialized normal(0, 1/sqrt(dim)), its gradient a dense scatter-add.
    The reference's sharded table (``is_distributed``) is not ported and
    raises; an ``is_sparse`` table builds, and ``append_backward`` refuses
    its sparse gradient."""
    if is_distributed:
        raise NotImplementedError(
            "a distributed embedding table is not ported yet: ROADMAP "
            "Queue A, \"Distribution and the input pipeline\"")
    helper = LayerHelper("embedding", name=name, **kwargs)
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


def reduce_sum(input, dim=None, keep_dim=False, name=None, **kwargs):
    helper = LayerHelper("reduce_sum", name=name, **kwargs)
    return _single(helper, "reduce_sum", {"X": [input.name]},
                   {"dim": dim, "keep_dim": keep_dim,
                    "reduce_all": dim is None})


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
elementwise_mul = _make_elementwise("elementwise_mul")
elementwise_div = _make_elementwise("elementwise_div")
