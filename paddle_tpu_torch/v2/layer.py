"""v2 layer DSL — the full ~85-function keyword-argument surface of
``python/paddle/trainer_config_helpers/layers.py`` (SURVEY A.5) plus
the projection/operator family for mixed_layer, lowered onto the
fluid-style layers. Sequence-typed data layers produce a padded
(data, length) pair under the hood (the LoD replacement, SURVEY §5.7);
every v2 layer that consumed LoD consults the hidden length var.

Naming: the reference exports both ``fc_layer``-style names and bare
``fc`` (via ``paddle.v2.layer``'s __convert_to_v2__); this module uses
the bare names and aliases the ``*_layer`` spellings.

The port's copy of ``paddle_tpu/v2/layer.py``: it imports nothing of
that package.
"""

import numpy as np

from .. import layers as _L
from .. import nets as _nets
from ..param_attr import ParamAttr
from . import activation as _act
from . import data_type as _dt

# var name -> (InputType, length var or None); scoped per program


def _input_types(program=None):
    """var name -> (InputType, length var) feeding table, scoped to the
    owning program (a module-level global keyed by user-chosen names
    would leak stale entries across topologies that reuse a name, e.g.
    two models both calling their input 'pixel')."""
    from ..core.framework import default_main_program
    prog = program or default_main_program()
    table = getattr(prog, "_v2_input_types", None)
    if table is None:
        table = prog._v2_input_types = {}
    return table


def _length_of(var):
    entry = _input_types().get(
        getattr(var, "_v2_source", None) or var.name)
    return entry[1] if entry else getattr(var, "_v2_length", None)


def _tag(out, src):
    """Propagate the sequence-length (and sub-length) vars through
    unary layers."""
    ln = _length_of(src)
    if ln is not None:
        out._v2_length = ln
    sl = getattr(src, "_v2_sublen", None)
    if sl is not None:
        out._v2_sublen = sl
    return out


def _act_name(act):
    return getattr(act, "name", act) if act is not None else None


def _first(input):
    return input[0] if isinstance(input, (list, tuple)) else input


# ---- data / io -------------------------------------------------------

def data(name, type, **kwargs):
    """v2 data layer: shape/dtype/sequence-ness from the InputType.

    Realizations (data_type.py, SURVEY §5.7 static shapes):
    * sequence -> padded ids/values + ``name@len`` length var;
    * sub-sequence (seq_type=2) -> [B, S, T, ...] + ``name@len`` [B] +
      ``name@sublen`` [B, S] (ops/nested_ops.py convention);
    * sparse pair types (sparse_float_vector*, sparse_binary_vector
      at sequence levels) -> ragged-K ids + ``name@value`` weights
      (all-ones for binary rows), one extra trailing K axis below the
      sequence levels — reference SparseFloat/SparseBinaryScanner
      (py_paddle/dataprovider_converter.py:154,184)."""
    if getattr(type, "is_sparse_pair", False):
        ndim = type.seq_type + 1  # K, plus one axis per seq level
        var = _L.data(name, shape=[None] * ndim, dtype="int64",
                      **kwargs)
        values = _L.data(name + "@value", shape=[None] * ndim,
                         dtype="float32", **kwargs)
        var._v2_value = values
        length = None
        if type.seq_type >= 1:
            length = _L.data(name + "@len", shape=[], dtype="int64",
                             **kwargs)
            var._v2_length = length
        if type.seq_type == 2:
            sublen = _L.data(name + "@sublen", shape=[None],
                             dtype="int64", **kwargs)
            var._v2_sublen = sublen
        _input_types()[var.name] = (type, length)
        return var
    if getattr(type, "is_nested", False):
        var = _L.data(name, shape=[None, None], dtype=type.dtype,
                      **kwargs)
        length = _L.data(name + "@len", shape=[], dtype="int64",
                         **kwargs)
        sublen = _L.data(name + "@sublen", shape=[None], dtype="int64",
                         **kwargs)
        var._v2_length = length
        var._v2_sublen = sublen
        _input_types()[var.name] = (type, length)
        return var
    if type.is_seq:
        var = _L.data(name, shape=[None], dtype=type.dtype, **kwargs)
        length = _L.data(name + "@len", shape=[], dtype="int64",
                         **kwargs)
        var._v2_length = length
        _input_types()[var.name] = (type, length)
        return var
    shape = [type.dim] if type.dtype == "float32" else [1]
    var = _L.data(name, shape=shape, dtype=type.dtype, **kwargs)
    _input_types()[var.name] = (type, None)
    return var


def printer(input, format=None, **kwargs):
    """Print layer (reference printer_layer / Print op)."""
    return _L.Print(_first(input), message=format or "")


# ---- core nn ---------------------------------------------------------

def _sparse_float_rowsum(input, width, param_attr=None):
    """sum_k values_k * Table[ids_k] — the sparse-row × dense-matrix
    product of the reference's sparse_float_vector path
    (``math/CpuSparseMatrix.h:24``, fc over sparse input) computed by
    gather + weighted sum; the dense [B, dim] row never materializes."""
    entry = _input_types().get(input.name)
    if entry is None:
        raise ValueError("sparse-float input %r has no registered "
                         "InputType" % input.name)
    vocab = entry[0].dim
    rows = _L.embedding(input, size=[vocab, width],
                        param_attr=param_attr,
                        keep_dims=True)               # [..., K, width]
    weighted = _L.elementwise_mul(rows, input._v2_value, axis=0)
    # sum over K (the ragged sparse-row axis); 0-padded values make
    # padding rows no-ops, so no mask is needed
    return _tag(_L.reduce_sum(weighted, dim=-2), input)


def fc(input, size, act=None, param_attr=None, bias_attr=None, **kwargs):
    inputs = input if isinstance(input, (list, tuple)) else [input]
    if any(getattr(v, "_v2_value", None) is not None for v in inputs):
        parts = []
        for v in inputs:
            if getattr(v, "_v2_value", None) is not None:
                parts.append(_sparse_float_rowsum(v, size, param_attr))
            else:
                parts.append(_L.fc(
                    v, size, bias_attr=False, param_attr=param_attr,
                    num_flatten_dims=2 if len(v.shape or ()) >= 3
                    else 1, **kwargs))
        out = parts[0] if len(parts) == 1 else _L.sums(parts)
        if bias_attr is not False:
            from ..layer_helper import LayerHelper
            helper = LayerHelper("fc_sparse_bias")
            b = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                        shape=[size], dtype=out.dtype,
                                        is_bias=True)
            out = _L.elementwise_add(out, b)
        act_n = _act_name(act)
        out = getattr(_L, act_n)(out) if act_n else out
        if act_n == "softmax":
            out._v2_softmaxed = True
        # bias/act wrap fresh Variables — re-tag sequence lengths so
        # downstream pooling masks padding (first tagged input wins)
        for v in inputs:
            if _length_of(v) is not None:
                return _tag(out, v)
        return out
    ndim = max(len(v.shape or ()) for v in inputs)
    out = _L.fc(input, size, act=_act_name(act), param_attr=param_attr,
                bias_attr=bias_attr,
                num_flatten_dims=2 if ndim >= 3 else 1, **kwargs)
    if _act_name(act) == "softmax":
        out._v2_softmaxed = True  # classification_cost picks plain CE
    return _tag(out, inputs[0])


def embedding(input, size, param_attr=None, **kwargs):
    entry = _input_types().get(input.name)
    vocab = entry[0].dim if entry else None
    if vocab is None:
        raise ValueError("embedding needs a data layer with "
                         "integer_value[_sequence] type")
    out = _L.embedding(input, size=[vocab, size], param_attr=param_attr,
                       **kwargs)
    return _tag(out, input)


def selective_fc(input, size, select=None, act=None, param_attr=None,
                 bias_attr=None, **kwargs):
    return _tag(_L.selective_fc(_first(input), size, select=select,
                                act=_act_name(act),
                                param_attr=param_attr,
                                bias_attr=bias_attr, **kwargs),
                _first(input))


def tensor(a, b, size, act=None, param_attr=None, bias_attr=None,
           **kwargs):
    """tensor_layer: y = a^T W b (bilinear)."""
    out = _L.bilinear_tensor_product(a, b, size,
                                     param_attr=param_attr,
                                     bias_attr=bias_attr, **kwargs)
    act_n = _act_name(act)
    return getattr(_L, act_n)(out) if act_n else out


def data_norm(input, mode="z-score", stats=None, **kwargs):
    return _L.data_norm(input, mode=mode, stats=stats, **kwargs)


# ---- conv / pool / norm family --------------------------------------

def img_conv(input, filter_size, num_filters, num_channels=None,
             act=None, padding=0, stride=1, groups=1, param_attr=None,
             bias_attr=None, **kwargs):
    return _L.conv2d(input, num_filters=num_filters,
                     filter_size=filter_size, padding=padding,
                     stride=stride, groups=groups,
                     act=_act_name(act), param_attr=param_attr,
                     bias_attr=bias_attr, **kwargs)


def img_conv3d(input, filter_size, num_filters, act=None, padding=0,
               stride=1, **kwargs):
    out = _L.conv3d(input, num_filters=num_filters,
                    filter_size=filter_size, padding=padding,
                    stride=stride, **kwargs)
    act_n = _act_name(act)
    return getattr(_L, act_n)(out) if act_n else out


def img_pool(input, pool_size, pool_type=None, stride=1, padding=0,
             **kwargs):
    ptype = getattr(pool_type, "name", None) or "max"
    if ptype in ("average", "avg"):
        ptype = "avg"
    return _L.pool2d(input, pool_size=pool_size, pool_type=ptype,
                     pool_stride=stride, pool_padding=padding, **kwargs)


def img_pool3d(input, pool_size, pool_type=None, stride=1, padding=0,
               **kwargs):
    ptype = getattr(pool_type, "name", None) or "max"
    if ptype in ("average", "avg"):
        ptype = "avg"
    return _L.pool3d(input, pool_size=pool_size, pool_type=ptype,
                     pool_stride=stride, pool_padding=padding, **kwargs)


def img_cmrnorm(input, size=5, scale=0.0001, power=0.75, **kwargs):
    """Cross-map response norm = LRN (reference img_cmrnorm_layer)."""
    return _L.lrn(input, n=size, alpha=scale, beta=power, **kwargs)


def batch_norm(input, act=None, is_test=False, **kwargs):
    return _L.batch_norm(input, act=_act_name(act), is_test=is_test,
                         **kwargs)


def spp(input, pyramid_height=3, pool_type=None, **kwargs):
    ptype = getattr(pool_type, "name", None) or "max"
    return _L.spp(input, pyramid_height=pyramid_height,
                  pool_type=ptype, **kwargs)


def maxout(input, groups, **kwargs):
    return _L.maxout(input, groups=groups, **kwargs)


def pad(input, pad_c=None, pad_h=None, pad_w=None, **kwargs):
    """Pad NCHW maps per dim ([before, after] each; reference
    pad_layer)."""
    c, h, w = (pad_c or [0, 0]), (pad_h or [0, 0]), (pad_w or [0, 0])
    return _L.pad(input, paddings=[0, 0, c[0], c[1], h[0], h[1],
                                   w[0], w[1]], **kwargs)


def crop(input, offset, shape, **kwargs):
    return _L.crop(input, offsets=offset, shape=shape, **kwargs)


def block_expand(input, block_x, block_y, stride_x=None, stride_y=None,
                 padding_x=0, padding_y=0, **kwargs):
    """im2sequence (reference BlockExpandLayer); padding applied as an
    explicit pad of the maps first."""
    x = input
    if padding_x or padding_y:
        x = _L.pad(x, paddings=[0, 0, 0, 0, padding_y, padding_y,
                                padding_x, padding_x])
    return _L.im2sequence(
        x, filter_size=[block_y, block_x],
        stride=[stride_y or block_y, stride_x or block_x], **kwargs)


def rotate(input, height, width, **kwargs):
    return _L.rotate(input, height=height, width=width, **kwargs)


def resize(input, size, **kwargs):
    return _L.resize(input, size=size, **kwargs)


def bilinear_interp(input, out_size_x, out_size_y, **kwargs):
    return _L.bilinear_interp(input, out_h=out_size_y,
                              out_w=out_size_x, **kwargs)


def switch_order(input, reshape_order=None, **kwargs):
    """switch_order_layer: NCHW <-> NHWC (the only two orders the
    reference SwitchOrderLayer supports)."""
    if reshape_order in (None, [0, 2, 3, 1], (0, 2, 3, 1)):
        return _L.switch_order(input, to_nhwc=True, **kwargs)
    if reshape_order in ([0, 3, 1, 2], (0, 3, 1, 2)):
        return _L.switch_order(input, to_nhwc=False, **kwargs)
    raise ValueError("switch_order supports NCHW<->NHWC orders "
                     "[0,2,3,1] / [0,3,1,2], got %r" % (reshape_order,))


def scale_shift(input, param_attr=None, bias_attr=None, **kwargs):
    return _L.scale_shift(input, param_attr=param_attr,
                          bias_attr=bias_attr, **kwargs)


def scale_sub_region(input, indices, value=1.0, **kwargs):
    return _L.scale_sub_region(input, indices, value=value, **kwargs)


def sum_to_one_norm(input, **kwargs):
    return _tag(_L.sum_to_one_norm(input), input)


def row_l2_norm(input, **kwargs):
    return _tag(_L.row_l2_norm(input), input)


def cross_channel_norm(input, param_attr=None, **kwargs):
    """Per-pixel L2 norm across channels x learned per-channel scale
    (reference cross_channel_norm_layer / CrossChannelNormLayer,
    SSD)."""
    from ..layer_helper import LayerHelper
    helper = LayerHelper("cross_channel_norm", **kwargs)
    c = input.shape[1]
    scale = helper.create_parameter(
        param_attr, shape=[1, c, 1, 1], dtype=input.dtype)
    normed = _L.l2_normalize(input, axis=1)
    return _L.elementwise_mul(normed, scale)


def prelu(input, param_attr=None, **kwargs):
    return _L.prelu(input, param_attr=param_attr, **kwargs)


def dropout(input, dropout_rate=0.5, **kwargs):
    return _tag(_L.dropout(input, dropout_prob=dropout_rate, **kwargs),
                input)


def clip(input, min, max, **kwargs):
    return _tag(_L.clip(input, min=min, max=max), input)


# ---- elementwise / math layers --------------------------------------

def addto(input, act=None, bias_attr=None, **kwargs):
    inputs = input if isinstance(input, (list, tuple)) else [input]
    out = _L.sums(list(inputs))
    act_n = _act_name(act)
    out = getattr(_L, act_n)(out) if act_n else out
    return _tag(out, inputs[0])


def concat(input, act=None, **kwargs):
    out = _L.concat(list(input), axis=-1, **kwargs)
    act_n = _act_name(act)
    out = getattr(_L, act_n)(out) if act_n else out
    return _tag(out, input[0])


def interpolation(input, weight, **kwargs):
    """interpolation_layer(input=[x1, x2], weight): w*x1+(1-w)*x2."""
    x1, x2 = input
    return _tag(_L.interpolation(x1, x2, weight), x1)


def linear_comb(weights, vectors, size, **kwargs):
    return _L.linear_comb(weights, vectors, size, **kwargs)


def slope_intercept(input, slope=1.0, intercept=0.0, **kwargs):
    return _tag(_L.slope_intercept(input, slope, intercept), input)


def power(input, weight, **kwargs):
    return _tag(_L.power(input, weight), input)


def scaling(input, weight, **kwargs):
    """scaling_layer: per-row scalar weight * input."""
    return _tag(_L.elementwise_mul(input, weight), input)


def trans(input, **kwargs):
    return _L.trans(input)


def repeat(input, num_repeats, as_row_vector=True, act=None, **kwargs):
    out = _L.repeat(input, num_repeats, as_row_vector=as_row_vector)
    act_n = _act_name(act)
    return getattr(_L, act_n)(out) if act_n else out


def expand(input, expand_as, expand_level="non-seq", **kwargs):
    """expand_layer: broadcast per-sequence rows to per-timestep
    (padded analog of the LoD expand)."""
    out = _L.sequence_expand(input, expand_as,
                             y_length=_length_of(expand_as), **kwargs)
    return _tag(out, expand_as)


def dot_prod(input1, input2, **kwargs):
    """Per-row dot product [B, 1] (reference dot_prod_layer)."""
    prod = _L.elementwise_mul(input1, input2)
    return _L.reduce_sum(prod, dim=-1, keep_dim=True)


def out_prod(input1, input2, **kwargs):
    return _L.out_prod(input1, input2, **kwargs)


def cos_sim(a, b, scale=1, **kwargs):
    out = _L.cos_sim(a, b, **kwargs)
    return _L.scale(out, scale=float(scale)) if scale != 1 else out


def l2_distance(x, y, **kwargs):
    return _L.l2_distance(x, y, **kwargs)


def multiplex(input, **kwargs):
    """multiplex_layer: input[0] is the per-row index layer, the rest
    are candidates."""
    index, cands = input[0], list(input[1:])
    return _L.multiplex(cands, index, **kwargs)


def gated_unit(input, size, act=None, gate_param_attr=None,
               gate_bias_attr=None, inproj_param_attr=None,
               inproj_bias_attr=None, **kwargs):
    return _L.gated_unit(input, size, act=_act_name(act),
                         gate_param_attr=gate_param_attr,
                         gate_bias_attr=gate_bias_attr,
                         inproj_param_attr=inproj_param_attr,
                         inproj_bias_attr=inproj_bias_attr, **kwargs)


def factorization_machine(input, factor_size, param_attr=None,
                          **kwargs):
    return _L.factorization_machine(input, factor_size,
                                    param_attr=param_attr, **kwargs)


def conv_shift(a, b, **kwargs):
    return _L.conv_shift(a, b, **kwargs)


def row_conv(input, context_len, act=None, param_attr=None, **kwargs):
    out = _L.row_conv(input, future_context_size=context_len - 1,
                      param_attr=param_attr, **kwargs)
    act_n = _act_name(act)
    return _tag(getattr(_L, act_n)(out) if act_n else out, input)


# ---- sequence layers -------------------------------------------------

def pooling(input, pooling_type=None, **kwargs):
    """Sequence pooling over the time axis (v2 pooling layer). On a
    sub-sequence input ([B, S, T, ...] + sub-lengths) it pools the
    INNERMOST level -> [B, S, ...] still tagged as an outer sequence —
    the reference's sequence_pool over a 2-level LoD; pool again for
    [B, ...]."""
    ptype = getattr(pooling_type, "name", None) or "max"
    sublen = getattr(input, "_v2_sublen", None)
    if sublen is not None:
        out = _L.nested_sequence_pool(input, sublen, pool_type=ptype,
                                      **kwargs)
        out._v2_length = input._v2_length
        return out
    return _L.sequence_pool(input, ptype, length=_length_of(input),
                            **kwargs)


def last_seq(input, **kwargs):
    return _L.sequence_last_step(input, length=_length_of(input),
                                 **kwargs)


def first_seq(input, **kwargs):
    return _L.sequence_first_step(input, length=_length_of(input),
                                  **kwargs)


def seq_concat(a, b, **kwargs):
    """Per-sample time concatenation. With known lengths the packed op
    shifts b behind a's valid prefix; otherwise a plain time-axis
    concat (full-length sequences)."""
    la, lb = _length_of(a), _length_of(b)
    if la is not None and lb is not None:
        out, ln = _L.sequence_concat_packed(a, b, la, lb)
        out._v2_length = ln
        return out
    return _L.sequence_concat([a, b], **kwargs)


def seq_reshape(input, reshape_size, **kwargs):
    out, new_len = _L.sequence_reshape(input, new_dim=reshape_size,
                                       length=_length_of(input),
                                       **kwargs)
    if new_len is not None:
        out._v2_length = new_len
    return out


def seq_slice(input, starts=0, ends=None, **kwargs):
    ends = ends if ends is not None else input.shape[1]
    return _L.sequence_slice(input, starts, ends - starts, **kwargs)


def sub_seq(input, offsets, sizes, max_size=None, **kwargs):
    out, new_len = _L.sub_seq(input, offsets, sizes,
                              max_size or input.shape[1], **kwargs)
    out._v2_length = new_len
    return out


def sub_nested_seq(input, selected_indices, sub_len=None, **kwargs):
    """sub_nested_seq_layer: select sub-sequences by index. The
    reference carried sub-lengths in the nested LoD; the padded analog
    defaults every sub-sequence to the full inner time axis."""
    if sub_len is None:
        t = input.shape[2]
        s_dim = input.shape[1]
        sub_len = _L.fill_constant_batch_size_like(
            input, [-1, s_dim], "int64", t)
    return _L.sub_nested_seq(input, sub_len, selected_indices,
                             **kwargs)


def kmax_seq_score(input, beam_size=1, **kwargs):
    return _L.kmax_seq_score(input, length=_length_of(input),
                             beam_size=beam_size, **kwargs)


def maxid(input, **kwargs):
    out, idx = _L.topk(input, k=1, **kwargs)
    return idx


max_id = maxid


def eos(input, eos_id, **kwargs):
    return _L.eos(input, eos_id, **kwargs)


def sampling_id(input, **kwargs):
    from ..layer_helper import LayerHelper
    helper = LayerHelper("sampling_id", **kwargs)
    out = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op(type="sampling_id",
                     inputs={"X": [_first(input).name]},
                     outputs={"Out": [out.name]}, attrs={})
    return out


# ---- recurrent -------------------------------------------------------

def lstmemory(input, size=None, reverse=False, act=None,
              param_attr=None, bias_attr=None, **kwargs):
    """Fused LSTM over a [B, T, 4H] projected sequence (reference
    lstmemory: input must be width 4*size). Returns hidden states
    [B, T, H]."""
    size = size or input.shape[-1] // 4
    h, c = _L.dynamic_lstm(input, size, length=_length_of(input),
                           is_reverse=reverse, param_attr=param_attr,
                           bias_attr=bias_attr, **kwargs)
    return _tag(h, input)


def grumemory(input, size=None, reverse=False, act=None,
              param_attr=None, bias_attr=None, **kwargs):
    size = size or input.shape[-1] // 3
    h = _L.dynamic_gru(input, size, length=_length_of(input),
                       is_reverse=reverse, param_attr=param_attr,
                       bias_attr=bias_attr, **kwargs)
    return _tag(h, input)


class StaticInput:
    """Non-time-varying input to recurrent_group (reference
    StaticInput)."""

    def __init__(self, input, is_seq=False, size=None):
        self.input = input
        self.is_seq = is_seq
        self.size = size


_GROUP_STACK = []


def memory(name=None, size=None, boot_layer=None, **kwargs):
    """Step memory inside recurrent_group (reference memory()). Returns
    the previous step's value; the step function updates it by calling
    ``update_memory(mem, new)`` (explicit here — the reference's
    implicit update-by-name relies on its global layer-name registry;
    documented divergence) or by returning it from lstm_step/gru_step.
    """
    from ..core import unique_name as _un
    if not _GROUP_STACK:
        raise RuntimeError("memory() outside a recurrent_group step")
    rnn, outer_anchor = _GROUP_STACK[-1]
    if boot_layer is None:
        # zero boot, batch-sized like the OUTER sequence input: the
        # init is read by the scan setup in the parent block, so the
        # fill op must live there, not in the step sub-block
        parent = rnn.parent_block
        boot_layer = parent.create_var(
            name=_un.generate("v2.memory_boot"), dtype="float32",
            shape=(-1, size), stop_gradient=True)
        parent.append_op(
            "fill_constant_batch_size_like",
            inputs={"Input": [outer_anchor.name]},
            outputs={"Out": [boot_layer.name]},
            attrs={"shape": [-1, size], "dtype": "float32",
                   "value": 0.0, "input_dim_idx": 0,
                   "output_dim_idx": 0})
    if hasattr(rnn, "state"):          # BeamSearchDecoder context
        mem = rnn.state(boot_layer)
    else:
        mem = rnn.memory(init=boot_layer)
    mem._v2_memory = True
    return mem


def update_memory(mem, new):
    if not _GROUP_STACK:
        raise RuntimeError("update_memory outside a recurrent_group")
    rnn, _ = _GROUP_STACK[-1]
    if hasattr(rnn, "update_state"):   # BeamSearchDecoder context
        rnn.update_state(mem, new)
    else:
        rnn.update_memory(mem, new)
    return new


def recurrent_group(step, input, reverse=False, **kwargs):
    """Run ``step`` over the time axis (reference recurrent_group /
    RecurrentLayerGroup). ``input``: sequence vars ([B, T, D]) sliced
    per step, or StaticInput passed whole. The step's return value(s)
    become [B, T, ...] outputs."""
    inputs = input if isinstance(input, (list, tuple)) else [input]
    rnn = _L.StaticRNN(is_reverse=reverse)
    seq_vars = [v for v in inputs if not isinstance(v, StaticInput)]
    outer_anchor = seq_vars[0] if seq_vars else None
    with rnn.step():
        step_args = []
        for v in inputs:
            if isinstance(v, StaticInput):
                step_args.append(v.input)
            else:
                step_args.append(rnn.step_input(v))
        _GROUP_STACK.append((rnn, outer_anchor))
        try:
            outs = step(*step_args)
        finally:
            _GROUP_STACK.pop()
        outs_t = outs if isinstance(outs, (list, tuple)) else [outs]
        for o in outs_t:
            rnn.step_output(o)
    result = rnn()
    result_t = result if isinstance(result, (list, tuple)) else [result]
    src = seq_vars[0] if seq_vars else None
    if src is not None:
        for r in result_t:
            _tag(r, src)
    return result if not isinstance(result, (list, tuple)) else \
        (result_t[0] if len(result_t) == 1 else result_t)


def lstm_step(input, state, size=None, act=None, gate_act=None,
              state_act=None, **kwargs):
    """One LSTM step inside recurrent_group (reference lstm_step_layer):
    input = x projection [B, 4H], state = cell memory. Returns hidden;
    updates the cell memory in place."""
    from ..layer_helper import LayerHelper
    size = size or state.shape[-1]
    helper = LayerHelper("v2_lstm_step", **kwargs)
    h = helper.create_tmp_variable(input.dtype)
    c = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="lstm_unit",
                     inputs={"X": [input.name],
                             "C_prev": [state.name]},
                     outputs={"H": [h.name], "C": [c.name]})
    update_memory(state, c)
    return h


def gru_step(input, output_mem, size=None, act=None, gate_act=None,
             **kwargs):
    """One GRU step inside recurrent_group (reference gru_step_layer):
    input = x projection [B, 3H], output_mem = previous hidden."""
    size = size or output_mem.shape[-1]
    h, _gate, _reset = _L.gru_unit(input, output_mem, size, **kwargs)
    update_memory(output_mem, h)
    return h


gru_step_naive = gru_step


def get_output(input, arg_name=None, **kwargs):
    """get_output_layer: select one of a multi-output layer's results
    (here: tuples are first-class, so this is indexing)."""
    if isinstance(input, (list, tuple)):
        idx = {"state": 1, "hidden": 0}.get(arg_name, 0)
        return input[idx]
    return input


def recurrent(input, act=None, reverse=False, param_attr=None,
              bias_attr=None, **kwargs):
    """Simple full-matrix recurrent layer (reference recurrent_layer):
    h_t = act(x_t + W h_{t-1})."""
    size = input.shape[-1]

    def step(x):
        prev = memory(size=size)
        h = fc([x, prev], size, act=act or _act.Tanh(),
               param_attr=param_attr, bias_attr=bias_attr)
        update_memory(prev, h)
        return h

    return recurrent_group(step, input, reverse=reverse)


def beam_search(step, input, bos_id, eos_id, beam_size=4,
                max_length=16, **kwargs):
    """v2 beam-search generation (reference beam_search): ``step``
    receives (token_embedding_maker-style) the current token var and
    any StaticInputs, and must return the per-step softmax/logits var.
    Implemented on the generic BeamSearchDecoder (see
    layers/beam_search.py; the same engine drives the seq2seq and
    transformer generate paths). Returns (ids, lengths, scores)."""
    statics = [v for v in (input if isinstance(input, (list, tuple))
                           else [input])]
    bs = _L.BeamSearchDecoder(beam_size=beam_size, max_len=max_length,
                              bos_id=bos_id, eos_id=eos_id)
    outer_anchor = next((v.input for v in statics
                         if isinstance(v, StaticInput)), None)
    with bs.step():
        tok = bs.token()
        args = []
        for v in statics:
            if isinstance(v, StaticInput):
                args.append(bs.state(v.input))
            else:
                args.append(v)
        _GROUP_STACK.append((bs, outer_anchor))
        try:
            logits = step(tok, *args)
        finally:
            _GROUP_STACK.pop()
        bs.set_logits(logits)
    return bs()


# ---- projections / operators + mixed --------------------------------

class _Projection:
    """Lazy projection: applied when mixed_layer assembles its sum."""

    def __init__(self, fn, src):
        self.fn = fn
        self.src = src

    def apply(self, size):
        return self.fn(size)


def full_matrix_projection(input, size=0, param_attr=None, **kwargs):
    return _Projection(
        lambda sz: _L.fc(input, sz, bias_attr=False,
                         param_attr=param_attr,
                         num_flatten_dims=2 if len(input.shape or ())
                         >= 3 else 1), input)


def trans_full_matrix_projection(input, size=0, param_attr=None,
                                 **kwargs):
    """W^T projection (reference trans_full_matrix_projection — weight
    sharing with a forward projection via transpose)."""
    def fn(sz):
        from ..layer_helper import LayerHelper
        helper = LayerHelper("trans_fm_proj")
        w = helper.create_parameter(param_attr,
                                    shape=[sz, input.shape[-1]],
                                    dtype=input.dtype)
        wt = _L.trans(w)
        return _L.matmul(input, wt)
    return _Projection(fn, input)


def table_projection(input, size=0, param_attr=None, **kwargs):
    entry = _input_types().get(input.name)
    vocab = entry[0].dim if entry else None
    if getattr(input, "_v2_value", None) is not None:
        return _Projection(
            lambda sz: _sparse_float_rowsum(input, sz, param_attr),
            input)
    return _Projection(
        lambda sz: _L.embedding(input, size=[vocab, sz],
                                param_attr=param_attr), input)


def identity_projection(input, offset=None, size=None, **kwargs):
    def fn(sz):
        if offset is None:
            return input
        end = offset + (size or sz)
        return _L.slice(input, axes=[len(input.shape) - 1],
                        starts=[offset], ends=[end])
    return _Projection(fn, input)


def slice_projection(input, slices, **kwargs):
    def fn(sz):
        parts = [_L.slice(input, axes=[len(input.shape) - 1],
                          starts=[s], ends=[e]) for s, e in slices]
        return _L.concat(parts, axis=-1)
    return _Projection(fn, input)


def scaling_projection(input, param_attr=None, **kwargs):
    def fn(sz):
        from ..layer_helper import LayerHelper
        helper = LayerHelper("scaling_proj")
        w = helper.create_parameter(param_attr, shape=[1],
                                    dtype=input.dtype)
        return _L.elementwise_mul(input, w)
    return _Projection(fn, input)


def dotmul_projection(input, param_attr=None, **kwargs):
    def fn(sz):
        from ..layer_helper import LayerHelper
        helper = LayerHelper("dotmul_proj")
        w = helper.create_parameter(param_attr,
                                    shape=[input.shape[-1]],
                                    dtype=input.dtype)
        return _L.elementwise_mul(input, w)
    return _Projection(fn, input)


def dotmul_operator(a, b, scale=1.0, **kwargs):
    out = _L.elementwise_mul(a, b)
    return _Projection(
        lambda sz, o=out: _L.scale(o, scale=scale)
        if scale != 1.0 else o, a)


def context_projection(input, context_len, context_start=None,
                       **kwargs):
    """Parameter-free context window: concat of time-shifted copies
    (reference ContextProjection)."""
    start = context_start if context_start is not None else \
        -(context_len // 2)

    def fn(sz):
        t = input.shape[1]
        parts = []
        for off in range(start, start + context_len):
            if off == 0:
                parts.append(input)
                continue
            if off < 0:
                padded = _L.pad(input, paddings=[0, 0, -off, 0, 0, 0])
                parts.append(_L.slice(padded, axes=[1], starts=[0],
                                      ends=[t]))
            else:
                padded = _L.pad(input, paddings=[0, 0, 0, off, 0, 0])
                parts.append(_L.slice(padded, axes=[1], starts=[off],
                                      ends=[t + off]))
        return _L.concat(parts, axis=-1)
    return _Projection(fn, input)


def conv_projection(input, filter_size, num_filters, num_channels=None,
                    stride=1, padding=0, param_attr=None, **kwargs):
    return _Projection(
        lambda sz: _L.conv2d(input, num_filters=num_filters,
                             filter_size=filter_size, stride=stride,
                             padding=padding, param_attr=param_attr,
                             bias_attr=False), input)


def conv_operator(img, filter, filter_size, num_filters,
                  num_channels=None, stride=1, padding=0,
                  filter_size_y=None, stride_y=None, padding_y=None,
                  **kwargs):
    """conv_operator: data-dependent filter conv inside mixed — the
    filter is another LAYER's output (one filter bank per batch row),
    not a parameter (reference gserver/layers/ConvOperator.h:31,
    ConvOperator.cpp:59 — per-row conv loop; config api
    trainer_config_helpers conv_operator). The filter layer's width
    must be num_filters*num_channels*kh*kw; output is the flattened
    [B, num_filters*oh*ow] feature map, summable inside mixed()."""
    kh = filter_size_y if filter_size_y is not None else filter_size
    kw = filter_size
    sy = stride_y if stride_y is not None else stride
    py = padding_y if padding_y is not None else padding

    def fn(sz):
        x = img
        if len(x.shape) == 2:
            if num_channels is None:
                raise ValueError(
                    "conv_operator on a flat input needs num_channels")
            hw = x.shape[-1] // num_channels
            side = int(round(float(hw) ** 0.5))
            if side * side != hw:
                raise ValueError(
                    "conv_operator cannot infer a square image from "
                    "width %d / %d channels" % (x.shape[-1],
                                                num_channels))
            x = _L.reshape(x, [-1, num_channels, side, side])
        c = num_channels if num_channels is not None else x.shape[1]
        f = filter
        if len(f.shape) != 5:
            f = _L.reshape(f, [-1, num_filters, c, kh, kw])
        out = _L.batch_conv2d(x, f, stride=[sy, stride],
                              padding=[py, padding])
        return _L.reshape(out, [out.shape[0],
                                int(np.prod(out.shape[1:]))])
    return _Projection(fn, img)


def mixed(size, input=None, act=None, bias_attr=None, **kwargs):
    """mixed_layer: sum of projections/operators, then bias + act."""
    projs = input if isinstance(input, (list, tuple)) else [input]
    outs = [p.apply(size) if isinstance(p, _Projection) else p
            for p in projs]
    out = outs[0] if len(outs) == 1 else _L.sums(list(outs))
    if bias_attr is not False and bias_attr is not None:
        from ..layer_helper import LayerHelper
        helper = LayerHelper("mixed_bias")
        b = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                    shape=[size], dtype=out.dtype,
                                    is_bias=True)
        out = _L.elementwise_add(out, b)
    act_n = _act_name(act)
    out = getattr(_L, act_n)(out) if act_n else out
    return _tag(out, projs[0].src if isinstance(projs[0], _Projection)
                else projs[0])


# ---- detection -------------------------------------------------------

def priorbox(input, image, min_size, max_size=None, aspect_ratio=None,
             variance=None, **kwargs):
    return _L.prior_box(input, image, min_sizes=list(min_size),
                        max_sizes=list(max_size or []),
                        aspect_ratios=list(aspect_ratio or []),
                        variances=list(variance or
                                       [0.1, 0.1, 0.2, 0.2]), **kwargs)


def multibox_loss(input_loc, input_conf, priorbox, gt_box, gt_label,
                  gt_count, num_classes=None, overlap_threshold=0.5,
                  neg_pos_ratio=3.0, **kwargs):
    """SSD loss. ``priorbox`` is the (boxes, variances) pair returned
    by priorbox(); the reference's single LoD ``label`` input becomes
    the padded (gt_box [N,G,4], gt_label [N,G], gt_count [N]) triple
    (SURVEY §5.7 padded-batch convention). num_classes is implied by
    input_conf's last dim and accepted for signature parity."""
    boxes, variances = priorbox
    return _L.multibox_loss(input_loc, input_conf,
                            _flatten_priors(boxes),
                            _flatten_priors(variances),
                            gt_box, gt_label, gt_count,
                            overlap_threshold=overlap_threshold,
                            neg_pos_ratio=neg_pos_ratio, **kwargs)


def _flatten_priors(v):
    """[H, W, P, 4] prior grids -> [H*W*P, 4] (the fluid detection ops
    take flat prior lists)."""
    if len(v.shape or ()) > 2:
        return _L.reshape(v, [-1, 4])
    return v


def detection_output(input_loc, input_conf, priorbox, num_classes=None,
                     nms_threshold=0.45, keep_top_k=200, **kwargs):
    """SSD inference head. ``priorbox`` = (boxes, variances) from
    priorbox(); input_conf holds post-softmax scores."""
    boxes, variances = priorbox
    return _L.detection_output(input_loc, input_conf,
                               _flatten_priors(boxes),
                               _flatten_priors(variances),
                               nms_threshold=nms_threshold,
                               keep_top_k=keep_top_k, **kwargs)


def roi_pool(input, rois, pooled_width, pooled_height,
             spatial_scale=1.0, **kwargs):
    return _L.roi_pool(input, rois, pooled_height=pooled_height,
                       pooled_width=pooled_width,
                       spatial_scale=spatial_scale, **kwargs)


# ---- costs -----------------------------------------------------------

def classification_cost(input, label, **kwargs):
    """softmax_with_cross_entropy mean (v2 classification_cost: the
    input is pre-softmax unless already activated; reference applies
    softmax inside the cost when the layer's act is Softmax — here the
    convention is: pass logits OR softmax output, cross_entropy picks
    the right path by checking the producing layer)."""
    if getattr(input, "_v2_softmaxed", False):
        return _L.mean(_L.cross_entropy(input, label, **kwargs))
    return _L.mean(_L.softmax_with_cross_entropy(input, label, **kwargs))


def cross_entropy_cost(input, label, **kwargs):
    return _L.mean(_L.cross_entropy(input, label, **kwargs))


cross_entropy = cross_entropy_cost


def cross_entropy_with_selfnorm_cost(input, label,
                                     softmax_selfnorm_alpha=0.1,
                                     **kwargs):
    return _L.mean(_L.cross_entropy_with_selfnorm(
        input, label, softmax_selfnorm_alpha))


cross_entropy_with_selfnorm = cross_entropy_with_selfnorm_cost


def multi_binary_label_cross_entropy_cost(input, label, **kwargs):
    return _L.mean(_L.multi_binary_label_cross_entropy(input, label))


multi_binary_label_cross_entropy = multi_binary_label_cross_entropy_cost


def cross_entropy_over_beam(input, **kwargs):
    """input: list of (scores, ids, gold) triples (see
    layers/legacy.py cross_entropy_over_beam)."""
    return _L.mean(_L.cross_entropy_over_beam(input))


def regression_cost(input, label, **kwargs):
    return _L.mean(_L.square_error_cost(input, label, **kwargs))


mse_cost = regression_cost


def square_error_cost(input, label, **kwargs):
    return _L.square_error_cost(input, label, **kwargs)


def rank_cost(left, right, label, **kwargs):
    return _L.mean(_L.rank_loss(left, right, label, **kwargs))


def lambda_cost(input, score, NDCG_num=5, max_sort_size=-1, **kwargs):
    return _L.mean(_L.lambda_cost(input, score,
                                  length=_length_of(input),
                                  NDCG_num=NDCG_num,
                                  max_sort_size=max_sort_size))


def sum_cost(input, **kwargs):
    return _L.sum_cost(input)


def huber_regression_cost(input, label, delta=1.0, **kwargs):
    return _L.mean(_L.huber_loss(input, label, delta=delta, **kwargs))


def huber_classification_cost(input, label, **kwargs):
    from ..layer_helper import LayerHelper
    helper = LayerHelper("modified_huber", **kwargs)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="modified_huber_loss",
                     inputs={"X": [input.name], "Y": [label.name]},
                     outputs={"Out": [out.name]})
    return _L.mean(out)


def smooth_l1_cost(input, label, **kwargs):
    return _L.mean(_L.smooth_l1(input, label, **kwargs))


def hsigmoid(input, label, num_classes, param_attr=None,
             bias_attr=None, **kwargs):
    return _L.mean(_L.hsigmoid(_first(input), label, num_classes,
                               param_attr=param_attr,
                               bias_attr=bias_attr, **kwargs))


def nce(input, label, num_classes, num_neg_samples=10,
        param_attr=None, bias_attr=None, **kwargs):
    return _L.mean(_L.nce(_first(input), label, num_classes,
                          num_neg_samples=num_neg_samples,
                          param_attr=param_attr, bias_attr=bias_attr,
                          **kwargs))


def ctc(input, label, size=None, label_length=None, **kwargs):
    llen = _length_of(input)
    if llen is None:  # full-length logits (no padding)
        llen = _L.fill_constant_batch_size_like(
            input, [-1], "int64", input.shape[1])
    tlen = label_length if label_length is not None else \
        _length_of(label)
    if tlen is None:
        tlen = _L.fill_constant_batch_size_like(
            label, [-1], "int64", label.shape[1])
    return _L.mean(_L.warpctc(input, label, logits_length=llen,
                              label_length=tlen, **kwargs))


warp_ctc = ctc


def crf(input, label, size=None, param_attr=None, **kwargs):
    ll = _L.linear_chain_crf(input, label, length=_length_of(input),
                             param_attr=param_attr, **kwargs)
    return _L.mean(_L.scale(ll, scale=-1.0))


def crf_decoding(input, size=None, param_attr=None, **kwargs):
    return _L.crf_decoding(input, param_attr,
                           length=_length_of(input), **kwargs)


# ---- group shorthands (kept from the earlier surface) ---------------

def lstmemory_group(input, size, reverse=False, **kwargs):
    """v2 simple_lstm-style group over a sequence input."""
    out = _nets.simple_lstm(input, size, length=_length_of(input),
                            is_reverse=reverse, **kwargs)
    return _tag(out, input)


def gru_group(input, size, reverse=False, **kwargs):
    out = _nets.simple_gru(input, size, length=_length_of(input),
                           is_reverse=reverse, **kwargs)
    return _tag(out, input)


def parse_network(*outputs):
    """v2 topology hook — programs ARE the topology here."""
    return list(outputs)


# *_layer aliases (the trainer_config_helpers spellings)
_ALIASES = {}
for _name in list(globals()):
    _obj = globals()[_name]
    if callable(_obj) and not _name.startswith("_") and _name not in (
            "StaticInput", "ParamAttr", "memory", "update_memory",
            "parse_network", "np"):
        _ALIASES[_name + "_layer"] = _obj
globals().update(_ALIASES)
