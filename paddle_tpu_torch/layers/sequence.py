"""Sequence layers of the program front end (reference
``paddle_tpu/layers/sequence.py``), with the reference's signatures,
defaults and ``LayerHelper`` naming, so a program serializes as the
reference's does. A sequence batch is (data[batch, time, ...],
length[batch]); a nested one (data[B, S, T, ...], seq_len[B],
sub_len[B, S]). The ops are ``ops/sequence_ops.py`` and
``ops/nested_ops.py``; the recurrent ones loop over time on the
tensors' device."""

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["sequence_mask", "sequence_pool", "sequence_first_step",
           "sequence_last_step", "sequence_softmax", "sequence_expand",
           "sequence_conv", "dynamic_lstm", "dynamic_gru", "gru_unit",
           "lstm_unit", "sequence_reverse", "sequence_erase_pad",
           "sequence_slice", "sequence_concat", "nested_sequence_mask",
           "nested_sequence_pool", "sub_seq", "sub_nested_seq",
           "nested_flatten", "nested_unflatten", "sequence_reshape",
           "lod_reset", "max_sequence_len", "sequence_concat_packed"]


def sequence_mask(length, maxlen, dtype="float32", **kwargs):
    helper = LayerHelper("sequence_mask", **kwargs)
    out = helper.create_tmp_variable(dtype, stop_gradient=True)
    helper.append_op(type="sequence_mask",
                     inputs={"Length": [length.name]},
                     outputs={"Out": [out.name]},
                     attrs={"maxlen": maxlen, "dtype": dtype})
    return out


def sequence_pool(input, pool_type, length=None, **kwargs):
    """Pool over time with padding masked (reference sequence_pool_op:
    average/sum/sqrt/max/last/first)."""
    helper = LayerHelper("sequence_pool", **kwargs)
    inputs = {"X": [input.name]}
    if length is not None:
        inputs["Length"] = [length.name]
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="sequence_pool", inputs=inputs,
                     outputs={"Out": [out.name]},
                     attrs={"pool_type": pool_type})
    return out


def sequence_first_step(input, length=None, **kwargs):
    return sequence_pool(input, "first", length, **kwargs)


def sequence_last_step(input, length=None, **kwargs):
    return sequence_pool(input, "last", length, **kwargs)


def sequence_softmax(input, length=None, **kwargs):
    helper = LayerHelper("sequence_softmax", **kwargs)
    inputs = {"X": [input.name]}
    if length is not None:
        inputs["Length"] = [length.name]
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="sequence_softmax", inputs=inputs,
                     outputs={"Out": [out.name]})
    return out


def sequence_expand(x, y, y_length=None, **kwargs):
    """Expand per-sequence rows of ``x`` [b, d] across ``y``'s time axis
    (padded analog of sequence_expand_op). With ``y_length`` the repeat
    count varies per row (reference per-sequence lod(y) repeats): rows
    past a row's length are zeroed."""
    helper = LayerHelper("sequence_expand", **kwargs)
    inputs = {"X": [x.name], "Y": [y.name]}
    if y_length is not None:
        inputs["Length"] = [y_length.name]
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="sequence_expand", inputs=inputs,
                     outputs={"Out": [out.name]})
    return out


def sequence_reverse(x, length=None, **kwargs):
    helper = LayerHelper("sequence_reverse", **kwargs)
    inputs = {"X": [x.name]}
    if length is not None:
        inputs["Length"] = [length.name]
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="sequence_reverse", inputs=inputs,
                     outputs={"Out": [out.name]})
    return out


def sequence_erase_pad(x, length, tokens, **kwargs):
    """Remove tokens from padded int sequences, repacking left
    (reference sequence_erase_op)."""
    helper = LayerHelper("sequence_erase", **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    new_len = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op(type="sequence_erase",
                     inputs={"X": [x.name], "Length": [length.name]},
                     outputs={"Out": [out.name], "OutLength": [new_len.name]},
                     attrs={"tokens": list(tokens)})
    return out, new_len


def sequence_slice(input, offset, length_attr, **kwargs):
    """Slice [offset, offset+length) along time (sequence_slice_op)."""
    helper = LayerHelper("sequence_slice", **kwargs)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="slice", inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"axes": [1], "starts": [offset],
                            "ends": [offset + length_attr]})
    return out


def sequence_concat(inputs, **kwargs):
    """Concatenate along time (sequence_concat_op on padded batches)."""
    helper = LayerHelper("sequence_concat", **kwargs)
    out = helper.create_tmp_variable(inputs[0].dtype)
    helper.append_op(type="concat",
                     inputs={"X": [v.name for v in inputs]},
                     outputs={"Out": [out.name]}, attrs={"axis": 1})
    return out


def sequence_conv(input, num_filters, filter_size=3, param_attr=None,
                  bias_attr=None, act=None, **kwargs):
    """Context-window projection over time (reference sequence_conv_op /
    ContextProjection): same-padding 1-D conv over [batch, time, dim]."""
    helper = LayerHelper("sequence_conv", act=act, **kwargs)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr,
                                shape=[filter_size * dim, num_filters],
                                dtype=input.dtype)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="sequence_conv",
                     inputs={"X": [input.name], "Filter": [w.name]},
                     outputs={"Out": [out.name]},
                     attrs={"contextLength": filter_size,
                            "contextStart": -(filter_size // 2)})
    if bias_attr is not False:
        out = helper.append_bias_op(out, ParamAttr.to_attr(bias_attr),
                                    dim_start=2)
    return helper.append_activation(out)


def dynamic_lstm(input, size, length=None, param_attr=None, bias_attr=None,
                 use_peepholes=False, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", h0=None, c0=None, **kwargs):
    """LSTM over padded [batch, time, 4*hidden] projected input (reference
    dynamic_lstm / LstmLayer). The time loop runs on the tensors' device
    (``ops/sequence_ops.py``); padded steps carry the state through
    unchanged (the analog of the shrinking-batch scheduling in
    sequence2batch).

    ``input`` must already be the gate projection x·W (4*size wide), as in
    the reference where dynamic_lstm consumes a fc output.
    """
    helper = LayerHelper("dynamic_lstm", **kwargs)
    w = helper.create_parameter(param_attr, shape=[size, 4 * size],
                                dtype=input.dtype)
    inputs = {"Input": [input.name], "Weight": [w.name]}
    if bias_attr is not False:
        nbias = 7 * size if use_peepholes else 4 * size
        bias = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                       shape=[1, nbias],
                                       dtype=input.dtype, is_bias=True)
        inputs["Bias"] = [bias.name]
    if length is not None:
        inputs["Length"] = [length.name]
    if h0 is not None:
        inputs["H0"] = [h0.name]
    if c0 is not None:
        inputs["C0"] = [c0.name]
    hidden = helper.create_tmp_variable(input.dtype)
    cell = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="dynamic_lstm", inputs=inputs,
                     outputs={"Hidden": [hidden.name], "Cell": [cell.name]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_gru(input, size, length=None, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h0=None, **kwargs):
    """GRU over padded [batch, time, 3*hidden] projected input (reference
    dynamic_gru / GatedRecurrentLayer / hl_gpu_gru)."""
    helper = LayerHelper("dynamic_gru", **kwargs)
    w = helper.create_parameter(param_attr, shape=[size, 3 * size],
                                dtype=input.dtype)
    inputs = {"Input": [input.name], "Weight": [w.name]}
    if bias_attr is not False:
        bias = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                       shape=[1, 3 * size],
                                       dtype=input.dtype, is_bias=True)
        inputs["Bias"] = [bias.name]
    if length is not None:
        inputs["Length"] = [length.name]
    if h0 is not None:
        inputs["H0"] = [h0.name]
    hidden = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="dynamic_gru", inputs=inputs,
                     outputs={"Hidden": [hidden.name]},
                     attrs={"is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "candidate_activation": candidate_activation})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid", **kwargs):
    """Single GRU step (reference gru_unit_op) for explicit RNN loops."""
    helper = LayerHelper("gru_unit", **kwargs)
    w = helper.create_parameter(param_attr, shape=[size, 3 * size],
                                dtype=input.dtype)
    bias = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                   shape=[1, 3 * size], dtype=input.dtype,
                                   is_bias=True)
    new_hidden = helper.create_tmp_variable(input.dtype)
    gate = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    reset_h = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    helper.append_op(type="gru_unit",
                     inputs={"Input": [input.name],
                             "HiddenPrev": [hidden.name],
                             "Weight": [w.name], "Bias": [bias.name]},
                     outputs={"Hidden": [new_hidden.name],
                              "Gate": [gate.name],
                              "ResetHiddenPrev": [reset_h.name]},
                     attrs={"activation": activation,
                            "gate_activation": gate_activation})
    return new_hidden, gate, reset_h


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, **kwargs):
    """Single LSTM step (reference lstm_unit_op): fc([x, h]) -> gates."""
    from . import nn as _nn
    from . import tensor as _tensor
    size = cell_t_prev.shape[-1]
    concat_in = _tensor.concat([x_t, hidden_t_prev], axis=1, **kwargs)
    fc_out = _nn.fc(concat_in, 4 * size, param_attr=param_attr,
                    bias_attr=bias_attr, **kwargs)
    helper = LayerHelper("lstm_unit", **kwargs)
    h = helper.create_tmp_variable(x_t.dtype)
    c = helper.create_tmp_variable(x_t.dtype)
    helper.append_op(type="lstm_unit",
                     inputs={"X": [fc_out.name], "C_prev": [cell_t_prev.name]},
                     outputs={"H": [h.name], "C": [c.name]},
                     attrs={"forget_bias": forget_bias})
    return h, c


# -- nested (2-level) sequences ---------------------------------------------
# Convention (ops/nested_ops.py; reference Argument.h:84-90
# subSequenceStartPositions, RecurrentGradientMachine.cpp:380-383):
# (data[B, S, T, ...], seq_len[B], sub_len[B, S]).

def nested_sequence_mask(seq_len, sub_len, max_sub, maxlen, **kwargs):
    """Returns (outer[B,S], inner[B,S,T]) float masks."""
    helper = LayerHelper("nested_sequence_mask", **kwargs)
    outer = helper.create_tmp_variable("float32", stop_gradient=True)
    inner = helper.create_tmp_variable("float32", stop_gradient=True)
    helper.append_op(type="nested_sequence_mask",
                     inputs={"SeqLen": [seq_len.name],
                             "SubLen": [sub_len.name]},
                     outputs={"Outer": [outer.name],
                              "Inner": [inner.name]},
                     attrs={"max_sub": max_sub, "maxlen": maxlen})
    return outer, inner


def nested_sequence_pool(input, sub_len, pool_type="average", **kwargs):
    """Pool the innermost level: [B,S,T,...] -> [B,S,...] (reference
    sequence_pool over a 2-level LoD). Chain with sequence_pool(.,
    length=seq_len) for the outer level."""
    helper = LayerHelper("nested_sequence_pool", **kwargs)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="nested_sequence_pool",
                     inputs={"X": [input.name], "SubLen": [sub_len.name]},
                     outputs={"Out": [out.name]},
                     attrs={"pool_type": pool_type})
    return out


def sub_seq(input, offset, size, max_size, **kwargs):
    """Per-sequence window slice (reference SubSequenceLayer): returns
    ([B, max_size, ...] left-packed, new_length[B])."""
    helper = LayerHelper("sub_seq", **kwargs)
    out = helper.create_tmp_variable(input.dtype)
    out_len = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op(type="sub_seq",
                     inputs={"X": [input.name], "Offset": [offset.name],
                             "Size": [size.name]},
                     outputs={"Out": [out.name], "OutLen": [out_len.name]},
                     attrs={"max_size": max_size})
    return out, out_len


def sub_nested_seq(input, sub_len, selected, **kwargs):
    """Select sub-sequences by per-sequence indices (reference
    SubNestedSequenceLayer): ([B,S,T,...], [B,S], [B,K]) ->
    ([B,K,T,...], [B,K]); negative index -> empty sub-sequence."""
    helper = LayerHelper("sub_nested_seq", **kwargs)
    out = helper.create_tmp_variable(input.dtype)
    out_sub = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op(type="sub_nested_seq",
                     inputs={"X": [input.name], "SubLen": [sub_len.name],
                             "Selected": [selected.name]},
                     outputs={"Out": [out.name],
                              "OutSubLen": [out_sub.name]})
    return out, out_sub


def nested_flatten(input, sub_len, **kwargs):
    """[B,S,T,...] -> ([B*S,T,...], [B*S]) — run any level-1 sequence op
    (dynamic_lstm/gru, sequence_pool...) over the sub-sequences, then
    nested_unflatten back: the nested recurrent group, whose inner level
    is a bigger batch (where the legacy engine cloned per-frame
    sub-networks with scatter/gather agents)."""
    from . import tensor as _tensor
    shape = list(input.shape)
    flat = _tensor.reshape(input, [-1] + shape[2:], **kwargs)
    flat_len = _tensor.reshape(sub_len, [-1], **kwargs)
    return flat, flat_len


def nested_unflatten(input, batch, max_sub, **kwargs):
    """[B*S, ...] -> [B, S, ...] (inverse of nested_flatten's batch
    collapse, after the inner-level op)."""
    from . import tensor as _tensor
    shape = list(input.shape)
    return _tensor.reshape(input, [batch, max_sub] + shape[1:], **kwargs)


def sequence_reshape(input, new_dim, length=None, **kwargs):
    """Change per-timestep width, scaling lengths (reference
    sequence_reshape_op). Returns (out, new_length|None).
    Caller contract (as in the reference's per-sequence enforce):
    every valid length must satisfy (length * D) % new_dim == 0."""
    helper = LayerHelper("sequence_reshape", **kwargs)
    inputs = {"X": [input.name]}
    out = helper.create_tmp_variable(input.dtype)
    outputs = {"Out": [out.name]}
    new_len = None
    if length is not None:
        inputs["Length"] = [length.name]
        new_len = helper.create_tmp_variable(length.dtype,
                                             stop_gradient=True)
        outputs["OutLength"] = [new_len.name]
    # infer_shape off: with a dynamic time axis the T*D divisibility
    # check is only meaningful at trace time against the concrete feed
    helper.append_op(type="sequence_reshape", inputs=inputs,
                     outputs=outputs, attrs={"new_dim": new_dim},
                     infer_shape=False)
    return out, new_len


def lod_reset(x, new_length, original_length=None, **kwargs):
    """Re-declare a batch's sequence lengths (reference lod_reset_op).
    Returns (x_passthrough, clipped_length). Pass ``original_length``
    to also clip against the CURRENT valid lengths — without it, a
    grown length exposes padding rows as data (the padded-batch hazard
    the dense-rows reference does not have)."""
    helper = LayerHelper("lod_reset", **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    out_len = helper.create_tmp_variable(new_length.dtype,
                                         stop_gradient=True)
    inputs = {"X": [x.name], "Length": [new_length.name]}
    if original_length is not None:
        inputs["OrigLength"] = [original_length.name]
    helper.append_op(type="lod_reset", inputs=inputs,
                     outputs={"Out": [out.name],
                              "OutLength": [out_len.name]})
    return out, out_len


def max_sequence_len(length, **kwargs):
    """Max sequence length in the batch (max_sequence_len_op)."""
    helper = LayerHelper("max_sequence_len", **kwargs)
    out = helper.create_tmp_variable(length.dtype, stop_gradient=True)
    helper.append_op(type="max_sequence_len",
                     inputs={"Length": [length.name]},
                     outputs={"Out": [out.name]})
    return out


def sequence_concat_packed(a, b, len_a, len_b, **kwargs):
    """Per-sample packed time concat: (out [B, Ta+Tb, ...], len [B])."""
    helper = LayerHelper("sequence_concat_packed", **kwargs)
    out = helper.create_tmp_variable(a.dtype)
    out_len = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op(type="sequence_concat_packed",
                     inputs={"A": [a.name], "B": [b.name],
                             "LenA": [len_a.name], "LenB": [len_b.name]},
                     outputs={"Out": [out.name], "OutLen": [out_len.name]})
    return out, out_len
