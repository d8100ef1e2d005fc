"""Composite networks of the program front end (reference
``paddle_tpu/nets.py``): ``simple_img_conv_pool``, ``img_conv_group``,
``sequence_conv_pool``, ``glu``, ``scaled_dot_product_attention``, and
the recurrent composites ``simple_lstm``, ``simple_gru``,
``bidirectional_lstm``, ``bidirectional_gru`` and ``simple_attention``
(the reference's v2 ``networks.py``)."""

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention", "simple_lstm",
           "simple_gru", "bidirectional_lstm", "bidirectional_gru",
           "simple_attention"]

def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, pool_type="max",
                         param_attr=None, **kwargs):
    conv_out = layers.conv2d(input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             act=act, **kwargs)
    return layers.pool2d(conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         **kwargs)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", **kwargs):
    tmp = input
    if isinstance(conv_with_batchnorm, bool):
        conv_with_batchnorm = [conv_with_batchnorm] * len(conv_num_filter)
    if isinstance(conv_batchnorm_drop_rate, (int, float)):
        conv_batchnorm_drop_rate = [conv_batchnorm_drop_rate] * \
            len(conv_num_filter)
    for i, nf in enumerate(conv_num_filter):
        local_act = conv_act if not conv_with_batchnorm[i] else None
        tmp = layers.conv2d(tmp, num_filters=nf,
                            filter_size=conv_filter_size,
                            padding=conv_padding, act=local_act, **kwargs)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(tmp, act=conv_act, **kwargs)
            if conv_batchnorm_drop_rate[i] > 0:
                tmp = layers.dropout(tmp,
                                     dropout_prob=conv_batchnorm_drop_rate[i],
                                     **kwargs)
    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride, **kwargs)


def sequence_conv_pool(input, num_filters, filter_size, length=None,
                       act="sigmoid", pool_type="max", **kwargs):
    conv_out = layers.sequence_conv(input, num_filters=num_filters,
                                    filter_size=filter_size, act=act,
                                    **kwargs)
    return layers.sequence_pool(conv_out, pool_type=pool_type,
                                length=length, **kwargs)


def glu(input, dim=-1, **kwargs):
    a, b = layers.split(input, num_or_sections=2, dim=dim, **kwargs)
    gate = layers.sigmoid(b, **kwargs)
    return layers.elementwise_mul(a, gate, **kwargs)


def scaled_dot_product_attention(queries, keys, values, **kwargs):
    ctx, attn = layers.dot_product_attention(queries, keys, values,
                                             **kwargs)
    return ctx


# -- v2 networks.py composites ----------------------------------------------
# (reference python/paddle/trainer_config_helpers/networks.py:1-1813:
# simple_lstm, simple_gru, bidirectional_lstm/gru, simple_attention)

def simple_lstm(input, size, length=None, is_reverse=False,
                mixed_param_attr=None, lstm_param_attr=None,
                lstm_bias_attr=None, **kwargs):
    """fc gate projection + LSTM over time (reference networks.py
    simple_lstm: mixed full-matrix projection into lstmemory)."""
    proj = layers.fc(input, 4 * size, num_flatten_dims=2,
                     param_attr=mixed_param_attr, bias_attr=False,
                     **kwargs)
    hidden, cell = layers.dynamic_lstm(
        proj, size, length=length, is_reverse=is_reverse,
        param_attr=lstm_param_attr, bias_attr=lstm_bias_attr, **kwargs)
    return hidden


def simple_gru(input, size, length=None, is_reverse=False,
               mixed_param_attr=None, gru_param_attr=None,
               gru_bias_attr=None, **kwargs):
    """fc gate projection + GRU over time (reference networks.py
    simple_gru)."""
    proj = layers.fc(input, 3 * size, num_flatten_dims=2,
                     param_attr=mixed_param_attr, bias_attr=False,
                     **kwargs)
    return layers.dynamic_gru(proj, size, length=length,
                              is_reverse=is_reverse,
                              param_attr=gru_param_attr,
                              bias_attr=gru_bias_attr, **kwargs)


def bidirectional_lstm(input, size, length=None, return_concat=True,
                       **kwargs):
    """Forward + backward LSTM over the same input; concat (or pair) of
    per-step hiddens (reference networks.py bidirectional_lstm:1005)."""
    fwd = simple_lstm(input, size, length=length, is_reverse=False,
                      **kwargs)
    bwd = simple_lstm(input, size, length=length, is_reverse=True,
                      **kwargs)
    if return_concat:
        return layers.concat([fwd, bwd], axis=2)
    return fwd, bwd


def bidirectional_gru(input, size, length=None, return_concat=True,
                      **kwargs):
    """Forward + backward GRU (reference networks.py
    bidirectional_gru)."""
    fwd = simple_gru(input, size, length=length, is_reverse=False,
                     **kwargs)
    bwd = simple_gru(input, size, length=length, is_reverse=True,
                     **kwargs)
    if return_concat:
        return layers.concat([fwd, bwd], axis=2)
    return fwd, bwd


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     length=None, **kwargs):
    """Bahdanau-style additive attention (reference networks.py
    simple_attention:1375): score_t = v . tanh(enc_proj_t + W s);
    softmax over valid steps; context = sum_t a_t * enc_t."""
    h = encoded_proj.shape[-1]
    dec_proj = layers.fc(decoder_state, h, bias_attr=False, **kwargs)
    dec_expand = layers.sequence_expand(dec_proj, encoded_proj, **kwargs)
    mix = layers.tanh(layers.elementwise_add(encoded_proj, dec_expand,
                                             **kwargs), **kwargs)
    scores = layers.fc(mix, 1, num_flatten_dims=2, bias_attr=False,
                       **kwargs)
    t = encoded_sequence.shape[1]
    scores = layers.reshape(scores, [-1, t], **kwargs)
    weights = layers.sequence_softmax(scores, length=length, **kwargs)
    weights3 = layers.reshape(weights, [-1, t, 1], **kwargs)
    weighted = layers.elementwise_mul(encoded_sequence, weights3,
                                      **kwargs)
    context = layers.reduce_sum(weighted, dim=1, **kwargs)
    return context, weights
