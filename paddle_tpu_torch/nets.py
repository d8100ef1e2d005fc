"""Composite networks of the program front end (reference
``paddle_tpu/nets.py``): ``simple_img_conv_pool``, ``img_conv_group``,
``glu`` and ``scaled_dot_product_attention``. The recurrent and sequence
composites (``sequence_conv_pool``, ``simple_lstm``, ``simple_gru``,
``bidirectional_lstm``, ``bidirectional_gru``, ``simple_attention``)
come with the sequence ops and raise until then."""

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention", "simple_lstm",
           "simple_gru", "bidirectional_lstm", "bidirectional_gru",
           "simple_attention"]

_LOOPS = 'ROADMAP Queue A, "RNN and seq2seq configs"'


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


def glu(input, dim=-1, **kwargs):
    a, b = layers.split(input, num_or_sections=2, dim=dim, **kwargs)
    gate = layers.sigmoid(b, **kwargs)
    return layers.elementwise_mul(a, gate, **kwargs)


def scaled_dot_product_attention(queries, keys, values, **kwargs):
    ctx, attn = layers.dot_product_attention(queries, keys, values,
                                             **kwargs)
    return ctx


def _loops(name):
    def composite(*args, **kwargs):
        raise NotImplementedError("%s is not ported yet: %s"
                                  % (name, _LOOPS))
    composite.__name__ = name
    return composite


sequence_conv_pool = _loops("sequence_conv_pool")
simple_lstm = _loops("simple_lstm")
simple_gru = _loops("simple_gru")
bidirectional_lstm = _loops("bidirectional_lstm")
bidirectional_gru = _loops("bidirectional_gru")
simple_attention = _loops("simple_attention")
