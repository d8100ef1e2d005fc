"""VGG-16/19 (reference ``paddle_tpu/models/vgg.py``, after
``benchmark/paddle/image/vgg.py``), built as a program."""

from .. import layers, nets

__all__ = ["vgg"]


def vgg(img, label, depth=19, class_dim=1000, is_test=False):
    cfg = {16: [2, 2, 3, 3, 3], 19: [2, 2, 4, 4, 4]}[depth]

    def conv_block(input, num_filter, groups):
        return nets.img_conv_group(
            input, conv_num_filter=[num_filter] * groups,
            pool_size=2, pool_stride=2, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=False)

    tmp = img
    for filters, groups in zip([64, 128, 256, 512, 512], cfg):
        tmp = conv_block(tmp, filters, groups)

    flat = layers.reshape(tmp, [-1, tmp.shape[1] * tmp.shape[2] *
                                tmp.shape[3]])
    fc1 = layers.fc(flat, 4096, act="relu")
    d1 = layers.dropout(fc1, 0.5, is_test=is_test)
    fc2 = layers.fc(d1, 4096, act="relu")
    d2 = layers.dropout(fc2, 0.5, is_test=is_test)
    logits = layers.fc(d2, class_dim)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return loss, acc, logits
