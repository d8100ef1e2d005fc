"""AlexNet (reference ``paddle_tpu/models/alexnet.py``, after
``benchmark/paddle/image/alexnet.py``), built as a program."""

from .. import layers

__all__ = ["alexnet"]


def alexnet(img, label, class_dim=1000, is_test=False):
    """img: [N,3,224,224]."""
    conv1 = layers.conv2d(img, 96, 11, stride=4, padding=1, act="relu")
    cmr1 = layers.lrn(conv1, n=5, alpha=0.0001, beta=0.75)
    pool1 = layers.pool2d(cmr1, 3, "max", 2)

    conv2 = layers.conv2d(pool1, 256, 5, padding=2, groups=1, act="relu")
    cmr2 = layers.lrn(conv2, n=5, alpha=0.0001, beta=0.75)
    pool2 = layers.pool2d(cmr2, 3, "max", 2)

    conv3 = layers.conv2d(pool2, 384, 3, padding=1, act="relu")
    conv4 = layers.conv2d(conv3, 384, 3, padding=1, act="relu")
    conv5 = layers.conv2d(conv4, 256, 3, padding=1, act="relu")
    pool3 = layers.pool2d(conv5, 3, "max", 2)

    flat = layers.reshape(pool3, [-1, pool3.shape[1] * pool3.shape[2] *
                                  pool3.shape[3]])
    fc1 = layers.fc(flat, 4096, act="relu")
    d1 = layers.dropout(fc1, 0.5, is_test=is_test)
    fc2 = layers.fc(d1, 4096, act="relu")
    d2 = layers.dropout(fc2, 0.5, is_test=is_test)
    logits = layers.fc(d2, class_dim)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return loss, acc, logits
