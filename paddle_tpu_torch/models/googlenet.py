"""GoogLeNet / Inception-v1 (reference ``paddle_tpu/models/googlenet.py``,
after ``benchmark/paddle/image/googlenet.py``), built as a program."""

from .. import layers

__all__ = ["googlenet"]


def inception(input, c1, c3r, c3, c5r, c5, proj):
    b1 = layers.conv2d(input, c1, 1, act="relu")
    b3 = layers.conv2d(layers.conv2d(input, c3r, 1, act="relu"),
                       c3, 3, padding=1, act="relu")
    b5 = layers.conv2d(layers.conv2d(input, c5r, 1, act="relu"),
                       c5, 5, padding=2, act="relu")
    bp = layers.conv2d(layers.pool2d(input, 3, "max", 1, 1), proj, 1,
                       act="relu")
    return layers.concat([b1, b3, b5, bp], axis=1)


def googlenet(img, label, class_dim=1000, is_test=False):
    conv1 = layers.conv2d(img, 64, 7, stride=2, padding=3, act="relu")
    pool1 = layers.pool2d(conv1, 3, "max", 2, 1)
    conv2 = layers.conv2d(pool1, 64, 1, act="relu")
    conv3 = layers.conv2d(conv2, 192, 3, padding=1, act="relu")
    pool3 = layers.pool2d(conv3, 3, "max", 2, 1)

    i3a = inception(pool3, 64, 96, 128, 16, 32, 32)
    i3b = inception(i3a, 128, 128, 192, 32, 96, 64)
    pool4 = layers.pool2d(i3b, 3, "max", 2, 1)

    i4a = inception(pool4, 192, 96, 208, 16, 48, 64)
    i4b = inception(i4a, 160, 112, 224, 24, 64, 64)
    i4c = inception(i4b, 128, 128, 256, 24, 64, 64)
    i4d = inception(i4c, 112, 144, 288, 32, 64, 64)
    i4e = inception(i4d, 256, 160, 320, 32, 128, 128)
    pool5 = layers.pool2d(i4e, 3, "max", 2, 1)

    i5a = inception(pool5, 256, 160, 320, 32, 128, 128)
    i5b = inception(i5a, 384, 192, 384, 48, 128, 128)
    pool6 = layers.pool2d(i5b, 7, "avg", 1, global_pooling=True)
    drop = layers.dropout(pool6, 0.4, is_test=is_test)
    flat = layers.reshape(drop, [-1, drop.shape[1]])
    logits = layers.fc(flat, class_dim)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return loss, acc, logits
