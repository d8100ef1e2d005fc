"""LeNet-5 for MNIST (reference ``paddle_tpu/models/lenet.py``; BASELINE
config 1, the book test ``test_recognize_digits_conv.py``): two 5x5
convolutions of 20 and 50 filters, each with ReLU and a 2x2 max pool,
and a 10-way fc, built as a program."""

from .. import layers, nets

__all__ = ["lenet5"]


def lenet5(img, label):
    """img: [N, 1, 28, 28]; label: [N, 1] int. Returns (loss, acc,
    logits)."""
    conv1 = nets.simple_img_conv_pool(img, num_filters=20, filter_size=5,
                                      pool_size=2, pool_stride=2,
                                      act="relu")
    conv2 = nets.simple_img_conv_pool(conv1, num_filters=50, filter_size=5,
                                      pool_size=2, pool_stride=2,
                                      act="relu")
    flat = layers.reshape(conv2, [-1, 50 * 4 * 4])
    logits = layers.fc(flat, 10)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return loss, acc, logits
