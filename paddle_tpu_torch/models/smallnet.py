"""SmallNet for MNIST/CIFAR (reference ``paddle_tpu/models/smallnet.py``,
after ``benchmark/paddle/image/smallnet_mnist_cifar.py``), built as a
program."""

from .. import layers, nets

__all__ = ["smallnet"]


def smallnet(img, label, class_dim=10):
    conv1 = nets.simple_img_conv_pool(img, num_filters=32, filter_size=5,
                                      pool_size=3, pool_stride=2,
                                      act="relu")
    conv2 = nets.simple_img_conv_pool(conv1, num_filters=64, filter_size=5,
                                      pool_size=3, pool_stride=2,
                                      act="relu")
    flat = layers.reshape(conv2, [-1, conv2.shape[1] * conv2.shape[2] *
                                  conv2.shape[3]])
    logits = layers.fc(flat, class_dim)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return loss, acc, logits
