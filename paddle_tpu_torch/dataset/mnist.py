"""MNIST (reference ``dataset/mnist.py``): samples are
(image[784] float32 in [-1,1], label int). Real idx-format files used when
present; synthetic digit blobs otherwise (see common.py policy).

The port's copy of ``paddle_tpu/dataset/mnist.py``: it imports nothing
of that package, and gives the same results.
"""

import gzip
import os
import struct

import numpy as np

from . import common

__all__ = ["train", "test"]


def _real_reader(images_name, labels_name):
    home = common.data_home("mnist")

    def reader():
        with gzip.open(os.path.join(home, labels_name), "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), dtype=np.uint8)
        with gzip.open(os.path.join(home, images_name), "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), dtype=np.uint8)
            images = images.reshape(n, rows * cols)
        images = images.astype("float32") / 127.5 - 1.0
        for img, lab in zip(images, labels):
            yield img, int(lab)
    return reader


def _synth_reader(split, n):
    def reader():
        s = common.Synthesizer("mnist", split, n)
        for _ in range(n):
            lab = int(s.rs.randint(0, 10))
            img = s.rs.randn(28, 28).astype("float32") * 0.3 - 0.5
            r0, c0 = 2 + (lab // 5) * 12, 2 + (lab % 5) * 5
            img[r0:r0 + 6, c0:c0 + 4] += 1.5
            yield np.clip(img, -1, 1).reshape(784), lab
    return reader


def train():
    if common.has_real("mnist", "train-images-idx3-ubyte.gz"):
        return _real_reader("train-images-idx3-ubyte.gz",
                            "train-labels-idx1-ubyte.gz")
    return _synth_reader("train", 8192)


def test():
    if common.has_real("mnist", "t10k-images-idx3-ubyte.gz"):
        return _real_reader("t10k-images-idx3-ubyte.gz",
                            "t10k-labels-idx1-ubyte.gz")
    return _synth_reader("test", 1024)
