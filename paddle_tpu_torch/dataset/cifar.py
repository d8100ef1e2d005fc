"""CIFAR-10/100 (reference ``dataset/cifar.py``): samples are
(image[3072] float32 in [0,1], label int).

The port's copy of ``paddle_tpu/dataset/cifar.py``: it imports nothing
of that package, and gives the same results.
"""

import os
import pickle
import tarfile

import numpy as np

from . import common

__all__ = ["train10", "test10", "train100", "test100"]


def _real_reader(tarname, keys, label_key):
    home = common.data_home("cifar")

    def reader():
        with tarfile.open(os.path.join(home, tarname)) as tf:
            for member in tf.getmembers():
                if not any(k in member.name for k in keys):
                    continue
                batch = pickle.load(tf.extractfile(member),
                                    encoding="latin1")
                for img, lab in zip(batch["data"], batch[label_key]):
                    yield img.astype("float32") / 255.0, int(lab)
    return reader


def _synth_reader(split, n, classes):
    def reader():
        s = common.Synthesizer("cifar%d" % classes, split, n)
        for _ in range(n):
            lab = int(s.rs.randint(0, classes))
            img = s.rs.rand(3, 32, 32).astype("float32") * 0.4
            ch = lab % 3
            img[ch, (lab * 3) % 28:(lab * 3) % 28 + 4] += 0.5
            yield np.clip(img, 0, 1).reshape(3072), lab
    return reader


def train10():
    if common.has_real("cifar", "cifar-10-python.tar.gz"):
        return _real_reader("cifar-10-python.tar.gz",
                            ["data_batch"], "labels")
    return _synth_reader("train", 8192, 10)


def test10():
    if common.has_real("cifar", "cifar-10-python.tar.gz"):
        return _real_reader("cifar-10-python.tar.gz",
                            ["test_batch"], "labels")
    return _synth_reader("test", 1024, 10)


def train100():
    if common.has_real("cifar", "cifar-100-python.tar.gz"):
        return _real_reader("cifar-100-python.tar.gz", ["train"],
                            "fine_labels")
    return _synth_reader("train", 8192, 100)


def test100():
    if common.has_real("cifar", "cifar-100-python.tar.gz"):
        return _real_reader("cifar-100-python.tar.gz", ["test"],
                            "fine_labels")
    return _synth_reader("test", 1024, 100)
