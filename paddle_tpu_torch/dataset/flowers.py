"""Oxford 102 Flowers (reference ``python/paddle/v2/dataset/flowers.py``):
train/valid/test readers of (image CHW float32, label 0..101).

The port's copy of ``paddle_tpu/dataset/flowers.py``: it imports nothing
of that package, and gives the same results.
"""

import io
import os
import tarfile

import numpy as np

from . import common

__all__ = ["train", "test", "valid"]

CLASSES = 102
_SHAPE = (3, 224, 224)
_DATA = "102flowers.tgz"
_LABELS = "imagelabels.mat"
_SETID = "setid.mat"
DATA_URL = ("http://www.robots.ox.ac.uk/~vgg/data/flowers/102/"
            "102flowers.tgz")
DATA_MD5 = "33bfc11892f1e405ca193ae9a9f2a118"
_SPLIT_KEY = {"train": "trnid", "test": "tstid", "valid": "valid"}


def _real_reader(split, mapper=None):
    """102flowers.tgz jpgs + imagelabels.mat/setid.mat (reference
    flowers.py reader_creator): yields (CHW float32 in [0,1] resized
    224x224, label 0..101)."""
    home = common.data_home("flowers")

    def reader():
        from PIL import Image
        from scipy.io import loadmat
        labels = loadmat(os.path.join(home, _LABELS))["labels"][0]
        ids = loadmat(os.path.join(home, _SETID))[
            _SPLIT_KEY[split]][0]
        wanted = {"jpg/image_%05d.jpg" % i: int(i) for i in ids}
        with tarfile.open(os.path.join(home, _DATA)) as tf:
            m = tf.next()
            while m is not None:
                idx = wanted.get(m.name)
                if idx is not None:
                    img = Image.open(io.BytesIO(
                        tf.extractfile(m).read())).convert("RGB")
                    img = img.resize((_SHAPE[2], _SHAPE[1]))
                    arr = np.asarray(img, dtype="float32") / 255.0
                    arr = arr.transpose(2, 0, 1)
                    lab = int(labels[idx - 1]) - 1
                    if mapper is not None:
                        arr, lab = mapper((arr, lab))
                    yield arr, lab
                m = tf.next()
    return reader


def _has_real():
    return all(common.has_real("flowers", f)
               for f in (_DATA, _LABELS, _SETID))


def _reader(split, n):
    def reader():
        s = common.Synthesizer("flowers", split, n)
        for _ in range(n):
            label = int(s.rs.randint(0, CLASSES))
            img = s.rs.rand(*_SHAPE).astype("float32")
            # class-dependent hue bias so models can actually fit
            img[label % 3] += (label / CLASSES)
            yield img, label
    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True):
    if _has_real():
        return _real_reader("train", mapper)
    return _reader("train", 2048)


def test(mapper=None, buffered_size=1024, use_xmap=True):
    if _has_real():
        return _real_reader("test", mapper)
    return _reader("test", 256)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    if _has_real():
        return _real_reader("valid", mapper)
    return _reader("valid", 256)
