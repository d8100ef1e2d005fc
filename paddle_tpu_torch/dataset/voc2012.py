"""PASCAL VOC2012 segmentation (reference
``python/paddle/v2/dataset/voc2012.py``): readers of
(image CHW float32, label mask HW int32 with 21 classes + 255 ignore).

The port's copy of ``paddle_tpu/dataset/voc2012.py``: it imports nothing
of that package, and gives the same results.
"""

import io
import os
import tarfile

import numpy as np

from . import common

__all__ = ["train", "test", "val"]

CLASSES = 21
IGNORE = 255
_H = _W = 96
_ARCHIVE = "VOCtrainval_11-May-2012.tar"
URL = ("http://host.robots.ox.ac.uk/pascal/VOC/voc2012/"
       "VOCtrainval_11-May-2012.tar")
MD5 = "6cd6e144f989b92b3379bac3b3de84fd"
_ROOT = "VOCdevkit/VOC2012"


def _real_reader(split):
    """VOC segmentation pairs (reference voc2012.py reader_creator):
    (image CHW float32 in [0,1], mask HW int32 with class ids, 255 =
    void). Images keep their native sizes, as the reference."""
    path = os.path.join(common.data_home("voc2012"), _ARCHIVE)
    seg_split = {"train": "train", "val": "val", "test": "trainval"}

    def reader():
        from PIL import Image
        with tarfile.open(path) as tf:
            lst = tf.extractfile(
                "%s/ImageSets/Segmentation/%s.txt"
                % (_ROOT, seg_split[split])).read().decode().split()
            for name in lst:
                img = Image.open(io.BytesIO(tf.extractfile(
                    "%s/JPEGImages/%s.jpg" % (_ROOT, name)).read())
                ).convert("RGB")
                mask = Image.open(io.BytesIO(tf.extractfile(
                    "%s/SegmentationClass/%s.png"
                    % (_ROOT, name)).read()))
                arr = np.asarray(img, dtype="float32") / 255.0
                yield (arr.transpose(2, 0, 1),
                       np.asarray(mask, dtype="int32"))
    return reader


def _reader(split, n):
    def reader():
        s = common.Synthesizer("voc2012", split, n)
        for _ in range(n):
            img = s.rs.rand(3, _H, _W).astype("float32")
            mask = np.zeros((_H, _W), dtype="int32")
            # a few rectangular object regions
            for _ in range(int(s.rs.randint(1, 4))):
                c = int(s.rs.randint(1, CLASSES))
                y0, x0 = s.rs.randint(0, _H - 16), s.rs.randint(0, _W - 16)
                h, w = s.rs.randint(8, 32), s.rs.randint(8, 32)
                mask[y0:y0 + h, x0:x0 + w] = c
                img[:, y0:y0 + h, x0:x0 + w] += c / CLASSES
            # thin ignore border like the reference's void boundary
            mask[0], mask[-1], mask[:, 0], mask[:, -1] = (IGNORE,) * 4
            yield img, mask
    return reader


def train():
    if common.has_real("voc2012", _ARCHIVE):
        return _real_reader("train")
    return _reader("train", 1024)


def test():
    if common.has_real("voc2012", _ARCHIVE):
        return _real_reader("test")
    return _reader("test", 128)


def val():
    if common.has_real("voc2012", _ARCHIVE):
        return _real_reader("val")
    return _reader("val", 128)
