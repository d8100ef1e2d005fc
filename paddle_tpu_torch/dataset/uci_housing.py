"""UCI housing (reference ``dataset/uci_housing.py``): samples are
(features[13] float32 normalized, price float32).

The port's copy of ``paddle_tpu/dataset/uci_housing.py``: it imports
nothing of that package, and gives the same results.
"""

import os

import numpy as np

from . import common

__all__ = ["train", "test"]

_W = None


def _synth(split, n):
    global _W
    if _W is None:
        _W = np.random.RandomState(7).randn(13, 1).astype("float32")

    def reader():
        s = common.Synthesizer("uci_housing", split, n)
        for _ in range(n):
            x = s.rs.randn(13).astype("float32")
            y = float((x @ _W)[0] + 0.1 * s.rs.randn())
            yield x, np.array([y], dtype="float32")
    return reader


def _real(path, start, end):
    def reader():
        data = np.loadtxt(path)
        data = (data - data.mean(0)) / (data.std(0) + 1e-8)
        for row in data[start:end]:
            yield row[:13].astype("float32"), row[13:14].astype("float32")
    return reader


URL = ("https://archive.ics.uci.edu/ml/machine-learning-databases/"
       "housing/housing.data")
MD5 = "d4accdce7a25600298819f8e28e8d593"


def train():
    p = os.path.join(common.data_home("uci_housing"), "housing.data")
    if common.has_real("uci_housing", "housing.data"):
        return _real(p, 0, 404)
    return _synth("train", 2048)


def test():
    p = os.path.join(common.data_home("uci_housing"), "housing.data")
    if common.has_real("uci_housing", "housing.data"):
        return _real(p, 404, 506)
    return _synth("test", 256)
