"""MQ2007 learning-to-rank (reference ``dataset/mq2007.py``): pairwise
mode yields (query_features_a[46], features_b[46], label).

The port's copy of ``paddle_tpu/dataset/mq2007.py``: it imports nothing
of that package, and gives the same results.
"""

import os

import numpy as np

from . import common

__all__ = ["train", "test"]

URL = ("https://download.microsoft.com/download/E/7/E/"
       "E7EABEF1-4C7B-4E31-ACE5-73927950ED5E/Letor.zip")
MD5 = None
# stdlib cannot unpack the upstream .rar — pre-extract Fold1/ into the
# cache dir (the LETOR text format is what gets parsed)
_TRAIN_FILE = os.path.join("Fold1", "train.txt")
_TEST_FILE = os.path.join("Fold1", "test.txt")


def _parse_letor(path):
    """LETOR line: '<rel> qid:<q> 1:<v> ... 46:<v> #docid ...'.
    Returns {qid: [(rel, feat[46])...]}."""
    queries = {}
    with open(path) as f:
        for line in f:
            data = line.split("#")[0].split()
            if len(data) < 3:
                continue
            rel = int(data[0])
            qid = data[1].split(":")[1]
            feats = np.zeros(46, dtype="float32")
            for tok in data[2:]:
                k, v = tok.split(":")
                feats[int(k) - 1] = float(v)
            queries.setdefault(qid, []).append((rel, feats))
    return queries


def _real_reader(filename, format):
    path = os.path.join(common.data_home("mq2007"), filename)

    def pairwise():
        for qid, docs in _parse_letor(path).items():
            for i in range(len(docs)):
                for j in range(i + 1, len(docs)):
                    ri, fi = docs[i]
                    rj, fj = docs[j]
                    if ri == rj:
                        continue
                    # label 1 when a outranks b (reference pairwise)
                    if ri > rj:
                        yield fi, fj, 1.0
                    else:
                        yield fi, fj, 0.0

    def listwise():
        for qid, docs in _parse_letor(path).items():
            rels = np.array([d[0] for d in docs], dtype="float32")
            feats = np.stack([d[1] for d in docs])
            yield feats, rels

    return pairwise if format == "pairwise" else listwise


def _synth(split, n):
    def reader():
        s = common.Synthesizer("mq2007", split, n)
        import numpy as np
        w = np.random.RandomState(3).randn(46).astype("float32")
        for _ in range(n):
            a = s.rs.randn(46).astype("float32")
            b = s.rs.randn(46).astype("float32")
            label = 1.0 if float((a - b) @ w) > 0 else 0.0
            yield a, b, label
    return reader


def train(format="pairwise"):
    if common.has_real("mq2007", _TRAIN_FILE):
        return _real_reader(_TRAIN_FILE, format)
    return _synth("train", 4096)


def test(format="pairwise"):
    if common.has_real("mq2007", _TEST_FILE):
        return _real_reader(_TEST_FILE, format)
    return _synth("test", 512)
