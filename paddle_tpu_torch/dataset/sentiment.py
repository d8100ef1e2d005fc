"""Movie-review sentiment (reference
``python/paddle/v2/dataset/sentiment.py``, NLTK movie_reviews corpus):
``get_word_dict()`` + train/test readers of (word-id list, label 0/1).

The port's copy of ``paddle_tpu/dataset/sentiment.py``: it imports
nothing of that package, and gives the same results.
"""

import os
import zipfile

import numpy as np

from . import common

__all__ = ["get_word_dict", "train", "test"]

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000
_VOCAB = 8000
_ARCHIVE = "movie_reviews.zip"
URL = ("https://raw.githubusercontent.com/nltk/nltk_data/gh-pages/"
       "packages/corpora/movie_reviews.zip")
MD5 = None
def _real_path():
    return os.path.join(common.data_home("sentiment"), _ARCHIVE)


def _real_docs():
    """(tokens, label) per review; pos=0, neg=1 (the reference's
    sorted-category order)."""
    with zipfile.ZipFile(_real_path()) as z:
        names = sorted(z.namelist())
        for label, pol in ((0, "pos"), (1, "neg")):
            marker = "movie_reviews/%s/" % pol
            for n in names:
                if marker in n and n.endswith(".txt"):
                    text = z.read(n).decode("utf-8", "ignore")
                    yield common.word_tokenize(text), label


def _real_word_dict():
    return common.build_freq_dict(
        ("sentiment", _real_path()),
        lambda: (toks for toks, _ in _real_docs()))


def _real_reader(split):
    def reader():
        wd = _real_word_dict()
        # deterministic interleaved split keeps both classes in both
        # splits (the reference shuffles with a fixed seed)
        for i, (toks, label) in enumerate(_real_docs()):
            if (i % 5 == 4) == (split == "test"):
                yield [wd[w] for w in toks if w in wd], label
    return reader


def get_word_dict():
    """Sorted-by-frequency word dict (reference sentiment.py:53)."""
    if common.has_real("sentiment", _ARCHIVE):
        return _real_word_dict()
    return {"w%d" % i: i for i in range(_VOCAB)}


def _reader(split, n):
    def reader():
        s = common.Synthesizer("sentiment", split, n)
        for _ in range(n):
            label = int(s.rs.randint(0, 2))
            ln = int(s.rs.randint(30, 200))
            ids = s.rs.randint(20, _VOCAB, ln)
            if label:  # positive marker tokens
                pos = s.rs.randint(0, ln, max(1, ln // 40))
                ids[pos] = 7
            yield ids.astype("int64").tolist(), label
    return reader


def train():
    if common.has_real("sentiment", _ARCHIVE):
        return _real_reader("train")
    return _reader("train", NUM_TRAINING_INSTANCES)


def test():
    if common.has_real("sentiment", _ARCHIVE):
        return _real_reader("test")
    return _reader("test", NUM_TOTAL_INSTANCES - NUM_TRAINING_INSTANCES)
