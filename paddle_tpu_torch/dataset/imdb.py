"""IMDB sentiment (reference ``dataset/imdb.py``): samples are
(word-id list, label 0/1); ``word_dict()`` returns the vocab.

The port's copy of ``paddle_tpu/dataset/imdb.py``: it imports nothing of
that package, and gives the same results.
"""

import os
import re
import tarfile

import numpy as np

from . import common

__all__ = ["train", "test", "word_dict"]

_VOCAB = 5147  # matches the reference's IMDB cutoff-150 dict size ballpark
_ARCHIVE = "aclImdb_v1.tar.gz"
URL = "http://ai.stanford.edu/%7Eamaas/data/sentiment/aclImdb_v1.tar.gz"
MD5 = "7c2ac02c03563afcf9b574c7e56c153a"
def _tokenize(tarf, pattern):
    """Sequential tar walk (reference imdb.py tokenize note: next()
    avoids random access)."""
    pat = re.compile(pattern)
    tf = tarf.next()
    while tf is not None:
        if bool(pat.match(tf.name)):
            yield common.word_tokenize(
                tarf.extractfile(tf).read().decode("utf-8", "ignore"))
        tf = tarf.next()


def _real_word_dict(path, cutoff=150):
    def docs():
        with tarfile.open(path) as tarf:
            yield from _tokenize(
                tarf,
                r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$")
    return common.build_freq_dict(("imdb", path, cutoff), docs,
                                  cutoff=cutoff, extra=("<unk>",))


def _real_reader(split, word_idx):
    """Reference reader_creator semantics: pos docs label 0, neg 1."""
    path = os.path.join(common.data_home("imdb"), _ARCHIVE)

    def reader():
        unk = word_idx["<unk>"]
        for label, pol in ((0, "pos"), (1, "neg")):
            with tarfile.open(path) as tarf:
                pat = r"aclImdb/%s/%s/.*\.txt$" % (split, pol)
                for doc in _tokenize(tarf, pat):
                    yield [word_idx.get(w, unk) for w in doc], label
    return reader


def word_dict():
    if common.has_real("imdb", _ARCHIVE):
        return _real_word_dict(
            os.path.join(common.data_home("imdb"), _ARCHIVE))
    return {"<pad>": 0, "<unk>": 1,
            **{"w%d" % i: i for i in range(2, _VOCAB)}}


def _synth(split, n):
    def reader():
        s = common.Synthesizer("imdb", split, n)
        for _ in range(n):
            lab = int(s.rs.randint(0, 2))
            ln = int(s.rs.randint(20, 120))
            ids = s.rs.randint(10, _VOCAB, ln)
            if lab:  # positive reviews carry marker bigrams
                for _ in range(max(1, ln // 30)):
                    p = s.rs.randint(0, ln - 1)
                    ids[p:p + 2] = [5, 6]
            yield ids.astype("int64").tolist(), lab
    return reader


def train(word_idx=None):
    if common.has_real("imdb", _ARCHIVE):
        return _real_reader("train", word_idx or word_dict())
    return _synth("train", 4096)


def test(word_idx=None):
    if common.has_real("imdb", _ARCHIVE):
        return _real_reader("test", word_idx or word_dict())
    return _synth("test", 512)
