"""PTB-style LM dataset (reference ``dataset/imikolov.py``): n-gram
samples (w0..wn-2, wn-1) from a 2074-word vocab.

The port's copy of ``paddle_tpu/dataset/imikolov.py``: it imports
nothing of that package, and gives the same results.
"""

import os
import tarfile

from . import common

__all__ = ["train", "test", "build_dict"]

_VOCAB = 2074
_ARCHIVE = "simple-examples.tgz"
URL = "http://www.fit.vutbr.cz/~imikolov/rnnlm/simple-examples.tgz"
MD5 = "30177ea32e27c525793142b6bf2c8e2d"
_TRAIN = "./simple-examples/data/ptb.train.txt"
_VALID = "./simple-examples/data/ptb.valid.txt"
def _real_path():
    return os.path.join(common.data_home("imikolov"), _ARCHIVE)


def _real_build_dict(min_word_freq=50):
    def docs():
        with tarfile.open(_real_path()) as tf:
            for line in tf.extractfile(_TRAIN):
                words = line.decode("utf-8", "ignore").split()
                yield [w for w in words if w != "<unk>"]
    d = dict(common.build_freq_dict(
        ("imikolov", _real_path(), min_word_freq), docs,
        cutoff=min_word_freq))
    # reference word_dict: ids shift by one for <s> at 0
    d = {w: i + 1 for w, i in d.items()}
    d["<s>"] = 0
    d["<e>"] = len(d)
    d["<unk>"] = len(d)
    return d


def _real_reader(member, word_idx, n):
    def reader():
        unk = word_idx["<unk>"]
        with tarfile.open(_real_path()) as tf:
            for line in tf.extractfile(member):
                words = line.decode("utf-8", "ignore").split()
                ids = [word_idx["<s>"]] + \
                    [word_idx.get(w, unk) for w in words] + \
                    [word_idx["<e>"]]
                for i in range(n, len(ids) + 1):
                    yield tuple(ids[i - n:i])
    return reader


def build_dict(min_word_freq=50):
    if common.has_real("imikolov", _ARCHIVE):
        return _real_build_dict(min_word_freq)
    return {"<s>": 0, "<e>": 1, "<unk>": 2,
            **{"w%d" % i: i for i in range(3, _VOCAB)}}


def _synth(split, n, ngram):
    def reader():
        s = common.Synthesizer("imikolov", split, n)
        for _ in range(n):
            # markov-ish chain: next word correlated with previous
            seq = [int(s.rs.randint(3, _VOCAB))]
            for _ in range(ngram - 1):
                nxt = (seq[-1] * 31 + int(s.rs.randint(0, 7))) % \
                    (_VOCAB - 3) + 3
                seq.append(nxt)
            yield tuple(seq)
    return reader


def train(word_idx=None, n=5):
    if common.has_real("imikolov", _ARCHIVE):
        return _real_reader(_TRAIN, word_idx or build_dict(), n)
    return _synth("train", 8192, n)


def test(word_idx=None, n=5):
    if common.has_real("imikolov", _ARCHIVE):
        return _real_reader(_VALID, word_idx or build_dict(), n)
    return _synth("test", 1024, n)
