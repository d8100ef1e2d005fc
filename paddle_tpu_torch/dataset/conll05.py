"""CoNLL-2005 semantic role labeling (reference
``python/paddle/v2/dataset/conll05.py``): each sample is nine aligned
sequences — (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred_ids,
mark, label_ids) — where the five ctx_* features and pred_ids repeat one
value over the sentence length, mark is 0/1 near the predicate, and
labels are BIO SRL tags. ``get_dict()`` returns (word, verb, label)
dicts; ``get_embedding()`` a [vocab, 32] matrix.

The port's copy of ``paddle_tpu/dataset/conll05.py``: it imports nothing
of that package, and gives the same results.
"""

import gzip
import itertools
import os
import tarfile

import numpy as np

from . import common

__all__ = ["get_dict", "get_embedding", "test"]

_ARCHIVE = "conll05st-tests.tar.gz"
DATA_URL = "http://www.cs.upc.edu/~srlconll/conll05st-tests.tar.gz"
DATA_MD5 = "387719152ae52d60422c016e92a742fc"
_WORDS_NAME = "conll05st-release/test.wsj/words/test.wsj.words.gz"
_PROPS_NAME = "conll05st-release/test.wsj/props/test.wsj.props.gz"
_UNK_IDX = 0


def _load_dict(path):
    with open(path) as f:
        return {line.strip(): i for i, line in enumerate(f)}


def _have_real():
    home = common.data_home("conll05st")
    return all(os.path.exists(os.path.join(home, f)) for f in
               (_ARCHIVE, "wordDict.txt", "verbDict.txt",
                "targetDict.txt"))


def _corpus_reader(data_path, words_name, props_name):
    """Faithful transcription of the reference corpus_reader
    (conll05.py:50-120): parallel words/props streams; props columns
    expand to per-verb BIO tag sequences."""

    def reader():
        with tarfile.open(data_path) as tf:
            wf = tf.extractfile(words_name)
            pf = tf.extractfile(props_name)
            with gzip.GzipFile(fileobj=wf) as words_file, \
                    gzip.GzipFile(fileobj=pf) as props_file:
                sentences, labels, one_seg = [], [], []
                for word, label in itertools.zip_longest(words_file,
                                                         props_file):
                    word = (word or b"").decode().strip()
                    label = (label or b"").decode().strip().split()
                    if len(label) == 0:  # end of sentence
                        for i in range(len(one_seg[0]) if one_seg
                                       else 0):
                            labels.append([x[i] for x in one_seg])
                        if len(labels) >= 1:
                            verb_list = [x for x in labels[0]
                                         if x != "-"]
                            for i, lbl in enumerate(labels[1:]):
                                cur_tag, in_br = "O", False
                                seq = []
                                for l in lbl:
                                    if l == "*" and not in_br:
                                        seq.append("O")
                                    elif l == "*" and in_br:
                                        seq.append("I-" + cur_tag)
                                    elif l == "*)":
                                        seq.append("I-" + cur_tag)
                                        in_br = False
                                    elif "(" in l and ")" in l:
                                        cur_tag = l[1:l.find("*")]
                                        seq.append("B-" + cur_tag)
                                        in_br = False
                                    elif "(" in l:
                                        cur_tag = l[1:l.find("*")]
                                        seq.append("B-" + cur_tag)
                                        in_br = True
                                    else:
                                        raise RuntimeError(
                                            "Unexpected label: %s" % l)
                                yield sentences, verb_list[i], seq
                        sentences, labels, one_seg = [], [], []
                    else:
                        sentences = sentences + [word]
                        one_seg.append(label)
    return reader


def _real_reader():
    """Reference reader_creator: per-verb sample with the five ctx
    windows, predicate column, and mark vector."""
    home = common.data_home("conll05st")
    word_dict = _load_dict(os.path.join(home, "wordDict.txt"))
    predicate_dict = _load_dict(os.path.join(home, "verbDict.txt"))
    label_dict = _load_dict(os.path.join(home, "targetDict.txt"))
    corpus = _corpus_reader(os.path.join(home, _ARCHIVE),
                            _WORDS_NAME, _PROPS_NAME)

    def reader():
        for sentence, predicate, labels in corpus():
            sen_len = len(sentence)
            verb_index = labels.index("B-V")
            mark = [0] * len(labels)

            def ctx(off, fallback):
                p = verb_index + off
                if 0 <= p < len(labels):
                    mark[p] = 1
                    return sentence[p]
                return fallback
            ctx_n2 = ctx(-2, "bos")
            ctx_n1 = ctx(-1, "bos")
            ctx_0 = ctx(0, None)
            ctx_p1 = ctx(1, "eos")
            ctx_p2 = ctx(2, "eos")
            wi = [word_dict.get(w, _UNK_IDX) for w in sentence]

            def rep(w):
                return [word_dict.get(w, _UNK_IDX)] * sen_len
            yield (wi, rep(ctx_n2), rep(ctx_n1), rep(ctx_0),
                   rep(ctx_p1), rep(ctx_p2),
                   [predicate_dict.get(predicate)] * sen_len, mark,
                   [label_dict.get(w) for w in labels])
    return reader

_WORDS = 5000
_VERBS = 300
# BIO tagset: O + B-/I- over 32 roles (reference label dict ~ 67 tags)
_ROLES = 32


def get_dict():
    if _have_real():
        home = common.data_home("conll05st")
        return (_load_dict(os.path.join(home, "wordDict.txt")),
                _load_dict(os.path.join(home, "verbDict.txt")),
                _load_dict(os.path.join(home, "targetDict.txt")))
    word_dict = {"<unk>": 0, "eos": 1,
                 **{"w%d" % i: i for i in range(2, _WORDS)}}
    verb_dict = {"v%d" % i: i for i in range(_VERBS)}
    label_dict = {"O": 0}
    for r in range(_ROLES):
        label_dict["B-A%d" % r] = 1 + 2 * r
        label_dict["I-A%d" % r] = 2 + 2 * r
    return word_dict, verb_dict, label_dict


def get_embedding():
    if _have_real():
        home = common.data_home("conll05st")
        emb_path = os.path.join(home, "emb")
        word_dict = _load_dict(os.path.join(home, "wordDict.txt"))
        if os.path.exists(emb_path):
            # reference emb file: one row of 32 floats per word
            emb = np.loadtxt(emb_path, dtype="float32")
            return emb.reshape(len(word_dict), -1)
        # no pretrained file seeded: random matrix sized to the REAL
        # dict (get_dict() switched too — ids must stay in range)
        rs = np.random.RandomState(7)
        return (rs.randn(len(word_dict), 32) * 0.1).astype("float32")
    rs = np.random.RandomState(7)
    return (rs.randn(_WORDS, 32) * 0.1).astype("float32")


def _reader(split, n):
    def reader():
        s = common.Synthesizer("conll05st", split, n)
        for _ in range(n):
            ln = int(s.rs.randint(5, 40))
            words = s.rs.randint(2, _WORDS, ln).astype("int64")
            vpos = int(s.rs.randint(0, ln))
            verb = int(s.rs.randint(0, _VERBS))

            def ctx(off):
                p = vpos + off
                return int(words[p]) if 0 <= p < ln else 1  # eos

            mark = np.zeros(ln, dtype="int64")
            mark[max(0, vpos - 2):vpos + 3] = 1
            # labels: role spans around the predicate, O elsewhere
            labels = np.zeros(ln, dtype="int64")
            role = int(s.rs.randint(0, _ROLES))
            span = int(s.rs.randint(1, 4))
            start = max(0, vpos - span)
            labels[start] = 1 + 2 * role           # B-
            labels[start + 1:vpos + 1] = 2 + 2 * role  # I-
            yield (words.tolist(),
                   [ctx(-2)] * ln, [ctx(-1)] * ln, [ctx(0)] * ln,
                   [ctx(1)] * ln, [ctx(2)] * ln,
                   [verb] * ln, mark.tolist(), labels.tolist())
    return reader


def test():
    """Reference note kept: the CoNLL05 train set is not free, so the
    test split is used for training (conll05.py:204)."""
    if _have_real():
        return _real_reader()
    return _reader("test", 1024)
