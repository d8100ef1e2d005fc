"""WMT14 fr-en NMT dataset (reference ``dataset/wmt14.py``): samples
(src_ids, trg_ids_with_bos, trg_ids_with_eos); dict size 30000.

The port's copy of ``paddle_tpu/dataset/wmt14.py``: it imports nothing
of that package, and gives the same results.
"""

import os
import tarfile

from . import common

__all__ = ["train", "test", "N_SOURCE_DICT", "N_TARGET_DICT"]

N_SOURCE_DICT = 30000
N_TARGET_DICT = 30000
_BOS, _EOS, _UNK = 0, 1, 2
_ARCHIVE = "wmt14.tgz"
URL_TRAIN = ("http://paddlepaddle.cdn.bcebos.com/demo/"
             "wmt_shrinked_data/wmt14.tgz")
MD5_TRAIN = "0791583d57d5beb693b9414c5b36798c"
_START, _END = "<s>", "<e>"


def _real_path():
    return os.path.join(common.data_home("wmt14"), _ARCHIVE)


def _read_dicts(dict_size):
    """src.dict/trg.dict members: one word per line, id = line number
    (reference wmt14.py __read_to_dict__)."""
    def to_dict(fd, size):
        out = {}
        for i, line in enumerate(fd):
            if i >= size:
                break
            out[line.decode("utf-8", "ignore").strip()] = i
        return out
    with tarfile.open(_real_path()) as f:
        src = [m.name for m in f if m.name.endswith("src.dict")]
        trg = [m.name for m in f if m.name.endswith("trg.dict")]
        return (to_dict(f.extractfile(src[0]), dict_size),
                to_dict(f.extractfile(trg[0]), dict_size))


def _real_reader(file_name, dict_size):
    def reader():
        src_dict, trg_dict = _read_dicts(dict_size)
        with tarfile.open(_real_path()) as f:
            names = [m.name for m in f if m.name.endswith(file_name)]
            for name in names:
                for line in f.extractfile(name):
                    parts = line.decode("utf-8", "ignore") \
                        .strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src_ids = [src_dict.get(w, _UNK) for w in
                               [_START] + parts[0].split() + [_END]]
                    trg_ids = [trg_dict.get(w, _UNK)
                               for w in parts[1].split()]
                    if len(src_ids) > 80 or len(trg_ids) > 80:
                        continue
                    yield (src_ids, [trg_dict[_START]] + trg_ids,
                           trg_ids + [trg_dict[_END]])
    return reader


def _synth(split, n, dict_size):
    def reader():
        s = common.Synthesizer("wmt14", split, n)
        for _ in range(n):
            ln = int(s.rs.randint(4, 30))
            src = s.rs.randint(3, dict_size, ln).astype("int64").tolist()
            # deterministic "translation": shifted ids
            trg = [(w * 17 + 3) % (dict_size - 3) + 3 for w in src]
            yield src, [_BOS] + trg, trg + [_EOS]
    return reader


def train(dict_size=N_SOURCE_DICT):
    if common.has_real("wmt14", _ARCHIVE):
        return _real_reader("train/train", dict_size)
    return _synth("train", 4096, dict_size)


def test(dict_size=N_SOURCE_DICT):
    if common.has_real("wmt14", _ARCHIVE):
        return _real_reader("test/test", dict_size)
    return _synth("test", 512, dict_size)
