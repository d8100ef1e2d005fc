"""The port's datasets (``paddle_tpu_torch/dataset``) against the
reference's (``paddle_tpu/dataset``), all exact:

* each surrogate reader's first samples (no dataset file under the data
  home: the deterministic synthetic streams), and each dict and table;
* the real-file parsers on tiny archives in the reference's formats,
  built in ``tmp_path`` as ``tests/test_datasets_real.py`` builds them;
* ``download``: a pre-seeded, md5-matching file is a cache hit; a fetch
  goes through ``urllib.request.urlopen`` (monkeypatched: nothing here
  touches the network), and three failed fetches raise the reference's
  error; ``split``, ``cluster_files_reader`` and ``convert`` write and read
  the same bytes.
"""

import gzip
import io
import os
import pickle
import struct
import tarfile
import types
import urllib.request
import zipfile

import numpy as np
import pytest

import paddle_tpu.dataset as ref_ds
import paddle_tpu_torch.dataset as port_ds
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

FIRST = 6


def _same(got, want):
    """Exact equality of two samples (tuples, lists, arrays, numbers)."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert type(got) is type(want) and got == want, (got, want)


def _first(reader, n=FIRST):
    out = []
    for s in reader():
        out.append(s)
        if len(out) == n:
            break
    return out


@pytest.fixture(autouse=True)
def data_root(tmp_path, monkeypatch):
    """An empty data home of both packages (the surrogates), which a test
    fills with real-format files."""
    monkeypatch.setenv("PADDLE_TPU_DATASET_DIR", str(tmp_path))
    return tmp_path


# -- the surrogates ----------------------------------------------------------

READERS = [("mnist", "train"), ("mnist", "test"), ("cifar", "train10"),
           ("cifar", "test10"), ("cifar", "train100"),
           ("cifar", "test100"), ("uci_housing", "train"),
           ("uci_housing", "test"), ("imdb", "train"), ("imdb", "test"),
           ("imikolov", "train"), ("imikolov", "test"),
           ("movielens", "train"), ("movielens", "test"),
           ("wmt14", "train"), ("wmt14", "test"), ("mq2007", "train"),
           ("mq2007", "test"), ("conll05", "test"), ("flowers", "train"),
           ("flowers", "test"), ("flowers", "valid"), ("voc2012", "train"),
           ("voc2012", "test"), ("voc2012", "val"), ("sentiment", "train"),
           ("sentiment", "test")]


@pytest.mark.parametrize("module,split", READERS,
                         ids=["%s.%s" % r for r in READERS])
def test_surrogate_samples_equal_reference(module, split):
    got = _first(getattr(getattr(port_ds, module), split)())
    want = _first(getattr(getattr(ref_ds, module), split)())
    assert len(got) == len(want) == FIRST
    _same(got, want)


def test_surrogate_variants_equal_reference():
    """The readers' arguments: imikolov's n, wmt14's dict size, mq2007's
    format (its surrogate takes none), and a second pass of a reader
    starting over."""
    for args in ((None, 3), (None, 7)):
        _same(_first(port_ds.imikolov.train(*args)),
              _first(ref_ds.imikolov.train(*args)))
    _same(_first(port_ds.wmt14.train(1000)), _first(ref_ds.wmt14.train(1000)))
    _same(_first(port_ds.mq2007.test("listwise")),
          _first(ref_ds.mq2007.test("listwise")))
    r = port_ds.mnist.train()
    _same(_first(r), _first(r))


DICTS = [("imdb", "word_dict"), ("imikolov", "build_dict"),
         ("conll05", "get_dict"), ("conll05", "get_embedding"),
         ("sentiment", "get_word_dict"), ("movielens", "max_user_id"),
         ("movielens", "max_movie_id"), ("movielens", "max_job_id")]


@pytest.mark.parametrize("module,fn", DICTS, ids=["%s.%s" % d for d in DICTS])
def test_dicts_equal_reference(module, fn):
    got = getattr(getattr(port_ds, module), fn)()
    want = getattr(getattr(ref_ds, module), fn)()
    if isinstance(want, tuple):     # conll05's three dicts
        assert got == want and [list(g) for g in got] == \
            [list(w) for w in want]
    elif isinstance(want, dict):
        assert got == want and list(got) == list(want)
    else:
        _same(got, want)


def test_module_constants_equal_reference():
    assert port_ds.movielens.age_table == ref_ds.movielens.age_table
    for m, names in (("wmt14", ("N_SOURCE_DICT", "N_TARGET_DICT",
                                "URL_TRAIN", "MD5_TRAIN")),
                     ("imdb", ("URL", "MD5")), ("imikolov", ("URL", "MD5")),
                     ("movielens", ("URL", "MD5")),
                     ("uci_housing", ("URL", "MD5")),
                     ("conll05", ("DATA_URL", "DATA_MD5")),
                     ("flowers", ("CLASSES", "DATA_URL", "DATA_MD5"))):
        for n in names:
            assert getattr(getattr(port_ds, m), n) == \
                getattr(getattr(ref_ds, m), n), (m, n)

    def modules(pkg):
        return sorted(k for k, v in vars(pkg).items()
                      if isinstance(v, types.ModuleType))
    assert modules(port_ds) == modules(ref_ds)


# -- the real-file parsers ----------------------------------------------------

def _targz(path, members, mode="w:gz"):
    with tarfile.open(path, mode) as tf:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def _idx(path, magic, dims, data):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">%dI" % (1 + len(dims)), magic, *dims))
        f.write(data.tobytes())


def _mnist(d):
    rs = np.random.RandomState(0)
    for split, n in (("train", 5), ("t10k", 3)):
        _idx(str(d / ("%s-images-idx3-ubyte.gz" % split)), 2051,
             (n, 28, 28), rs.randint(0, 256, (n, 28, 28)).astype(np.uint8))
        _idx(str(d / ("%s-labels-idx1-ubyte.gz" % split)), 2049, (n,),
             rs.randint(0, 10, n).astype(np.uint8))
    return [("mnist", "train", ()), ("mnist", "test", ())]


def _cifar(d):
    rs = np.random.RandomState(1)

    def batch(n, key):
        return pickle.dumps({"data": rs.randint(0, 256, (n, 3072)).astype(
            np.uint8), key: rs.randint(0, 10, n).tolist()})
    _targz(str(d / "cifar-10-python.tar.gz"), {
        "cifar-10-batches-py/data_batch_1": batch(3, "labels"),
        "cifar-10-batches-py/test_batch": batch(2, "labels")})
    _targz(str(d / "cifar-100-python.tar.gz"), {
        "cifar-100-python/train": batch(3, "fine_labels"),
        "cifar-100-python/test": batch(2, "fine_labels")})
    return [("cifar", s, ()) for s in ("train10", "test10", "train100",
                                       "test100")]


def _imdb(d):
    docs = {}
    for i in range(3):
        docs["aclImdb/train/pos/%d.txt" % i] = b"a good great movie " * 40
        docs["aclImdb/train/neg/%d.txt" % i] = b"a bad awful movie " * 40
        docs["aclImdb/test/pos/%d.txt" % i] = b"good great " * 40
        docs["aclImdb/test/neg/%d.txt" % i] = b"bad awful " * 40
    _targz(str(d / "aclImdb_v1.tar.gz"), docs)
    return [("imdb", "word_dict", ()), ("imdb", "train", ()),
            ("imdb", "test", ())]


def _imikolov(d):
    text = b"the cat sat on the mat\nthe dog sat on the rug\n" * 30
    _targz(str(d / "simple-examples.tgz"),
           {"./simple-examples/data/ptb.train.txt": text,
            "./simple-examples/data/ptb.valid.txt": text})
    return [("imikolov", "build_dict", (5,)), ("imikolov", "train", ()),
            ("imikolov", "test", ())]


def _movielens(d):
    users = b"1::M::25::6::12345\n2::F::35::3::54321\n"
    movies = b"10::Film A (1990)::Comedy\n20::Film B::Drama\n"
    ratings = b"".join(b"%d::%d::%d::97830\n" % (u, m, 1 + (u + m) % 5)
                       for u in (1, 2) for m in (10, 20) for _ in range(5))
    with zipfile.ZipFile(str(d / "ml-1m.zip"), "w") as z:
        z.writestr("ml-1m/users.dat", users)
        z.writestr("ml-1m/movies.dat", movies)
        z.writestr("ml-1m/ratings.dat", ratings)
    return [("movielens", "train", ()), ("movielens", "test", ())]


def _wmt14(d):
    bitext = b"le chat noir\tthe black cat\n" * 4
    _targz(str(d / "wmt14.tgz"),
           {"wmt14/src.dict": b"<s>\n<e>\n<unk>\nle\nchat\nnoir\n",
            "wmt14/trg.dict": b"<s>\n<e>\n<unk>\nthe\ncat\nblack\n",
            "wmt14/train/train": bitext, "wmt14/test/test": bitext[:28]})
    return [("wmt14", "train", (6,)), ("wmt14", "test", (6,))]


def _sentiment(d):
    with zipfile.ZipFile(str(d / "movie_reviews.zip"), "w") as z:
        for i in range(5):
            z.writestr("movie_reviews/pos/cv%d.txt" % i,
                       "a wonderful film " * 20)
            z.writestr("movie_reviews/neg/cv%d.txt" % i,
                       "a terrible film " * 20)
    return [("sentiment", "get_word_dict", ()), ("sentiment", "train", ()),
            ("sentiment", "test", ())]


def _mq2007(d):
    d = d / "Fold1"
    d.mkdir()
    lines = ["%d qid:%d %s #docid=x" % (rel, qid, " ".join(
        "%d:%.2f" % (k + 1, rel * 0.1 + k) for k in range(46)))
        for qid in (1, 2) for rel in (0, 1, 2)]
    (d / "train.txt").write_text("\n".join(lines))
    (d / "test.txt").write_text("\n".join(lines[:3]))
    return [("mq2007", "train", ("pairwise",)),
            ("mq2007", "train", ("listwise",)),
            ("mq2007", "test", ("pairwise",))]


def _uci_housing(d):
    rows = np.random.RandomState(0).rand(506, 14)
    (d / "housing.data").write_text(
        "\n".join(" ".join("%.4f" % v for v in r) for r in rows))
    return [("uci_housing", "train", ()), ("uci_housing", "test", ())]


def _conll05(d):
    words = b"The\ncat\nsleeps\n.\n\n"
    props = b"- *\n- *\nsleep (V*)\n- *\n\n"
    _targz(str(d / "conll05st-tests.tar.gz"), {
        "conll05st-release/test.wsj/words/test.wsj.words.gz":
            gzip.compress(words),
        "conll05st-release/test.wsj/props/test.wsj.props.gz":
            gzip.compress(props)})
    (d / "wordDict.txt").write_text(
        "<unk>\nthe\ncat\nsleeps\n.\nbos\neos\nThe\n")
    (d / "verbDict.txt").write_text("sleep\nrun\n")
    (d / "targetDict.txt").write_text("O\nB-V\nI-V\nB-A0\nI-A0\n")
    return [("conll05", "get_dict", ()), ("conll05", "get_embedding", ()),
            ("conll05", "test", ())]


def _flowers(d):
    from PIL import Image
    from scipy.io import savemat
    jpgs = {}
    for i in range(1, 5):
        buf = io.BytesIO()
        Image.new("RGB", (32, 24), (i * 40 % 255, 10, 10)).save(buf, "JPEG")
        jpgs["jpg/image_%05d.jpg" % i] = buf.getvalue()
    _targz(str(d / "102flowers.tgz"), jpgs)
    savemat(str(d / "imagelabels.mat"), {"labels": np.array([[1, 2, 3, 4]])})
    savemat(str(d / "setid.mat"), {"trnid": np.array([[1, 2]]),
                                   "tstid": np.array([[3]]),
                                   "valid": np.array([[4]])})
    return [("flowers", s, ()) for s in ("train", "test", "valid")]


def _voc2012(d):
    from PIL import Image
    members = {}
    names = ["2007_000001", "2007_000002"]
    for n in names:
        buf = io.BytesIO()
        Image.new("RGB", (20, 16), (100, 50, 25)).save(buf, "JPEG")
        members["VOCdevkit/VOC2012/JPEGImages/%s.jpg" % n] = buf.getvalue()
        buf = io.BytesIO()
        m = Image.new("L", (20, 16), 0)
        m.putpixel((3, 3), 5)
        m.save(buf, "PNG")
        members["VOCdevkit/VOC2012/SegmentationClass/%s.png" % n] = \
            buf.getvalue()
    sets = "VOCdevkit/VOC2012/ImageSets/Segmentation/"
    members[sets + "train.txt"] = ("%s\n" % names[0]).encode()
    members[sets + "val.txt"] = ("%s\n" % names[1]).encode()
    members[sets + "trainval.txt"] = "\n".join(names).encode()
    _targz(str(d / "VOCtrainval_11-May-2012.tar"), members, mode="w")
    return [("voc2012", s, ()) for s in ("train", "test", "val")]


ARCHIVES = {"mnist": _mnist, "cifar": _cifar, "imdb": _imdb,
            "imikolov": _imikolov, "movielens": _movielens,
            "wmt14": _wmt14, "sentiment": _sentiment, "mq2007": _mq2007,
            "uci_housing": _uci_housing, "conll05st": _conll05,
            "flowers": _flowers, "voc2012": _voc2012}


@pytest.mark.parametrize("home", sorted(ARCHIVES))
def test_real_file_parsers_equal_reference(data_root, home):
    d = data_root / home
    d.mkdir()
    calls = ARCHIVES[home](d)
    for module, fn, args in calls:
        got = getattr(getattr(port_ds, module), fn)(*args)
        want = getattr(getattr(ref_ds, module), fn)(*args)
        if callable(want):
            got, want = list(got()), list(want())
            assert want, (module, fn)   # the real path ran
        if isinstance(want, dict):
            assert got == want and list(got) == list(want)
        elif isinstance(want, tuple) and isinstance(want[0], dict):
            assert got == want
        else:
            _same(got, want)


# -- common: download, shards ------------------------------------------------

def test_download_cache_hit(data_root):
    d = data_root / "mymod"
    d.mkdir()
    (d / "file.bin").write_bytes(b"hello")
    md5 = port_ds.common.md5file(str(d / "file.bin"))
    assert md5 == ref_ds.common.md5file(str(d / "file.bin"))
    for common in (port_ds.common, ref_ds.common):
        assert common.download("http://example.invalid/file.bin", "mymod",
                               md5) == str(d / "file.bin")


class _Fetch:
    """``urllib.request.urlopen`` stand-in: fails ``fail`` times with an
    OSError, then serves ``body``; counts its calls."""

    def __init__(self, fail, body=b""):
        self.fail, self.body, self.calls = fail, body, 0

    def __call__(self, url, timeout=None):
        self.calls += 1
        if self.calls <= self.fail:
            raise OSError("fetch %d of %s refused" % (self.calls, url))
        return io.BytesIO(self.body)


def test_download_three_failures_raise_the_reference_error(data_root,
                                                           monkeypatch):
    errors = []
    for common in (port_ds.common, ref_ds.common):
        fetch = _Fetch(fail=10)
        monkeypatch.setattr(urllib.request, "urlopen", fetch)
        with pytest.raises(RuntimeError) as e:
            common.download("http://example.invalid/x.tgz", "offline",
                            "0" * 32)
        assert fetch.calls == 3
        errors.append(str(e.value))
        assert not os.path.exists(str(data_root / "offline" / "x.tgz.part"))
    assert errors[0] == errors[1]
    assert "within 3 retries" in errors[0]


def test_download_retries_then_caches(data_root, monkeypatch):
    body = b"payload" * 100
    import hashlib
    md5 = hashlib.md5(body).hexdigest()
    for i, common in enumerate((port_ds.common, ref_ds.common)):
        fetch = _Fetch(fail=2, body=body)
        monkeypatch.setattr(urllib.request, "urlopen", fetch)
        got = common.download("http://example.invalid/f%d.bin" % i, "fetched",
                              md5)
        assert fetch.calls == 3
        assert open(got, "rb").read() == body
        assert common.download("http://example.invalid/f%d.bin" % i,
                               "fetched", md5) == got
        assert fetch.calls == 3     # the second call is a cache hit


def _samples():
    rs = np.random.RandomState(3)
    for i in range(23):
        yield (rs.randn(4).astype("float32"), i, [i] * (i % 4))


def test_split_and_cluster_reader_equal_reference(tmp_path):
    written = {}
    for name, common in (("port", port_ds.common), ("ref", ref_ds.common)):
        d = tmp_path / name
        d.mkdir()
        paths = common.split(_samples, 5, suffix=str(d / "%05d.pickle"))
        written[name] = [open(p, "rb").read() for p in paths]
        got = {k: list(common.cluster_files_reader(
            str(d / "*.pickle"), 2, k)()) for k in (0, 1)}
        written[name + "-read"] = got
    assert written["port"] == written["ref"] and len(written["port"]) == 5
    for k in (0, 1):
        _same(written["port-read"][k], written["ref-read"][k])
    with pytest.raises(TypeError):
        port_ds.common.split(_samples, 5, dumper="not callable")


def test_convert_writes_the_reference_recordio(tmp_path):
    outs = {}
    for name, common in (("port", port_ds.common), ("ref", ref_ds.common)):
        paths = common.convert(str(tmp_path / name), _samples, 10, "train",
                               max_chunk_bytes=256)
        outs[name] = [(os.path.basename(p), open(p, "rb").read())
                      for p in paths]
    assert outs["port"] == outs["ref"] and len(outs["port"]) == 3


def test_tokenize_and_freq_dict_equal_reference():
    text = "The cat, the CAT; a dog... (the end)"
    assert port_ds.common.word_tokenize(text) == \
        ref_ds.common.word_tokenize(text)

    def docs():
        yield ["b", "a", "c", "a"]
        yield ["c", "b", "a", "d"]
    for cutoff in (0, 1):
        key = ("test_torch_datasets", cutoff)
        got = port_ds.common.build_freq_dict(key, docs, cutoff=cutoff,
                                             extra=("<unk>",))
        want = ref_ds.common.build_freq_dict(key, docs, cutoff=cutoff,
                                             extra=("<unk>",))
        assert got == want and list(got) == list(want)
    s = port_ds.common.Synthesizer("x", "train", 3)
    r = ref_ds.common.Synthesizer("x", "train", 3)
    np.testing.assert_array_equal(s.rs.rand(5), r.rs.rand(5))
