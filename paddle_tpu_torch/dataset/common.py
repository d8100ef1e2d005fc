"""Dataset infrastructure (reference ``python/paddle/v2/dataset/common.py``:
download cache, converters).

Each dataset module follows the same policy: if real data exists under
``$PADDLE_TPU_DATASET_DIR/<name>`` (the file formats of the reference's
``~/.cache/paddle/dataset``), it is read; otherwise a deterministic
synthetic surrogate with the same shapes, vocabulary and API is drawn, so
every pipeline, model and test runs end to end without the files. Nothing
here fetches a file unless ``download`` is called.

The port's copy of ``paddle_tpu/dataset/common.py``: it imports nothing
of that package, and gives the same results (the surrogates draw the
same ``numpy.random.RandomState`` streams).
"""

import os

import numpy as np

__all__ = ["data_home", "has_real", "Synthesizer",
           "md5file", "download", "word_tokenize",
           "build_freq_dict", "split", "cluster_files_reader",
           "convert"]


def data_home(name):
    root = os.environ.get("PADDLE_TPU_DATASET_DIR",
                          os.path.expanduser("~/.cache/paddle_tpu/dataset"))
    return os.path.join(root, name)


def has_real(name, filename):
    return os.path.exists(os.path.join(data_home(name), filename))


def md5file(fname):
    import hashlib
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum):
    """Download-with-cache (reference common.py:61): returns the cached
    path when present AND md5-verified; otherwise fetches (3 retries).
    Where a host has no network, pre-seed the cache dir
    ($PADDLE_TPU_DATASET_DIR/<module>/<basename>) and this is a pure
    cache hit, exactly like a warmed reference ~/.cache."""
    dirname = data_home(module_name)
    os.makedirs(dirname, exist_ok=True)
    filename = os.path.join(dirname, url.split("/")[-1])
    retry = 0
    last_err = None
    while not (os.path.exists(filename) and
               (md5sum is None or md5file(filename) == md5sum)):
        if retry >= 3:
            raise RuntimeError(
                "cannot download %s within 3 retries (no network "
                "egress? pre-seed %s)%s"
                % (url, filename,
                   ": last error %s" % last_err if last_err else ""))
        retry += 1
        # fetch to a temp name, rename only on success: a partial
        # write must never be mistaken for a valid cache entry
        # (especially with md5sum=None)
        tmp = filename + ".part"
        try:
            import shutil
            import urllib.request
            with urllib.request.urlopen(url, timeout=60) as r, \
                    open(tmp, "wb") as f:
                shutil.copyfileobj(r, f)
            os.replace(tmp, filename)
        except Exception as e:  # URLError, timeout, reset mid-copy
            last_err = e
            if os.path.exists(tmp):
                os.remove(tmp)
    return filename


def _shard_stream(reader, line_count, write_shard):
    """Accumulate ``line_count`` samples per shard and hand each full
    (or trailing partial) shard to ``write_shard(index, lines) ->
    path``. Shared by split() and convert()."""
    paths, lines, indx_f = [], [], 0

    def flush():
        nonlocal lines, indx_f
        paths.append(write_shard(indx_f, lines))
        lines = []
        indx_f += 1

    for d in reader():
        lines.append(d)
        if len(lines) >= line_count:
            flush()
    if lines:
        flush()
    return paths


def split(reader, line_count, suffix="%05d.pickle", dumper=None):
    """Split a sample stream into per-file pickled shards (reference
    ``dataset/common.py:125`` split): ``suffix`` must contain one
    ``%d``-style placeholder. Returns the list of written paths."""
    import pickle
    if dumper is None:
        dumper = pickle.dump
    if not callable(dumper):
        raise TypeError("dumper should be callable.")

    def write_shard(i, lines):
        path = suffix % i
        with open(path, "wb") as f:
            dumper(lines, f)
        return path

    return _shard_stream(reader, line_count, write_shard)


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=None):
    """Reader over the shard files assigned to this trainer by
    round-robin rank (reference ``dataset/common.py:158``)."""
    import glob
    import pickle
    if loader is None:
        loader = pickle.load

    def reader():
        if not callable(loader):
            raise TypeError("loader should be callable.")
        file_list = sorted(glob.glob(files_pattern))
        for idx, fn in enumerate(file_list):
            if idx % trainer_count != trainer_id:
                continue
            with open(fn, "rb") as f:
                for line in loader(f):
                    yield line
    return reader


def convert(output_path, reader, line_count, name_prefix,
            max_chunk_bytes=1 << 14):
    """Convert a dataset reader to RecordIO shard files (reference
    ``dataset/common.py:193``) — the bridge from the 13 dataset modules
    to the elastic master's chunk tasks: feed the returned paths (or
    the ``<output_path>/<name_prefix>-*`` glob) to
    ``distributed.ElasticDataDispatcher``. ``line_count`` samples per
    file; ``max_chunk_bytes`` sets the intra-file chunk (= task lease)
    granularity. Returns the list of written paths."""
    from ..reader.recordio import write_recordio
    assert line_count >= 1
    os.makedirs(output_path, exist_ok=True)

    def write_shard(i, lines):
        path = os.path.join(output_path, "%s-%05d" % (name_prefix, i))
        write_recordio(path, lines, max_chunk_bytes=max_chunk_bytes)
        return path

    return _shard_stream(reader, line_count, write_shard)


class Synthesizer:
    """Deterministic synthetic sample stream."""

    def __init__(self, name, split, n):
        # crc32, NOT hash(): str hashes are salted per process
        # (PYTHONHASHSEED), which made every run draw different
        # synthetic data and marginal convergence asserts flaky
        import zlib
        key = ("%s/%s" % (name, split)).encode()
        seed = (zlib.crc32(key) & 0x7FFFFFFF) or 1
        self.rs = np.random.RandomState(seed)
        self.n = n


_WORD_PAT = None


def word_tokenize(text):
    r"""Lowercase \W+ tokenization (the reference imdb/sentiment
    tokenizer — shared so the corpora stay consistent)."""
    global _WORD_PAT
    if _WORD_PAT is None:
        import re
        _WORD_PAT = re.compile(r"\W+")
    return [w for w in _WORD_PAT.split(text.lower()) if w]


_dict_cache = {}


def build_freq_dict(key, doc_iter_fn, cutoff=0, extra=()):
    """Memoized frequency dict over a token-doc iterator; ids ordered
    by (-frequency, word) ascending — the REFERENCE tie-break
    (build_dict's key=lambda x: (-x[1], x[0])), so ids match dicts
    built by the reference exactly. ``extra`` words append after."""
    if key in _dict_cache:
        return _dict_cache[key]
    import collections
    freq = collections.defaultdict(int)
    for doc in doc_iter_fn():
        for w in doc:
            freq[w] += 1
    kept = sorted(((w, f) for w, f in freq.items() if f > cutoff),
                  key=lambda x: (-x[1], x[0]))
    d = {w: i for i, (w, f) in enumerate(kept)}
    for w in extra:
        d[w] = len(d)
    _dict_cache[key] = d
    return d
