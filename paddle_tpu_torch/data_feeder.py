"""DataFeeder: batch of python samples -> feed dict of padded arrays
(reference ``paddle_tpu/data_feeder.py``, numpy only).

Parity with reference ``fluid/data_feeder.py`` (numpy->LoDTensor) and the
legacy DataProviderConverter (``py_paddle/dataprovider_converter.py``):
variable-length fields become (padded array, lengths array), the LoD
replacement, with optional bucketing to limit distinct shapes.
"""

import numpy as np

from .core.framework import Variable, convert_dtype

__all__ = ["DataFeeder", "pad_batch", "bucket_batch_by_length"]


def _index_dtype():
    """Allocation dtype for ids/lengths buffers: the width they will
    actually cross the wire in (int32: 64-bit types are demoted, as in
    the reference without jax x64) — padding in int64 just to down-cast
    on the card doubles the host-to-device bytes."""
    return convert_dtype("int64")


def _feed_dtype(var):
    """Buffer dtype for a feed var: its wire_dtype when declared (the
    narrow-wire path keeps batches in wire form end to end; the
    executor widens on the card), else the model dtype."""
    if not isinstance(var, Variable):
        return None
    wd = getattr(var, "wire_dtype", None)
    return wd if wd is not None else convert_dtype(var.dtype)


def pad_batch(seqs, pad_value=0, maxlen=None, dtype=None):
    """list of 1-D/2-D samples -> (padded [N,T,...], lengths [N])."""
    lengths = np.array([len(s) for s in seqs], dtype=_index_dtype())
    t = int(maxlen or lengths.max())
    first = np.asarray(seqs[0])
    tail_shape = first.shape[1:]
    dtype = dtype or first.dtype
    out = np.full((len(seqs), t) + tail_shape, pad_value, dtype=dtype)
    for i, s in enumerate(seqs):
        arr = np.asarray(s)[:t]
        out[i, :len(arr)] = arr
    return out, np.minimum(lengths, t)


def bucket_batch_by_length(maxlen, buckets):
    """Round maxlen up to a bucket boundary (static-shape friendly)."""
    for b in buckets:
        if maxlen <= b:
            return b
    return buckets[-1]


def _norm_sparse_row(row):
    """A sparse row is ``[(id, value), ...]``, ``([ids], [values])``,
    or a bare id list (binary; all-ones values synthesized) —
    reference SparseFloat/SparseBinaryScanner formats
    (py_paddle/dataprovider_converter.py:154,184). The (ids, values)
    form must be a tuple of two LISTS/arrays — a tuple of two (id,
    value) TUPLES is parsed as a pair list, keeping the two forms
    unambiguous."""
    if isinstance(row, tuple) and len(row) == 2 and \
            isinstance(row[0], (list, np.ndarray)):
        ids, vals = row
        return list(ids), [float(v) for v in vals]
    row = list(row)
    if row and isinstance(row[0], (tuple, list)):
        return [p[0] for p in row], [float(p[1]) for p in row]
    return row, [1.0] * len(row)


def _pad_sparse(col, depth):
    """Ragged sparse field -> (ids, values[, lengths[, sub_lengths]])
    dense arrays. depth = number of sequence levels above the K axis
    (0: [B,K]; 1: [B,T,K] + len; 2: [B,S,T,K] + len + sublen)."""
    def rows_of(sample, d):
        # normalize to a nested list-of-...-of (ids, vals) rows
        return _norm_sparse_row(sample) if d == 0 else \
            [rows_of(s, d - 1) for s in sample]

    norm = [rows_of(s, depth) for s in col]
    b = len(norm)
    idt = _index_dtype()
    if depth == 0:
        k = max(max((len(r[0]) for r in norm), default=1), 1)
        ids = np.zeros((b, k), idt)
        vals = np.zeros((b, k), "float32")
        for i, (rid, rv) in enumerate(norm):
            ids[i, :len(rid)] = rid
            vals[i, :len(rv)] = rv
        return ids, vals
    if depth == 1:
        t = max(max((len(s) for s in norm), default=1), 1)
        k = max(max((len(r[0]) for s in norm for r in s), default=1), 1)
        ids = np.zeros((b, t, k), idt)
        vals = np.zeros((b, t, k), "float32")
        lens = np.zeros((b,), idt)
        for i, s in enumerate(norm):
            lens[i] = len(s)
            for j, (rid, rv) in enumerate(s):
                ids[i, j, :len(rid)] = rid
                vals[i, j, :len(rv)] = rv
        return ids, vals, lens
    # depth == 2
    s_max = max(max((len(s) for s in norm), default=1), 1)
    t = max(max((len(sub) for s in norm for sub in s), default=1), 1)
    k = max(max((len(r[0]) for s in norm for sub in s for r in sub),
                default=1), 1)
    ids = np.zeros((b, s_max, t, k), idt)
    vals = np.zeros((b, s_max, t, k), "float32")
    lens = np.zeros((b,), idt)
    subl = np.zeros((b, s_max), idt)
    for i, s in enumerate(norm):
        lens[i] = len(s)
        for j, sub in enumerate(s):
            subl[i, j] = len(sub)
            for m, (rid, rv) in enumerate(sub):
                ids[i, j, m, :len(rid)] = rid
                vals[i, j, m, :len(rv)] = rv
    return ids, vals, lens, subl


def _pad_nested(col, dtype):
    """Sub-sequence field (list of sub-seqs of scalars/vectors) ->
    (data [B,S,T(,D)], lengths [B], sub_lengths [B,S]) — the
    ops/nested_ops.py convention."""
    b = len(col)
    s_max = max(max((len(s) for s in col), default=1), 1)
    t = max(max((len(sub) for s in col for sub in s), default=1), 1)
    first = None
    for s in col:
        for sub in s:
            if len(sub):
                first = np.asarray(sub[0])
                break
        if first is not None:
            break
    tail = first.shape if first is not None and first.ndim else ()
    if dtype is None:
        # allocate in the data's own (canonicalized) width — integer
        # sub-sequences (ids) must not materialize as f32 padded
        # buffers just because no dtype was declared
        dtype = convert_dtype(first.dtype) if first is not None \
            else "float32"
    data = np.zeros((b, s_max, t) + tail, dtype)
    lens = np.zeros((b,), _index_dtype())
    subl = np.zeros((b, s_max), _index_dtype())
    for i, s in enumerate(col):
        lens[i] = len(s)
        for j, sub in enumerate(s):
            subl[i, j] = len(sub)
            if len(sub):
                data[i, j, :len(sub)] = np.asarray(sub, data.dtype)
    return data, lens, subl


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None,
                 seq_buckets=None):
        """feed_list entries:
        * a Variable or name — dense field;
        * (data_var, length_var) tuple — padded sequence field;
        * a dict spec — structured field:
          {"kind": "sparse", "name", "values", "depth",
           "len"?, "sublen"?} or
          {"kind": "nested", "name", "len", "sublen", "dtype"?}."""
        self.feed_specs = []
        for item in feed_list:
            if isinstance(item, dict):
                self.feed_specs.append((item["kind"], item, None))
            elif isinstance(item, tuple):
                self.feed_specs.append(("seq", item[0], item[1]))
            else:
                self.feed_specs.append(("dense", item, None))
        self.seq_buckets = seq_buckets

    def feed(self, batch):
        """batch: list of sample tuples aligned with feed_list order."""
        n_fields = len(self.feed_specs)
        columns = list(zip(*batch))
        if len(columns) != n_fields:
            raise ValueError("sample has %d fields, feeder expects %d"
                             % (len(columns), n_fields))
        out = {}
        for (kind, var, len_var), col in zip(self.feed_specs, columns):
            if kind == "sparse":
                spec = var
                arrs = _pad_sparse(col, spec["depth"])
                out[spec["name"]], out[spec["values"]] = arrs[0], arrs[1]
                if spec.get("len"):
                    out[spec["len"]] = arrs[2]
                if spec.get("sublen"):
                    out[spec["sublen"]] = arrs[3]
                continue
            if kind == "nested":
                spec = var
                data, lens, subl = _pad_nested(col, spec.get("dtype"))
                out[spec["name"]] = data
                out[spec["len"]] = lens
                out[spec["sublen"]] = subl
                continue
            name = var.name if isinstance(var, Variable) else var
            if kind == "seq":
                maxlen = max(len(s) for s in col)
                if self.seq_buckets:
                    maxlen = bucket_batch_by_length(maxlen,
                                                    self.seq_buckets)
                padded, lengths = pad_batch(col, maxlen=maxlen,
                                            dtype=_feed_dtype(var))
                out[name] = padded
                lname = len_var.name if isinstance(len_var, Variable) \
                    else len_var
                out[lname] = lengths
            else:
                arr = np.asarray(col, dtype=_feed_dtype(var))
                if isinstance(var, Variable) and var.shape is not None \
                        and arr.ndim == len(var.shape) - 1:
                    # scalar-per-sample fields get the trailing [*,1] the
                    # reference's feeders add (e.g. int labels)
                    tail = tuple(d for d in var.shape[1:])
                    if all(isinstance(d, int) and d > 0 for d in tail):
                        arr = arr.reshape((-1,) + tail)
                out[name] = arr
        return out
