"""v2 input-type descriptors (reference ``python/paddle/v2/data_type.py``
re-exporting PyDataProvider2 types, ``python/paddle/trainer/
PyDataProvider2.py:117-245``): each describes one feed slot's
shape/dtype/sequence-ness; the v2 trainer builds the fluid-side data
layout from these.

Realizations (static shapes, SURVEY §5.7):
* sequences -> padded batch + length var;
* sub-sequences (seq_type=2, reference ``PyDataProvider2.py:198,215,
  232``) -> padded [B, S, T] + outer length [B] + sub-lengths [B, S]
  (the nested-ops convention, ops/nested_ops.py);
* sparse_binary_vector -> id-sequence (ids of the set bits);
* sparse_float_vector (reference ``py_paddle/dataprovider_converter.py:
  184`` SparseFloatScanner, ``math/CpuSparseMatrix.h:24``) -> a static
  (ids [B, K], values [B, K]) pair; consumers compute weighted
  row-sums so the [B, dim] dense form is never materialized.

The port's copy of ``paddle_tpu/v2/data_type.py``: it imports nothing of
that package.
"""

__all__ = ["InputType", "dense_vector", "integer_value",
           "dense_vector_sequence", "integer_value_sequence",
           "sparse_binary_vector", "sparse_float_vector",
           "sparse_binary_vector_sequence",
           "sparse_float_vector_sequence",
           "dense_vector_sub_sequence", "integer_value_sub_sequence",
           "sparse_binary_vector_sub_sequence",
           "sparse_float_vector_sub_sequence"]


class InputType:
    def __init__(self, dim, seq_type, dtype, sparse=None):
        self.dim = dim
        # 0 = no sequence, 1 = sequence, 2 = sub-sequence (nested)
        self.seq_type = seq_type
        self.dtype = dtype
        # None | "float" | "binary": sparse rows are ragged id lists
        # (+ parallel values for "float"; all-ones values synthesized
        # for "binary") padded onto a static K axis
        self.sparse = sparse

    @property
    def is_seq(self):
        return self.seq_type != 0

    @property
    def is_nested(self):
        return self.seq_type == 2

    @property
    def is_sparse_float(self):
        return self.sparse == "float"

    @property
    def is_sparse_pair(self):
        """True for the (ids, values)-pair realizations — float rows,
        and binary rows at sequence levels (where the plain id-seq
        encoding of sparse_binary_vector has no free axis left)."""
        return self.sparse in ("float", "binary")


def dense_vector(dim):
    return InputType(dim, 0, "float32")


def integer_value(value_range):
    return InputType(value_range, 0, "int64")


def dense_vector_sequence(dim):
    return InputType(dim, 1, "float32")


def integer_value_sequence(value_range):
    return InputType(value_range, 1, "int64")


def sparse_binary_vector(dim):
    # realized as an id-sequence feed (ids of the set bits)
    return InputType(dim, 1, "int64")


def sparse_float_vector(dim):
    """(ids, values) pair feed — float-weighted sparse features (CTR
    models); samples are [(id, value), ...] or ([ids], [values])."""
    return InputType(dim, 0, "int64", sparse="float")


def sparse_binary_vector_sequence(dim):
    """Sequence of sparse binary rows -> ids [B, T, K] (+ synthesized
    0/1 values) + length [B]."""
    return InputType(dim, 1, "int64", sparse="binary")


def sparse_float_vector_sequence(dim):
    """Sequence of sparse float rows -> (ids, values) [B, T, K] +
    length [B]."""
    return InputType(dim, 1, "int64", sparse="float")


def dense_vector_sub_sequence(dim):
    return InputType(dim, 2, "float32")


def integer_value_sub_sequence(value_range):
    return InputType(value_range, 2, "int64")


def sparse_binary_vector_sub_sequence(dim):
    # sub-sequences of sparse binary rows -> ids [B, S, T, K]
    return InputType(dim, 2, "int64", sparse="binary")


def sparse_float_vector_sub_sequence(dim):
    return InputType(dim, 2, "int64", sparse="float")
