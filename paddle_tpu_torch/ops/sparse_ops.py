"""SelectedRows-style sparse gradients of embedding tables (reference
``paddle_tpu/ops/sparse_ops.py``).

A sparse gradient is (Rows [nnz] int32, Values [nnz, D]): nnz is the
number of looked-up ids, duplicates included, never a dense [V, D]
gradient. ``lookup_table_sparse_grad`` makes it from the lookup's output
gradient; the sgd, momentum, adagrad and adam ops apply it row by row
(``ops/optimizer_ops.py``) after :func:`merge_duplicate_rows`, dropping
the rows out of range (the padding id, the merge's padding). The merge
sums each row's values in their order of arrival, one segment at a time
(``torch.segment_reduce``), so its result does not depend on a scatter's
order on the card; every row is then written once.
"""

import torch

from ..core.registry import register_op

__all__ = ["merge_duplicate_rows"]


def merge_duplicate_rows(rows, vals, vocab_size):
    """Sort-based duplicate-row merge with static shapes (the reference's
    ``selected_rows_functor::MergeAdd`` analog). Returns (merged_rows
    int32, merged_vals) of the SAME length: slot k holds the k-th
    distinct row (ascending) and its summed values; the slots past the
    last distinct row get row ``vocab_size`` (out of range, dropped by
    the update) and zeros. An empty batch comes back as it is; an
    all-duplicate one compacts into slot 0."""
    if rows.shape[0] == 0:
        return rows.to(torch.int32), vals
    order = torch.argsort(rows, stable=True)
    r = rows[order]
    v = vals[order]
    uniq, counts = torch.unique_consecutive(r, return_counts=True)
    k = uniq.shape[0]
    merged_vals = torch.zeros_like(vals)
    merged_vals[:k] = torch.segment_reduce(v, "sum", lengths=counts,
                                           axis=0)
    merged_rows = torch.full_like(r, vocab_size)
    merged_rows[:k] = uniq
    return merged_rows.to(torch.int32), merged_vals


@register_op("lookup_table_sparse_grad")
def _lookup_table_sparse_grad(ctx):
    """d(lookup_table)/dW as (Rows, Values) in place of a dense scatter
    into [V, D]; padding_idx rows are pushed out of range (their forward
    output was zeroed, so their gradient is discarded)."""
    og = ctx.input("OutGrad")
    ids = ctx.input("Ids")
    vocab = ctx.attr("vocab_size")
    rows = ids.reshape(-1).to(torch.int32)
    vals = og.reshape(-1, og.shape[-1])
    pad = ctx.attr("padding_idx")
    if pad is not None:
        rows = torch.where(rows == pad, torch.full_like(rows, vocab), rows)
    return {"Rows": rows, "Values": vals}
