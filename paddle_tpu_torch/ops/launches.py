"""The kernel wrappers' launch counts taken together.

Each wrapper counts its kernel's launches where it launches it (the CUDA
implementation of its torch op). A CUDA graph replay runs no Python, so
the executor (``core/executor.py``) takes the counts a capture made with
:func:`snapshot` and :func:`since`, takes them back with :func:`add` and
a sign of -1 (a capture launches nothing), and adds them once for each
replay: the counts stay the number of launches the card ran.
"""

import collections

__all__ = ["snapshot", "since", "add"]


def _counted():
    """(wrapper, attribute) of every launch count."""
    from . import conv_bn, flash_attention as fa, quant_ops
    return ((fa.flash_attention, "launches"),
            (fa.flash_attention, "launches_bf16"),
            (fa.flash_attention_tile, "launches"),
            (fa.decode_attention, "launches"),
            (fa.decode_attention_paged, "launches"),
            (quant_ops.quant_matmul_2d, "launches"),
            (conv_bn.conv_bn_stats_1x1, "launches"),
            (conv_bn.conv1x1_bn_relu, "launches"))


def _by_shape():
    from . import quant_ops
    return quant_ops.quant_matmul_2d.launches_by_shape


def snapshot():
    """Every count now, with B3's counts by (m, k, n)."""
    return ({pair: getattr(*pair) for pair in _counted()},
            collections.Counter(_by_shape()))


def since(before):
    """The counts added since the :func:`snapshot` ``before``."""
    counts, shapes = snapshot()
    return ({pair: n - before[0][pair] for pair, n in counts.items()
             if n != before[0][pair]}, shapes - before[1])


def add(delta, sign=1):
    """Add ``delta`` (from :func:`since`) to the counts ``sign`` times."""
    counts, shapes = delta
    for (fn, attr), n in counts.items():
        setattr(fn, attr, getattr(fn, attr) + sign * n)
    by_shape = _by_shape()
    for shape, n in shapes.items():
        by_shape[shape] += sign * n
