"""v2 pooling descriptors (reference ``python/paddle/v2/pooling.py``).

The port's copy of ``paddle_tpu/v2/pooling.py``: it imports nothing of
that package.
"""

__all__ = ["Max", "Avg", "Sum"]


class _Pool:
    name = None


class Max(_Pool):
    name = "max"


class Avg(_Pool):
    name = "average"


class Sum(_Pool):
    name = "sum"
