"""Datasets with the reference's reader-creator API (SURVEY A.6:
``python/paddle/v2/dataset/``: mnist, cifar, imdb, imikolov, movielens,
conll05, uci_housing, wmt14, sentiment, mq2007). The policy of
common.py: real files if present, deterministic synthetic surrogates
otherwise — same shapes, dtypes, vocab sizes, and iteration contract.

The port's copy of ``paddle_tpu/dataset/__init__.py``: it imports
nothing of that package, and gives the same results.
"""

from . import common  # noqa: F401
from . import mnist, cifar, uci_housing, imdb, imikolov, movielens  # noqa
from . import wmt14, mq2007  # noqa: F401
from . import conll05, flowers, voc2012, sentiment  # noqa: F401
