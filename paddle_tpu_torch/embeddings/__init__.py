"""Sharded embedding tables: row-sharded storage and the two-hop
``all_to_all`` lookup and gradient exchange (``sharded.py``), and the
shard-layout-aware checkpoint reshard (``checkpoint.py``); reference
``paddle_tpu/embeddings``. Importing it registers the
``lookup_table_dist`` / ``lookup_table_dist_grad`` ops."""

from .sharded import (  # noqa: F401
    PAD_MULTIPLE, padded_vocab, to_shard_major, to_logical,
    register_table, dist_tables, active_shards, a2a_step_bytes)
from .checkpoint import (  # noqa: F401
    layout_meta, reshard_scope, reshard_array)

__all__ = ["PAD_MULTIPLE", "padded_vocab", "to_shard_major",
           "to_logical", "register_table", "dist_tables",
           "active_shards", "a2a_step_bytes", "layout_meta",
           "reshard_scope", "reshard_array"]
