"""Checkpoint layout metadata and reshard of distributed embedding
tables (reference ``paddle_tpu/embeddings/checkpoint.py``).

A distributed table is stored in the mod-interleaved layout of the
shard count its strategy used. The padded vocab does not depend on the
shard count (``PAD_MULTIPLE``), so a reshard across a resize is a pure
row PERMUTATION: the array's shape and the program survive.

* save: pass :func:`layout_meta` as ``extra_meta`` to
  ``io.save_checkpoint``; ``latest.json`` then carries each table's (and
  each registered optimizer slot's) shard count.
* restore: after ``io.load_checkpoint`` (global arrays in the scope),
  :func:`reshard_scope` with the saved layout and the NEW strategy
  permutes every table whose shard count changed, old -> logical -> new,
  optimizer slots included, row-exactly.
"""

import numpy as np
import torch

from .sharded import active_shards, to_logical, to_shard_major

__all__ = ["layout_meta", "reshard_scope", "reshard_array"]

META_KEY = "embedding_layout"


def layout_meta(program, strategy=None):
    """``extra_meta`` for ``io.save_checkpoint``: the shard layout every
    registered distributed table (and optimizer slot) is stored in under
    ``strategy``."""
    tables = getattr(program, "_dist_embeddings", None) or {}
    out = {}
    for name, info in tables.items():
        n, _, _ = active_shards(strategy, info["padded"])
        out[name] = {"num_shards": int(n), "vocab": int(info["vocab"]),
                     "padded": int(info["padded"]),
                     "dim": int(info["dim"]),
                     "slot_of": info.get("slot_of")}
    return {META_KEY: out}


def reshard_array(arr, old_shards, new_shards):
    """Re-permute one shard-major array across a shard-count change."""
    old_n, new_n = int(old_shards), int(new_shards)
    if old_n == new_n:
        return np.asarray(arr)
    return to_shard_major(to_logical(arr, old_n), new_n)


def reshard_scope(scope, layout, strategy=None):
    """Re-key every restored table in ``scope`` from its saved shard
    count (``layout``: the ``embedding_layout`` entry of
    ``io.load_checkpoint_meta``, or the whole meta) to the count
    ``strategy`` implies. Row-shaped optimizer slots ride along; [1]
    accumulators were never registered and pass through. Returns the
    number of re-permuted arrays."""
    if layout and META_KEY in layout:
        layout = layout[META_KEY]
    moved = 0
    for name, info in (layout or {}).items():
        if not scope.has_var(name):
            continue
        old_n = int(info.get("num_shards", 1))
        new_n, _, _ = active_shards(strategy, int(info["padded"]))
        if old_n == new_n:
            continue
        val = scope.find_var(name)
        device = val.device if isinstance(val, torch.Tensor) else None
        arr = val.detach().cpu().numpy() if device is not None \
            else np.asarray(val)
        if arr.ndim < 1 or arr.shape[0] != int(info["padded"]):
            continue  # defensive: registry drift / a foreign var
        out = reshard_array(arr, old_n, new_n)
        scope.set_var(name, torch.from_numpy(out).to(device)
                      if device is not None else out)
        moved += 1
    return moved
