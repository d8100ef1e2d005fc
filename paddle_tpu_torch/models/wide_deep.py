"""Wide&Deep CTR model (reference ``paddle_tpu/models/wide_deep.py``;
BASELINE config 5, the sparse workload). Two table regimes:

* ``is_sparse=True``: (rows, values) gradients and row-wise updates;
  :func:`vocab_shard_rules` shards both tables' vocab over a mesh axis.
* ``is_distributed=True``: distributed tables (``embeddings/sharded.py``)
  row-sharded over the data axis and exchanged by the two-hop
  ``all_to_all``; they place themselves, no rules needed.
"""

from .. import layers

__all__ = ["wide_deep", "vocab_shard_rules"]


def wide_deep(sparse_ids, dense_feats, label, vocab_size, num_slots,
              emb_dim=16, hidden=(64, 32), is_sparse=True,
              is_distributed=False):
    """sparse_ids: [N, num_slots] int (one id a slot); dense_feats: [N, D]
    float; label: [N, 1] float (click). Returns (loss, pred, logit)."""
    # deep: one embedding table shared by every slot
    emb = layers.embedding(sparse_ids, size=[vocab_size, emb_dim],
                           param_attr="deep_embedding",
                           is_sparse=is_sparse,
                           is_distributed=is_distributed)
    deep = layers.reshape(emb, [-1, num_slots * emb_dim])
    deep = layers.concat([deep, dense_feats], axis=1)
    for h in hidden:
        deep = layers.fc(deep, h, act="relu")
    deep_logit = layers.fc(deep, 1)

    # wide: a linear model over one-hot ids (a [vocab, 1] table summed
    # over the slots) and a dense fc
    wide_emb = layers.embedding(sparse_ids, size=[vocab_size, 1],
                                param_attr="wide_embedding",
                                is_sparse=is_sparse,
                                is_distributed=is_distributed)
    wide_sum = layers.reduce_sum(wide_emb, dim=1)
    wide_dense = layers.fc(dense_feats, 1, bias_attr=False)
    logit = layers.elementwise_add(
        layers.elementwise_add(deep_logit, wide_sum), wide_dense)
    loss = layers.mean(
        layers.sigmoid_cross_entropy_with_logits(logit, label))
    pred = layers.sigmoid(logit)
    return loss, pred, logit


def vocab_shard_rules(axis="model"):
    """``DistStrategy`` param rules sharding both tables (and their
    optimizer accumulators, which extend the parameter's name) on the
    vocab dim."""
    from ..parallel import P
    return [(r"(deep|wide)_embedding", P(axis, None))]
