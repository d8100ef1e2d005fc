"""The stacked-LSTM sentiment classifier (reference
``paddle_tpu/models/lstm_sentiment.py``; BASELINE config 3, the
reference's ``benchmark/paddle/rnn/rnn.py`` IMDB recipe and the book
test's ``stacked_lstm_net``), built as a program: padded [batch, time]
ids and their lengths; each layer a projected ``dynamic_lstm``, the odd
ones reversed; the last fc and LSTM outputs max-pooled over time."""

from .. import layers

__all__ = ["stacked_lstm_net"]


def stacked_lstm_net(data, length, label, dict_dim, emb_dim=128,
                     hid_dim=512, stacked_num=3, class_dim=2):
    """data: [N, T] int ids; length: [N] int; label: [N,1] int."""
    emb = layers.embedding(data, size=[dict_dim, emb_dim])
    fc1 = layers.fc(emb, hid_dim * 4, num_flatten_dims=2)
    lstm1, _ = layers.dynamic_lstm(fc1, hid_dim, length=length)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(inputs, hid_dim * 4, num_flatten_dims=2)
        lstm, _ = layers.dynamic_lstm(fc, hid_dim, length=length,
                                      is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(inputs[0], "max", length=length)
    lstm_last = layers.sequence_pool(inputs[1], "max", length=length)
    logits = layers.fc([fc_last, lstm_last], class_dim)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return loss, acc, logits
