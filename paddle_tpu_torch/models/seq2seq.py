"""The seq2seq NMT with attention (reference
``paddle_tpu/models/seq2seq.py``; BASELINE config 4, the reference's
``test_machine_translation.py`` and the NMT demo), built as a program.

Encoder: an embedding and a projected bidirectional GRU. Decoder: the
attention-GRU ops of ``ops/seq2seq_ops.py``, teacher-forced for
training; generation greedy or by beam search. Every parameter has the
reference's name (``src_embedding``, ``enc_fwd_gru.w``, ``dec_w_in``,
...), so a scope trained by the reference loads here and the training
and generation programs share weights through the scope."""

from .. import layers
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["seq2seq_attention", "Seq2SeqParams"]


def _decoder_params(helper, hid_dim, emb_dim, vocab):
    mk = helper.create_parameter
    w_in = mk(ParamAttr(name="dec_w_in"), shape=[emb_dim + hid_dim,
                                                 3 * hid_dim],
              dtype="float32")
    w_h = mk(ParamAttr(name="dec_w_h"), shape=[hid_dim, 3 * hid_dim],
             dtype="float32")
    bias = mk(ParamAttr(name="dec_bias"), shape=[3 * hid_dim],
              dtype="float32", is_bias=True)
    w_att = mk(ParamAttr(name="dec_w_att"), shape=[hid_dim, hid_dim],
               dtype="float32")
    w_out = mk(ParamAttr(name="dec_w_out"), shape=[hid_dim, vocab],
               dtype="float32")
    b_out = mk(ParamAttr(name="dec_b_out"), shape=[vocab],
               dtype="float32", is_bias=True)
    return w_in, w_h, bias, w_att, w_out, b_out


def seq2seq_attention(src, src_len, trg, trg_len, label, src_vocab,
                      trg_vocab, emb_dim=64, hid_dim=128, mode="train",
                      max_gen_len=32, beam_size=4, bos_id=0, eos_id=1):
    """src/trg: [N,T] int ids; label: [N,T2] int (trg shifted by one).
    mode: 'train' (teacher forcing) | 'greedy' | 'beam'.
    Returns train: (loss, logits); generate: (ids, length)."""
    # every parameter is named so the train and generation Programs share
    # weights through the scope (the reference shares via the same
    # ParamAttr names across train/infer configs)
    src_emb = layers.embedding(src, size=[src_vocab, emb_dim],
                               param_attr="src_embedding")
    fwd_proj = layers.fc(src_emb, 3 * hid_dim, num_flatten_dims=2,
                         param_attr="enc_fwd_proj.w",
                         bias_attr=ParamAttr(name="enc_fwd_proj.b"))
    enc_fwd = layers.dynamic_gru(fwd_proj, hid_dim, length=src_len,
                                 param_attr="enc_fwd_gru.w",
                                 bias_attr=ParamAttr(name="enc_fwd_gru.b"))
    bwd_proj = layers.fc(src_emb, 3 * hid_dim, num_flatten_dims=2,
                         param_attr="enc_bwd_proj.w",
                         bias_attr=ParamAttr(name="enc_bwd_proj.b"))
    enc_bwd = layers.dynamic_gru(bwd_proj, hid_dim, length=src_len,
                                 is_reverse=True,
                                 param_attr="enc_bwd_gru.w",
                                 bias_attr=ParamAttr(name="enc_bwd_gru.b"))
    enc_cat = layers.concat([enc_fwd, enc_bwd], axis=2)
    enc_out = layers.fc(enc_cat, hid_dim, num_flatten_dims=2, act="tanh",
                        param_attr="enc_out.w",
                        bias_attr=ParamAttr(name="enc_out.b"))
    enc_mask = layers.sequence_mask(src_len, maxlen=src.shape[1])
    h0 = layers.sequence_pool(enc_bwd, "first")
    h0 = layers.fc(h0, hid_dim, act="tanh", param_attr="dec_h0.w",
                   bias_attr=ParamAttr(name="dec_h0.b"))

    helper = LayerHelper("seq2seq_decoder")
    w_in, w_h, bias, w_att, w_out, b_out = _decoder_params(
        helper, hid_dim, emb_dim, trg_vocab)

    common_inputs = {
        "EncOut": [enc_out.name], "EncMask": [enc_mask.name],
        "H0": [h0.name], "WIn": [w_in.name], "WH": [w_h.name],
        "Bias": [bias.name], "WAtt": [w_att.name], "WOut": [w_out.name],
        "BOut": [b_out.name]}

    if mode == "train":
        trg_emb = layers.embedding(trg, size=[trg_vocab, emb_dim],
                                   param_attr="trg_embedding")
        logits = helper.create_tmp_variable("float32")
        hidden = helper.create_tmp_variable("float32")
        helper.append_op(
            type="attention_gru_decoder",
            inputs=dict(common_inputs, TrgEmb=[trg_emb.name]),
            outputs={"Logits": [logits.name], "Hidden": [hidden.name]})
        # masked token-level cross entropy
        t2 = trg.shape[1]
        flat_logits = layers.reshape(logits, [-1, trg_vocab])
        flat_label = layers.reshape(label, [-1, 1])
        tok_loss = layers.softmax_with_cross_entropy(flat_logits,
                                                     flat_label)
        tok_loss = layers.reshape(tok_loss, [-1, t2])
        trg_mask = layers.sequence_mask(trg_len, maxlen=t2)
        masked = layers.elementwise_mul(tok_loss, trg_mask)
        total = layers.reduce_sum(masked)
        count = layers.reduce_sum(trg_mask)
        loss = layers.elementwise_div(total, count)
        return loss, logits

    # generation: need the target embedding table
    gen_helper = LayerHelper("seq2seq_gen")
    trg_emb_table = gen_helper.create_parameter(
        ParamAttr(name="trg_embedding"), shape=[trg_vocab, emb_dim],
        dtype="float32")
    ids = gen_helper.create_tmp_variable("int32", stop_gradient=True)
    length = gen_helper.create_tmp_variable("int32", stop_gradient=True)
    inputs = dict(common_inputs, Embedding=[trg_emb_table.name])
    if mode == "greedy":
        gen_helper.append_op(
            type="attention_gru_greedy_decode", inputs=inputs,
            outputs={"Ids": [ids.name], "Length": [length.name]},
            attrs={"max_len": max_gen_len, "bos_id": bos_id,
                   "eos_id": eos_id})
        return ids, length
    elif mode == "beam":
        scores = gen_helper.create_tmp_variable("float32",
                                                stop_gradient=True)
        gen_helper.append_op(
            type="attention_gru_beam_decode", inputs=inputs,
            outputs={"Ids": [ids.name], "Length": [length.name],
                     "Scores": [scores.name]},
            attrs={"max_len": max_gen_len, "beam_size": beam_size,
                   "bos_id": bos_id, "eos_id": eos_id})
        return ids, length
    raise ValueError("unknown mode %r" % mode)
