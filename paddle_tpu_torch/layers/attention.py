"""Transformer layers (reference ``paddle_tpu/layers/attention.py``), in
two forms.

Program forms, which append ops to the current program as the
reference's do, with its parameter names (``mha_N.qkv_{q,k,v}.w``,
``mha_N.o.w``, ``enc_N.ffn{1,2}.{w,b}``, the layer norms' and the
position table's unique names): :func:`multi_head_attention`,
:func:`multi_head_attention_cached` (the KV-cached attention of the
generation programs: the ``kv_cache_*`` ops and the decode and prefill
attentions of ``ops/generation_ops.py``, dense and paged),
:func:`transformer_encoder_layer` (``cache=`` takes the cached one),
:func:`positional_encoding` and :func:`positional_encoding_window`.

``nn.Module`` forms, for the ``multi_head_attention``,
``multi_head_attention_cached`` dense and paged branches,
``transformer_encoder_layer``, ``positional_encoding`` and
``positional_encoding_window`` computations. One module holds one set of
parameters for the uncached (training) attention and the cached
(serving) ones, as the reference's layers share parameter names, so
trained weights serve unchanged. Weights keep the reference's [in, out]
layout; the models' loaders map the reference's parameter names onto
these modules. A weight consumed only by ``mul`` (the projections and
the FFN) may be int8, armed for int8 compute: its f32 [out] scales are
the buffer ``<weight>_scale`` beside it, None while it is float32.
``amp`` (a dtype, or None) is the mixed-precision dtype of the ``mul``
products (``amp.py``): an argument of each call, never stored, so a
model follows the flag as its caller reads it."""

import torch
from torch import nn

from ..core import unique_name
from ..initializer import NormalInitializer
from ..layer_helper import LayerHelper
from ..ops.attention_ops import multihead_attention
from ..ops.generation_ops import (kv_cache_append, kv_cache_write_rows,
                                  kv_cache_write_slot,
                                  multihead_attention_decode,
                                  multihead_attention_decode_paged,
                                  multihead_attention_prefill_paged,
                                  multihead_attention_verify_paged)
from ..ops.nn_ops import fc, gather, gelu, layer_norm, mul
from . import nn as _nn

__all__ = ["multi_head_attention", "multi_head_attention_cached",
           "transformer_encoder_layer", "positional_encoding",
           "positional_encoding_window", "MultiHeadAttention",
           "TransformerEncoderLayer", "PositionalEncodingWindow"]

def multi_head_attention(queries, keys, values, d_model, num_heads,
                         causal=False, key_length=None, ring_axis=None,
                         param_attr=None, name=None, **kwargs):
    """Full MHA with input/output projections (program form).
    queries/keys/values: [B, T, D]; ``key_length`` [B] masks padded
    keys. ``ring_axis`` names a mesh axis that the op splits T over
    under a strategy (ring attention)."""
    helper = LayerHelper("multi_head_attention", name=name, **kwargs)
    prefix = name or unique_name.generate("mha")

    def attr(suffix):
        return param_attr if param_attr is not None else \
            "%s.%s.w" % (prefix, suffix)
    q = _nn.fc(queries, d_model, num_flatten_dims=2, bias_attr=False,
               param_attr=attr("qkv_q"), **kwargs)
    k = _nn.fc(keys, d_model, num_flatten_dims=2, bias_attr=False,
               param_attr=attr("qkv_k"), **kwargs)
    v = _nn.fc(values, d_model, num_flatten_dims=2, bias_attr=False,
               param_attr=attr("qkv_v"), **kwargs)
    inputs = {"Q": [q.name], "K": [k.name], "V": [v.name]}
    if key_length is not None:
        inputs["KeyLength"] = [key_length.name]
    ctx_out = helper.create_tmp_variable(queries.dtype)
    helper.append_op(type="multihead_attention", inputs=inputs,
                     outputs={"Out": [ctx_out.name]},
                     attrs={"num_heads": num_heads, "causal": causal,
                            "ring_axis": ring_axis})
    return _nn.fc(ctx_out, d_model, num_flatten_dims=2, bias_attr=False,
                  param_attr=attr("o"), **kwargs)


def _cache_op(helper, op_type, cvar, **inputs):
    """A cache write: ``Out`` names the cache variable ``cvar``, so the
    executor writes it in place (the reference's donated state)."""
    slots = {"Cache": [cvar.name]}
    slots.update({k: [v.name] for k, v in inputs.items()})
    helper.append_op(type=op_type, inputs=slots,
                     outputs={"Out": [cvar.name]})


def multi_head_attention_cached(x, cache, d_model, num_heads,
                                key_length=None, param_attr=None,
                                name=None, **kwargs):
    """KV-cached MHA (program form): the projections and parameter names
    of :func:`multi_head_attention`, with K/V written into persistable
    per-layer cache variables (``cache["k"]``, ``cache["v"]``) and read
    back from them. ``cache["mode"]``:

    * ``"prefill"`` — x is one prompt [1, P, D]: its K/V rows go into
      slot ``cache["slot"]`` at positions [0, P), and the attention is
      causal within the prompt (``key_length`` masks right-padding).
    * ``"decode"`` — x is one token per slot [S, 1, D]: K/V rows go to
      per-slot positions ``cache["pos"]`` and each query attends its
      slot's rows [0, pos].

    With ``cache["layout"] == "paged"`` the caches are block pools
    addressed through ``cache["table"]``: prefill is a suffix-window
    prefill at cached depth ``cache["hist"]`` (the window attends the
    cached prefix and itself causally), decode gathers each slot's
    rows through its table row."""
    helper = LayerHelper("multi_head_attention", name=name, **kwargs)
    prefix = name or unique_name.generate("mha")

    def attr(suffix):
        return param_attr if param_attr is not None else \
            "%s.%s.w" % (prefix, suffix)
    q = _nn.fc(x, d_model, num_flatten_dims=2, bias_attr=False,
               param_attr=attr("qkv_q"), **kwargs)
    k = _nn.fc(x, d_model, num_flatten_dims=2, bias_attr=False,
               param_attr=attr("qkv_k"), **kwargs)
    v = _nn.fc(x, d_model, num_flatten_dims=2, bias_attr=False,
               param_attr=attr("qkv_v"), **kwargs)
    ck, cv = cache["k"], cache["v"]
    ctx_out = helper.create_tmp_variable(x.dtype)
    mode = cache["mode"]
    if mode not in ("prefill", "decode"):
        raise ValueError("cache mode must be 'prefill' or 'decode', "
                         "got %r" % (mode,))
    attn = {"Q": [q.name], "CacheK": [ck.name], "CacheV": [cv.name]}
    if cache.get("layout") == "paged":
        table = cache["table"]
        if mode == "prefill":
            hist = cache["hist"]
            for cvar, proj in ((ck, k), (cv, v)):
                _cache_op(helper, "kv_cache_write_paged", cvar, New=proj,
                          Table=table, Hist=hist, Len=key_length)
            op_type = "multihead_attention_prefill_paged"
            attn.update(Table=[table.name], Hist=[hist.name],
                        Len=[key_length.name])
        else:
            pos = cache["pos"]
            for cvar, proj in ((ck, k), (cv, v)):
                _cache_op(helper, "kv_cache_append_paged", cvar, New=proj,
                          Pos=pos, Table=table)
            op_type = "multihead_attention_decode_paged"
            attn.update(Pos=[pos.name], Table=[table.name])
        helper.append_op(type=op_type, inputs=attn,
                         outputs={"Out": [ctx_out.name]},
                         attrs={"num_heads": num_heads})
    elif mode == "prefill":
        for cvar, proj in ((ck, k), (cv, v)):
            _cache_op(helper, "kv_cache_write_slot", cvar, New=proj,
                      Slot=cache["slot"])
        inputs = {"Q": [q.name], "K": [k.name], "V": [v.name]}
        if key_length is not None:
            inputs["KeyLength"] = [key_length.name]
        helper.append_op(type="multihead_attention", inputs=inputs,
                         outputs={"Out": [ctx_out.name]},
                         attrs={"num_heads": num_heads, "causal": True,
                                "ring_axis": None})
    else:
        pos = cache["pos"]
        for cvar, proj in ((ck, k), (cv, v)):
            _cache_op(helper, "kv_cache_append", cvar, New=proj, Pos=pos)
        attn["Pos"] = [pos.name]
        helper.append_op(type="multihead_attention_decode", inputs=attn,
                         outputs={"Out": [ctx_out.name]},
                         attrs={"num_heads": num_heads})
    return _nn.fc(ctx_out, d_model, num_flatten_dims=2, bias_attr=False,
                  param_attr=attr("o"), **kwargs)


def transformer_encoder_layer(x, d_model, num_heads, d_ff, causal=False,
                              key_length=None, ring_axis=None,
                              dropout_prob=0.0, is_test=False, name=None,
                              cache=None, **kwargs):
    """Pre-norm transformer block (program form): x + MHA(LN(x)); x +
    FFN(LN(x)), FFN = fc + gelu, fc; dropout after the attention and
    after the FFN when ``dropout_prob``. ``cache`` (see
    :func:`multi_head_attention_cached`) takes the KV-cached attention;
    every parameter name is unchanged."""
    ln1 = _nn.layer_norm(x, begin_norm_axis=2, **kwargs)
    if cache is not None:
        if ring_axis:
            raise ValueError(
                "cache= is incompatible with ring_axis (the cached "
                "decode path is single-mesh; ring attention shards "
                "the sequence dim the cache keeps local)")
        if not causal:
            raise ValueError("cached attention is causal-only")
        att = multi_head_attention_cached(ln1, cache, d_model, num_heads,
                                          key_length=key_length, **kwargs)
    else:
        att = multi_head_attention(ln1, ln1, ln1, d_model, num_heads,
                                   causal=causal, key_length=key_length,
                                   ring_axis=ring_axis, **kwargs)
    if dropout_prob:
        att = _nn.dropout(att, dropout_prob, is_test=is_test, **kwargs)
    x = _nn.elementwise_add(x, att, **kwargs)
    ln2 = _nn.layer_norm(x, begin_norm_axis=2, **kwargs)
    prefix = name or unique_name.generate("enc")
    ff = _nn.fc(ln2, d_ff, num_flatten_dims=2, act="gelu",
                param_attr="%s.ffn1.w" % prefix,
                bias_attr="%s.ffn1.b" % prefix, **kwargs)
    ff = _nn.fc(ff, d_model, num_flatten_dims=2,
                param_attr="%s.ffn2.w" % prefix,
                bias_attr="%s.ffn2.b" % prefix, **kwargs)
    if dropout_prob:
        ff = _nn.dropout(ff, dropout_prob, is_test=is_test, **kwargs)
    return _nn.elementwise_add(x, ff, **kwargs)


def positional_encoding(x, max_len=None, name=None, **kwargs):
    """Learned positional embedding added to [B, T, D] input (program
    form): a [T, D] table initialized normal(0, 0.02)."""
    helper = LayerHelper("pos_encoding", name=name, **kwargs)
    t, d = x.shape[1], x.shape[2]
    pos = helper.create_parameter(
        None, shape=[t, d], dtype=x.dtype,
        default_initializer=NormalInitializer(0.0, 0.02))
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="elementwise_add",
                     inputs={"X": [x.name], "Y": [pos.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": 1})
    return out


def positional_encoding_window(x, max_len, pos=None, window_rows=False,
                               name=None, **kwargs):
    """A window of the learned [max_len, D] position table of
    :func:`positional_encoding` (the same parameter name under the same
    ``unique_name`` sequence), added to x (program form): rows [0, P) to
    a prompt [1, P, D] (``pos=None``); row pos[s] to each slot's token
    [S, 1, D]; or, with ``window_rows`` (the paged suffix prefill), row
    pos[i] to window row i of x [1, P, D]."""
    helper = LayerHelper("pos_encoding", name=name, **kwargs)
    d = x.shape[2]
    table = helper.create_parameter(
        None, shape=[max_len, d], dtype=x.dtype,
        default_initializer=NormalInitializer(0.0, 0.02))
    out = helper.create_tmp_variable(x.dtype)
    if pos is None:
        t = x.shape[1]
        if t > max_len:
            raise ValueError("prefill window %d exceeds the position "
                             "table length %d" % (t, max_len))
        win = helper.create_tmp_variable(x.dtype)
        helper.append_op(type="slice", inputs={"Input": [table.name]},
                         outputs={"Out": [win.name]},
                         attrs={"axes": [0], "starts": [0], "ends": [t]})
        helper.append_op(type="elementwise_add",
                         inputs={"X": [x.name], "Y": [win.name]},
                         outputs={"Out": [out.name]}, attrs={"axis": 1})
    else:
        rows = helper.create_tmp_variable(x.dtype)
        helper.append_op(type="gather",
                         inputs={"X": [table.name], "Index": [pos.name]},
                         outputs={"Out": [rows.name]})
        rows3 = helper.create_tmp_variable(x.dtype)
        helper.append_op(type="reshape", inputs={"X": [rows.name]},
                         outputs={"Out": [rows3.name]},
                         attrs={"shape": [1, -1, d] if window_rows
                                else [-1, 1, d]})
        helper.append_op(type="elementwise_add",
                         inputs={"X": [x.name], "Y": [rows3.name]},
                         outputs={"Out": [out.name]}, attrs={})
    return out


def _weight(*shape, device):
    return nn.Parameter(torch.zeros(*shape, device=device),
                        requires_grad=False)


def _scales(module, *weights):
    """Register the (empty) scale buffer of each mul weight."""
    for name in weights:
        module.register_buffer(name + "_scale", None)


class MultiHeadAttention(nn.Module):
    """q/k/v/o projections around multi-head attention.

    * ``full`` — uncached self-attention over x [B, T, D] (the training
      path; reference ``multi_head_attention`` with queries, keys and
      values all x), ``key_length`` [B] masking each row's padding, its
      products under ``amp`` (a dtype or None) when given.

    The cached modes route K/V through one layer's [slots, cache_len,
    d_model] cache tensors:

    * ``prefill`` — x is one prompt [1, P, D]: its K/V rows are written
      into cache slot ``slot`` at positions [0, P) and attention runs
      causally within the prompt (``key_length`` masks right-padding).
    * ``decode`` — x is one token per slot [S, 1, D]: K/V rows are
      written at per-slot positions ``pos`` and each query attends its
      slot's cache rows [0, pos], its own row included.

    The paged layout (``cache_k``/``cache_v`` are one layer's
    [NB + 1, BS, D] pool storages, ``ops/generation_ops.py``):

    * ``prefill_paged`` — x is a prompt window [1, P, D] whose first
      row sits at logical position ``hist`` (the rows before it are a
      cached prefix, shared blocks); its K/V rows are written at the
      storage ``rows`` (``ops.generation_ops.paged_window_rows``) and
      each attends the prefix and the window causally through the block
      ``table``.
    * ``decode_paged`` — as ``decode``, through per-slot table rows
      ``table`` [S, MB], writing at the storage ``rows``
      (``paged_append_rows``).
    * ``verify_paged`` — a speculative window [1, W, D] at logical
      position ``hist``, written as ``prefill_paged`` writes, each row i
      attending rows [0, hist + i] through ``table`` [MB] as the decode
      step at that position would: W queries of the paged decode
      attention (kernel B5), so a row's arithmetic is the decode
      step's."""

    def __init__(self, d_model, num_heads, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.wq = _weight(d_model, d_model, device=device)
        self.wk = _weight(d_model, d_model, device=device)
        self.wv = _weight(d_model, d_model, device=device)
        self.wo = _weight(d_model, d_model, device=device)
        _scales(self, "wq", "wk", "wv", "wo")

    def _qkv(self, x, amp=None):
        return (mul(x, self.wq, self.wq_scale, amp),
                mul(x, self.wk, self.wk_scale, amp),
                mul(x, self.wv, self.wv_scale, amp))

    def _out(self, ctx, amp=None):
        return mul(ctx, self.wo, self.wo_scale, amp)

    def full(self, x, causal=False, key_length=None, amp=None,
             ring_axis=None):
        q, k, v = self._qkv(x, amp)
        return self._out(multihead_attention(q, k, v, self.num_heads,
                                             causal=causal,
                                             key_length=key_length,
                                             ring_axis=ring_axis), amp)

    def prefill(self, x, cache_k, cache_v, slot, key_length):
        q, k, v = self._qkv(x)
        kv_cache_write_slot(cache_k, k, slot)
        kv_cache_write_slot(cache_v, v, slot)
        ctx = multihead_attention(q, k, v, self.num_heads, causal=True,
                                  key_length=key_length)
        return self._out(ctx)

    def decode(self, x, cache_k, cache_v, pos):
        q, k, v = self._qkv(x)
        kv_cache_append(cache_k, k, pos)
        kv_cache_append(cache_v, v, pos)
        ctx = multihead_attention_decode(q, cache_k, cache_v, pos,
                                         self.num_heads)
        return self._out(ctx)

    def prefill_paged(self, x, cache_k, cache_v, table, hist, rows):
        q, k, v = self._qkv(x)
        kv_cache_write_rows(cache_k, k[0], rows)
        kv_cache_write_rows(cache_v, v[0], rows)
        ctx = multihead_attention_prefill_paged(q, cache_k, cache_v, table,
                                                hist, self.num_heads)
        return self._out(ctx)

    def verify_paged(self, x, cache_k, cache_v, table, hist, rows):
        q, k, v = self._qkv(x)
        kv_cache_write_rows(cache_k, k[0], rows)
        kv_cache_write_rows(cache_v, v[0], rows)
        return self._out(multihead_attention_verify_paged(
            q, cache_k, cache_v, table, hist, self.num_heads))

    def decode_paged(self, x, cache_k, cache_v, pos, table, rows):
        q, k, v = self._qkv(x)
        kv_cache_write_rows(cache_k, k[:, 0], rows)
        kv_cache_write_rows(cache_v, v[:, 0], rows)
        ctx = multihead_attention_decode_paged(q, cache_k, cache_v, pos,
                                               table, self.num_heads)
        return self._out(ctx)


_MODES = ("full", "prefill", "decode", "prefill_paged", "decode_paged",
          "verify_paged")


class TransformerEncoderLayer(nn.Module):
    """Pre-norm block: x + MHA(LN(x)); x + FFN(LN(x)), FFN = fc + gelu,
    fc. ``mode`` names the attention's method (full, the uncached
    training path, or a cached one: prefill, decode, prefill_paged,
    decode_paged, verify_paged) and ``index`` its keyword arguments;
    ``full`` takes no caches. ``amp`` (a dtype or None) is the
    mixed-precision dtype of this call's ``mul`` products; the cached
    modes run without it.

    ``dropout_prob`` > 0 raises NotImplementedError here: dropout runs
    on the program route, where each mask comes from its op's key.
    ``ring_axis`` names a mesh axis of the current strategy
    (``parallel.set_current_strategy``) that the full mode's attention
    splits T over (ring attention); without one it runs as usual."""

    def __init__(self, d_model, num_heads, d_ff, device=None,
                 dropout_prob=0.0, ring_axis=None):
        super().__init__()
        if dropout_prob:
            raise NotImplementedError(
                "dropout_prob > 0 runs on the program route, not on this "
                "nn.Module: each dropout op draws its mask from the key "
                "that the executor's per-op key split takes from the "
                "scope's @RNG_STATE@, which a module has none of; build "
                "the program with models.transformer.transformer_lm given "
                "Variables and run it with core.Executor")
        self.ring_axis = ring_axis
        self.ln1_w = _weight(d_model, device=device)
        self.ln1_b = _weight(d_model, device=device)
        self.attn = MultiHeadAttention(d_model, num_heads, device)
        self.ln2_w = _weight(d_model, device=device)
        self.ln2_b = _weight(d_model, device=device)
        self.ffn1_w = _weight(d_model, d_ff, device=device)
        self.ffn1_b = _weight(d_ff, device=device)
        self.ffn2_w = _weight(d_ff, d_model, device=device)
        self.ffn2_b = _weight(d_model, device=device)
        _scales(self, "ffn1_w", "ffn2_w")

    def forward(self, x, cache_k=None, cache_v=None, mode="full", amp=None,
                **index):
        if mode not in _MODES:
            raise ValueError("mode must be one of %s, got %r"
                             % (_MODES, mode))
        h = layer_norm(x, self.ln1_w, self.ln1_b)
        if mode == "full":
            x = x + self.attn.full(h, amp=amp, ring_axis=self.ring_axis,
                                   **index)
        else:
            x = x + getattr(self.attn, mode)(h, cache_k, cache_v, **index)
        h = layer_norm(x, self.ln2_w, self.ln2_b)
        ff = fc(h, self.ffn1_w, self.ffn1_b, act=gelu,
                w_scale=self.ffn1_w_scale, amp=amp)
        return x + fc(ff, self.ffn2_w, self.ffn2_b,
                      w_scale=self.ffn2_w_scale, amp=amp)


class PositionalEncodingWindow(nn.Module):
    """A window of the learned [max_len, D] position table: rows
    [0, P) added to a prompt [1, P, D] or a training batch [B, P, D]
    (``pos=None``; reference ``positional_encoding`` when P = max_len),
    row pos[s]
    added to each slot's token [S, 1, D], or, with ``window_rows``
    (the paged suffix prefill), row pos[i] added to window row i of
    x [1, P, D]."""

    def __init__(self, max_len, d_model, device=None):
        super().__init__()
        self.max_len = max_len
        self.table = _weight(max_len, d_model, device=device)

    def forward(self, x, pos=None, window_rows=False):
        if pos is None:
            t = x.shape[1]
            if t > self.max_len:
                raise ValueError("prefill window %d exceeds the position "
                                 "table length %d" % (t, self.max_len))
            return x + self.table[:t]
        rows = gather(self.table, pos.to(device=x.device, dtype=torch.long))
        shape = (1, -1, x.shape[2]) if window_rows else (-1, 1, x.shape[2])
        return x + rows.reshape(shape)
