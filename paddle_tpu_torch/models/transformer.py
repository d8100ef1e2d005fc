"""The causal transformer LM (reference ``paddle_tpu/models/transformer.py``):
its training forward (``_lm_backbone`` without a cache and
``transformer_lm``'s loss), uncached generation by beam search or
sampling over the whole history (``transformer_lm_generate``) and
KV-cached generation (the dense and paged
branches of ``transformer_lm_session``, with its decode policies:
sampling, speculative decoding with a draft, constrained output).

:func:`transformer_lm` takes two forms: given program Variables it
builds the reference's program (the front end's ops, the reference's
parameter names, ``dropout_prob`` and ``length`` included), which
``core.Executor`` runs; given a :class:`TransformerLM` it computes the
same loss on the ``nn.Module`` route.

Parameters carry the reference's names at the boundary
(:func:`lm_param_names`), so weights saved by ``paddle_tpu`` load here
through ``io.params_from_jax``, float32 or already armed for int8
compute (the int8 form of each weight of :func:`lm_mul_weight_names`
with its scales under ``<name>@quant.scale``)."""

import functools
import itertools
import math
import re

import torch
from torch import nn

from .. import config as _config
from .. import layers as _layers
from ..amp import flag_dtype
from ..core import unique_name
from ..core.framework import Program, Variable, program_guard
from ..layers.attention import (PositionalEncodingWindow,
                                TransformerEncoderLayer,
                                positional_encoding,
                                positional_encoding_window,
                                transformer_encoder_layer)
from ..ops.decoding_ops import sample_from_keys
from ..ops.generation_ops import (VERIFY_TAG, kv_block_copy,
                                  paged_append_rows, paged_window_rows)
from ..ops.loss_ops import mean, softmax_with_cross_entropy
from ..ops.nn_ops import argmax, layer_norm, lookup_table, mul
from ..ops.quant_ops import SCALE_SUFFIX, scale_var_name
from ..place import resolve_device

__all__ = ["TransformerLM", "transformer_lm", "transformer_tp_rules",
           "lm_param_names",
           "lm_mul_weight_names", "check_lm_params", "infer_num_layers",
           "kv_dtype", "policy_epilogue", "transformer_lm_generate",
           "transformer_lm_session"]


def _name_map(num_layers):
    """Reference parameter name -> this module's parameter path, in the
    order the reference creates them under ``unique_name.guard()``."""
    names = {"tok_embedding": "tok_embedding",
             "pos_encoding_0.w_0": "pos.table"}
    for i in range(num_layers):
        lay = "layers.%d." % i
        names.update({
            "layer_norm_%d.w_0" % (2 * i): lay + "ln1_w",
            "layer_norm_%d.w_1" % (2 * i): lay + "ln1_b",
            "mha_%d.qkv_q.w" % i: lay + "attn.wq",
            "mha_%d.qkv_k.w" % i: lay + "attn.wk",
            "mha_%d.qkv_v.w" % i: lay + "attn.wv",
            "mha_%d.o.w" % i: lay + "attn.wo",
            "layer_norm_%d.w_0" % (2 * i + 1): lay + "ln2_w",
            "layer_norm_%d.w_1" % (2 * i + 1): lay + "ln2_b",
            "enc_%d.ffn1.w" % i: lay + "ffn1_w",
            "enc_%d.ffn1.b" % i: lay + "ffn1_b",
            "enc_%d.ffn2.w" % i: lay + "ffn2_w",
            "enc_%d.ffn2.b" % i: lay + "ffn2_b",
        })
    names["layer_norm_%d.w_0" % (2 * num_layers)] = "ln_f_w"
    names["layer_norm_%d.w_1" % (2 * num_layers)] = "ln_f_b"
    names["lm_head.w"] = "lm_head"
    return names


def lm_param_names(num_layers):
    """The reference's parameter names of a ``num_layers`` LM."""
    return list(_name_map(num_layers))


def lm_mul_weight_names(num_layers):
    """Sorted reference names of the 2-D [in, out] weights the LM
    consumes only through ``mul``, with the output channel on axis 1:
    the q/k/v/o projections, the two FFN weights and the LM head. They
    are the weights the reference's ``select_compute_vars`` arms for
    int8 compute; the embedding (a ``lookup_table``), the position
    table, the layer norms and the biases stay float32."""
    names = ["lm_head.w"]
    for i in range(num_layers):
        names += ["mha_%d.qkv_%s.w" % (i, p) for p in "qkv"]
        names += ["mha_%d.o.w" % i, "enc_%d.ffn1.w" % i, "enc_%d.ffn2.w" % i]
    return sorted(names)


def _is_int8(value):
    return str(value.dtype) in ("int8", "torch.int8")


def check_lm_params(params, num_layers):
    """Raise ValueError unless ``params`` ({reference name: array or
    tensor}) holds every parameter of a ``num_layers`` LM and nothing
    else. A weight of :func:`lm_mul_weight_names` may come int8 with its
    scales under ``<name>@quant.scale`` (an armed reference scope); a
    scale without its int8 weight, or an int8 weight without its scale,
    raises."""
    expected = set(lm_param_names(num_layers))
    armable = set(lm_mul_weight_names(num_layers))
    scales = {n for n in params if n.endswith(SCALE_SUFFIX)}
    missing = sorted(expected - set(params))
    unknown = sorted(set(params) - expected - scales)
    for name in sorted(scales):
        base = name[:-len(SCALE_SUFFIX)]
        if base not in armable or base not in params \
                or not _is_int8(params[base]):
            unknown.append(name)
    for name in sorted(expected & set(params)):
        if _is_int8(params[name]):
            if name not in armable:
                unknown.append(name + " (int8)")
            elif scale_var_name(name) not in params:
                missing.append(scale_var_name(name))
    if missing or unknown:
        raise ValueError("parameter names do not match a %d-layer LM: "
                         "missing %s, unknown %s"
                         % (num_layers, missing, unknown))


def infer_num_layers(names):
    """Layer count implied by the per-layer names (mha_i / enc_i)."""
    idx = [int(m.group(1)) for n in names
           for m in [re.match(r"(?:mha|enc)_(\d+)\.", n)] if m]
    return max(idx) + 1 if idx else 0


class TransformerLM(nn.Module):
    """Embedding + learned positions, ``num_layers`` pre-norm blocks, a
    final layer norm and the LM head.

    Training: :meth:`forward` is the reference's ``_lm_backbone`` without
    a cache (tokens [B, T] -> logits [B, T, V]), and with labels the loss
    of :func:`transformer_lm`. The ``amp`` flag, read at each forward and
    each loss as the reference's executor reads it at each run, makes
    every ``mul`` of that call a bfloat16 product (``amp.py``); parameters
    stay float32, so one model trains under amp and runs without it.
    ``dropout_prob`` > 0 raises NotImplementedError (dropout runs on the
    program route); ``ring_axis`` splits T over that axis of the current
    strategy's mesh (ring attention). Parameters are created
    without gradients; an optimizer over them turns gradients on.

    Generation, over per-layer KV caches that :meth:`allocate_cache`
    (dense) or :meth:`allocate_pools` (paged) creates: :meth:`prefill`
    fills one slot from a prompt, :meth:`prefill_paged` a prompt window
    through a block table, :meth:`verify_paged` a speculative window (the
    logits of every row); :meth:`decode` advances every slot by one token.
    A model may share another's tensors (:meth:`bind_params`). Generation
    under amp is not ported: each of these calls raises while the flag is
    on."""

    def __init__(self, vocab_size, d_model, num_heads, d_ff, num_layers,
                 max_len, device=None, dropout_prob=0.0, ring_axis=None):
        super().__init__()
        device = resolve_device(device)
        self.device = device
        self.num_layers = num_layers

        def weight(*shape):
            return nn.Parameter(torch.zeros(*shape, device=device),
                                requires_grad=False)

        self.tok_embedding = weight(vocab_size, d_model)
        self.pos = PositionalEncodingWindow(max_len, d_model, device)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, num_heads, d_ff, device,
                                    dropout_prob, ring_axis)
            for _ in range(num_layers))
        self.ln_f_w = weight(d_model)
        self.ln_f_b = weight(d_model)
        self.lm_head = weight(d_model, vocab_size)
        self.register_buffer("lm_head_scale", None)
        self.caches = []

    def reference_tensors(self):
        """{reference name: parameter}, in the order the reference creates
        them (``lm_param_names``)."""
        return {name: getattr(*self._owner(name))
                for name in _name_map(self.num_layers)}

    def reference_parameters(self):
        """{reference name: trainable parameter}: every tensor of
        :meth:`reference_tensors` (the LM keeps no running statistics)."""
        return self.reference_tensors()

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        """Fill every parameter with the reference's initializers, drawn
        from a ``torch.Generator`` on the model's device seeded with
        ``seed``: the embedding normal(0, 1/sqrt(d_model)), the position
        table normal(0, 0.02), fc weights Xavier-uniform (limit
        sqrt(6 / (in + out))), biases 0, layer-norm scales 1 and
        shifts 0."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        for name, p in self.reference_tensors().items():
            if name == "tok_embedding":
                p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
            elif name == "pos_encoding_0.w_0":
                p.normal_(0.0, 0.02, generator=gen)
            elif name.startswith("layer_norm_"):
                p.fill_(1.0 if name.endswith(".w_0") else 0.0)
            elif p.dim() == 1:
                p.zero_()
            else:
                limit = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                p.uniform_(-limit, limit, generator=gen)

    def forward(self, tokens, labels=None, length=None):
        """tokens [B, T] ints (T at most ``max_len``) -> logits [B, T, V]
        (bfloat16 when the ``amp`` flag is on at this call). With
        ``labels`` [B, T], returns :func:`transformer_lm`'s ``(loss,
        logits)`` instead."""
        if labels is not None:
            return transformer_lm(self, tokens, labels, length)
        amp = flag_dtype()
        x = self.pos(lookup_table(self.tok_embedding, tokens))
        for layer in self.layers:
            x = layer(x, mode="full", amp=amp, causal=True)
        return self._head(x, amp)

    @staticmethod
    def _serving():
        if flag_dtype() is not None:
            raise NotImplementedError(
                "KV-cached generation under amp is not ported: turn the "
                "amp flag off to serve")

    def _owner(self, name):
        """(module, attribute) of the reference-named parameter."""
        path = _name_map(self.num_layers)[name]
        mod, _, attr = path.rpartition(".")
        return (self.get_submodule(mod) if mod else self), attr

    def mul_weight(self, name):
        """(weight, scales or None) of a weight of
        :func:`lm_mul_weight_names`, by its reference name."""
        mod, attr = self._owner(name)
        return getattr(mod, attr), getattr(mod, attr + "_scale")

    @torch.no_grad()
    def set_int8_weight(self, name, wq, scales):
        """Replace the weight ``name`` of :func:`lm_mul_weight_names` by
        its int8 [in, out] form and f32 [out] scales, on the module's
        device. The float32 weight is dropped."""
        mod, attr = self._owner(name)
        old = getattr(mod, attr)
        if tuple(wq.shape) != tuple(old.shape) or \
                tuple(scales.shape) != (old.shape[1],):
            raise ValueError("%s: int8 shape %s / scales %s, expected %s"
                             % (name, tuple(wq.shape), tuple(scales.shape),
                                tuple(old.shape)))
        setattr(mod, attr, nn.Parameter(
            torch.as_tensor(wq).to(device=self.device, dtype=torch.int8),
            requires_grad=False))
        setattr(mod, attr + "_scale", torch.as_tensor(scales).to(
            device=self.device, dtype=torch.float32))

    @torch.no_grad()
    def load_params(self, params):
        """Copy ``{reference name: tensor}`` into the module. Every name
        must be present with its shape; unknown names raise
        (:func:`check_lm_params`). An int8 weight and its scales are
        taken as they are."""
        check_lm_params(params, self.num_layers)
        own = dict(self.named_parameters())
        for name, path in _name_map(self.num_layers).items():
            dst, src = own[path], params[name]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError("%s: shape %s, expected %s"
                                 % (name, tuple(src.shape), tuple(dst.shape)))
            if _is_int8(src):
                self.set_int8_weight(name, src,
                                     params[scale_var_name(name)])
            else:
                dst.copy_(src)

    def reference_state(self):
        """{reference name: tensor} of every parameter, and the scales of
        the armed weights under ``<name>@quant.scale``: what
        :meth:`bind_params` shares."""
        state = {}
        for name, t in self.reference_tensors().items():
            state[name] = t
            mod, attr = self._owner(name)
            scale = getattr(mod, attr + "_scale", None)
            if scale is not None:
                state[scale_var_name(name)] = scale
        return state

    @torch.no_grad()
    def bind_params(self, state, device):
        """Take the tensors of ``state`` (a :meth:`reference_state`, or any
        superset of this model's names) as this model's own, by reference
        name and without a copy, and move the model to ``device``, where
        they must lie: a model sharing another's weights (the
        speculative self-draft, a truncation whose names are a subset of
        the target's). An armed weight comes with its scales."""
        for name in _name_map(self.num_layers):
            mod, attr = self._owner(name)
            src, old = state[name], getattr(mod, attr)
            if tuple(src.shape) != tuple(old.shape):
                raise ValueError("%s: shape %s, expected %s"
                                 % (name, tuple(src.shape),
                                    tuple(old.shape)))
            if not isinstance(src, nn.Parameter):
                src = nn.Parameter(src, requires_grad=False)
            setattr(mod, attr, src)
            if hasattr(mod, attr + "_scale"):
                setattr(mod, attr + "_scale",
                        state.get(scale_var_name(name)))
        self.device = torch.device(device)

    def allocate_cache(self, slots, cache_len, dtype=torch.float32):
        """Zeroed [slots, cache_len, d_model] K and V tensors of
        ``dtype`` (float32 or bfloat16) per layer."""
        self._zero_caches(slots, cache_len, dtype)

    def allocate_pools(self, num_blocks, block_size, dtype=torch.float32):
        """The paged layout: zeroed [num_blocks + 1, block_size, d_model]
        K and V pool storages of ``dtype`` per layer, the ``num_blocks``
        blocks that block tables address plus the sink block that
        dropped writes land in (``ops/generation_ops.py``)."""
        self._zero_caches(num_blocks + 1, block_size, dtype)

    def _zero_caches(self, rows, cols, dtype):
        shape = (rows, cols, self.tok_embedding.shape[1])
        self.caches = [(torch.zeros(shape, dtype=dtype, device=self.device),
                        torch.zeros(shape, dtype=dtype, device=self.device))
                       for _ in range(self.num_layers)]

    def release_cache(self):
        self.caches = []

    def _pool_geometry(self):
        """(num_blocks, block_size) of the paged caches."""
        storage = self.caches[0][0]
        return storage.shape[0] - 1, storage.shape[1]

    def _head(self, x, amp=None):
        return mul(layer_norm(x, self.ln_f_w, self.ln_f_b), self.lm_head,
                   self.lm_head_scale, amp)

    @torch.no_grad()
    def prefill(self, tokens, length, slot):
        """tokens [1, P] (prompt padded to a bucket), length = real
        prompt length, slot = cache slot to fill. Writes all P rows of
        the slot in every layer and returns the logits [1, V] at the last
        real position, length - 1."""
        self._serving()
        x = self.pos(lookup_table(self.tok_embedding, tokens))
        key_length = torch.tensor([length], dtype=torch.int32,
                                  device=self.device)
        slot = torch.tensor([slot], device=self.device)
        for layer, (ck, cv) in zip(self.layers, self.caches):
            x = layer(x, ck, cv, "prefill", slot=slot, key_length=key_length)
        return self._head(x[:, length - 1])

    def _window_paged(self, tokens, length, hist, pos_idx, table,
                      mode="prefill_paged"):
        self._serving()
        nb, bs = self._pool_geometry()
        rows = paged_window_rows(table, hist, length, tokens.shape[1], nb,
                                 bs)
        x = self.pos(lookup_table(self.tok_embedding, tokens), pos_idx,
                     window_rows=True)
        for layer, (ck, cv) in zip(self.layers, self.caches):
            x = layer(x, ck, cv, mode, table=table, hist=hist, rows=rows)
        return x

    @torch.no_grad()
    def prefill_paged(self, tokens, length, hist, pos_idx, table):
        """The paged suffix prefill. tokens [1, P]: a prompt window
        padded to a bucket, ``length`` real rows, the first at logical
        position ``hist`` (positions before it are cached in the table's
        first blocks); pos_idx [P] int, each window row's position-table
        row; table [MB] int block ids. Writes the window's real K/V rows
        through the table in every layer and returns the logits [1, V]
        at window row length - 1."""
        x = self._window_paged(tokens, length, hist, pos_idx, table)
        return self._head(x[:, length - 1])

    @torch.no_grad()
    def verify_paged(self, tokens, hist, pos_idx, table, last=False):
        """The speculative verify forward: the paged suffix-window forward
        of a W-row window, unpadded (tokens [1, W]: the pending token and
        the W - 1 drafts, the first at logical position ``hist``; pos_idx
        [W], table [MB] as in :meth:`prefill_paged`). Writes the W K/V
        rows and returns the logits of every row, [W, V]: row i scores
        the token at sequence index hist + i + 1. Each row attends as the
        decode step at its position does, through the paged decode
        attention (kernel B5) with its own length, where the reference
        runs its prefill attention: the same function, and row for row
        the decode step's arithmetic (with int8 weights every product is
        exact per row too), so a speculative stream is the plain one.
        With ``last``, only the last row's logits, [1, V]: a replay
        admission re-running a journal's generated tokens."""
        x = self._window_paged(tokens, tokens.shape[1], hist, pos_idx,
                               table, "verify_paged")
        return self._head(x[0, -1:] if last else x[0])

    @torch.no_grad()
    def decode(self, tokens, pos, table=None):
        """tokens [S, 1], pos [S] int32 (each slot's write position).
        Appends one K/V row per slot, active or not, and returns the
        logits [S, V]. Paged caches take ``table`` [S, MB] int32, each
        slot's block-table row; a dead entry drops the slot's write."""
        self._serving()
        if table is None:
            mode, index = "decode", {"pos": pos}
        else:
            rows = paged_append_rows(pos, table, *self._pool_geometry())
            mode, index = "decode_paged", {"pos": pos, "table": table,
                                           "rows": rows}
        x = self.pos(lookup_table(self.tok_embedding, tokens), pos)
        for layer, (ck, cv) in zip(self.layers, self.caches):
            x = layer(x, ck, cv, mode, **index)
        return self._head(x[:, 0])

    @torch.no_grad()
    def copy_block(self, src, dst):
        """Copy-on-write of paged caches: block ``src`` -> ``dst`` in
        every layer's K and V pool, on the device."""
        src, dst = (torch.tensor([i], device=self.device) for i in (src, dst))
        for ck, cv in self.caches:
            kv_block_copy(ck, src, dst)
            kv_block_copy(cv, src, dst)


def transformer_tp_rules(model_axis="model"):
    """Megatron-style tensor-parallel rules for the transformer's
    parameters (fed to ``parallel.DistStrategy``): qkv and ffn1
    column-sharded, attention-out and ffn2 row-sharded, the lm head and
    the token embedding vocab-sharded. The tails are UNANCHORED, so
    optimizer accumulators (``<param>_moment1_acc_0``) inherit the
    sharding; ``state_sharding``'s divisibility guard drops the axis on
    [1] beta-pow accumulators."""
    from ..parallel import P
    return [
        (r"\.qkv_[qkv]\.w", P(None, model_axis)),
        (r"\.o\.w", P(model_axis, None)),
        (r"\.ffn1\.w", P(None, model_axis)),
        (r"\.ffn1\.b", P(model_axis)),
        (r"\.ffn2\.w", P(model_axis, None)),
        (r"^lm_head\.w", P(None, model_axis)),
        (r"^tok_embedding", P(model_axis, None)),
    ]


def _lm_backbone(tokens, vocab_size, d_model, num_heads, d_ff, num_layers,
                 ring_axis=None, dropout_prob=0.0, is_test=False,
                 cache_ctx=None):
    """The reference's ``_lm_backbone`` (program form): tokens [B, T] ->
    logits [B, T, V] Variables. ``cache_ctx`` (the cached generation
    programs of :func:`transformer_lm_session`): ``mode`` ('prefill' or
    'decode'), ``caches`` ([(k, v) cache Variables per layer]),
    ``max_len`` (the position table's length) and the mode's index feeds
    (``slot``/``key_length`` for prefill, ``pos`` for decode); with
    ``layout='paged'`` also ``table``, and for prefill ``hist`` and
    ``pos_idx`` (each window row's position). Every parameter name is
    the uncached build's, so the cached programs serve a trained
    scope."""
    emb = _layers.embedding(tokens, size=[vocab_size, d_model],
                            param_attr="tok_embedding",
                            keep_dims=cache_ctx is not None)
    if cache_ctx is None:
        x = positional_encoding(emb)
    elif cache_ctx.get("pos_idx") is not None:
        x = positional_encoding_window(emb, cache_ctx["max_len"],
                                       pos=cache_ctx["pos_idx"],
                                       window_rows=True)
    else:
        x = positional_encoding_window(emb, cache_ctx["max_len"],
                                       pos=cache_ctx.get("pos"))
    for i in range(num_layers):
        cache = key_length = None
        if cache_ctx is not None:
            ck, cv = cache_ctx["caches"][i]
            cache = {"k": ck, "v": cv, "mode": cache_ctx["mode"],
                     "slot": cache_ctx.get("slot"),
                     "pos": cache_ctx.get("pos"),
                     "layout": cache_ctx.get("layout"),
                     "table": cache_ctx.get("table"),
                     "hist": cache_ctx.get("hist")}
            key_length = cache_ctx.get("key_length")
        x = transformer_encoder_layer(
            x, d_model, num_heads, d_ff, causal=True,
            key_length=key_length, ring_axis=ring_axis,
            dropout_prob=dropout_prob, is_test=is_test, cache=cache)
    x = _layers.layer_norm(x, begin_norm_axis=2)
    return _layers.fc(x, vocab_size, num_flatten_dims=2, bias_attr=False,
                      param_attr="lm_head.w")


def _transformer_lm_program(tokens, labels, vocab_size, d_model=128,
                            num_heads=4, d_ff=256, num_layers=2,
                            ring_axis=None, dropout_prob=0.0, is_test=False,
                            length=None):
    """Reference ``transformer_lm`` (program form): tokens/labels [B, T]
    id Variables, ``length`` an optional [B] Variable. Returns (loss,
    logits) Variables."""
    logits = _lm_backbone(tokens, vocab_size, d_model, num_heads, d_ff,
                          num_layers, ring_axis=ring_axis,
                          dropout_prob=dropout_prob, is_test=is_test)
    t = tokens.shape[1]
    flat_logits = _layers.reshape(logits, [-1, vocab_size])
    flat_labels = _layers.reshape(labels, [-1, 1])
    tok_loss = _layers.softmax_with_cross_entropy(flat_logits, flat_labels)
    tok_loss = _layers.reshape(tok_loss, [-1, t])
    if length is not None:
        mask = _layers.sequence_mask(length, maxlen=t)
        masked = _layers.elementwise_mul(tok_loss, mask)
        loss = _layers.elementwise_div(_layers.reduce_sum(masked),
                                       _layers.reduce_sum(mask))
    else:
        loss = _layers.mean(tok_loss)
    return loss, logits


def transformer_lm(*args, **kwargs):
    """Two forms, by the first argument. Given a program Variable,
    ``transformer_lm(tokens, labels, vocab_size, d_model=128,
    num_heads=4, d_ff=256, num_layers=2, ring_axis=None,
    dropout_prob=0.0, is_test=False, length=None)`` builds the
    reference's program into the current program and returns its (loss,
    logits) Variables. Given a :class:`TransformerLM`,
    ``transformer_lm(model, tokens, labels, length=None)`` computes the
    loss below on the nn.Module route."""
    first = args[0] if args else kwargs.get("tokens")
    if isinstance(first, Variable):
        return _transformer_lm_program(*args, **kwargs)
    return _transformer_lm_module(*args, **kwargs)


def _transformer_lm_module(model, tokens, labels, length=None):
    """Reference ``transformer_lm``'s loss over ``model``'s logits: the
    per-token ``softmax_with_cross_entropy`` (float32 under amp, a BLACK
    op) of logits [B, T, V] against labels [B, T], then its mean, or with
    ``length`` [B] the mean over each row's first ``length`` tokens. The
    ``amp`` flag is read at this call. Returns ``(loss, logits)``."""
    amp = flag_dtype()
    logits = model(tokens)
    b, t, v = logits.shape
    tok_loss = softmax_with_cross_entropy(
        logits.reshape(-1, v), labels.reshape(-1, 1), amp)[0]
    tok_loss = tok_loss.reshape(-1, t)
    if length is None:
        return mean(tok_loss), logits
    mask = (torch.arange(t, device=tok_loss.device)[None, :]
            < length.reshape(-1, 1).to(tok_loss.device)).to(tok_loss.dtype)
    return (tok_loss * mask).sum() / mask.sum(), logits


# the cache namespaces of transformer_lm_session's specs
_CACHE_NS = itertools.count()


def kv_dtype(name):
    """The torch dtype of a cache dtype name ("float32", "bfloat16",
    ...); raises ValueError for a name that is not a floating dtype."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError("not a floating cache dtype: %r" % (name,))
    return dt


def _build_model(params, vocab_size, d_model, num_heads, d_ff, num_layers,
                 max_len, device, share=False):
    """The spec's model over ``params``: copied in
    (:meth:`TransformerLM.load_params`), or with ``share`` taken by
    reference from another model's :meth:`~TransformerLM.reference_state`
    (:meth:`~TransformerLM.bind_params`; nothing is allocated for the
    weights)."""
    if share:
        model = TransformerLM(vocab_size, d_model, num_heads, d_ff,
                              num_layers, max_len, "meta")
        model.bind_params(params, device)
        return model
    model = TransformerLM(vocab_size, d_model, num_heads, d_ff, num_layers,
                          max_len, device)
    model.load_params(params)
    return model


def policy_epilogue(logits, policy, keys=None, mask=None):
    """Next tokens of ``logits`` [N, V] under the decode ``policy`` (None:
    greedy), the reference's ``_policy_epilogue``: a constraint's
    additive ``mask`` [N, V] is added first, then the policy samples
    (``ops.decoding_ops.sample_from_keys`` under ``keys`` [N, 2], the
    rows' ``decoding_key(seed, step)``) or takes the argmax. Returns [N]
    int64."""
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    if policy is not None and policy.sampled:
        return sample_from_keys(logits, keys,
                                temperature=policy.temperature,
                                top_k=policy.top_k, top_p=policy.top_p)
    return argmax(logits, -1)


def _generation_programs(ns, vocab_size, d_model, num_heads, d_ff,
                         num_layers, max_len, slots, prompt_buckets, dtype,
                         paged, max_blocks, cache_shape, policy):
    """The reference's cached generation programs under the cache
    namespace ``ns`` (its ``transformer_lm_session`` body): {field of
    ``GenerationSpec``: value} for the prefill programs (one per bucket),
    the decode program, the block-copy program (paged) and the verify
    program (speculative), with their feed and fetch names. Each is
    built under ``unique_name.guard()``, so its parameter names are
    those of the ``transformer_lm`` program."""
    sampled = policy is not None and policy.sampled
    constraint = None if policy is None else policy.constraint
    spec_k = 0 if policy is None else policy.speculate_k

    def make_cache_vars(program):
        block = program.global_block()
        return [tuple(block.create_var(name="%s.l%d.%s" % (ns, i, kv),
                                       shape=cache_shape, dtype=dtype,
                                       persistable=True, stop_gradient=True)
                      for kv in ("k", "v"))
                for i in range(num_layers)]

    def policy_epilogue(row, seed=None, step=None, mask=None):
        if mask is not None:
            row = _layers.elementwise_add(row, mask)
        if sampled:
            return _layers.decode_sample(
                row, seed, step, temperature=policy.temperature,
                top_k=policy.top_k, top_p=policy.top_p)
        return _layers.argmax(row, axis=-1)

    def policy_feeds(prefix, n):
        seed = step = mask = None
        names = []
        if sampled:
            seed = _layers.data(prefix + "seed", shape=[n], dtype="int64",
                                append_batch_size=False)
            step = _layers.data(prefix + "step", shape=[n], dtype="int32",
                                append_batch_size=False)
            names += [prefix + "seed", prefix + "step"]
        if constraint is not None:
            mask = _layers.data(prefix + "mask", shape=[n, vocab_size],
                                dtype="float32", append_batch_size=False)
            names.append(prefix + "mask")
        return seed, step, mask, tuple(names)

    def data(name, shape, dtype="int32"):
        return _layers.data(name, shape=shape, dtype=dtype,
                            append_batch_size=False)

    def backbone(tokens, cache_ctx):
        return _lm_backbone(tokens, vocab_size, d_model, num_heads, d_ff,
                            num_layers, is_test=True, cache_ctx=cache_ctx)

    out = {"prefill_programs": {}}
    prefill_extra = ()
    for p in prompt_buckets:
        prog = Program()
        with unique_name.guard(), program_guard(prog, Program()):
            toks = data("gen.ptok", [1, p], "int64")
            plen = data("gen.plen", [1])
            ppos = data("gen.ppos", [1])
            if paged:
                cache_ctx = {"mode": "prefill", "layout": "paged",
                             "table": None, "hist": data("gen.phist", [1]),
                             "pos_idx": data("gen.ppix", [p]),
                             "key_length": plen, "max_len": max_len}
                cache_ctx["table"] = data("gen.ptab", [max_blocks])
            else:
                cache_ctx = {"mode": "prefill", "slot": data("gen.slot", [1]),
                             "key_length": plen, "max_len": max_len}
            pseed, pstep, pmask, prefill_extra = policy_feeds("gen.p", 1)
            cache_ctx["caches"] = make_cache_vars(prog)
            logits = backbone(toks, cache_ctx)
            at = _layers.gather(_layers.transpose(logits, [1, 0, 2]), ppos)
            nxt = policy_epilogue(_layers.reshape(at, [1, vocab_size]),
                                  seed=pseed, step=pstep, mask=pmask)
        out["prefill_programs"][p] = prog
        out["prefill_fetch"] = nxt.name
    out["prefill_feeds"] = (("gen.ptok", "gen.plen", "gen.ppos", "gen.phist",
                             "gen.ppix", "gen.ptab") if paged
                            else ("gen.ptok", "gen.plen", "gen.ppos",
                                  "gen.slot")) + prefill_extra

    prog = Program()
    with unique_name.guard(), program_guard(prog, Program()):
        toks = data("gen.dtok", [slots, 1], "int64")
        dpos = data("gen.dpos", [slots])
        cache_ctx = {"mode": "decode", "pos": dpos, "max_len": max_len}
        if paged:
            cache_ctx.update(layout="paged",
                             table=data("gen.dtab", [slots, max_blocks]))
        dseed, dstep, dmask, decode_extra = policy_feeds("gen.d", slots)
        cache_ctx["caches"] = make_cache_vars(prog)
        logits = backbone(toks, cache_ctx)
        nxt = policy_epilogue(_layers.reshape(logits, [slots, vocab_size]),
                              seed=dseed, step=dstep, mask=dmask)
    out.update(decode_program=prog, decode_fetch=nxt.name,
               decode_feeds=(("gen.dtok", "gen.dpos", "gen.dtab") if paged
                             else ("gen.dtok", "gen.dpos")) + decode_extra)

    if paged:
        # copy-on-write: block Src -> Dst in every layer's K and V pool
        prog = Program()
        with unique_name.guard(), program_guard(prog, Program()):
            csrc, cdst = data("gen.csrc", [1]), data("gen.cdst", [1])
            block = prog.global_block()
            for pair in make_cache_vars(prog):
                for cvar in pair:
                    block.append_op(type="kv_block_copy",
                                    inputs={"Cache": [cvar.name],
                                            "Src": [csrc.name],
                                            "Dst": [cdst.name]},
                                    outputs={"Out": [cvar.name]})
        out.update(copy_program=prog, copy_feeds=("gen.csrc", "gen.cdst"))

    if spec_k:
        # one suffix-window forward at window W = k + 1 whose epilogue
        # re-decides every window position with the target's logits; its
        # attention is tagged to run as W decode queries (VERIFY_TAG)
        w = spec_k + 1
        prog = Program()
        with unique_name.guard(), program_guard(prog, Program()):
            vtok = data("gen.vtok", [1, w], "int64")
            vlen, vhist = data("gen.vlen", [1]), data("gen.vhist", [1])
            vpix = data("gen.vpix", [w])
            vtab = data("gen.vtab", [max_blocks])
            vseed = data("gen.vseed", [1], "int64")
            cache_ctx = {"mode": "prefill", "layout": "paged",
                         "caches": make_cache_vars(prog), "table": vtab,
                         "hist": vhist, "pos_idx": vpix, "key_length": vlen,
                         "max_len": max_len}
            logits = backbone(vtok, cache_ctx)
            vtoks, vaccept = _layers.decode_verify(
                logits, vtok, vseed, vhist, kind=policy.kind,
                temperature=policy.temperature, top_k=policy.top_k,
                top_p=policy.top_p)
        setattr(prog, VERIFY_TAG, True)
        out.update(verify_program=prog,
                   verify_feeds=("gen.vtok", "gen.vlen", "gen.vhist",
                                 "gen.vpix", "gen.vtab", "gen.vseed"),
                   verify_fetch=(vtoks.name, vaccept.name))
    return out


def transformer_lm_generate(batch_anchor, vocab_size, d_model=128,
                            num_heads=4, d_ff=256, num_layers=2,
                            max_len=16, beam_size=4, bos_id=0, eos_id=1,
                            return_all_beams=False, decode="beam",
                            sample_seed=0, temperature=1.0, top_k=0,
                            top_p=1.0):
    """Beam-search generation from the causal LM through
    ``BeamSearchDecoder`` (reference ``transformer_lm_generate``): the
    step sub-block runs the whole backbone over the token history, O(L^2)
    a sequence, the exact formulation the KV-cached decode
    (:func:`transformer_lm_session` and ``serving.generation``) is held
    to token for token at ``beam_size=1``. Its attention is the f32
    ``multihead_attention`` op, kernel B2 on the card, one launch a layer
    a step.

    ``decode="sample"`` is the stochastic reference path: beam_size is
    forced to 1 and each step samples under the SAME counter-key
    schedule the cached session uses — ``decoding_key(sample_seed,
    position)`` with temperature/top-k/top-p — so cached-vs-reference
    parity tests cover stochastic decode too (the token at sequence
    index *i* is keyed by (seed, i) on both paths; a session decoding
    from a ``[bos]`` prompt with the same seed reproduces this path's
    stream token-for-token).

    ``batch_anchor``: any [B, ...] variable sizing the batch (e.g. an
    int32 dummy [B, 1]). Returns (ids, lengths, scores).
    """
    if decode == "sample":
        beam_size = 1
    bs = _layers.BeamSearchDecoder(beam_size=beam_size, max_len=max_len,
                                  bos_id=bos_id, eos_id=eos_id,
                                  decode=decode, sample_seed=sample_seed,
                                  temperature=temperature, top_k=top_k,
                                  top_p=top_p)
    with bs.step():
        bs.token()                       # advances via history
        anchor = bs.state(batch_anchor)  # sizes the batch; never updated
        del anchor
        hist = bs.history()              # [N, max_len] tokens so far
        pos = bs.position()              # [1] current step index
        logits_all = _lm_backbone(hist, vocab_size, d_model, num_heads,
                                  d_ff, num_layers, is_test=True)
        # take logits at the current position: [N,L,V] -> [L,N,V] -> [N,V]
        by_time = _layers.transpose(logits_all, [1, 0, 2])
        at_pos = _layers.gather(by_time, pos)
        bs.set_logits(_layers.reshape(at_pos, [-1, vocab_size]))
    return bs(return_all_beams=return_all_beams)


def transformer_lm_session(vocab_size, d_model=128, num_heads=4, d_ff=256,
                           num_layers=2, max_len=16, slots=None,
                           cache_len=None, prompt_buckets=None, bos_id=0,
                           eos_id=1, cache_ns=None, device=None,
                           dtype="float32", paged=None, block_size=None,
                           num_blocks=None, prefix_cache=None,
                           decode_policy="flags"):
    """The KV-cached generation spec of the causal LM. Defaults
    for ``slots`` / ``cache_len`` / ``prompt_buckets`` come from the
    ``generation_slots`` / ``generation_cache_buckets`` /
    ``generation_prompt_buckets`` flags, resolved as the reference does.
    ``device`` defaults to CUDA and raises when there is none.

    The spec carries both of the port's serving routes. Its programs are
    the reference's, op for op and name for name (each built under
    ``unique_name.guard()``): a prefill program per prompt bucket, the
    decode program, with ``paged`` the block-copy program, and with
    speculation the verify program; ``GenerationSession(spec, scope)``
    runs them through ``core.Executor`` over a scope holding the
    ``transformer_lm`` program's parameters. ``build_model`` gives the
    ``nn.Module`` route, ``GenerationSession(spec, params)``.

    ``dtype`` is the K/V cache storage, dense rows and paged pools both
    ("float32" or "bfloat16"; weights and activations stay float32).
    Left at "float32", it is filled from the ``generation_kv_dtype``
    flag when that is set; any other explicit dtype wins over the flag.

    ``paged`` (default: the ``generation_paged_kv`` flag) swaps the dense
    [slots, cache_len, d_model] caches for per-layer block pools of
    ``num_blocks`` blocks of ``block_size`` rows (defaults: the
    ``generation_pool_blocks`` / ``generation_block_size`` flags;
    ``num_blocks`` 0 means slots x ceil(cache_len / block_size), byte
    parity with the dense cache), addressed through block tables of
    ``max_blocks`` = ceil(cache_len / block_size) entries;
    ``prefix_cache`` (default: the ``generation_prefix_cache`` flag)
    shares prompt blocks between admissions.

    ``decode_policy`` (default ``"flags"``: the ``decode_*`` flags through
    ``DecodePolicy.from_flags``, the only place they are read; None
    forces greedy; or a ``DecodePolicy``) makes the next token a policy:
    sampling keyed by (seed, position), a constraint's additive mask rows,
    and with ``speculate_k`` > 0 (paged only) speculative rounds: a dense
    greedy draft spec, by default a 1-layer truncation whose parameter
    names are the target's own (so the session shares the target's
    tensors), proposes k tokens a round and one verify forward of the
    target scores them. ``decode_draft_model`` overrides the draft's
    ``d_model``, ``num_heads``, ``d_ff`` or ``num_layers``. The
    all-defaults flags resolve to no policy: greedy as before.

    Each spec names its caches under a namespace of its own, ``cache_ns``
    (default: a new "kv_session_<n>" of a process-wide count; the
    reference draws it from ``unique_name``), as ``cache_vars``
    ("<cache_ns>.l<i>.k" / ".v" with the reference's declared shapes: a
    paged session's storage holds one sink block past them).
    ``spec.rebuild()`` returns the same spec, its draft's too, under new
    namespaces, reading no flag (every value is resolved here), which is
    what a session rebuild builds its replacement from. ``bos_id`` is the
    token a rebuild's warm-up prompts are made of.

    Returns a :class:`~paddle_tpu_torch.serving.generation.GenerationSpec`."""
    from ..serving.decoding import DecodePolicy
    from ..serving.generation import GenerationSpec

    if decode_policy == "flags":
        decode_policy = DecodePolicy.from_flags()
    policy = decode_policy
    spec_k = 0 if policy is None else policy.speculate_k
    device = resolve_device(device)
    if slots is None:
        slots = int(_config.get_flag("generation_slots"))
    if slots < 1:
        raise ValueError("slots must be >= 1, got %r" % (slots,))
    if cache_len is None:
        bucks = sorted(int(b) for b in
                       _config.get_flag("generation_cache_buckets"))
        cache_len = next((b for b in bucks if b >= max_len),
                         bucks[-1] if bucks else max_len)
    cache_len = max(int(cache_len), int(max_len))
    if prompt_buckets is None:
        prompt_buckets = _config.get_flag("generation_prompt_buckets")
    prompt_buckets = tuple(sorted({
        min(int(p), max_len) for p in prompt_buckets if int(p) >= 1}))
    if not prompt_buckets:
        raise ValueError("need at least one prompt bucket")
    if dtype == "float32":
        kvd = _config.get_flag("generation_kv_dtype")
        if kvd:
            dtype = str(kvd)
    kv_dtype(dtype)
    if paged is None:
        paged = bool(_config.get_flag("generation_paged_kv"))
    max_blocks = 0
    if paged:
        if block_size is None:
            block_size = int(_config.get_flag("generation_block_size"))
        block_size = max(1, int(block_size))
        max_blocks = -(-cache_len // block_size)
        if num_blocks is None:
            num_blocks = int(_config.get_flag("generation_pool_blocks"))
        num_blocks = int(num_blocks) or slots * max_blocks
        if prefix_cache is None:
            prefix_cache = bool(_config.get_flag("generation_prefix_cache"))
        cache_shape = (num_blocks, block_size, d_model)
    else:
        block_size, num_blocks, prefix_cache = 0, 0, False
        cache_shape = (slots, cache_len, d_model)
    if spec_k and not paged:
        raise ValueError("decode_speculate_k needs the paged KV layout "
                         "(generation_paged_kv / paged=True): the verify "
                         "pass is a suffix-window prefill and rollback is "
                         "block decref")
    dkw = None
    if spec_k:
        dkw = dict(d_model=d_model, num_heads=num_heads, d_ff=d_ff,
                   num_layers=1)
        if policy.draft:
            unknown = set(policy.draft) - set(dkw)
            if unknown:
                raise ValueError("decode_draft_model keys %r not in %r"
                                 % (sorted(unknown), sorted(dkw)))
            dkw.update(policy.draft)

    def make(ns=None):
        # a fresh cache namespace per spec (its draft's too); the rebuild
        # factory is this function again, over the values resolved above
        ns = ns or "kv_session_%d" % next(_CACHE_NS)
        draft_spec = None if dkw is None else transformer_lm_session(
            vocab_size, max_len=max_len, slots=slots, cache_len=cache_len,
            prompt_buckets=prompt_buckets, bos_id=bos_id, eos_id=eos_id,
            device=device, dtype=dtype, paged=False, decode_policy=None,
            **dkw)
        return GenerationSpec(
            slots=slots, cache_len=cache_len, max_len=max_len,
            prompt_buckets=prompt_buckets, bos_id=bos_id, eos_id=eos_id,
            device=device, dtype=str(dtype), paged=bool(paged),
            block_size=block_size, num_blocks=num_blocks,
            max_blocks=max_blocks, prefix_cache=bool(prefix_cache),
            vocab_size=vocab_size, policy=policy, draft_spec=draft_spec,
            cache_vars=tuple(("%s.l%d.%s" % (ns, i, kv), cache_shape,
                              str(dtype))
                             for i in range(num_layers)
                             for kv in ("k", "v")),
            rebuild=make,
            build_model=functools.partial(
                _build_model, vocab_size=vocab_size, d_model=d_model,
                num_heads=num_heads, d_ff=d_ff, num_layers=num_layers,
                max_len=max_len, device=device),
            **_generation_programs(
                ns, vocab_size, d_model, num_heads, d_ff, num_layers,
                max_len, slots, prompt_buckets, str(dtype), paged,
                max_blocks, cache_shape, policy))
    return make(cache_ns)
