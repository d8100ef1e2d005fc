"""The causal transformer LM for KV-cached generation (reference
``paddle_tpu/models/transformer.py``: ``_lm_backbone`` and the dense,
greedy branch of ``transformer_lm_session``).

Parameters carry the reference's names at the boundary
(:func:`lm_param_names`), so weights saved by ``paddle_tpu`` load here
through ``io.params_from_jax``."""

import functools
import re

import torch
from torch import nn

from .. import config as _config
from ..layers.attention import (PositionalEncodingWindow,
                                TransformerEncoderLayer)
from ..ops.nn_ops import layer_norm, lookup_table, mul
from ..place import resolve_device

__all__ = ["TransformerLM", "lm_param_names", "infer_num_layers",
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


def infer_num_layers(names):
    """Layer count implied by the per-layer names (mha_i / enc_i)."""
    idx = [int(m.group(1)) for n in names
           for m in [re.match(r"(?:mha|enc)_(\d+)\.", n)] if m]
    return max(idx) + 1 if idx else 0


class TransformerLM(nn.Module):
    """Embedding + learned positions, ``num_layers`` pre-norm blocks, a
    final layer norm and the LM head, over per-layer KV caches that
    :meth:`allocate_cache` creates. :meth:`prefill` fills one slot from
    a prompt; :meth:`decode` advances every slot by one token."""

    def __init__(self, vocab_size, d_model, num_heads, d_ff, num_layers,
                 max_len, device=None):
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
            TransformerEncoderLayer(d_model, num_heads, d_ff, device)
            for _ in range(num_layers))
        self.ln_f_w = weight(d_model)
        self.ln_f_b = weight(d_model)
        self.lm_head = weight(d_model, vocab_size)
        self.caches = []

    @torch.no_grad()
    def load_params(self, params):
        """Copy ``{reference name: tensor}`` into the module. Every name
        must be present with its shape; unknown names raise."""
        names = _name_map(self.num_layers)
        missing = sorted(set(names) - set(params))
        unknown = sorted(set(params) - set(names))
        if missing or unknown:
            raise ValueError("parameter names do not match a %d-layer LM: "
                             "missing %s, unknown %s"
                             % (self.num_layers, missing, unknown))
        own = dict(self.named_parameters())
        for name, path in names.items():
            dst, src = own[path], params[name]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError("%s: shape %s, expected %s"
                                 % (name, tuple(src.shape), tuple(dst.shape)))
            dst.copy_(src)

    def allocate_cache(self, slots, cache_len):
        """Zeroed float32 [slots, cache_len, d_model] K and V tensors per
        layer."""
        shape = (slots, cache_len, self.tok_embedding.shape[1])
        self.caches = [(torch.zeros(shape, device=self.device),
                        torch.zeros(shape, device=self.device))
                       for _ in range(self.num_layers)]

    def release_cache(self):
        self.caches = []

    def _head(self, x):
        return mul(layer_norm(x, self.ln_f_w, self.ln_f_b), self.lm_head)

    @torch.no_grad()
    def prefill(self, tokens, length, slot):
        """tokens [1, P] (prompt padded to a bucket), length = real
        prompt length, slot = cache slot to fill. Writes all P rows of
        the slot in every layer and returns the logits [1, V] at the last
        real position, length - 1."""
        x = self.pos(lookup_table(self.tok_embedding, tokens))
        key_length = torch.tensor([length], dtype=torch.int32,
                                  device=self.device)
        for layer, (ck, cv) in zip(self.layers, self.caches):
            x = layer(x, ck, cv, "prefill", slot=slot, key_length=key_length)
        return self._head(x[:, length - 1])

    @torch.no_grad()
    def decode(self, tokens, pos):
        """tokens [S, 1], pos [S] int32 (each slot's write position).
        Appends one K/V row per slot, active or not, and returns the
        logits [S, V]."""
        x = self.pos(lookup_table(self.tok_embedding, tokens), pos)
        for layer, (ck, cv) in zip(self.layers, self.caches):
            x = layer(x, ck, cv, "decode", pos=pos)
        return self._head(x[:, 0])


def _build_model(params, vocab_size, d_model, num_heads, d_ff, num_layers,
                 max_len, device):
    model = TransformerLM(vocab_size, d_model, num_heads, d_ff, num_layers,
                          max_len, device)
    model.load_params(params)
    return model


def transformer_lm_session(vocab_size, d_model=128, num_heads=4, d_ff=256,
                           num_layers=2, max_len=16, slots=None,
                           cache_len=None, prompt_buckets=None, eos_id=1,
                           device=None):
    """The KV-cached generation spec of the causal LM: dense float32
    cache, greedy. Defaults for ``slots`` / ``cache_len`` / ``prompt_buckets``
    come from the ``generation_slots`` / ``generation_cache_buckets`` /
    ``generation_prompt_buckets`` flags, resolved as the reference does.
    ``device`` defaults to CUDA and raises when there is none. Returns a
    :class:`~paddle_tpu_torch.serving.generation.GenerationSpec` for
    ``GenerationSession(spec, params)``."""
    from ..serving.generation import GenerationSpec

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
    return GenerationSpec(
        slots=slots, cache_len=cache_len, max_len=max_len,
        prompt_buckets=prompt_buckets, eos_id=eos_id, device=device,
        build_model=functools.partial(
            _build_model, vocab_size=vocab_size, d_model=d_model,
            num_heads=num_heads, d_ff=d_ff, num_layers=num_layers,
            max_len=max_len, device=device))
