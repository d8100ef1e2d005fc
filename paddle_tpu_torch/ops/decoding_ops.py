"""Decode-policy ops on tensors (reference
``paddle_tpu/ops/decoding_ops.py``): temperature / top-k / top-p
sampling keyed by counter, and the speculative accept step.

* :func:`sample_from_logits` draws one token a row under the key
  ``decoding_key(seed, step)`` (:func:`sample_from_keys` under keys
  already derived): the categorical draw is
  ``argmax(x + gumbel)``, which is what ``jax.random.categorical``
  computes, the first index winning a tie in both. Sharing this one
  function between the prefill and decode epilogues and the verify step
  is the replay contract.
* :func:`decode_sample` adds the optional additive mask row first (the
  constrained-decoding row: 0 legal, ``NEG_INF`` banned).
* :func:`decode_verify` re-decides every position of a draft window with
  the target's logits and counts the accepted draft prefix
  (:func:`verify_tokens` on tensors).

The op types ``decode_sample`` and ``decode_verify`` of the generation
programs are registered here, with the reference's slots and attributes.

The reference computes these in plain jnp/XLA, with no Pallas kernel,
and so does the port in plain torch ops: they are small next to the
transformer stack they follow.
"""

import torch

from ..core.registry import register_op
from .random_ops import decoding_key, gumbel

__all__ = ["NEG_INF", "filtered_logits", "sample_from_keys",
           "sample_from_logits", "decode_sample", "verify_tokens",
           "decode_verify"]

NEG_INF = -1e30


def _f32(value, device):
    # a fill on the device, not a copy from the host: a captured step
    # (core/executor.py) may make it
    return torch.full((), value, dtype=torch.float32, device=device)


def filtered_logits(logits, temperature=1.0, top_k=0, top_p=1.0):
    """The scores a sampled draw perturbs: ``logits`` [N, V] in float32
    over the temperature, as a float32 scalar like the reference's
    ``jnp.float32(temperature)``; top-k keeps every logit tied with the
    k-th largest; top-p keeps the shortest prefix of the descending
    order (ties in index order, as ``lax.top_k``) whose mass reaches
    ``top_p``, the first token always. The rest become NEG_INF."""
    dev = logits.device
    x = logits.to(torch.float32) / _f32(temperature, dev)
    v = x.shape[1]
    if top_k and 0 < top_k < v:
        kth = torch.topk(x, top_k, dim=-1).values[:, -1:]
        x = torch.where(x < kth, _f32(NEG_INF, dev), x)
    if top_p < 1.0:
        sorted_x, sort_idx = torch.sort(x, dim=-1, descending=True,
                                        stable=True)
        probs = torch.softmax(sorted_x, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < _f32(top_p, dev)
        kept = torch.where(keep, sorted_x, _f32(NEG_INF, dev))
        x = torch.full_like(x, NEG_INF).scatter(1, sort_idx, kept)
    return x


def sample_from_keys(logits, keys, temperature=1.0, top_k=0, top_p=1.0):
    """One token a row of ``logits`` [N, V] under the key words ``keys``
    [N, 2] (:func:`~.random_ops.decoding_key`'s, on any device): the
    argmax of :func:`filtered_logits` plus the key's Gumbel noise.
    Returns [N] int64."""
    x = filtered_logits(logits, temperature, top_k, top_p)
    noise = gumbel(keys.to(x.device), x.shape[1])
    return torch.argmax(noise + x, dim=-1).to(torch.int64)


def sample_from_logits(logits, seeds, steps, temperature=1.0, top_k=0,
                       top_p=1.0):
    """:func:`sample_from_keys` under the keys ``decoding_key(seeds[i],
    steps[i])``, derived where ``seeds`` and ``steps`` lie: given host
    arrays, the key schedule's few dozen ops on [N] run on the host and
    only the [N, 2] key words reach the logits' device."""
    keys = decoding_key(torch.as_tensor(seeds).reshape(-1),
                        torch.as_tensor(steps).reshape(-1))
    return sample_from_keys(logits, keys, temperature, top_k, top_p)


def decode_sample(logits, seeds, steps, mask=None, temperature=1.0,
                  top_k=0, top_p=1.0):
    """``decode_sample``: logits [N, V], seeds [N] (the request seeds),
    steps [N] (the sequence index of the token drawn), an optional
    additive ``mask`` [N, V] added first. Returns [N] int64."""
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    return sample_from_logits(logits, seeds, steps, temperature=temperature,
                              top_k=top_k, top_p=top_p)


def verify_tokens(logits, window, seed, hist, kind="greedy",
                  temperature=1.0, top_k=0, top_p=1.0):
    """The speculative accept step on tensors: logits [W, V] (or [1, W,
    V]), window [W] (or [1, W]), ``seed`` and ``hist`` ints or tensors of
    one, where the keys are derived (the host for ints). Returns
    ``(tokens [W] int64, accept [1] int32)``, ``accept`` on the tokens'
    device and never read back here."""
    window = window.reshape(-1)
    w = window.shape[0]
    logits = logits.reshape(w, -1)
    if kind == "sample":
        where = hist.device if isinstance(hist, torch.Tensor) else None
        base = hist.reshape(-1)[:1].to(torch.int64) \
            if isinstance(hist, torch.Tensor) else int(hist)
        steps = base + 1 + torch.arange(w, dtype=torch.int64, device=where)
        seeds = seed.reshape(-1)[:1].to(steps.device).expand(w) \
            if isinstance(seed, torch.Tensor) \
            else torch.full_like(steps, int(seed))
        toks = sample_from_logits(logits, seeds, steps,
                                  temperature=temperature, top_k=top_k,
                                  top_p=top_p)
    else:
        toks = torch.argmax(logits, dim=-1).to(torch.int64)
    match = (toks[:-1] == window.to(toks.device)[1:]).to(torch.int32)
    accept = torch.cumprod(match, dim=0).sum().to(torch.int32).reshape(1)
    return toks, accept


def decode_verify(logits, window, seed, hist, kind="greedy",
                  temperature=1.0, top_k=0, top_p=1.0):
    """The speculative accept step over one window. logits [W, V] (row i
    scores the token at sequence index hist + i + 1), window [W] (the
    pending token, then the W - 1 drafts), the request's ``seed`` and
    ``hist`` (the live length L) as ints. Returns ``(tokens [W] int64,
    accept)``: the target policy's token at every window position, keyed
    ``decoding_key(seed, L + i + 1)`` when sampling (the keys on the
    host, as the decode step's), and the count of leading drafts equal to
    it (``tokens[i] == window[i + 1]``). The caller emits
    ``tokens[:accept + 1]``."""
    toks, accept = verify_tokens(logits, window, int(seed), int(hist), kind,
                                 temperature, top_k, top_p)
    return toks, int(accept[0])


@register_op("decode_sample")
def _decode_sample(ctx):
    """Logits [N, V], Seed [N], Step [N], optional additive Mask [N, V];
    attributes temperature, top_k, top_p -> Out [N] int64. The keys
    ``decoding_key(seed, step)`` are derived in the op, where the feeds
    lie (the run's device), and never read back."""
    logits = ctx.input("Logits")
    if logits.device.type == "meta":
        return {"Out": torch.empty(logits.shape[:1], dtype=torch.int64,
                                   device="meta")}
    return {"Out": decode_sample(
        logits, ctx.input("Seed"), ctx.input("Step"), ctx.input("Mask"),
        temperature=ctx.attr("temperature", 1.0),
        top_k=ctx.attr("top_k", 0), top_p=ctx.attr("top_p", 1.0))}


@register_op("decode_verify")
def _decode_verify(ctx):
    """Logits [1, W, V], Window [1, W], Seed [1], Hist [1]; attributes
    kind, temperature, top_k, top_p -> Tokens [W] int64, Accept [1]
    int32 (:func:`verify_tokens`)."""
    logits, window = ctx.input("Logits"), ctx.input("Window")
    w = window.numel()
    if logits.device.type == "meta":
        return {"Tokens": torch.empty(w, dtype=torch.int64, device="meta"),
                "Accept": torch.empty(1, dtype=torch.int32, device="meta")}
    toks, accept = verify_tokens(
        logits, window, ctx.input("Seed"), ctx.input("Hist"),
        ctx.attr("kind", "greedy"), ctx.attr("temperature", 1.0),
        ctx.attr("top_k", 0), ctx.attr("top_p", 1.0))
    return {"Tokens": toks, "Accept": accept}
