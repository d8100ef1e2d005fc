"""Beam search (reference ``paddle_tpu/ops/beam_search_ops.py``): the
one-step ``beam_search`` op, the backtracking ``beam_search_decode`` op,
and ``dynamic_beam_search``, which runs a step sub-block (any decoder)
for ``max_len`` steps.

Ended beams are FROZEN, as in the reference: an ended beam keeps its
slot but can only emit EOS at log-prob 0, so its score stays and it
never spawns new prefixes; other tokens of a frozen beam score
``NEG_INF`` = -1e9 (a finite constant: ``-inf`` would make NaNs in
``score + logp``).

Ties are broken as the reference breaks them: the top ``K`` of [B, K*V]
is a stable descending sort sliced, equal values lowest index first as
``lax.top_k`` returns them (``torch.topk`` promises no order among ties
on the card), and the final ranking is a stable ``argsort`` as
``jnp.argsort``'s.

The search runs on the device with no read back to the host, so a
program holding it captures. At the last step the history write of the
column past the end is skipped, as the reference's ``.at[:, t + 1]``
drops it.
"""

import torch

from ..core.registry import register_op
from .control_flow_ops import pin_carry_dtype, run_sub_block

__all__ = ["NEG_INF", "beam_step", "backtrack", "finalize", "init_scores",
           "repeat_rows"]

NEG_INF = -1e9


def repeat_rows(x, k):
    """Each row of ``x`` repeated ``k`` times, the copies adjacent
    (``jnp.repeat(x, k, axis=0)``), by a view and one copy: nothing is
    read back to size the output."""
    return x[:, None].expand((x.shape[0], k) + tuple(x.shape[1:])) \
        .reshape((x.shape[0] * k,) + tuple(x.shape[1:]))


def top_k_stable(x, k):
    """(values, indices) of the ``k`` largest entries of each row of
    ``x`` [B, N], equal values lowest index first (``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def beam_step(scores, logp, done, eos_id):
    """One beam expansion. scores [B, K] cumulative log-probs, logp
    [B*K, V] this step's log-probs, done [B, K] bool. Returns (new_scores
    [B, K], parent [B, K] int32, token [B, K] int32, new_done [B, K])."""
    b, k = scores.shape
    v = logp.shape[-1]
    # made by a select on the device: a Python scalar stored into a
    # tensor is a copy from the host, which a captured step cannot hold
    eos_only = torch.where(
        torch.arange(v, device=logp.device) == eos_id,
        torch.zeros((), dtype=logp.dtype, device=logp.device),
        torch.full((), NEG_INF, dtype=logp.dtype, device=logp.device))
    logp = torch.where(done.reshape(-1)[:, None], eos_only[None, :], logp)
    cand = (scores.reshape(-1)[:, None] + logp).reshape(b, k * v)
    new_scores, top_idx = top_k_stable(cand, k)
    parent = torch.div(top_idx, v, rounding_mode="floor").to(torch.int32)
    token = (top_idx % v).to(torch.int32)
    parent_done = torch.gather(done, 1, parent.long())
    return new_scores, parent, token, parent_done | (token == eos_id)


def backtrack(step_tokens, step_parents):
    """Walk per-step (token, parent) arrays [L, B, K] back into sequences
    [B, K, L]: for the beam ending in slot k at step L-1, its path."""
    steps, b, k = step_tokens.shape
    nxt = torch.arange(k, device=step_tokens.device)[None, :].expand(b, k)
    toks = [None] * steps
    for t in range(steps - 1, -1, -1):
        toks[t] = torch.gather(step_tokens[t], 1, nxt)
        nxt = torch.gather(step_parents[t], 1, nxt).long()
    return torch.stack(toks, dim=2)


def finalize(seqs, scores, eos_id, length_penalty):
    """Lengths (tokens before the first EOS), the length-normalized
    scores, and the beams sorted best first: seqs [B, K, L], scores
    [B, K] -> (seqs, lengths int32, norm)."""
    lengths = torch.sum(torch.cumsum((seqs == eos_id).to(torch.int32),
                                     dim=-1) == 0, dim=-1).to(torch.int32)
    if length_penalty == "avg":
        norm = scores / torch.clamp(lengths.to(scores.dtype), min=1.0)
    else:
        norm = scores
    order = torch.argsort(-norm, dim=1, stable=True)
    seqs = torch.gather(seqs, 1, order[:, :, None].expand(seqs.shape))
    return seqs, torch.gather(lengths, 1, order), torch.gather(norm, 1, order)


def init_scores(batch, beam_size, dtype=torch.float32, device=None):
    """[B, K] start scores: only beam 0 is live."""
    row = torch.where(torch.arange(beam_size, device=device) == 0,
                      torch.zeros((), dtype=dtype, device=device),
                      torch.full((), NEG_INF, dtype=dtype, device=device))
    return row[None, :].expand(batch, beam_size).contiguous()


def _beam_search_infer(op, block):
    """The [B, K] outputs take PreScores' shape (the B*K rows of the
    logits cannot be related to B when B is unknown)."""
    import numpy as np
    pre = block.var_or_none(op.inputs["PreScores"][0])
    if pre is None or pre.shape is None:
        return
    for slot, dtype in (("Scores", "float32"), ("Parent", "int32"),
                        ("Token", "int32"), ("DoneOut", "bool")):
        names = op.outputs.get(slot) or []
        v = block.var_or_none(names[0]) if names else None
        if v is not None:
            v.shape = tuple(pre.shape)
            v.dtype = np.dtype(dtype)


@register_op("beam_search", infer_shape=_beam_search_infer)
def _beam_search(ctx):
    """One step (the reference's ``beam_search`` op contract): PreScores
    [B, K], Logits [B*K, V] (log-softmaxed unless ``is_log_prob``), Done
    [B, K] -> Scores, Parent, Token, DoneOut."""
    logits = ctx.input("Logits")
    if not ctx.attr("is_log_prob", False):
        logits = torch.log_softmax(logits, dim=-1)
    new_scores, parent, token, new_done = beam_step(
        ctx.input("PreScores"), logits, ctx.input("Done").to(torch.bool),
        ctx.attr("eos_id", 1))
    return {"Scores": new_scores, "Parent": parent, "Token": token,
            "DoneOut": new_done}


@register_op("beam_search_decode")
def _beam_search_decode(ctx):
    """StepTokens and StepParents [L, B, K], FinalScores [B, K] -> Ids
    [B, K, L] (EOS-padded), Length [B, K], Scores [B, K], beams sorted
    best first."""
    seqs = backtrack(ctx.input("StepTokens"), ctx.input("StepParents"))
    seqs, lengths, norm = finalize(
        seqs, ctx.input("FinalScores"), ctx.attr("eos_id", 1),
        ctx.attr("length_penalty", "avg"))
    return {"Ids": seqs, "Length": lengths, "Scores": norm}


def _sample_step(ctx, logits, logp, scores, done, t, k, eos):
    """``decode="sample"``: one sampled token a row (K == 1) under the
    serving tier's key schedule: the token written to history column
    t + 1 sits at sequence index t + 1, so its key is
    ``decoding_key(seed, t + 1)``, derived on the device."""
    from .decoding_ops import sample_from_logits
    n, dev = logits.shape[0], logits.device
    seeds = torch.full((n,), ctx.attr("sample_seed", 0), dtype=torch.int64,
                       device=dev)
    steps = torch.full((n,), t + 1, dtype=torch.int64, device=dev)
    picked = sample_from_logits(
        logits, seeds, steps, temperature=ctx.attr("temperature", 1.0),
        top_k=ctx.attr("top_k", 0),
        top_p=ctx.attr("top_p", 1.0)).to(torch.int32)
    token = torch.where(done, torch.full((), eos, dtype=torch.int32,
                                         device=dev), picked.reshape(-1, k))
    gain = torch.gather(logp, 1, token.reshape(-1, 1).long()).reshape(-1, k)
    new_scores = scores + torch.where(done, torch.zeros_like(gain), gain)
    return new_scores, torch.zeros_like(token), token, \
        done | (token == eos)


@register_op("dynamic_beam_search", skip_eval_shape=True)
def _dynamic_beam_search(ctx):
    """Beam search over a step SUB-BLOCK: (token [N] int32, optional
    position [1] int32, optional history [N, max_len] int32, states...)
    -> (logits [N, V], updated states...), N = batch * beam_size. The
    initial states are tiled per beam, every updated state is gathered
    by parent after each step, and the recorded steps are backtracked.
    States the sub-block never updates (encoder outputs) are tiled once
    and not gathered."""
    sub = ctx.block.program.blocks[ctx.attr("sub_block")]
    token_var = ctx.attr("token_var")
    pos_var = ctx.attr("pos_var")
    hist_var = ctx.attr("hist_var")
    logits_var = ctx.attr("logits_var")
    state_vars = ctx.attr("state_vars")
    k = ctx.attr("beam_size", 4)
    steps = ctx.attr("max_len", 32)
    bos = ctx.attr("bos_id", 0)
    eos = ctx.attr("eos_id", 1)
    sample = ctx.attr("decode", "beam") == "sample"

    captured = dict(zip(ctx.attr("captured_vars"), ctx.inputs("Captured")))
    init_states = ctx.inputs("InitStates")
    b = init_states[0].shape[0]
    dev = init_states[0].device
    const_env, dyn_vars, states = {}, [], []
    for (prev, upd), s in zip(state_vars, init_states):
        tiled = repeat_rows(s, k)
        if prev == upd:
            const_env[prev] = tiled
        else:
            dyn_vars.append((prev, upd))
            states.append(tiled)

    tok = torch.full((b * k,), bos, dtype=torch.int32, device=dev)
    scores = init_scores(b, k, device=dev)
    done = torch.zeros((b, k), dtype=torch.bool, device=dev)
    hist = None
    if hist_var:
        cols = torch.arange(steps, device=dev)[None, :].expand(b * k, steps)
        hist = torch.where(cols == 0,
                           torch.full((), bos, dtype=torch.int32, device=dev),
                           torch.full((), eos, dtype=torch.int32, device=dev))
    base = torch.arange(b, device=dev)[:, None] * k
    step_toks, step_pars = [], []
    for t in range(steps):
        env = dict(captured)
        env.update(const_env)
        env[token_var] = tok
        if pos_var:
            env[pos_var] = torch.full((1,), t, dtype=torch.int32,
                                      device=dev)
        if hist_var:
            env[hist_var] = hist
        env.update({prev: s for (prev, _), s in zip(dyn_vars, states)})
        run_sub_block(sub, env, ctx.trace)
        logits = env[logits_var]
        logp = torch.log_softmax(logits, dim=-1)
        if sample:
            scores, parent, token, done = _sample_step(
                ctx, logits, logp, scores, done, t, k, eos)
        else:
            scores, parent, token, done = beam_step(scores, logp, done, eos)
        flat_src = (base + parent).reshape(-1)
        states = [pin_carry_dtype(env[upd][flat_src], s)
                  for (_, upd), s in zip(dyn_vars, states)]
        tok = token.reshape(-1)
        if hist_var and t + 1 < steps:
            # the last step's column t + 1 is past the end: dropped
            hist = hist[flat_src]
            hist[:, t + 1] = tok
        step_toks.append(token)
        step_pars.append(parent)
    seqs = backtrack(torch.stack(step_toks), torch.stack(step_pars))
    seqs, lengths, norm = finalize(seqs, scores, eos,
                                   ctx.attr("length_penalty", "avg"))
    return {"Ids": seqs, "Length": lengths, "Scores": norm}
