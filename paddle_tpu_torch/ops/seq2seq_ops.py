"""The attention-GRU decoder of the seq2seq NMT (reference
``paddle_tpu/ops/seq2seq_ops.py``): teacher-forced decoding for
training, greedy and beam-search generation.

Attention is dot attention over the encoder outputs with a source-length
mask; the cell is the reference's GRU over the concatenated [embedding,
context]. Each decode loop is a Python loop of torch ops on the device
(the reference's ``lax.scan``), the products ``torch.matmul``.

The teacher-forced decoder projects to the vocabulary once, after the
loop: [B, T2, H] @ [H, V] is each step's [B, H] @ [H, V] stacked (every
logit is the same H-term dot product), as one product instead of T2.
Generation projects inside the loop, where the next token needs it.
"""

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .beam_search_ops import (backtrack, beam_step, finalize, init_scores,
                              repeat_rows)


def _attend(h, enc, mask, w_att):
    """h [B, H] decoder state, enc [B, T, H], mask [B, T]: the context
    [B, H]."""
    query = h @ w_att
    scores = torch.matmul(enc, query[:, :, None])[:, :, 0]
    neg = torch.full((), torch.finfo(scores.dtype).min, dtype=scores.dtype,
                     device=scores.device)
    alpha = torch.softmax(torch.where(mask > 0, scores, neg), dim=-1) * mask
    alpha = alpha / torch.clamp(alpha.sum(-1, keepdim=True), min=1e-9)
    return torch.matmul(alpha[:, None, :], enc)[:, 0]


def _gru_cell(x_and_ctx, hp, w_in, w_h, bias):
    """x_and_ctx [B, E+H]: the new hidden state [B, H]."""
    h = hp.shape[-1]
    gates_x = x_and_ctx @ w_in + bias
    g = gates_x[:, :2 * h] + hp @ w_h[:, :2 * h]
    u, r = torch.chunk(torch.sigmoid(g), 2, dim=-1)
    c = torch.tanh(gates_x[:, 2 * h:] + (r * hp) @ w_h[:, 2 * h:])
    return (1.0 - u) * hp + u * c


class _Inputs:
    """The decoder's inputs from an op's context."""

    def __init__(self, ctx):
        self.enc = ctx.input("EncOut")
        self.mask = ctx.input("EncMask").to(self.enc.dtype)
        self.h0 = ctx.input("H0")
        self.w_in, self.w_h = ctx.input("WIn"), ctx.input("WH")
        self.bias = ctx.input("Bias").reshape(-1)
        self.w_att = ctx.input("WAtt")
        self.w_out = ctx.input("WOut")
        b_out = ctx.input("BOut")
        self.b_out = b_out.reshape(-1) if b_out is not None else None

    def step(self, x_t, hp, enc, mask):
        c = _attend(hp, enc, mask, self.w_att)
        return _gru_cell(torch.cat([x_t, c], dim=-1), hp, self.w_in,
                         self.w_h, self.bias)

    def project(self, h):
        logit = h @ self.w_out
        return logit + self.b_out if self.b_out is not None else logit


@register_op("attention_gru_decoder")
def _attention_gru_decoder(ctx):
    """Teacher-forced decoding. EncOut [B, T, H], EncMask [B, T], TrgEmb
    [B, T2, E], H0 [B, H], WIn [E+H, 3H], WH [H, 3H], Bias [3H], WAtt
    [H, H], WOut [H, V] (+ BOut [V]) -> Logits [B, T2, V], Hidden
    [B, T2, H]."""
    p = _Inputs(ctx)
    hp, hs = p.h0, []
    # one unbind: its gradient stacks the steps' gradients
    for x_t in torch.unbind(ctx.input("TrgEmb"), dim=1):
        hp = p.step(x_t, hp, p.enc, p.mask)
        hs.append(hp)
    hidden = torch.stack(hs, dim=1)
    return {"Logits": p.project(hidden), "Hidden": hidden}


@register_op("attention_gru_greedy_decode")
def _attention_gru_greedy_decode(ctx):
    """Greedy generation, the argmax token fed back and a row frozen at
    EOS. Inputs as the decoder's plus Embedding [V, E] -> Ids [B,
    max_len] (EOS-padded), Length [B]."""
    p = _Inputs(ctx)
    emb = ctx.input("Embedding")
    max_len = ctx.attr("max_len", 32)
    bos, eos = ctx.attr("bos_id", 0), ctx.attr("eos_id", 1)
    b, dev = p.enc.shape[0], p.enc.device
    eos_t = torch.full((), eos, dtype=torch.int32, device=dev)
    hp = p.h0
    tok = torch.full((b,), bos, dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    ids = []
    for _ in range(max_len):
        h_new = p.step(F.embedding(tok.long(), emb), hp, p.enc, p.mask)
        nxt = torch.argmax(p.project(h_new), dim=-1).to(torch.int32)
        nxt = torch.where(done, eos_t, nxt)
        hp = torch.where(done[:, None], hp, h_new)
        done = done | (nxt == eos)
        tok = nxt
        ids.append(nxt)
    ids = torch.stack(ids, dim=1)
    return {"Ids": ids,
            "Length": torch.sum(ids != eos, dim=1).to(torch.int32)}


@register_op("attention_gru_beam_decode")
def _attention_gru_beam_decode(ctx):
    """Beam-search generation over the beam core of
    ``beam_search_ops.py`` (frozen EOS beams, backtracking, best first by
    the length-averaged score): Ids [B, max_len], Length [B], Scores [B]
    of each source's best beam."""
    p = _Inputs(ctx)
    emb = ctx.input("Embedding")
    max_len = ctx.attr("max_len", 32)
    k = ctx.attr("beam_size", 4)
    bos, eos = ctx.attr("bos_id", 0), ctx.attr("eos_id", 1)
    b, dev = p.enc.shape[0], p.enc.device
    enc = repeat_rows(p.enc, k)
    mask = repeat_rows(p.mask, k)
    h = repeat_rows(p.h0, k)
    tok = torch.full((b * k,), bos, dtype=torch.int32, device=dev)
    scores = init_scores(b, k, p.enc.dtype, dev)
    done = torch.zeros((b, k), dtype=torch.bool, device=dev)
    base = torch.arange(b, device=dev)[:, None] * k
    step_toks, step_pars = [], []
    for _ in range(max_len):
        h_new = p.step(F.embedding(tok.long(), emb), h, enc, mask)
        logp = torch.log_softmax(p.project(h_new), dim=-1)
        scores, parent, token, done = beam_step(scores, logp, done, eos)
        h = h_new[(base + parent).reshape(-1)]
        tok = token.reshape(-1)
        step_toks.append(token)
        step_pars.append(parent)
    seqs = backtrack(torch.stack(step_toks), torch.stack(step_pars))
    seqs, lengths, norm = finalize(seqs, scores, eos, "avg")
    return {"Ids": seqs[:, 0], "Length": lengths[:, 0],
            "Scores": norm[:, 0]}
