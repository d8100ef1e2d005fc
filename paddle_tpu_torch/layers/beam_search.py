"""Beam-search layers (reference ``paddle_tpu/layers/beam_search.py``):
the step op, the decode op, and ``BeamSearchDecoder``, which builds a
per-token step as a sub-block (any layers: GRU, attention, transformer)
run by the ``dynamic_beam_search`` op (``ops/beam_search_ops.py``)."""

import contextlib

from ..core import unique_name
from ..layer_helper import LayerHelper
from .control_flow import _block_external_reads

__all__ = ["beam_search_step", "beam_search_decode", "BeamSearchDecoder"]


def beam_search_step(pre_scores, logits, done, eos_id=1,
                     is_log_prob=False, **kwargs):
    """One beam expansion (reference beam_search_op contract): top-k over
    beam*vocab per source, ended beams frozen. pre_scores/done: [B,K];
    logits: [B*K,V]. Returns (scores, parent, token, done_out)."""
    helper = LayerHelper("beam_search", **kwargs)
    scores = helper.create_tmp_variable("float32", stop_gradient=True)
    parent = helper.create_tmp_variable("int32", stop_gradient=True)
    token = helper.create_tmp_variable("int32", stop_gradient=True)
    done_out = helper.create_tmp_variable("bool", stop_gradient=True)
    helper.append_op(
        type="beam_search",
        inputs={"PreScores": [pre_scores.name], "Logits": [logits.name],
                "Done": [done.name]},
        outputs={"Scores": [scores.name], "Parent": [parent.name],
                 "Token": [token.name], "DoneOut": [done_out.name]},
        attrs={"eos_id": eos_id, "is_log_prob": is_log_prob})
    return scores, parent, token, done_out


def beam_search_decode(step_tokens, step_parents, final_scores, eos_id=1,
                       length_penalty="avg", **kwargs):
    """Backtrack recorded per-step (token, parent) arrays [L,B,K] into
    ranked sequences (reference beam_search_decode_op). Returns
    (ids [B,K,L], length [B,K], scores [B,K]) sorted best-first."""
    helper = LayerHelper("beam_search_decode", **kwargs)
    ids = helper.create_tmp_variable("int32", stop_gradient=True)
    length = helper.create_tmp_variable("int32", stop_gradient=True)
    scores = helper.create_tmp_variable("float32", stop_gradient=True)
    helper.append_op(
        type="beam_search_decode",
        inputs={"StepTokens": [step_tokens.name],
                "StepParents": [step_parents.name],
                "FinalScores": [final_scores.name]},
        outputs={"Ids": [ids.name], "Length": [length.name],
                 "Scores": [scores.name]},
        attrs={"eos_id": eos_id, "length_penalty": length_penalty})
    return ids, length, scores


class BeamSearchDecoder:
    """Beam search over a user-built step block (any decoder model).

    Usage::

        bs = BeamSearchDecoder(beam_size=4, max_len=32, bos_id=0, eos_id=1)
        with bs.step():
            tok = bs.token()              # [N] int32, N = batch*beam
            h_prev = bs.state(h0)         # [B,H] tiled to [N,H]
            emb = layers.embedding(tok, ...)
            h = <any layers>(emb, h_prev, ...)
            bs.update_state(h_prev, h)
            bs.set_logits(layers.fc(h, V))
        ids, lengths, scores = bs()       # best beam per source

    Optional step inputs: ``bs.position()`` — [1] int32 current step;
    ``bs.history()`` — [N, max_len] int32 tokens so far (EOS-padded,
    maintained by the op; for transformer-style full-context steps).
    States never passed to ``update_state`` are carried unchanged
    (encoder outputs etc. — tiled per beam once).
    """

    def __init__(self, beam_size=4, max_len=32, bos_id=0, eos_id=1,
                 length_penalty="avg", name=None, main_program=None,
                 decode="beam", sample_seed=0, temperature=1.0,
                 top_k=0, top_p=1.0):
        if decode not in ("beam", "sample"):
            raise ValueError("decode must be 'beam' or 'sample', got "
                             "%r" % (decode,))
        if decode == "sample" and beam_size != 1:
            raise ValueError("decode='sample' needs beam_size=1 (one "
                             "sampled trajectory per source)")
        self.helper = LayerHelper("beam_search_decoder", name=name,
                                  main_program=main_program)
        self.program = self.helper.main_program
        self.decode = decode
        self.sample_seed = int(sample_seed)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.beam_size = beam_size
        self.max_len = max_len
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.length_penalty = length_penalty
        self._token = None
        self._pos = None
        self._hist = None
        self._states = []    # [sub prev var, outer init var, updated var]
        self._logits = None
        self._outs = None

    @contextlib.contextmanager
    def step(self):
        self.parent_block = self.program.current_block()
        self.sub_block = self.program.create_block()
        yield
        self.program.rollback()
        self._complete()

    def token(self):
        if self._token is None:
            self._token = self.sub_block.create_var(
                name=unique_name.generate("beam.token"), shape=(-1,),
                dtype="int32")
        return self._token

    def position(self):
        if self._pos is None:
            self._pos = self.sub_block.create_var(
                name=unique_name.generate("beam.pos"), shape=(1,),
                dtype="int32")
        return self._pos

    def history(self):
        if self._hist is None:
            self._hist = self.sub_block.create_var(
                name=unique_name.generate("beam.hist"),
                shape=(-1, self.max_len), dtype="int32")
        return self._hist

    def state(self, init):
        prev = self.sub_block.create_var(
            name=unique_name.generate("beam.state"), shape=init.shape,
            dtype=init.dtype)
        self._states.append([prev, init, None])
        return prev

    def update_state(self, prev, new):
        for entry in self._states:
            if entry[0] is prev:
                entry[2] = new
                return
        raise ValueError("update_state: %r is not a state" % prev.name)

    def set_logits(self, logits):
        self._logits = logits

    def _complete(self):
        if self._token is None:
            raise ValueError("step block never called token()")
        if self._logits is None:
            raise ValueError("step block never called set_logits()")
        internal = {self._token.name}
        if self._pos is not None:
            internal.add(self._pos.name)
        if self._hist is not None:
            internal.add(self._hist.name)
        internal |= {s[0].name for s in self._states}
        captured = [n for n in _block_external_reads(self.sub_block)
                    if n not in internal and self.parent_block.has_var(n)]
        K, L = self.beam_size, self.max_len
        init0 = self._states[0][1] if self._states else None
        batch = init0.shape[0] if init0 is not None and init0.shape else -1
        mk = self.parent_block.create_var
        ids = mk(name=unique_name.generate("beam.ids"),
                 shape=(batch, K, L), dtype="int32", stop_gradient=True)
        length = mk(name=unique_name.generate("beam.len"),
                    shape=(batch, K), dtype="int32", stop_gradient=True)
        scores = mk(name=unique_name.generate("beam.scores"),
                    shape=(batch, K), dtype="float32", stop_gradient=True)
        if not self._states:
            raise ValueError("beam search needs at least one state() to "
                             "size the batch")
        self.parent_block.append_op(
            type="dynamic_beam_search",
            inputs={"InitStates": [s[1].name for s in self._states],
                    "Captured": captured},
            outputs={"Ids": [ids.name], "Length": [length.name],
                     "Scores": [scores.name]},
            attrs={"sub_block": self.sub_block.idx,
                   "token_var": self._token.name,
                   "pos_var": self._pos.name if self._pos else None,
                   "hist_var": self._hist.name if self._hist else None,
                   "logits_var": self._logits.name,
                   "state_vars": [(s[0].name,
                                   (s[2] or s[0]).name) for s in
                                  self._states],
                   "captured_vars": captured,
                   "beam_size": K, "max_len": L,
                   "bos_id": self.bos_id, "eos_id": self.eos_id,
                   "length_penalty": self.length_penalty,
                   "decode": self.decode,
                   "sample_seed": self.sample_seed,
                   "temperature": self.temperature,
                   "top_k": self.top_k, "top_p": self.top_p},
            infer_shape=False)
        self._outs = (ids, length, scores)

    def __call__(self, return_all_beams=False):
        """Returns (ids, length, scores): best beam ([B,L],[B],[B]) or all
        beams sorted best-first ([B,K,L],[B,K],[B,K])."""
        ids, length, scores = self._outs
        if return_all_beams:
            return ids, length, scores
        # beams are sorted best-first: beam 0 slice is the argmax beam
        from .tensor import slice as _slice, reshape as _reshape
        best_ids = _reshape(_slice(ids, [1], [0], [1]),
                            [-1, self.max_len])
        best_len = _reshape(_slice(length, [1], [0], [1]), [-1])
        best_scores = _reshape(_slice(scores, [1], [0], [1]), [-1])
        return best_ids, best_len, best_scores
