"""Sequence layers of the program front end (reference
``paddle_tpu/layers/sequence.py``): ``sequence_mask``, which the LM's
``length`` form needs. The rest are not ported yet (ROADMAP Queue A, "RNN
and seq2seq configs")."""

from ..layer_helper import LayerHelper

__all__ = ["sequence_mask"]


def sequence_mask(length, maxlen, dtype="float32", **kwargs):
    helper = LayerHelper("sequence_mask", **kwargs)
    out = helper.create_tmp_variable(dtype, stop_gradient=True)
    helper.append_op(type="sequence_mask",
                     inputs={"Length": [length.name]},
                     outputs={"Out": [out.name]},
                     attrs={"maxlen": maxlen, "dtype": dtype})
    return out
