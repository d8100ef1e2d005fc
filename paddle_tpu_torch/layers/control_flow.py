"""Control-flow layers of the program front end (reference
``paddle_tpu/layers/control_flow.py``): ``recompute``, which wraps a
group of layers in a ``recompute_block`` op over a sub-block
(``ops/control_flow_ops.py``, ``torch.utils.checkpoint``). The
reference's StaticRNN, While, cond and compares are not ported yet
(ROADMAP Queue A, "RNN and seq2seq configs")."""

from ..core import unique_name
from ..core.executor import EMPTY_VAR
from ..layer_helper import LayerHelper

__all__ = ["recompute"]


def _block_external_reads(block):
    """Names read by ``block`` before being written inside it."""
    reads, writes = [], set()
    seen = set()
    for op in block.ops:
        sub_idx = op.attrs.get("sub_block")
        if sub_idx is not None:
            inner = _block_external_reads(block.program.blocks[sub_idx])
            for n in inner:
                if n not in writes and n not in seen:
                    reads.append(n)
                    seen.add(n)
        for n in op.input_names():
            if n != EMPTY_VAR and n not in writes and n not in seen:
                reads.append(n)
                seen.add(n)
        for n in op.output_names():
            if n != EMPTY_VAR:
                writes.add(n)
    return reads


def _block_writes(block):
    writes = set()
    for op in block.ops:
        for n in op.output_names():
            if n != EMPTY_VAR:
                writes.add(n)
    return writes


def recompute(fn, name=None, main_program=None):
    """Gradient checkpointing (rematerialization): run ``fn``'s layers
    with only their INPUTS saved for backward; the gradient recomputes
    the internals (ops/control_flow_ops.py recompute_block ->
    torch.utils.checkpoint). Use around memory-heavy groups (e.g. each
    ResNet residual block) to trade recompute flops for activation
    memory. ``fn`` must be rng-free.

    Returns fn's Variable (or list/tuple of Variables)."""
    helper = LayerHelper("recompute", name=name,
                         main_program=main_program)
    program = helper.main_program
    parent = program.current_block()
    sub = program.create_block()
    out = fn()
    program.rollback()
    outs = list(out) if isinstance(out, (list, tuple)) else [out]

    captured = [n for n in _block_external_reads(sub)
                if parent.has_var(n)]
    # persistable outer vars the sub-block writes (batch_norm running
    # stats, metric states): surfaced as StateOut so the updates
    # escape the checkpointed scope and the executor persists them
    state_writes = []
    for n in _block_writes(sub):
        v = parent.var(n) if parent.has_var(n) else None
        if v is not None and v.persistable:
            state_writes.append(n)
    state_writes = sorted(state_writes)
    new_outs = []
    for v in outs:
        nv = parent.create_var(
            name=unique_name.generate("recompute.out"),
            shape=v.shape, dtype=v.dtype)
        new_outs.append(nv)
    parent.append_op(
        type="recompute_block",
        inputs={"Captured": captured},
        outputs={"Out": [v.name for v in new_outs],
                 "StateOut": state_writes},
        attrs={"sub_block": sub.idx,
               "captured_vars": captured,
               "output_vars": [v.name for v in outs],
               "state_vars": state_writes},
        infer_shape=False)
    return new_outs[0] if len(new_outs) == 1 else new_outs

