"""The control-flow op of the ResNet program (reference
``paddle_tpu/ops/control_flow_ops.py`` ``recompute_block``): gradient
checkpointing over a sub-block, by ``torch.utils.checkpoint``.

The reference's ``static_rnn``, ``while`` and ``cond`` are not ported
yet (ROADMAP Queue A, "RNN and seq2seq configs")."""

import torch
import torch.utils.checkpoint

from ..core.registry import register_op


def _run_sub_block(block, env, parent):
    """Run ``block`` against ``env`` in the ambient autograd mode, with
    the parent run's amp dtype and device."""
    from ..core.executor import _TraceState, run_block
    run_block(block, env, _TraceState(amp=parent.amp, autograd=True,
                                      device=parent.device))


@register_op("recompute_block", skip_eval_shape=True)
def _recompute_block(ctx):
    """Gradient checkpointing over a sub-block: the forward runs
    normally, but only the block's INPUTS are kept for backward, and the
    gradient runs the sub-block again to rebuild its activations
    (``torch.utils.checkpoint``, non-reentrant). The persistable outputs
    of the sub-block (batch-norm running statistics) leave through
    StateOut once: a recomputation's are discarded. Sub-block ops must
    be deterministic (no rng ops)."""
    program = ctx.block.program
    sub = program.blocks[ctx.attr("sub_block")]
    cap_names = ctx.attr("captured_vars")
    out_names = ctx.attr("output_vars")
    state_names = ctx.attr("state_vars") or []  # persistable writes
    trace = ctx.trace

    def fn(*cap):
        env = dict(zip(cap_names, cap))
        _run_sub_block(sub, env, trace)
        return tuple(env[n] for n in out_names) + \
            tuple(env[n] for n in state_names)

    captured = ctx.inputs("Captured")
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in captured):
        res = torch.utils.checkpoint.checkpoint(fn, *captured,
                                                use_reentrant=False)
    else:
        res = fn(*captured)
    return {"Out": list(res[:len(out_names)]),
            "StateOut": list(res[len(out_names):])}
