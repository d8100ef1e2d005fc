"""Control-flow ops over sub-blocks (reference
``paddle_tpu/ops/control_flow_ops.py``): ``static_rnn``, ``while``,
``cond`` and ``recompute_block``.

The reference lowers each to one XLA construct; here each runs its
sub-block's ops in turn on the run's device, in the ambient autograd
mode, so a differentiated op records its whole loop and the executor's
``vjp_grad`` takes the gradient through it:

* ``static_rnn``: a Python loop over the time axis (the reference's
  ``lax.scan``), differentiable.
* ``while`` with ``max_iters``: a loop of exactly ``max_iters`` steps
  whose finished iterations pass the carry through unchanged (the
  reference's bounded ``lax.scan``), differentiable. Without it: the
  condition is read on the host before each iteration, and the loop
  stops when it is false (the reference's ``lax.while_loop``). That read
  is the only way a trip count can depend on the data here; it has no
  gradient (``append_backward`` refuses it, as the reference's
  ``lax.while_loop`` has no transpose rule).
* ``cond``: the predicate is read on the host and one branch runs, as
  ``lax.cond`` runs one; differentiable through that branch.
* ``recompute_block``: gradient checkpointing by
  ``torch.utils.checkpoint``.

Every host read adds one to :data:`HOST_READS` under its op type. The
executor refuses to capture or export a program holding an unbounded
``while`` or a ``cond`` (``core/executor.py``), since a graph would bake
in one trip count or one branch, or a ``print`` (``ops/misc_ops.py``),
whose read a graph would skip. The other loops read nothing back and
capture.

Sub-blocks take the parent run's amp dtype, and a carry is cast back to
its dtype after each step (:func:`pin_carry_dtype`). Under
``check_nan_inf`` the finiteness of each sub-op's outputs is ANDed over
the steps on the device and reported as ``sub<idx>/<key>``, as the
reference does for ``static_rnn``.
"""

import collections

import torch
import torch.utils.checkpoint

from ..core.registry import register_op

__all__ = ["HOST_READS", "run_sub_block", "pin_carry_dtype",
           "host_read_reason", "walk_ops", "is_unbounded_while"]

# host reads of data-dependent control flow, by op type
HOST_READS = collections.Counter()


def run_sub_block(block, env, parent, guards=None):
    """Run ``block`` against ``env`` in the ambient autograd mode, with
    the parent run's amp dtype and device; ``guards`` (a dict) collects
    the per-op finiteness predicates."""
    from ..core.executor import _TraceState, run_block
    run_block(block, env, _TraceState(
        amp=getattr(parent, "amp", None), autograd=True,
        device=getattr(parent, "device", None), nan_guards=guards))


def _wants_guards(ctx):
    return getattr(ctx.trace, "nan_guards", None) is not None


def _and_guards(acc, guards):
    for key, ok in guards.items():
        acc[key] = ok if key not in acc else acc[key] & ok


def _report_guards(ctx, sub, acc):
    for key, ok in acc.items():
        ctx.trace.nan_guards["sub%d/%s" % (sub.idx, key)] = ok


def pin_carry_dtype(new, old):
    """A carry's update cast back to the carry's dtype: an amp cast inside
    a sub-block must not change a loop state's type."""
    if isinstance(old, torch.Tensor) and new.dtype != old.dtype:
        return new.to(old.dtype)
    return new


def _host_bool(t, op_type):
    HOST_READS[op_type] += 1
    return bool(t.reshape(()))


def walk_ops(program, ops):
    """Each op of ``ops`` and, depth first, each op of its sub-blocks
    (a loop's body, a cond's branches, nested to any depth)."""
    for op in ops:
        yield op
        for attr in ("sub_block", "true_block", "false_block"):
            idx = op.attrs.get(attr)
            if isinstance(idx, int) and idx < len(program.blocks):
                yield from walk_ops(program, program.blocks[idx].ops)


def is_unbounded_while(op):
    return op.type == "while" and op.attrs.get("max_iters") is None


def host_read_reason(program, block):
    """Why a run of ``block`` reads data back to the host (an unbounded
    ``while`` or a ``cond`` to decide its control flow, a ``print`` to
    print; in it or in a sub-block of it), or None."""
    for op in walk_ops(program, block.ops):
        if is_unbounded_while(op):
            return ("an unbounded while (no max_iters) reads its condition "
                    "on the host before each iteration")
        if op.type == "cond":
            return "cond reads its predicate on the host to pick a branch"
        if op.type == "print":
            return "print reads its input back to the host at every run"
    return None


def _rnn_infer_shape(op, block):
    """Outputs [B, T, ...] from the step outputs' shapes, final states as
    the updated memories (the reference's shape function)."""
    sub = block.program.blocks[op.attrs["sub_block"]]
    batch, t = -1, None
    for name in op.inputs.get("StepInputs", []):
        v = block.var_or_none(name)
        if v is not None and v.shape is not None and len(v.shape) >= 2:
            batch, t = v.shape[0], v.shape[1]
            break
    for out_name, sub_name in zip(op.outputs.get("Outputs", []),
                                  op.attrs["output_vars"]):
        sv, ov = sub.var_or_none(sub_name), block.var_or_none(out_name)
        if sv is not None and ov is not None and sv.shape is not None:
            ov.shape = (batch, t) + tuple(sv.shape[1:])
            ov.dtype = sv.dtype
    for out_name, (_, upd) in zip(op.outputs.get("FinalStates", []),
                                  op.attrs["state_vars"]):
        sv, ov = sub.var_or_none(upd), block.var_or_none(out_name)
        if sv is not None and ov is not None:
            ov.shape = sv.shape
            ov.dtype = sv.dtype


@register_op("static_rnn", infer_shape=_rnn_infer_shape)
def _static_rnn(ctx):
    sub = ctx.block.program.blocks[ctx.attr("sub_block")]
    step_in_names = ctx.attr("step_input_vars")
    state_vars = ctx.attr("state_vars")        # [(prev, updated)]
    out_names = ctx.attr("output_vars")
    captured = dict(zip(ctx.attr("captured_vars"), ctx.inputs("Captured")))
    xs = ctx.inputs("StepInputs")
    carry = tuple(ctx.inputs("InitStates"))
    t_len = xs[0].shape[1]
    # one unbind a step input: its gradient stacks the steps' gradients
    steps_in = [torch.unbind(x, dim=1) for x in xs]
    steps = range(t_len - 1, -1, -1) if ctx.attr("is_reverse", False) \
        else range(t_len)
    acc = {} if _wants_guards(ctx) else None
    outs = [None] * t_len
    for t in steps:
        env = dict(captured)
        env.update({pv: c for (pv, _), c in zip(state_vars, carry)})
        env.update({n: x[t] for n, x in zip(step_in_names, steps_in)})
        guards = {} if acc is not None else None
        run_sub_block(sub, env, ctx.trace, guards)
        carry = tuple(pin_carry_dtype(env[upd], c)
                      for (_, upd), c in zip(state_vars, carry))
        outs[t] = [env[n] for n in out_names]
        if acc is not None:
            _and_guards(acc, guards)
    if acc is not None:
        _report_guards(ctx, sub, acc)
    return {"Outputs": [torch.stack([o[i] for o in outs], dim=1)
                        for i in range(len(out_names))],
            "FinalStates": list(carry)}


@register_op("while", skip_eval_shape=True)
def _while(ctx):
    """Run the sub-block while the condition var is true. Carried: the
    vars the sub-block writes (and the condition); captured: read-only
    outer vars. With ``max_iters`` the loop runs that many steps and a
    finished one keeps the carry (differentiable); without it the
    condition is read on the host each iteration."""
    sub = ctx.block.program.blocks[ctx.attr("sub_block")]
    carried_names = ctx.attr("carried_vars")
    captured = dict(zip(ctx.attr("captured_vars"), ctx.inputs("Captured")))
    max_iters = ctx.attr("max_iters")
    carry = tuple(ctx.inputs("Carried"))
    cond_idx = carried_names.index(ctx.attr("cond_var"))

    def run_body(carry):
        env = dict(captured)
        env.update(zip(carried_names, carry))
        run_sub_block(sub, env, ctx.trace)
        return tuple(pin_carry_dtype(env[n], c)
                     for n, c in zip(carried_names, carry))

    if max_iters is not None:
        for _ in range(max_iters):
            alive = carry[cond_idx].reshape(()).to(torch.bool)
            new = run_body(carry)
            carry = tuple(torch.where(alive, n, c)
                          for n, c in zip(new, carry))
        return {"CarriedOut": list(carry)}
    while _host_bool(carry[cond_idx], "while"):
        carry = run_body(carry)
    return {"CarriedOut": list(carry)}


@register_op("recompute_block", skip_eval_shape=True)
def _recompute_block(ctx):
    """Gradient checkpointing over a sub-block: the forward runs
    normally, but only the block's INPUTS are kept for backward, and the
    gradient runs the sub-block again to rebuild its activations
    (``torch.utils.checkpoint``, non-reentrant). The persistable outputs
    of the sub-block (batch-norm running statistics) leave through
    StateOut once: a recomputation's are discarded. Sub-block ops must
    be deterministic (no rng ops)."""
    sub = ctx.block.program.blocks[ctx.attr("sub_block")]
    cap_names = ctx.attr("captured_vars")
    out_names = ctx.attr("output_vars")
    state_names = ctx.attr("state_vars") or []  # persistable writes
    trace = ctx.trace

    def fn(*cap):
        env = dict(zip(cap_names, cap))
        run_sub_block(sub, env, trace)
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


@register_op("cond", skip_eval_shape=True)
def _cond(ctx):
    """One of two branch blocks, picked by the predicate read on the
    host. Both branches write the same number of outputs, of matching
    shapes."""
    program = ctx.block.program
    captured = dict(zip(ctx.attr("captured_vars"), ctx.inputs("Captured")))
    if _host_bool(ctx.input("Cond"), "cond"):
        block, names = program.blocks[ctx.attr("true_block")], \
            ctx.attr("true_outputs")
    else:
        block, names = program.blocks[ctx.attr("false_block")], \
            ctx.attr("false_outputs")
    env = dict(captured)
    run_sub_block(block, env, ctx.trace)
    return {"Out": [env[n] for n in names]}
