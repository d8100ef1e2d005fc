"""Control-flow layers of the program front end (reference
``paddle_tpu/layers/control_flow.py``): ``StaticRNN``, ``While``,
``cond``, the compares and ``recompute``, each building a sub-block and
the op that runs it (``ops/control_flow_ops.py``); and ``Print``, over
the ``print`` op (``ops/misc_ops.py``)."""

import contextlib

from ..core import unique_name
from ..core.executor import EMPTY_VAR
from ..layer_helper import LayerHelper

__all__ = ["StaticRNN", "While", "cond", "less_than", "equal",
           "greater_than", "Print", "recompute"]


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


class StaticRNN:
    """An RNN unrolled over time, built as a sub-block (reference
    StaticRNN / recurrent_group). Usage::

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)          # x: [N, T, D]
            h_prev = rnn.memory(init=h0)     # h0: [N, H]
            h = layers.fc([x_t, h_prev], H, act="tanh")
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()                          # [N, T, H]

    Runs as a loop over time (``ops/control_flow_ops.py``), fully
    differentiable, so append_backward / optimizer.minimize work through
    it.
    """

    def __init__(self, name=None, main_program=None, is_reverse=False):
        self.helper = LayerHelper("static_rnn", name=name,
                                  main_program=main_program)
        self.program = self.helper.main_program
        self._step_inputs = []   # (sub var, outer var)
        self._memories = []      # [prev sub var, init outer var, updated]
        self._outputs = []       # sub vars
        self._out_vars = None
        self._final_vars = None
        self.is_reverse = is_reverse

    @contextlib.contextmanager
    def step(self):
        self.parent_block = self.program.current_block()
        self.sub_block = self.program.create_block()
        yield
        self.program.rollback()
        self._complete()

    def step_input(self, x):
        if x.shape is None or len(x.shape) < 2:
            raise ValueError("step_input needs [batch, time, ...] input")
        var = self.sub_block.create_var(
            name=unique_name.generate("rnn.step_in"),
            shape=(x.shape[0],) + tuple(x.shape[2:]), dtype=x.dtype)
        self._step_inputs.append((var, x))
        return var

    def memory(self, init):
        prev = self.sub_block.create_var(
            name=unique_name.generate("rnn.mem"),
            shape=init.shape, dtype=init.dtype)
        self._memories.append([prev, init, None])
        return prev

    def update_memory(self, mem, new):
        for entry in self._memories:
            if entry[0] is mem:
                entry[2] = new
                return
        raise ValueError("update_memory: %r is not a memory" % mem.name)

    def step_output(self, o):
        self._outputs.append(o)

    output = step_output  # fluid alias

    def _complete(self):
        for prev, init, updated in self._memories:
            if updated is None:
                raise ValueError("memory %r never updated" % prev.name)
        sub_internal = {v.name for v, _ in self._step_inputs}
        sub_internal |= {m[0].name for m in self._memories}
        captured = [n for n in _block_external_reads(self.sub_block)
                    if n not in sub_internal
                    and self.parent_block.has_var(n)]
        helper = self.helper
        out_vars = [self.parent_block.create_var(
            name=unique_name.generate("rnn.out"), dtype=o.dtype)
            for o in self._outputs]
        final_vars = [self.parent_block.create_var(
            name=unique_name.generate("rnn.final"), dtype=m[0].dtype)
            for m in self._memories]
        self.parent_block.append_op(
            type="static_rnn",
            inputs={
                "StepInputs": [x.name for _, x in self._step_inputs],
                "InitStates": [m[1].name for m in self._memories],
                "Captured": captured,
            },
            outputs={"Outputs": [v.name for v in out_vars],
                     "FinalStates": [v.name for v in final_vars]},
            attrs={"sub_block": self.sub_block.idx,
                   "step_input_vars": [v.name for v, _ in
                                       self._step_inputs],
                   "state_vars": [(m[0].name, m[2].name)
                                  for m in self._memories],
                   "output_vars": [o.name for o in self._outputs],
                   "captured_vars": captured,
                   "is_reverse": self.is_reverse})
        self._out_vars = out_vars
        self._final_vars = final_vars

    def __call__(self):
        if len(self._out_vars) == 1:
            return self._out_vars[0]
        return self._out_vars

    def final_states(self):
        return self._final_vars


class While:
    """Run a block until ``cond`` becomes False (reference While /
    while_op). The sub-block must update ``cond`` and may only write vars
    that already exist in the parent (the loop carry). With
    ``max_iters`` the loop is fully differentiable (bounded loop, the
    analog of reference MakeBlockBackward ``framework/backward.cc:353``);
    without it, forward-only (append_backward refuses it).

    Usage::

        i = layers.fill_constant([1], "int32", 0)
        out = layers.fill_constant([4], "float32", 0.0)
        cond = layers.less_than(i, n)
        w = While(cond)
        with w.block():
            ... compute, assign into out/i ...
            layers.assign(layers.less_than(i, n), cond)
    """

    def __init__(self, cond, name=None, main_program=None,
                 max_iters=None):
        """``max_iters``: static iteration bound. When given, the loop
        runs that many steps and finished iterations pass the state
        through, so a While-built RNN trains (and its program captures);
        when None the condition is read on the host each iteration
        (data-dependent trip count, forward-only, never captured)."""
        self.helper = LayerHelper("while", name=name,
                                  main_program=main_program)
        self.cond = cond
        self.max_iters = max_iters
        self.program = self.helper.main_program

    @contextlib.contextmanager
    def block(self):
        self.parent_block = self.program.current_block()
        self.sub_block = self.program.create_block()
        yield
        self.program.rollback()
        self._complete()

    def _complete(self):
        writes = _block_writes(self.sub_block)
        # loop state = written vars that exist in the parent (write-back
        # semantics); sub-block-local temporaries die each iteration
        carried = sorted({n for n in writes
                          if self.parent_block.has_var(n)
                          and not self.sub_block.vars.get(n)}
                         | {self.cond.name})
        captured = [n for n in _block_external_reads(self.sub_block)
                    if n not in set(carried)
                    and self.parent_block.has_var(n)]
        if self.max_iters is not None:
            # The bounded loop is differentiable, so float
            # carries are live gradient paths even when their defining op
            # was a constant fill (fill_constant marks its output
            # stop_gradient=True; as a loop carry it is loop *state*, and
            # append_backward must route cotangents into the while op).
            # Only constant-fill outputs are flipped — a user explicitly
            # freezing a non-constant carry keeps stop_gradient.
            from ..core.backward import _float_like
            const_fills = {"fill_constant", "fill_constant_batch_size_like",
                           "fill_like", "assign_value"}
            const_outs = set()
            blk = self.parent_block  # walk the same ancestor chain var()
            while blk is not None:   # resolves through (nested loops)
                const_outs.update(n for op in blk.ops
                                  if op.type in const_fills
                                  for n in op.output_names())
                blk = blk.parent
            for n in carried:
                v = self.parent_block.var(n)
                if n in const_outs and _float_like(self.parent_block, n):
                    v.stop_gradient = False
        self.parent_block.append_op(
            type="while",
            inputs={"Carried": carried, "Captured": captured},
            outputs={"CarriedOut": carried},
            attrs={"sub_block": self.sub_block.idx,
                   "carried_vars": carried,
                   "captured_vars": captured,
                   "cond_var": self.cond.name,
                   "max_iters": self.max_iters},
            infer_shape=False)


def cond(pred, true_fn, false_fn, name=None, main_program=None):
    """Functional conditional (reference IfElse capability): the
    predicate is read on the host and one branch runs.
    ``true_fn``/``false_fn`` build ops and return a Variable or list of
    Variables (same count/shape/dtype both sides)."""
    helper = LayerHelper("cond", name=name, main_program=main_program)
    program = helper.main_program
    parent = program.current_block()

    true_block = program.create_block()
    t_out = true_fn()
    program.rollback()
    false_block = program.create_block()
    f_out = false_fn()
    program.rollback()

    t_out = t_out if isinstance(t_out, (list, tuple)) else [t_out]
    f_out = f_out if isinstance(f_out, (list, tuple)) else [f_out]
    if len(t_out) != len(f_out):
        raise ValueError("cond branches return different arity")

    captured = []
    for blk in (true_block, false_block):
        for n in _block_external_reads(blk):
            if parent.has_var(n) and n not in captured:
                captured.append(n)
    outs = [parent.create_var(name=unique_name.generate("cond.out"),
                              shape=t.shape, dtype=t.dtype)
            for t in t_out]
    parent.append_op(
        type="cond",
        inputs={"Cond": [pred.name], "Captured": captured},
        outputs={"Out": [o.name for o in outs]},
        attrs={"true_block": true_block.idx,
               "false_block": false_block.idx,
               "true_outputs": [v.name for v in t_out],
               "false_outputs": [v.name for v in f_out],
               "captured_vars": captured},
        infer_shape=False)
    return outs[0] if len(outs) == 1 else outs


def _cmp(op_type, x, y, **kwargs):
    helper = LayerHelper(op_type, **kwargs)
    out = helper.create_tmp_variable("bool", stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]})
    return out


def less_than(x, y, **kwargs):
    return _cmp("less_than", x, y, **kwargs)


def equal(x, y, **kwargs):
    return _cmp("equal", x, y, **kwargs)


def greater_than(x, y, **kwargs):
    return _cmp("greater_than", x, y, **kwargs)


def Print(input, message=None, summarize=20, **kwargs):
    """Print a tensor at every run (the ``print`` op,
    ``ops/misc_ops.py``: ``message: <array>`` on standard output, a read
    back to the host, so the program is neither captured nor exported).
    Returns the input, passed through."""
    helper = LayerHelper("print", **kwargs)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="print", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"message": message or input.name,
                            "summarize": summarize})
    return out


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

