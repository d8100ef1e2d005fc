"""Executor: runs a Block op by op on the card (reference
``paddle_tpu/core/executor.py``).

The reference traces a whole Block into one jitted XLA computation. Here
each op's torch compute runs in turn on the step's tensors, and the
kernels it reaches launch as it runs (B1 under ``conv2d_bn``). What the
reference gets from XLA, this executor does by hand:

* Gradients: a ``vjp_grad`` op (appended by ``backward.py``) names its
  forward op. That forward op runs with autograd recording, on its
  inputs cut from the graphs of earlier ops (only those whose gradient
  some ``vjp_grad`` op writes take part, each through an ``_Input``
  node), and its ``vjp_grad`` op is answered by ``torch.autograd.grad``
  through the recorded graph, from the outputs' edges to the inputs'
  edges: the forward is not run again, neither inputs nor outputs are
  held for the gradient (only what autograd saves is, as under autograd
  alone), and the graph's saved tensors are freed when the gradient is
  taken. Every other op runs under ``torch.no_grad``.
* Memory: each temporary leaves the run's environment after its last
  reader (computed once per program version, with the block's
  persistable reads and writes), as XLA frees a buffer after its last
  use. Only fetches and persistable state outlive their readers.
* State: persistable outputs are written back into the Scope. An update
  op whose output names its input (``momentum``'s ``ParamOut``) writes
  into the scope's tensor in place, the reference's donated buffer,
  unless ``nonfinite_guard`` needs the old value.
* int8 compute: a program armed by ``serving/quant.py``
  ``arm_quant_compute(programs, scope)`` carries its tag in
  ``program._quant_compute``, read at each run as the reference reads
  it; an armed ``mul``, ``matmul`` or ``conv2d`` that is not
  differentiated runs on its int8 weight and the weight's scales
  (``<name>@quant.scale``, read from the scope beside the block's
  state) through ``ops/quant_ops.maybe_quant_compute``: kernel B3 for
  the products on the card.

* Ingest: a feed arriving in its variable's ``wire_dtype`` (uint8
  images, int32 ids) is widened and normalized on the card before the
  first op reads it (``core/ingest.widen``, the reference's prologue);
  a ``PackedBatch`` (one uint8 buffer for the whole batch, staged by
  ``reader/staging.py``) is unpacked on the card by slicing and viewing
  each slot as its dtype, after the executor's stream waits on the
  staging copy's event, and the buffer is dropped once unpacked (the
  reference donates it).

Not ported: the compile cache and AOT (``lower``, ``cache_digest``,
``prime_aot``), ``as_jax_function`` and distribution strategies; each
raises NotImplementedError.
"""

import collections.abc
import contextlib

import numpy as np
import torch
from torch.autograd.graph import get_gradient_edge

from . import ingest as _ingest
from . import registry
from .enforce import EnforceNotMet
from .framework import (Program, Variable, convert_dtype,
                        default_main_program, torch_dtype, RNG_STATE_VAR)
from .scope import global_scope
from .. import config as _config
from ..amp import amp_cast, amp_dtype
from ..ops import quant_ops, random_ops
from ..place import resolve_device

EMPTY_VAR = "@EMPTY@"

__all__ = ["Executor", "EMPTY_VAR", "run_block"]


# the ROADMAP Queue A items that bring what this executor refuses
_AOT = 'ROADMAP Queue A, "The compile cache and AOT"'
_DISTRIBUTION = 'ROADMAP Queue A, "Distribution and the input pipeline"'


def _not_ported(what, item):
    raise NotImplementedError("%s is not ported yet: %s" % (what, item))


def _lookup(env, name, op, block):
    try:
        return env[name]
    except KeyError:
        reader = op.type if op is not None else "<fetch>"
        var = block.var_or_none(name)
        if var is not None and var.persistable:
            raise EnforceNotMet(
                "persistable variable %r read by %r is not initialized in "
                "scope — run the startup program first" % (name, reader))
        raise EnforceNotMet("%r reads undefined variable %r"
                            % (reader, name)) from None


def _arriving_dtype(value):
    """The numpy dtype a feed value arrives in (bfloat16 as
    ``torch.bfloat16``)."""
    dt = getattr(value, "dtype", None)
    if isinstance(dt, torch.dtype):
        return convert_dtype(dt) if dt == torch.bfloat16 else \
            np.dtype(str(dt).replace("torch.", ""))
    return np.dtype(dt) if dt is not None else np.asarray(value).dtype


def _ingest_spec(var, arriving_dtype, packed=False):
    """The prologue step (target_dtype, scale, mean, std) for one feed
    arriving as ``arriving_dtype``, or None when the feed needs no work
    on the card (reference ``_ingest_spec``). Normalize attrs fire ONLY
    for wire-form arrivals: an already-widened (host-normalized) feed
    takes the plain path."""
    if var is None:
        return None
    target = convert_dtype(var.dtype)
    wire = getattr(var, "wire_dtype", None)
    if wire is not None and arriving_dtype == wire:
        norm = getattr(var, "ingest", None) or {}
        return (target, _ingest.canon_norm(norm.get("scale")),
                _ingest.canon_norm(norm.get("mean")),
                _ingest.canon_norm(norm.get("std")))
    if packed and arriving_dtype != target:
        # a packed slot skips the host-side cast, so any residual dtype
        # gap is closed on the card instead
        return (target, None, None, None)
    return None


def _shares(t, buf):
    return t.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()


def _is_float(t):
    return isinstance(t, torch.Tensor) and t.is_floating_point()


class _TraceState:
    """Per-run state shared across the ops of one block execution.

    ``needs_vjp`` maps id(forward op) to its ``vjp_grad`` op;
    ``vjp_cache`` holds, per forward op run so far, the autograd edges
    (``_grad_root``) of its outputs and of the inputs its gradients are
    taken for.
    ``autograd`` (a sub-block run inside a differentiated op, as
    ``recompute_block`` runs one) runs every op in the ambient autograd
    mode instead. ``drops`` maps an op index to the names that leave the
    environment after it. ``nan_guards`` collects per-op finiteness
    predicates under ``check_nan_inf``. ``device`` is where ops without
    inputs (``fill_constant``) put their outputs. ``quant`` is an armed
    program's tag (None otherwise) and ``quant_seen`` the armed ops
    already counted."""

    def __init__(self, needs_vjp=None, nan_guards=None, amp=None,
                 inplace=False, autograd=False, drops=None, device=None,
                 quant=None, quant_seen=None):
        self.device = device
        self.quant = quant
        self.quant_seen = quant_seen if quant_seen is not None else set()
        self.anchor = torch.zeros((), requires_grad=True)
        self.vjp_cache = {}
        self.needs_vjp = needs_vjp or {}
        self.nan_guards = nan_guards
        self.amp = amp
        self.inplace = inplace
        self.autograd = autograd
        self.drops = drops


def _gather_inputs(op, env, block):
    values = {}
    for slot, names in op.inputs.items():
        values[slot] = [None if n == EMPTY_VAR else _lookup(env, n, op, block)
                        for n in names]
    return values


def _write_outputs(op, env, norm_result):
    for slot, names in op.outputs.items():
        vals = norm_result.get(slot, [])
        for i, name in enumerate(names):
            if name == EMPTY_VAR:
                continue
            if i < len(vals) and vals[i] is not None:
                env[name] = vals[i]


def _compute(opdef, op, values, rng_key, block, trace):
    if trace.amp is not None:
        # inside autograd for a differentiated op: the cast's backward
        # brings float32 gradients back to float32 inputs (master weights)
        values = {slot: [amp_cast(op.type, v, trace.amp) for v in lst]
                  for slot, lst in values.items()}
    ctx = registry.ExecContext(op, values, rng_key=rng_key, block=block,
                               trace=trace)
    return registry.normalize_outputs(op, opdef.compute(ctx))


def _execute_forward_op(op, env, block, trace):
    opdef = registry.get_op_def(op.type)
    values = _gather_inputs(op, env, block)
    rng_key = None
    if opdef.needs_rng:
        env[RNG_STATE_VAR], rng_key = random_ops.split(
            _lookup(env, RNG_STATE_VAR, op, block))

    vjp_op = trace.needs_vjp.get(id(op))
    if vjp_op is None:
        mode = contextlib.nullcontext() if trace.autograd \
            else torch.no_grad()
        with mode:
            result = None
            if trace.quant is not None and \
                    op.type in quant_ops.QUANT_COMPUTE_TYPES:
                # before the amp cast, as the reference routes it
                result = quant_ops.maybe_quant_compute(op, values, env,
                                                       trace)
            if result is None:
                result = _compute(opdef, op, values, rng_key, block, trace)
            else:
                result = registry.normalize_outputs(op, result)
        _write_outputs(op, env, result)
        return

    in_slots = registry.flat_input_slots(op)
    wanted = [n != EMPTY_VAR for n in vjp_op.outputs.get("InGrads", [])]
    inputs = []
    with torch.enable_grad():
        for (slot, i), want in zip(in_slots, wanted):
            v = values[slot][i]
            if want and _is_float(v):
                v = values[slot][i] = _Input.apply(v.detach(), trace.anchor)
                inputs.append(_grad_root(v))
            else:
                inputs.append(None)
        result = _compute(opdef, op, values, rng_key, block, trace)
    # an output no gradient reaches (its OutGrads entry is empty) keeps
    # no edge: the edge would hold its node, and what the node saved, to
    # the gradient (softmax_with_cross_entropy's Softmax: the exp node
    # and its [N, V] result)
    has_grad = [n != EMPTY_VAR for n in vjp_op.inputs.get("OutGrads", [])]
    roots = []
    for (slot, i), grad in zip(registry.flat_output_slots(op), has_grad):
        vals = result.get(slot, [])
        val = vals[i] if i < len(vals) else None
        roots.append(_grad_root(val) if grad else None)
        names = op.outputs.get(slot, [])
        if i < len(names) and val is not None and names[i] != EMPTY_VAR:
            env[names[i]] = val.detach()
    trace.vjp_cache[id(op)] = (roots, inputs)


class _Input(torch.autograd.Function):
    """An input of a differentiated op as a node of its own, whose
    gradient the executor takes at the node's edge. The node holds
    nothing of the input (a detached leaf would: autograd keeps a leaf
    alive for its gradient), so the input's memory goes with its last
    reader unless the op's backward saves it, as under autograd alone.
    ``anchor`` is a scalar that requires grad, so the output does."""

    @staticmethod
    def forward(ctx, x, anchor):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, None


def _grad_root(val):
    """What a gradient needs of a tensor in an op's graph: its autograd
    edge, shape, dtype and device; the edge and not the tensor, so the
    tensor's memory is not held for the gradient (autograd saves what
    the backward reads). None for a tensor without a gradient
    (integers, outputs that do not depend on the differentiated
    inputs)."""
    if not isinstance(val, torch.Tensor) or not val.requires_grad:
        return None
    return get_gradient_edge(val), val.shape, val.dtype, val.device


def _execute_vjp_grad(op, env, block, trace):
    fwd_op = op.attrs["fwd_op"]
    entry = trace.vjp_cache.pop(id(fwd_op), None)
    if entry is None:
        raise RuntimeError(
            "vjp_grad for op %r executed before its forward op — backward "
            "ops must follow forward ops in the same block" % fwd_op.type)
    roots, inputs = entry
    sel, cots = [], []
    for root, gname in zip(roots, op.inputs.get("OutGrads", [])):
        # integer outputs take no cotangent; an output without a gradient
        # takes zeros, which autograd assumes for one left out
        if gname == EMPTY_VAR or root is None:
            continue
        edge, shape, dtype, _ = root
        g = _lookup(env, gname, op, block)
        sel.append(edge)
        cots.append(g.to(dtype).reshape(shape))
    live = [r[0] for r in inputs if r is not None]
    grads = torch.autograd.grad(sel, live, cots, allow_unused=True) \
        if sel and live else [None] * len(live)
    grads = iter(grads)
    for root, gname in zip(inputs, op.outputs.get("InGrads", [])):
        if root is None:
            continue
        g = next(grads)
        _, shape, dtype, device = root
        env[gname] = torch.zeros(shape, dtype=dtype, device=device) \
            if g is None else g


def run_block(block, env, trace):
    """Run every op of ``block`` against ``env`` (name -> tensor)."""
    drops = trace.drops
    for i, op in enumerate(block.ops):
        if op.type == "vjp_grad":
            _execute_vjp_grad(op, env, block, trace)
        else:
            _execute_forward_op(op, env, block, trace)
        if trace.nan_guards is not None:
            for name in op.output_names():
                val = env.get(name)
                if _is_float(val):
                    key = "op#%d:%s:%s" % (i, op.type, name)
                    trace.nan_guards[key] = torch.isfinite(val).all()
        if drops:
            for name in drops.get(i, ()):
                env.pop(name, None)


def _block_io(block):
    """Classify persistable reads/writes and rng need for a block."""
    read, written, needs_rng = set(), set(), False
    for op in block.ops:
        if op.type != "vjp_grad":
            if registry.get_op_def(op.type).needs_rng:
                needs_rng = True
        for names in op.inputs.values():
            for n in names:
                if n == EMPTY_VAR:
                    continue
                v = block.var_or_none(n)
                if v is not None and v.persistable and n not in written:
                    read.add(n)
        for names in op.outputs.values():
            for n in names:
                if n == EMPTY_VAR:
                    continue
                v = block.var_or_none(n)
                if v is not None and v.persistable:
                    written.add(n)
    return read, written, needs_rng


class _Plan:
    """What a run of one program version with one fetch list (and int8
    tag) needs: the block's persistable reads and writes (with an armed
    program's scale sidecars, which are not block variables), its RNG
    need, the forward ops that a ``vjp_grad`` op differentiates, and
    after which op each temporary is read for the last time; and the
    armed ops counted so far."""

    def __init__(self, block, fetch_names, quant=None):
        self.read, self.written, self.needs_rng = _block_io(block)
        if quant:
            self.read.update(quant_ops.scale_var_name(n)
                             for n in quant["vars"])
        self.quant_seen = set()
        if self.needs_rng:
            self.written.add(RNG_STATE_VAR)
        self.needs_vjp = {id(op.attrs["fwd_op"]): op for op in block.ops
                          if op.type == "vjp_grad"}
        last = {}
        for i, op in enumerate(block.ops):
            for n in op.input_names() + op.output_names():
                last[n] = i
        keep = set(fetch_names) | self.written | {EMPTY_VAR}
        self.drops = {}
        for n, i in last.items():
            if n not in keep:
                self.drops.setdefault(i, []).append(n)


def _to_numpy(v):
    v = v.detach()
    if v.dtype == torch.bfloat16:  # numpy has no bfloat16
        v = v.float()
    return v.cpu().numpy()


class Executor:
    """Runs Programs. Parity surface: ``fluid.Executor(place).run(...)``
    (reference ``python/paddle/v2/fluid/executor.py:71,126``).

    ``place`` (or ``device``) is the device the program runs on: CUDA
    when neither is given, which raises without a GPU; ``device="cpu"``
    runs on the CPU."""

    def __init__(self, place=None, strategy=None, device=None):
        if strategy is not None:
            _not_ported("A distribution strategy", _DISTRIBUTION)
        self.device = resolve_device(device if device is not None
                                     else place)
        self._cache = {}
        # plans built, as the reference counts compiles: one per
        # (program version, fetch list)
        self._compiles = 0

    def compile_stats(self):
        """``entries`` (live plans) and ``compiles`` (plans ever built)."""
        return {"entries": len(self._cache), "compiles": self._compiles}

    def lower(self, *args, **kwargs):
        _not_ported("Executor.lower (AOT lowering)", _AOT)

    def cache_digest(self, *args, **kwargs):
        _not_ported("The persistent compile cache", _AOT)

    def prime_aot(self, *args, **kwargs):
        _not_ported("AOT executables", _AOT)

    def as_jax_function(self, *args, **kwargs):
        _not_ported("Exporting a program as a function", _AOT)

    def _tensor(self, value, dtype=None):
        if isinstance(value, torch.Tensor):
            return value.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(value), dtype=dtype,
                               device=self.device)

    def _unpack(self, feed, block):
        """{name: tensor} of a PackedBatch on this executor's device:
        the buffer's slots viewed as their wire dtypes, each wire slot
        widened by its variable's ingest attrs. A staged device buffer
        is read on this executor's stream only after the staging copy's
        event, is marked as used by this stream for the caching
        allocator, and is consumed: dropped from the batch, with no
        slot left viewing it (the reference donates it)."""
        buf = feed.buffer
        if buf is None:
            raise RuntimeError("this PackedBatch was consumed by an "
                               "earlier run (its buffer is released once "
                               "unpacked)")
        if isinstance(buf, np.ndarray):
            buf = torch.from_numpy(buf).to(self.device)
        else:
            feed.buffer = None
            if feed.event is not None and buf.is_cuda:
                stream = torch.cuda.current_stream(buf.device)
                stream.wait_event(feed.event)
                buf.record_stream(stream)
            buf = buf.to(self.device)
        out = {}
        views = _ingest.unpack(buf, feed.layout)
        dense = {s.name: s.dtype for s in feed.layout if s.kind == "dense"}
        for name, t in views.items():
            if name in dense:
                spec = _ingest_spec(block.var_or_none(name),
                                    np.dtype(dense[name]), packed=True)
                if spec is not None:
                    t = _ingest.widen(t, *spec)
            # sparse triples arrive in their final wire dtypes
            out[name] = t.clone() if _shares(t, buf) else t
        return out

    def _state(self, scope, name):
        """The scope's tensor of ``name`` on this executor's device; a
        numpy array or a tensor on another device is moved once and
        stored back, so in-place updates land in the scope."""
        v = scope.find_var(name)
        if not isinstance(v, torch.Tensor) or v.device != self.device:
            v = self._tensor(v)
            scope.set_var(name, v)
        return v

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, donate_state=True):
        if program is None:
            program = default_main_program()
        if not isinstance(program, Program):
            raise TypeError("Executor.run expects a Program, got %r"
                            % (program,))
        feed = {} if feed is None else feed
        if not isinstance(feed, (_ingest.PackedBatch,
                                 collections.abc.Mapping)):
            raise TypeError("Executor.run feeds a dict of arrays or a "
                            "PackedBatch, got %r" % type(feed).__name__)
        fetch_list = fetch_list or []
        scope = scope or global_scope()
        block = program.global_block()
        fetch_names = [v.name if isinstance(v, Variable) else v
                       for v in fetch_list]

        check_nan_inf = bool(_config.get_flag("check_nan_inf"))
        nonfinite_guard = bool(_config.get_flag("nonfinite_guard"))
        amp = amp_dtype(_config.get_flag("amp"))
        # an armed program carries its int8 tag (serving/quant.py)
        quant = getattr(program, "_quant_compute", None)

        key = (program._uid, program._version, tuple(fetch_names),
               quant["key"] if quant else None)
        plan = self._cache.get(key)
        if plan is None:
            self._compiles += 1
            plan = self._cache[key] = _Plan(block, fetch_names, quant)

        state_rw, env = {}, {}
        for n in plan.written:
            if scope.has_var(n):
                state_rw[n] = self._state(scope, n)
        for n in plan.read:
            if n not in state_rw and scope.has_var(n):
                env[n] = self._state(scope, n)
            # else: the first reader raises with a clear message
        if plan.needs_rng:
            if not scope.has_var(RNG_STATE_VAR):
                seed = program.random_seed if program.random_seed else 0
                scope.set_var(RNG_STATE_VAR,
                              random_ops.prng_key(seed, self.device))
            state_rw[RNG_STATE_VAR] = self._state(scope, RNG_STATE_VAR)
        env.update(state_rw)
        if isinstance(feed, _ingest.PackedBatch):
            env.update(self._unpack(feed, block))
        else:
            for name, value in _ingest.explode_sparse(feed).items():
                var = block.var_or_none(name)
                spec = _ingest_spec(var, _arriving_dtype(value))
                if spec is not None:
                    env[name] = _ingest.widen(self._tensor(value), *spec)
                else:
                    env[name] = self._tensor(
                        value, torch_dtype(var.dtype) if var is not None
                        else None)

        trace = _TraceState(plan.needs_vjp,
                            nan_guards={} if check_nan_inf else None,
                            amp=amp,
                            inplace=bool(donate_state) and not nonfinite_guard,
                            drops=plan.drops, device=self.device,
                            quant=quant, quant_seen=plan.quant_seen)
        run_block(block, env, trace)
        new_state = {n: env[n] for n in plan.written if n in env}
        fetches = [_lookup(env, n, None, block) for n in fetch_names]
        if nonfinite_guard:
            # a poisoned batch leaves the state as it was; RNG is exempt
            # so a retried batch draws fresh randomness
            ok = torch.ones((), dtype=torch.bool, device=self.device)
            for v in fetches:
                if _is_float(v):
                    ok = ok & torch.isfinite(v).all()
            new_state = {
                n: (v if n == RNG_STATE_VAR or n not in state_rw
                    else torch.where(ok, v, state_rw[n]))
                for n, v in new_state.items()}
        for n, v in new_state.items():
            scope.set_var(n, v)
        if return_numpy:
            fetches = [_to_numpy(v) for v in fetches]
        if trace.nan_guards:
            # Per-op output scan (reference framework/executor.cc:120-128).
            bad = [k for k, ok in trace.nan_guards.items() if not bool(ok)]
            if bad:
                raise FloatingPointError(
                    "NaN/Inf detected in op outputs: %s" % ", ".join(bad))
        return fetches
