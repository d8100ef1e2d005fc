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

* The step cache (reference ``_CacheEntry``): each run resolves one cache
  entry, keyed as the reference keys it: program uid and version, the
  feed signature, fetch names, donation, the strategy's uid,
  ``check_nan_inf``, ``amp``, the ``matmul_precision`` flag (applied
  around each run, ``config.resolve_matmul_precision``),
  ``nonfinite_guard``, the ingest specs, the embedding flags of a program
  with a distributed table and the int8 tag. The reference's
  ``flash_attention`` flag is not part of the key: the port has no such
  flag (``config.py``). ``compile_stats()``
  counts one compile per key. Forward programs (no ``vjp_grad`` op) have
  executables:

  - on the card, a CUDA graph: the entry's first run executes op by op,
    which warms it; its second captures its step into a
    ``torch.cuda.CUDAGraph`` (one memory pool for each executor), with the
    feeds in static buffers and the scope's state at the addresses it
    has; written state is copied into the scope's own tensors inside the
    graph. That run and every later one copy their feeds in and replay
    the graph (a program run once, a startup, is never captured). A run
    whose scope holds other state
    tensors than the capture read (a weight swap installs new ones, a
    load replaces them) recaptures, counted in ``compile_stats`` as a
    recompile; a run on another scope (a swap's canary) runs op by op and
    leaves the graph alone. A replay adds the kernel launches its capture
    counted (``ops/launches.py``), and the graph keeps the scratch its
    kernels baked in (``ops/_build.capture_buffers``). A capture that
    fails (an op that waits on the host) logs ``executor_capture_failed``
    and the entry runs op by op from then on.
  - ``lower`` exports the step as a ``torch.export.ExportedProgram``, the
    state as inputs (so it does not depend on the weights, as the
    reference's executables do not), the kernels as ``paddle_tpu_torch::``
    torch ops. With ``compile_cache_dir`` set, ``run`` loads the entry's
    program from disk (``core/compile_cache.py``) or exports and stores
    it, and executes it: its module on the CPU, its module captured on
    the card. ``prime_aot`` installs a program from a serving artifact's
    ``compiled/`` index, gated by ``cache_digest``. A call that no longer
    fits the program's inputs marks it failed for good, and the entry
    runs op by op from then on.
  - Training programs (a ``vjp_grad`` op: ``torch.autograd.grad`` cannot
    be exported or captured) run op by op, store nothing
    (``aot_export_skipped``) and capture nothing.
  - A program that decides its control flow on the host (an unbounded
    ``while``, a ``cond``: ``ops/control_flow_ops.py``) or prints (a
    ``print`` op) is refused capture and export when its plan is made,
    since a graph would bake in one trip count or one branch, or skip
    the print: it runs op by op,
    ``capture_stats()`` counts it as ``refused`` with the reason,
    ``lower`` raises, and an export the flags ask for logs
    ``aot_export_skipped`` with the reason. Bounded loops,
    ``static_rnn`` and the decoders read nothing back and capture.

  Under the ``telemetry`` flag an entry of a forward program is exported
  at its second run (a program run once, a startup, is not), and the
  reference's ``paddle_executor_*`` families count
  cache hits and misses, the export's seconds (``_trace_seconds``), the
  capture's (``_compile_seconds``), and the exported graph's operations
  (``_step_flops``, ``torch.utils.flop_counter``) and bytes
  (``_step_bytes``: each call node's operands and results).

* Distribution (``Executor(strategy=DistStrategy)``, ``parallel/``):
  every rank runs the same program on the same global feeds; each keeps
  only its rows of the batch (a ``PackedBatch`` staged under the strategy
  already holds only them) and runs each op on them by its rule in
  ``parallel/spmd.py`` (row-local ops as they are; batch reductions,
  batch-norm statistics and the sparse gradients through collectives on
  the data axis; any other op on the gathered rows). State is stored as
  ``param_rules`` place it: each rank keeps its slice in the scope, the
  step gathers it, and the slice of the new value is written back; a
  distributed embedding table row-sharded by ``embedding_shard_rows``
  stays a local block, read by its lookup and its sparse update only.
  The gradients of state are summed over the data axis at their vjp,
  state a run creates is broadcast from the mesh's first rank, and a
  batch-sharded fetch is gathered, so every rank sees the global value.
  The strategy's uid and, for a program with a distributed table, the
  embedding flags key the cache, as the reference's. A step under a
  strategy is neither captured (its collectives would be baked into a
  graph: ``capture_stats()`` counts it as refused, with the reason) nor
  exported.
"""

import collections
import collections.abc
import contextlib
import itertools
import time
import weakref

import numpy as np
import torch
from torch.autograd.graph import get_gradient_edge
from torch.utils import _pytree as pytree

from . import compile_cache as _compile_cache
from . import ingest as _ingest
from . import registry
from .enforce import EnforceNotMet
from .framework import (Program, Variable, convert_dtype,
                        default_main_program, torch_dtype, RNG_STATE_VAR)
from .scope import global_scope
from .. import config as _config
from ..amp import amp_cast, amp_dtype
from ..observability import metrics as _metrics
from ..observability import tracing as _tracing
from ..ops import _build
from ..ops import launches as _launches
from ..ops import control_flow_ops, quant_ops, random_ops
from .. import parallel as _parallel
from ..parallel import spmd
from ..place import resolve_device
from ..utils import log as _log

EMPTY_VAR = "@EMPTY@"

__all__ = ["Executor", "EMPTY_VAR", "run_block", "CAPTURES"]


# Compile-cache and per-step cost telemetry (the reference's families;
# hooks gated by the telemetry flag)
_CACHE_HITS = _metrics.REGISTRY.counter(
    "paddle_executor_cache_hits_total",
    "Executor.run compile-cache hits")
_CACHE_MISSES = _metrics.REGISTRY.counter(
    "paddle_executor_cache_misses_total",
    "Executor.run compile-cache misses (trace + XLA compile)")
_TRACE_SECONDS = _metrics.REGISTRY.gauge(
    "paddle_executor_trace_seconds",
    "Python block trace + StableHLO lowering wall time per "
    "compile-cache key",
    labelnames=("key",))
_COMPILE_SECONDS = _metrics.REGISTRY.gauge(
    "paddle_executor_compile_seconds",
    "XLA compile wall time per compile-cache key",
    labelnames=("key",))
_STEP_FLOPS = _metrics.REGISTRY.gauge(
    "paddle_executor_step_flops",
    "XLA cost-analysis FLOPs of the cached step (MFU numerator)",
    labelnames=("key",))
_STEP_BYTES = _metrics.REGISTRY.gauge(
    "paddle_executor_step_bytes",
    "XLA cost-analysis bytes accessed of the cached step "
    "(bandwidth-roofline numerator)",
    labelnames=("key",))
# labels must not alias across executors or threads
_KEY_IDS = itertools.count(1)

# process-wide CUDA graph events, for a caller that checks a whole run:
# "captures", "recaptures", "failed" (logged as executor_capture_failed),
# "replays" and "refused" (entries whose control flow is decided on the
# host, or that print)
CAPTURES = collections.Counter()


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
    already counted. ``dist`` is a run's ``parallel.spmd.DistRun`` under
    a strategy (None otherwise)."""

    def __init__(self, needs_vjp=None, nan_guards=None, amp=None,
                 inplace=False, autograd=False, drops=None, device=None,
                 quant=None, quant_seen=None, dist=None):
        self.device = device
        self.dist = dist
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
    if trace.dist is not None:
        return trace.dist.run_op(opdef, op, values, rng_key, block, trace)
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
    dist = trace.dist
    in_names = [fwd_op.inputs[slot][i]
                for slot, i in registry.flat_input_slots(fwd_op)]
    for root, gname, name in zip(inputs, op.outputs.get("InGrads", []),
                                 in_names):
        if root is None:
            continue
        g = next(grads)
        _, shape, dtype, device = root
        g = torch.zeros(shape, dtype=dtype, device=device) \
            if g is None else g
        if dist is not None:
            # an input's gradient takes the input's state; the partial
            # gradient of state is completed over the data axis
            var = block.var_or_none(name)
            if var is not None and var.persistable and \
                    dist.state(name) == "R":
                g = spmd.all_reduce(g, dist.data_group)
            dist.record_names([gname], dist.state(name))
        env[gname] = g


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
    """What the runs of one cache entry need: the block's persistable reads and writes (with an armed
    program's scale sidecars, which are not block variables), its RNG
    need, the forward ops that a ``vjp_grad`` op differentiates, and
    after which op each temporary is read for the last time; and the
    armed ops counted so far."""

    def __init__(self, block, fetch_names, quant=None):
        self.read, self.written, self.needs_rng = _block_io(block)
        # why the step may be neither captured nor exported: control flow
        # decided on the host (an unbounded while, a cond), a print
        self.host_reads = control_flow_ops.host_read_reason(block.program,
                                                            block)
        if quant:
            self.read.update(quant_ops.scale_var_name(n)
                             for n in quant["vars"])
        self.quant_seen = set()
        if self.needs_rng:
            self.written.add(RNG_STATE_VAR)
        # in name order: an exported step's input tree follows it
        self.written_sorted = sorted(self.written)
        self.read_sorted = sorted(self.read)
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


def _step_fn(block, plan, fetch_names, widen, check_nan_inf, amp,
             nonfinite_guard, inplace, quant, device, strategy=None):
    """The step of one cache entry as a function of (state_rw, state_ro,
    feed) -> (new state, fetches, guards): the feeds widened by their
    ingest specs, the block run op by op, then ``nonfinite_guard``'s
    choice between the new and the old state (the RNG key exempt, so a
    retried batch draws fresh randomness). ``ambient`` runs the ops in
    the caller's autograd mode, as an export traces them under one
    ``torch.no_grad``. Under ``strategy``, ``dist`` is the run's
    ``spmd.DistRun`` and the fetches come out global."""
    def fn(state_rw, state_ro, feed, ambient=False, dist=None):
        env = dict(state_ro)
        env.update(state_rw)
        for name, t in feed.items():
            spec = widen.get(name)
            env[name] = t if spec is None else _ingest.widen(t, *spec)
        trace = _TraceState(plan.needs_vjp,
                            nan_guards={} if check_nan_inf else None,
                            amp=amp, inplace=inplace, autograd=ambient,
                            drops=plan.drops, device=device, quant=quant,
                            quant_seen=plan.quant_seen, dist=dist)
        if strategy is not None:
            prev = _parallel.set_current_strategy(strategy)
            try:
                run_block(block, env, trace)
            finally:
                _parallel.set_current_strategy(prev)
        else:
            run_block(block, env, trace)
        new_state = {n: env[n] for n in plan.written_sorted if n in env}
        fetches = [_lookup(env, n, None, block) for n in fetch_names]
        if dist is not None:
            fetches = [dist.fetch(n, v) for n, v in zip(fetch_names,
                                                        fetches)]
        if nonfinite_guard:
            # a poisoned batch leaves the state as it was
            ok = torch.ones((), dtype=torch.bool, device=device)
            for v in fetches:
                if _is_float(v):
                    ok = ok & torch.isfinite(v).all()
            new_state = {
                n: (v if n == RNG_STATE_VAR or n not in state_rw
                    else torch.where(ok, v, state_rw[n]))
                for n, v in new_state.items()}
        return new_state, fetches, trace.nan_guards or {}
    return fn


class _StepModule(torch.nn.Module):
    """An entry's step as the module ``torch.export`` takes: the state a
    step writes in place (a KV cache, an update op's ``ParamOut``) is an
    input mutation of the exported program, not an output; an output
    that is one of the inputs is copied, as an exported program's
    outputs may not alias its inputs."""

    def __init__(self, fn, device):
        super().__init__()
        self._fn = fn
        self._device = device

    def forward(self, state_rw, state_ro, feed):
        new_state, fetches, guards = self._fn(state_rw, state_ro, feed,
                                              ambient=True)
        ins = {id(t) for d in (state_rw, state_ro, feed)
               for t in d.values()}
        new_state = {n: (v.clone() if id(v) in ins else v)
                     for n, v in new_state.items()
                     if v is not state_rw.get(n)}
        fetches = [v.clone() if id(v) in ins else v for v in fetches]
        # a step that only writes state in place (the block copy) still
        # returns one tensor: a program without outputs does not serialize
        empty = not (new_state or fetches or guards)
        return (new_state, fetches, guards,
                [torch.zeros((), device=self._device)] if empty else [])


def _export(fn, args, device):
    """``torch.export`` of the step ``fn`` on ``args`` (state_rw,
    state_ro, feed) on ``device``: non-strict, every op traced under one
    ``torch.no_grad`` (the executor's per-op ``no_grad`` blocks would
    each become a graph region)."""
    with torch.no_grad():
        ep = torch.export.export(_StepModule(fn, device), args,
                                 strict=False)
    # the example inputs are the state itself: neither held (a swap's old
    # weights would stay alive) nor serialized (a blob would carry them)
    ep._example_inputs = None
    return ep


def _aot_signature(ep):
    """(input tree spec, [(shape, dtype, device type)] of each input) of
    an exported step: what a call must fit."""
    names = ep.graph_signature.user_inputs
    vals = {n.name: n.meta.get("val") for n in ep.graph.nodes
            if n.op == "placeholder"}
    return ep.call_spec.in_spec, [
        (tuple(vals[n].shape), vals[n].dtype, vals[n].device.type)
        for n in names]


def _fits(sig, args):
    flat, spec = pytree.tree_flatten((args, {}))
    in_spec, inputs = sig
    return spec == in_spec and len(flat) == len(inputs) and all(
        isinstance(t, torch.Tensor) and tuple(t.shape) == shape
        and t.dtype == dtype and t.device.type == dev
        for t, (shape, dtype, dev) in zip(flat, inputs))


def _cost(ep):
    """(operations, bytes) of an exported step: the FLOPs
    ``FlopCounterMode`` counts running the graph on fake tensors, and the
    bytes of every call node's operands and results (``meta["val"]``),
    XLA's "bytes accessed"."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    nbytes = 0
    for node in ep.graph.nodes:
        if node.op != "call_function":
            continue
        vals = [a.meta.get("val") for a in node.all_input_nodes]
        vals.append(node.meta.get("val"))
        for v in pytree.tree_leaves(vals):
            if isinstance(v, torch.Tensor):
                nbytes += v.numel() * v.element_size()
    vals = {n.name: n.meta["val"] for n in ep.graph.nodes
            if n.op == "placeholder"}
    with FakeTensorMode(allow_non_fake_inputs=True):
        # fake tensors on the step's device: no memory is allocated
        flat = [torch.empty(v.shape, dtype=v.dtype, device=v.device)
                for v in (vals[n] for n in ep.graph_signature.user_inputs)]
        args, kwargs = pytree.tree_unflatten(flat, ep.call_spec.in_spec)
        counter = FlopCounterMode(display=False)
        with counter:
            ep.module()(*args, **kwargs)
    return counter.get_total_flops(), nbytes


class _Entry:
    """One step-cache entry (reference ``_CacheEntry``): the plan and the
    step function of runs with one key, and its executables: ``aot`` an
    ``ExportedProgram`` (exported under telemetry or the persistent
    cache, loaded from disk, or primed from an artifact) with its module
    ``aot_fn`` and input signature ``aot_sig``, and ``graph``, the CUDA
    graph of its step, captured at a run after one op by op
    (``capturable``). ``skey_parts`` is the key minus its process-local
    head (the stable half of the persistent digest), ``pkey`` the digest
    once computed."""

    __slots__ = ("plan", "fn", "key_id", "skey_parts", "pkey", "aot",
                 "aot_fn", "aot_sig", "aot_failed", "graph",
                 "graph_failed", "ran", "capturable")

    def __init__(self, plan, fn, key_id, skey_parts):
        self.plan = plan
        self.fn = fn
        self.key_id = key_id
        self.skey_parts = skey_parts
        self.pkey = None
        self.aot = self.aot_fn = self.aot_sig = None
        self.aot_failed = False
        self.graph = None
        self.graph_failed = False
        # set after each run op by op: that it ran, whether the next run
        # may capture
        self.ran = self.capturable = False

    def install(self, ep):
        self.aot = ep
        self.aot_fn = ep.module()
        self.aot_sig = _aot_signature(ep)
        self.aot_failed = False
        self.graph = None   # the next capture takes the installed program

    def execute(self, args):
        """(new state, fetches, guards) of one run op by op, or through
        the installed program when the call fits it; a call that does not
        fit marks the program failed for good."""
        if self.aot_fn is not None:
            if _fits(self.aot_sig, args):
                return self.aot_fn(*args)[:3]
            _log.structured("aot_call_fallback", key=self.key_id)
            self.aot = self.aot_fn = self.aot_sig = None
            self.aot_failed = True
            self.graph = None
        return self.fn(*args)


class _Graph:
    """An entry's step captured on the card: the graph, the scope whose
    state it reads and writes (weakly), those tensors, the static feed
    buffers, its outputs, the scratch its kernels took, and the launches
    its capture counted."""

    __slots__ = ("graph", "scope", "state", "feed", "fetches", "guards",
                 "buffers", "launches")

    def matches(self, state):
        return len(state) == len(self.state) and all(
            state.get(n) is t for n, t in self.state.items())


class _Call:
    """One resolved run: the entry, its block and fetch names, the scope,
    and the state and feeds the step takes."""

    __slots__ = ("entry", "block", "fetch_names", "scope", "state_rw",
                 "state_ro", "feed", "dist", "placed")

    def __init__(self, entry, block, fetch_names, scope, state_rw,
                 state_ro, feed, dist=None, placed=None):
        self.entry = entry
        # under a strategy: the run's spmd.DistRun, and the index of this
        # rank's slice of each state the step gathered
        self.dist = dist
        self.placed = placed or {}
        self.block = block
        self.fetch_names = fetch_names
        self.scope = scope
        self.state_rw = state_rw
        self.state_ro = state_ro
        self.feed = feed

    @property
    def args(self):
        return self.state_rw, self.state_ro, self.feed


class Executor:
    """Runs Programs. Parity surface: ``fluid.Executor(place).run(...)``
    (reference ``python/paddle/v2/fluid/executor.py:71,126``).

    ``place`` (or ``device``) is the device the program runs on: CUDA
    when neither is given, which raises without a GPU; ``device="cpu"``
    runs on the CPU. ``strategy``: a ``parallel.DistStrategy`` whose
    mesh holds this rank."""

    def __init__(self, place=None, strategy=None, device=None):
        if strategy is not None and not strategy.mesh.in_mesh:
            raise ValueError("rank %d is not in the strategy's mesh %r"
                             % (strategy.mesh.rank, strategy.mesh))
        self.strategy = strategy
        self.device = resolve_device(device if device is not None
                                     else place)
        self._cache = {}
        # entries ever made, and recaptures, as the reference counts
        # compiles and recompiles
        self._compiles = 0
        self._captures = collections.Counter()
        self._refusals = {}          # entry key id -> why not captured
        self._pool = None            # the CUDA graphs' memory pool
        self._capture_stream = None

    def compile_stats(self):
        """Flag-free per-executor compile counters: ``entries`` (live
        cache entries) and ``compiles`` (entries ever made, ``lower``
        included, plus recaptures after the state they read was
        replaced). N distinct (program, feed signature, flags) shapes
        show as exactly N compiles however many steps run."""
        return {"entries": len(self._cache), "compiles": self._compiles}

    def release_graphs(self):
        """Drop every entry's CUDA graph, with the memory and the state
        tensors it holds (a closed session's caches, an engine's
        weights); an entry run again captures anew. Owners call it when
        they close."""
        for entry in self._cache.values():
            entry.graph = None

    def capture_stats(self):
        """This executor's CUDA graph events: ``captures``,
        ``recaptures`` (part of ``captures``), ``failed``, ``replays``,
        and ``refused``, the entries whose plan forbids a capture (a
        step that decides its control flow on the host); when there are
        any, ``refused_reasons`` names why, one reason an entry."""
        stats = {k: self._captures[k] for k in
                 ("captures", "recaptures", "failed", "replays")}
        stats["refused"] = len(self._refusals)
        if self._refusals:
            stats["refused_reasons"] = dict(self._refusals)
        return stats

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

    def _prepare(self, program, feed, fetch_list, scope, donate_state,
                 count_cache=True):
        """The run's cache entry, made on a miss, with its state and
        feeds (reference ``_prepare``)."""
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

        # an armed program carries its int8 tag (serving/quant.py)
        quant = getattr(program, "_quant_compute", None)
        # the feeds as tensors on the device, in their names' order (an
        # exported step's input tree follows it); a wire-dtype feed stays
        # narrow and is widened inside the step
        widen, feeds = {}, {}
        if isinstance(feed, _ingest.PackedBatch):
            packed = ("@packed@",) + feed.signature()
            feeds = self._unpack(feed, block)
        else:
            packed = None
            for name, value in _ingest.explode_sparse(feed).items():
                var = block.var_or_none(name)
                spec = _ingest_spec(var, _arriving_dtype(value))
                if spec is not None:
                    widen[name] = spec
                    feeds[name] = self._tensor(value)
                else:
                    feeds[name] = self._tensor(
                        value, torch_dtype(var.dtype) if var is not None
                        else None)
        feeds = {n: feeds[n] for n in sorted(feeds)}
        sharded = ()
        if self.strategy is not None:
            if quant is not None:
                raise ValueError("an int8-armed program does not run under "
                                 "a distribution strategy")
            feeds, sharded = self._shard_feeds(feed, feeds)
        feed_sig = tuple((n, tuple(t.shape), str(t.dtype))
                         for n, t in feeds.items())
        if packed is not None:
            feed_sig = (packed,) + feed_sig

        check_nan_inf = bool(_config.get_flag("check_nan_inf"))
        nonfinite_guard = bool(_config.get_flag("nonfinite_guard"))
        amp = amp_dtype(_config.get_flag("amp"))
        precision = _config.resolve_matmul_precision()
        telemetry = bool(_config.get_flag("telemetry"))
        ingest_specs = tuple(sorted((n,) + tuple(spec)
                                    for n, spec in widen.items()))
        # the embedding flags are read only for a program that registered
        # a distributed table (one getattr for any other)
        emb_tables = getattr(program, "_dist_embeddings", None)
        emb_key = None
        if emb_tables:
            emb_key = (bool(_config.get_flag("embedding_shard_rows")),
                       bool(_config.get_flag("embedding_a2a")), telemetry,
                       _config.get_flag("embedding_wire_dtype"))
        # every run-time flag keys the cache (the reference's key, less
        # the flash_attention flag the port does not have)
        key = (program._uid, program._version, feed_sig, tuple(fetch_names),
               bool(donate_state),
               self.strategy._uid if self.strategy is not None else None,
               check_nan_inf, amp, precision, nonfinite_guard, ingest_specs,
               emb_key, quant["key"] if quant else None)
        entry = self._cache.get(key)
        if entry is None:
            self._compiles += 1
            if telemetry and count_cache:
                _CACHE_MISSES.inc()
            plan = _Plan(block, fetch_names, quant)
            fn = _step_fn(block, plan, fetch_names, widen, check_nan_inf, amp,
                          nonfinite_guard,
                          bool(donate_state) and not nonfinite_guard, quant,
                          self.device, self.strategy)
            # key[2:] drops the program's uid and version, which the
            # program's serialized content replaces in the digest
            entry = self._cache[key] = _Entry(plan, fn,
                                              "k%d" % next(_KEY_IDS),
                                              key[2:])
            refusal = plan.host_reads or (
                self.strategy is not None and
                "a step under a distribution strategy runs collectives "
                "on its process groups, which a graph would replay "
                "outside the group's own ordering")
            if refusal:
                # refused when the plan is made, not after a capture fails
                entry.graph_failed = True
                self._refusals[entry.key_id] = refusal
                CAPTURES["refused"] += 1
        elif telemetry and count_cache:
            _CACHE_HITS.inc()
        if entry.pkey is None and self.strategy is None and \
                _config.get_flag("compile_cache_dir"):
            entry.pkey = _compile_cache.entry_digest(
                program, entry.skey_parts, self.device)

        plan = entry.plan
        state_rw, state_ro = {}, {}
        for n in plan.written_sorted:
            if scope.has_var(n):
                state_rw[n] = self._state(scope, n)
        for n in plan.read_sorted:
            if n not in state_rw and scope.has_var(n):
                state_ro[n] = self._state(scope, n)
            # else: the first reader raises with a clear message
        if plan.needs_rng:
            if not scope.has_var(RNG_STATE_VAR):
                seed = program.random_seed if program.random_seed else 0
                scope.set_var(RNG_STATE_VAR,
                              random_ops.prng_key(seed, self.device))
            state_rw[RNG_STATE_VAR] = self._state(scope, RNG_STATE_VAR)
            state_rw = {n: state_rw[n] for n in sorted(state_rw)}
        if self.strategy is None:
            return _Call(entry, block, fetch_names, scope, state_rw,
                         state_ro, feeds)
        dist_rows = None
        if emb_key is not None and emb_key[0]:
            dist_rows = {n: info["padded"] for n, info in emb_tables.items()
                         if n in _row_shardable(entry.plan, block)}
        placed, row_base = {}, {}
        state_rw, state_ro = (
            {n: self._place(scope, block, n, t, dist_rows, placed, row_base)
             for n, t in d.items()} for d in (state_rw, state_ro))
        dist = spmd.DistRun(self.strategy, sharded, row_base)
        return _Call(entry, block, fetch_names, scope, state_rw, state_ro,
                     feeds, dist, placed)

    def global_state(self, scope=None, names=None, program=None):
        """{name: global value} of the persistable state ``names`` (every
        one in ``scope`` by default): under a strategy a slice that this
        rank holds is gathered, which is collective (every rank of the
        mesh calls it with the same names); a value the scope holds
        whole is returned as it is."""
        scope = scope or global_scope()
        names = list(scope.var_names()) if names is None else list(names)
        if self.strategy is None:
            return {n: scope.find_var(n) for n in names if scope.has_var(n)}
        program = program or default_main_program()
        block = program.global_block()
        tables = getattr(program, "_dist_embeddings", None) or {}
        dist_rows = {n: info["padded"] for n, info in tables.items()}
        out = {}
        for n in names:
            if not scope.has_var(n):
                continue
            t = scope.find_var(n)
            var = block.var_or_none(n)
            if var is None or not isinstance(t, torch.Tensor) or \
                    tuple(t.shape) == tuple(var.shape):
                out[n] = t
                continue
            gshape = tuple(var.shape)
            spec = self.strategy.state_sharding(n, len(gshape), gshape,
                                                dist_rows)
            out[n] = self.strategy.gather(t, spec)
        return out

    def _shard_feeds(self, feed, feeds):
        """(feeds, names of the batch-sharded ones) under the strategy:
        each feed's rows of this rank's data shard (a PackedBatch staged
        under the strategy holds only them already). A batch the data
        axis does not divide is replicated (``shard_feed`` logs it once),
        and so are feeds whose leading dims differ (a sequence feed's ids
        and offsets, a [T] table beside [B, T] ids): their rows are not
        one batch's."""
        st = self.strategy
        if isinstance(feed, _ingest.PackedBatch) and \
                feed.shard_start is not None:
            return feeds, tuple(n for n, t in feeds.items() if t.dim())
        n = st.data_shards()
        if len({t.shape[0] for t in feeds.values() if t.dim()}) > 1:
            return feeds, ()
        if any(t.dim() and t.shape[0] % n for t in feeds.values()):
            for name, t in feeds.items():
                if t.dim() and t.shape[0] % n:
                    st.shard_feed(name, t)      # logs the fallback once
            return feeds, ()
        out = {name: st.shard_feed(name, t) for name, t in feeds.items()}
        return out, tuple(name for name, t in out.items() if t.dim())

    def _place(self, scope, block, name, t, dist_rows, placed, row_base):
        """The tensor the step reads for state ``name`` under the
        strategy. The scope keeps this rank's slice (a global tensor, as a
        startup or a load leaves it, is sliced and stored back); a
        row-sharded distributed table stays local, with its first row's
        global index in ``row_base``; other sharded state is gathered,
        and its slice's index kept in ``placed`` for the write-back."""
        st = self.strategy
        var = block.var_or_none(name)
        gshape = tuple(var.shape) if var is not None and var.shape and \
            all(d is not None and d > 0 for d in var.shape) \
            else tuple(t.shape)
        spec = st.state_sharding(name, len(gshape), gshape, dist_rows)
        if not any(spec):
            return t
        idx = st.local_index(spec, gshape)
        lshape = tuple(len(range(*s.indices(d))) for s, d in zip(idx, gshape))
        if tuple(t.shape) == gshape and lshape != gshape:
            t = t[idx].clone()
            scope.set_var(name, t)
        elif tuple(t.shape) != lshape:
            raise ValueError(
                "state %r has shape %s: neither its global shape %s nor "
                "this rank's slice %s" % (name, tuple(t.shape), gshape,
                                          lshape))
        if dist_rows and name in dist_rows and spec[0] == st.data_axis:
            row_base[name] = st.data_coord() * lshape[0]
            return t
        placed[name] = idx
        return st.gather(t, spec)

    def lower(self, program=None, feed=None, fetch_list=None, scope=None,
              donate_state=True):
        """Export the EXACT step ``run`` would execute (same donation,
        amp policy, state threading) without running it. Returns the
        ``torch.export.ExportedProgram`` (the counterpart of
        ``jax.stages.Lowered``) whose inputs are ``(state_rw, state_ro,
        feed)``: dicts of the written state, the read state and the feeds
        by name. Raises for a step that cannot be exported (a training
        program)."""
        if self.strategy is not None:
            raise ValueError("a step under a distribution strategy is not "
                             "exported (it runs collectives)")
        call = self._prepare(program, feed, fetch_list, scope, donate_state,
                             count_cache=False)
        if call.entry.plan.host_reads:
            raise ValueError("this step cannot be exported: %s"
                             % call.entry.plan.host_reads)
        return _export(call.entry.fn, call.args, self.device)

    def cache_digest(self, program, feed=None, fetch_list=None, scope=None,
                     donate_state=True):
        """The process-stable persistent-cache digest of the EXACT step
        ``run`` would execute for these arguments (program content,
        feed/fetch signature, trace-time flags and the environment
        fingerprint: ``core/compile_cache.py``). An AOT serving artifact
        records it per bucket, so a loader can prove that the stored
        program IS the step it would build here before trusting it."""
        entry = self._prepare(program, feed, fetch_list, scope,
                              donate_state, count_cache=False).entry
        if entry.pkey is None:
            entry.pkey = _compile_cache.entry_digest(
                program, entry.skey_parts, self.device)
        return entry.pkey

    def prime_aot(self, program, feed, fetch_list, scope, compiled,
                  expect_digest=None, donate_state=True):
        """Install an ``ExportedProgram`` (deserialized from a serving
        artifact's ``compiled/`` index) as the executable of the cache
        entry these arguments resolve to: the serving cold-start path.

        When ``expect_digest`` is given it must equal this entry's
        :meth:`cache_digest` (raises ValueError otherwise): version skew,
        flag drift or another card cannot install a program that computes
        something else; callers catch and run the program. A program the
        call does not fit is dropped at its first run, which then runs
        op by op. Returns the entry."""
        entry = self._prepare(program, feed, fetch_list, scope,
                              donate_state, count_cache=False).entry
        if expect_digest is not None:
            if entry.pkey is None:
                entry.pkey = _compile_cache.entry_digest(
                    program, entry.skey_parts, self.device)
            if entry.pkey != expect_digest:
                raise ValueError(
                    "AOT executable digest %s does not match this "
                    "executor's computation digest %s (program/flag/"
                    "environment skew)" % (expect_digest[:12],
                                           entry.pkey[:12]))
        entry.install(compiled)
        return entry

    def as_jax_function(self, program, feed_templates, fetch_list,
                        scope=None):
        """A Program block as a pure function (the reference's name, so
        code written against it runs). Returns ``(fn, (state, feed))``
        where ``fn(state, feed) -> fetches`` is a torch function that
        writes none of its inputs, ``state`` the persistable variables
        the block reads and writes, from ``scope`` (run the startup
        program first), and ``feed`` the templates as tensors of their
        variables' dtypes on this executor's device. The ops run in the
        caller's autograd mode, so ``torch.autograd`` differentiates
        through ``fn``."""
        scope = scope or global_scope()
        block = program.global_block()
        fetch_names = [v.name if isinstance(v, Variable) else v
                       for v in fetch_list]
        feed = {}
        for name, value in feed_templates.items():
            var = block.var_or_none(name)
            feed[name] = self._tensor(
                value, torch_dtype(var.dtype) if var is not None else None)
        read, written, needs_rng = _block_io(block)
        needs_vjp = {id(op.attrs["fwd_op"]): op for op in block.ops
                     if op.type == "vjp_grad"}
        state = {}
        for n in sorted(read | written):
            if scope.has_var(n):
                state[n] = self._state(scope, n)
        if needs_rng:
            seed = program.random_seed if program.random_seed else 0
            state[RNG_STATE_VAR] = self._state(scope, RNG_STATE_VAR) \
                if scope.has_var(RNG_STATE_VAR) else \
                random_ops.prng_key(seed, self.device)
        amp = amp_dtype(_config.get_flag("amp"))
        device = self.device

        def fn(state, feed):
            env = dict(state)
            env.update(feed)
            trace = _TraceState(needs_vjp, amp=amp, autograd=True,
                                device=device)
            run_block(block, env, trace)
            return [_lookup(env, n, None, block) for n in fetch_names]

        return fn, (state, feed)

    def _aot(self, call):
        """Give ``call``'s entry its ExportedProgram where the persistent
        cache or telemetry asks for one (reference ``run``'s AOT branch):
        loaded from the cache dir, else exported (and stored). A training
        step is not exported; an export that fails leaves the entry to run
        op by op. Either logs ``aot_export_skipped``."""
        entry = call.entry
        telemetry = bool(_config.get_flag("telemetry"))
        pcache = _compile_cache.active_cache() \
            if entry.pkey is not None else None
        if pcache is None and not telemetry:
            return
        if entry.plan.host_reads:
            entry.aot_failed = True
            _log.structured("aot_export_skipped", key=entry.key_id,
                            error=entry.plan.host_reads)
            return
        if pcache is not None:
            ep = pcache.load(entry.pkey, self.device)
            if ep is not None:
                entry.install(ep)
                return
        if entry.plan.needs_vjp:
            entry.aot_failed = True
            _log.structured("aot_export_skipped", key=entry.key_id,
                            error="a training step (vjp_grad) is not "
                            "serializable")
            return
        t0 = time.perf_counter()
        try:
            with _tracing.span("executorTrace", key=entry.key_id):
                ep = _export(entry.fn, call.args, self.device)
        except Exception as e:
            entry.aot_failed = True
            _log.structured("aot_export_skipped", key=entry.key_id,
                            error=repr(e))
            return
        t1 = time.perf_counter()
        entry.install(ep)
        if telemetry:
            _TRACE_SECONDS.labels(key=entry.key_id).set(t1 - t0)
            if self.device.type != "cuda":
                # the executable is the program's module: made above
                _COMPILE_SECONDS.labels(key=entry.key_id).set(
                    time.perf_counter() - t1)
            try:
                flops, nbytes = _cost(ep)
                _STEP_FLOPS.labels(key=entry.key_id).set(float(flops))
                _STEP_BYTES.labels(key=entry.key_id).set(float(nbytes))
            except Exception:
                pass  # cost counting is best-effort, as the reference's
        if pcache is not None:
            pcache.store(entry.pkey, ep, self.device)

    def _capture(self, call):
        """Capture ``call``'s step into a CUDA graph over the scope's
        state as ``call`` holds it and static copies of its feeds (the
        entry has run before, which warmed it). Written state is copied
        into the scope's own tensors in the graph. Returns the _Graph, or
        None with the entry marked (logged ``executor_capture_failed``)."""
        entry = call.entry
        state_rw, state_ro = call.state_rw, call.state_ro
        feed = {n: t.clone() for n, t in call.feed.items()}
        args = (state_rw, state_ro, feed)

        def body():
            new_state, fetches, guards = entry.execute(args)
            for n, v in new_state.items():
                if v is not state_rw[n]:
                    state_rw[n].copy_(v)
            return fetches, guards

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)
        g = _Graph()
        g.graph = torch.cuda.CUDAGraph()
        stream = self._capture_stream
        before = _launches.snapshot()
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream(self.device))
        try:
            with _tracing.span("executorCompile", key=entry.key_id), \
                    _build.capture_buffers() as buffers, \
                    torch.cuda.stream(stream):
                _warm_handles(self.device)
                g.graph.capture_begin(pool=self._pool,
                                      capture_error_mode="thread_local")
                try:
                    g.fetches, g.guards = body()
                except BaseException:
                    try:
                        g.graph.capture_end()
                    except Exception:
                        pass
                    raise
                g.graph.capture_end()
        except Exception as e:
            entry.graph_failed = True
            self._captures["failed"] += 1
            CAPTURES["failed"] += 1
            _log.structured("executor_capture_failed", key=entry.key_id,
                            error=repr(e))
            return None
        finally:
            g.launches = _launches.since(before)
            _launches.add(g.launches, -1)   # a capture launches nothing
        torch.cuda.current_stream(self.device).wait_stream(stream)
        if _config.get_flag("telemetry"):
            _COMPILE_SECONDS.labels(key=entry.key_id).set(
                time.perf_counter() - t0)
        g.scope = weakref.ref(call.scope)
        g.state = dict(state_ro)
        g.state.update(state_rw)
        g.feed = feed
        g.buffers = buffers
        self._captures["captures"] += 1
        CAPTURES["captures"] += 1
        return g

    def _note_writes(self, call, new_state):
        """After a run op by op: whether the entry's step can be captured,
        a forward program on the card whose written state all lives in
        the scope with the shapes and dtypes the step writes (a state
        variable's first write waits for the next run)."""
        entry = call.entry
        if not graphs_on(self.device) or entry.graph_failed or \
                entry.plan.needs_vjp:
            return False
        for n, v in new_state.items():
            if n not in call.state_rw:
                return False
            cur = call.scope.find_var(n)
            if not isinstance(cur, torch.Tensor) or cur.shape != v.shape \
                    or cur.dtype != v.dtype:
                entry.graph_failed = True
                _log.structured("executor_capture_skipped",
                                key=entry.key_id, var=n)
                return False
        return True

    def _replay(self, call):
        g = call.entry.graph
        for n, t in call.feed.items():
            g.feed[n].copy_(t)
        g.graph.replay()
        _launches.add(g.launches)
        self._captures["replays"] += 1
        CAPTURES["replays"] += 1
        return g.fetches, g.guards

    def _run_dist(self, call, return_numpy):
        """One run under the strategy, op by op: state a run creates is
        broadcast from the mesh's first rank, and each gathered state's
        slice of its new value is written back."""
        entry, scope = call.entry, call.scope
        new_state, fetches, guards = entry.fn(*call.args, dist=call.dist)
        mesh = self.strategy.mesh
        for n, v in new_state.items():
            if n not in call.state_rw and n not in call.state_ro:
                spmd.broadcast(v, mesh.first_rank(), mesh.mesh_group)
            idx = call.placed.get(n)
            if idx is None:
                # (a sharded state's first write is sliced at its next
                # read, by _place)
                scope.set_var(n, v)
                continue
            part = v[idx]
            cur = scope.find_var(n)
            if isinstance(cur, torch.Tensor) and cur.shape == part.shape \
                    and cur is not part:
                cur.copy_(part)
            else:
                scope.set_var(n, part.clone())
        entry.ran = True
        if return_numpy:
            fetches = [_to_numpy(v) for v in fetches]
        _check_guards(guards)
        return fetches

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, donate_state=True):
        precision = _config.resolve_matmul_precision()
        if precision is None:
            return self._run(program, feed, fetch_list, scope, return_numpy,
                             donate_state)
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision(precision)
        try:
            return self._run(program, feed, fetch_list, scope, return_numpy,
                             donate_state)
        finally:
            torch.set_float32_matmul_precision(prev)

    def _run(self, program, feed, fetch_list, scope, return_numpy,
             donate_state):
        call = self._prepare(program, feed, fetch_list, scope, donate_state)
        if self.strategy is not None:
            return self._run_dist(call, return_numpy)
        entry, scope = call.entry, call.scope
        if entry.aot is None and not entry.aot_failed and (
                entry.pkey is not None or
                (entry.ran and _config.get_flag("telemetry"))):
            # entry.pkey doubles as the "persistent cache armed" gate;
            # telemetry exports at an entry's second run, so a program
            # run once (a startup: tens of thousands of random-bit ops)
            # is never traced for it
            self._aot(call)
        g = entry.graph
        if g is not None:
            owner = g.scope()
            state = dict(call.state_ro)
            state.update(call.state_rw)
            if owner is scope and not g.matches(state):
                # the scope's state was replaced (a swap, a load): the
                # graph reads the old tensors; recapture now
                entry.graph = g = None
                self._compiles += 1
                self._captures["recaptures"] += 1
                CAPTURES["recaptures"] += 1
            elif owner is None:
                entry.graph = g = None
            # else another scope's run (a canary) runs op by op and the
            # graph stays
        if g is None and entry.capturable:
            entry.graph = g = self._capture(call)
        if g is not None and g.scope() is scope:
            fetches, guards = self._replay(call)
            fetches = [_to_numpy(v) if return_numpy else v.clone()
                       for v in fetches]
        else:
            new_state, fetches, guards = entry.execute(call.args)
            for n, v in new_state.items():
                scope.set_var(n, v)
            entry.ran = True
            entry.capturable = self._note_writes(call, new_state)
            if return_numpy:
                fetches = [_to_numpy(v) for v in fetches]
        _check_guards(guards)
        return fetches


def _row_shardable(plan, block):
    """The persistable names that only a distributed lookup and the
    sparse updates read: a distributed table (or slot) that another op
    reads (weight tying, whose gradient is dense) stays whole."""
    names = getattr(plan, "row_shardable", None)
    if names is None:
        bad, seen = set(), set()
        for op in block.ops:
            if op.type == "vjp_grad":
                continue
            sparse = op.type == "lookup_table_dist" or "Rows" in op.inputs
            for n in op.input_names():
                seen.add(n)
                if not sparse:
                    bad.add(n)
        names = plan.row_shardable = frozenset(seen - bad)
    return names


def _warm_handles(device):
    """Make this thread's cuBLAS, cuBLASLt and cuDNN handles on the
    current stream before a capture: a thread whose runs so far were
    all replays (a replica's worker after a swap) has none, and creating
    one inside a capture fails."""
    torch.cuda.current_blas_handle()
    x = torch.ones((2, 8, 4, 4), device=device)
    torch.nn.functional.linear(x[0, 0], x[0, 0], x[0, 0, 0])
    torch.nn.functional.conv2d(x, x[:, :, :1, :1])


def graphs_on(device):
    """Whether forward steps on ``device`` are captured as CUDA graphs
    (the card's are)."""
    return device.type == "cuda"


def _check_guards(guards):
    # Per-op output scan (reference framework/executor.cc:120-128).
    if guards:
        bad = [k for k, ok in guards.items() if not bool(ok)]
        if bad:
            raise FloatingPointError(
                "NaN/Inf detected in op outputs: %s" % ", ".join(bad))
