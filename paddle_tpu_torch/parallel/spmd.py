"""Global-view semantics for one rank's share of a step.

Under a :class:`~paddle_tpu_torch.parallel.DistStrategy` each rank runs
every op of the block on its own rows, and this module makes the results
the reference's global-view ones (``jnp`` reductions are global there,
and XLA emits the collectives). Every value of a run is in one of three
states:

* ``R`` replicated: the same on every rank (state, constants, and what
  the batch reductions return);
* ``S`` batch-sharded: this rank's rows of a global batch (the feeds and
  what row-local ops make of them);
* ``G`` gathered: the global batch, the same on every rank (what an op
  that mixes rows, run on all the rows, returns).

Gradients follow one rule: the gradient of an ``S`` value is this rank's
rows of the global gradient, and the gradient of an ``R`` or ``G`` value
is a partial that sums over the data axis to the global one (the
backward's seed is ``1 / n`` of a replicated loss on each of the ``n``
data ranks). So the collectives' own gradients are fixed: an all-reduce
all-reduces its gradient, an all-gather of rows reduce-scatters it, a
slice of rows pads it with zeros; and the executor completes the
gradient of replicated state with one all-reduce over the data axis.
Values on the model axis (attention heads) are the same on every rank
of it, gradients too.

Each op runs by its rule (:func:`route`): row-local ops run as they are;
the batch reductions (``mean``, ``reduce_sum``/``reduce_mean`` over the
batch), ``batch_norm``, ``conv2d_bn``, ``dropout``, ``reshape``,
``multihead_attention`` and the sparse gradients have a seam here; any
other op that reads sharded rows runs on all the rows, gathered, and
returns ``G`` values: slower, but the reference's numbers.
"""

import torch

from ..core import registry

__all__ = ["all_reduce", "all_gather", "all_to_all", "broadcast",
           "AllReduce", "GatherRows", "SliceRows", "GatherShared",
           "SliceShared", "DistRun"]


# -- collectives ----------------------------------------------------------

def _dist():
    return torch.distributed


def group_size(group):
    return 1 if group is None else _dist().get_world_size(group)


def group_rank(group):
    return 0 if group is None else _dist().get_rank(group)


def all_reduce(t, group, op="sum"):
    """The sum (or max) of ``t`` over ``group`` (``t`` itself without a
    group), as a new tensor."""
    if group is None:
        return t
    out = t.detach().clone().contiguous()
    red = _dist().ReduceOp.SUM if op == "sum" else _dist().ReduceOp.MAX
    _dist().all_reduce(out, op=red, group=group)
    return out


def all_gather(t, group, dim=0):
    """The ranks' ``t`` of ``group`` concatenated along ``dim``, in rank
    order."""
    if group is None:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(group_size(group))]
    _dist().all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def all_to_all(t, group):
    """``t`` [n, ...]: row j goes to rank j of ``group``; returns the
    rows received, row i from rank i."""
    if group is None:
        return t
    t = t.detach().contiguous()
    out = torch.empty_like(t)
    _dist().all_to_all_single(out, t, group=group)
    return out


def broadcast(t, src, group):
    """``t`` from global rank ``src`` to every rank of ``group``, in
    place."""
    if group is not None:
        _dist().broadcast(t, src=src, group=group)
    return t


def _narrow(t, group, dim):
    k = t.shape[dim] // group_size(group)
    return t.narrow(dim, group_rank(group) * k, k)


class AllReduce(torch.autograd.Function):
    """Sum over the group; its gradient is the gradient's sum (a partial
    in, the global gradient out)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class GatherRows(torch.autograd.Function):
    """This rank's rows to the global batch (``S`` to ``G``); the
    gradient, a partial of the global batch, is summed and this rank's
    rows kept (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _narrow(all_reduce(g, ctx.group), ctx.group, ctx.dim), \
            None, None


class SliceRows(torch.autograd.Function):
    """The global batch to this rank's rows (``G`` to ``S``); the
    gradient of the rows, padded with zeros, is this rank's partial of
    the global one."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.shape = group, dim, x.shape
        return _narrow(x, group, dim).clone()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        _narrow(out, ctx.group, ctx.dim).copy_(g)
        return out, None, None


class GatherShared(torch.autograd.Function):
    """Each rank's part of a value the group shares (attention heads on
    the model axis) concatenated along ``dim``; the gradient, the same on
    every rank, is sliced."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _narrow(g, ctx.group, ctx.dim).contiguous(), None, None


class SliceShared(torch.autograd.Function):
    """This rank's part of a value the group shares; the gradient is
    gathered from every rank's part."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _narrow(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


# -- op rules -------------------------------------------------------------

_ROW_LOCAL = frozenset([
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "scale", "sum", "minus", "clip", "sign", "pow",
    "cast", "assign", "fill_zeros_like", "one_hot", "lookup_table",
    "softmax_with_cross_entropy", "cross_entropy",
    "sigmoid_cross_entropy_with_logits", "square_error_cost",
    "hinge_loss", "huber_loss", "log_loss", "smooth_l1_loss",
    "modified_huber_loss", "rank_loss", "margin_rank_loss", "conv2d",
    "conv3d", "conv2d_transpose", "conv3d_transpose", "pool2d", "pool3d",
    "lrn", "maxout", "sequence_mask", "fill_constant_batch_size_like",
    "cos_sim", "squared_l2_distance", "logical_and", "logical_or",
    "logical_xor", "logical_not", "less_than", "less_equal",
    "greater_than", "greater_equal", "equal", "not_equal",
    "lookup_table_dist"])


def _activation(op_type):
    opdef = registry.get_op_def(op_type)
    return opdef.compute.__module__.endswith(".activation_ops")


def _axis_not_batch(op, attr, default, ndim):
    axis = op.attrs.get(attr, default)
    return ndim >= 2 and axis is not None and axis % ndim != 0


def _reduce_axes(op, ndim):
    dim = op.attrs.get("dim")
    if op.attrs.get("reduce_all", False) or dim is None:
        return tuple(range(ndim))
    dims = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
    return tuple(sorted(d % ndim for d in dims)) if ndim else ()


def _first(values, slot):
    vals = values.get(slot) or [None]
    return vals[0]


def route(op, values, kinds):
    """How ``op`` runs on inputs of states ``kinds`` (slot -> [state]):
    ``"rows"`` row by row, ``"gather"`` on the gathered rows, or a seam
    (a function of this module)."""
    t = op.type
    sharded = {s for s, ks in kinds.items() if "S" in ks}
    if t in _SEAMS:
        return _SEAMS[t]
    if t in ("reduce_sum", "reduce_mean"):
        x = _first(values, "X")
        return _reduce_seam if 0 in _reduce_axes(op, x.dim()) else "rows"
    if t.startswith("reduce_"):
        x = _first(values, "X")
        return "gather" if 0 in _reduce_axes(op, x.dim()) else "rows"
    if t == "softmax" or t == "top_k":
        return "rows" if _first(values, "X").dim() >= 2 else "gather"
    if t in _ROW_LOCAL:
        return "rows"
    if t == "mul":
        return "gather" if "Y" in sharded else "rows"
    if t == "matmul":
        x, y = _first(values, "X"), _first(values, "Y")
        if "Y" not in sharded or (x.dim() >= 3 and y.dim() >= 3 and
                                  "X" in sharded):
            return "rows"
        return "gather"
    if t in ("concat", "split", "stack", "unstack"):
        x = _first(values, "X")
        return "rows" if _axis_not_batch(op, "axis", 0, x.dim() + (
            t == "stack")) else "gather"
    if t in ("arg_max", "arg_min"):
        return "rows" if _axis_not_batch(op, "axis", -1,
                                         _first(values, "X").dim()) \
            else "gather"
    if t == "transpose":
        perm = op.attrs.get("axis") or []
        return "rows" if perm and perm[0] == 0 else "gather"
    if t == "layer_norm":
        return "rows" if op.attrs.get("begin_norm_axis", 1) >= 1 \
            else "gather"
    if _activation(t):
        return "rows" if t != "prelu" or \
            op.attrs.get("mode", "all") != "element" or \
            "Alpha" not in sharded else "gather"
    return "gather"


class _OpView:
    """An op seen with other attributes (a seam's local shape)."""

    def __init__(self, op, **attrs):
        self._op = op
        self.attrs = dict(op.attrs, **attrs)

    def __getattr__(self, name):
        return getattr(self._op, name)


def _mean_seam(run, opdef, op, values, rng_key, block, trace, kinds):
    x = _first(values, "X")
    if "S" not in kinds["X"]:
        return run.plain(opdef, op, values, rng_key, block, trace), "R"
    total = AllReduce.apply(x.sum(), run.data_group)
    return {"Out": [total / (x.numel() * run.n)]}, "R"


def _reduce_seam(run, opdef, op, values, rng_key, block, trace, kinds):
    x = _first(values, "X")
    if "S" not in kinds["X"]:
        return run.plain(opdef, op, values, rng_key, block, trace), "R"
    axes = _reduce_axes(op, x.dim())
    keep = op.attrs.get("keep_dim", False)
    xs = x if x.is_floating_point() else x.to(torch.float32) \
        if op.type == "reduce_mean" else x
    out = xs.sum(dim=axes, keepdim=keep)
    if op.type == "reduce_sum" and not x.is_floating_point():
        out = out.to(torch.int32 if x.dtype == torch.bool else x.dtype)
    out = AllReduce.apply(out, run.data_group)
    if op.type == "reduce_mean":
        count = run.n
        for d in axes:
            count *= x.shape[d]
        out = out / count
    return {"Out": [out]}, "R"


def _batch_norm_seam(run, opdef, op, values, rng_key, block, trace,
                     kinds):
    key = "Input" if op.type == "conv2d_bn" else "X"
    if "S" not in kinds[key] or op.attrs.get("is_test", False):
        out = run.plain(opdef, op, values, rng_key, block, trace)
        return out, {"Y": "S" if "S" in kinds[key] else
                     ("G" if "G" in kinds[key] else "R")}
    # the per-channel sums over the data axis's ranks, each holding
    # 1 / n of the batch
    group, mult = run.data_group, run.n

    def reduce(t):
        return AllReduce.apply(t, group)
    v = {s: _first(values, s) for s in values}
    if op.type == "conv2d_bn":
        from ..ops.conv_bn import conv2d_bn_stats
        y, mean, var, saved_mean, inv = conv2d_bn_stats(
            v["Input"], v["Filter"], v["Scale"], v["Bias"], v["Mean"],
            v["Variance"], op.attrs.get("strides", [1, 1]),
            op.attrs.get("paddings", [0, 0]),
            op.attrs.get("dilations", [1, 1]),
            int(op.attrs.get("groups", 1) or 1),
            op.attrs.get("momentum", 0.9), op.attrs.get("epsilon", 1e-5),
            False, reduce=reduce, count_mult=mult)
    else:
        from ..ops.nn_ops import batch_norm_stats
        x = v["X"]
        channel_axis = 1 if op.attrs.get("data_layout", "NCHW") == "NCHW" \
            else x.dim() - 1
        y, mean, var, saved_mean, inv = batch_norm_stats(
            x, v["Scale"], v["Bias"], v["Mean"], v["Variance"],
            op.attrs.get("momentum", 0.9), op.attrs.get("epsilon", 1e-5),
            False, channel_axis, reduce=reduce, count_mult=mult)
    return ({"Y": [y], "MeanOut": [mean], "VarianceOut": [var],
             "SavedMean": [saved_mean], "SavedVariance": [inv]},
            {"Y": "S"})


def _dropout_seam(run, opdef, op, values, rng_key, block, trace, kinds):
    x = _first(values, "X")
    if "S" not in kinds["X"] or op.attrs.get("is_test", False):
        out = run.plain(opdef, op, values, rng_key, block, trace)
        return out, run.rows_state(kinds)
    # the global batch's mask, this rank's rows of it
    from ..ops.nn_ops import bernoulli
    p = op.attrs.get("dropout_prob", 0.5)
    b = x.shape[0]
    mask = bernoulli(rng_key, 1.0 - p, (b * run.n,) + tuple(x.shape[1:]))
    mask = mask[run.coord * b:(run.coord + 1) * b].to(x.dtype)
    return {"Out": [x * mask], "Mask": [mask]}, "S"


def _reshape_seam(run, opdef, op, values, rng_key, block, trace, kinds):
    shape = list(op.attrs.get("shape") or [])
    if "S" not in kinds["X"] or not shape or shape[0] in (-1, 0):
        return run.plain(opdef, op, values, rng_key, block, trace), \
            run.rows_state(kinds)
    if shape[0] % run.n:
        return run.gathered(opdef, op, values, rng_key, block, trace,
                            kinds)
    shape[0] //= run.n
    return run.plain(opdef, _OpView(op, shape=shape), values, rng_key,
                     block, trace), "S"


def _attention_seam(run, opdef, op, values, rng_key, block, trace, kinds):
    from ..ops.attention_ops import sharded_attention
    q = _first(values, "Q")
    if q.device.type == "meta":
        return run.plain(opdef, op, values, rng_key, block, trace), "S"
    k, v = _first(values, "K"), _first(values, "V")
    klen = _first(values, "KeyLength")
    rows = "S" in kinds["Q"]
    if not rows or any("S" not in kinds[s] for s in ("K", "V")):
        # the queries' rows and the keys' rows are not one batch split
        # one way: all the rows
        q, k, v = (run.to_global(t, kinds[s]) for t, s in
                   ((q, "Q"), (k, "K"), (v, "V")))
        if klen is not None:
            klen = run.to_global(klen, kinds["KeyLength"])
        out = sharded_attention(q, k, v, op, run.strategy, klen,
                                rows_sharded=False)
        return {"Out": [out]}, "G" if run.any_batch(kinds) else "R"
    if klen is not None and "S" not in kinds["KeyLength"]:
        klen = run.to_rows(klen, kinds["KeyLength"])
    out = sharded_attention(q, k, v, op, run.strategy, klen,
                            rows_sharded=True)
    return {"Out": [out]}, "S"


def _sparse_grad_seam(run, opdef, op, values, rng_key, block, trace,
                      kinds):
    """Every rank's rows and values, concatenated: this rank's rows'
    gradients, or its partial of a replicated batch's, which the
    update's merge sums; the global sparse gradient on every rank. The
    distributed gradient on the a2a route sends each row to its owner
    itself (``embeddings/sharded.py``), which keeps what it received."""
    out = run.plain(opdef, op, values, rng_key, block, trace)
    if op.type == "lookup_table_dist_grad":
        from ..embeddings import sharded
        if sharded.exchanges_grads(int(op.attrs["padded_vocab"])):
            return out, "R"
    return {s: [all_gather(out[s][0], run.data_group, 0)]
            for s in ("Rows", "Values")}, "R"


def _fill_like_seam(run, opdef, op, values, rng_key, block, trace, kinds):
    out = run.plain(opdef, op, values, rng_key, block, trace)
    name = (op.outputs.get("Out") or [""])[0]
    if "S" not in kinds["X"] and "@GRAD" in name:
        # the backward's seed of a replicated loss: 1/n on each of the n
        # data ranks, so partial gradients sum to the global one
        out = {"Out": [out["Out"][0] / run.n]}
    return out, run.rows_state(kinds)


_SEAMS = {
    "mean": _mean_seam,
    "batch_norm": _batch_norm_seam,
    "conv2d_bn": _batch_norm_seam,
    "dropout": _dropout_seam,
    "reshape": _reshape_seam,
    "multihead_attention": _attention_seam,
    "lookup_table_sparse_grad": _sparse_grad_seam,
    "lookup_table_dist_grad": _sparse_grad_seam,
    "fill_like": _fill_like_seam,
}

# seams that run whatever their inputs' states
_ALWAYS = frozenset(["fill_like", "lookup_table_sparse_grad",
                     "lookup_table_dist_grad"])


class DistRun:
    """The distribution state of one run: the strategy, the data axis's
    group, this rank's shard, and the state of every sharded or gathered
    value by name (a name absent is ``R``). ``row_base`` maps a
    row-sharded table (and its slots) to the global row of its first
    local row."""

    def __init__(self, strategy, sharded=(), row_base=None):
        self.strategy = strategy
        self.data_group = strategy.mesh.group(strategy.data_axis)
        self.n = strategy.data_shards()
        self.coord = strategy.data_coord()
        self.states = dict.fromkeys(sharded, "S")
        self.row_base = dict(row_base or {})

    def state(self, name):
        return self.states.get(name, "R")

    @staticmethod
    def rows_state(kinds):
        allk = {k for ks in kinds.values() for k in ks}
        return "S" if "S" in allk else ("G" if "G" in allk else "R")

    @staticmethod
    def any_batch(kinds):
        return any(k in ("S", "G") for ks in kinds.values() for k in ks)

    def to_global(self, t, kind):
        return GatherRows.apply(t, self.data_group, 0) if kind == ["S"] \
            else t

    def to_rows(self, t, kind, like=None):
        """A ``G`` value (the global batch) as this rank's rows."""
        if kind != ["G"] or t is None or t.dim() == 0 or \
                t.shape[0] % self.n or \
                (like is not None and (t.dim() != like.dim() or
                                       t.shape[0] != like.shape[0] * self.n)):
            return t
        return SliceRows.apply(t, self.data_group, 0)

    def plain(self, opdef, op, values, rng_key, block, trace):
        ctx = registry.ExecContext(op, values, rng_key=rng_key, block=block,
                                   trace=trace)
        return registry.normalize_outputs(op, opdef.compute(ctx))

    def gathered(self, opdef, op, values, rng_key, block, trace, kinds):
        vals = {s: [None if v is None else self.to_global(v, [k])
                    for v, k in zip(values[s], kinds[s])]
                for s in values}
        return self.plain(opdef, op, vals, rng_key, block, trace), "G"

    def run_op(self, opdef, op, values, rng_key, block, trace):
        """Run ``op`` on this rank's values; returns its normalized
        outputs, with their states recorded."""
        kinds = {s: [self.state(n) for n in op.inputs.get(s, [])]
                 for s in values}
        batch = self.any_batch(kinds)
        if op.type in _ALWAYS or (batch and op.type in _SEAMS):
            out, st = _SEAMS[op.type](self, opdef, op, values, rng_key,
                                      block, trace, kinds)
        elif not batch:
            out, st = self.plain(opdef, op, values, rng_key, block,
                                 trace), "R"
        else:
            how = route(op, values, kinds)
            if how == "rows":
                if any("S" in ks for ks in kinds.values()):
                    like = next(v for s in values
                                for v, k in zip(values[s], kinds[s])
                                if k == "S")
                    values = {s: [self.to_rows(v, [k], like)
                                  for v, k in zip(values[s], kinds[s])]
                              for s in values}
                out = self.plain(opdef, op, values, rng_key, block, trace)
                st = self.rows_state(kinds)
            elif how == "gather":
                out, st = self.gathered(opdef, op, values, rng_key, block,
                                        trace, kinds)
            else:
                out, st = how(self, opdef, op, values, rng_key, block,
                              trace, kinds)
        self.record(op, out, st)
        return out

    def record_names(self, names, st):
        for name in names:
            if st == "R":
                self.states.pop(name, None)
            else:
                self.states[name] = st

    def record(self, op, out, st):
        for slot, names in op.outputs.items():
            self.record_names(names, st.get(slot, "R")
                              if isinstance(st, dict) else st)

    def fetch(self, name, value):
        """The global value of a fetch."""
        if self.state(name) == "S" and isinstance(value, torch.Tensor):
            return all_gather(value, self.data_group, 0)
        return value
