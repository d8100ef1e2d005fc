"""IR-level autodiff: append backward ops to a Program (reference
``paddle_tpu/core/backward.py``, ported close to verbatim: a program
whose backward either package appended runs in the other).

Backward is symbolic at the IR level (grad ops are visible like any
other op) but *generic* at the kernel level: each appended ``vjp_grad``
op references its forward op, and the executor answers it with autograd
through the graph the forward op recorded when it ran — nothing is
recomputed and no op has grad code of its own.

Gradient accumulation (a var consumed by N ops) follows the reference's
"sum" insertion (``backward.cc: MakeOpGrad`` dedup logic): contributions get
unique names and a ``sum`` op folds them right before first use.

Sparse gradients (the reference's SelectedRows path): a trainable table
read by exactly ONE ``is_sparse`` lookup gets a ``lookup_table_sparse_grad``
op, and a distributed table (``lookup_table_dist``) one
``lookup_table_dist_grad`` op a lookup, their (Rows, Values) pairs
concatenated: never a dense [V, D] gradient. The values variable carries
the rows in ``selected_rows``, which the optimizers read. A distributed
table that another op reads (weight tying) falls back to the dense
gradient, with a warning.
"""

import logging

import numpy as np

from . import registry
from .framework import Parameter
from .executor import EMPTY_VAR
from ..ops import control_flow_ops

GRAD_SUFFIX = "@GRAD"

__all__ = ["append_backward", "grad_var_name", "GRAD_SUFFIX"]

# Ops that never propagate gradients (metrics, IO, optimizer updates...).
NO_GRAD_OP_TYPES = {
    "sgd", "momentum", "adam", "adamax", "adagrad", "adadelta", "rmsprop",
    "decayed_adagrad", "ftrl", "proximal_gd", "proximal_adagrad",
    "accuracy", "auc", "print", "increment", "assign_value",
    "fill_constant", "gaussian_random", "uniform_random",
}


def grad_var_name(name):
    return name + GRAD_SUFFIX


def _float_like(block, name):
    var = block.var_or_none(name)
    if var is None:
        return True
    try:
        kind = np.dtype(var.dtype).kind
    except TypeError:
        return True  # bfloat16 scalar type
    return kind == "f"


def append_backward(loss, parameter_list=None, no_grad_set=None):
    """Append grad ops for ``loss``; return [(Parameter, grad Variable)].

    The backward ops land in the same block as the forward ops, so one
    Executor.run of the program performs fwd+bwd (+optimizer ops if
    appended).
    """
    block = loss.block
    program = block.program
    if block.idx != 0:
        raise NotImplementedError("append_backward on sub-blocks not yet "
                                  "supported")
    no_grad = set(no_grad_set or ())

    if parameter_list is not None:
        param_names = set(p.name if isinstance(p, Parameter) else p
                          for p in parameter_list)
    else:
        param_names = set(p.name for p in block.all_parameters()
                          if p.trainable)
    param_names -= no_grad

    # Forward pass: which var names require grad.
    req = set(param_names)
    fwd_ops = list(block.ops)
    for op in fwd_ops:
        if op.type in NO_GRAD_OP_TYPES or op.type == "vjp_grad":
            continue
        if any(n in req for n in op.input_names()):
            for n in op.output_names():
                if n == EMPTY_VAR or n in no_grad:
                    continue
                var = block.var_or_none(n)
                if var is not None and var.stop_gradient:
                    continue
                if not _float_like(block, n):
                    continue
                req.add(n)

    if loss.name not in req:
        raise ValueError(
            "loss %r does not depend on any trainable parameter" % loss.name)

    # grad bookkeeping: var name -> {"contribs": [grad names], "final": name}
    grads = {}
    _contrib_counts = {}  # survives grads.pop on non-SSA overwrites

    def add_contrib(name):
        entry = grads.setdefault(name, {"contribs": [], "final": None})
        k = _contrib_counts.get(name, 0)
        _contrib_counts[name] = k + 1
        gname = grad_var_name(name) if k == 0 else \
            "%s%s@%d" % (name, GRAD_SUFFIX, k)
        src = block.var(name)
        block.create_var(name=gname, shape=src.shape, dtype=src.dtype,
                         stop_gradient=True)
        entry["contribs"].append(gname)
        return gname

    def final_grad(name):
        entry = grads.get(name)
        if entry is None or not entry["contribs"]:
            return None
        if entry["final"] is None:
            if len(entry["contribs"]) == 1:
                entry["final"] = entry["contribs"][0]
            else:
                out = "%s%s@SUM" % (name, GRAD_SUFFIX)
                src = block.var(name)
                block.create_var(name=out, shape=src.shape, dtype=src.dtype,
                                 stop_gradient=True)
                block.append_op("sum", inputs={"X": entry["contribs"]},
                                outputs={"Out": [out]}, infer_shape=False)
                entry["final"] = out
        return entry["final"]

    # Sparse-eligible embedding tables: a trainable table consumed by
    # exactly ONE is_sparse lookup_table; a distributed table however
    # many lookups share it, unless a non-lookup op reads it too.
    consumers = {}
    for op in fwd_ops:
        for n in set(op.input_names()):
            consumers[n] = consumers.get(n, 0) + 1
    sparse_tables, dist_tables, lookup_consumers = set(), set(), {}
    for op in fwd_ops:
        if op.type == "lookup_table" and op.attrs.get("is_sparse"):
            w = op.input("W")
            if w in param_names and consumers.get(w, 0) == 1:
                sparse_tables.add(w)
        elif op.type == "lookup_table_dist":
            w = op.input("W")
            lookup_consumers[w] = lookup_consumers.get(w, 0) + 1
            if w in param_names:
                dist_tables.add(w)
    for w in sorted(dist_tables):
        if lookup_consumers.get(w, 0) != consumers.get(w, 0):
            dist_tables.discard(w)
            logging.getLogger("paddle_tpu_torch").warning(
                "distributed embedding table %r is consumed by a "
                "non-lookup op: its gradient falls back to a DENSE "
                "[%s] cotangent — the sparse-update guarantee does "
                "not hold for this table", w,
                "x".join(str(d) for d in block.var(w).shape))
    sparse_grads = {}       # table name -> (rows var, values var)
    dist_grad_parts = {}    # table name -> [(rows, values), ...]

    # Seed: d loss / d loss = ones.
    seed = add_contrib(loss.name)
    block.append_op("fill_like", inputs={"X": [loss.name]},
                    outputs={"Out": [seed]}, attrs={"value": 1.0},
                    infer_shape=False)

    for i in range(len(fwd_ops) - 1, -1, -1):
        op = fwd_ops[i]
        if op.type in NO_GRAD_OP_TYPES or op.type == "vjp_grad":
            continue
        if (op.type == "lookup_table" and op.input("W") in sparse_tables) \
                or (op.type == "lookup_table_dist" and
                    op.input("W") in dist_tables):
            g_out = final_grad(op.output("Out"))
            if g_out is None:
                continue
            w = block.var(op.input("W"))
            dist = op.type == "lookup_table_dist"
            k = len(dist_grad_parts.get(w.name, ())) if dist else 0
            suffix = "" if k == 0 else "@%d" % k
            rows_n = "%s%s@ROWS%s" % (w.name, GRAD_SUFFIX, suffix)
            vals_n = "%s%s@VALUES%s" % (w.name, GRAD_SUFFIX, suffix)
            block.create_var(name=rows_n, dtype="int32",
                             stop_gradient=True)
            block.create_var(name=vals_n, dtype=w.dtype,
                             stop_gradient=True)
            if dist:
                attrs = {"vocab_size": op.attrs.get("vocab_size"),
                         "padded_vocab": int(w.shape[0]),
                         "padding_idx": op.attrs.get("padding_idx")}
            else:
                attrs = {"vocab_size": int(w.shape[0]),
                         "padding_idx": op.attrs.get("padding_idx")}
            block.append_op(
                op.type + ("_grad" if dist else "_sparse_grad"),
                inputs={"OutGrad": [g_out], "Ids": [op.input("Ids")]},
                outputs={"Rows": [rows_n], "Values": [vals_n]},
                attrs=attrs, infer_shape=False)
            if dist:
                dist_grad_parts.setdefault(w.name, []).append(
                    (rows_n, vals_n))
            else:
                sparse_grads[w.name] = (rows_n, vals_n)
            continue
        out_slots = registry.flat_output_slots(op)
        in_slots = registry.flat_input_slots(op)
        if not out_slots or not in_slots:
            continue
        out_names = [op.outputs[slot][j] for slot, j in out_slots]
        if not any(n in grads and grads[n]["contribs"] for n in out_names):
            continue
        in_names = [op.inputs[slot][j] for slot, j in in_slots]
        need = []
        for n in in_names:
            var = block.var_or_none(n)
            need.append(n != EMPTY_VAR and n in req and var is not None
                        and not var.stop_gradient and _float_like(block, n))
        if not any(need):
            continue

        out_grad_names = []
        for n in out_names:
            g = final_grad(n)
            out_grad_names.append(g if g is not None else EMPTY_VAR)
        # Consume the written vars' grad state BEFORE adding input
        # contributions: an op that overwrites a var it also reads (the
        # While carry pattern — non-SSA) must not let its own input
        # contribution alias the already-consumed output gradient.
        for n in set(out_names):
            grads.pop(n, None)
        if any(map(control_flow_ops.is_unbounded_while,
                   control_flow_ops.walk_ops(program, [op]))):
            raise ValueError(
                "append_backward: an unbounded While (no max_iters) has no "
                "gradient, as lax.while_loop has none in the reference, "
                "also inside another op's sub-block; give the While a "
                "max_iters to train through it")
        in_grad_names = []
        for n, ok in zip(in_names, need):
            in_grad_names.append(add_contrib(n) if ok else EMPTY_VAR)

        block.append_op(
            "vjp_grad",
            inputs={"OutGrads": out_grad_names},
            outputs={"InGrads": in_grad_names},
            attrs={"fwd_op": op, "fwd_op_type": op.type},
            infer_shape=False)

    # a table shared by N distributed lookups: its N (rows, values) pairs
    # concatenated (the update's merge sums the duplicates)
    for wname, parts in dist_grad_parts.items():
        if len(parts) == 1:
            sparse_grads[wname] = parts[0]
            continue
        w = block.var(wname)
        rows_n = "%s%s@ROWS@CAT" % (wname, GRAD_SUFFIX)
        vals_n = "%s%s@VALUES@CAT" % (wname, GRAD_SUFFIX)
        block.create_var(name=rows_n, dtype="int32", stop_gradient=True)
        block.create_var(name=vals_n, dtype=w.dtype, stop_gradient=True)
        for out, k in ((rows_n, 0), (vals_n, 1)):
            block.append_op("concat", inputs={"X": [p[k] for p in parts]},
                            outputs={"Out": [out]}, attrs={"axis": 0},
                            infer_shape=False)
        sparse_grads[wname] = (rows_n, vals_n)

    params_and_grads = []
    for pname in sorted(param_names):
        param = block.var(pname)
        if pname in sparse_grads:
            rows_n, vals_n = sparse_grads[pname]
            gvar = block.var(vals_n)
            gvar.selected_rows = block.var(rows_n)  # SelectedRows marker
            params_and_grads.append((param, gvar))
            continue
        g = final_grad(pname)
        if g is None:
            # Unused parameter: gradient is zeros (reference raises; we keep
            # training robust and let the optimizer apply a zero update).
            g = grad_var_name(pname)
            if block.var_or_none(g) is None:
                block.create_var(name=g, shape=param.shape,
                                 dtype=param.dtype, stop_gradient=True)
                block.append_op("fill_like", inputs={"X": [pname]},
                                outputs={"Out": [g]}, attrs={"value": 0.0},
                                infer_shape=False)
        gvar = block.var(g)
        params_and_grads.append((param, gvar))
    return params_and_grads
