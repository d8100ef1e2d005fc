"""Gradients of the float ops of the LeNet-5/MNIST slice: the port's
route (autograd through the op's compute, which is what the executor's
``vjp_grad`` answers) against ``jax.vjp`` of the reference's compute, on
the cases of ``test_torch_ops_cases.py`` with seeded cotangents, within
each case's tolerance (a convolution's or a sum's a little looser: its
gradient is another sum). Inputs are drawn away from kinks and ties;
the rules at kinks and ties (reductions and elementwise max/min at
ties, clip at its bounds, abs, relu6 and hard_shrink at their kinks,
round, floor, ceil) are pinned one by one below."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as ref_registry
from paddle_tpu_torch.core import registry as port_registry
from test_torch_ops_cases import CASES, KEY_WORDS, Case, op_desc, rel_err
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

GRAD_CASES = [c for c in CASES if c.grad]


def _float_slots(inputs):
    """(slot, index) of every float32 input."""
    out = []
    for slot, v in sorted(inputs.items()):
        for i, a in enumerate(v if isinstance(v, list) else [v]):
            if np.asarray(a).dtype == np.float32:
                out.append((slot, i))
    return out


def grads(case, inputs=None, seed=7, jit=False):
    """(reference gradients, port gradients) of every float32 input, for
    seeded cotangents of every float output; ``jit``: the reference's
    compute jitted (one compile instead of an eager dispatch an
    operation)."""
    inputs = case.inputs() if inputs is None else inputs
    op = op_desc(case.op_type, inputs, case.attrs)
    diff = _float_slots(inputs)

    def values(wrap, leaves):
        vals = {k: [wrap(a) for a in (v if isinstance(v, list) else [v])]
                for k, v in inputs.items()}
        for (slot, i), leaf in zip(diff, leaves):
            vals[slot][i] = leaf
        return vals

    ref_key = jnp.asarray(KEY_WORDS, jnp.uint32) if case.key else None
    port_key = torch.tensor(KEY_WORDS) if case.key else None

    def ref_f(*leaves):
        ctx = ref_registry.ExecContext(op, values(jnp.asarray, leaves),
                                       rng_key=ref_key)
        out = ref_registry.normalize_outputs(
            op, ref_registry.get_op_def(case.op_type).compute(ctx))
        return [a for k in sorted(out) for a in out[k]
                if jnp.issubdtype(a.dtype, jnp.floating)]
    primals = [jnp.asarray(np.asarray(inputs[s] if not isinstance(
        inputs[s], list) else inputs[s][i])) for s, i in diff]
    outs, vjp = jax.vjp(jax.jit(ref_f) if jit else ref_f, *primals)
    rs = np.random.RandomState(seed)
    cots = [rs.standard_normal(o.shape).astype(np.asarray(o).dtype)
            for o in outs]
    want = [np.asarray(g) for g in vjp([jnp.asarray(c) for c in cots])]

    leaves = [torch.from_numpy(np.array(p)).requires_grad_() for p in
              primals]
    ctx = port_registry.ExecContext(
        op, values(lambda a: torch.from_numpy(np.array(a)), leaves),
        rng_key=port_key)
    out = port_registry.normalize_outputs(
        op, port_registry.get_op_def(case.op_type).compute(ctx))
    touts = [a for k in sorted(out) for a in out[k] if a.is_floating_point()]
    assert len(touts) == len(cots), case.id
    live = [(o, torch.from_numpy(c)) for o, c in zip(touts, cots)
            if o.requires_grad]
    got = torch.autograd.grad([o for o, _ in live], leaves,
                              [c.to(o.dtype) for o, c in live],
                              allow_unused=True) if live else \
        [None] * len(leaves)
    got = [np.zeros(p.shape, np.float32) if g is None else g.numpy()
           for g, p in zip(got, primals)]
    return want, got


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: c.id)
def test_gradient_matches_reference(case):
    want, got = grads(case)
    tol = max(case.tol, 4 * 2.0 ** -23) * 4
    for w, g in zip(want, got):
        assert g.shape == w.shape
        if not np.abs(w).max() and not np.abs(g).max():
            continue
        assert rel_err(g, w) <= tol, (case.id, rel_err(g, w), tol)


def _tie(op_type, x, attrs=(), slot="X", **more):
    inputs = {slot: np.asarray(x, np.float32)}
    inputs.update({k: np.asarray(v, np.float32) for k, v in more.items()})
    return Case(op_type, lambda rs: inputs, attrs)


# inputs sitting on each op's kink or tie
TIES = [
    _tie("reduce_max", [[1.0, 3.0, 3.0], [2.0, 2.0, 2.0]], {"dim": [1]}),
    _tie("reduce_min", [[1.0, 1.0, 3.0], [-2.0, 5.0, -2.0]],
         {"dim": None, "reduce_all": True}),
    _tie("maxout", np.ones((1, 4, 1, 2)), {"groups": 2}),
    _tie("elementwise_max", [[1.0, 2.0], [3.0, -1.0]], Y=[[1.0, 0.0],
                                                        [3.0, -1.0]]),
    _tie("elementwise_min", [[1.0, 2.0], [3.0, -1.0]], Y=[[1.0, 0.0],
                                                        [3.0, -1.0]]),
    _tie("clip", [-0.5, 0.7, 0.1, -1.0, 2.0], {"min": -0.5, "max": 0.7}),
    _tie("brelu", [0.0, 24.0, 3.0], {}),
    _tie("relu6", [0.0, 6.0, 3.0, -1.0], {}),
    _tie("abs", [0.0, -1.0, 2.0]),
    _tie("hard_shrink", [0.5, -0.5, 0.6, 0.0], {}),
    _tie("thresholded_relu", [1.0, 0.5, 2.0], {}),
    _tie("softplus", [0.0]),
    _tie("softsign", [0.0, -0.0]),
    _tie("l1_norm", [0.0, -1.0, 2.0]),
    _tie("round", [0.5, 1.5, 2.5, -0.5, 0.49]),
    _tie("floor", [1.0, -1.0, 1.5]),
    _tie("ceil", [1.0, -1.0, 1.5]),
    _tie("sign", [0.0, 1.0, -2.0]),
    _tie("hinge_loss", [[1.0], [-1.0]], slot="Logits",
         Labels=[[1.0], [0.0]]),
    _tie("sigmoid_cross_entropy_with_logits", [[0.0, 1.0]],
         Label=[[1.0, 0.0]]),
    _tie("leaky_relu", [0.0, -1.0, 1.0], {"alpha": 0.1}),
]


@pytest.mark.parametrize("case", TIES, ids=lambda c: c.op_type)
def test_kink_and_tie_rules_are_the_references(case):
    """At a tie or a kink the port's gradient is the reference's: shared
    evenly among tied maxima, halved at a clip bound or an
    elementwise tie, zero for the step functions."""
    want, got = grads(case)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w, err_msg=case.op_type)
