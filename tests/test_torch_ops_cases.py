"""The op library of the LeNet-5/MNIST slice against the reference: the
helpers that run one case of ``paddle_tpu_torch/probes/op_cases.py``
(inputs from a seed, attributes, tolerance) through both packages'
registries, the reference's compute on jax arrays and the port's on CPU
tensors (``test_torch_ops_forward.py`` and ``test_torch_ops_grad.py``
run every case); and the registry's coverage: the port registers all
219 of the reference's op types, and ``core/registry.PENDING`` names
none.
"""

import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the reference's ops)
from paddle_tpu.core import registry as ref_registry
from paddle_tpu_torch.core import registry as port_registry
from paddle_tpu_torch.probes.op_cases import (  # noqa: F401
    CASES, CONV, EXACT, KEY_WORDS, SLICE_OPS, SUM, ULP4, Case, op_desc,
    to_torch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def one_thread():
    """The box's intra-op threads shared among the pytest-xdist workers
    for a module's tests (``usefixtures`` in their files): one each for
    the tier-1 run's six workers on 8 cores, torch's default when the
    tests run in one process. Each worker's default pool of one thread a
    core oversubscribes the cores six-fold, and the port's small CPU ops
    (the RNN slice's time loops are thousands of them) then wait on pool
    threads: six heavy port files took 1,709.7 worker-seconds under ``-n
    6 --dist loadfile`` with the default and 444.4 with one thread."""
    prev = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, prev // workers))
    yield
    torch.set_num_threads(prev)


# -- running one description through both registries ------------------------

def _listify(v):
    return v if isinstance(v, list) else [v]


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            return v.float().numpy().astype(jnp.bfloat16)
        return v.numpy()
    return np.asarray(v)


def run_ref(case, inputs=None, jit=False):
    """{slot: [numpy]} of the reference's compute on ``inputs``."""
    inputs = case.inputs() if inputs is None else inputs
    op = op_desc(case.op_type, inputs, case.attrs)
    key = jnp.asarray(KEY_WORDS, jnp.uint32) if case.key else None

    def f(vals, key):
        ctx = ref_registry.ExecContext(op, vals, rng_key=key)
        return ref_registry.normalize_outputs(
            op, ref_registry.get_op_def(case.op_type).compute(ctx))
    vals = {k: [jnp.asarray(a) for a in _listify(v)]
            for k, v in inputs.items()}
    out = (jax.jit(f) if jit else f)(vals, key)
    return {k: [np.asarray(a) for a in v] for k, v in out.items()}


def run_port(case, inputs=None, device="cpu", trace=None):
    """{slot: [numpy]} of the port's compute on ``inputs`` on
    ``device``."""
    inputs = case.inputs() if inputs is None else inputs
    op = op_desc(case.op_type, inputs, case.attrs)
    key = torch.tensor(KEY_WORDS, dtype=torch.int64, device=device) \
        if case.key else None
    vals = {k: [to_torch(a, device) for a in _listify(v)]
            for k, v in inputs.items()}
    trace = trace or SimpleNamespace(device=torch.device(device),
                                     inplace=False)
    ctx = port_registry.ExecContext(op, vals, rng_key=key, trace=trace)
    with torch.no_grad():
        out = port_registry.normalize_outputs(
            op, port_registry.get_op_def(case.op_type).compute(ctx))
    return {k: [_to_numpy(a.cpu()) for a in v] for k, v in out.items()}


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if want.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_outputs_match(port, ref, tol, what=""):
    """Same slots, element counts, shapes and dtypes; values within
    ``tol`` (bitwise for 0; NaN where the reference has NaN)."""
    assert sorted(port) == sorted(ref), (what, sorted(port), sorted(ref))
    for slot in ref:
        assert len(port[slot]) == len(ref[slot]), (what, slot)
        for p, r in zip(port[slot], ref[slot]):
            assert p.shape == r.shape, (what, slot, p.shape, r.shape)
            assert np.dtype(p.dtype) == np.dtype(r.dtype), \
                (what, slot, p.dtype, r.dtype)
            if r.dtype == np.bool_ or np.issubdtype(r.dtype, np.integer) \
                    or tol == 0:
                np.testing.assert_array_equal(
                    p.view(np.uint16) if r.dtype == jnp.bfloat16 else p,
                    r.view(np.uint16) if r.dtype == jnp.bfloat16 else r,
                    err_msg="%s %s" % (what, slot))
            else:
                assert rel_err(p, r) <= tol, (what, slot, rel_err(p, r),
                                              tol)


# -- the registry's coverage ------------------------------------------------

def _reference_registry():
    import importlib
    import pkgutil
    import paddle_tpu
    for m in pkgutil.walk_packages(paddle_tpu.__path__, "paddle_tpu."):
        if m.name.startswith(("paddle_tpu.ops.", "paddle_tpu.embeddings.")):
            importlib.import_module(m.name)
    return set(ref_registry.registered_ops())


def _queue_a_titles():
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        section = f.read().split("### Queue A")[1].split("### Queue B")[0]
    return [re.sub(r"\s+", " ", t).strip() for t in re.findall(
        r"^\d+\.\s+\*\*(.+?)\*\*", section, re.M | re.S)]


def test_the_slice_registers_118_op_types():
    assert len(SLICE_OPS) == 118
    assert set(SLICE_OPS) <= set(port_registry.registered_ops())


def test_registered_and_pending_partition_the_reference():
    """Every reference op type is registered in the port or named in
    ``PENDING``, never both: all 219 registered, none pending."""
    ref = _reference_registry()
    port = set(port_registry.registered_ops())
    pending = set(port_registry.PENDING)
    assert len(ref) == 219
    assert port <= ref
    assert not port & pending
    assert port | pending == ref, sorted(ref - port - pending)
    assert (len(port), len(pending)) == (219, 0)


def test_pending_ops_cite_their_queue_a_item():
    """Nothing is pending: the registry's refusal of an unknown op type
    names no Queue A item, and a citation would have to name a Queue A
    title."""
    titles = _queue_a_titles()
    assert port_registry.PENDING == {}
    assert any(t.startswith("Long tail") for t in titles)
    with pytest.raises(NotImplementedError, match="no op registered"):
        port_registry.get_op_def("lstm")


def test_flags_of_the_slice_ops_are_the_references():
    """needs_rng and skip_eval_shape as the reference registers them."""
    for op_type in SLICE_OPS:
        ours = port_registry.get_op_def(op_type)
        theirs = ref_registry.get_op_def(op_type)
        assert (ours.needs_rng, ours.skip_eval_shape) == \
            (theirs.needs_rng, theirs.skip_eval_shape), op_type
