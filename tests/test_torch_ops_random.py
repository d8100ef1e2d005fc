"""The random ops of the LeNet-5/MNIST slice against the reference's,
bit for bit: ``randint`` (``jax.random.randint``'s two draws, span,
multiplier and modulus on the port's threefry bits), ``sampling_id``
(``jax.random.categorical``: the argmax of the log probabilities plus
the Gumbel noise), ``nce``'s negative samples, and ``gaussian_random``
and ``uniform_random`` at float32, float16 and bfloat16 (the reference's
executor jits them: XLA rounds float16 within a fusion and bfloat16
after each operation). Through programs too: the executors split the
scope's key before each random op alike."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu_torch import core as pc
from paddle_tpu_torch.ops import random_ops
from test_torch_ops_cases import Case, run_port, run_ref
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("shape,low,high", [
    ((3, 4), -3, 17), ((1000,), 0, 10), ((7, 5), 0, 2 ** 31 - 1),
    ((6,), 5, 5), ((4, 4), -2 ** 31, 2 ** 31 - 1), ((5,), 100, 3),
    ((33,), 0, 1 << 20)])
@pytest.mark.parametrize("seed", [0, 12345])
def test_randint_bitwise(shape, low, high, seed):
    key = jnp.asarray([0, seed], jnp.uint32)
    want = np.asarray(jax.random.randint(key, shape, low, high,
                                         dtype=jnp.int32))
    got = random_ops.randint(torch.tensor([0, seed]), shape, low, high)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_id_equals_reference():
    """Ids equal the reference's on 64 rows of 50 columns (a tie of the
    noisy log probabilities within an ulp would be the only way apart;
    none in these rows)."""
    rs = np.random.RandomState(4)
    p = rs.uniform(0.01, 1.0, (64, 50)).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    case = Case("sampling_id", lambda r: {"X": p}, key=True)
    want = run_ref(case, jit=True)["Out"][0]
    got = run_port(case)["Out"][0]
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_nce_samples_bitwise():
    rs = np.random.RandomState(6)
    inputs = {"Input": rs.randn(8, 5).astype(np.float32),
              "Label": rs.randint(0, 30, (8, 1)).astype(np.int32),
              "Weight": rs.randn(30, 5).astype(np.float32)}
    case = Case("nce", lambda r: inputs, {"num_neg_samples": 12,
                                          "num_total_classes": 30},
                key=True)
    want, got = run_ref(case), run_port(case)
    np.testing.assert_array_equal(got["SampleLabels"][0],
                                  want["SampleLabels"][0])
    assert (want["SampleLabels"][0][:, 1:] < 30).all()


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16",
                                   "float64"])
@pytest.mark.parametrize("op,attrs", [
    ("gaussian_random", {"mean": 0.5, "std": 0.02}),
    ("gaussian_random", {"mean": -1.0, "std": 3.0}),
    ("uniform_random", {"min": -3.0, "max": 7.5}),
    ("uniform_random", {"min": 0.0, "max": 1.0})])
def test_draws_bitwise_at_every_dtype(op, attrs, dtype):
    attrs = dict(attrs, shape=[37, 29], dtype=dtype)
    case = Case(op, lambda r: {}, attrs, key=True)
    want = run_ref(case, jit=True)["Out"][0]
    got = run_port(case)["Out"][0]
    assert got.dtype == want.dtype
    if op == "gaussian_random" and dtype in ("float32", "float64"):
        # XLA's float32 erf_inv evaluated as XLA does: within 2 ulp
        scale = np.maximum(np.abs(want.astype(np.float64)), 1.0)
        assert (np.abs(got.astype(np.float64) - want) <=
                2 * 2.0 ** -23 * scale).all()
        return
    np.testing.assert_array_equal(got.view(np.uint16) if dtype ==
                                  "bfloat16" else got,
                                  want.view(np.uint16) if dtype ==
                                  "bfloat16" else want)


def _random_program(pkg):
    fw = ptpu if pkg == "ref" else pc
    main = fw.Program()
    main.random_seed = 21
    block = main.global_block()
    outs = []
    for i, (op, attrs) in enumerate([
            ("uniform_random", {"shape": [6, 5], "dtype": "float16",
                                "min": -1.0, "max": 2.0}),
            ("gaussian_random", {"shape": [4, 7], "dtype": "bfloat16",
                                 "mean": 0.0, "std": 1.0}),
            ("randint", {"shape": [9], "low": 0, "high": 1000}),
            ("gaussian_random", {"shape": [5], "dtype": "float16",
                                 "mean": 2.0, "std": 0.5})]):
        name = "r%d" % i
        block.create_var(name=name, persistable=True)
        block.append_op(op, outputs={"Out": [name]}, attrs=attrs,
                        infer_shape=False)
        outs.append(name)
    return main, outs


def test_draws_through_programs_bitwise():
    """One program of four random ops: the executors split the scope's
    key alike, so each op draws the reference's values."""
    main, outs = _random_program("ref")
    scope = ptpu.Scope()
    with ptpu.scope_guard(scope):
        ptpu.Executor().run(main)
    pmain, _ = _random_program("port")
    pscope = pc.Scope()
    pc.Executor(device="cpu").run(pmain, scope=pscope)
    for n in outs:
        want = np.asarray(scope.find_var(n))
        got = pscope.find_var(n)
        if got.dtype == torch.bfloat16:
            got = got.float().numpy().astype(jnp.bfloat16)
        else:
            got = got.numpy()
        assert got.dtype == want.dtype, n
        np.testing.assert_array_equal(got.view(np.uint16) if got.dtype ==
                                      jnp.bfloat16 else got,
                                      want.view(np.uint16) if want.dtype ==
                                      jnp.bfloat16 else want, err_msg=n)
