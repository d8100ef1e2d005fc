"""Every op type of the LeNet-5/MNIST slice, forward: the port's compute
against the reference's on the same inputs (the cases and their
tolerances are ``paddle_tpu_torch/probes/op_cases.py``'s), with the same
output slots, shapes and dtypes; and the unary activations at float16
and bfloat16. ``test_torch_ops_shapes.py`` holds the build-time
shapes."""

import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu_torch.probes.op_cases import FAMILIES
from test_torch_ops_cases import (CASES, assert_outputs_match, run_port,
                                  run_ref)
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

_RANDOM = ("randint", "gaussian_random", "uniform_random")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_forward_matches_reference(case):
    # the random ops as the reference's executor runs them, jitted (XLA
    # rounds 16-bit floats within a fusion)
    ref = run_ref(case, jit=case.op_type in _RANDOM)
    port = run_port(case)
    assert_outputs_match(port, ref, case.tol, case.id)


@pytest.mark.parametrize("dt", [np.float16, jnp.bfloat16],
                         ids=["float16", "bfloat16"])
def test_unary_activations_keep_half_dtypes(dt):
    """A float16 or bfloat16 input gives an output of its dtype, within
    two steps of the dtype of the reference's."""
    step = 2.0 ** -7 if dt == jnp.bfloat16 else 2.0 ** -10
    for case in CASES:
        if case.op_type not in FAMILIES["activation"] or \
                case.op_type == "prelu":
            continue
        inputs = {"X": case.inputs()["X"].astype(dt)}
        ref = run_ref(case, inputs)["Out"][0]
        port = run_port(case, inputs)["Out"][0]
        assert port.dtype == ref.dtype, case.id
        want = ref.astype(np.float32)
        err = np.abs(port.astype(np.float32) - want)
        assert (err <= 2 * step * np.maximum(np.abs(want), 1)).all(), \
            case.id
