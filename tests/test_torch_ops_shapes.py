"""Build-time shapes of the LeNet-5/MNIST slice's op types: appending an
op of each case (``paddle_tpu_torch/probes/op_cases.py``) to a block
infers the output shapes and dtypes the reference's shape inference
gives (``core/registry.py`` ``infer_shape`` runs the op's torch compute
on meta tensors where the reference runs ``jax.eval_shape``), and with
the batch axis unknown (-1) for the ops whose shape rules run through
it."""

import numpy as np
import pytest

from paddle_tpu.core import framework as ref_framework
from paddle_tpu_torch.core import framework as port_framework
from paddle_tpu_torch.core import registry as port_registry
from test_torch_ops_cases import CASES, run_port


def _infer(pkg, case, inputs, unknown_batch):
    """The (shape, dtype) the package's ``infer_shape`` gives each output
    of an op of ``case`` appended to a block holding its inputs; with
    ``unknown_batch`` the first axis of X (or Input) is -1."""
    fw = ref_framework if pkg == "ref" else port_framework
    block = fw.Program().global_block()
    names = {}
    for slot, v in inputs.items():
        names[slot] = []
        for i, a in enumerate(v if isinstance(v, list) else [v]):
            n = "%s_%d" % (slot, i)
            shape = list(a.shape)
            if unknown_batch and slot in ("X", "Input"):
                shape[0] = -1
            block.create_var(name=n, shape=shape, dtype=str(a.dtype))
            names[slot].append(n)
    # the output slots (the forward test holds them equal to the
    # reference's)
    outs = {slot: ["%s_out_%d" % (slot, i) for i in range(len(v))]
            for slot, v in run_port(case, inputs).items()}
    for ns in outs.values():
        for n in ns:
            block.create_var(name=n)
    block.append_op(case.op_type, inputs=names, outputs=outs,
                    attrs=case.attrs)
    return {n: (tuple(block.var(n).shape), fw.dtype_name(block.var(n).dtype)
                if hasattr(fw, "dtype_name") else
                str(np.dtype(block.var(n).dtype)) if
                str(block.var(n).dtype) != "bfloat16" else "bfloat16")
            for ns in outs.values() for n in ns}


# the shape rules the batch axis runs through at build time
_UNKNOWN_BATCH = ("conv2d_transpose", "conv3d_transpose",
                  "pool2d_with_index", "spp", "im2sequence", "crop",
                  "expand", "fill_constant_batch_size_like", "pool3d",
                  "one_hot", "arg_min", "reduce_mean", "concat", "cast")


@pytest.mark.parametrize("case", [c for c in CASES if not
                                  port_registry.get_op_def(
                                      c.op_type).skip_eval_shape],
                         ids=lambda c: c.id)
def test_build_time_shapes_match_reference(case):
    """Appending the op infers the reference's output shapes and dtypes
    (``core/registry.py`` ``infer_shape`` on meta tensors), and with the
    batch axis unknown for the ops whose shape rules run through it."""
    inputs = case.inputs()
    for unknown in (False, True) if case.op_type in _UNKNOWN_BATCH \
            else (False,):
        want = _infer("ref", case, inputs, unknown)
        got = _infer("port", case, inputs, unknown)
        assert {k: (s, str(d)) for k, (s, d) in got.items()} == \
            {k: (s, str(d)) for k, (s, d) in want.items()}, unknown
