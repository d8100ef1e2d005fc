"""Program IR: Variable / Operator / Block / Program (reference
``paddle_tpu/core/framework.py``).

A pure-Python description of a program, as in the reference: a Program
is a list of Blocks, a Block an ordered op list plus a symbol table.
Shapes and dtypes are inferred when an op is appended, by running the
op's torch compute on ``meta`` tensors (``registry.infer_shape``), and
the Executor (``executor.py``) runs a Block op by op.

Dtypes are numpy dtype objects, as in the reference, with one exception:
bfloat16, which numpy lacks, is ``torch.bfloat16`` here where the
reference holds ``jnp.bfloat16``; both serialize as "bfloat16".
"""

import contextlib

import numpy as np
import torch

from . import unique_name

__all__ = [
    "Variable",
    "Operator",
    "Block",
    "Program",
    "Parameter",
    "default_main_program",
    "default_startup_program",
    "program_guard",
    "switch_main_program",
    "switch_startup_program",
    "convert_dtype",
    "dtype_name",
    "torch_dtype",
]

# Reserved scope entry holding the PRNG key threaded through random ops.
RNG_STATE_VAR = "@RNG_STATE@"

BFLOAT16 = torch.bfloat16

# the reference's policy without jax x64 (which the port never enables):
# 64-bit types are demoted to their 32-bit kin
_DEMOTE = {np.dtype("int64"): np.dtype("int32"),
           np.dtype("uint64"): np.dtype("uint32"),
           np.dtype("float64"): np.dtype("float32")}


def convert_dtype(dtype):
    """Normalize a user dtype (str, numpy, torch) to a numpy dtype object,
    or ``torch.bfloat16`` for bfloat16."""
    if dtype is None:
        return np.dtype("float32")
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).replace("torch.", "")
    if isinstance(dtype, str):
        aliases = {"float": "float32", "double": "float64", "half": "float16",
                   "int": "int32", "long": "int64", "bfloat16": "bfloat16"}
        dtype = aliases.get(dtype, dtype)
    if dtype == "bfloat16" or dtype is BFLOAT16:
        return BFLOAT16
    dt = np.dtype(dtype)
    return _DEMOTE.get(dt, dt)


def dtype_name(dtype):
    """The name of a dtype as the reference prints and serializes it."""
    if dtype is BFLOAT16 or str(dtype) == "bfloat16":
        return "bfloat16"
    return np.dtype(dtype).name


def torch_dtype(dtype):
    """The torch dtype of a program dtype."""
    dt = convert_dtype(dtype)
    return dt if dt is BFLOAT16 else getattr(torch, dt.name)


class Variable:
    """A named value in a Block.

    Mirrors the reference Variable (framework.py:125): name, shape, dtype,
    persistable flag, stop_gradient. ``shape`` may contain -1 in the batch
    position at build time; the executor specializes on concrete feed shapes.
    """

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 persistable=False, stop_gradient=False, trainable=False,
                 initializer=None, is_data=False):
        self.block = block
        if name is None:
            name = unique_name.generate("tmp")
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.trainable = trainable
        self.initializer = initializer
        self.is_data = is_data
        # Narrow-wire feed declaration (layers.data wire_dtype/scale/
        # mean/std): feeds arriving in ``wire_dtype`` stay narrow on the
        # wire and are widened/normalized on the card by the executor's
        # ingest prologue (core/ingest.py). None = the plain feed path.
        # Not serialized, as in the reference.
        self.wire_dtype = None
        self.ingest = None
        self.op = None  # producing operator, if any

    @property
    def program(self):
        return self.block.program

    def __repr__(self):
        return "Variable(%s, shape=%s, dtype=%s%s)" % (
            self.name, self.shape, dtype_name(self.dtype),
            ", persistable" if self.persistable else "")

    __str__ = __repr__


class Parameter(Variable):
    """A trainable persistable Variable (reference framework.py:931)."""

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 initializer=None, regularizer=None, gradient_clip=None,
                 trainable=True, learning_rate=1.0):
        super().__init__(block, name=name, shape=shape, dtype=dtype,
                         persistable=True, trainable=trainable,
                         initializer=initializer)
        self.regularizer = regularizer
        self.gradient_clip = gradient_clip
        self.optimize_attr = {"learning_rate": learning_rate}


class Operator:
    """One op in a Block: type, named input/output var lists, attrs.

    Mirrors reference Operator (framework.py:350) minus the protobuf round
    trip. inputs/outputs map slot name -> list[str] of variable names.
    """

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input(self, slot):
        names = self.inputs.get(slot, [])
        return names[0] if names else None

    def output(self, slot):
        names = self.outputs.get(slot, [])
        return names[0] if names else None

    def input_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    def output_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def __repr__(self):
        def fmt(d):
            return ", ".join("%s=%s" % (k, v) for k, v in sorted(d.items()))
        return "{%s: (%s) -> (%s)}" % (self.type, fmt(self.inputs),
                                       fmt(self.outputs))


class Block:
    """An ordered op list plus a var symbol table (reference framework.py:621)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}
        self.ops = []

    @property
    def parent(self):
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, **kwargs):
        var = Variable(self, **kwargs)
        if var.name in self.vars:
            raise ValueError("Variable %r already exists in block %d"
                             % (var.name, self.idx))
        self.vars[var.name] = var
        return var

    def create_parameter(self, **kwargs):
        # Parameters always live in the program's global (0th) block, like the
        # reference (framework.py: global_block().create_parameter).
        gblock = self.program.global_block()
        param = Parameter(gblock, **kwargs)
        if param.name in gblock.vars:
            raise ValueError("Parameter %r already exists" % param.name)
        gblock.vars[param.name] = param
        return param

    def var(self, name):
        """Look up ``name`` in this block then ancestors (scope chaining)."""
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent
        raise KeyError("Variable %r not found in block %d or ancestors"
                       % (name, self.idx))

    def has_var(self, name):
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    def var_or_none(self, name):
        try:
            return self.var(name)
        except KeyError:
            return None

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        if infer_shape:
            from . import registry
            registry.infer_shape(op, self)
        for ns in op.outputs.values():
            for n in ns:
                v = self.var_or_none(n)
                if v is not None and v.op is None:
                    v.op = op
        return op

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def __repr__(self):
        lines = ["Block(%d):" % self.idx]
        for v in self.vars.values():
            lines.append("  " + repr(v))
        for op in self.ops:
            lines.append("  " + repr(op))
        return "\n".join(lines)


_program_uid_counter = [0]


class Program:
    """A list of Blocks; block 0 is global (reference framework.py:789)."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._version = 0  # bumped on mutation; part of the executor's plan key
        # Monotonic uid: executor plan keys use this instead of id() so a
        # GC'd Program's id being reused can never alias a stale plan.
        _program_uid_counter[0] += 1
        self._uid = _program_uid_counter[0]
        self.random_seed = None

    # -- structure -----------------------------------------------------------
    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx=None):
        if parent_idx is None:
            parent_idx = self.current_block_idx
        block = Block(self, len(self.blocks), parent_idx)
        self.blocks.append(block)
        self.current_block_idx = block.idx
        self._bump_version()
        return block

    def rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def _bump_version(self):
        self._version += 1

    def all_parameters(self):
        return self.global_block().all_parameters()

    def list_vars(self):
        for block in self.blocks:
            yield from block.vars.values()

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)


_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


def switch_main_program(program):
    global _main_program
    prev, _main_program = _main_program, program
    return prev


def switch_startup_program(program):
    global _startup_program
    prev, _startup_program = _startup_program, program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    """Route layer construction into the given programs (reference parity)."""
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)
