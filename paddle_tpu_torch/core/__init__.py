"""Core: IR (framework), registry, executor, backward, scope,
serialization (reference ``paddle_tpu/core``)."""

from . import unique_name  # noqa: F401
from .framework import (  # noqa: F401
    Program, Block, Operator, Variable, Parameter,
    default_main_program, default_startup_program, program_guard,
    switch_main_program, switch_startup_program, convert_dtype)
from .scope import Scope, global_scope, scope_guard  # noqa: F401
from .executor import Executor  # noqa: F401
from .backward import append_backward, grad_var_name  # noqa: F401
