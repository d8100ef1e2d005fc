"""Input layers of the program front end (reference
``paddle_tpu/layers/io.py``)."""

from ..core.framework import default_main_program, convert_dtype

__all__ = ["data"]


def data(name, shape, dtype="float32", append_batch_size=True,
         stop_gradient=True, main_program=None, wire_dtype=None,
         scale=None, mean=None, std=None):
    """Declare a feed variable. ``append_batch_size`` prepends -1 like the
    reference (``fluid/layers/io.py data``). The reference's narrow-wire
    feeds (``wire_dtype``, ``scale``, ``mean``, ``std``) are not ported:
    giving one raises."""
    if any(v is not None for v in (wire_dtype, scale, mean, std)):
        raise NotImplementedError(
            "narrow-wire feeds are not ported yet: ROADMAP Queue A, "
            "\"Ingest, the compile cache and AOT\"")
    program = main_program or default_main_program()
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = program.global_block()
    if block.has_var(name):
        var = block.var(name)
        var.shape = tuple(shape)
        var.dtype = convert_dtype(dtype)
    else:
        var = block.create_var(name=name, shape=shape, dtype=dtype,
                               stop_gradient=stop_gradient, is_data=True)
    return var
