"""Input layers of the program front end (reference
``paddle_tpu/layers/io.py``)."""

from ..core.framework import default_main_program, convert_dtype

__all__ = ["data"]


def data(name, shape, dtype="float32", append_batch_size=True,
         stop_gradient=True, main_program=None, wire_dtype=None,
         scale=None, mean=None, std=None):
    """Declare a feed variable. ``append_batch_size`` prepends -1 like the
    reference (``fluid/layers/io.py data``).

    wire_dtype: the narrow dtype this feed crosses the host->device wire
    in (e.g. ``"uint8"`` images, ``"int32"`` ids). A feed arriving in
    wire form is kept narrow end to end (DataFeeder allocates batch
    buffers in it, reader/staging copies it) and the executor casts it
    to ``dtype`` on the card before the first op reads it, so the
    program sees the same widened tensors as on the plain path.
    scale/mean/std: optional per-feed normalize attrs applied on the card
    right after the widening cast, as ``(x * scale - mean) / std``;
    scalars or per-channel (axis 1) vectors. They fire only for feeds
    arriving in wire form: an already-widened (host-normalized) feed
    passes through untouched.
    """
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
    var.wire_dtype = convert_dtype(wire_dtype) if wire_dtype is not None \
        else None
    var.ingest = {"scale": scale, "mean": mean, "std": std} \
        if (scale is not None or mean is not None or std is not None) \
        else None
    return var
