"""Tensor plumbing ops (reference ``paddle_tpu/ops/tensor_ops.py``):
``cast``, ``concat``, ``split``, ``reshape``, ``transpose``, ``flip``,
``pad``, ``crop``, ``expand``, ``gather``, ``scatter``, ``multiplex``,
the fills, ``assign``, ``assign_value``, ``increment``, ``is_empty``,
``one_hot``, ``lookup_table``, ``shape``, ``slice``, ``stack``,
``unstack``, ``arg_max``, ``arg_min`` and ``top_k``; and the
tensor-array ops ``array_write`` and ``array_read`` over a preallocated
[max_len, ...] buffer, whose runtime index is clamped into bounds on the
device as XLA's dynamic slices clamp it (torch's index ops on the card
would assert instead).

Every op stays on the run's device: ``shape``, ``is_empty`` and
``increment`` give tensors there, read nothing back to the host, and a
constant the op needs from its attributes (``assign_value``'s values,
``shape``'s dims) is copied to the card once and cloned on the card at
each run, so that a captured step (``core/executor.py``) replays it.
"""

import functools

import numpy as np
import torch

from ..core.framework import convert_dtype, torch_dtype
from ..core.registry import register_op
from .nn_ops import argmax, gather


def _device(ctx):
    """Where an op without tensor inputs puts its output: the run's
    device (the CPU under a bare context, as in a test)."""
    return ctx.trace.device if ctx.trace is not None else "cpu"


@functools.lru_cache(maxsize=256)
def _on_device(values, shape, dtype, device):
    """A tensor of ``values`` (a tuple) reshaped to ``shape`` on
    ``device``, made once per distinct constant; callers clone it."""
    arr = np.asarray(values, dtype=dtype).reshape(shape)
    return torch.from_numpy(arr).to(device)


@register_op("cast")
def _cast(ctx):
    """``astype`` with the reference's dtype policy (64-bit types are
    their 32-bit kin); float to int truncates toward zero."""
    dtype = torch_dtype(ctx.attr("out_dtype", ctx.attr("dtype", "float32")))
    return {"Out": ctx.input("X").to(dtype)}


@register_op("concat")
def _concat(ctx):
    return {"Out": torch.cat(ctx.inputs("X"), dim=ctx.attr("axis", 0))}


@register_op("split")
def _split(ctx):
    """Into ``sections`` (their sizes) or ``num`` equal parts along
    ``axis``."""
    x = ctx.input("X")
    axis = ctx.attr("axis", 0)
    sections = ctx.attr("sections")
    if sections:
        outs = torch.split(x, list(sections), dim=axis)
    else:
        num = ctx.attr("num")
        if x.shape[axis] % num:
            raise ValueError("split of %d into %d equal parts"
                             % (x.shape[axis], num))
        outs = torch.split(x, x.shape[axis] // num, dim=axis)
    return {"Out": list(outs)}


@register_op("reshape")
def _reshape(ctx):
    return {"Out": ctx.input("X").reshape(list(ctx.attr("shape")))}


@register_op("transpose")
def _transpose(ctx):
    return {"Out": ctx.input("X").permute(*ctx.attr("axis"))}


@register_op("flip")
def _flip(ctx):
    axis = ctx.attr("axis")
    dims = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    return {"Out": torch.flip(ctx.input("X"), dims=dims)}


@register_op("pad")
def _pad(ctx):
    """Constant padding; ``paddings`` is flat [before0, after0, before1,
    ...] over every axis."""
    x = ctx.input("X")
    p = ctx.attr("paddings")
    pads = []
    for i in reversed(range(x.dim())):
        pads += [p[2 * i], p[2 * i + 1]]
    return {"Out": torch.nn.functional.pad(x, pads,
                                           value=ctx.attr("pad_value", 0.0))}


@register_op("crop")
def _crop(ctx):
    """``shape`` from ``offsets``; a -1 keeps the axis from its offset to
    the end (a dynamic batch)."""
    x = ctx.input("X")
    slices = tuple(slice(o, None if s == -1 else o + s)
                   for o, s in zip(ctx.attr("offsets"), ctx.attr("shape")))
    return {"Out": x[slices]}


@register_op("expand")
def _expand(ctx):
    """``jnp.tile(x, expand_times)``: fewer times than axes tile the
    trailing axes, more prepend axes."""
    x = ctx.input("X")
    times = list(ctx.attr("expand_times"))
    times = [1] * (x.dim() - len(times)) + times
    return {"Out": x.repeat(*times)}


@register_op("gather")
def _gather(ctx):
    """Rows ``Index`` (flattened) of X along axis 0."""
    return {"Out": gather(ctx.input("X"), ctx.input("Index"))}


def scatter(x, index, updates):
    """``x.at[index].set(updates)`` over rows: X with row ``index[i]``
    replaced by ``updates[i]``. Where an index repeats, the last of its
    updates is the one kept, as the reference's scatter keeps on the
    CPU, and only that update takes the row's gradient, as JAX's scatter
    rule gives it. Computed as a gather from the last position of each
    row (a ``scatter_reduce`` of the positions by max), so the result
    does not depend on the order of parallel writes on the card."""
    idx = index.reshape(-1).to(torch.int64)
    pos = torch.arange(idx.numel(), device=idx.device)
    last = torch.full((x.shape[0],), -1, dtype=torch.int64,
                      device=idx.device).scatter_reduce(0, idx, pos, "amax")
    src = updates.reshape((idx.numel(),) + tuple(x.shape[1:]))[
        last.clamp(min=0)].to(x.dtype)
    has = (last >= 0).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(has, src, x)


@register_op("scatter")
def _scatter(ctx):
    return {"Out": scatter(ctx.input("X"), ctx.input("Index"),
                           ctx.input("Updates"))}


def _array_index(i, n):
    """The [1] int64 row of a runtime scalar index into ``n`` rows, as
    ``lax.dynamic_index_in_dim`` takes it: a negative index counts from
    the end once, then the index is clamped into [0, n - 1]."""
    idx = i.reshape(1).to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.clamp(idx, 0, n - 1)


@register_op("array_write")
def _array_write(ctx):
    """arr[i] = x, returning the updated array."""
    arr, x, i = ctx.input("Array"), ctx.input("X"), ctx.input("I")
    idx = _array_index(i, arr.shape[0])
    return {"Out": arr.index_copy(0, idx, x.to(arr.dtype)[None])}


@register_op("array_read")
def _array_read(ctx):
    """arr[i]."""
    arr, i = ctx.input("Array"), ctx.input("I")
    return {"Out": arr.index_select(0, _array_index(i, arr.shape[0]))[0]}


@register_op("multiplex")
def _multiplex(ctx):
    """Row i of the ``Ids[i]``-th input."""
    ids = ctx.input("Ids").reshape(-1).to(torch.int64)
    stack = torch.stack(ctx.inputs("X"), dim=0)
    rows = torch.arange(stack.shape[1], device=stack.device)
    return {"Out": stack[ids, rows]}


@register_op("slice")
def _slice(ctx):
    x = ctx.input("Input")
    index = [slice(None)] * x.dim()
    for ax, st, en in zip(ctx.attr("axes"), ctx.attr("starts"),
                          ctx.attr("ends")):
        index[ax] = slice(st, en)
    return {"Out": x[tuple(index)]}


@register_op("arg_max")
def _arg_max(ctx):
    """The first maximum's index along ``axis``, int32 as the
    reference's."""
    return {"Out": argmax(ctx.input("X"), ctx.attr("axis", -1)).to(
        torch.int32)}


@register_op("arg_min")
def _arg_min(ctx):
    """The first minimum's index along ``axis``, int32."""
    return {"Out": torch.argmin(ctx.input("X"), dim=ctx.attr("axis", -1))
            .to(torch.int32)}


@register_op("top_k")
def _top_k(ctx):
    """The k largest entries of each row and their int32 indices."""
    vals, idx = torch.topk(ctx.input("X"), ctx.attr("k", 1), dim=-1)
    return {"Out": vals, "Indices": idx.to(torch.int32)}


@register_op("fill_constant", skip_eval_shape=True)
def _fill_constant(ctx):
    """A tensor of ``shape`` filled with ``value``, on the run's device
    (the op has no input to take it from)."""
    return {"Out": torch.full(tuple(ctx.attr("shape")),
                              ctx.attr("value", 0.0),
                              dtype=torch_dtype(ctx.attr("dtype", "float32")),
                              device=_device(ctx))}


@register_op("fill_like")
def _fill_like(ctx):
    return {"Out": torch.full_like(ctx.input("X"), ctx.attr("value", 0.0))}


@register_op("fill_zeros_like")
def _fill_zeros_like(ctx):
    return {"Out": torch.zeros_like(ctx.input("X"))}


@register_op("fill_constant_batch_size_like")
def _fill_constant_batch_size_like(ctx):
    """A fill of ``shape`` whose ``output_dim_idx`` axis is Input's
    ``input_dim_idx`` axis, on Input's device."""
    x = ctx.input("Input")
    shape = list(ctx.attr("shape"))
    shape[ctx.attr("output_dim_idx", 0)] = x.shape[
        ctx.attr("input_dim_idx", 0)]
    return {"Out": torch.full(tuple(shape), ctx.attr("value", 0.0),
                              dtype=torch_dtype(ctx.attr("dtype",
                                                         "float32")),
                              device=x.device)}


@register_op("assign")
def _assign(ctx):
    """A copy of X: an update op may later write into X in place."""
    return {"Out": ctx.input("X").clone()}


@register_op("assign_value", skip_eval_shape=True)
def _assign_value(ctx):
    """The literal ``values`` of ``dtype``, reshaped to ``shape``."""
    dtype = convert_dtype(ctx.attr("dtype", "float32"))
    src = _on_device(tuple(ctx.attr("values")), tuple(ctx.attr("shape")),
                     np.dtype(dtype).name, str(_device(ctx)))
    return {"Out": src.clone()}


@register_op("increment")
def _increment(ctx):
    """``x + step`` in x's dtype (an integer step for an integer x)."""
    x = ctx.input("X")
    step = ctx.attr("step", 1.0)
    if not x.is_floating_point():
        step = int(step)
    return {"Out": x + torch.full((), step, dtype=x.dtype, device=x.device)}


@register_op("is_empty")
def _is_empty(ctx):
    """A 0-d bool on X's device: whether X has no element."""
    x = ctx.input("X")
    return {"Out": torch.full((), x.numel() == 0, dtype=torch.bool,
                              device=x.device)}


@register_op("one_hot")
def _one_hot(ctx):
    """float32 one-hot rows of ``depth`` (a trailing ids axis of 1 is
    dropped); an id outside [0, depth) gives a row of zeros, as
    ``jax.nn.one_hot``."""
    ids = ctx.input("X")
    if ids.dim() and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    classes = torch.arange(ctx.attr("depth"), device=ids.device)
    return {"Out": (ids.unsqueeze(-1) == classes).to(torch.float32)}


@register_op("shape")
def _shape(ctx):
    """Input's shape as an int32 vector on its device."""
    x = ctx.input("Input")
    if x.device.type == "meta":
        return {"Out": torch.empty((x.dim(),), dtype=torch.int32,
                                   device="meta")}
    return {"Out": _on_device(tuple(x.shape), (x.dim(),), "int32",
                              str(x.device)).clone()}


@register_op("stack")
def _stack(ctx):
    return {"Out": torch.stack(ctx.inputs("X"), dim=ctx.attr("axis", 0))}


@register_op("unstack")
def _unstack(ctx):
    return {"Out": list(torch.unbind(ctx.input("X"),
                                     dim=ctx.attr("axis", 0)))}


@register_op("lookup_table")
def _lookup_table(ctx):
    """Embedding lookup (reference ``lookup_table``): the rows of W at
    the flattened ids, zero at ``padding_idx``; a trailing ids axis of 1
    is squeezed unless ``keep_dims``. Its gradient is a dense scatter-add
    into W (``index_select``'s backward), as the reference's vjp of
    ``take``."""
    w, ids = ctx.input("W"), ctx.input("Ids")
    flat = ids.reshape(-1)
    emb = w.index_select(0, flat)
    pad = ctx.attr("padding_idx")
    if pad is not None:
        emb = torch.where((flat == pad)[:, None],
                          torch.zeros((), dtype=emb.dtype, device=emb.device),
                          emb)
    shape = tuple(ids.shape)
    if not ctx.attr("keep_dims", False) and shape and shape[-1] == 1:
        shape = shape[:-1]
    return {"Out": emb.reshape(shape + (w.shape[1],))}
