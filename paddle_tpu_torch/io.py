"""Reading parameters saved by the reference package.

``paddle_tpu.io.save_params`` writes ``<dir>/params.npz`` (arrays under
keys v0, v1, ...) and ``<dir>/params.meta.json`` ({key: variable
name}); :func:`load_params` reads that layout with numpy alone, and
:func:`params_from_jax` turns the arrays into tensors on a device (the
LM's serving weights) or copies them into a model (a ResNet or a
transformer LM) and its optimizer by name. :func:`scope_from_jax` puts
them into a ``core.Scope``, from which the Executor runs a program."""

import json
import os

import numpy as np
import torch

from .core.scope import Scope
from .models.transformer import check_lm_params, infer_num_layers
from .optimizer import LR_NAME
from .place import resolve_device

__all__ = ["load_params", "params_from_jax", "scope_from_jax"]

# the reference scope's random-number state (``core/framework.py``
# RNG_STATE_VAR): no ported path draws from it
RNG_STATE = "@RNG_STATE@"


def load_params(dirname, filename="params"):
    """{variable name: np.ndarray} from a reference params checkpoint."""
    path = os.path.join(dirname, filename)
    with open(os.path.join(dirname, filename + ".meta.json")) as f:
        meta = json.load(f)
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        return {name: data[key] for key, name in meta.items()}


def params_from_jax(named, device=None, model=None, optimizer=None):
    """{reference name: array} -> {name: tensor} on ``device`` (default
    CUDA).

    Without ``model``: the transformer LM. Every name of the LM whose
    layer count the names imply must be present, and no other: a missing
    or unknown name raises ValueError. An armed reference scope is
    accepted as it is: the int8 form of a mul weight with its scales
    under ``<name>@quant.scale`` (``models.transformer.check_lm_params``).

    With ``model`` (a ``models.resnet.ResNet`` or a
    ``models.transformer.TransformerLM``): the reference scope's
    parameters (and a ResNet's running statistics) are copied into the
    model by name (``model.reference_tensors()``), and with ``optimizer``
    its accumulators (``optimizer.accumulators()``: Momentum's
    ``<param>_velocity_acc_0``, Adam's moments and beta powers) and
    ``learning_rate_0`` into the optimizer. The names must be exactly
    those, with the model's shapes: a missing or unknown name, or another
    shape, raises ValueError before anything is copied. The tensors go to
    the model's device; ``device`` must then be left out.

    Either way a scope's ``@RNG_STATE@`` is dropped: a whole reference
    scope after ``startup`` loads as it is."""
    named = {n: v for n, v in named.items() if n != RNG_STATE}
    if model is None:
        check_lm_params(named, infer_num_layers(named))
        device = resolve_device(device)
        return {name: torch.as_tensor(np.asarray(val)).to(device)
                for name, val in named.items()}
    if device is not None:
        raise ValueError("device is the model's own (%s): leave it out with "
                         "model" % model.device)
    targets = dict(model.reference_tensors())
    if optimizer is not None:
        targets.update(optimizer.accumulators())
    lr = {LR_NAME} if optimizer is not None else set()
    missing = sorted(set(targets) - set(named))
    unknown = sorted(set(named) - set(targets) - lr)
    if missing or unknown:
        raise ValueError("names do not match the model%s: missing %s, "
                         "unknown %s" % (" and optimizer" if optimizer
                                         else "", missing, unknown))
    src = {name: torch.as_tensor(np.asarray(val))
           for name, val in named.items()}
    for name, t in src.items():
        if name not in lr and tuple(t.shape) != tuple(targets[name].shape):
            raise ValueError("%s: shape %s, expected %s" % (
                name, tuple(t.shape), tuple(targets[name].shape)))
    out = {}
    with torch.no_grad():
        for name, t in src.items():
            if name in lr:
                optimizer.learning_rate = float(t.reshape(-1)[0])
                out[name] = t.to(model.device)
                continue
            targets[name].copy_(t)
            out[name] = targets[name]
    return out


def scope_from_jax(named, device=None):
    """{reference scope name: array} -> a new ``core.Scope`` holding a
    copy of each as a tensor on ``device`` (default CUDA), under its own
    name and dtype (the executor updates state in place; the caller's
    arrays stay as they are): int8 weights with their ``@quant.scale``
    sidecars stay as they are, and only ``@RNG_STATE@`` is dropped, as
    :func:`params_from_jax` drops it (the port's executor seeds its own
    key from the program's ``random_seed``)."""
    device = resolve_device(device)
    scope = Scope()
    for name, val in named.items():
        if name != RNG_STATE:
            scope.set_var(name, torch.tensor(np.asarray(val), device=device))
    return scope
