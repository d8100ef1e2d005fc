"""Reading parameters saved by the reference package.

``paddle_tpu.io.save_params`` writes ``<dir>/params.npz`` (arrays under
keys v0, v1, ...) and ``<dir>/params.meta.json`` ({key: variable
name}); :func:`load_params` reads that layout with numpy alone, and
:func:`params_from_jax` turns the arrays into tensors on a device."""

import json
import os

import numpy as np
import torch

from .models.transformer import check_lm_params, infer_num_layers
from .place import resolve_device

__all__ = ["load_params", "params_from_jax"]


def load_params(dirname, filename="params"):
    """{variable name: np.ndarray} from a reference params checkpoint."""
    path = os.path.join(dirname, filename)
    with open(os.path.join(dirname, filename + ".meta.json")) as f:
        meta = json.load(f)
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        return {name: data[key] for key, name in meta.items()}


def params_from_jax(named, device=None):
    """{reference name: array} of the transformer LM -> {name: tensor}
    on ``device`` (default CUDA). Every name of the LM whose layer count
    the names imply must be present, and no other: a missing or unknown
    name raises ValueError. An armed reference scope is accepted as it
    is: the int8 form of a mul weight with its scales under
    ``<name>@quant.scale`` (``models.transformer.check_lm_params``)."""
    check_lm_params(named, infer_num_layers(named))
    device = resolve_device(device)
    return {name: torch.as_tensor(np.asarray(val)).to(device)
            for name, val in named.items()}
