"""Reading parameters saved by the reference package.

``paddle_tpu.io.save_params`` writes ``<dir>/params.npz`` (arrays under
keys v0, v1, ...) and ``<dir>/params.meta.json`` ({key: variable
name}); :func:`load_params` reads that layout with numpy alone, and
:func:`params_from_jax` turns the arrays into tensors on a device."""

import json
import os

import numpy as np
import torch

from .models.transformer import infer_num_layers, lm_param_names
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
    name raises ValueError."""
    expected = set(lm_param_names(infer_num_layers(named)))
    missing = sorted(expected - set(named))
    unknown = sorted(set(named) - expected)
    if missing or unknown:
        raise ValueError("not the parameters of a transformer LM: missing "
                         "%s, unknown %s" % (missing, unknown))
    device = resolve_device(device)
    return {name: torch.as_tensor(np.asarray(val)).to(device)
            for name, val in named.items()}
