"""v2 Parameters handle (reference ``python/paddle/v2/parameters.py``):
a named view over the trained parameter values. Here parameters live in
the global Scope as torch tensors on the executor's device;
``create(cost)`` snapshots the topology's parameter names and the handle
reads and writes the scope: ``get`` returns a host numpy copy, ``set``
writes in place on the tensor's device and keeps its dtype.

Tar checkpoints (reference ``parameters.py:328 to_tar``, ``:358
from_tar``, ``:387 init_from_tar``): one tar member per parameter with
the reference's 16-byte header (``struct.pack("IIQ", version,
value_size, count)``) followed by the raw value bytes, plus a
``<name>.conf`` JSON member in place of the reference's
``<name>.protobuf`` ParameterConfig (this design is proto-less,
SURVEY N26). The format is ``paddle_tpu/v2/parameters.py``'s byte for
byte: a tar either package writes loads in the other.
"""

import io
import json
import struct
import tarfile

import numpy as np
import torch

from ..core.scope import global_scope
from . import place as _place

__all__ = ["Parameters", "create"]


def _host(value):
    """A host numpy copy of a scope value."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy().copy()
    return np.array(value)


class Parameters:
    def __init__(self, names=(), _local=None, device=None):
        self._names = list(names)
        # from_tar() products are DETACHED from the scope: values live
        # in this dict until pushed via init_from_tar / set on a
        # scope-backed handle.
        self._local = _local
        # where ``set`` puts a parameter the scope does not hold yet
        self._device = device

    def names(self):
        return list(self._names)

    def keys(self):
        return self.names()

    def __contains__(self, name):
        return name in self._names

    def get(self, name):
        if self._local is not None:
            v = self._local.get(name)
            return None if v is None else np.asarray(v)
        v = global_scope().find_var(name)
        return None if v is None else _host(v)

    __getitem__ = get

    def set(self, name, value):
        if self._local is not None:
            self._local[name] = np.asarray(value)
            if name not in self._names:
                self._names.append(name)
            return
        scope = global_scope()
        cur = scope.find_var(name)
        src = torch.as_tensor(np.array(value))
        if isinstance(cur, torch.Tensor):
            if tuple(src.shape) == tuple(cur.shape):
                with torch.no_grad():
                    cur.copy_(src)
                return
            scope.set_var(name, src.to(device=cur.device, dtype=cur.dtype))
            return
        device = self._device if self._device is not None else \
            _place.current()
        scope.set_var(name, src.to(device))

    __setitem__ = set

    def to_dict(self):
        return {n: self.get(n) for n in self._names}

    # -- tar checkpoints (the v2 event-handler save idiom) ------------

    def serialize(self, name, f):
        """Write one parameter in the reference's wire format
        (``parameters.py:297``): header (version=0, value_size,
        element count) then raw bytes."""
        param = np.ascontiguousarray(self.get(name))
        f.write(struct.pack("IIQ", 0, param.dtype.itemsize, param.size))
        f.write(param.tobytes())

    def deserialize(self, name, f, shape, dtype):
        f.read(16)  # header; shape/dtype come from the conf member
        arr = np.frombuffer(f.read(), dtype=dtype)
        self.set(name, arr.reshape(shape))

    def to_tar(self, f):
        """Save all parameters to an open binary file object as a tar
        archive (reference ``Parameters.to_tar``). Most callers should
        use ``trainer.save_parameter_to_tar(f)``."""
        tar = tarfile.TarFile(fileobj=f, mode="w")
        for nm in self._names:
            val = self.get(nm)
            if val is None:
                continue
            buf = io.BytesIO()
            self.serialize(nm, buf)
            info = tarfile.TarInfo(name=nm)
            info.size = buf.tell()
            buf.seek(0)
            tar.addfile(info, buf)

            conf = json.dumps({"name": nm, "shape": list(val.shape),
                               "dtype": str(val.dtype)}).encode()
            info = tarfile.TarInfo(name="%s.conf" % nm)
            info.size = len(conf)
            tar.addfile(info, io.BytesIO(conf))
        tar.close()

    @staticmethod
    def from_tar(f):
        """Create a detached Parameters from a tar checkpoint
        (reference ``Parameters.from_tar``) — it holds only the values
        in the file, independent of any scope/topology."""
        params = Parameters(_local={})
        tar = tarfile.TarFile(fileobj=f, mode="r")
        confs = {}
        for finfo in tar:
            if finfo.name.endswith(".conf"):
                conf = json.loads(tar.extractfile(finfo).read().decode())
                confs[conf["name"]] = conf
        for nm, conf in confs.items():
            params.deserialize(nm, tar.extractfile(nm),
                               tuple(conf["shape"]), conf["dtype"])
        return params

    def init_from_tar(self, f, exclude_params=()):
        """Init (a subset of) THIS handle's parameters from another
        saved model (reference ``Parameters.init_from_tar``) — names
        absent from this topology are ignored."""
        tar_param = Parameters.from_tar(f)
        for nm in tar_param.names():
            if nm in exclude_params or nm not in self._names:
                continue
            cur = self.get(nm)
            val = tar_param.get(nm)
            if cur is not None and tuple(cur.shape) != tuple(val.shape):
                raise ValueError(
                    "init_from_tar: shape mismatch for %r: %s vs %s"
                    % (nm, cur.shape, val.shape))
            self.set(nm, val)


def create(cost, device=None):
    """Collect the trainable parameters reachable from ``cost``'s
    program (v2 parameters.create). ``device``: where ``set`` places a
    parameter the scope does not hold yet (the ``init`` device when
    None)."""
    costs = cost if isinstance(cost, (list, tuple)) else [cost]
    block = costs[0].block.program.global_block()
    return Parameters([p.name for p in block.all_parameters()],
                      device=_place.current(device))
