"""Where the v2 surface runs.

``paddle.init`` records a device; ``SGD``, ``SGD.test``, ``Inference``
and the ``Parameters`` of a topology use it unless they are given their
own ``device``. Nothing recorded means CUDA, which raises without a GPU:
the CPU is used only when the caller asks for it (``device="cpu"`` or
``use_gpu=False``)."""

from ..place import resolve_device

__all__ = ["record", "current"]

_recorded = [None]


def record(use_gpu=None, device=None):
    """Resolve and record the v2 surface's device: ``device`` when given,
    the CPU for ``use_gpu=False``, CUDA otherwise."""
    if device is None and use_gpu is False:
        device = "cpu"
    resolved = resolve_device(device)
    if use_gpu and resolved.type != "cuda":
        raise ValueError("init(use_gpu=True) with device %s" % resolved)
    _recorded[0] = resolved
    return resolved


def current(device=None):
    """``device`` when given, else the recorded one, else CUDA."""
    if device is not None:
        return resolve_device(device)
    if _recorded[0] is not None:
        return _recorded[0]
    return resolve_device(None)
