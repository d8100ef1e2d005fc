"""Python side of the port's C inference API (``csrc/capi.cc``, the
reference's ``native/capi.cc`` + ``paddle_tpu/capi_bridge.py``).

The C library embeds (or joins) a CPython interpreter and calls these
functions; handles are ints, so no Python object crosses the ABI. A
handle owns its Executor and Scope (or a bucketed ServingEngine), so
requests against different models never share mutable state.

Models load on CUDA unless :func:`set_default_device` names another
device first (``"cpu"``): the C signatures are the reference's, which
carry no device, and without a GPU a load on the default raises.
"""

import threading

import numpy as np

_models = {}
_next_id = [1]
_lock = threading.Lock()
_device = [None]

_DTYPES = {0: np.float32, 1: np.int32, 2: np.int64}


def set_default_device(device):
    """The device later loads put their models on: None (CUDA, the
    default) or anything ``torch.device`` takes, e.g. ``"cpu"``."""
    _device[0] = device


def load_model(dirname, batch_buckets=None, deadline_ms=None):
    """Load an inference dir (JSON __model__ + params) or a merged file
    -> int handle. With ``batch_buckets`` the handle serves through a
    bucketed ServingEngine (padded shapes, warmed, with the serving
    layer's breakers from the ``serving_breaker_*`` flags) instead of a
    plain Executor, and ``deadline_ms`` (default: the
    ``serving_deadline_ms`` flag; 0 = none) bounds every forward."""
    from . import config as _config
    from . import io as _io
    from .core.executor import Executor
    from .core.scope import Scope

    if deadline_ms and not batch_buckets:  # 0/None = no deadline
        raise ValueError(
            "deadline_ms needs the bucketed serving path — pass "
            "batch_buckets too (the plain Executor path has no deadline "
            "enforcement)")
    if batch_buckets:
        from .serving.engine import ServingEngine
        eng = ServingEngine(dirname, buckets=batch_buckets,
                            device=_device[0])
        if deadline_ms is None:
            flag_ms = _config.get_flag("serving_deadline_ms")
            deadline_ms = flag_ms if flag_ms else None
        entry = {"serving": eng, "feed_names": list(eng.feed_names),
                 "fetch_names": list(eng.fetch_names),
                 "deadline_ms": deadline_ms,
                 "lock": threading.Lock()}
    else:
        scope = Scope()
        exe = Executor(device=_device[0])
        program, feed_names, fetch_names = _io.load_inference_model(
            dirname, exe, scope=scope)
        entry = {"exe": exe, "scope": scope, "program": program,
                 "feed_names": feed_names, "fetch_names": fetch_names,
                 "lock": threading.Lock()}
    with _lock:
        handle = _next_id[0]
        _next_id[0] += 1
        _models[handle] = entry
    return handle


def forward(handle, inputs):
    """inputs: [(name, bytes_or_buffer, shape tuple, dtype code)].
    Returns [(name, float32 C-contiguous array, shape list)] for each
    fetch."""
    entry = _models[handle]
    feed = {}
    for name, buf, shape, dtype_code in inputs:
        dt = _DTYPES[int(dtype_code)]
        # a writable copy: the C side's bytes are read-only
        feed[name] = np.frombuffer(bytearray(buf), dtype=dt).reshape(
            [int(s) for s in shape])
    if "serving" in entry:
        # the engine is itself thread-safe; deadlines/breakers apply
        outs = entry["serving"].run(feed, deadline_ms=entry["deadline_ms"])
    else:
        with entry["lock"]:
            outs = entry["exe"].run(entry["program"], feed=feed,
                                    fetch_list=entry["fetch_names"],
                                    scope=entry["scope"])
    result = []
    for name, val in zip(entry["fetch_names"], outs):
        a = np.ascontiguousarray(np.asarray(val), dtype=np.float32)
        result.append((name, a, list(a.shape)))
    return result


def release(handle):
    with _lock:
        entry = _models.pop(handle, None)
    if entry and "serving" in entry:
        entry["serving"].close()  # stop the probe and worker threads


def feed_fetch_names(handle):
    e = _models[handle]
    return list(e["feed_names"]), list(e["fetch_names"])
