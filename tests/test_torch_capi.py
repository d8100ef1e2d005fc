"""The port's C inference API (``paddle_tpu_torch/csrc/capi.cc`` +
``capi_bridge.py``, built by ``native.py``), as ``tests/test_capi.py``
holds the reference's: built with g++ here, loaded with ctypes (it joins
this interpreter), a C forward equal to ``Executor.run``, concurrent C
calls from several threads over shared and private handles, the
bucketed ServingEngine path, and the reference's symbols."""

import ctypes
import re
import threading

import numpy as np
import pytest

import paddle_tpu as ptpu
from paddle_tpu import io as ref_io
from paddle_tpu import layers as ref_layers
from paddle_tpu_torch import capi_bridge
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import native


@pytest.fixture(scope="module")
def lib():
    """The C API, built on first use; the tests that call it skip only
    when it cannot be built here (no g++ or no Python headers)."""
    try:
        return native.capi_lib()
    except (RuntimeError, OSError) as exc:
        pytest.skip("C API build unavailable: %s" % exc)


@pytest.fixture(autouse=True)
def _cpu_bridge():
    capi_bridge.set_default_device("cpu")
    yield
    capi_bridge.set_default_device(None)


def _build_and_save(dirname, seed=5):
    main, startup = pc.Program(), pc.Program()
    main.random_seed = startup.random_seed = seed
    with pc.unique_name.guard(), pc.program_guard(main, startup):
        x = port_layers.data("x", shape=[4])
        h = port_layers.fc(x, 8, act="relu")
        out = port_layers.fc(h, 3, act="softmax")
    exe, scope = pc.Executor(device="cpu"), pc.Scope()
    exe.run(startup, scope=scope)
    port_io.save_inference_model(dirname, ["x"], [out], exe, main, scope)
    xv = np.random.RandomState(0).randn(6, 4).astype("float32")
    want, = exe.run(main, feed={"x": xv}, fetch_list=[out], scope=scope)
    return xv, want, out.name


def _c_forward(lib, model, name, arr):
    shape = (ctypes.c_int64 * arr.ndim)(*arr.shape)
    t = native.PtcTensor(name=name.encode(),
                         data=arr.ctypes.data_as(ctypes.c_void_p),
                         shape=shape, ndim=arr.ndim, dtype=0)
    n = lib.ptc_model_forward(ctypes.c_void_p(model), ctypes.byref(t), 1)
    assert n >= 1, "forward failed: %d" % n
    numel = ctypes.c_int64()
    data = lib.ptc_model_output_data(ctypes.c_void_p(model), 0,
                                     ctypes.byref(numel))
    nd = lib.ptc_model_output_ndim(ctypes.c_void_p(model), 0)
    shape_out = [lib.ptc_model_output_dim(ctypes.c_void_p(model), 0, d)
                 for d in range(nd)]
    out = np.ctypeslib.as_array(data, shape=(numel.value,)).copy()
    return out.reshape(shape_out)


def test_c_round_trip_matches_executor(lib, tmp_path):
    assert lib.ptc_init(b"") == 0
    d = str(tmp_path)
    xv, want, out = _build_and_save(d)
    model = lib.ptc_model_load(d.encode())
    assert model
    got = _c_forward(lib, model, "x", xv)
    np.testing.assert_array_equal(got, want)
    assert lib.ptc_model_num_outputs(ctypes.c_void_p(model)) == 1
    assert lib.ptc_model_output_name(ctypes.c_void_p(model), 0) == \
        out.encode()
    lib.ptc_model_release(ctypes.c_void_p(model))


def test_c_concurrent_requests(lib, tmp_path):
    """N threads hammer one loaded model and a private model each, all
    results exact (the reference's multi-thread serving example). A
    handle keeps one output buffer, which its next forward replaces, so
    a caller sharing a handle holds one lock around its forward and its
    reads of that handle's outputs (``ptc_model_output_data``); the
    private handles run with no lock, concurrently."""
    assert lib.ptc_init(b"") == 0
    d = str(tmp_path)
    xv, want, _ = _build_and_save(d)
    shared = lib.ptc_model_load(d.encode())
    shared_lock = threading.Lock()
    errors = []

    def worker(i):
        try:
            rs = np.random.RandomState(100 + i)
            mine = lib.ptc_model_load(d.encode())
            for _ in range(5):
                np.testing.assert_array_equal(
                    _c_forward(lib, mine, "x", xv), want)
                with shared_lock:
                    got = _c_forward(lib, shared, "x", xv)
                np.testing.assert_array_equal(got, want)
                out = _c_forward(lib, mine, "x",
                                 rs.randn(3, 4).astype("float32"))
                assert out.shape == (3, 3) and np.isfinite(out).all()
            lib.ptc_model_release(ctypes.c_void_p(mine))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    np.testing.assert_array_equal(_c_forward(lib, shared, "x", xv), want)
    lib.ptc_model_release(ctypes.c_void_p(shared))


def test_c_forward_of_a_reference_artifact(lib, tmp_path):
    """A reference export served through the port's C API equals the
    reference's own run."""
    assert lib.ptc_init(b"") == 0
    d = str(tmp_path)
    with ptpu.unique_name.guard():
        main, startup = ptpu.Program(), ptpu.Program()
        startup.random_seed = 7
        with ptpu.program_guard(main, startup):
            x = ref_layers.data("x", shape=[4])
            out = ref_layers.fc(ref_layers.fc(x, 8, act="relu"), 3)
    scope = ptpu.Scope()
    xv = np.random.RandomState(1).randn(5, 4).astype("float32")
    with ptpu.scope_guard(scope):
        exe = ptpu.Executor()
        exe.run(startup)
        ref_io.save_inference_model(d, ["x"], [out], exe, main_program=main)
        want, = exe.run(main, feed={"x": xv}, fetch_list=[out])
    model = lib.ptc_model_load(d.encode())
    got = _c_forward(lib, model, "x", xv)
    want = np.asarray(want)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    lib.ptc_model_release(ctypes.c_void_p(model))


def test_bridge_bucketed_path_through_the_engine(tmp_path):
    d = str(tmp_path)
    xv, want, _ = _build_and_save(d)
    h = capi_bridge.load_model(d, batch_buckets=(4,))
    try:
        assert capi_bridge.feed_fetch_names(h)[0] == ["x"]
        outs = capi_bridge.forward(
            h, [("x", xv[:2].tobytes(), xv[:2].shape, 0)])
        name, arr, shape = outs[0]
        assert shape == [2, 3]
        np.testing.assert_array_equal(arr, want[:2])
    finally:
        capi_bridge.release(h)
    with pytest.raises(ValueError, match="batch_buckets"):
        capi_bridge.load_model(d, deadline_ms=10)


def test_bridge_loads_on_cuda_by_default(tmp_path, monkeypatch):
    import torch
    d = str(tmp_path)
    _build_and_save(d)
    capi_bridge.set_default_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capi_bridge.load_model(d)


def test_shim_has_the_reference_symbols():
    """The port's shim exports the reference's ``ptc_*`` C ABI and
    imports the port's bridge, not the reference's."""
    def symbols(path):
        with open(path) as f:
            src = f.read()
        return sorted(set(re.findall(r"^\S.*?\b(ptc_\w+)\(", src, re.M))), \
            src
    ours, src = symbols(native.SOURCE)
    theirs, _ = symbols(native.SOURCE.replace(
        "paddle_tpu_torch/csrc/capi.cc", "native/capi.cc"))
    assert ours == theirs and "ptc_model_forward" in ours
    assert '"paddle_tpu_torch.capi_bridge"' in src
    assert '"paddle_tpu.capi_bridge"' not in src
