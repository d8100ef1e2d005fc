"""RecordIO and the shuffling loader of the port (``reader/recordio.py``
over ``native/recordio.cc`` and ``native/shuffle_pool.cc``, built by
``paddle_tpu_torch/native.py`` into the port's ``build/``), against the
reference's: a file either package writes reads back through the other
record for record, chunk by chunk; the shuffle pool's order under one
seed is the reference's (with the pool holding the whole file before the
first pop: with a smaller pool, the order depends on the producer
thread's timing in both packages), and a permutation at any pool
size."""

import os

import numpy as np
import pytest

from paddle_tpu.reader import recordio as ref_rio
from paddle_tpu_torch import native
from paddle_tpu_torch.reader import recordio as port_rio


def _samples(n=60):
    rs = np.random.RandomState(3)
    return [(i, rs.randn(4).astype(np.float32), "s" * (i % 7))
            for i in range(n)]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[0] == y[0] and x[2] == y[2]
        np.testing.assert_array_equal(x[1], y[1])


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port"),
                                           ("port", "port")])
def test_recordio_round_trip_across_packages(tmp_path, writer, reader):
    w = port_rio if writer == "port" else ref_rio
    r = port_rio if reader == "port" else ref_rio
    path = str(tmp_path / "d.rio")
    samples = _samples()
    assert w.write_recordio(path, samples, max_chunk_bytes=300) == 60
    _same(list(r.read_recordio(path)()), samples)
    n = r.num_chunks(path)
    assert n == ref_rio.num_chunks(path) > 1
    chunks = [list(r.chunked_reader(path, [i])()) for i in range(n)]
    _same([s for c in chunks for s in c], samples)


def test_files_are_byte_identical(tmp_path):
    a, b = str(tmp_path / "a.rio"), str(tmp_path / "b.rio")
    port_rio.write_recordio(a, _samples(), max_chunk_bytes=300)
    ref_rio.write_recordio(b, _samples(), max_chunk_bytes=300)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("seed", [0, 3])
def test_shuffle_order_is_the_references(tmp_path, seed):
    path = str(tmp_path / "d.rio")
    port_rio.write_recordio(path, _samples(), max_chunk_bytes=300)
    got = [s[0] for s in port_rio.recordio_reader(
        path, shuffle_pool=64, seed=seed)()]
    want = [s[0] for s in ref_rio.recordio_reader(
        path, shuffle_pool=64, seed=seed)()]
    assert got == want and got != list(range(60))
    again = [s[0] for s in port_rio.recordio_reader(
        path, shuffle_pool=64, seed=seed)()]
    assert again == got


def test_small_pool_yields_a_permutation(tmp_path):
    path = str(tmp_path / "d.rio")
    port_rio.write_recordio(path, _samples(), max_chunk_bytes=300)
    got = [s[0] for s in port_rio.recordio_reader(path, shuffle_pool=8,
                                                  seed=1)()]
    assert sorted(got) == list(range(60))


def test_libraries_build_into_the_ports_build_dir():
    for stem, lib in (("recordio", native.recordio_lib()),
                      ("shuffle_pool", native.shuffle_pool_lib())):
        path = native.build_native_lib(stem)
        assert os.path.dirname(path) == os.path.join(
            os.path.dirname(native.__file__), "build")
        assert lib is not None
