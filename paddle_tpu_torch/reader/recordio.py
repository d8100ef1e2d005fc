"""RecordIO files and the native shuffling loader (reference
``paddle_tpu/reader/recordio.py``).

The Python face of the reference's native data layer
(``native/recordio.cc``, ``native/shuffle_pool.cc``, built by the port's
own loader, ``paddle_tpu_torch/native.py``): the chunk IO and the sample
pool are C++, the decode is a Python function (pickle by default), and
samples arrive shuffled by the pool's seed. The file format is the
reference's, so a file written by either package reads back through the
other.
"""

import ctypes
import pickle
import threading

from .. import native

__all__ = ["write_recordio", "read_recordio", "chunked_reader",
           "num_chunks", "ShuffleLoader", "recordio_reader"]


def write_recordio(path, samples, max_chunk_bytes=1 << 20,
                   serialize=pickle.dumps):
    """Write an iterable of samples to a RecordIO file; returns count."""
    lib = native.recordio_lib()
    h = lib.ptrc_writer_open(path.encode(), max_chunk_bytes)
    if not h:
        raise IOError("cannot open %s for writing" % path)
    n = 0
    try:
        for s in samples:
            data = serialize(s)
            if lib.ptrc_writer_write(h, data, len(data)) != 0:
                raise IOError("write failed at record %d" % n)
            n += 1
    finally:
        lib.ptrc_writer_close(h)
    return n


class _Reader:
    def __init__(self, path):
        self.lib = native.recordio_lib()
        self.h = self.lib.ptrc_reader_open(path.encode())
        if not self.h:
            raise IOError("cannot open %s" % path)

    def num_chunks(self):
        return self.lib.ptrc_reader_num_chunks(self.h)

    def chunk_records(self, i):
        n = self.lib.ptrc_reader_load_chunk(self.h, i)
        if n < 0:
            raise IOError("bad chunk %d" % i)
        out = []
        for _ in range(n):
            ln = self.lib.ptrc_reader_peek_len(self.h)
            buf = ctypes.create_string_buffer(ln)
            self.lib.ptrc_reader_next(self.h, buf, ln)
            out.append(buf.raw)
        return out

    def close(self):
        if self.h:
            self.lib.ptrc_reader_close(self.h)
            self.h = None


def read_recordio(path, deserialize=pickle.loads):
    """Reader creator over all records of a file."""
    def reader():
        r = _Reader(path)
        try:
            for i in range(r.num_chunks()):
                for rec in r.chunk_records(i):
                    yield deserialize(rec)
        finally:
            r.close()
    return reader


def chunked_reader(path, chunk_indices, deserialize=pickle.loads):
    """Reader over the given chunks only: the granularity a task
    dispatcher hands out."""
    def reader():
        r = _Reader(path)
        try:
            for i in chunk_indices:
                for rec in r.chunk_records(i):
                    yield deserialize(rec)
        finally:
            r.close()
    return reader


def num_chunks(path):
    r = _Reader(path)
    try:
        return r.num_chunks()
    finally:
        r.close()


class ShuffleLoader:
    """Native shuffling prefetch pool fed by a background thread.

    loader = ShuffleLoader(reader, min_pool=1024); for s in loader: ...
    """

    def __init__(self, reader, min_pool=1024, max_pool=0, seed=0,
                 serialize=pickle.dumps, deserialize=pickle.loads):
        self.lib = native.shuffle_pool_lib()
        self.h = self.lib.ptpool_create(min_pool, max_pool, seed)
        self.deserialize = deserialize

        def produce():
            try:
                for s in reader():
                    data = serialize(s)
                    if self.lib.ptpool_push(self.h, data, len(data)) != 0:
                        break
            finally:
                self.lib.ptpool_close(self.h)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def __iter__(self):
        cap = 1 << 16
        buf = ctypes.create_string_buffer(cap)
        while True:
            n = self.lib.ptpool_pop(self.h, buf, cap)
            if n == -1:
                break
            if n < -1:  # -(len+1): buffer too small, record not consumed
                cap = -n
                buf = ctypes.create_string_buffer(cap)
                continue
            yield self.deserialize(buf.raw[:n])

    def __del__(self):
        try:
            self.lib.ptpool_destroy(self.h)
        except Exception:
            pass


def recordio_reader(path, shuffle_pool=0, seed=0):
    """Convenience: recordio file -> (optionally pool-shuffled) reader."""
    base = read_recordio(path)
    if not shuffle_pool:
        return base

    def reader():
        return iter(ShuffleLoader(base, min_pool=shuffle_pool, seed=seed))
    return reader
