"""Reader decorators: push-based Python data pipelines (reference
``paddle_tpu/reader/__init__.py``).

Parity with reference ``python/paddle/v2/reader/decorator.py:51-236``:
shuffle, buffered, chain, compose, map_readers, batch, xmap_readers
(parallel map), firstn, cache. A reader is a zero-arg callable returning
an iterator of samples.

Pair these with ``data_feeder.DataFeeder`` for batching and padding, and
with ``reader/staging.py`` (or ``buffered``) for host-side prefetch that
overlaps the step on the card.
"""

import itertools
import queue as _queue
import random as _random
import threading

__all__ = ["shuffle", "buffered", "chain", "compose", "map_readers",
           "batch", "xmap_readers", "firstn", "cache"]


def shuffle(reader, buf_size, seed=None):
    def reader_creator():
        rng = _random.Random(seed)
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            rng.shuffle(buf)
            yield from buf
    return reader_creator


def buffered(reader, size):
    """Background-thread prefetch queue (host/device overlap)."""
    end = object()

    def reader_creator():
        q = _queue.Queue(maxsize=size)

        def fill():
            try:
                for sample in reader():
                    q.put(sample)
            except Exception as e:  # surface in the consumer
                q.put(e)
            finally:
                q.put(end)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            sample = q.get()
            if sample is end:
                break
            if isinstance(sample, Exception):
                # a reader failure (e.g. a generation-fenced dispatcher
                # raising GenerationMismatch) must not read as a clean
                # end-of-pass — re-raise where the train loop can see it
                raise sample
            yield sample
    return reader_creator


def chain(*readers):
    def reader_creator():
        for r in readers:
            yield from r()
    return reader_creator


def compose(*readers, check_alignment=True):
    """Zip readers into tuple samples (reference compose)."""
    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader_creator():
        its = [r() for r in readers]
        for outputs in itertools.zip_longest(*its):
            if check_alignment and any(o is None for o in outputs):
                raise RuntimeError("composed readers have different "
                                   "lengths")
            yield sum((make_tuple(o) for o in outputs), ())
    return reader_creator


def map_readers(func, *readers):
    def reader_creator():
        for args in zip(*[r() for r in readers]):
            yield func(*args)
    return reader_creator


def batch(reader, batch_size, drop_last=True):
    def reader_creator():
        b = []
        for sample in reader():
            b.append(sample)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return reader_creator


def xmap_readers(mapper, reader, process_num, buffer_size,
                 order=False):
    """Parallel map over samples with worker threads (reference
    xmap_readers)."""
    end = object()

    def reader_creator():
        in_q = _queue.Queue(buffer_size)
        out_q = _queue.Queue(buffer_size)

        def feed():
            for i, sample in enumerate(reader()):
                in_q.put((i, sample))
            for _ in range(process_num):
                in_q.put(end)

        def work():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    break
                i, sample = item
                out_q.put((i, mapper(sample)))

        threads = [threading.Thread(target=feed, daemon=True)]
        threads += [threading.Thread(target=work, daemon=True)
                    for _ in range(process_num)]
        for t in threads:
            t.start()

        finished = 0
        pending = {}
        next_i = 0
        while finished < process_num:
            item = out_q.get()
            if item is end:
                finished += 1
                continue
            if not order:
                yield item[1]
                continue
            pending[item[0]] = item[1]
            while next_i in pending:
                yield pending.pop(next_i)
                next_i += 1
        if order:
            for i in sorted(pending):
                yield pending[i]
    return reader_creator


def firstn(reader, n):
    def reader_creator():
        return itertools.islice(reader(), n)
    return reader_creator


def cache(reader):
    all_data = []
    filled = []

    def reader_creator():
        if not filled:
            all_data.extend(reader())
            filled.append(True)
        return iter(all_data)
    return reader_creator
