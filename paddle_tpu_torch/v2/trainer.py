"""v2 trainer surface (reference ``python/paddle/v2/trainer.py:37-207``
SGD(cost, parameters, update_equation).train(reader, num_passes,
event_handler, feeding)): the legacy entry point, lowered onto the
fluid-style Trainer/Executor. The reader yields BATCHES of sample
tuples (make them with ``paddle.batch``); ``feeding`` maps data-layer
name -> tuple index.

The program runs on the ``init`` device, or on ``SGD(..., device=)``:
CUDA unless the caller asks for the CPU (``v2/place.py``). The port's
copy of ``paddle_tpu/v2/trainer.py``."""

import numpy as np

from ..core.framework import (default_main_program,
                              default_startup_program)
from ..data_feeder import DataFeeder
from ..io import prune_program
from ..trainer import Trainer as _FluidTrainer
from . import layer as _v2layer
from . import place as _place

__all__ = ["SGD"]


def _build_feeder(feeding, sample_width, program=None):
    """DataFeeder from the v2 feeding map + registered input types."""
    if feeding is None:
        raise ValueError("v2 SGD needs feeding={layer_name: index}")
    order = sorted(feeding.items(), key=lambda kv: kv[1])
    if len(order) != sample_width:
        raise ValueError("feeding has %d slots but samples have %d "
                         "fields" % (len(order), sample_width))
    feed_list = []
    for name, _ in order:
        entry = _v2layer._input_types(program).get(name)
        if entry is None:
            raise KeyError("unknown data layer %r in feeding" % name)
        typ, length = entry
        if getattr(typ, "is_sparse_pair", False):
            spec = {"kind": "sparse", "name": name,
                    "values": name + "@value", "depth": typ.seq_type}
            if typ.seq_type >= 1:
                spec["len"] = name + "@len"
            if typ.seq_type == 2:
                spec["sublen"] = name + "@sublen"
            feed_list.append(spec)
        elif getattr(typ, "is_nested", False):
            feed_list.append({"kind": "nested", "name": name,
                              "len": name + "@len",
                              "sublen": name + "@sublen",
                              "dtype": typ.dtype})
        elif typ.is_seq:
            feed_list.append((name, length.name))
        else:
            feed_list.append(name)
    return DataFeeder(feed_list)


class SGD:
    def __init__(self, cost, parameters, update_equation,
                 extra_layers=None, is_local=True, device=None):
        self.__topology_in_use__ = cost
        self._cost = cost
        self._parameters = parameters
        self._device = _place.current(device)
        self._main = default_main_program()
        self._startup = default_startup_program()
        update_equation.minimize(cost, startup_program=self._startup)
        self._trainer = None

    def _fluid_trainer(self, feeder):
        if self._trainer is None:
            self._trainer = _FluidTrainer(
                self._cost, feeder=feeder, main_program=self._main,
                startup_program=self._startup, device=self._device)
        return self._trainer

    def train(self, reader, num_passes=1, event_handler=None,
              feeding=None):
        sample = next(iter(reader()))[0]
        feeder = _build_feeder(feeding, len(sample), self._main)
        self._fluid_trainer(feeder).feeder = feeder
        self._trainer.train(reader, num_passes=num_passes,
                            event_handler=event_handler)

    def save_parameter_to_tar(self, f):
        """Save the trained parameters to an open binary file as a tar
        checkpoint (reference ``trainer.py`` SGD.save_parameter_to_tar
        — the v2 event-handler save idiom)."""
        self._parameters.to_tar(f)

    def test(self, reader, feeding=None):
        """Mean cost over a test reader (v2 SGD.test), on the trainer's
        device."""
        sample = next(iter(reader()))[0]
        feeder = _build_feeder(feeding, len(sample), self._main)
        trainer = self._fluid_trainer(feeder)
        pruned = prune_program(self._main, [self._cost.name])
        trainer.startup()
        exe = trainer.exe
        total, count = 0.0, 0
        for batch in reader():
            out, = exe.run(pruned, feed=feeder.feed(batch),
                           fetch_list=[self._cost.name])
            total += float(np.asarray(out).mean())
            count += 1

        class _Result:
            cost = total / max(count, 1)
            metrics = {"cost": total / max(count, 1)}
        return _Result()
