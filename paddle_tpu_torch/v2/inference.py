"""v2 inference (reference ``python/paddle/v2/inference.py:24-125``
infer(output_layer, parameters, input, feeding)): prune the topology to
the output layer and run it over a list of input samples.

The pruned program is the output layer's own program (the reference
takes the default main program, which is the same one unless the
topology was built under another ``program_guard``). It runs on the
``init`` device, or on ``device=``: CUDA unless the caller asks for the
CPU (``v2/place.py``). The port's copy of
``paddle_tpu/v2/inference.py``."""

import numpy as np

from ..core.executor import Executor
from ..io import prune_program
from . import place as _place
from .trainer import _build_feeder

__all__ = ["infer", "Inference"]


class Inference:
    def __init__(self, output_layer, parameters, device=None):
        outputs = output_layer if isinstance(output_layer, (list, tuple)) \
            else [output_layer]
        self._outputs = outputs
        self._source = outputs[0].block.program
        self._program = prune_program(self._source,
                                      [v.name for v in outputs])
        self._exe = Executor(device=_place.current(device))

    def infer(self, input, feeding=None, field="value"):
        if feeding is None:
            if isinstance(input, dict):
                feed = input  # already a name -> array feed dict
            else:
                raise ValueError(
                    "v2 infer needs feeding={layer_name: sample_index} "
                    "for tuple-sample input (or pass a feed dict)")
        else:
            feeder = _build_feeder(feeding, len(input[0]), self._source)
            feed = feeder.feed(input)
        outs = self._exe.run(self._program, feed=feed,
                             fetch_list=[v.name for v in self._outputs])
        outs = [np.asarray(v) for v in outs]
        return outs[0] if len(outs) == 1 else outs


def infer(output_layer, parameters, input, feeding=None, field="value",
          device=None):
    return Inference(output_layer, parameters,
                     device=device).infer(input, feeding=feeding,
                                          field=field)
