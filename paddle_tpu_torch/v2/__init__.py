"""paddle.v2-compatible API surface (reference ``python/paddle/v2``):
the legacy keyword-argument layer DSL, SGD trainer, Parameters handle,
datasets/readers/minibatch, and infer — lowered onto the port's
fluid-style engine. A v2 user ports scripts by changing only the
import.

    import paddle_tpu_torch.v2 as paddle
    paddle.init()                      # CUDA; init(device="cpu") asks
    images = paddle.layer.data("pixel", paddle.data_type.dense_vector(784))
    ...
    trainer = paddle.trainer.SGD(cost, parameters, optimizer)
    trainer.train(paddle.batch(paddle.dataset.mnist.train(), 64), ...)

The port's copy of ``paddle_tpu/v2/__init__.py``: the same names, and
an ``init`` that records the device the surface runs on.
"""

from .. import dataset  # noqa: F401  (same module names as v2.dataset)
from .. import reader  # noqa: F401
from ..reader import batch  # noqa: F401  (paddle.batch)
from ..utils import image  # noqa: F401
from .. import plot  # noqa: F401
from . import activation  # noqa: F401
from . import data_type  # noqa: F401
from . import event  # noqa: F401
from . import inference  # noqa: F401
from . import layer  # noqa: F401
from . import optimizer  # noqa: F401
from . import parameters  # noqa: F401
from . import pooling  # noqa: F401
from . import trainer  # noqa: F401
from .. import nets as networks  # noqa: F401
from .inference import infer  # noqa: F401
from ..param_attr import ParamAttr as attr  # noqa: F401
from . import place as _place

__all__ = ["init", "layer", "activation", "pooling", "data_type",
           "event", "trainer", "parameters", "optimizer", "dataset",
           "reader", "batch", "infer", "inference", "networks", "attr",
           "image", "plot"]


def init(use_gpu=None, trainer_count=1, device=None, **kwargs):
    """v2 bootstrap (reference paddle.init parsing gflags): records the
    device that ``SGD``, ``SGD.test``, ``Inference`` and ``Parameters``
    use — ``device`` when given, the CPU for ``use_gpu=False``, else
    CUDA, which raises when there is no GPU. ``trainer_count`` and the
    other flags are accepted and ignored, as in the reference. Returns
    the device."""
    return _place.record(use_gpu=use_gpu, device=device)
