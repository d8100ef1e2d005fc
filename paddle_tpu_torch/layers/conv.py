"""The convolutional layers of the ResNet as ``nn.Module``s: the two
forms of ``conv_bn_layer`` (reference ``models/resnet.py``), fused
(``layers.fused_conv_bn``, one ``conv2d_bn`` op) and unfused
(``layers.conv2d`` without bias, then ``layers.batch_norm``), and
``layers.fc``.

Each module owns its parameters and its running-statistic buffers and
knows their reference names, which :class:`UniqueNames` hands out in the
reference's order (``unique_name.generate``): ``conv2d_bn_<i>.w_0``
(filter), ``.w_1`` (BN scale), ``.w_2`` (BN bias), ``.global_0``
(running mean), ``.global_1`` (running variance); unfused
``conv2d_<i>.w_0`` and ``batch_norm_<i>.{w_0, w_1, global_0,
global_1}``; ``fc_<i>.w_0`` and ``.w_1``. Initial values follow the
reference's initializers: filters He normal (std sqrt(2 / fan_in)), BN
scales 1 and biases 0, running means 0 and variances 1, the fc weight
Xavier uniform and its bias 0."""

import contextlib
import math
import threading

import torch
from torch import nn

from ..ops.conv_bn import conv2d_bn
from ..ops.nn_ops import batch_norm, conv2d, fc

__all__ = ["UniqueNames", "ConvBN", "FC", "recomputing"]

_recompute = threading.local()


@contextlib.contextmanager
def recomputing():
    """Inside: a checkpointed forward runs again for its gradient
    (``torch.utils.checkpoint``); its first run already updated the
    running statistics, so a ConvBN leaves them as they are."""
    prev = getattr(_recompute, "on", False)
    _recompute.on = True
    try:
        yield
    finally:
        _recompute.on = prev


class UniqueNames:
    """``prefix_<n>`` with one counter per prefix, as the reference's
    ``unique_name.generate`` under a fresh ``unique_name.guard()``."""

    def __init__(self):
        self._counts = {}

    def __call__(self, prefix):
        n = self._counts.get(prefix, 0)
        self._counts[prefix] = n + 1
        return "%s_%d" % (prefix, n)


class ConvBN(nn.Module):
    """A bias-free ``filter_size`` convolution, a batch norm (the
    reference's defaults: momentum 0.9, epsilon 1e-5) and ``act`` ("relu"
    or None). ``fused`` runs ``conv2d_bn`` (kernel B1 for a 1x1 stride-1
    f32 convolution on the card); otherwise ``conv2d`` then
    ``batch_norm``. ``is_test`` normalizes by the running statistics and
    leaves them as they are; training updates them in place. ``amp`` (a
    dtype or None, given at each call) makes the unfused ``conv2d`` a
    WHITE op; ``conv2d_bn`` is on neither amp list. Under
    :func:`recomputing` the running statistics are not updated again."""

    def __init__(self, ch_in, ch_out, filter_size, stride, padding,
                 act="relu", fused=False, is_test=False, names=None,
                 device=None):
        super().__init__()
        names = names if names is not None else UniqueNames()
        self.stride, self.padding = stride, padding
        self.act, self.fused, self.is_test = act, fused, is_test
        k = filter_size
        self.weight = nn.Parameter(torch.empty(ch_out, ch_in, k, k,
                                               device=device))
        self.scale = nn.Parameter(torch.ones(ch_out, device=device))
        self.bias = nn.Parameter(torch.zeros(ch_out, device=device))
        self.register_buffer("mean", torch.zeros(ch_out, device=device))
        self.register_buffer("variance", torch.ones(ch_out, device=device))
        if fused:
            conv = bn = names("conv2d_bn")
            slots = ("w_0", "w_1", "w_2")
        else:
            conv, bn = names("conv2d"), names("batch_norm")
            slots = ("w_0", "w_0", "w_1")
        self.ref_names = {
            "weight": "%s.%s" % (conv, slots[0]),
            "scale": "%s.%s" % (bn, slots[1]),
            "bias": "%s.%s" % (bn, slots[2]),
            "mean": "%s.global_0" % bn,
            "variance": "%s.global_1" % bn,
        }

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        fan_in = self.weight[0].numel()
        self.weight.normal_(0.0, math.sqrt(2.0 / fan_in),
                            generator=generator)
        self.scale.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.variance.fill_(1.0)

    def forward(self, x, amp=None):
        update = not getattr(_recompute, "on", False)
        if self.fused:
            y = conv2d_bn(x, self.weight, self.scale, self.bias, self.mean,
                          self.variance, self.stride, self.padding,
                          is_test=self.is_test, update_stats=update)
        else:
            y = batch_norm(conv2d(x, self.weight, self.stride, self.padding,
                                  amp=amp),
                           self.scale, self.bias, self.mean, self.variance,
                           is_test=self.is_test, update_stats=update)
        if self.act == "relu":
            y = torch.relu(y)
        elif self.act is not None:
            raise ValueError("unsupported act %r" % self.act)
        return y


class FC(nn.Module):
    """``layers.fc`` on a 2-D input: x [N, in] @ w [in, out] + b; its
    ``mul`` under ``amp`` (a dtype or None) when given."""

    def __init__(self, size_in, size_out, names=None, device=None):
        super().__init__()
        names = names if names is not None else UniqueNames()
        self.weight = nn.Parameter(torch.empty(size_in, size_out,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(size_out, device=device))
        layer = names("fc")
        self.ref_names = {"weight": layer + ".w_0", "bias": layer + ".w_1"}

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        limit = math.sqrt(6.0 / sum(self.weight.shape))
        self.weight.uniform_(-limit, limit, generator=generator)
        self.bias.zero_()

    def forward(self, x, amp=None):
        return fc(x, self.weight, self.bias, amp=amp)
