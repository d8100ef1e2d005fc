"""ResNet for ImageNet and CIFAR (reference ``paddle_tpu/models/
resnet.py``): ``conv_bn_layer``, ``shortcut``, ``basicblock``,
``bottleneck``, ``layer_warp``, ``DEPTH_CFG``, ``resnet_imagenet`` and
``resnet_cifar10``, in two forms under the same names.

Given a program Variable first (``resnet_imagenet(img, label, depth,
class_dim, is_test, recompute)``), each function builds the reference's
program through the front end (``layers``), and ``resnet_imagenet``
returns its ``(loss, acc, logits)`` Variables; ``recompute`` wraps each
residual block in ``layers.recompute``. ``resnet_cifar10`` takes
``recompute`` too, which the reference's does not.

Otherwise they build ``nn.Module``s: ``resnet_imagenet`` and
``resnet_cifar10`` return a module whose forward takes ``(img, label)``
and returns the reference's ``(loss, acc, logits)``; ``recompute`` runs
each residual block under ``torch.utils.checkpoint``, the running
statistics updated once. The ``fused_conv_bn`` flag (``config.py``),
read when the model is built as in the reference, makes every
``conv_bn_layer`` one ``conv2d_bn`` op (``ops/conv_bn.py``): on the card
its 1x1 stride-1 convolutions run kernel B1 (30 per forward of
ResNet-50). The ``amp`` flag is read at each forward, as the reference's
executor reads it at each run: under it the unfused ``conv2d`` and the
fc's ``mul`` are bfloat16 products (``amp.py``), the loss float32.
Parameters and running statistics carry the reference's
scope names (:meth:`ResNet.reference_tensors`,
:func:`resnet_scope_names`), so a reference scope loads through
``io.params_from_jax``."""

import contextlib
import functools

import torch
import torch.utils.checkpoint
from torch import nn

from .. import config as _config
from .. import layers
from ..amp import flag_dtype
from ..core.framework import Variable
from ..layers.conv import FC, ConvBN, UniqueNames, recomputing
from ..ops.loss_ops import mean, softmax_with_cross_entropy
from ..ops.metric_ops import accuracy
from ..ops.nn_ops import pool2d
from ..place import resolve_device

__all__ = ["conv_bn_layer", "shortcut", "basicblock", "bottleneck",
           "layer_warp", "DEPTH_CFG", "ResNet", "resnet_imagenet",
           "resnet_cifar10", "resnet_scope_names"]


class _Build:
    """What every layer of one model is built with: the fused flag,
    is_test, the reference's name counters, the device and whether each
    residual block is recomputed for its gradient."""

    def __init__(self, fused, is_test, device, recompute=False):
        self.fused, self.is_test, self.device = fused, is_test, device
        self.recompute = recompute
        self.names = UniqueNames()


def _program_form(first=0):
    """Route a call to the program builder ``_program_<name>`` when its
    argument ``first`` (an index) is a program Variable, else to the
    nn.Module builder."""
    def deco(module_fn):
        @functools.wraps(module_fn)
        def fn(*args, **kwargs):
            arg = args[first] if len(args) > first else None
            if isinstance(arg, Variable) or (arg is None and any(
                    isinstance(v, Variable) for v in kwargs.values())):
                return _PROGRAM[module_fn.__name__](*args, **kwargs)
            return module_fn(*args, **kwargs)
        return fn
    return deco


@_program_form()
def conv_bn_layer(b, ch_in, ch_out, filter_size, stride, padding,
                  act="relu"):
    return ConvBN(ch_in, ch_out, filter_size, stride, padding, act=act,
                  fused=b.fused, is_test=b.is_test, names=b.names,
                  device=b.device)


@_program_form()
def shortcut(b, ch_in, ch_out, stride):
    """A 1x1 conv_bn_layer when the channels or the stride change, else
    None (the identity)."""
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(b, ch_in, ch_out, 1, stride, 0, act=None)
    return None


def _recompute_contexts():
    return contextlib.nullcontext(), recomputing()


class _Block(nn.Module):
    """relu(shortcut(x) + convs(x)), the layers built in the reference's
    order (shortcut first). With ``recompute`` (and autograd on) only
    the block's input is kept for backward, and the gradient runs the
    block again (``torch.utils.checkpoint``, non-reentrant) under
    :func:`layers.conv.recomputing`, so the running statistics are
    updated once."""

    def __init__(self, short, convs, recompute=False):
        super().__init__()
        self.short = short
        self.convs = nn.Sequential(*convs)
        self.recompute = recompute

    def _forward(self, x, amp=None):
        s = x if self.short is None else self.short(x, amp)
        for conv in self.convs:
            x = conv(x, amp)
        return torch.relu(s + x)

    def forward(self, x, amp=None):
        if self.recompute and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                self._forward, x, amp, use_reentrant=False,
                context_fn=_recompute_contexts)
        return self._forward(x, amp)


@_program_form()
def basicblock(b, ch_in, ch_out, stride):
    short = shortcut(b, ch_in, ch_out, stride)
    conv1 = conv_bn_layer(b, ch_in, ch_out, 3, stride, 1)
    conv2 = conv_bn_layer(b, ch_out, ch_out, 3, 1, 1, act=None)
    return _Block(short, [conv1, conv2], b.recompute), ch_out


@_program_form()
def bottleneck(b, ch_in, ch_out, stride):
    short = shortcut(b, ch_in, ch_out * 4, stride)
    conv1 = conv_bn_layer(b, ch_in, ch_out, 1, stride, 0)
    conv2 = conv_bn_layer(b, ch_out, ch_out, 3, 1, 1)
    conv3 = conv_bn_layer(b, ch_out, ch_out * 4, 1, 1, 0, act=None)
    return _Block(short, [conv1, conv2, conv3], b.recompute), ch_out * 4


@_program_form(first=1)
def layer_warp(b, block_func, ch_in, ch_out, count, stride):
    """``count`` blocks, the first with ``stride``: (blocks, channels
    out)."""
    blocks = []
    for i in range(count):
        blk, ch_in = block_func(b, ch_in, ch_out, stride if i == 0 else 1)
        blocks.append(blk)
    return blocks, ch_in


DEPTH_CFG = {
    18: (basicblock, [2, 2, 2, 2]),
    34: (basicblock, [3, 4, 6, 3]),
    50: (bottleneck, [3, 4, 6, 3]),
    101: (bottleneck, [3, 4, 23, 3]),
    152: (bottleneck, [3, 8, 36, 3]),
}


class ResNet(nn.Module):
    """A stem, residual stages, a global average pool and an fc layer;
    ``forward(img, label)`` returns ``(loss, acc, logits)``: the mean
    softmax cross entropy, the top-1 accuracy of the softmax and the
    logits. Built by :func:`resnet_imagenet` or :func:`resnet_cifar10`."""

    def __init__(self, stem, max_pool, stages, class_dim, ch, b):
        super().__init__()
        self.device = b.device
        self.stem = stem
        self.max_pool = max_pool
        self.stages = nn.Sequential(*stages)
        self.fc = FC(ch, class_dim, names=b.names, device=b.device)

    def conv_layers(self):
        """The ConvBN layers in the reference's program order."""
        return [m for m in self.modules() if isinstance(m, ConvBN)]

    def reference_tensors(self):
        """{reference scope name: parameter or running-statistic
        buffer}, in program order: each conv layer's filter, BN scale,
        BN bias, running mean and running variance, then the fc weight
        and bias."""
        out = {}
        for layer in self.conv_layers() + [self.fc]:
            for attr, name in layer.ref_names.items():
                out[name] = getattr(layer, attr)
        return out

    def reference_parameters(self):
        """{reference name: trainable parameter}, in program order."""
        return {n: t for n, t in self.reference_tensors().items()
                if isinstance(t, nn.Parameter)}

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        """Fill every parameter and running statistic with the
        reference's initializers, drawn from a ``torch.Generator`` on the
        model's device seeded with ``seed``."""
        gen = None
        if self.device.type != "meta":
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        for layer in self.conv_layers() + [self.fc]:
            layer.reset_parameters(gen)

    def logits(self, img):
        """The logits of ``img`` under the ``amp`` flag as it is now."""
        amp = flag_dtype()
        h = self.stem(img, amp)
        if self.max_pool:
            h = pool2d(h, 3, "max", 2, 1)
        for block in self.stages:
            h = block(h, amp)
        pool = pool2d(h, h.shape[2:], "avg", global_pooling=True)
        return self.fc(pool.reshape(-1, pool.shape[1]), amp)

    def forward(self, img, label):
        logits = self.logits(img)
        loss, softmax = softmax_with_cross_entropy(logits, label,
                                                   flag_dtype())
        acc, _, _ = accuracy(softmax, label)
        return mean(loss), acc, logits


def _imagenet(b, depth, class_dim, seed):
    block, counts = DEPTH_CFG[depth]
    stem = conv_bn_layer(b, 3, 64, 7, 2, 3)
    stages, ch = [], 64
    for ch_out, count, stride in zip((64, 128, 256, 512), counts,
                                     (1, 2, 2, 2)):
        blocks, ch = layer_warp(b, block, ch, ch_out, count, stride)
        stages += blocks
    model = ResNet(stem, True, stages, class_dim, ch, b)
    model.reset_parameters(seed)
    return model


def _cifar10(b, depth, class_dim, seed):
    n = (depth - 2) // 6
    stem = conv_bn_layer(b, 3, 16, 3, 1, 1)
    stages, ch = [], 16
    for ch_out, stride in ((16, 1), (32, 2), (64, 2)):
        blocks, ch = layer_warp(b, basicblock, ch, ch_out, n, stride)
        stages += blocks
    model = ResNet(stem, False, stages, class_dim, ch, b)
    model.reset_parameters(seed)
    return model


@_program_form()
def resnet_imagenet(depth=50, class_dim=1000, is_test=False, recompute=False,
                    seed=0, device=None):
    """Reference ``resnet_imagenet`` on 3-channel images: 7x7/2 stem,
    3x3/2 max pool, four stages, global average pool, fc. Reads the
    ``fused_conv_bn`` flag. Parameters are initialized from ``seed``.
    ``recompute`` checkpoints each residual block. Runs on CUDA unless
    ``device`` says otherwise."""
    b = _Build(_config.get_flag("fused_conv_bn"), is_test,
               resolve_device(device), recompute)
    return _imagenet(b, depth, class_dim, seed)


@_program_form()
def resnet_cifar10(depth=32, class_dim=10, is_test=False, seed=0,
                   device=None, recompute=False):
    """Reference ``resnet_cifar10`` on 3-channel images: 3x3 stem, three
    basicblock stages of (depth - 2) / 6 blocks, global average pool,
    fc. Reads the ``fused_conv_bn`` flag."""
    b = _Build(_config.get_flag("fused_conv_bn"), is_test,
               resolve_device(device), recompute)
    return _cifar10(b, depth, class_dim, seed)


def resnet_scope_names(depth=50, fused_conv_bn=True, class_dim=1000,
                       cifar=False):
    """The reference's scope names of a ResNet trained with Momentum and
    built with the ``fused_conv_bn`` flag as given, in program order:
    {"parameters": [...], "running_stats": [...], "velocities": [...]}
    (fused ResNet-50: 161, 106 and 161 names; the scope also holds
    ``learning_rate_0``). Built on the meta device, so nothing is
    allocated; the flag itself is not read."""
    b = _Build(bool(fused_conv_bn), False, resolve_device("meta"))
    model = (_cifar10 if cifar else _imagenet)(b, depth, class_dim, 0)
    tensors = model.reference_tensors()
    params = [n for n, t in tensors.items() if isinstance(t, nn.Parameter)]
    return {"parameters": params,
            "running_stats": [n for n in tensors if n not in set(params)],
            "velocities": [n + "_velocity_acc_0" for n in params]}


# -- the program form (reference paddle_tpu/models/resnet.py) ---------------

def _program_conv_bn_layer(input, ch_out, filter_size, stride, padding,
                           act="relu", is_test=False, name=None):
    if _config.get_flag("fused_conv_bn"):
        # one conv2d_bn op; construction-time flag read
        return layers.fused_conv_bn(
            input, num_filters=ch_out, filter_size=filter_size,
            stride=stride, padding=padding, act=act, is_test=is_test,
            name=name)
    conv = layers.conv2d(input, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act=None, bias_attr=False,
                         name=name)
    return layers.batch_norm(conv, act=act, is_test=is_test,
                             name=None if name is None else name + "_bn")


def _program_shortcut(input, ch_out, stride, is_test=False):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                             is_test=is_test)
    return input


def _program_basicblock(input, ch_out, stride, is_test=False):
    short = shortcut(input, ch_out, stride, is_test)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None,
                          is_test=is_test)
    return layers.elementwise_add(short, conv2, act="relu")


def _program_bottleneck(input, ch_out, stride, is_test=False):
    short = shortcut(input, ch_out * 4, stride, is_test)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test)
    return layers.elementwise_add(short, conv3, act="relu")


def _program_layer_warp(block_func, input, ch_out, count, stride,
                        is_test=False, recompute=False):
    """recompute: wrap each residual block in layers.recompute."""
    def apply(x, stride_):
        if recompute:
            return layers.recompute(
                lambda: block_func(x, ch_out, stride_, is_test))
        return block_func(x, ch_out, stride_, is_test)

    res = apply(input, stride)
    for i in range(1, count):
        res = apply(res, 1)
    return res


def _program_resnet_imagenet(img, label, depth=50, class_dim=1000,
                             is_test=False, recompute=False):
    block, stages = DEPTH_CFG[depth]
    conv1 = conv_bn_layer(img, 64, 7, 2, 3, is_test=is_test)
    pool1 = layers.pool2d(conv1, pool_size=3, pool_type="max",
                          pool_stride=2, pool_padding=1)
    res1 = layer_warp(block, pool1, 64, stages[0], 1, is_test, recompute)
    res2 = layer_warp(block, res1, 128, stages[1], 2, is_test, recompute)
    res3 = layer_warp(block, res2, 256, stages[2], 2, is_test, recompute)
    res4 = layer_warp(block, res3, 512, stages[3], 2, is_test, recompute)
    pool2 = layers.pool2d(res4, pool_size=7, pool_type="avg",
                          global_pooling=True)
    flat_dim = pool2.shape[1]
    flat = layers.reshape(pool2, [-1, flat_dim])
    logits = layers.fc(flat, class_dim)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return loss, acc, logits


def _program_resnet_cifar10(img, label, depth=32, class_dim=10,
                            is_test=False, recompute=False):
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(img, 16, 3, 1, 1, is_test=is_test)
    res1 = layer_warp(basicblock, conv1, 16, n, 1, is_test, recompute)
    res2 = layer_warp(basicblock, res1, 32, n, 2, is_test, recompute)
    res3 = layer_warp(basicblock, res2, 64, n, 2, is_test, recompute)
    pool = layers.pool2d(res3, pool_size=8, pool_type="avg",
                         global_pooling=True)
    flat = layers.reshape(pool, [-1, pool.shape[1]])
    logits = layers.fc(flat, class_dim)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return loss, acc, logits


_PROGRAM = {name[len("_program_"):]: fn for name, fn in globals().items()
            if name.startswith("_program_") and name != "_program_form"}
