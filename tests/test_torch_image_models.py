"""The image recipes and SSD (``models/{alexnet,vgg,googlenet,smallnet,
ssd}.py`` in both packages): the programs the port builds serialize as
the reference's, byte for byte, at their full sizes (ImageNet 224² with
1000 classes, SmallNet's 3 x 32 x 32 with 10, SSD's 300² VOC net with 21,
training and inference); and one Momentum(0.01, 0.9) step from a
``paddle_tpu`` checkpoint (the startup's initializers drawn in numpy into
a reference scope, ``save_persistables`` → ``load_persistables``, the
dropout key with it) at the smallest input each model admits, batch
2, gives the reference's loss within 1e-5 and each parameter and
velocity within 1e-5 of its largest magnitude. The reference convolves
in XLA, the port in torch; both on the CPU."""

import json

import numpy as np
import pytest

import paddle_tpu as ptpu
from paddle_tpu import io as ref_io
from paddle_tpu import layers as ref_layers
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu.models import (alexnet as ref_alexnet, vgg as ref_vgg,
                               googlenet as ref_googlenet,
                               smallnet as ref_smallnet, ssd as ref_ssd)
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.models import (alexnet as port_alexnet,
                                     vgg as port_vgg,
                                     googlenet as port_googlenet,
                                     smallnet as port_smallnet,
                                     ssd as port_ssd)
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-5
G = 3          # SSD's padded ground-truth boxes an image

# name -> (build function by package, full input, smallest input, classes)
MODELS = {
    "alexnet": ({"ref": ref_alexnet.alexnet, "port": port_alexnet.alexnet},
                224, 65, 1000),
    "vgg19": ({"ref": lambda i, l, **k: ref_vgg.vgg(i, l, depth=19, **k),
               "port": lambda i, l, **k: port_vgg.vgg(i, l, depth=19, **k)},
              224, 32, 1000),
    "googlenet": ({"ref": ref_googlenet.googlenet,
                   "port": port_googlenet.googlenet}, 224, 32, 1000),
    "smallnet": ({"ref": ref_smallnet.smallnet,
                  "port": port_smallnet.smallnet}, 32, 32, 10),
}


def _pkg(pkg):
    return (ptpu, ref_layers, ptpu.optimizer, ref_ssd) if pkg == "ref" \
        else (pc, port_layers, port_opt, port_ssd)


def _recipe(pkg, name, res, train=True):
    """The recipe's program at res² with Momentum(0.01, 0.9)."""
    fw, L, opt, _ = _pkg(pkg)
    build, _, _, classes = MODELS[name]
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 3
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        img = L.data("img", shape=[3, res, res])
        label = L.data("label", shape=[1], dtype="int64")
        loss, _, _ = build[pkg](img, label, class_dim=classes)
        if train:
            opt.Momentum(learning_rate=0.01, momentum=0.9).minimize(
                loss, startup)
    return main, startup, loss


def _ssd(pkg, res, mode="train", classes=21):
    """``ssd_net`` at res² (padded ground truth of G boxes), Momentum(0.01,
    0.9) in training; the detections in inference."""
    fw, L, opt, ssd = _pkg(pkg)
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 3
    with fw.unique_name.guard(), fw.program_guard(main, startup):
        img = L.data("img", shape=[3, res, res])
        if mode == "infer":
            return main, startup, ssd.ssd_net(img, num_classes=classes,
                                              mode="infer")
        gb = L.data("gb", shape=[G, 4])
        gl = L.data("gl", shape=[G], dtype="int64")
        gc = L.data("gc", shape=[], dtype="int64")
        loss, _, _ = ssd.ssd_net(img, num_classes=classes, gt_box=gb,
                                 gt_label=gl, gt_count=gc)
        opt.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss,
                                                                startup)
    return main, startup, loss


def ssd_feed(n, res, rs, classes=21):
    """Images with 1..G ground-truth boxes each, labels 1..classes-1."""
    boxes = np.zeros((n, G, 4), np.float32)
    labels = np.zeros((n, G), np.int64)
    count = rs.randint(1, G + 1, n).astype(np.int64)
    for i in range(n):
        for g in range(count[i]):
            x0, y0 = rs.uniform(0.0, 0.6, 2)
            w, h = rs.uniform(0.1, 0.4, 2)
            boxes[i, g] = [x0, y0, x0 + w, y0 + h]
            labels[i, g] = rs.randint(1, classes)
    return {"img": rs.rand(n, 3, res, res).astype(np.float32),
            "gb": boxes, "gl": labels, "gc": count}


PROGRAMS = [(name, which) for name in MODELS for which in (0, 1)] + \
    [("ssd-" + mode, which) for mode in ("train", "infer")
     for which in (0, 1)]


@pytest.mark.parametrize("name,which", PROGRAMS,
                         ids=["%s-%s" % (n, ("main", "startup")[w])
                              for n, w in PROGRAMS])
def test_program_is_the_references(name, which):
    if name.startswith("ssd-"):
        progs = {pkg: _ssd(pkg, 300, name[4:]) for pkg in ("ref", "port")}
    else:
        progs = {pkg: _recipe(pkg, name, MODELS[name][1])
                 for pkg in ("ref", "port")}
    ref = json.dumps(ref_ser.program_to_dict(progs["ref"][which]))
    port = json.dumps(port_ser.program_to_dict(progs["port"][which]))
    assert port == ref


def numpy_startup(startup, scope, seed=3):
    """The startup program's initializers drawn in numpy into ``scope``
    (each ``gaussian_random``, ``uniform_random``, ``fill_constant`` and
    ``assign_value`` with its attributes), and the dropout key: the
    reference's executor compiles a startup's random ops for ~17 s for
    GoogLeNet, and its draws are not what these tests compare (the
    startup programs are held equal above; the random ops' draws bitwise
    in ``test_torch_ops_random.py``)."""
    rs = np.random.RandomState(seed)
    for op in startup.global_block().ops:
        a = op.attrs
        shape, dtype = tuple(a["shape"]), np.dtype(a["dtype"])
        if op.type == "gaussian_random":
            v = rs.normal(a["mean"], a["std"], shape)
        elif op.type == "uniform_random":
            v = rs.uniform(a["min"], a["max"], shape)
        elif op.type == "assign_value":
            v = np.asarray(a["values"]).reshape(shape)
        else:
            assert op.type == "fill_constant", op.type
            v = np.full(shape, a["value"])
        scope.set_var(op.outputs["Out"][0], v.astype(dtype))
    scope.set_var("@RNG_STATE@", np.array([0, seed], np.uint32))


def one_step(tmp_path, build, feed):
    """Loss, and the persistables, of one step of the reference's program
    and of the port's from the reference's checkpoint (the startup's
    initializers drawn in numpy, ``save_persistables`` →
    ``load_persistables``)."""
    d = str(tmp_path)
    main, startup, loss = build("ref")
    exe, scope = ptpu.Executor(), ptpu.Scope()
    with ptpu.scope_guard(scope):
        numpy_startup(startup, scope)
        ref_io.save_persistables(exe, d, main_program=main)
        want = float(np.asarray(exe.run(main, feed=feed,
                                        fetch_list=[loss])[0]).ravel()[0])
    pmain, _, ploss = build("port")
    pexe, pscope = pc.Executor(device="cpu"), pc.Scope()
    port_io.load_persistables(pexe, d, main_program=pmain, scope=pscope)
    got = float(np.asarray(pexe.run(pmain, feed=feed, fetch_list=[ploss],
                                    scope=pscope)[0]).ravel()[0])
    return want, got, scope, pscope, pmain


def state_errors(scope, pscope, pmain):
    """{persistable: max|port - ref| / max|ref|} after the step."""
    errs = {}
    for v in pmain.global_block().vars.values():
        if not v.persistable or v.name.startswith("@"):
            continue
        w = np.asarray(scope.find_var(v.name))
        g = pscope.find_var(v.name).numpy()
        errs[v.name] = float(np.abs(g - w).max()) / max(
            float(np.abs(w).max()), 1e-30)
    assert errs
    return errs


def check_one_step(tmp_path, name):
    """One Momentum step of recipe ``name`` from the reference's
    checkpoint: the loss and every parameter and velocity within 1e-5."""
    _, _, res, classes = MODELS[name]
    rs = np.random.RandomState(5)
    feed = {"img": rs.randn(2, 3, res, res).astype(np.float32),
            "label": rs.randint(0, classes, (2, 1)).astype(np.int64)}
    want, got, scope, pscope, pmain = one_step(
        tmp_path, lambda pkg: _recipe(pkg, name, res), feed)
    assert abs(got - want) <= RTOL * abs(want), (got, want)
    errs = state_errors(scope, pscope, pmain)
    bad = {n: e for n, e in errs.items() if e > RTOL}
    assert not bad, bad


# GoogLeNet's and VGG-19's steps are test_torch_image_steps.py's
@pytest.mark.parametrize("name", ["alexnet", "smallnet"])
def test_one_momentum_step_from_a_reference_checkpoint(tmp_path, name):
    check_one_step(tmp_path, name)
