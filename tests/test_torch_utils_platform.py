"""The port's host utilities of the v2 slice against the reference's:
``utils/image.py`` bit for bit on seeded images, ``plot.Ploter``'s CSV
text (and its file: a PNG when matplotlib imports, the CSV otherwise),
and ``utils/net_drawer.draw_program``'s dot text of programs built the
same way in both packages. All exact."""

import builtins

import numpy as np
import pytest

import paddle_tpu as ptpu
from paddle_tpu import layers as ref_layers
from paddle_tpu import plot as ref_plot
from paddle_tpu.utils import image as ref_image
from paddle_tpu.utils import net_drawer as ref_drawer
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch import plot as port_plot
from paddle_tpu_torch.utils import image as port_image
from paddle_tpu_torch.utils import net_drawer as port_drawer
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _images():
    rs = np.random.RandomState(11)
    return {"f32-hwc": rs.rand(37, 23, 3).astype("float32"),
            "u8-hwc": rs.randint(0, 256, (30, 41, 3)).astype("uint8"),
            "f64-hw": rs.randn(17, 29),
            "u8-hw-square": rs.randint(0, 256, (16, 16)).astype("uint8")}


IMAGES = sorted(_images())


def _bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want) and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", IMAGES)
def test_image_transforms_bitwise(name):
    im = _images()[name]
    for size in (8, 13, 40):
        _bitwise(port_image.resize_short(im, size),
                 ref_image.resize_short(im, size))
    for h, w in ((5, 7), (im.shape[0], im.shape[1]), (50, 9)):
        _bitwise(port_image._resize(im, h, w), ref_image._resize(im, h, w))
    for size in (4, 15, 60):
        _bitwise(port_image.center_crop(im, size),
                 ref_image.center_crop(im, size))
        _bitwise(port_image.random_crop(im, size, np.random.RandomState(2)),
                 ref_image.random_crop(im, size, np.random.RandomState(2)))
    _bitwise(port_image.left_right_flip(im), ref_image.left_right_flip(im))
    if im.ndim == 3:
        _bitwise(port_image.to_chw(im), ref_image.to_chw(im))


@pytest.mark.parametrize("name", IMAGES)
@pytest.mark.parametrize("is_train", [False, True])
def test_simple_transform_bitwise(name, is_train):
    im = _images()[name]
    mean = [0.5, 0.25, 0.125][:im.shape[2]] if im.ndim == 3 else [0.5]
    for kw in ({}, {"mean": mean}):
        got = port_image.simple_transform(
            im, 14, 10, is_train, rng=np.random.RandomState(5), **kw)
        want = ref_image.simple_transform(
            im, 14, 10, is_train, rng=np.random.RandomState(5), **kw)
        _bitwise(got, want)


def _curves(module):
    p = module.Ploter("train", "test")
    for step in range(5):
        p.append("train", step, 1.0 / (step + 1))
        if step % 2:
            p.append("test", step, np.float32(0.7) ** step)
    return p


def test_ploter_csv_equals_reference(tmp_path):
    port, ref = _curves(port_plot), _curves(ref_plot)
    assert port.to_csv() == ref.to_csv()
    assert port.plot() == ref.plot() == ref.to_csv()
    with pytest.raises(KeyError) as got:
        port.append("nope", 0, 0)
    with pytest.raises(KeyError) as want:
        ref.append("nope", 0, 0)
    assert str(got.value) == str(want.value)
    port.reset()
    ref.reset()
    assert port.to_csv() == ref.to_csv() == "title,step,value"


def test_ploter_file_equals_reference(tmp_path, monkeypatch):
    """Without matplotlib both write the CSV text to the path; with it
    both write a PNG."""
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)
    with monkeypatch.context() as m:
        m.setattr(builtins, "__import__", no_matplotlib)
        paths = [mod.Ploter.plot(_curves(mod), str(tmp_path / (
            "%s.csv" % i))) for i, mod in enumerate((port_plot, ref_plot))]
    texts = [open(p).read() for p in paths]
    assert texts[0] == texts[1] == _curves(ref_plot).to_csv()
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return
    for i, mod in enumerate((port_plot, ref_plot)):
        path = _curves(mod).plot(str(tmp_path / ("%d.png" % i)))
        assert open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def _program(pkg, layers, minimize):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = layers.data("img", shape=[1, 8, 8])
        label = layers.data("label", shape=[1], dtype="int64")
        conv = layers.conv2d(img, num_filters=4, filter_size=3, act="relu")
        pool = layers.pool2d(conv, pool_size=2, pool_stride=2)
        logits = layers.fc(pool, 10)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        minimize(loss, startup)
    return main, startup


@pytest.mark.parametrize("train", [False, True], ids=["forward", "train"])
def test_draw_program_equals_reference(tmp_path, train):
    ref_main, ref_startup = _program(
        ptpu, ref_layers, lambda loss, s: train and ptpu.optimizer.SGD(
            learning_rate=0.1).minimize(loss, startup_program=s))
    port_main, port_startup = _program(
        pc, port_layers, lambda loss, s: train and port_opt.SGD(
            learning_rate=0.1).minimize(loss, s))
    for main_pair in ((port_main, ref_main), (port_startup, ref_startup)):
        got = port_drawer.draw_program(main_pair[0])
        want = ref_drawer.draw_program(main_pair[1])
        assert got == want
        assert got.startswith("digraph program {") and "->" in got
    assert port_drawer.draw_program(port_main, max_label=6) == \
        ref_drawer.draw_program(ref_main, max_label=6)
    path = port_drawer.save_dot(port_main, str(tmp_path / "p.dot"))
    assert open(path).read() == ref_drawer.draw_program(ref_main)
