"""Image preprocessing utilities (reference ``python/paddle/v2/image.py``:
resize_short, center_crop, random_crop, left_right_flip,
simple_transform, to_chw) in pure numpy (the reference uses cv2; the
math here is bilinear resample + crops, no native dependency).

The port's copy of ``paddle_tpu/utils/image.py``: it imports nothing of
that package, and gives the same results.
"""

import numpy as np

__all__ = ["resize_short", "center_crop", "random_crop",
           "left_right_flip", "to_chw", "simple_transform"]


def _resize(im, h, w):
    """Bilinear resample HWC (or HW) image to (h, w)."""
    ih, iw = im.shape[:2]
    if (ih, iw) == (h, w):
        return im
    ys = (np.arange(h) + 0.5) * ih / h - 0.5
    xs = (np.arange(w) + 0.5) * iw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, ih - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, iw - 1)
    y1 = np.clip(y0 + 1, 0, ih - 1)
    x1 = np.clip(x0 + 1, 0, iw - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    if im.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    a = im[y0][:, x0]
    b = im[y0][:, x1]
    c = im[y1][:, x0]
    d = im[y1][:, x1]
    top = a * (1 - wx) + b * wx
    bot = c * (1 - wx) + d * wx
    out = top * (1 - wy) + bot * wy
    if np.issubdtype(im.dtype, np.integer):
        out = np.rint(out)  # truncation would bias uint8 images dark
    return out.astype(im.dtype)


def resize_short(im, size):
    """Scale so the SHORTER edge equals ``size`` (reference
    image.py resize_short)."""
    h, w = im.shape[:2]
    if h < w:
        return _resize(im, size, int(round(w * size / h)))
    return _resize(im, int(round(h * size / w)), size)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    hs = max((h - size) // 2, 0)
    ws = max((w - size) // 2, 0)
    return im[hs:hs + size, ws:ws + size]


def random_crop(im, size, rng=None):
    rng = rng or np.random
    h, w = im.shape[:2]
    hs = rng.randint(0, max(h - size, 0) + 1)
    ws = rng.randint(0, max(w - size, 0) + 1)
    return im[hs:hs + size, ws:ws + size]


def left_right_flip(im):
    return im[:, ::-1]


def to_chw(im, order=(2, 0, 1)):
    return im.transpose(order)


def simple_transform(im, resize_size, crop_size, is_train,
                     is_color=True, mean=None, rng=None):
    """resize_short -> crop (+flip when training) -> CHW -> -mean
    (reference image.py simple_transform)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, rng=rng)
        if (rng or np.random).randint(0, 2):
            im = left_right_flip(im)
    else:
        im = center_crop(im, crop_size)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype(np.float32)
    if mean is not None:
        im -= np.asarray(mean, dtype=np.float32).reshape(
            -1, *( [1] * (im.ndim - 1) ))
    return im
