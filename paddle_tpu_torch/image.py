"""Image preprocessing (paddle_tpu/image.py; parity:
python/paddle/v2/image.py — resize_short, center_crop, random_crop,
left_right_flip, to_chw, simple_transform). Host code on numpy HWC
arrays, the same as the JAX package's (the reference used cv2);
``random_crop`` and ``simple_transform`` draw from ``rng`` (a
``numpy.random.RandomState``, default the global one)."""

import numpy as np


def to_chw(img, order=(2, 0, 1)):
    """HWC -> CHW."""
    return img.transpose(order)


def resize_short(img_hwc, size):
    """Resize the short side to ``size`` (nearest-neighbor, numpy-only)."""
    h, w = img_hwc.shape[:2]
    if h < w:
        nh, nw = size, int(round(w * size / h))
    else:
        nh, nw = int(round(h * size / w)), size
    rows = (np.arange(nh) * h / nh).astype(np.int64).clip(0, h - 1)
    cols = (np.arange(nw) * w / nw).astype(np.int64).clip(0, w - 1)
    return img_hwc[rows][:, cols]


def center_crop(img_hwc, size):
    h, w = img_hwc.shape[:2]
    top = max((h - size) // 2, 0)
    left = max((w - size) // 2, 0)
    return img_hwc[top: top + size, left: left + size]


def random_crop(img_hwc, size, rng=None):
    rng = rng or np.random
    h, w = img_hwc.shape[:2]
    top = rng.randint(0, max(h - size, 0) + 1)
    left = rng.randint(0, max(w - size, 0) + 1)
    return img_hwc[top: top + size, left: left + size]


def left_right_flip(img_hwc):
    return img_hwc[:, ::-1]


def simple_transform(img_hwc, resize_size, crop_size, is_train=True,
                     mean=None, rng=None):
    """resize short side -> crop -> maybe flip -> CHW float32 (reference:
    simple_transform)."""
    img = resize_short(img_hwc, resize_size)
    if is_train:
        img = random_crop(img, crop_size, rng)
        if (rng or np.random).randint(2):
            img = left_right_flip(img)
    else:
        img = center_crop(img, crop_size)
    img = to_chw(img).astype(np.float32)
    if mean is not None:
        img -= np.asarray(mean, np.float32).reshape(-1, 1, 1)
    return img
