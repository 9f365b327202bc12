"""Client-side input preprocessing (port of dnn_tpu/io/preprocess.py):
an image file -> RGB -> 32x32 bilinear -> [0, 1] -> normalized with mean
0.5 and std 0.5 per channel -> a (1, H, W, 3) NHWC float32 batch. On any
failure (no PIL, a missing or unreadable file) a standard-normal dummy
image from numpy's `default_rng(seed)` takes its place, the same draw
as the JAX package's."""

from __future__ import annotations

import numpy as np

CIFAR_SIZE = (32, 32)
_MEAN = 0.5
_STD = 0.5


def load_image(path: str, size=CIFAR_SIZE) -> np.ndarray:
    """Image file -> normalized (1, H, W, 3) float32 array. PIL is
    imported here, at first use."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize(size[::-1], Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    arr = (arr - _MEAN) / _STD
    return arr[None, ...]


def dummy_image(size=CIFAR_SIZE, seed: int = 0) -> np.ndarray:
    """The dummy input: standard normal (1, H, W, 3) from `seed`."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((1, *size, 3), dtype=np.float32)


def load_image_or_dummy(path, size=CIFAR_SIZE):
    """Load `path`, falling back to the dummy image on any failure.
    Returns (array, used_dummy)."""
    if not path:
        return dummy_image(size), True
    try:
        return load_image(path, size), False
    except Exception:  # noqa: BLE001 — any failure means the dummy input
        return dummy_image(size), True
