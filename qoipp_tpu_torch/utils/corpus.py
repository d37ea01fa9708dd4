"""Synthetic inputs of the codec's measurements, made from a seed.

Copies of the JAX package's two generators, on the port's oracle and
``Desc``, so the port's smoke run and tests need nothing of ``qoipp_tpu``
or ``bench``: the same seed gives the same bytes on both sides.
"""

from __future__ import annotations

import numpy as np

from .. import oracle
from ..common import Channels, Desc


def make_corpus(b, w, h, seed=0, channels=3):
    """B synthetic 'photographic-ish' images, piecewise-flat regions,
    smooth gradients and a noise patch (every QOI op class); channels=4
    adds alpha variation.  Returns (desc, raws, blobs): raw uint8 pixels
    and their oracle-encoded streams."""
    rng = np.random.default_rng(seed)
    desc = Desc(w, h, Channels(channels))
    raws, blobs = [], []
    for _ in range(b):
        y, x = np.mgrid[0:h, 0:w]
        grad = ((x * 255 // max(w - 1, 1)) // 3
                + (y * 150 // max(h - 1, 1)) // 3)
        base = np.stack([grad, grad + 40, 255 - grad],
                        axis=-1).astype(np.uint8)
        for _ in range(60):  # flat patches
            py, px = rng.integers(0, h), rng.integers(0, w)
            ph, pw = rng.integers(8, h // 4), rng.integers(8, w // 4)
            base[py : py + ph, px : px + pw] = rng.integers(0, 256, 3)
        py, px = rng.integers(0, h // 2), rng.integers(0, w // 2)
        base[py : py + h // 8, px : px + w // 8] = rng.integers(  # noise
            0, 256, (min(h // 8, h - py), min(w // 8, w - px), 3))
        if channels == 4:
            alpha = np.full((h, w), 255, np.uint8)
            for _ in range(40):  # translucent patches
                py, px = rng.integers(0, h), rng.integers(0, w)
                ph, pw = rng.integers(8, h // 4), rng.integers(8, w // 4)
                alpha[py : py + ph, px : px + pw] = rng.integers(0, 256)
            alpha = np.minimum(  # banded vignette
                alpha, 128 + ((x + y) // 24 * 8) % 128).astype(np.uint8)
            base = np.concatenate([base, alpha[:, :, None]], axis=-1)
        raw = base.reshape(-1)
        enc, complete = oracle.encode(raw, desc)
        assert complete
        raws.append(raw)
        blobs.append(enc)
    return desc, raws, blobs


def make_image(w, h, seed=3):
    """One large RGB image of gradients and 240 flat rectangles plus a
    noise patch (the input of the split-replay measurements): raw uint8
    pixels, w * h * 3 bytes."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    grad = ((x * 255 // max(w - 1, 1)) // 3 + (y * 150 // max(h - 1, 1)) // 3)
    base = np.stack([grad, grad + 40, 255 - grad], axis=-1).astype(np.uint8)
    for _ in range(240):
        py, px = rng.integers(0, h), rng.integers(0, w)
        ph, pw = rng.integers(8, h // 6), rng.integers(8, w // 6)
        base[py : py + ph, px : px + pw] = rng.integers(0, 256, 3)
    py, px = rng.integers(0, h // 2), rng.integers(0, w // 2)
    base[py : py + h // 8, px : px + w // 8] = rng.integers(
        0, 256, (min(h // 8, h - py), min(w // 8, w - px), 3))
    return base.reshape(-1)
