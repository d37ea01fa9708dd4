"""Synthetic images from a seed: a frozen copy of the image generator of
``qoipp_tpu_torch.utils.corpus.make_corpus`` without its encoding step.

The same seed gives the same pixels as ``make_corpus`` (a test holds the
two together); the benchmark encodes them with its own reference.  The
gradient every image starts from depends only on the geometry, so it is
computed once a call; the random draws are make_corpus's, in its order.
"""

from __future__ import annotations

import numpy as np


def make_images(b: int, w: int, h: int, seed: int, channels: int = 3):
    """B 'photographic-ish' images: piecewise-flat patches over smooth
    gradients and a noise patch (every QOI op class); channels=4 adds
    translucent patches and a banded vignette in alpha.  Returns a list
    of (h * w * channels,) uint8 arrays."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    grad = ((x * 255 // max(w - 1, 1)) // 3
            + (y * 150 // max(h - 1, 1)) // 3)
    base0 = np.stack([grad, grad + 40, 255 - grad], axis=-1).astype(np.uint8)
    vignette = 128 + ((x + y) // 24 * 8) % 128
    raws = []
    for _ in range(b):
        base = base0.copy()
        for _ in range(60):  # flat patches
            py, px = rng.integers(0, h), rng.integers(0, w)
            ph, pw = rng.integers(8, h // 4), rng.integers(8, w // 4)
            base[py: py + ph, px: px + pw] = rng.integers(0, 256, 3)
        py, px = rng.integers(0, h // 2), rng.integers(0, w // 2)
        base[py: py + h // 8, px: px + w // 8] = rng.integers(  # noise
            0, 256, (min(h // 8, h - py), min(w // 8, w - px), 3))
        if channels == 4:
            alpha = np.full((h, w), 255, np.uint8)
            for _ in range(40):  # translucent patches
                py, px = rng.integers(0, h), rng.integers(0, w)
                ph, pw = rng.integers(8, h // 4), rng.integers(8, w // 4)
                alpha[py: py + ph, px: px + pw] = rng.integers(0, 256)
            alpha = np.minimum(alpha, vignette).astype(np.uint8)
            base = np.concatenate([base, alpha[:, :, None]], axis=-1)
        raws.append(base.reshape(-1))
    return raws
