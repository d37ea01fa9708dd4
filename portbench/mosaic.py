"""A large image from a committed one: a grid of tiles, each the tile
image flipped horizontally, vertically or both, as a seeded draw says.

The streaming configuration's 8K frame is a 4 x 4 mosaic of the 1080p
photo: no image of that size is committed, and none may be fetched.  The
flips keep each tile's content a photo's while its neighbours differ at
every seam, so no tile's stream repeats the one beside it.
"""

from __future__ import annotations

import numpy as np

from . import corpus, reference

# a tile's flips, drawn from 1..3: bit 0 horizontal (columns reversed),
# bit 1 vertical (rows reversed)
FLIP_H, FLIP_V = 1, 2


def flips(seed: int, tiles: int, image: int = 0) -> np.ndarray:
    """The flips of image ``image``'s ``tiles`` tiles in row-major order,
    each 1 (horizontal), 2 (vertical) or 3 (both): row ``image`` of one
    draw of ``numpy.random.default_rng([seed, 7])``, a row an image."""
    return np.random.default_rng([seed, 7]).integers(
        1, 4, (image + 1, tiles))[image]


def flipped(tile: np.ndarray, code: int) -> np.ndarray:
    """(h, w, c) ``tile`` with the flips of ``code``."""
    if code & FLIP_H:
        tile = tile[:, ::-1]
    if code & FLIP_V:
        tile = tile[::-1]
    return tile


def make(tile: np.ndarray, rows: int, cols: int, seed: int,
         image: int = 0) -> np.ndarray:
    """A (rows * h, cols * w, c) uint8 mosaic of the (h, w, c) ``tile``,
    tile (i, j) flipped as ``flips(seed, rows * cols, image)[i * cols +
    j]``."""
    h, w, c = tile.shape
    out = np.empty((rows * h, cols * w, c), np.uint8)
    for k, code in enumerate(flips(seed, rows * cols, image)):
        i, j = divmod(k, cols)
        out[i * h: (i + 1) * h, j * w: (j + 1) * w] = flipped(tile, code)
    return out


def from_config(root, config: dict, seed: int, images: int = 1):
    """A mosaic configuration's images: (reference.Header, a list of
    ``images`` (n_px * c,) uint8 pixel arrays), each a ``rows`` x ``cols``
    mosaic of the one file of its corpus (``dir``, ``digests``,
    ``files``), held to its digest, whose geometry has to make ``width`` x
    ``height``."""
    files = corpus.load(root, config)
    if len(files.names) != 1:
        raise ValueError("a mosaic configuration names one tile file")
    th = files.headers[0]
    rows, cols = config["rows"], config["cols"]
    header = reference.Header(config["width"], config["height"],
                              config["channels"], config.get("colorspace",
                                                             0))
    if (th.width * cols, th.height * rows, th.channels) != (
            header.width, header.height, header.channels):
        raise ValueError(f"{rows} x {cols} tiles of {files.names[0]} "
                         f"({th.width}x{th.height}, {th.channels} "
                         f"channels) do not make {header.width}x"
                         f"{header.height} with {header.channels}")
    tile = corpus.raw_pixels(root, files)[0].reshape(th.height, th.width,
                                                     th.channels)
    return header, [make(tile, rows, cols, seed, i).reshape(-1)
                    for i in range(images)]
