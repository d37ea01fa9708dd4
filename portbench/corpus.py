"""A corpus configuration's files: read in place, held to their SHA-256
digests, and their raw pixels by the benchmark's own reference.

The reference decoder is plain Python (some seconds for the committed
corpus), so its pixels are cached under ``build/portbench/`` in the
checkout, keyed by the file's digest and by the digest of
``reference.py``: only the first run in a checkout decodes.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import List, NamedTuple

import numpy as np

from . import reference

CACHE = Path("build") / "portbench" / "corpus"


class Corpus(NamedTuple):
    names: List[str]
    blobs: List[np.ndarray]  # the files' bytes, uint8
    headers: List[reference.Header]
    digests: List[str]


def sha256(data) -> str:
    return hashlib.sha256(memoryview(np.ascontiguousarray(data))).hexdigest()


def read_digests(path: Path) -> dict:
    """A ``sha256sum`` listing -> {file name: digest}."""
    out = {}
    for line in path.read_text().splitlines():
        if line.strip():
            digest, name = line.split(None, 1)
            out[name.strip().lstrip("*")] = digest
    return out


def load(root: Path, config: dict) -> Corpus:
    """The configuration's files, in its order; raises if one is missing
    or its digest differs from the one the benchmark keeps."""
    want = read_digests(root / config["digests"])
    folder = root / config["dir"]
    names, blobs, headers, digests = [], [], [], []
    for name in config["files"]:
        blob = np.fromfile(folder / name, np.uint8)
        d = sha256(blob)
        if d != want.get(name):
            raise RuntimeError(f"corpus file {folder / name} has SHA-256 "
                               f"{d}, the benchmark keeps {want.get(name)}")
        names.append(name)
        blobs.append(blob)
        headers.append(reference.read_header(blob))
        digests.append(d)
    return Corpus(names, blobs, headers, digests)


def _reference_digest() -> str:
    return hashlib.sha256(Path(reference.__file__).read_bytes()).hexdigest()


def raw_pixels(root: Path, corpus: Corpus) -> List[np.ndarray]:
    """Each file's raw pixels by the reference decoder, through the cache
    in the checkout."""
    folder = root / CACHE
    ref = _reference_digest()[:16]
    out = []
    for blob, digest in zip(corpus.blobs, corpus.digests):
        path = folder / f"{digest}.{ref}.npy"
        if path.exists():
            out.append(np.load(path))
            continue
        raw = reference.decode(blob)
        folder.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.{os.getpid()}.npy")
        np.save(tmp, raw)
        os.replace(tmp, path)  # a reader never sees half a file
        out.append(raw)
    return out
