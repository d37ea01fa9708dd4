"""The port's stream census (utils/debug.py: inspect_stream, StreamStats)
against the JAX package's, every field equal, on the reference's fixtures
(whole and truncated streams) and the committed real corpus."""

from pathlib import Path

import numpy as np
import pytest

from conftest import FIXTURES
from qoipp_tpu.utils.debug import inspect_stream as jinspect
from qoipp_tpu_torch.utils.debug import StreamStats, inspect_stream

CORPUS = Path(__file__).resolve().parent / "resources" / "local_corpus"
STREAMS = ([FIXTURES / n for n in ("image_qoi_3.bin", "image_qoi_4.bin",
                                   "image_qoi_3_incomplete.bin",
                                   "image_qoi_4_incomplete.bin")]
           + sorted(CORPUS.glob("*.qoi")))


@pytest.mark.parametrize("path", STREAMS, ids=[p.stem for p in STREAMS])
def test_inspect_stream_matches_jax(path):
    data = np.frombuffer(path.read_bytes(), np.uint8)
    got, want = inspect_stream(data, device="cpu"), jinspect(data)
    assert isinstance(got, StreamStats)
    d, w = got.desc, want.desc
    assert (d.width, d.height, int(d.channels), int(d.colorspace)) == (
        w.width, w.height, int(w.channels), int(w.colorspace))
    assert (got.chunks, got.pixels, got.bytes_total) == (
        want.chunks, want.pixels, want.bytes_total)
    assert got.ops == want.ops
    assert str(got) == str(want)
    assert sum(got.ops.values()) == got.chunks
    # bytes as well as an array
    assert inspect_stream(path.read_bytes(), device="cpu").ops == got.ops
