"""The gate tests of crafted and grammar-built streams against the port:
test_adversarial.py's six cases through the port's one-shot decoder
(``ops/decode.decode_single`` on the CPU) and the JAX package's, both
against the native oracle, and test_property_fuzz.py's two hypothesis
grammars (chunk streams, truncated ones included, to decode; pixel moves
to encode through ``api.encode(backend="torch")``), with the same
QOIPP_FUZZ_EXAMPLES budget (25 by default)."""

import numpy as np
import pytest

from qoipp_tpu.ops import decode as jdec
from qoipp_tpu_torch import END_MARKER, Channels, Desc, api, oracle, \
    write_header
from qoipp_tpu_torch.ops import decode as dec_ops

hyp = pytest.importorskip("hypothesis")
from hypothesis import given, strategies as st  # noqa: E402

from test_property_fuzz import (  # noqa: E402
    SETTINGS,
    _build_image,
    _chunk,
    _move,
    _serialize,
)

# the grammar tests' descs, as the port's Desc
DESCS = [Desc(8, 8, Channels.RGB), Desc(16, 4, Channels.RGBA),
         Desc(24, 14, Channels.RGBA)]


def _jdesc(desc):
    import qoipp_tpu as q

    return q.Desc(desc.width, desc.height, q.Channels(int(desc.channels)))


def check(desc, body: bytes, dst=None):
    """The port's and the JAX package's one-shot decode of header + body +
    end marker, both equal to the oracle's; returns the port's pixels."""
    import qoipp_tpu as q

    dst = desc.channels if dst is None else dst
    stream = np.frombuffer(write_header(desc) + body + END_MARKER, np.uint8)
    want = oracle.decode(stream, desc, dst)
    got = dec_ops.decode_single(stream, desc, dst, device="cpu")
    assert np.array_equal(got, want)
    jgot = jdec.decode_single(stream, _jdesc(desc), q.Channels(int(dst)))
    assert np.array_equal(np.asarray(jgot), want)
    return got


def test_index_unwritten_slot_then_reuse():
    # INDEX on unwritten slot 7 reads zeros and writes them to slot 0
    # (hash(0,0,0,0) = 0), clobbering whatever lived there
    desc = Desc(6, 1, Channels.RGBA)
    body = bytes([0xFF, 64, 0, 0, 0] + [0x00 | 7] + [0x00 | 0]
                 + [0xFF, 64, 0, 0, 0] + [0x00 | 0] + [0x00 | 7])
    check(desc, body)


def test_index_chain_through_unwritten_slots():
    check(Desc(8, 1, Channels.RGB),
          bytes([0x00 | s for s in (5, 12, 63, 53, 0, 5, 12, 63)]))


def test_diff_luma_off_unwritten_index():
    body = bytes([0x00 | 9]              # zeros from unwritten slot 9
                 + [0x40 | 0b111111]     # DIFF +1,+1,+1
                 + [0x80 | 63, 0xFF]     # LUMA extremes (wraparound)
                 + [0x40 | 0]            # DIFF -2,-2,-2 (wrap under 0)
                 + [0xC0 | 0])           # RUN 1
    check(Desc(5, 1, Channels.RGB), body)


def test_run_spam_overproduce():
    # more RUN pixels than the image holds: the reference clamps a chunk
    check(Desc(10, 1, Channels.RGB), bytes([0xFE, 1, 2, 3] + [0xC0 | 61] * 4))


def test_rgba_tags_in_rgb_stream():
    # a 3-channel header with RGBA ops: decode follows the tags, and to
    # RGBA the alpha shows
    desc = Desc(4, 1, Channels.RGB)
    body = bytes([0xFF, 10, 20, 30, 99] + [0x40 | 0b101010] + [0xC0 | 1])
    check(desc, body)
    got = check(desc, body, Channels.RGBA)
    assert got.reshape(-1, 4)[0, 3] == 99


def test_garbage_payload_fuzz_mini():
    rng = np.random.default_rng(99)
    for trial in range(8):
        w = int(rng.integers(1, 24))
        h = int(rng.integers(1, 24))
        ch = Channels.RGBA if trial % 2 else Channels.RGB
        body = bytes(rng.integers(0, 256, int(rng.integers(0, 4 * w * h + 20)),
                                  dtype=np.uint8))
        check(Desc(w, h, ch), body)


@SETTINGS
@given(di=st.integers(0, len(DESCS) - 1), ops=st.lists(_chunk, max_size=200),
       cut=st.one_of(st.none(), st.integers(0, 1000)))
def test_structured_stream_differential(di, ops, cut):
    """Grammar-built chunk streams, truncated ones included: the port's
    one-shot decoder equals the oracle."""
    desc = DESCS[di]
    stream = write_header(desc) + _serialize(ops) + END_MARKER
    if cut is not None:
        stream = stream[: 14 + min(cut, len(stream) - 14)]
    blob = np.frombuffer(stream, np.uint8)
    want = oracle.decode(blob, desc, desc.channels)
    got = dec_ops.decode_single(blob, desc, desc.channels, device="cpu")
    assert np.array_equal(got, want)


@SETTINGS
@given(di=st.integers(0, len(DESCS) - 1), moves=st.lists(_move, max_size=60))
def test_structured_image_encode_differential(di, moves):
    """Grammar-built images: the api's torch backend equals the oracle
    (op precedence, LUMA narrowing corners)."""
    desc = DESCS[di]
    raw = _build_image(moves, desc.width * desc.height, int(desc.channels))
    want, complete = oracle.encode(raw, desc)
    assert complete
    got = api.encode(raw, desc, backend="torch", device="cpu").value()
    assert np.array_equal(got, want)
