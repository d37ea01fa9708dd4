"""The batch path on RGBA frames whose alpha varies (the
``batch_1080p_rgba`` configuration's content, cut to CPU sizes), on the
CPU with the kernels' plain versions, against the benchmark's plain
reference (``portbench/reference.py``: ``qoi.h`` in plain PyTorch,
importing nothing of the port).  The frames carry OP_RGBA chunks;
``BatchPipeline.decode`` gives their four channels back, or their first
three; ``raw_to_packed`` and ``encode_packed_chunked`` give the
reference's bytes; and a traced call counts the pixels and bytes its
4-byte pack and its unpack move."""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import generator, reference
from qoipp_tpu_torch.common import Channels, Desc
from qoipp_tpu_torch.models.pipeline import BatchPipeline
from qoipp_tpu_torch.utils import tracing

torch.set_num_threads(1)

CONFIG = (Path(__file__).resolve().parent.parent / "portbench" / "configs"
          / "batch_1080p_rgba.json")
SIZES = ((96, 64), (128, 72))
SEEDS = (0, 1, 2)
B = 4


def _chunk_tags(stream: np.ndarray):
    """(chunks, OP_RGBA chunks, OP_RGBA bytes, body bytes) of a stream."""
    i, end = 14, stream.size - 8
    n = rgba = 0
    while i < end:
        tag = int(stream[i])
        if tag == 0xFF:
            rgba += 1
            i += 5
        elif tag == 0xFE:
            i += 4
        elif tag >> 6 == 2:
            i += 2
        else:
            i += 1
        n += 1
    return n, rgba, 5 * rgba, end - 14


@functools.cache
def _frames(w: int, h: int, seed: int, channels: int = 4):
    """(raws, the reference's streams) of B generator frames."""
    raws = generator.make_images(B, w, h, seed, channels)
    header = reference.Header(w, h, channels, 0)
    return raws, [reference.encode(torch.from_numpy(r), header).stream.numpy()
                  for r in raws]


def _pipe(w, h, channels=4, **kw):
    return BatchPipeline(Desc(w, h, Channels(channels)), device="cpu", **kw)


def test_configuration_is_rgba():
    c = json.loads(CONFIG.read_text())
    assert (c["width"], c["height"], c["channels"]) == (1920, 1080, 4)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("size", SIZES)
def test_frames_hold_op_rgba_and_round_trip(size, seed):
    """At these sizes OP_RGBA is 7.6-9.5% of chunks and about a quarter of
    the body's bytes (at 1920 x 1080 20-23% and 44-49%)."""
    raws, streams = _frames(*size, seed)
    for raw, s in zip(raws, streams):
        n, rgba, rgba_bytes, body = _chunk_tags(s)
        assert rgba >= 0.05 * n
        assert rgba_bytes >= 0.2 * body
        assert np.array_equal(reference.decode(s), raw)
        alpha = raw.reshape(-1, 4)[:, 3]
        assert alpha.max() < 255 and np.unique(alpha).size > 2


@pytest.mark.parametrize("target", (Channels.RGBA, Channels.RGB))
@pytest.mark.parametrize("size", SIZES)
def test_batch_decode_gives_the_frames(size, target):
    raws, streams = _frames(*size, 0)
    pipe = _pipe(*size, max_stream_len=max(s.size for s in streams))
    out = pipe.decode(*pipe.pack_streams(streams), target)
    w, h = size
    assert out.shape == (B, h, w, int(target)) and out.dtype == torch.uint8
    want = np.stack(raws).reshape(B, h, w, 4)[..., : int(target)]
    assert np.array_equal(out.numpy(), want)


@pytest.mark.parametrize("size", SIZES)
def test_batch_encode_gives_the_reference_bytes(size):
    raws, streams = _frames(*size, 1)
    pipe = _pipe(*size)
    out, lengths, ok = pipe.encode_packed_chunked(
        pipe.raw_to_packed(torch.from_numpy(np.stack(raws))), sub=2)
    assert bool(ok.all())
    for i, want in enumerate(streams):
        assert np.array_equal(out[i, : int(lengths[i])].numpy(), want)


W, H = SIZES[0]
N_PX = W * H


@pytest.mark.parametrize("target", (Channels.RGB, Channels.RGBA))
@pytest.mark.parametrize("channels", (3, 4))
def test_traced_decode_counts_the_unpack(channels, target):
    """``decode.unpack`` counts the pixels it unpacks and the bytes it
    writes, the target's channels a pixel, whatever the streams hold."""
    raws, streams = _frames(W, H, 2, channels)
    pipe = _pipe(W, H, channels)
    packed = pipe.pack_streams(streams)
    with tracing.collect() as tr:
        with tracing.request(0):
            out = pipe.decode(*packed, target)
    want = np.stack(raws).reshape(B, H, W, channels)[..., : int(target)]
    if int(target) > channels:  # an RGB stream's alpha is 255
        want = np.concatenate(
            [want, np.full((B, H, W, 1), 255, np.uint8)], axis=-1)
    assert np.array_equal(out.numpy(), want)
    assert [s.name for s in tr.spans].count("decode.unpack") == 1
    assert tr.counters[(0, "unpack_px")] == B * N_PX
    assert tr.counters[(0, "unpack_bytes")] == B * N_PX * int(target)
    assert (0, "pack_px") not in tr.counters
    assert not tracing.enabled()


@pytest.mark.parametrize("channels", (3, 4))
def test_traced_encode_counts_the_pack(channels):
    """``encode.pack`` holds ``pixels_to_packed`` and the pad, counts
    B x n_px pixels and the raw bytes it reads, and adds no device work:
    the words are the untraced call's."""
    raws, _ = _frames(W, H, 2, channels)
    pipe = _pipe(W, H, channels)
    x = torch.from_numpy(np.stack(raws))
    plain = pipe.raw_to_packed(x)
    with tracing.collect() as tr:
        with tracing.request(0), tracing.span("call"):
            packed = pipe.raw_to_packed(x)
    assert torch.equal(packed, plain) and packed.shape == (B, pipe.nb)
    (pack,) = [s for s in tr.spans if s.name == "encode.pack"]
    call = next(s for s in tr.spans if s.name == "call")
    assert pack.parent == call.id
    assert tr.counters[(0, "pack_px")] == B * N_PX
    assert tr.counters[(0, "pack_bytes")] == B * N_PX * channels
    assert (0, "unpack_px") not in tr.counters
