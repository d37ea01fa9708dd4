"""The port's tracing (qoipp_tpu_torch.utils.tracing) on the CPU: off by
default, spans nested per thread, requests stamped on spans and
counters, the span names of the benchmarked paths (BatchPipeline decode
and encode, ServingCodec decode and encode over tiles of the committed
corpus, the streaming codec's sessions over a tile of the 1080p photo),
counters equal to what the code returns or moves, outputs
byte-identical with tracing on and off, and the ``qoipp:`` ranges in a
torch profiler's trace."""

import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from qoipp_tpu_torch import oracle
from qoipp_tpu_torch.common import Channels, Desc
from qoipp_tpu_torch.models.packed import PackedEncoder
from qoipp_tpu_torch.models.pipeline import BatchPipeline
from qoipp_tpu_torch.models.serving import ServingCodec
from qoipp_tpu_torch.ops import device_stream
from qoipp_tpu_torch.utils import timing, tracing

torch.set_num_threads(1)

CORPUS = Path(__file__).resolve().parent / "resources" / "local_corpus"
DESC = Desc(64, 48, Channels.RGB)


def _batch(b=4, seed=0):
    """Flat-patch RGB images of DESC and their streams."""
    rng = np.random.default_rng(seed)
    raws = [(rng.integers(0, 4, DESC.width * DESC.height * 3) * 60)
            .astype(np.uint8) for _ in range(b)]
    return raws, [oracle.encode(r, DESC)[0] for r in raws]


def _tiles():
    """A tile of each committed corpus file (its channels, geometries of
    24-60 x 16-40), the tile's pixels and its stream."""
    raws, descs, blobs = [], [], []
    for i, path in enumerate(sorted(CORPUS.glob("*.qoi"))):
        data = np.fromfile(path, np.uint8)
        d = oracle.read_header(data)
        px = oracle.decode(data, d, d.channels).reshape(
            d.height, d.width, int(d.channels))
        w, h = 24 + 12 * (i % 4), 16 + 8 * (i % 4)
        y, x = d.height // 3, d.width // 3
        tile = np.ascontiguousarray(px[y: y + h, x: x + w]).reshape(-1)
        td = Desc(w, h, d.channels)
        raws.append(tile)
        descs.append(td)
        blobs.append(oracle.encode(tile, td)[0])
    return raws, descs, blobs


def _codec():
    # small caps, so the tiles take every route: packed tiers, the split
    # route for the largest streams, geometry buckets to encode
    return ServingCodec(pack_lane_bytes=1 << 11, pack_lane_px=2048,
                        min_len=1 << 12, split_min_bytes=1 << 11,
                        split_lanes=16, device="cpu")


def _batch_decode():
    raws, blobs = _batch()
    pipe = BatchPipeline(DESC, device="cpu")
    streams, sizes = pipe.pack_streams(blobs)
    return pipe.decode(streams, sizes).numpy().tobytes()


def _batch_encode():
    raws, _ = _batch()
    pipe = BatchPipeline(DESC, device="cpu")
    streams, lengths, ok = pipe.encode_packed_chunked(
        pipe.raw_to_packed(torch.from_numpy(np.stack(raws))), 2)
    return streams.numpy().tobytes() + lengths.numpy().tobytes()


def _serving_decode():
    _, _, blobs = _tiles()
    c = _codec()
    outs = c.decode_finish(c.decode_dispatch_staged(c.decode_stage(blobs)))
    return b"".join(o.tobytes() for o in outs)


def _serving_encode():
    raws, descs, _ = _tiles()
    c = _codec()
    outs = c.encode_finish(c.encode_dispatch_staged(
        c.encode_stage(raws, descs)))
    return b"".join(o.tobytes() for o in outs)


def _photo(w=96, h=64):
    """A w x h tile of the committed 1080p photo: its RGB pixels, Desc
    and stream."""
    data = np.fromfile(CORPUS / "photo_china_1080p.qoi", np.uint8)
    d = oracle.read_header(data)
    px = oracle.decode(data, d, d.channels).reshape(d.height, d.width, 3)
    tile = np.ascontiguousarray(px[400: 400 + h, 800: 800 + w]).reshape(-1)
    td = Desc(w, h, Channels.RGB)
    return tile, td, oracle.encode(tile, td)[0]


def _stream_decode():
    # 4 KiB windows fed 1,000 bytes at a time: torn chunks at the seams
    _, _, blob = _photo()
    out, _ = device_stream.stream_decode(blob, 4096, feed=1000,
                                         device="cpu")
    return out.tobytes()


def _stream_encode():
    raw, desc, _ = _photo()
    return device_stream.stream_encode(raw, desc, 1000, split_lanes=8,
                                       device="cpu")


PATHS = {
    "batch_decode": (_batch_decode, {
        "host.pack_streams", "host.upload", "decode.boundary",
        "decode.fields", "decode.replay", "decode.place", "decode.unpack"}),
    "batch_encode": (_batch_encode, {
        "encode.fields", "encode.compact", "encode.templates",
        "encode.emit"}),
    "serving_decode": (_serving_decode, {
        "host.route", "host.plan", "host.upload", "host.fetch", "host.sync",
        "host.unpack", "decode.boundary", "decode.fields", "decode.replay",
        "decode.place"}),
    "serving_encode": (_serving_encode, {
        "host.route", "host.plan", "host.upload", "host.fetch", "host.sync",
        "host.unpack", "encode.positions", "encode.fields", "encode.compact",
        "encode.templates", "encode.emit"}),
    "stream_decode": (_stream_decode, {
        "host.plan", "host.upload", "host.fetch", "host.sync",
        "decode.window", "decode.fields", "decode.replay", "decode.place"}),
    "stream_encode": (_stream_encode, {
        "host.upload", "stream.carry", "encode.fields", "encode.compact",
        "encode.templates", "encode.emit", "host.fetch"}),
}


def test_off_by_default_records_nothing():
    assert not tracing.enabled()
    assert tracing.span("host.plan") is tracing.span("decode.fields")
    with tracing.span("host.plan"):
        tracing.count("h2d_bytes", 5)
    _batch_decode()
    with tracing.collect() as tr:
        pass
    assert tr.spans == [] and tr.counters == {}
    assert not tracing.enabled()


def test_collect_is_not_reentrant():
    with tracing.collect():
        with pytest.raises(RuntimeError):
            with tracing.collect():
                pass
        assert tracing.enabled()
    assert not tracing.enabled()


def test_nesting_gives_parent_ids_per_thread():
    started, release = threading.Event(), threading.Event()

    def worker():
        with tracing.span("w.outer"):
            started.set()
            release.wait(10)
            with tracing.span("w.inner"):
                pass

    with tracing.collect() as tr:
        with tracing.span("m.outer"):
            t = threading.Thread(target=worker)
            t.start()
            assert started.wait(10)
            with tracing.span("m.inner"):
                release.set()
                t.join(10)
    assert not t.is_alive()
    by = {s.name: s for s in tr.spans}
    assert set(by) == {"m.outer", "m.inner", "w.outer", "w.inner"}
    assert by["m.outer"].parent == -1 and by["w.outer"].parent == -1
    assert by["m.inner"].parent == by["m.outer"].id
    assert by["w.inner"].parent == by["w.outer"].id
    assert by["w.outer"].thread != by["m.outer"].thread
    assert len({s.id for s in tr.spans}) == 4
    for s in tr.spans:
        assert s.start_ns <= s.end_ns


def test_request_stamps_spans_and_counters_on_every_thread():
    def worker():
        with tracing.span("w"):
            tracing.count("n", 2)

    with tracing.collect() as tr:
        with tracing.span("before"):
            tracing.count("n")
        with tracing.request(7):
            with tracing.span("in"):
                tracing.count("n", 3)
            t = threading.Thread(target=worker)
            t.start()
            t.join(10)
            with tracing.request(8):
                tracing.count("n")
            tracing.count("n")
    assert not t.is_alive()
    assert {s.name: s.request for s in tr.spans} == {
        "before": -1, "in": 7, "w": 7}
    assert tr.counters == {(-1, "n"): 1, (7, "n"): 6, (8, "n"): 1}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_path_emits_its_spans_and_same_output(path):
    fn, names = PATHS[path]
    off = fn()
    with tracing.collect() as tr:
        with tracing.request(0):
            on = fn()
    assert on == off
    assert names <= {s.name for s in tr.spans}, (
        names - {s.name for s in tr.spans})
    assert all(s.request == 0 for s in tr.spans)
    ids = {s.id for s in tr.spans}
    assert all(s.parent in ids or s.parent == -1 for s in tr.spans)


def test_batch_counters_equal_what_moves():
    raws, blobs = _batch()
    pipe = BatchPipeline(DESC, device="cpu")
    with tracing.collect() as tr:
        streams, sizes = pipe.pack_streams(blobs)
        pipe.decode(streams, sizes)
        pipe.encode_packed_chunked(
            pipe.raw_to_packed(torch.from_numpy(np.stack(raws))), 2)
    c = {k: v for (_, k), v in tr.counters.items()}
    up = streams.nbytes + sizes.nbytes
    assert c["h2d_bytes"] == up and c["h2d_pageable_bytes"] == up
    assert c["template_rows"] == len(raws) * pipe.chunk_cap
    assert c["fields_rows"] == len(raws) * pipe.nb
    assert "d2h_bytes" not in c and "host_syncs" not in c
    names = [s.name for s in tr.spans]
    # steps, not items: one span each, and one a sub-batch of the encode
    assert names.count("host.pack_streams") == 1
    assert names.count("decode.boundary") == 1
    assert names.count("encode.templates") == 2
    assert names.count("encode.fields") == 2
    assert "encode.positions" not in names


def test_serving_decode_counters_equal_what_it_returns():
    raws, descs, blobs = _tiles()
    c = _codec()
    with tracing.collect() as tr:
        disp = c.decode_dispatch_staged(c.decode_stage(blobs))
        _, packed_parts, split_parts = disp
        outs = c.decode_finish(disp)
    cnt = {k: v for (_, k), v in tr.counters.items()}
    rounds = sum(p[1][3] for p in split_parts)
    assert packed_parts and split_parts and rounds >= 1
    assert cnt["split_rounds"] == rounds
    # exactly the bytes returned cross: no padded slot, no empty lane
    assert cnt["d2h_bytes"] == sum(o.nbytes for o in outs) == sum(
        r.nbytes for r in raws)
    assert cnt["gather_px"] == sum(d.width * d.height for d in descs)
    syncs = sum(s.name in ("host.fetch", "host.sync") for s in tr.spans)
    assert cnt["host_syncs"] == syncs
    assert sum(s.name == "host.fetch" for s in tr.spans) == 1
    assert syncs == 1 + rounds  # one fetch a call, a read a round
    assert sum(s.name == "decode.replay" for s in tr.spans) == (
        rounds + len(packed_parts))


def test_serving_encode_counters_equal_what_it_moves():
    raws, descs, _ = _tiles()
    c = _codec()
    with tracing.collect() as tr:
        outs = c.encode_finish(c.encode_dispatch_staged(
            c.encode_stage(raws, descs)))
    cnt = {k: v for (_, k), v in tr.counters.items()}
    assert cnt["h2d_bytes"] >= sum(r.nbytes for r in raws)
    assert cnt["d2h_bytes"] >= sum(o.nbytes - 14 for o in outs)
    assert cnt["host_syncs"] == sum(
        s.name in ("host.fetch", "host.sync") for s in tr.spans)
    assert cnt["template_rows"] > 0
    assert "packed_recodes" not in cnt


def test_stream_decode_counters_equal_what_it_returns():
    raw, _, blob = _photo()
    dec = device_stream.DeviceStreamDecoder(4096, device="cpu")
    body = blob[14:-8]
    with tracing.collect() as tr:
        dec.initialize(blob[:14]).value()
        parts = [dec.decode_window(body[i: i + 1000]).value()
                 for i in range(0, body.size, 1000)]
    assert np.concatenate(parts).tobytes() == raw.tobytes()
    cnt = {k: v for (_, k), v in tr.counters.items()}
    names = [s.name for s in tr.spans]
    assert cnt["stream_windows"] == len(dec.windows) > 1
    assert cnt["stream_rounds"] == sum(w["rounds"] for w in dec.windows)
    assert cnt["stream_lanes"] == sum(w["lanes"] for w in dec.windows)
    assert cnt["d2h_bytes"] == sum(p.nbytes for p in parts)
    # a plan and an upload a window, a fetch a window that completed a
    # chunk (one that holds only a torn chunk fetches nothing), a flag
    # read a round
    for name in ("host.plan", "host.upload", "decode.window"):
        assert names.count(name) == len(dec.windows), name
    fetches = names.count("host.fetch")
    assert 0 < fetches <= len(dec.windows)
    assert names.count("host.sync") == cnt["stream_rounds"]
    assert cnt["host_syncs"] == fetches + cnt["stream_rounds"]


@pytest.mark.parametrize("lanes", (1, 8))
def test_stream_encode_counters_equal_what_it_moves(lanes):
    raw, desc, blob = _photo()
    enc = device_stream.DeviceStreamEncoder(1000, split_lanes=lanes,
                                            device="cpu")
    step = 4096 * 3  # 4,096 pixels a call: five windows, then three
    with tracing.collect() as tr:
        head = enc.initialize(desc).value()
        parts = [enc.encode_window(raw[i: i + step]).value()
                 for i in range(0, raw.size, step)]
        tail = enc.finalize().value()
    stream = head + b"".join(p.tobytes() for p in parts) + tail
    assert stream == blob.tobytes()
    windows = sum(-(-min(step, raw.size - i) // 3 // 1000)
                  for i in range(0, raw.size, step))
    cnt = {k: v for (_, k), v in tr.counters.items()}
    names = [s.name for s in tr.spans]
    assert cnt["stream_windows"] == windows == 8
    assert cnt["d2h_bytes"] == sum(p.nbytes for p in parts)
    up = windows * enc.nb * 3
    assert cnt["h2d_bytes"] == up and cnt["h2d_pageable_bytes"] == up
    assert cnt["fields_rows"] == windows * enc.nb
    assert cnt["host_syncs"] == names.count("host.fetch") == windows
    for name in ("host.upload", "encode.fields", "encode.templates",
                 "encode.emit"):
        assert names.count(name) == windows, name
    assert names.count("stream.carry") == (windows if lanes > 1 else 0)


@pytest.mark.parametrize("noise,recodes", [(False, 0), (True, 1)])
def test_packed_recodes_counts_a_second_encode(noise, recodes):
    raws, descs, _ = _tiles()
    raws, descs = raws[:4], descs[:4]
    if noise:  # a dense stream past the first byte cap of its lane
        rng = np.random.default_rng(1)
        raws.append(rng.integers(0, 256, 64 * 64 * 3, np.uint8))
        descs.append(Desc(64, 64, Channels.RGB))
    enc = PackedEncoder(lane_px=8192, device="cpu")
    with tracing.collect() as tr:
        outs = enc.encode(raws, descs)
    for raw, d, s in zip(raws, descs, outs):
        assert np.array_equal(s, oracle.encode(raw, d)[0])
    got = {k: v for (_, k), v in tr.counters.items()}
    assert got.get("packed_recodes", 0) == recodes
    assert sum(s.name == "encode.templates" for s in tr.spans) == 1 + recodes
    assert sum(s.name == "host.sync" for s in tr.spans) == 1 + recodes


def test_profiler_ranges_and_chrome_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with tracing.collect(), profile(activities=[ProfilerActivity.CPU]) as p:
        _batch_decode()
    names = {e.name() for e in p.profiler.kineto_results.events()}
    assert {"qoipp:host.pack_streams", "qoipp:decode.boundary"} <= names
    with tracing.collect(), timing.trace(tmp_path):
        _batch_decode()
    events = json.loads((tmp_path / "trace.json").read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    assert "qoipp:decode.place" in {e.get("name") for e in events}
    # off, no range reaches the profiler
    with profile(activities=[ProfilerActivity.CPU]) as p:
        _batch_decode()
    assert not any(e.name().startswith("qoipp:")
                   for e in p.profiler.kineto_results.events())
