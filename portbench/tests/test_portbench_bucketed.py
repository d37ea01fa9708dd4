"""The mixed-density frame store's cells (``frames4k_mixed_decode``,
``batch1080_decode_b16``) at CPU sizes: each runs through the harness on a
small stand-in, correct, and wrong under its control; the batch's photo
positions and frames are the configuration's; a program without
``BucketedCodec.decode_to_device`` fails at build, before any call; a
traced run reads the bucket counters and spans the port writes; and the
bucketed cell's eight per-layer metrics (its own counter reader and the
batch decode's span, trace and roofline readers) read numbers from
made-up records."""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench import generator, harness, mosaic, program
from portbench.program import DeviceOp, ProgramProfile, ProgramRecord
from portbench.roofline import Work
from portbench.spec import HERE, Spec
from portbench.trace import DeviceTrace, Event
from portbench_small import run_cpu, small_spec
from qoipp_tpu_torch.models.scheduler import BucketedCodec
from qoipp_tpu_torch.utils import tracing
from qoipp_tpu_torch.utils.tracing import Span

CELL = "frames4k_mixed_decode"
MS = 1_000_000  # ns


def bucketed_spec(tmp) -> Spec:
    """portbench_small's spec with the frame store cut to 2 x 2 mosaics of
    its 48 x 40 RGB file beside generator frames (96 x 80), 8 frames a
    call (2 photos), one warm-up and one traced call."""
    spec = small_spec(tmp)
    path = spec.home / "configs" / "frames_4k_mixed_rgb.json"
    c = json.loads(path.read_text())
    c.update(dir="corpus", digests="pb/corpus/small.sha256",
             files=["f2.qoi"], width=96, height=80)
    path.write_text(json.dumps(c))
    path = spec.home / "traffic" / "decode_b64_bucketed_resident.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), batch=8,
                                    warmup_calls=1, trace_calls=1)))
    return spec


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return bucketed_spec(tmp_path_factory.mktemp("bucketed"))


@pytest.mark.parametrize("control", (0, 1))
@pytest.mark.parametrize("cell", (CELL, "batch1080_decode_b16"))
def test_cell_runs_on_cpu(spec, cell, control):
    r = run_cpu(spec, cell, seconds=0.2, control=control)
    assert r["correct"] is (not control), r["checks"]
    batch = 8 if cell == CELL else 16  # every frame of a kept call
    assert r["compared"] == min(2, r["attempted"] // batch) * batch >= batch
    wrong = [v["value"] for v in r["checks"].values()]
    assert (max(wrong) > 0) == bool(control)
    assert set(r["metrics"]) == {"decode_mpix_s", "setup_s"}


def _driver(spec, seed=2 ** 31 + 11):
    import torch

    c = spec.cell(CELL)
    drv = spec.driver("bucketed_decode")(
        spec, spec.config(c["config"]), spec.traffic(c["traffic"]), seed,
        torch.device("cpu"))
    drv.prepare()
    return drv


def test_batch_is_the_configurations_mix(spec):
    drv = _driver(spec)
    seed = drv.seed
    want = np.sort(np.random.default_rng([seed, 11]).permutation(8)[:2])
    assert np.array_equal(drv.photos, want)
    config = spec.config("frames_4k_mixed_rgb")
    _, tiles = mosaic.from_config(spec.root, config, seed, 2)
    flat = generator.make_images(6, 96, 80, seed, 3)
    it_t, it_f = iter(tiles), iter(flat)
    for i, raw in enumerate(drv.raws):
        assert np.array_equal(raw, next(it_t) if i in want else next(it_f))
    assert len(drv.blobs) == 8
    # another seed, other positions or other frames
    other = _driver(spec, seed=seed + 1)
    assert not all(np.array_equal(a, b)
                   for a, b in zip(other.raws, drv.raws))


def test_program_without_resident_decode_fails_at_build(spec, monkeypatch):
    monkeypatch.delattr(BucketedCodec, "decode_to_device")
    drv = _driver(spec)
    with pytest.raises(AttributeError, match="decode_to_device"):
        drv.build()


def test_traced_run_reads_the_program(spec, monkeypatch):
    """A traced run on the CPU (made-up device events beside the real host
    profile, as the profiler keeps none here): the cell's counter and span
    metrics read the port's buckets."""
    real = harness.read_profile

    def with_device(prof, calls):
        t = real(prof, calls)
        return t._replace(device=[
            Event(k, t.lo, t.lo + 1e-6) for k in (
                "void replay_kernel<false>(int)", "place_fill_kernel(int)",
                "at::native::elementwise_kernel")])

    monkeypatch.setattr(harness, "read_profile", with_device)
    r = run_cpu(spec, CELL, seconds=0.2, trace=1)
    assert r["correct"] is True
    m = {k: v["value"] for k, v in r["metrics"].items()}
    # every stream of the small store fits the 16 KiB bucket: 8 lanes of
    # qb 16,384 over the streams' bytes
    assert m["bucket_rows_per_byte.frames4k_decode"] > 1
    assert m["host_pack_ms.batch_decode"] > 0
    assert 0 <= m["idle_pct.decode"] < 100
    assert m["torch_passes_ms.decode"] > 0
    assert m["launches_per_call.decode"] > 0
    assert not tracing.enabled()


# -- the cell's metrics on made-up records ------------------------------------

def _span(name, sid, request, start_ms, end_ms):
    return Span(name, sid, -1, request, 1, start_ms * MS, end_ms * MS)


def _record(direction):
    """A harness record of two calls holding every span, counter and
    device event the bucketed cell's metrics read."""
    t = tracing.Trace()
    t.spans = [_span("host.pack_streams", 1, 0, 0, 3),
               _span("host.pack_streams", 2, 0, 3, 4),
               _span("host.pack_streams", 3, 1, 5, 8),
               _span("host.pack_streams", 4, -1, 20, 90)]  # outside a call
    t.counters = {(0, "bucket_rows"): 300, (1, "bucket_rows"): 300,
                  (0, "bucket_stream_bytes"): 200,
                  (1, "bucket_stream_bytes"): 200,
                  (-1, "bucket_rows"): 9999}
    # 0.1 s of boundary kernels over the two traced calls
    prof = ProgramProfile([], [DeviceOp("k", 0.5, 0.6, ("decode.boundary",))],
                          0.0, 2.0, 2, {})
    prec = ProgramRecord(direction, 2, 2000, t, prof)
    dev = [Event("void replay_kernel<false>(int)", 0.1, 0.3),
           Event("void replay_kernel<true>(int)", 0.3, 0.4),
           Event("place_fill_kernel(int)", 0.4, 0.5),
           Event("at::native::vectorized_elementwise_kernel", 0.5, 0.9),
           Event("Memcpy HtoD (Pinned -> Device)", 0.9, 1.0)]
    tr = DeviceTrace(dev, [], 0.0, 2.0, 2)
    # the bounds: K1 10 ms, K2 5 ms a call
    work = {"k1": Work(3.35e12 * 0.01, 0), "k2": Work(3.35e12 * 0.005, 0)}
    return harness.Record(direction, 1.0, 1.0, [], 2, 2000, [], tr, work,
                          "NVIDIA H100 80GB HBM3", prec)


READS = {
    "bucket_rows_per_byte.frames4k_decode": 1.5,  # 600 / 400
    "host_pack_ms.batch_decode": 3.5,  # (3 + 1 + 3) ms / 2 calls
    "torch_passes_ms.decode": 200.0,  # 0.4 s / 2
    "launches_per_call.decode": 0.5,  # one torch pass over 2 calls
    "boundary_device_ms.decode": 50.0,  # 0.1 s / 2
    "k1_roofline": 10.0,  # 10 ms over 100 (not <true>)
    "k2_roofline": 10.0,  # 5 ms over 50
    "idle_pct.decode": 55.0,  # 0.9 of 2 s busy
}


@pytest.mark.parametrize("name", sorted(READS))
def test_bucketed_metric_reads_its_record(name):
    read = Spec().reader(name)
    assert read(_record("decode")) == pytest.approx(READS[name])
    assert read(_record("encode")) is None or name.startswith(
        ("k1_", "k2_"))  # a roofline reads its kernels, whatever the cell
    bare = _record("decode")._replace(program=None, trace=None)
    assert read(bare) is None


def test_every_bucketed_metric_is_tested():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = {m["name"] for m in bench["per_layer"]
            if CELL in m.get("workloads", ())}
    assert cell == set(READS)
    e2e = {m["name"]: m.get("workloads") for m in bench["end_to_end"]}
    assert {CELL, "batch1080_decode_b16"} <= set(e2e["decode_mpix_s"])


def test_program_reader_counts_buckets():
    """``program.counter`` over the calls leaves out what was counted
    outside a request."""
    assert program.counter(_record("decode").program, "bucket_rows") == 600
