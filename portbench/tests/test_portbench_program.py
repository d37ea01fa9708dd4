"""``portbench/program.py`` on made-up records and traces, and on the
CPU at a small size: each reader of the program's spans and counters,
device ops tied to the span open at their launch by kineto's correlation
ids, idle gaps named by the program's spans, the ``--trace 0`` run that
never turns the program's tracing on, and a run with it on that reports
each reader's number in its cells."""

from __future__ import annotations

import pytest
import torch
from torch.autograd import DeviceType

from portbench import program
from portbench.program import (OUTSIDE, DeviceOp, ProgramProfile,
                               ProgramRecord, Range)
from portbench_small import run_cpu, small_spec
from qoipp_tpu_torch.utils import tracing
from qoipp_tpu_torch.utils.tracing import Span

CELLS = ("batch1080_decode", "serving_corpus_decode", "batch1080_encode",
         "serving_corpus_encode")
MS = 1_000_000  # ns


def _trace(spans, counters):
    t = tracing.Trace()
    t.spans, t.counters = list(spans), dict(counters)
    return t


def _rec(direction, spans=(), counters=None, calls=2, pixels=1000,
         profile=None):
    return ProgramRecord(direction, calls, pixels,
                         _trace(spans, counters or {}), profile)


def _span(name, sid, parent, request, start_ms, end_ms):
    return Span(name, sid, parent, request, 1, start_ms * MS, end_ms * MS)


def test_host_readers():
    spans = [
        _span("host.pack_streams", 1, -1, 0, 0, 4),
        _span("host.pack_streams", 2, -1, 1, 10, 16),
        _span("host.pack_streams", 3, -1, -1, 20, 99),  # outside a call
        _span("host.unpack", 4, -1, 0, 0, 10),
        _span("host.fetch", 5, 4, 0, 1, 4),  # children: 3 + 2 ms
        _span("host.unpack", 6, 4, 0, 5, 7),
        _span("host.sync", 7, -1, 1, 30, 31),
    ]
    dec = _rec("decode", spans)
    r = program.READERS
    assert r["host_pack_ms.batch_decode"](dec) == pytest.approx(5.0)
    # (10 - 3 - 2) + 2, over two calls
    assert r["host_unpack_ms.serving_decode"](dec) == pytest.approx(3.5)
    assert r["host_wait_ms.serving_decode"](dec) == pytest.approx(2.0)
    assert r["host_wait_ms.serving_encode"](dec) is None
    assert r["host_wait_ms.serving_encode"](
        _rec("encode", spans)) == pytest.approx(2.0)
    assert r["host_pack_ms.batch_decode"](_rec("decode")) is None


def test_counter_readers():
    counters = {(0, "d2h_bytes"): 3000, (1, "d2h_bytes"): 1000,
                (-1, "d2h_bytes"): 99, (0, "split_rounds"): 5,
                (1, "split_rounds"): 2, (0, "template_rows"): 1750}
    dec, enc = _rec("decode", counters=counters), _rec(
        "encode", counters=counters)
    r = program.READERS
    assert r["d2h_bytes_per_px.serving_decode"](dec) == pytest.approx(4.0)
    assert r["split_rounds_per_call.serving_decode"](dec) == 3.5
    assert r["template_rows_per_px.encode"](enc) == pytest.approx(1.75)
    assert r["template_rows_per_px.encode"](dec) is None
    assert r["split_rounds_per_call.serving_decode"](_rec("decode")) is None


def _rows():
    """A made-up kineto trace: one call; the program's ranges and torch
    ops on the torch thread (7); runtime calls on the runtime's id of that
    thread (4242), one launched from Python with no torch op around it;
    the device ops they launched, one whose runtime call the trace lost,
    one with neither; the ranges' own mirrors on the device's timeline.
    Torch ops and runtime calls number their correlation ids apart, so
    they may collide (91)."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    s = 1_000_000_000  # ns: the trace's clock starts anywhere
    us = 1000
    op, rt, ann = "cpu_op", "cuda_runtime", "user_annotation"
    return [
        ("portbench:call", cpu, s, s + 1000 * us, 1, 0, 7, ann),
        ("qoipp:host.pack_streams", cpu, s + 10 * us, s + 300 * us, 2, 0, 7,
         ann),
        ("qoipp:decode.boundary", cpu, s + 300 * us, s + 500 * us, 3, 0, 7,
         ann),
        ("aten::cumsum", cpu, s + 310 * us, s + 320 * us, 4, 0, 7, op),
        ("cudaLaunchKernel", cpu, s + 312 * us, s + 315 * us, 90, 4, 4242,
         rt),
        ("qoipp:decode.replay", cpu, s + 500 * us, s + 600 * us, 5, 0, 7,
         ann),
        ("cuLaunchKernel", cpu, s + 510 * us, s + 512 * us, 91, 0, 4242, rt),
        ("aten::copy_", cpu, s + 700 * us, s + 710 * us, 6, 0, 7, op),
        ("cudaMemcpyAsync", cpu, s + 702 * us, s + 709 * us, 92, 6, 4242,
         rt),
        ("aten::zeros", cpu, s + 950 * us, s + 951 * us, 91, 0, 7, op),
        ("qoipp:decode.boundary", cuda, s + 300 * us, s + 500 * us, 3, 3, 0,
         "gpu_user_annotation"),
        ("scan_kernel", cuda, s + 320 * us, s + 420 * us, 90, 4, 0,
         "kernel"),
        ("replay_kernel(int)", cuda, s + 520 * us, s + 560 * us, 91, 0, 0,
         "kernel"),
        ("Memcpy DtoH (Device -> Pageable)", cuda, s + 720 * us,
         s + 900 * us, 92, 6, 0, "gpu_memcpy"),
        ("lost_launch_kernel", cuda, s + 430 * us, s + 440 * us, 95, 4, 0,
         "kernel"),
        ("orphan_kernel", cuda, s + 950 * us, s + 960 * us, 93, 77, 0,
         "kernel"),
    ]


def test_device_ops_tied_by_correlation_id():
    p = program.tie(_rows(), 1.0, 1.001, 1)
    by = {d.name: d.spans for d in p.device}
    assert by == {"scan_kernel": ("decode.boundary",),
                  "replay_kernel(int)": ("decode.replay",),
                  "Memcpy DtoH (Device -> Pageable)": (),
                  "lost_launch_kernel": ("decode.boundary",),
                  "orphan_kernel": ()}
    assert p.tied == {"runtime": 3, "op": 1, "neither": 1}
    assert [r.name for r in p.ranges] == [
        "host.pack_streams", "decode.boundary", "decode.replay"]
    ops = dict(map(tuple, program.device_ops_by_span(p)))
    assert ops["decode.boundary"] == pytest.approx(110e-6)
    assert ops["decode.replay"] == pytest.approx(40e-6)
    assert ops[OUTSIDE] == pytest.approx(190e-6)
    rec = _rec("decode", profile=p, calls=5)
    assert program.READERS["boundary_device_ms.decode"](
        rec) == pytest.approx(0.11)
    assert program.READERS["templates_device_ms.encode"](
        _rec("encode", profile=p)) is None


def test_open_spans_nest_and_copies_are_not_kernels():
    p = ProgramProfile(
        [Range("host.unpack", 0.0, 1.0, 1), Range("host.fetch", 0.2, 0.4, 1)],
        [DeviceOp("k", 0.0, 0.1, ("host.unpack", "decode.boundary")),
         DeviceOp("Memcpy DtoH", 0.1, 0.3, ("decode.boundary",))],
        0.0, 1.0, 2, {})
    assert program._open_at(p.ranges, [(0.3, 1), (0.5, 1), (0.3, 2)]) == [
        ("host.unpack", "host.fetch"), ("host.unpack",), ()]
    # the copy is not a kernel: 0.1 s of kernels over 2 calls
    assert program.device_ms_in(_rec("decode", profile=p),
                                "decode.boundary") == pytest.approx(50.0)


def test_idle_gaps_named_by_innermost_span():
    ranges = [Range("host.unpack", 0.0, 10.0, 1),
              Range("host.fetch", 1.0, 1.5, 1),
              Range("host.pack_streams", 12.0, 13.0, 1),
              Range("w.plan", 14.0, 17.0, 2),
              Range("w.inner", 14.5, 15.0, 2)]
    dev = [DeviceOp("k", 2.0, 3.0, ()), DeviceOp("k", 11.0, 12.5, ())]
    p = ProgramProfile(ranges, dev, 0.0, 20.0, 1, {})
    # [0, 2): unpack 1.5 s, fetch 0.5; [3, 11): unpack 7, outside 1;
    # [12.5, 20): pack 0.5, w.plan 2.5, w.inner 0.5, outside 4
    named, by = program.idle_gaps_program(p, top=3, least=2.0)
    assert named == [["host.unpack", 8.0], [OUTSIDE, 7.5],
                     ["host.unpack", 2.0]]
    assert by == [["host.unpack", 10.0, 2], [OUTSIDE, 7.5, 1]]
    named, by = program.idle_gaps_program(p, top=1, least=7.6)
    assert named == [["host.unpack", 8.0]]
    assert by == [["host.unpack", 10.0, 1], [OUTSIDE, 7.5, 0]]


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return small_spec(tmp_path_factory.mktemp("small"))


@pytest.mark.parametrize("cell", CELLS)
def test_trace_0_never_turns_program_tracing_on(spec, cell, monkeypatch):
    def refuse():
        raise AssertionError("the program's tracing was turned on")

    monkeypatch.setattr(tracing, "collect", refuse)
    r = run_cpu(spec, cell)
    assert r["correct"] is True
    assert not tracing.enabled()


EXPECTED = {
    "batch1080_decode": {"host_pack_ms.batch_decode"},
    "serving_corpus_decode": {"host_unpack_ms.serving_decode",
                              "host_wait_ms.serving_decode",
                              "d2h_bytes_per_px.serving_decode"},
    "batch1080_encode": {"template_rows_per_px.encode"},
    "serving_corpus_encode": {"host_wait_ms.serving_encode",
                              "template_rows_per_px.encode"},
}


@pytest.mark.parametrize("cell", CELLS)
def test_program_run_reports_its_readers(spec, cell):
    args = program.parse(["--workload", cell, "--seed", str(2 ** 31 + 9),
                          "--seconds", "0.2", "--windows", "1"])
    r = program.run(args, 0.0, spec=spec, device=torch.device("cpu"))
    assert r["correct"] is True, r["checks"]
    # on the CPU no device trace is taken: the device readers and the
    # split route (no stream of the small corpus takes it) read nothing
    assert set(r["metrics"]) == EXPECTED[cell]
    assert all(v > 0 for v in r["metrics"].values())
    assert r["calls"] >= 1 and len(r["mpix_s"]["on"]) == 1
    assert r["span_cost_ns"]["off"] < r["span_cost_ns"]["on"]
    assert not tracing.enabled()


def _both_directions():
    """Made-up records of each direction holding every span, counter and
    device span the program's metrics read."""
    spans = [
        _span("host.pack_streams", 1, -1, 0, 0, 4),
        _span("host.unpack", 2, -1, 0, 0, 10),
        _span("host.fetch", 3, 2, 0, 1, 4),
        _span("host.sync", 4, -1, 1, 30, 31),
    ]
    counters = {(0, "d2h_bytes"): 3000, (1, "split_rounds"): 3,
                (0, "template_rows"): 1750, (1, "fields_rows"): 1000}
    prof = ProgramProfile(
        [], [DeviceOp("k", 0.0, 0.003, ("decode.boundary",)),
             DeviceOp("k", 0.0, 0.005, ("encode.templates",))],
        0.0, 1.0, 2, {})
    return [_rec(d, spans, counters, profile=prof)
            for d in ("decode", "encode")]


def _as_harness_record(prec):
    from portbench.harness import Record

    return Record(prec.direction, 1.0, 1.0, [], 0, prec.pixels, [], None,
                  {}, "cpu", prec)


@pytest.mark.parametrize("name", sorted(program.READERS))
def test_metric_files_read_as_program_readers(name):
    """Each benchmark metric over the program's record reads what
    ``program.READERS`` reads, in the cells of either direction."""
    from portbench.spec import Spec

    read = Spec().reader(name)
    got = [read(_as_harness_record(p)) for p in _both_directions()]
    assert got == [program.READERS[name](p) for p in _both_directions()]
    assert any(v is not None for v in got)
    assert read(_as_harness_record(_both_directions()[0])._replace(
        program=None)) is None


def test_fields_rows_per_px():
    from portbench.spec import Spec

    read = Spec().reader("fields_rows_per_px.encode")
    dec, enc = (_as_harness_record(p) for p in _both_directions())
    assert read(enc) == 1.0 and read(dec) is None


class _Kineto:
    def __init__(self, name, dtype, start, end):
        self._n, self._d, self._s, self._e = name, dtype, start, end

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s


def test_program_ranges_are_not_device_work():
    """The program's spans, mirrored on the device's timeline while a
    profile runs, are neither device ops nor launches."""
    from types import SimpleNamespace

    from portbench.trace import read_profile

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_Kineto("portbench:call", cpu, 0, 1000),
              _Kineto("portbench:call", cuda, 0, 1000),
              _Kineto("qoipp:decode.boundary", cpu, 10, 500),
              _Kineto("qoipp:decode.boundary", cuda, 10, 500),
              _Kineto("scan_kernel", cuda, 20, 40)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    t = read_profile(prof, 1)
    assert [e.name for e in t.device] == ["scan_kernel"]
    assert [e.name for e in t.spans] == ["call"]
