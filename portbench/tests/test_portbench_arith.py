"""The benchmark's arithmetic on made-up records: the interval union, the
idle share over the traced window's wall time, the p95 over every call,
host spans, the roofline counts from inputs, the kernel names, the
draws and the breakdown; and the traffic's host threads."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import readers, roofline
from portbench.drivers import Draws
from portbench.harness import Record, _whole
from portbench.spec import Spec
from portbench.trace import (DeviceTrace, Event, Span, breakdown, gaps,
                             is_transfer, port_kernel, union)

SPEC = Spec()
K1 = ("void (anonymous namespace)::replay_kernel<false>(unsigned int "
      "const*, unsigned int const*, long long, int)")
K5 = "void (anonymous namespace)::replay_kernel<true>(unsigned int const*)"
K2 = "place_fill_kernel(int const*, int const*, int*, long long*, int)"
TORCH = ("void at::native::vectorized_elementwise_kernel<4, "
         "at::native::FillFunctor<int>, std::array<char*, 1ul> >(int)")


def _record(direction="decode", trace=None, latencies=(), spans=(),
            work=None, kind="NVIDIA H100 80GB HBM3", pixels=0, window=1.0):
    return Record(direction, 1.5, window, list(latencies), 0,
                  pixels, list(spans), trace, work or {}, kind)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 11)]
    assert union(iv) == pytest.approx(5.0)
    assert gaps(iv, -1, 12) == [(-1, 0), (3, 5), (6, 10), (11, 12)]
    assert union([]) == 0


def test_idle_is_over_the_window_not_the_events():
    """Device busy 2 s of a 10 s window: 80% idle, though the events
    span only 3 s."""
    dev = [Event("k", 4.0, 5.0), Event("Memcpy HtoD (Pageable -> Device)",
                                       6.0, 7.0)]
    tr = DeviceTrace(dev, [Event("call", 0.0, 10.0)], 0.0, 10.0, 5)
    assert tr.busy_s == pytest.approx(2.0)
    assert readers.idle_pct(_record(trace=tr), "decode") == pytest.approx(80)
    assert readers.idle_pct(_record(trace=tr), "encode") is None


def test_p95_over_every_call():
    lat = [0.010] * 90 + [0.100 + 0.001 * i for i in range(10)]
    got = SPEC.reader("call_p95_ms")(_record(latencies=lat))
    assert got == pytest.approx(1e3 * np.percentile(lat, 95))
    assert got > 10.0  # the tail, not a median of medians


def test_mpix_and_span_readers():
    rec = _record(pixels=265_420_800 * 3, window=0.5, spans=[
        Span("decode_stage", 0, 0.0, 0.010),
        Span("decode_stage", 1, 1.0, 1.030),
        Span("decode_stage", -1, 2.0, 2.5)])  # outside the window
    assert SPEC.reader("decode_mpix_s")(rec) == pytest.approx(
        265.4208 * 3 / 0.5)
    assert SPEC.reader("encode_mpix_s")(rec) is None
    assert SPEC.reader("host_stage_ms.serving_decode")(rec) == \
        pytest.approx(20.0)
    assert SPEC.reader("host_finish_ms.serving_decode")(rec) is None


def test_kernel_names():
    assert port_kernel(K1) == "replay_kernel"
    assert port_kernel(K2) == "place_fill_kernel"
    assert port_kernel("place_fill2_kernel(int)") == "place_fill2_kernel"
    assert port_kernel("void emit_window_kernel<256>(int)") == \
        "emit_window_kernel"
    assert port_kernel(TORCH) is None
    assert port_kernel("void at::native::inplace_emit_kernel_x(int)") is None
    assert is_transfer("Memset (Device)") and not is_transfer(K1)


def test_torch_passes_and_launches():
    dev = [Event(K1, 0, 0.002), Event(TORCH, 0.002, 0.003),
           Event(TORCH, 0.003, 0.005), Event("Memcpy DtoH", 0.005, 0.006)]
    tr = DeviceTrace(dev, [], 0, 0.01, 2)
    rec = _record(trace=tr)
    assert SPEC.reader("torch_passes_ms.decode")(rec) == pytest.approx(1.5)
    assert SPEC.reader("launches_per_call.decode")(rec) == 1.0
    assert SPEC.reader("torch_passes_ms.encode")(rec) is None


def test_roofline_counts_from_inputs():
    assert roofline.k1_replay(1000, 2) == (12 * 1000 + 4 * 65 * 2 * 2,
                                           24 * 1000)
    assert roofline.k2_place(1000, 5000) == (8 * 1000 + 4 * 5000,
                                             14 * 5000)
    assert roofline.k3_compact(5000, 1000) == (5000 + 16 * 1000, 3 * 5000)
    assert roofline.k4_emit(1003, 4000) == (12 * 1003 + 4000, 4 * 4000)
    assert roofline.e1_fields(5000) == (12 * 5000, 24 * 5000)


def test_roofline_share_reads_the_named_kernel_only():
    work = {"k1": roofline.Work(3.35e9, 0.0)}  # 1 ms at 3.35 TB/s
    dev = [Event(K1, 0, 0.004), Event(K5, 0.004, 0.104),
           Event(TORCH, 0.104, 0.2)]
    rec = _record(trace=DeviceTrace(dev, [], 0, 1, 2), work=work)
    # 4 ms of K1 over 2 calls: 2 ms a call against a 1 ms bound
    assert SPEC.reader("k1_roofline")(rec) == pytest.approx(50.0)
    assert SPEC.reader("k2_roofline")(rec) is None  # no K2 in the trace
    other = rec._replace(device_kind="NVIDIA A100-SXM4-80GB")
    assert SPEC.reader("k1_roofline")(other) is None  # no peaks: silent
    ops = {"k1": roofline.Work(0.0, 67e9)}  # 1 ms at 67 T/s
    assert SPEC.reader("k1_roofline")(rec._replace(work=ops)) == \
        pytest.approx(50.0)


def test_e1_roofline_reads_both_fields_launches():
    """E1's share counts fields_kernel and its summary launch, and no
    other kernel."""
    work = {"e1": roofline.Work(3.35e9, 0.0)}  # 1 ms at 3.35 TB/s
    e1 = "void fields_kernel(unsigned int const*, int const*, int)"
    summary = "fields_summary_kernel(unsigned int const*, int const*)"
    dev = [Event(e1, 0, 0.003), Event(summary, 0.003, 0.004),
           Event(K1, 0.004, 0.104), Event(TORCH, 0.104, 0.2)]
    rec = _record(direction="encode", trace=DeviceTrace(dev, [], 0, 1, 2),
                  work=work)
    # 4 ms of E1 over 2 calls: 2 ms a call against a 1 ms bound
    assert SPEC.reader("e1_roofline")(rec) == pytest.approx(50.0)
    assert SPEC.reader("e1_roofline")(rec._replace(work={})) is None


def test_draws_are_balanced_dealt_and_seeded():
    """Every run serves the same calls (the deal is the traffic's); the
    seed changes only their order and the order inside each call."""
    big = 2 ** 31 + 99
    d = Draws(big, 16, 16, 0, deal_seed=18)
    calls = [d.next() for _ in range(32)]
    counts = np.bincount(np.concatenate(calls), minlength=16)
    assert (counts == 32).all()
    again = Draws(big, 16, 16, 0, deal_seed=18)
    assert [again.next() for _ in range(3)] == calls[:3]
    other = Draws(big + 1, 16, 16, 0, deal_seed=18)
    others = [other.next() for _ in range(32)]
    assert others[:16] != calls[:16]
    for lo in (0, 16):  # each block holds the same calls, reordered
        assert sorted(map(sorted, others[lo:lo + 16])) == \
            sorted(map(sorted, calls[lo:lo + 16]))
    dealt = Draws(big, 16, 16, 0, deal_seed=19)
    assert sorted(map(sorted, [dealt.next() for _ in range(16)])) != \
        sorted(map(sorted, calls[:16]))


def test_breakdown_names_gaps_by_span():
    dev = [Event(TORCH, 1.0, 2.0), Event(K1, 2.0, 2.5),
           Event(TORCH, 6.0, 6.5)]
    spans = [Event("call", 0.0, 8.0), Event("decode_stage", 0.0, 1.0),
             Event("decode_finish", 2.4, 6.0), Event("next", 6.4, 7.0)]
    b = breakdown(DeviceTrace(dev, spans, 0.0, 8.0, 1))
    assert b["device_ops"][0][0].startswith("at::native::vectorized")
    assert b["device_ops"][0][1] == pytest.approx(1.5)
    assert b["idle_gaps"][0] == ["decode_finish", pytest.approx(3.5)]
    # the gap 6.5-8.0 is mostly the next span's, 0-1 decode_stage's
    assert [g[0] for g in b["idle_gaps"]] == ["decode_finish", "next",
                                              "decode_stage"]


def test_a_trace_missing_a_kernel_is_taken_again():
    """The traced run takes a trace again when CUPTI dropped the events of
    a kernel the traffic names (K2 here), of the torch passes, or a call
    span; not when the trace is whole."""
    kernels = ["replay_kernel", "place_fill_kernel"]
    full = [Event(K1, 0, 0.002), Event(K2, 0.002, 0.003),
            Event(TORCH, 0.003, 0.004)]
    calls = [Event("call", 0.0, 0.005), Event("call", 0.005, 0.01)]
    assert _whole(DeviceTrace(full, calls, 0, 0.01, 2), kernels)
    assert not _whole(DeviceTrace(full[:1] + full[2:], calls, 0, 0.01, 2),
                      kernels)
    assert not _whole(DeviceTrace(full[:2], calls, 0, 0.01, 2), kernels)
    assert not _whole(DeviceTrace(full, calls[:1], 0, 0.01, 2), kernels)
    # a mix that names no kernel wants one of the program's
    assert _whole(DeviceTrace(full[:1] + full[2:], calls, 0, 0.01, 2), [])
    assert not _whole(DeviceTrace(full[2:], calls, 0, 0.01, 2), [])


def test_traced_calls_are_left_out_of_host_metrics(tmp_path, monkeypatch):
    """The calls made under the profiler are slowed by it: a traced run
    traces its calls after the window, and the p95 and the host spans
    read every call of the window and none of the traced ones."""
    import json

    from portbench import harness, program
    from portbench_small import run_cpu, small_spec
    from qoipp_tpu_torch.models.serving import ServingCodec

    spec = small_spec(tmp_path)
    mix = spec.home / "traffic" / "decode_16req_calls.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()),
                                   trace_calls=2)))
    on, stages, read = [], [], []

    class Profiler:
        def start(self):
            on.append(True)

        def stop(self):
            on.clear()

    def read_profile(prof, calls):
        spans = [Event("call", 0.1 * k, 0.1 * k + 0.05) for k in range(calls)]
        dev = [Event(K1, 0.0, 0.01), Event(K2, 0.01, 0.02),
               Event(TORCH, 0.02, 0.03)]
        return DeviceTrace(dev, spans, 0.0, 0.1 * calls, calls)

    stage = ServingCodec.decode_stage

    def counted(self, *a, **k):
        stages.append(bool(on))
        return stage(self, *a, **k)

    reader = spec.reader

    def kept(name):
        f = reader(name)
        return lambda rec: read.append(rec) or f(rec)

    monkeypatch.setattr(harness, "_profiler", Profiler)
    monkeypatch.setattr(harness, "read_profile", read_profile)
    # the made-up profiler keeps no kineto events to tie to the program's
    # spans
    monkeypatch.setattr(program, "read_program_profile",
                        lambda prof, calls: None)
    monkeypatch.setattr(ServingCodec, "decode_stage", counted)
    monkeypatch.setattr(spec, "reader", kept)
    r = run_cpu(spec, "serving_corpus_decode", seconds=1.0, trace=1)
    assert r["correct"] is True and r["device"]["busy_s"] > 0
    assert "call_p95_ms.serving_decode" in r["metrics"]
    # the serving warm-up makes three calls: every file once, then two
    window = stages[3:]
    assert window[-2:] == [True, True] and window.count(True) == 2
    rec = read[-1]
    assert len(rec.latencies) == len(window) - 2
    calls = [s.call for s in rec.spans if s.name == "decode_stage"]
    assert calls == list(range(len(window) - 2))
    # the program's own spans too: every call of the window, no traced one
    assert {s.request for s in rec.program.trace.spans} == set(calls)


def test_traffic_holds_the_host_threads(tmp_path, monkeypatch):
    """A traffic file's ``host_threads`` is torch's thread count from
    set-up through the window, and the count before the run is back
    after it; a traffic file without the key leaves the count alone."""
    import json

    import torch

    from portbench_small import run_cpu, small_spec

    spec = small_spec(tmp_path)
    before = torch.get_num_threads()
    mixes = {"serving_corpus_encode": spec.home / "traffic"
             / "encode_16req_calls.json",
             "serving_corpus_decode": spec.home / "traffic"
             / "decode_16req_calls.json"}
    assert json.loads(mixes["serving_corpus_encode"].read_text())[
        "host_threads"] == 1
    assert "host_threads" not in json.loads(
        mixes["serving_corpus_decode"].read_text())
    for cell, want in (("serving_corpus_encode", 1),
                       ("serving_corpus_decode", before)):
        drv = spec.driver(json.loads(mixes[cell].read_text())["kind"])
        seen, call = [], drv.call

        def counted(self, *a, _call=call, _seen=seen, **k):
            _seen.append(torch.get_num_threads())
            return _call(self, *a, **k)

        monkeypatch.setattr(drv, "call", counted)
        assert run_cpu(spec, cell)["correct"] is True
        assert seen and set(seen) == {want}
        assert torch.get_num_threads() == before
