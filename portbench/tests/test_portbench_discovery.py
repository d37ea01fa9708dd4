"""A configuration, a traffic mix, a driver kind and a metric added as
new files, with their entries, are found and run with no edit to any
existing file."""

from __future__ import annotations

import json

from portbench_small import run_cpu, small_spec

from portbench.drivers import Driver
from portbench.spec import Spec


def test_new_files_are_found_by_name(tmp_path):
    spec = small_spec(tmp_path)
    home = spec.home
    before = {p: p.read_bytes() for p in home.rglob("*") if p.is_file()}
    (home / "configs" / "tiny_rgba.json").write_text(json.dumps(dict(
        kind="synthetic", width=48, height=40, channels=4, colorspace=0)))
    (home / "traffic" / "decode_b2_rgba.json").write_text(json.dumps(dict(
        kind="batch_decode", batch=2, warmup_calls=1, sample_calls=1)))
    (home / "metrics" / "calls_in_window.py").write_text(
        "def read(rec):\n    return float(len(rec.latencies))\n")
    bench = dict(spec.bench)
    bench["configs"] = bench["configs"] + [dict(
        name="tiny_rgba", source="https://qoiformat.org/benchmark/",
        file="pb/configs/tiny_rgba.json", reduced=[], why="a test")]
    bench["workloads"] = bench["workloads"] + [dict(
        name="tiny_rgba.decode", config="tiny_rgba",
        traffic="decode_b2_rgba", chips=1, why="a test")]
    bench["end_to_end"] = [
        dict(m, workloads=m["workloads"] + ["tiny_rgba.decode"])
        if m["name"] == "decode_mpix_s" else m for m in bench["end_to_end"]]
    bench["per_layer"] = bench["per_layer"] + [dict(
        name="calls_in_window", unit="calls", better="higher",
        source="host_clock", layer="entry and router",
        moves="decode_mpix_s", workloads=["tiny_rgba.decode"])]
    spec = Spec(root=spec.root, home=home, bench=bench)

    assert [m["name"] for m in spec.end_to_end("tiny_rgba.decode")] == [
        "decode_mpix_s", "setup_s"]
    assert "calls_in_window" in [m["name"] for m in
                                 spec.per_layer("tiny_rgba.decode")]
    r = run_cpu(spec, "tiny_rgba.decode")
    assert r["correct"] is True
    assert set(r["metrics"]) == {"decode_mpix_s", "setup_s"}
    assert r["checks"]["wrong_images"] == {"value": 0, "limit": 0}
    assert spec.reader("calls_in_window")(_Rec()) == 3.0
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there changed


class _Rec:
    latencies = [0.1, 0.2, 0.3]


def test_every_named_file_exists():
    spec = Spec()
    for c in spec.bench["configs"]:
        assert (spec.root / c["file"]).is_file()
        assert spec.config(c["name"])
    for w in spec.bench["workloads"]:
        kind = spec.traffic(w["traffic"])["kind"]
        assert (spec.home / "kinds" / f"{kind}.py").is_file()
        assert issubclass(spec.driver(kind), Driver)
    for m in spec.bench["end_to_end"] + spec.bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


TOY_KIND = '''"""A toy kind: each call sums a seeded vector inside one
program span and counts its items."""

import numpy as np

from portbench.drivers import Check, Driver, Out


class ToySum(Driver):
    direction = "decode"

    def prepare(self):
        rng = np.random.default_rng([self.seed, 0])
        self.x = rng.integers(0, 100, self.config["items"])

    def build(self):
        from qoipp_tpu_torch.utils import tracing

        self.tracing = tracing

    def call(self, rec):
        with self.tracing.span("toy.sum"):
            total = int(self.x.sum())
        self.tracing.count("toy_items", self.x.size)
        return Out(total, None, 1, int(self.x.size))

    def check(self, samples):
        wrong = sum(s.outputs != int(self.x.sum()) for s in samples)
        return Check({"wrong_sums": (wrong, 0)}, len(samples), wrong)


DRIVER = ToySum
'''

TOY_METRICS = {  # name: (source, reader)
    "toy_items_per_call": ("program_counter", '''from portbench import program


def read(rec):
    p = rec.program
    v = None if p is None else program.counter(p, "toy_items")
    return None if v is None else v / p.calls
'''),
    "toy_sum_ms": ("program_span", '''from portbench import program


def read(rec):
    return None if rec.program is None else program.span_ms(
        rec.program, "toy.sum")
'''),
}


def test_new_kind_is_found_by_name(tmp_path, monkeypatch):
    """A kind of traffic added as new files (its driver, configuration,
    mix and two metrics over the program's spans and counters) runs with
    no edit to any existing file.  On the CPU the profiler keeps no
    device event, so the traced run's device trace gets one made-up event
    beside the real host profile; the program's record is all real."""
    from portbench import harness
    from portbench.trace import Event
    from qoipp_tpu_torch.utils import tracing

    spec = small_spec(tmp_path)
    home = spec.home
    before = {p: p.read_bytes() for p in home.rglob("*") if p.is_file()}
    (home / "kinds" / "toy_sum.py").write_text(TOY_KIND)
    (home / "configs" / "toy_vector.json").write_text(json.dumps(dict(
        items=1000)))
    (home / "traffic" / "toy_calls.json").write_text(json.dumps(dict(
        kind="toy_sum", warmup_calls=1, sample_calls=2, trace_calls=2)))
    for name, (_, src) in TOY_METRICS.items():
        (home / "metrics" / f"{name}.py").write_text(src)
    bench = dict(spec.bench)
    bench["configs"] = bench["configs"] + [dict(
        name="toy_vector", source="https://qoiformat.org/benchmark/",
        file="pb/configs/toy_vector.json", reduced=[], why="a test")]
    bench["workloads"] = bench["workloads"] + [dict(
        name="toy.sum", config="toy_vector", traffic="toy_calls", chips=1,
        why="a test")]
    bench["end_to_end"] = [
        dict(m, workloads=m["workloads"] + ["toy.sum"])
        if m["name"] == "decode_mpix_s" else m for m in bench["end_to_end"]]
    bench["per_layer"] = [dict(
        name=name, unit="x", better="lower", source=source,
        layer="entry and router", moves="decode_mpix_s",
        workloads=["toy.sum"])
        for name, (source, _) in TOY_METRICS.items()]
    spec = Spec(root=spec.root, home=home, bench=bench)

    r = run_cpu(spec, "toy.sum")
    assert r["correct"] is True and r["compared"] == 2
    assert set(r["metrics"]) == {"decode_mpix_s", "setup_s"}

    real = harness.read_profile

    def with_device(prof, calls):
        t = real(prof, calls)
        return t._replace(device=[Event("toy_kernel", t.lo, t.lo + 1e-6)])

    monkeypatch.setattr(harness, "read_profile", with_device)
    r = run_cpu(spec, "toy.sum", trace=1)
    assert r["correct"] is True
    assert r["metrics"]["toy_items_per_call"] == {"value": 1000.0,
                                                  "unit": "x"}
    assert r["metrics"]["toy_sum_ms"]["value"] > 0
    assert {"idle_gaps_program", "idle_by_span",
            "device_ops_by_span"} <= set(r["breakdown"])
    assert not tracing.enabled()
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there changed
