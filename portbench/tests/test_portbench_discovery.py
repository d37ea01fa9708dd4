"""A configuration, a traffic mix and a metric added as new files, with
their entries, are found and run with no edit to any existing file."""

from __future__ import annotations

import json

from portbench_small import run_cpu, small_spec

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
        assert spec.traffic(w["traffic"])["kind"]
    for m in spec.bench["end_to_end"] + spec.bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
