"""BENCHMARK.json against the rules of its format: keys, names, units,
lengths, bounds, the cells each metric reaches, and the run length that a
full check of 24 cells can hold."""

from __future__ import annotations

import json
import re

import pytest

from portbench.spec import ROOT, Spec

SPEC = Spec()
B = SPEC.bench
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(B["command"]) <= 32 and all(map(_line, B["command"]))
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    # a full check of 24 cells fits the time a check has
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs():
    assert 1 <= len(B["configs"]) <= 24
    files = set()
    used = {w["config"] for w in B["workloads"]}
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in B["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert len({c["source"] for c in B["configs"]}) == len(B["configs"])


def test_workloads():
    assert 1 <= len(B["workloads"]) <= 24
    configs = {c["name"] for c in B["configs"]}
    pairs = set()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, len(B["workloads"]) // 4)


def test_metrics():
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in B["workloads"]}
    assert 1 <= len(B["end_to_end"]) <= 16
    assert 1 <= len(B["per_layer"]) <= 128
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in B["end_to_end"])
    e2e = {m["name"] for m in B["end_to_end"]}
    layers = {}
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        for w in m.get("workloads", ()):
            assert m["moves"] in {x["name"] for x in SPEC.end_to_end(w)}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in SPEC.end_to_end(cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert SPEC.per_layer(cell)


def test_json_is_what_spec_reads():
    assert json.loads((ROOT / "BENCHMARK.json").read_text()) == B
