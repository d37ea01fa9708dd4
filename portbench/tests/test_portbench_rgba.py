"""The 1080p RGBA batch cells (``batch1080_rgba_decode``,
``batch1080_rgba_encode``) at CPU sizes: each runs through the harness on
a copy of the data cut to 64 x 48, batch 4 and ``sub`` 2, correct, and
wrong under its control; the configuration's frames carry OP_RGBA chunks;
and the two readers the cells add (``unpack_roofline.decode``,
``pack_roofline.encode``) read their shares from made-up records, and
nothing where a counter, the device time or the card's peaks are
missing."""

from __future__ import annotations

import json

import pytest

from portbench import harness
from portbench.program import DeviceOp, ProgramProfile, ProgramRecord
from portbench.spec import HERE, Spec
from portbench_small import run_cpu, small_spec
from qoipp_tpu_torch.utils import tracing

CELLS = ("batch1080_rgba_decode", "batch1080_rgba_encode")
H100 = "NVIDIA H100 80GB HBM3"
HBM = 3.35e12  # bytes/s, roofline.PEAKS


def _edit(path, **kw):
    path.write_text(json.dumps(dict(json.loads(path.read_text()), **kw)))


def rgba_spec(tmp) -> Spec:
    spec = small_spec(tmp)
    _edit(spec.home / "configs" / "batch_1080p_rgba.json", width=64,
          height=48)
    _edit(spec.home / "traffic" / "decode_b64_rgba_from_host.json", batch=4)
    _edit(spec.home / "traffic" / "encode_b64_rgba_resident.json", batch=4,
          sub=2)
    return spec


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return rgba_spec(tmp_path_factory.mktemp("rgba"))


@pytest.mark.parametrize("control", (0, 1))
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_cpu(spec, cell, control):
    r = run_cpu(spec, cell, seconds=0.2, control=control)
    assert r["correct"] is (not control), r["checks"]
    assert r["compared"] == min(2, r["attempted"] // 4) * 4 >= 4
    wrong = [v["value"] for v in r["checks"].values()]
    assert (max(wrong) > 0) == bool(control)
    rate = "decode_mpix_s" if cell.endswith("decode") else "encode_mpix_s"
    assert set(r["metrics"]) == {rate, "setup_s"}


def test_cells_are_the_configurations(spec):
    """Four channels from the configuration: the decode's target is RGBA
    and every frame holds OP_RGBA chunks."""
    import torch

    c = spec.cell(CELLS[0])
    drv = spec.driver("batch_decode")(
        spec, spec.config(c["config"]), spec.traffic(c["traffic"]),
        2 ** 33 + 5, torch.device("cpu"))
    drv.prepare()
    assert drv.header.channels == 4
    for blob in drv.blobs:
        assert (blob[14:-8] == 0xFF).any()


# -- the readers on made-up records ---------------------------------------------

def _record(direction, counters, ops, kind=H100, calls=2):
    """A harness record of ``calls`` window calls with the program's
    ``counters`` (summed over them) and device ``ops`` (name, seconds,
    spans) over ``calls`` traced calls."""
    t = tracing.Trace()
    t.counters = {(r, k): v // calls for k, v in counters.items()
                  for r in range(calls)}
    t.counters[(-1, "unpack_px")] = 10 ** 12  # outside a call: not read
    dev = [DeviceOp(n, 0.0, s, spans) for n, s, spans in ops]
    prof = ProgramProfile([], dev, 0.0, 1.0, calls, {})
    prec = ProgramRecord(direction, calls, 1000, t, prof)
    return harness.Record(direction, 1.0, 1.0, [], calls, 1000, [], None,
                          {}, kind, prec)


PX = 132_710_400  # 64 x 1920 x 1080, a call
UNPACK = {"unpack_px": 2 * PX, "unpack_bytes": 2 * 4 * PX}
PACK = {"pack_px": 2 * PX, "pack_bytes": 2 * 4 * PX}
# the bound a call: 8 bytes a pixel over HBM; the ops take 4x it in all
BOUND_S = 8 * PX / HBM


def _ops(span):
    return [("elementwise_kernel", 2 * BOUND_S, (span,)),
            ("CatArrayBatchedCopy", 6 * BOUND_S, ("outer", span)),
            ("Memcpy DtoD (Device -> Device)", 5.0, (span,)),
            ("elementwise_kernel", 5.0, ("decode.fields",))]


CASES = {
    "unpack_roofline.decode": ("decode", UNPACK, "decode.unpack"),
    "pack_roofline.encode": ("encode", PACK, "encode.pack"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_reads_its_share(name):
    direction, counters, span = CASES[name]
    read = Spec().reader(name)
    # 8 bound-seconds of kernels over 2 traced calls: 4 a call, 25%;
    # copies and other spans' kernels are not the pass's
    assert read(_record(direction, counters, _ops(span))) == pytest.approx(
        25.0)
    other = "encode" if direction == "decode" else "decode"
    assert read(_record(other, counters, _ops(span))) is None


@pytest.mark.parametrize("missing", ("px", "bytes", "device", "peaks",
                                     "program"))
@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_reads_nothing_without_its_inputs(name, missing):
    """A program without the span or counters (the parent's), a CPU
    record, or a run without tracing read nothing, and raise nothing."""
    direction, counters, span = CASES[name]
    counters = {k: v for k, v in counters.items()
                if not k.endswith("_" + missing)}
    ops = [] if missing == "device" else _ops(span)
    rec = _record(direction, counters, ops,
                  kind="cpu" if missing == "peaks" else H100)
    if missing == "program":
        rec = rec._replace(program=None)
    assert Spec().reader(name)(rec) is None


def test_new_cells_and_metrics_are_declared():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    for cell, traffic in zip(CELLS, ("decode_b64_rgba_from_host",
                                     "encode_b64_rgba_resident")):
        assert cells[cell]["config"] == "batch_1080p_rgba"
        assert cells[cell]["traffic"] == traffic
        assert cells[cell]["chips"] == 1
    layer = {m["name"]: m for m in bench["per_layer"]}
    assert set(layer["unpack_roofline.decode"]["workloads"]) == {
        "batch1080_decode", "batch1080_decode_b16", "frames4k_mixed_decode",
        CELLS[0]}
    assert set(layer["pack_roofline.encode"]["workloads"]) == {
        "batch1080_encode", CELLS[1]}
    for m in ("k1_roofline", "k2_roofline", "unpack_roofline.decode"):
        assert CELLS[0] in layer[m]["workloads"]
    for m in ("k3_roofline", "k4_roofline", "e1_roofline",
              "pack_roofline.encode"):
        assert CELLS[1] in layer[m]["workloads"]
