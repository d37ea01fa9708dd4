"""On the card (``-m cuda``; skipped without one): each cell's run at the
small sizes of portbench_small through the program's CUDA kernels is
correct, its control is not, and a traced run reads the device."""

from __future__ import annotations

import pytest

from portbench import harness
from portbench_small import small_spec

CELLS = ("batch1080_decode", "batch1080_encode", "serving_corpus_decode",
         "serving_corpus_encode")


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return small_spec(tmp_path_factory.mktemp("small"))


def _run(spec, card, cell, trace=0, control=0):
    args = harness.parse(["--workload", cell, "--seed", str(2 ** 31 + 3),
                          "--seconds", "0.5", "--trace", str(trace),
                          "--control", str(control)])
    return harness.run(args, 0.0, spec=spec, device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(spec, card, cell):
    r = _run(spec, card, cell)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["memory_peak_bytes"] > 0
    assert _run(spec, card, cell, control=1)["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_cell_on_card(spec, card, cell):
    r = _run(spec, card, cell, trace=1)
    assert r["correct"] is True
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["breakdown"]["device_ops"]
    idle = [v["value"] for k, v in r["metrics"].items()
            if k.startswith("idle_pct")]
    assert idle and 0 <= idle[0] < 100
