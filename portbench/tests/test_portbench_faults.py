"""Every cell's run on the CPU at a small size (the program's plain
versions in place of its kernels): sound, it is correct; with its control
in the program's place, or with the timed path broken underneath, it is
not.  The faults a codec's cell can have: a call that returns its output
unwritten (the state unchanged), half of the batch left out, one answer
altered where it is produced.  (No cell exchanges between chips.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench_small import run_cpu, small_spec

CELLS = ("batch1080_decode", "batch1080_encode", "serving_corpus_decode",
         "serving_corpus_encode")


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return small_spec(tmp_path_factory.mktemp("small"))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(spec, cell):
    r = run_cpu(spec, cell)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0 and r["compared"] > 0
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(spec, cell):
    r = run_cpu(spec, cell, control=1)
    assert r["correct"] is False
    assert r["checks"]["wrong_bytes"]["value"] > 0


def _unchanged(x):
    """The output as it was before any work: zeros of its shape."""
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    return [np.zeros_like(np.asarray(a)) for a in x]


def _half(x):
    """Half of the batch left out: the second half never written."""
    if isinstance(x, torch.Tensor):
        y = x.clone()
        y[y.shape[0] // 2:] = 0
        return y
    n = len(x)
    return list(x[: n // 2]) + [np.zeros_like(np.asarray(a))
                                for a in x[n // 2:]]


def _altered(x):
    """One byte of one answer altered."""
    if isinstance(x, torch.Tensor):
        y = x.clone()
        y.view(y.shape[0], -1)[-1, 20] ^= 1  # past the header
        return y
    y = [np.array(a, copy=True) for a in x]
    y[-1].reshape(-1)[y[-1].size // 2] ^= 1
    return y


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


def _patch(monkeypatch, cell, fault):
    from qoipp_tpu_torch.models.pipeline import BatchPipeline
    from qoipp_tpu_torch.models.serving import ServingCodec

    if cell == "batch1080_decode":
        orig = BatchPipeline.decode
        monkeypatch.setattr(BatchPipeline, "decode",
                            lambda self, *a, **k: fault(orig(self, *a, **k)))
    elif cell == "batch1080_encode":
        orig = BatchPipeline.encode_packed_chunked

        def enc(self, *a, **k):
            streams, lengths, ok = orig(self, *a, **k)
            return fault(streams), lengths, ok
        monkeypatch.setattr(BatchPipeline, "encode_packed_chunked", enc)
    elif cell == "serving_corpus_decode":
        orig = ServingCodec.decode_finish
        monkeypatch.setattr(ServingCodec, "decode_finish",
                            lambda self, d: fault(orig(self, d)))
    else:
        orig = ServingCodec.encode_finish
        monkeypatch.setattr(ServingCodec, "encode_finish",
                            lambda self, d: fault(orig(self, d)))


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(spec, cell, fault, monkeypatch):
    _patch(monkeypatch, cell, FAULTS[fault])
    r = run_cpu(spec, cell)
    assert r["correct"] is False, (cell, fault, r["checks"])
    assert r["failed"] >= 1
