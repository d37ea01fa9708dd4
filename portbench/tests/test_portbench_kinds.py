"""The four kinds the benchmark had before they moved to ``kinds/``: each,
made by ``drivers.make`` on the small spec with a fixed seed, serves,
produces and checks what the parent's fixed table of kinds did, sound and
as its control; and a kind with no file is refused with its path."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from portbench import drivers
from portbench.harness import Sample
from portbench.trace import Recorder
from portbench_small import small_spec

SEED = 2 ** 31 + 11
CALLS = 3

# digest() of the parent commit's drivers.make (its KINDS table) on this
# small spec, taken once and kept: sound (0) and control (1); every one
# compared 12 outputs of 12 attempted
PARENT = {
    "batch1080_decode": {
        0: dict(checks={"wrong_images": [0, 0], "wrong_bytes": [0, 0]},
                served=[None] * CALLS,
                outputs="086988d948f14fff85256b85151ee356"
                        "87823c026792bb2052763cd794777d8f"),
        1: dict(checks={"wrong_images": [12, 0], "wrong_bytes": [54225, 0]},
                served=[None] * CALLS,
                outputs="2014fd0cdfde3c1224079aae6ab5e6ad"
                        "3ebbb492e1b224ebfa4f7f1874cbea00"),
    },
    "batch1080_encode": {
        0: dict(checks={"wrong_streams": [0, 0], "wrong_bytes": [0, 0]},
                served=[None] * CALLS,
                outputs="0006da4e0465e95bd5e861a3f12ab791"
                        "c6f5b37fe0ecb092bc093a9880d287de"),
        1: dict(checks={"wrong_streams": [12, 0], "wrong_bytes": [35319, 0]},
                served=[None] * CALLS,
                outputs="3f70d572ff10ecc69f7d8914ba6060d9"
                        "bb7e002369ac0b3ed7ad02e77841db8d"),
    },
    "serving_corpus_decode": {
        0: dict(checks={"wrong_requests": [0, 0], "wrong_bytes": [0, 0]},
                served=[[3, 2, 2, 1], [0, 3, 0, 2], [0, 1, 2, 3]],
                outputs="ca240bf214f43c8bd7e561f4bb2b5554"
                        "dd1e83777ce3dfb9d0cabfb88ec0c21d"),
        1: dict(checks={"wrong_requests": [12, 0], "wrong_bytes": [82803, 0]},
                served=[[3, 2, 2, 1], [0, 3, 0, 2], [0, 1, 2, 3]],
                outputs="0d4795344a42097dbae9a1cbd84635dc"
                        "1692f06bbecf4cfbae638a0011087108"),
    },
    "serving_corpus_encode": {
        0: dict(checks={"wrong_requests": [0, 0], "wrong_bytes": [0, 0]},
                served=[[3, 2, 2, 1], [0, 3, 0, 2], [0, 1, 2, 3]],
                outputs="931297659cde6310d09891bae536d364"
                        "f7a095d541a233e4dbe5f5e0480bae40"),
        1: dict(checks={"wrong_requests": [12, 0], "wrong_bytes": [49345, 0]},
                served=[[3, 2, 2, 1], [0, 3, 0, 2], [0, 1, 2, 3]],
                outputs="061847cc15fe0b9b4e124d13d4004227"
                        "88b6d4c12c579c67174184dd1b2a7595"),
    },
}


def _hash(h, x):
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    if isinstance(x, np.ndarray):
        h.update(str((x.dtype.str, x.shape)).encode())
        h.update(np.ascontiguousarray(x).tobytes())
    elif isinstance(x, (list, tuple)):
        h.update(b"[%d" % len(x))
        for a in x:
            _hash(h, a)
    else:
        h.update(repr(x).encode())


def digest(spec, cell: str, control: int) -> dict:
    """``CALLS`` calls of the cell's driver after its warm-up, checked as
    the harness checks them: what they served, a hash of what they
    produced, the numbers compared, how many were compared and
    attempted."""
    c = spec.cell(cell)
    drv = drivers.make(spec, spec.config(c["config"]),
                       spec.traffic(c["traffic"]), SEED,
                       torch.device("cpu"), bool(control))
    rec = Recorder()
    drv.prepare()
    drv.build()
    drv.warmup(rec)
    h, served, attempted, samples = hashlib.sha256(), [], 0, []
    for i in range(CALLS):
        out = drv.call(rec)
        attempted += out.items
        served.append(out.served)
        _hash(h, out.outputs)
        samples.append((i, out.served, out.outputs))
    drv.release()
    check = drv.check([Sample(*s) for s in samples])
    return {"checks": {k: list(v) for k, v in check.numbers.items()},
            "compared": check.compared, "attempted": attempted,
            "served": served, "outputs": h.hexdigest()}


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return small_spec(tmp_path_factory.mktemp("small"))


@pytest.mark.parametrize("control", (0, 1))
@pytest.mark.parametrize("cell", sorted(PARENT))
def test_moved_kind_runs_as_before(spec, cell, control):
    want = dict(PARENT[cell][control], compared=12, attempted=12)
    assert digest(spec, cell, control) == want


def test_missing_kind_names_its_path(spec):
    with pytest.raises(FileNotFoundError, match=r"kinds/no_such_kind\.py"):
        spec.driver("no_such_kind")
