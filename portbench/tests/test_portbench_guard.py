"""The import check, by whole top-level module name, on the names, on a
fresh process that loads the harness and the program's entry points, and
on the sources of the benchmark."""

from __future__ import annotations

import ast
import subprocess
import sys

from portbench import guard
from portbench.spec import HERE, ROOT


def test_forbidden_by_whole_top_level_name():
    names = ["qoipp_tpu_torch", "qoipp_tpu_torch.models.serving",
             "qoipp_tpu_torch.benchmarks.stages", "benchmarks_extra",
             "jaxtyping", "bencher", "numpy"]
    assert guard.forbidden_modules(names) == []
    assert guard.forbidden_modules(names + ["qoipp_tpu.ops", "jaxlib.xla",
                                            "bench", "benchmarks.stages",
                                            "flax"]) == [
        "bench", "benchmarks", "flax", "jaxlib", "qoipp_tpu"]


def test_harness_and_program_load_nothing_forbidden():
    code = ("import sys, portbench.harness, portbench.drivers, "
            "portbench.run;"
            "import qoipp_tpu_torch.models.pipeline, "
            "qoipp_tpu_torch.models.serving;"
            "from portbench import guard; "
            "from portbench.spec import Spec; s = Spec();"
            "[s.reader(m['name']) for m in s.bench['end_to_end'] "
            "+ s.bench['per_layer']];"
            "print(','.join(guard.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_nothing_forbidden():
    files = [p for p in HERE.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        assert guard.forbidden_modules(list(_imports(p))) == [], p


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "generator.py", "roofline.py",
                 "corpus.py"):
        tops = {guard.top_level(m) for m in _imports(HERE / name)}
        assert "qoipp_tpu_torch" not in tops, name
        assert tops <= {"__future__", "hashlib", "os", "pathlib", "struct",
                        "typing", "numpy", "torch"}, (name, tops)


def test_run_without_card_prints_no_result():
    """Here, with no CUDA device, a run exits non-zero and prints no
    result line."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: test_portbench_card.py runs there")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "batch1080_decode", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
