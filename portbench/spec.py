"""What the benchmark runs, found by name: ``BENCHMARK.json`` at the root
of the checkout, and under the benchmark's folder one file for each
configuration (``configs/<name>.json``), traffic mix
(``traffic/<name>.json``), driver kind (``kinds/<kind>.py``, exporting
``DRIVER``) and metric (``metrics/<name>.py``, a reader with
``read(record) -> float | None``).  Nothing here names a cell, a
configuration, a kind or a metric: adding one is adding its files and
entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Spec:
    """BENCHMARK.json and the files it names.  ``root`` is the checkout
    (where BENCHMARK.json and the corpus paths of configurations are
    relative to); ``home`` the folder of configs/, traffic/ and
    metrics/."""

    def __init__(self, root: Path = ROOT, home: Path = HERE,
                 bench: dict | None = None):
        self.root = Path(root)
        self.home = Path(home)
        if bench is None:
            bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = bench
        self._readers: dict = {}
        self._drivers: dict = {}

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return json.loads((self.home / "configs" / f"{name}.json")
                          .read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.home / "traffic" / f"{name}.json")
                          .read_text())

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics the cell reports: those without a
        ``workloads`` key and those that list it."""
        return [m for m in self.bench["end_to_end"]
                if cell in m.get("workloads", (cell,))]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics the cell reports: those that list it, and
        those without a ``workloads`` key whose end-to-end metric it
        reports."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if ("workloads" in m and cell in m["workloads"])
                or ("workloads" not in m and m["moves"] in moved)]

    def _load(self, folder: str, name: str, prefix: str):
        """The module ``<home>/<folder>/<name>.py``, loaded by its path."""
        path = self.home / folder / f"{name}.py"
        mod_name = prefix + "".join(c if c.isalnum() else "_" for c in name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or not path.exists():
            raise FileNotFoundError(f"no {folder[:-1]} file {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str):
        """The metric's ``read`` function, from metrics/<name>.py."""
        if metric not in self._readers:
            self._readers[metric] = self._load(
                "metrics", metric, "portbench_metric_").read
        return self._readers[metric]

    def driver(self, kind: str):
        """The traffic kind's ``DRIVER`` class, from kinds/<kind>.py."""
        if kind not in self._drivers:
            self._drivers[kind] = self._load(
                "kinds", kind, "portbench_kind_").DRIVER
        return self._drivers[kind]
