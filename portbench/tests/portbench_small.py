"""A copy of the benchmark's data at CPU-test sizes, for the tests: the
configurations cut to small images and a four-file corpus of the
generator's images, the traffic to small batches and calls.  The files
are copies in a temporary folder, so a test also shows that the harness
finds a configuration, a mix and a metric by name there."""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import torch

from portbench import generator, harness, reference
from portbench.spec import HERE, ROOT, Spec

SMALL_FILES = ((40, 36, 3), (64, 64, 4), (48, 40, 3), (128, 96, 3))


def _edit(path: Path, **kw):
    d = json.loads(path.read_text())
    d.update(kw)
    path.write_text(json.dumps(d))


def small_spec(tmp: Path, bench: dict | None = None) -> Spec:
    home = tmp / "pb"
    shutil.copytree(HERE, home, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    _edit(home / "configs" / "batch_1080p_rgb.json", width=64, height=48)
    _edit(home / "traffic" / "decode_b128_from_host.json", batch=4)
    _edit(home / "traffic" / "encode_b128_resident.json", batch=4, sub=2)
    folder = tmp / "corpus"
    folder.mkdir()
    lines, names = [], []
    for i, (w, h, ch) in enumerate(SMALL_FILES):
        raw = generator.make_images(1, w, h, seed=i, channels=ch)[0]
        s = reference.encode(torch.from_numpy(raw),
                             reference.Header(w, h, ch, 0)).stream.numpy()
        names.append(f"f{i}.qoi")
        (folder / names[-1]).write_bytes(s.tobytes())
        lines.append(f"{hashlib.sha256(s.tobytes()).hexdigest()}  "
                     f"{names[-1]}")
    (home / "corpus" / "small.sha256").write_text("\n".join(lines) + "\n")
    _edit(home / "configs" / "serving_mixed_corpus.json", dir="corpus",
          digests="pb/corpus/small.sha256", files=names)
    for t in ("decode_16req_calls", "encode_16req_calls"):
        _edit(home / "traffic" / f"{t}.json", requests_per_call=4,
              sample_calls=3)
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return Spec(root=tmp, home=home, bench=bench)


def run_cpu(spec: Spec, cell: str, seed: int = 2 ** 31 + 7,
            seconds: float = 0.3, control: int = 0, trace: int = 0) -> dict:
    args = harness.parse(["--workload", cell, "--seed", str(seed),
                          "--seconds", str(seconds), "--control",
                          str(control), "--trace", str(trace)])
    return harness.run(args, 0.0, spec=spec, device=torch.device("cpu"))
