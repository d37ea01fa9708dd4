"""The port's tools, examples, timing helpers and scatter encoders on the
CPU: the scatter encoders against the JAX package's whole outputs; each
fuzz target at two rounds (--cpu); gen -> conv -> swap against the JAX
tools' files for the same arguments; bench's table and one-shot sweep;
both examples at a small size; utils.timing as test_utils.py's
test_timing_helpers holds the JAX package's; and every tool refusing
the card where there is none."""

import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoipp_tpu.ops import bitops as jbit
from qoipp_tpu.ops import encode as jenc
from qoipp_tpu_torch import Channels, Desc, kernels, oracle, write_header
from qoipp_tpu_torch.convert import words_to_torch
from qoipp_tpu_torch.ops import encode
from qoipp_tpu_torch.tools import bench, fuzz
from qoipp_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parent.parent


def _jax_tool(name):
    """The repository's tools/<name>.py, loaded by path under a name of
    its own (tools/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scatter_inputs(channels, b, seed):
    """b images of 37 x 29 pixels (noise, a 4-level palette, runs of 70)
    packed to the encoder's tile width, with their header."""
    rng = np.random.default_rng(seed)
    w, h = 37, 29
    n = w * h
    raws = []
    for i in range(b):
        if i % 3 == 0:
            raw = rng.integers(0, 256, n * channels, dtype=np.uint8)
        elif i % 3 == 1:
            raw = (rng.integers(0, 4, n * channels) * 40).astype(np.uint8)
        else:
            raw = np.repeat(rng.integers(0, 256, n * channels // 70 + 1,
                                         dtype=np.uint8), 70)[: n * channels]
        raws.append(raw)
    px = np.zeros((b, encode.pad_to_tile(n), channels), np.uint8)
    px[:, :n] = np.stack(raws).reshape(b, n, channels)
    packed = np.stack([np.asarray(jbit.pixels_to_packed(
        jnp.asarray(p.reshape(-1)), channels)) for p in px])
    desc = Desc(w, h, Channels(channels))
    header = np.frombuffer(write_header(desc), np.uint8).copy()
    return desc, raws, packed, header


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("channels", [3, 4])
def test_encode_scatter_matches_jax(channels, b):
    desc, raws, packed, header = _scatter_inputs(channels, b, 10 * b + channels)
    n_px = desc.width * desc.height
    jout, jlen = jenc.encode_batch_scatter(jnp.asarray(packed), n_px,
                                           jnp.asarray(header), channels)
    out, lens = encode.encode_batch_scatter(
        words_to_torch(packed, device="cpu"), n_px, torch.from_numpy(header),
        channels)
    assert out.dtype == torch.uint8 and lens.dtype == torch.int32
    assert np.array_equal(out.numpy(), np.asarray(jout))
    assert np.array_equal(lens.numpy(), np.asarray(jlen))
    for i, raw in enumerate(raws):
        want, _ = oracle.encode(raw, desc)
        assert np.array_equal(out[i, : lens[i]].numpy(), want)

    jout1, jlen1 = jenc.encode_core_scatter(jnp.asarray(packed[-1]), n_px,
                                            jnp.asarray(header), channels)
    out1, len1 = encode.encode_core_scatter(
        words_to_torch(packed[-1], device="cpu"), n_px,
        torch.from_numpy(header), channels)
    assert np.array_equal(out1.numpy(), np.asarray(jout1))
    assert int(len1) == int(jlen1)


@pytest.mark.parametrize("channels", [3, 4])
def test_encode_batch_and_core(channels):
    """encode_batch and encode_core are encode_batch_checked (held against
    the JAX package's elsewhere) at B and at B = 1, without the flags."""
    desc, raws, packed, header = _scatter_inputs(channels, 3, 7 + channels)
    n_px = desc.width * desc.height
    tp, th = words_to_torch(packed, device="cpu"), torch.from_numpy(header)
    want, want_len, ok = encode.encode_batch_checked(tp, n_px, th, channels)
    assert bool(ok.all())
    out, lens = encode.encode_batch(tp, n_px, th, channels)
    assert torch.equal(out, want) and torch.equal(lens, want_len)
    out1, len1 = encode.encode_core(tp[1], n_px, th, channels)
    assert torch.equal(out1, want[1]) and int(len1) == int(want_len[1])
    assert np.array_equal(out1[: int(len1)].numpy(),
                          oracle.encode(raws[1], desc)[0])


@pytest.mark.parametrize("target", sorted(fuzz.FUZZERS))
def test_fuzz_target(target, capsys):
    assert fuzz.main(["-n", "2", "--only", target, "--cpu"]) == 0
    assert "fuzz OK: 2 iterations x 1 targets on cpu" in capsys.readouterr().out


def test_fuzz_reports_seed_and_iteration(monkeypatch):
    def diverge(rng, device):
        fuzz.expect(rng.random() > 2, "made up")

    monkeypatch.setitem(fuzz.FUZZERS, "stream", diverge)
    with pytest.raises(fuzz.Divergence,
                       match=r"stream \(seed 5, iteration 0\): made up"):
        fuzz.run(1, 5, only="stream", device="cpu")


@pytest.mark.parametrize("backend", ["native", "torch"])
def test_gen_conv_swap_match_jax_tools(tmp_path, backend):
    """gen -> conv (QOI to PNG, PNG to QOI) -> swap, each through the
    port's tool and the JAX package's with the same arguments: the same
    files (PNGs compared by their pixels)."""
    pytest.importorskip("PIL")
    from PIL import Image

    port = {n: importlib.import_module(f"qoipp_tpu_torch.tools.{n}")
            for n in ("gen", "conv", "swap")}
    ref = {n: _jax_tool(n) for n in ("gen", "conv", "swap")}
    dev = ["--backend", backend] + (["--cpu"] if backend == "torch" else [])
    for side, tools, extra in (("port", port, dev),
                               ("jax", ref, ["--backend", "native"])):
        d = tmp_path / side
        d.mkdir()
        assert tools["gen"].main([str(d / "a.qoi"), "-W", "40", "-H", "30",
                                  "-C", "4", "-s", "3", *extra]) == 0
        assert tools["conv"].main([str(d / "a.qoi"), str(d / "a.png"),
                                   *extra]) == 0
        assert tools["conv"].main([str(d / "a.png"), str(d / "b.qoi"),
                                   "--rgb-only", *extra]) == 0
        assert tools["swap"].main([str(d / "b.qoi"), "-n", "2", "-o",
                                   str(d / "c.qoi"), *extra]) == 0
    for name in ("a.qoi", "b.qoi", "c.qoi"):
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name
    assert np.array_equal(np.asarray(Image.open(tmp_path / "port" / "a.png")),
                          np.asarray(Image.open(tmp_path / "jax" / "a.png")))
    c = (tmp_path / "port" / "c.qoi").read_bytes()
    desc = Desc(40, 30, Channels.RGB)
    b = oracle.decode((tmp_path / "port" / "b.qoi").read_bytes(), desc,
                      Channels.RGB).reshape(-1, 3)
    assert np.array_equal(oracle.decode(c, desc, Channels.RGB).reshape(-1, 3),
                          b[:, [1, 2, 0]])


def test_bench_prints_a_total_for_every_codec(capsys):
    assert bench.main(["--synthetic", "2", "--width", "64", "--height", "48",
                       "--cpu", "--runs", "1"]) == 0
    out = capsys.readouterr().out
    assert "3x3 enc/dec cross matrix bit-exact" in out
    codecs = {line.split()[1] for line in out.splitlines()
              if line.split()[:1] == ["TOTAL"]}
    want = {"native", "torch", "stream", "torch-batch", "serving"}
    if importlib.util.find_spec("PIL"):
        want.add("png")
    assert codecs == want


def test_bench_oneshot_sweep(capsys):
    assert bench.main(["--sizes", "64x48,80x64", "--cpu"]) == 0
    out = capsys.readouterr().out
    for size in ("64x48", "80x64"):
        rows = [line.split()[1] for line in out.splitlines()
                if line.split()[:1] == [size]]
        assert rows == ["native", "torch"]
        assert f"{size}: torch/native warm" in out


def test_ingest_example(capsys):
    from qoipp_tpu_torch.examples import ingest_pipeline

    assert ingest_pipeline.main(["--batch", "2", "--size", "64", "--runs",
                                 "1", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "2 x 64x64 equal to the oracle" in out
    assert "host clock on the cpu" in out and "(2, 128)" in out


def test_ingest_model_matches_its_definition():
    """ToyTrunk is the JAX example's toy_model_apply: 8x8 patches, two
    matmuls with a ReLU between, mean over the patches (fp32 here)."""
    from qoipp_tpu_torch.examples.ingest_pipeline import ToyTrunk

    model = ToyTrunk(seed=1, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (2, 16, 24, 3)).astype(np.float32))
    p = x.reshape(2, 2, 8, 3, 8, 3).permute(0, 1, 3, 2, 4, 5).reshape(
        2, 6, 192)
    w1, w2 = model.fc1.weight.detach().T, model.fc2.weight.detach().T
    want = (torch.relu(p @ w1) @ w2).mean(dim=1)
    with torch.no_grad():
        assert torch.allclose(model(x), want, atol=1e-6)
    assert 0.015 < float(w1.std()) < 0.025 and 0.015 < float(w2.std()) < 0.025


def test_serving_example(capsys):
    from qoipp_tpu_torch.examples import serving_codec

    assert serving_codec.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert "routing: 8 packed, 16 bucketed on cpu" in out
    assert "parity vs oracle: 100%" in out
    assert "resident-corpus parity (2 requests): 100%" in out


def test_serving_example_corpus_matches_jax():
    ref = importlib.util.spec_from_file_location(
        "jax_example_serving_codec", ROOT / "examples" / "serving_codec.py")
    mod = importlib.util.module_from_spec(ref)
    ref.loader.exec_module(mod)
    from qoipp_tpu_torch.examples import serving_codec

    for (r, d, e), (jr, jd, je) in zip(serving_codec.make_corpus(),
                                       mod.make_corpus()):
        assert (d.width, d.height, int(d.channels)) == (
            jd.width, jd.height, int(jd.channels))
        assert np.array_equal(r, jr) and np.array_equal(e, je)


def test_timing_helpers():
    assert timing.mpix_per_s(1_000_000, 1.0) == pytest.approx(1000.0)
    assert timing.mpix_per_s(5, 0) == float("inf")
    assert timing.time_ms(lambda: None, runs=2, warmup=0) >= 0
    calls = []
    assert timing.time_ms(lambda: calls.append(1), runs=3, warmup=2) >= 0
    assert len(calls) == 5


def test_device_time_refuses_the_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        timing.device_time_ms(lambda: None)


def test_trace_writes_a_chrome_trace(tmp_path):
    with timing.trace(tmp_path / "t") as out:
        torch.arange(1000).cumsum(0)
    assert out == tmp_path / "t"
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


@pytest.mark.parametrize("tool,argv", [
    ("tools.fuzz", ["-n", "1"]),
    ("tools.bench", ["--synthetic", "1", "--width", "64", "--height", "48"]),
    ("tools.bench", ["--sizes", "64x48"]),
    ("tools.gen", ["{tmp}/a.qoi", "-W", "8", "-H", "8", "--backend",
                   "torch"]),
    ("examples.ingest_pipeline", ["--batch", "1", "--size", "64"]),
    ("examples.serving_codec", []),
])
def test_tools_refuse_cuda_without_card(tmp_path, monkeypatch, tool, argv):
    """Asked for the card (their default) where torch sees none, the tools
    raise; they never go on with the plain versions."""
    mod = importlib.import_module(f"qoipp_tpu_torch.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = kernels.launch_counts()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([a.format(tmp=tmp_path) for a in argv])
    assert kernels.launch_counts() == before



def test_chip_smoke_samples_tools_calls():
    """chip_smoke's tools phase holds a bounded sample of each path's
    kernel calls: the first, the largest, the first at the last shape and
    every K6 call, each on copies of its arguments; only calls that
    launched count, and the wrappers are restored after.  Run in a child:
    chip_smoke blocks the JAX package on import."""
    code = """
import torch
import chip_smoke as cs
from qoipp_tpu_torch import kernels
from qoipp_tpu_torch.ops import compact_kernel, replay_kernel

class Ticking(dict):  # every wrapper call reads as a launch on the CPU
    n = 0
    def __getitem__(self, k):
        Ticking.n += 1
        return Ticking.n

kernels.LAUNCHES = Ticking(kernels.LAUNCHES)
wrappers = (compact_kernel.compact_rows, replay_kernel.logfill_batch)
g = torch.Generator().manual_seed(0)
with cs._sampled(((compact_kernel, ("compact_rows",)),
                  (replay_kernel, ("logfill_batch",)))) as (kept, n):
    for w in (64, 256, 128, 128, 128):
        plane = torch.randint(0, 99, (2, w), generator=g, dtype=torch.int32)
        keep = plane % 3 == 0
        compact_kernel.compact_rows((plane,), keep, cap=w)
        plane.zero_()  # the path reuses its buffer: the copy stays
    for _ in range(3):
        replay_kernel.logfill_batch(torch.zeros((1, 70), dtype=torch.int32))
assert (compact_kernel.compact_rows, replay_kernel.logfill_batch) == wrappers
assert n == {"compact": 5, "logfill": 3}, n
tags = {k: {i: t for i, (t, _) in v.items()} for k, v in kept.items()}
assert tags["compact"] == {1: ["first"], 2: ["largest"],
                           3: ["last shape"]}, tags
assert tags["logfill"] == {1: ["first", "largest", "last shape", "every"],
                           2: ["every"], 3: ["every"]}, tags
assert bool(kept["compact"][2][1][1][0][0].any())
held = {}
assert cs._hold_sampled(held, kept, n, "t") == {"compact": 3, "logfill": 3}
assert [h["max_abs_err"] for v in held.values() for h in v] == [0] * 6
assert held["compact"][1]["what"] == (
    "t, call 2 of 5 (largest): compact_rows((2x256), 2x256, cap=256)"), held
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
