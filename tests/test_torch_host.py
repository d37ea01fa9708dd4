"""The port's own host layer (common, oracle, utils.corpus) against the JAX
package's: headers, the native split planner and the synthetic corpora
must be byte-equal, so both packages see the same inputs and plans."""

import importlib.util
from pathlib import Path

import qoipp_tpu_torch

import numpy as np
import pytest

import bench
from qoipp_tpu import common as jcommon
from qoipp_tpu import oracle as joracle
from qoipp_tpu_torch import common, oracle
from qoipp_tpu_torch.utils import corpus

ROOT = Path(__file__).resolve().parent.parent


def _jdesc(d):
    return jcommon.Desc(d.width, d.height, jcommon.Channels(int(d.channels)),
                        jcommon.Colorspace(int(d.colorspace)))


def _same_desc(a, b):
    return ((a.width, a.height, int(a.channels), int(a.colorspace))
            == (b.width, b.height, int(b.channels), int(b.colorspace)))


@pytest.mark.parametrize("desc", [
    common.Desc(29, 17, common.Channels.RGB),
    common.Desc(1, 65535, common.Channels.RGBA, common.Colorspace.LINEAR),
    common.Desc(4096, 4096, common.Channels.RGB),
])
def test_header_roundtrip_matches_jax(desc):
    head = common.write_header(desc)
    assert head == jcommon.write_header(_jdesc(desc))
    assert len(head) == common.HEADER_SIZE == jcommon.HEADER_SIZE
    got, want = common.read_header(head + b"\0" * 8), jcommon.read_header(head)
    assert bool(got) and bool(want)
    assert _same_desc(got.value(), want.value())
    assert common.worst_size(desc).value() == jcommon.worst_size(
        _jdesc(desc)).value()
    assert common.END_MARKER == jcommon.END_MARKER


@pytest.mark.parametrize("data", [
    b"", b"qoif", b"xoif" + bytes(10), b"qoif" + bytes(8) + bytes([5, 0]),
    b"qoif" + bytes(8) + bytes([3, 0]),  # zero width
    b"qoif\0\0\0\1\0\0\0\1" + bytes([3, 2]),  # bad colorspace
])
def test_read_header_errors_match_jax(data):
    got, want = common.read_header(data), jcommon.read_header(data)
    assert not got and not want
    assert int(got.error()) == int(want.error())


def _header_path(tmp_path, kind):
    """A path of each kind read_header tells apart."""
    if kind == "missing":
        return tmp_path / "missing.qoi"
    if kind == "directory":
        return tmp_path
    path = tmp_path / f"{kind}.qoi"
    if kind == "short":
        path.write_bytes(b"qoif\0")
    else:
        _, _, blobs = corpus.make_corpus(1, 64, 48, seed=3, channels=4)
        path.write_bytes(blobs[0].tobytes())
    return path


@pytest.mark.parametrize("as_str", [False, True])
@pytest.mark.parametrize("kind", ["missing", "directory", "short", "valid"])
def test_read_header_of_path_matches_jax(tmp_path, kind, as_str):
    path = _header_path(tmp_path, kind)
    arg = str(path) if as_str else path
    got, want = common.read_header(arg), jcommon.read_header(arg)
    assert bool(got) == bool(want) == (kind == "valid")
    if got:
        assert _same_desc(got.value(), want.value())
    else:
        assert int(got.error()) == int(want.error())
        assert got.error().name == {"missing": "FILE_NOT_EXISTS",
                                    "directory": "NOT_REGULAR_FILE",
                                    "short": "IO_ERROR"}[kind]


def test_package_exports_resolve():
    for name in qoipp_tpu_torch.__all__:
        assert getattr(qoipp_tpu_torch, name) is not None
    from qoipp_tpu_torch.ops import device_stream

    assert qoipp_tpu_torch.DeviceStreamDecoder is \
        device_stream.DeviceStreamDecoder
    assert qoipp_tpu_torch.DeviceStreamEncoder is \
        device_stream.DeviceStreamEncoder
    assert qoipp_tpu_torch.read_header is common.read_header
    assert qoipp_tpu_torch.Error is common.Error
    from qoipp_tpu_torch import api, stream
    from qoipp_tpu_torch.models import packed, scheduler, serving

    assert qoipp_tpu_torch.decode is api.decode
    assert qoipp_tpu_torch.StreamDecoder is stream.StreamDecoder
    assert qoipp_tpu_torch.PackedDecoder is packed.PackedDecoder
    assert qoipp_tpu_torch.PackedEncoder is packed.PackedEncoder
    assert qoipp_tpu_torch.BucketedCodec is scheduler.BucketedCodec
    assert qoipp_tpu_torch.ServingCodec is serving.ServingCodec
    assert qoipp_tpu_torch.ResidentCorpus is serving.ResidentCorpus
    # modules and the engines the JAX package's root does not export
    for name in ("api", "stream", "SplitDecoder"):
        assert name not in qoipp_tpu_torch.__all__


def test_error_codes_match_jax():
    assert {e.name: int(e) for e in common.Error} == {
        e.name: int(e) for e in jcommon.Error}


@pytest.mark.parametrize("desc", [
    common.Desc(29, 17, common.Channels.RGB),
    common.Desc(4096, 4096, common.Channels.RGBA, common.Colorspace.LINEAR),
    common.Desc(0, 17, common.Channels.RGB),
    common.Desc(1 << 40, 1 << 40, common.Channels.RGBA),
])
def test_count_bytes_matches_jax(desc):
    got, want = common.count_bytes(desc), jcommon.count_bytes(_jdesc(desc))
    assert bool(got) == bool(want)
    if got:
        assert got.value() == want.value()
    else:
        assert int(got.error()) == int(want.error())


@pytest.mark.parametrize("desc", [
    common.Desc(1 << 31, 1 << 31, common.Channels.RGBA),
    common.Desc((1 << 32) - 1, (1 << 32) - 1, common.Channels.RGB),
    common.Desc((1 << 32) - 1, (1 << 32) - 1, common.Channels.RGBA),
    common.Desc(17, 0, common.Channels.RGBA),
    common.Desc(29, 17, common.Channels.RGB),
    common.Desc(1, 65535, common.Channels.RGBA, common.Colorspace.LINEAR),
])
def test_worst_size_matches_jax(desc):
    # through count_bytes' size_t checks first, as the JAX package does
    got, want = common.worst_size(desc), jcommon.worst_size(_jdesc(desc))
    assert bool(got) == bool(want)
    if got:
        assert got.value() == want.value()
    else:
        assert int(got.error()) == int(want.error())


def test_result_constructors():
    ok = common.Result.ok(b"qoif")
    assert ok and ok.value() == b"qoif"
    err = common.Result.err(common.Error.NOT_INITIALIZED)
    assert not err and err.error() == common.Error.NOT_INITIALIZED
    with pytest.raises(ValueError):
        err.value()


@pytest.mark.parametrize("n_segments,lookahead,prefer_rgba", [
    (1, 0, False), (7, 0, False), (16, 64, False), (16, 64, True)])
def test_split_points_match_jax(n_segments, lookahead, prefer_rgba):
    desc, _, blobs = corpus.make_corpus(1, 96, 64, seed=2,
                                        channels=4 if prefer_rgba else 3)
    body = blobs[0][14:-8]
    n_px = desc.width * desc.height
    args = (body, n_px, n_segments, 50.0, 1.5)
    kw = dict(lookahead=lookahead, prefer_rgba=prefer_rgba, chunk_w=0.25)
    for got, want in zip(oracle.split_points(*args, **kw),
                         joracle.split_points(*args, **kw)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("channels,seed", [(3, 0), (4, 7)])
def test_make_corpus_matches_bench(channels, seed):
    desc, raws, blobs = corpus.make_corpus(2, 80, 48, seed=seed,
                                           channels=channels)
    jdesc, jraws, jblobs = bench.make_corpus(2, 80, 48, seed=seed,
                                             channels=channels)
    assert _same_desc(desc, jdesc)
    for a, b in zip(raws + blobs, jraws + jblobs):
        assert np.array_equal(a, b)
    for raw, blob in zip(raws, blobs):  # the port's oracle, both ways
        assert np.array_equal(oracle.decode(blob, desc, desc.channels), raw)
        assert np.array_equal(oracle.encode(raw, desc)[0], blob)


def test_make_image_matches_device_stream_bench():
    spec = importlib.util.spec_from_file_location(
        "device_stream_bench", ROOT / "benchmarks" / "device_stream_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert np.array_equal(corpus.make_image(160, 120, seed=3),
                          mod.make_image(160, 120, seed=3))


def test_pack_files_matches_jax(tmp_path):
    _, _, blobs = corpus.make_corpus(3, 64, 48, seed=5)
    paths = []
    for i, blob in enumerate(blobs):
        paths.append(tmp_path / f"{i}.qoi")
        paths[-1].write_bytes(blob.tobytes())
    got, want = oracle.pack_files(paths, 8192), joracle.pack_files(paths, 8192)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_oracle_builds_its_own_library():
    assert oracle.build() == oracle.LIB_PATH
    assert oracle.LIB_PATH.parent.name == "qoipp_tpu_torch"
    assert oracle.LIB_PATH.parent.parent.name == "build"


def test_pyproject_lists_every_subpackage_of_the_port():
    """A non-editable install ships only the packages pyproject.toml
    names: every directory of the port with an __init__.py is one."""
    import tomllib

    listed = set(tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "tool"]["setuptools"]["packages"])
    pkg = ROOT / "qoipp_tpu_torch"
    found = {".".join(d.relative_to(ROOT).parts)
             for d in [pkg, *pkg.rglob("*")]
             if d.is_dir() and (d / "__init__.py").exists()}
    assert "qoipp_tpu_torch.parallel" in found
    assert found <= listed, sorted(found - listed)
