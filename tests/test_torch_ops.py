"""The port's host passes (no kernel) against the JAX package, bit-exact:
bitops, the boundary pass, the dense field pass, the encoder's same-hash
predecessor, the carry conversion, and the port's freedom from JAX."""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoipp_tpu.ops import bitops as jbit
from qoipp_tpu.ops import boundary as jbnd
from qoipp_tpu.ops import decode as jdec
from qoipp_tpu.ops import encode as jenc
from qoipp_tpu_torch import convert
from qoipp_tpu_torch.convert import words_to_numpy
from qoipp_tpu_torch.ops import bitops, boundary, decode, encode

torch.set_num_threads(1)

def words_to_torch(words):
    return convert.words_to_torch(words, device="cpu")
ROOT = Path(__file__).resolve().parent.parent


def _words(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _np(x):
    return np.asarray(x)


def test_bitops_words():
    rng = np.random.default_rng(0)
    x, y = _words(rng, 4096), _words(rng, 4096)
    tx, ty = words_to_torch(x), words_to_torch(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    assert np.array_equal(_np(jbit.hash6(jx)), bitops.hash6(tx).numpy())
    assert np.array_equal(_np(jbit.swar_add_bytes(jx, jy)),
                          words_to_numpy(bitops.swar_add_bytes(tx, ty)))
    for c in range(4):
        assert np.array_equal(_np(jbit.unpack_channel(jx, c)),
                              bitops.unpack_channel(tx, c).numpy())
    assert np.array_equal(_np(jbit.to_int8(jx)), bitops.to_int8(tx).numpy())
    assert int(np.uint32(jbit.START_PIXEL_PACKED)) == int(
        words_to_numpy(torch.tensor([bitops.START_PIXEL_PACKED]))[0])


@pytest.mark.parametrize("channels", [3, 4])
def test_pixels_packed_roundtrip(channels):
    rng = np.random.default_rng(channels)
    raw = rng.integers(0, 256, 300 * channels, dtype=np.uint8)
    want = _np(jbit.pixels_to_packed(jnp.asarray(raw), channels))
    got = bitops.pixels_to_packed(torch.from_numpy(raw), channels)
    assert np.array_equal(want, words_to_numpy(got))
    back = bitops.packed_to_pixels(got, channels).numpy()
    assert np.array_equal(back, _np(jbit.packed_to_pixels(jnp.asarray(want),
                                                          channels)))
    assert np.array_equal(back, raw)


def _regions(seed, b, qb):
    """Adversarial chunk regions: uniform noise, tag-heavy bytes (RGB/RGBA
    tags, RUN and LUMA bytes) and long zero tails."""
    rng = np.random.default_rng(seed)
    reg = rng.integers(0, 256, (b, qb + 8), dtype=np.uint8)
    tags = np.array([0xFE, 0xFF, 0xC0, 0xFD, 0x80, 0xBF, 0x00, 0x40],
                    np.uint8)
    heavy = rng.random((b, qb + 8)) < 0.5
    reg[heavy] = tags[rng.integers(0, tags.size, heavy.sum())]
    reg[0, qb // 2 :] = 0  # zero tail: INDEX-0 chunks while pixels are owed
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_analyze_region_batch(seed):
    b, qb = 4, 1024
    reg = _regions(seed, b, qb)
    rng = np.random.default_rng(100 + seed)
    sizes = rng.integers(-8, qb, b).astype(np.int32)
    n_px = int(rng.integers(1, 4 * qb))
    want = jbnd.analyze_region_batch(jnp.asarray(reg[:, :qb]),
                                     jnp.asarray(sizes), jnp.int32(n_px))
    got = boundary.analyze_region_batch(torch.from_numpy(reg[:, :qb].copy()),
                                        torch.from_numpy(sizes), n_px)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(_np(want[k]), got[k].numpy()), k


def test_chunk_starts_single_block_and_many():
    for qb in (boundary.BLOCK, 64 * boundary.BLOCK):
        reg = _regions(7, 2, qb)[:, :qb]
        want = jbnd.chunk_starts_batch(jnp.asarray(reg))
        got = boundary.chunk_starts_batch(torch.from_numpy(reg.copy()))
        assert np.array_equal(_np(want), got.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_fields_dense_batch(seed):
    b, qb = 3, 512
    reg = _regions(seed, b, qb)
    real = np.random.default_rng(seed).random((b, qb)) < 0.6
    jm, jv = jdec.fields_dense_batch(jnp.asarray(reg), jnp.asarray(real))
    tm, tv = decode.fields_dense_batch(torch.from_numpy(reg),
                                       torch.from_numpy(real))
    assert np.array_equal(_np(jm), words_to_numpy(tm))
    assert np.array_equal(_np(jv), words_to_numpy(tv))


@pytest.mark.parametrize("density", [0.0, 0.1, 0.7, 1.0])
def test_last_same_hash_value(density):
    b, n = 3, 512
    rng = np.random.default_rng(int(density * 10))
    palette = _words(rng, 40)
    packed = palette[rng.integers(0, palette.size, (b, n))]
    packed[0, :5] = 0  # zero pixels match the zero table
    noneq = rng.random((b, n)) < density
    h = _np(jbit.hash6(jnp.asarray(packed))).astype(np.int32)
    want = jax.vmap(jenc._last_same_hash_value)(
        jnp.asarray(packed), jnp.asarray(h), jnp.asarray(noneq))
    got = encode._last_same_hash_value(words_to_torch(packed),
                                       torch.from_numpy(h),
                                       torch.from_numpy(noneq))
    assert np.array_equal(_np(want), words_to_numpy(got))
    one = encode._last_same_hash_value(words_to_torch(packed[1]),
                                       torch.from_numpy(h[1]),
                                       torch.from_numpy(noneq[1]))
    assert np.array_equal(_np(want[1]), words_to_numpy(one))


@pytest.mark.parametrize("density", [0.1, 0.7])
def test_last_same_hash_value_incoming(density):
    # a streaming window's carried table: pixels with no same-hash
    # predecessor in the row read it
    b, n = 3, 512
    rng = np.random.default_rng(20 + int(density * 10))
    palette = _words(rng, 40)
    packed = palette[rng.integers(0, palette.size, (b, n))]
    noneq = rng.random((b, n)) < density
    h = _np(jbit.hash6(jnp.asarray(packed))).astype(np.int32)
    incoming = _words(rng, (b, 64))
    for i in range(b):  # half the palette sits in the carried table
        incoming[i, h[0, :20]] = packed[0, :20]
    want = jax.vmap(jenc._last_same_hash_value)(
        jnp.asarray(packed), jnp.asarray(h), jnp.asarray(noneq),
        jnp.asarray(incoming))
    got = encode._last_same_hash_value(
        words_to_torch(packed), torch.from_numpy(h), torch.from_numpy(noneq),
        words_to_torch(incoming))
    assert np.array_equal(_np(want), words_to_numpy(got))
    one = encode._last_same_hash_value(
        words_to_torch(packed[1]), torch.from_numpy(h[1]),
        torch.from_numpy(noneq[1]), words_to_torch(incoming[1]))
    assert np.array_equal(_np(want[1]), words_to_numpy(one))


def test_carry_conversion_roundtrip():
    rng = np.random.default_rng(3)
    prev, seen = _words(rng, (1, 5)), _words(rng, (64, 5))
    tp, ts = convert.carry_from_jax(prev, seen, device="cpu")
    assert tp.dtype == ts.dtype == torch.int32
    bp, bs = convert.carry_to_jax(tp, ts)
    assert bp.dtype == np.uint32
    assert np.array_equal(bp, prev) and np.array_equal(bs, seen)
    with pytest.raises(ValueError):
        convert.carry_from_jax(seen, prev, device="cpu")


def test_stream_carry_conversion_roundtrip():
    rng = np.random.default_rng(4)
    prev, seen = _words(rng, ()), _words(rng, 64)
    run = np.uint32(61)
    tp, tr, ts = convert.encoder_carry_from_jax(prev, run, seen, device="cpu")
    assert (tp.shape, tr.shape, ts.shape) == ((), (), (64,))
    assert tp.dtype == tr.dtype == ts.dtype == torch.int32
    for got, want in zip(convert.encoder_carry_to_jax(tp, tr, ts),
                         (prev, run, seen)):
        assert got.dtype == np.uint32 and np.array_equal(got, want)
    with pytest.raises(ValueError, match="0..61"):
        convert.encoder_carry_from_jax(prev, np.uint32(62), seen,
                                       device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.encoder_carry_from_jax(prev[None], run, seen, device="cpu")
    wp, ws = convert.window_carry_from_jax(prev[None], seen, device="cpu")
    assert (wp.shape, ws.shape) == ((1,), (64,))
    bp, bs = convert.window_carry_to_jax(wp, ws)
    assert np.array_equal(bp, prev[None]) and np.array_equal(bs, seen)
    with pytest.raises(ValueError, match="shape"):
        convert.window_carry_from_jax(prev, seen, device="cpu")


def test_conversion_defaults_to_cuda():
    # decided when the test runs, on whichever machine runs it
    rng = np.random.default_rng(5)
    prev, seen = _words(rng, (1, 2)), _words(rng, (64, 2))
    if torch.cuda.is_available():
        assert convert.words_to_torch(prev).device.type == "cuda"
        assert convert.carry_from_jax(prev, seen)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.words_to_torch(prev)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.encoder_carry_from_jax(prev[0, 0], np.uint32(0),
                                           seen[:, 0])


def test_port_imports_without_jax():
    # the port and chip_smoke.py must run where neither JAX nor the JAX
    # package is installed: import every module of the port with jax,
    # qoipp_tpu, bench and the JAX experiments' benchmarks blocked
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'qoipp_tpu', 'bench', 'benchmarks'):\n"
        "    sys.modules[name] = None\n"
        "import qoipp_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    qoipp_tpu_torch.__path__, 'qoipp_tpu_torch.')]\n"
        "assert len(names) > 25, names\n"
        "for e in ('expt_place_wide', 'expt_place2', 'expt_place_narrow',\n"
        "          'expt_place_fixed', 'expt_place', 'expt_emit_wide',\n"
        "          'profile_r2'):\n"
        "    assert 'qoipp_tpu_torch.benchmarks.' + e in names, names\n"
        "for m in ('api', 'stream', 'models.packed', 'models.scheduler',\n"
        "          'models.serving', 'utils.transfer'):\n"
        "    assert 'qoipp_tpu_torch.' + m in names, names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "from qoipp_tpu_torch.models.pipeline import BatchPipeline\n"
        "assert qoipp_tpu_torch.BatchPipeline is BatchPipeline\n"
        "from qoipp_tpu_torch.models.serving import ServingCodec\n"
        "assert qoipp_tpu_torch.ServingCodec is ServingCodec\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _port_sources():
    return sorted((ROOT / "qoipp_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_nothing_of_jax(path):
    banned = ("jax", "qoipp_tpu", "bench", "benchmarks")
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, (
                f"{path.name}:{node.lineno} imports {name}")


def test_profile_grouping_and_busy_union():
    from qoipp_tpu_torch.utils import profile

    assert profile.busy_us([(0, 4), (2, 6), (10, 11), (10.5, 10.7)]) == 7
    assert profile.busy_us([]) == 0
    assert profile.group_of("void (anonymous namespace)::replay_kernel"
                            "<true>(unsigned int const*)") == "K1/K5 replay"
    assert profile.group_of("Memcpy HtoD (Pageable -> Device)") == "copies"
    assert profile.group_of("void at::native::vectorized_elementwise_kernel"
                            "<4, ...>") == "torch elementwise"
    assert profile.group_of("void (anonymous namespace)::fields_kernel("
                            "unsigned int const*)") == "E1 fields"
    assert profile.group_of("void (anonymous namespace)::fields_summary_"
                            "kernel(unsigned int const*)") == "E1 fields"
    assert profile.group_of("void (anonymous namespace)::place_fill_kernel("
                            "int const*)") == "K2 place_fill"
    assert profile.group_of("void (anonymous namespace)::place_fill2_kernel("
                            "int const*)") == "E2/E3/E5/E6 windowed placement"
    assert profile.group_of("void (anonymous namespace)::place_variant_kernel"
                            "<true, false, 3>(int const*)") == (
        "E2/E3/E5/E6 windowed placement")
    assert profile.group_of("void (anonymous namespace)::place_grouped_kernel"
                            "<1>(int const*)") == "E4 grouped placement"
    assert profile.group_of("void (anonymous namespace)::emit_window_kernel"
                            "<256>(int const*)") == "E7 emit_wide"
    assert profile.group_of("void (anonymous namespace)::emit_kernel("
                            "int const*)") == "K4 emit"
    assert profile.group_of("void (anonymous namespace)::grid_step_kernel("
                            "uint4 const*)") == "E8 grid probe"
    assert profile.group_of("void (anonymous namespace)::onehot_place_kernel"
                            "(int const*)") == "E9 one-hot placement"
    assert profile.group_of("some_other_kernel") == "other"
