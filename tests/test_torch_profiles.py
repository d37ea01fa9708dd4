"""The port's last public helpers and its stage profiles and host-stage
experiments (qoipp_tpu_torch.benchmarks: profile_r3,
profile_bucket_decode, profile_packed_decode, profile_packed_encode,
expt_boundary2l, expt_table_stack, expt_compact, expt_enc_lanes,
expt_h2d_chunks) on the CPU, bit-exact (tolerance: exact equality):
ops/bitops.unpack_rgba and ops/boundary.chunk_starts against the JAX
package's; the two-level boundary scan and both stacked table fills
against the port's shipped functions and the JAX scripts' (loaded from
benchmarks/ by path), on the scripts' own generators (byte-equal
copies); each script's main at a tiny size with --runs 0, which holds its
stages' composed output against the fused call and the oracle; and every
script refusing to time without a card."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoipp_tpu.ops import bitops as jbitops
from qoipp_tpu.ops import boundary as jboundary
from qoipp_tpu_torch.benchmarks import (expt_boundary2l, expt_compact,
                                        expt_enc_lanes, expt_h2d_chunks,
                                        expt_table_stack,
                                        profile_bucket_decode,
                                        profile_packed_decode,
                                        profile_packed_encode, profile_r3)
from qoipp_tpu_torch.convert import words_to_torch
from qoipp_tpu_torch.ops import bitops, boundary
from qoipp_tpu_torch.ops import encode as enc_ops
from qoipp_tpu_torch.utils.corpus import make_corpus

torch.set_num_threads(1)

_LOADED = {}


def _script(name):
    """A module of benchmarks/, loaded by path once per process."""
    if name not in _LOADED:
        path = (Path(__file__).resolve().parent.parent / "benchmarks"
                / f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"benchmarks_{name}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[name] = mod
    return _LOADED[name]


def test_unpack_rgba_matches_jax():
    words = np.random.default_rng(3).integers(0, 1 << 32, 4096,
                                              dtype=np.uint64).astype(
                                                  np.uint32)
    got = bitops.unpack_rgba(words_to_torch(words, device="cpu"))
    want = jbitops.unpack_rgba(jnp.asarray(words))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_chunk_starts_matches_jax():
    qb = 640
    region = _script("expt_boundary2l")._rand_streams(
        np.random.default_rng(qb), 1, qb)[0]
    got = boundary.chunk_starts(torch.from_numpy(region))
    assert got.shape == (qb,)
    assert np.array_equal(got.numpy(), np.asarray(
        jboundary.chunk_starts(jnp.asarray(region))))


def test_rand_streams_byte_equal_to_script():
    a = expt_boundary2l._rand_streams(np.random.default_rng(11), 3, 4 * 128)
    b = _script("expt_boundary2l")._rand_streams(
        np.random.default_rng(11), 3, 4 * 128)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("b,qb", expt_boundary2l.PARITY_SHAPES
                         + ((4, 64 * 128),))
def test_two_level_scan_matches_shipped(b, qb):
    reg = torch.from_numpy(expt_boundary2l._rand_streams(
        np.random.default_rng(qb), b, qb))
    assert torch.equal(expt_boundary2l.chunk_starts_batch_2l(reg),
                       boundary.chunk_starts_batch(reg))


def test_two_level_scan_matches_script():
    reg = expt_boundary2l._rand_streams(np.random.default_rng(3), 3, 512)
    got = expt_boundary2l.chunk_starts_batch_2l(torch.from_numpy(reg))
    script = _script("expt_boundary2l").chunk_starts_batch_2l
    assert np.array_equal(got.numpy(), np.asarray(script(jnp.asarray(reg))))


def test_two_level_scan_on_real_regions():
    reg = expt_boundary2l.batch_regions(torch.device("cpu"), b=3, w=80,
                                        h=64)
    assert torch.equal(expt_boundary2l.chunk_starts_batch_2l(reg),
                       boundary.chunk_starts_batch(reg))


def test_rand_case_byte_equal_to_script():
    for n, n_seg in ((64, 1), (4096, 9)):
        a = expt_table_stack._rand_case(np.random.default_rng(7), n, n_seg)
        b = _script("expt_table_stack")._rand_case(
            np.random.default_rng(7), n, n_seg)
        for x, y in zip(a, b):
            assert np.array_equal(x, np.asarray(y))


def _torch_case(case):
    """A _rand_case as one-row tensors (seg None: left out)."""
    pk, h, nq, seg = case
    return (torch.from_numpy(pk.view(np.int32))[None],
            torch.from_numpy(h.view(np.int32))[None],
            torch.from_numpy(nq)[None],
            None if seg is None else torch.from_numpy(seg)[None])


SEG_CASES = [(64, 1), (256, 3), (4096, 9), (64 * 256, 40)]


@pytest.mark.parametrize("n,n_seg", SEG_CASES)
@pytest.mark.parametrize("tile", [64, 32])
def test_seg_stacked_matches_shipped(n, n_seg, tile):
    args = _torch_case(expt_table_stack._rand_case(
        np.random.default_rng(n + tile), n, n_seg))
    assert torch.equal(
        expt_table_stack._last_same_hash_value_seg_stacked(*args, tile=tile),
        enc_ops._last_same_hash_value_seg(*args))


@pytest.mark.parametrize("tile", [64, 32])
def test_seg_stacked_matches_script(tile):
    case = expt_table_stack._rand_case(np.random.default_rng(tile), 1024, 5)
    got = expt_table_stack._last_same_hash_value_seg_stacked(
        *_torch_case(case), tile=tile)
    want = _script("expt_table_stack")._last_same_hash_value_seg_stacked(
        *map(jnp.asarray, case), tile=tile)
    assert np.array_equal(got[0].numpy().view(np.uint32), np.asarray(want))


def _plain_case(n, with_incoming):
    rng = np.random.default_rng(n)
    case = expt_table_stack._rand_case(rng, n, 1)[:3]
    return case, expt_table_stack._incoming(rng) if with_incoming else None


@pytest.mark.parametrize("n", [64, 256, 4096])
@pytest.mark.parametrize("with_incoming", [False, True])
def test_plain_stacked_matches_shipped(n, with_incoming):
    case, inc = _plain_case(n, with_incoming)
    pk, h, nq, _ = _torch_case((*case, None))
    inc = None if inc is None else torch.from_numpy(inc.view(np.int32))
    assert torch.equal(
        expt_table_stack._last_same_hash_value_stacked(pk, h, nq, inc),
        enc_ops._last_same_hash_value(pk, h, nq, inc))


@pytest.mark.parametrize("with_incoming", [False, True])
def test_plain_stacked_matches_script(with_incoming):
    case, inc = _plain_case(1024, with_incoming)
    pk, h, nq, _ = _torch_case((*case, None))
    got = expt_table_stack._last_same_hash_value_stacked(
        pk, h, nq, None if inc is None else torch.from_numpy(
            inc.view(np.int32)))
    want = _script("expt_table_stack")._last_same_hash_value_stacked(
        *map(jnp.asarray, case), None if inc is None else jnp.asarray(inc))
    assert np.array_equal(got[0].numpy().view(np.uint32), np.asarray(want))


def test_stacked_batched_rows_match_shipped():
    """Several lanes at once (the timed shapes' form), seg at 3 lanes."""
    rng = np.random.default_rng(5)
    args = expt_table_stack._rows(
        [expt_table_stack._rand_case(rng, 2048, 4) for _ in range(3)],
        torch.device("cpu"))
    assert torch.equal(
        expt_table_stack._last_same_hash_value_seg_stacked(*args),
        enc_ops._last_same_hash_value_seg(*args))
    assert torch.equal(
        expt_table_stack._last_same_hash_value_stacked(*args[:3]),
        enc_ops._last_same_hash_value(*args[:3]))


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    """A small corpus of .qoi files: two each of four geometries, RGB and
    RGBA."""
    d = tmp_path_factory.mktemp("corpus")
    for i, (ch, w, h) in enumerate([(3, 48, 40), (4, 48, 40), (3, 64, 48),
                                    (4, 80, 40)]):
        for j, blob in enumerate(make_corpus(2, w, h, seed=i,
                                             channels=ch)[2]):
            (d / f"img{i}_{j}.qoi").write_bytes(blob.tobytes())
    return str(d)


SCRIPTS = {  # module: argv of a tiny parity-only run ({} the corpus)
    profile_r3: ["--batch", "3", "--encode-batch", "2", "--width", "64",
                 "--height", "48"],
    profile_bucket_decode: ["--cap-kb", "0", "--replicate", "2",
                            "--corpus", "{}"],
    profile_packed_decode: ["--lane-kb", "64", "--replicate", "2",
                            "--corpus", "{}"],
    profile_packed_encode: ["--lane-px", "4096", "--replicate", "2",
                            "--corpus", "{}"],
    expt_boundary2l: [],
    expt_table_stack: [],
    expt_compact: ["--lanes", "3", "--rows", "10000", "--cap", "4608"],
    expt_enc_lanes: ["--lanes", "2", "5", "--lane-px", "4096",
                     "--replicate", "2", "--corpus", "{}"],
    expt_h2d_chunks: ["--mb", "1", "--pieces", "1", "2", "8", "256"],
}


@pytest.mark.parametrize("module", list(SCRIPTS),
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_script_parity_on_cpu(module, corpus_dir):
    """main(["--runs", "0", ...], device="cpu"): every hold the script
    makes before timing (stages composing to the fused call, the oracle,
    the shipped functions) passes."""
    argv = [a.format(corpus_dir) for a in SCRIPTS[module]]
    module.main(["--runs", "0", *argv], device="cpu")


@pytest.mark.parametrize("module", list(SCRIPTS),
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_script_refuses_timing_without_card(module, monkeypatch):
    with pytest.raises(ValueError, match="CUDA device"):
        module.main(["--runs", "1", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--runs", "0"])


def test_profile_r3_rows_and_stats():
    """The profile's returned chunk statistics at --runs 0: the decode's
    chunks a byte and the encode's counts within its chunk cap."""
    out = profile_r3.main(["--runs", "0", "--batch", "2", "--encode-batch",
                           "2", "--width", "64", "--height", "48"],
                          device="cpu")
    dec, enc = out["decode"]["chunks"], out["encode"]["chunks"]
    assert 0 < dec["min"] <= dec["mean"] <= dec["max"]
    assert 0 < dec["per_byte"] <= 1
    assert 0 < enc["max"] <= enc["chunk_cap"] and enc["nb"] == 64 * 48
