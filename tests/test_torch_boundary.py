"""The chunk-start scan's routes off the card: the plain version against a
sequential walk of chunk lengths (the two-level experiment's byte soup and
one-tag rows, at the kernel's edge widths), CPU tensors never reaching the
kernel library, strided views equal to their contiguous copies, and the
kernel route's refusals on meta tensors (which take it without a card)."""

import numpy as np
import pytest
import torch

from qoipp_tpu_torch import kernels
from qoipp_tpu_torch.benchmarks import expt_boundary2l
from qoipp_tpu_torch.kernels import selfcheck
from qoipp_tpu_torch.ops import boundary
from qoipp_tpu_torch.utils import tracing

# the card tests' soup shapes that fit a CPU run, and selfcheck's
SOUP_SHAPES = sorted({(1, 128), (3, 512), (2, 37 * 128), (8, 2048 * 128),
                      *selfcheck.CHUNK_STARTS_SHAPES})


def _length(tag: int) -> int:
    return 4 if tag == 0xFE else 5 if tag == 0xFF else \
        2 if tag & 0xC0 == 0x80 else 1


def walk(regions: np.ndarray) -> np.ndarray:
    """Chunk starts by walking each row: byte 0, then one chunk's length
    after another."""
    out = np.zeros(regions.shape, bool)
    for row, starts in zip(regions, out):
        p = 0
        while p < row.size:
            starts[p] = True
            p += _length(int(row[p]))
    return out


def _plain(regions: np.ndarray) -> np.ndarray:
    return boundary.chunk_starts_batch_plain(torch.from_numpy(regions)).numpy()


@pytest.mark.parametrize("b,qb", SOUP_SHAPES)
def test_plain_scan_matches_walk_on_byte_soup(b, qb):
    reg = expt_boundary2l._rand_streams(np.random.default_rng(qb), b, qb)
    assert np.array_equal(_plain(reg), walk(reg))


@pytest.mark.parametrize("tag", selfcheck.CHUNK_STARTS_FILLS)
def test_plain_scan_matches_walk_on_one_tag_rows(tag):
    reg = np.full((2, 9 * 4096 + 256), tag, np.uint8)
    reg[1, ::7] = 0x00  # a 1-byte op every seventh byte breaks the chains
    assert np.array_equal(_plain(reg), walk(reg))


def test_byte_soup_holds_every_length_class():
    """The soup the scan is held on starts chunks of every length and
    hides tags in payloads, so the phases reach 1..4 everywhere."""
    reg = expt_boundary2l._rand_streams(np.random.default_rng(0), 2, 4096)
    starts = walk(reg)
    assert np.array_equal(_plain(reg), starts)
    assert {_length(int(t)) for t in reg[starts]} == {1, 2, 4, 5}
    assert {0xFE, 0xFF} <= set(reg[~starts].tolist())


def test_cpu_tensors_take_the_plain_route(monkeypatch):
    """A CPU tensor never touches the kernel library, and counts no
    boundary scan."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU route reached the kernel library")

    monkeypatch.setattr(kernels, "launch", refuse)
    monkeypatch.setattr(kernels, "library", refuse)
    reg = expt_boundary2l._rand_streams(np.random.default_rng(4), 3, 4096)
    with tracing.collect() as tr:
        got = boundary.chunk_starts_batch(torch.from_numpy(reg))
        one = boundary.chunk_starts(torch.from_numpy(reg[0]))
    assert np.array_equal(got.numpy(), walk(reg))
    assert np.array_equal(one.numpy(), walk(reg[:1])[0])
    assert not any(k in ("boundary_scans", "boundary_scan_bytes")
                   for _, k in tr.counters)


@pytest.mark.parametrize("first,after", selfcheck.CHUNK_STARTS_VIEWS)
def test_strided_view_matches_contiguous_copy(first, after):
    reg = expt_boundary2l._rand_streams(np.random.default_rng(after), 5,
                                        3 * 4096 + 128)
    view = selfcheck.strided_view(reg, torch.device("cpu"), first, after)
    assert view.stride() == (first + reg.shape[1] + after, 1)
    assert torch.equal(boundary.chunk_starts_batch(view),
                       boundary.chunk_starts_batch(view.contiguous()))
    assert np.array_equal(boundary.chunk_starts_batch(view).numpy(),
                          walk(reg))


@pytest.mark.parametrize("case", ["dtype", "column stride", "width"])
def test_kernel_route_refuses(case):
    """Off the CPU the wrapper checks before it launches: uint8, a unit
    column stride, a width that is a multiple of BLOCK."""
    meta = torch.device("meta")
    reg = {"dtype": torch.empty((2, 256), dtype=torch.int32, device=meta),
           "column stride": torch.empty((2, 512), dtype=torch.uint8,
                                        device=meta)[:, ::2],
           "width": torch.empty((2, 200), dtype=torch.uint8, device=meta)
           }[case]
    with pytest.raises(ValueError):
        boundary.chunk_starts_batch(reg)


def test_kernel_route_never_falls_back(monkeypatch):
    """Off the CPU a valid input goes to the kernel library, and where the
    library fails the call raises: no plain version in its place."""
    def missing(*args, **kwargs):
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(kernels, "library", missing)
    monkeypatch.setattr(kernels, "launch", missing)
    reg = torch.empty((2, 256), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel library"):
        boundary.chunk_starts_batch(reg)
