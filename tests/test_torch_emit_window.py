"""E7, the wide-slab emit experiment of K4, against the JAX package's Pallas
kernel (benchmarks/expt_emit_wide.py, loaded by path, interpret mode) on
the whole (B, out_cap) output, bit-exact.  On CPU tensors the wrapper takes
its plain version (K4's, qoipp_tpu_torch.ops.emit_window); the kernel runs
on the card (tests/test_torch_cuda.py, chip_smoke.py).  Also: the script's
generator and window_base_rows_w against the port's, the TPU kernel's
``lenr`` cap pinned where it binds, and the port's script at a small
size; the selfcheck's trailing-run cases against the JAX kernel, and
the rows the card's kernel reads for them."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qoipp_tpu.ops import emit_kernel as jek
from qoipp_tpu_torch.benchmarks import expt_emit_wide
from qoipp_tpu_torch.convert import words_to_torch
from qoipp_tpu_torch.kernels import selfcheck
from qoipp_tpu_torch.ops import emit_window as EW

torch.set_num_threads(1)

_LOADED = {}


def _script():
    """benchmarks/expt_emit_wide.py, loaded by path once per process."""
    if not _LOADED:
        path = (Path(__file__).resolve().parent.parent / "benchmarks"
                / "expt_emit_wide.py")
        spec = importlib.util.spec_from_file_location(
            "benchmarks_expt_emit_wide", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED["mod"] = mod
    return _LOADED["mod"]


def _inputs(b, c, seed=0):
    """The script's inputs as JAX arrays and as the port's tensors."""
    off, tlo, thn, out_cap = _script().gen_inputs(np.random.default_rng(seed),
                                                  b, c)
    port = (torch.from_numpy(np.array(off)),
            words_to_torch(np.asarray(tlo), device="cpu"),
            words_to_torch(np.asarray(thn), device="cpu"))
    return (off, tlo, thn), port, out_cap


@pytest.mark.parametrize("lanes", EW.WIDE_LANES)
@pytest.mark.parametrize("hoist", [False, True])
def test_emit_wide_matches_jax(lanes, hoist):
    e7 = _script()
    (off, tlo, thn), port, out_cap = _inputs(2, 4096, seed=lanes + hoist)
    want = np.asarray(e7.emit_wide(off, tlo, thn,
                                   e7.window_base_rows_w(off, out_cap, lanes),
                                   out_cap, lanes=lanes, hoist=hoist))
    got = EW.emit_wide(*port, EW.window_base_rows_w(port[0], out_cap, lanes),
                       out_cap, lanes=lanes, hoist=hoist)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert np.array_equal(want, got.numpy())


def test_lenr_cap_drops_the_covering_row_of_a_long_equal_off_run():
    # at the script's own C = 2^17 the last 32,770 rows share one off; only
    # the last of them covers, and both JAX kernels stop before its slab
    # (their bytes there continue the row before, or read 0)
    e7 = _script()
    (off, tlo, thn), port, out_cap = _inputs(1, 1 << 17)
    want = np.asarray(e7.emit_wide(off, tlo, thn,
                                   e7.window_base_rows_w(off, out_cap, 256),
                                   out_cap, lanes=256))
    production = np.asarray(jek.emit_bytes(
        off, tlo, thn, jek.window_base_rows(off, out_cap), out_cap=out_cap))
    got = EW.emit_wide(*port, EW.window_base_rows_w(port[0], out_cap, 256),
                       out_cap).numpy()
    differ = np.flatnonzero(got[0] != want[0])
    assert differ.tolist() == list(range(343745, 343751))
    assert np.array_equal(production.astype(np.int32), want)
    sentinel = int(np.asarray(off)[0, -1])
    assert sentinel == 343745  # the covering row's bytes, written by the port
    thn_last = int(np.asarray(thn)[0, -1])
    tlo_last = int(np.asarray(tlo)[0, -1])
    assert got[0, 343745:343751].tolist() == [
        (tlo_last >> 8 * k) & 0xFF for k in range(4)] + [
        thn_last & 0xFF, thn_last >> 8 & 0xFF]


@pytest.mark.parametrize("lanes", EW.WIDE_LANES)
@pytest.mark.parametrize("case", sorted(selfcheck.EMIT_RUN_CASES))
def test_emit_run_cases_match_jax(case, lanes):
    # the selfcheck's trailing runs of equal offs (the card's kernel reads
    # only the rows before each and its last row): every run here is shorter
    # than the JAX kernel's lenr slabs, so its whole output is the port's
    off, tlo, thn, out_cap = selfcheck.emit_run_case(
        case, np.random.default_rng(lanes), "cpu")
    e7 = _script()
    joff = jnp.asarray(off.numpy())
    jtlo, jthn = (jnp.asarray(x.numpy().view(np.uint32)) for x in (tlo, thn))
    want = np.asarray(e7.emit_wide(
        joff, jtlo, jthn, e7.window_base_rows_w(joff, out_cap, lanes),
        out_cap, lanes=lanes))
    got = EW.emit_wide(off, tlo, thn,
                       EW.window_base_rows_w(off, out_cap, lanes), out_cap,
                       lanes=lanes)
    assert np.array_equal(want, got.numpy())
    runs = [int((r == r[-1]).sum()) for r in off.numpy()]
    assert min(runs) >= selfcheck.EMIT_RUN_ROWS


@pytest.mark.parametrize("case", sorted(selfcheck.EMIT_RUN_CASES))
def test_emit_run_cases_candidate_rows_hold_every_writer(case):
    # the card's kernel reads, for window w, the row before base's first
    # slab and the slabs' rows [lo, hi), and writes only the last row of
    # the trailing run of equal offs in them: every row whose bytes land in
    # the window lies there, and the trailing run's rows before its last
    # write nothing, at every lanes
    off, _, _, out_cap = selfcheck.emit_run_case(
        case, np.random.default_rng(5), "cpu")
    o = off.numpy().astype(np.int64)
    b, c = o.shape
    nxt = np.concatenate([o[:, 1:], np.full((b, 1), out_cap + EW.WIN)], 1)
    n = np.minimum(nxt - o, 6)
    for lanes in EW.WIDE_LANES:
        base = EW.window_base_rows_w(off, out_cap, lanes).numpy()
        for i in range(b):
            for w in range(out_cap // EW.WIN):
                w0 = w * EW.WIN
                lo = int(base[i, w]) * lanes
                hi = min((int(base[i, w + 1]) + 1) * lanes, c)
                rows = np.flatnonzero((n[i] > 0) & (o[i] < w0 + EW.WIN)
                                      & (o[i] + n[i] > w0)
                                      & (o[i] < out_cap))
                assert rows.size == 0 or (rows.min() >= max(lo - 1, 0)
                                          and rows.max() < hi), (lanes, i, w)
                if lo < hi:
                    run = o[i, lo:hi] == o[i, hi - 1]
                    start = lo + int(np.argmax(run))
                    assert run[start - lo:].all()
                    assert not np.any(n[i, start:hi - 1] > 0)


def test_gen_inputs_is_the_script():
    want = _script().gen_inputs(np.random.default_rng(3), 3, 5000, fill=0.6)
    got = expt_emit_wide.gen_inputs(np.random.default_rng(3), 3, 5000,
                                    fill=0.6)
    assert got[3] == want[3]
    for w, g in zip(want[:3], got[:3]):
        assert np.asarray(w).dtype == g.dtype
        assert np.array_equal(np.asarray(w), g)


@pytest.mark.parametrize("lanes", EW.WIDE_LANES)
def test_window_base_rows_w_match_the_script(lanes):
    (off, _, _), port, out_cap = _inputs(3, 3 * lanes + 77, seed=lanes)
    want = _script().window_base_rows_w(off, out_cap, lanes)
    got = EW.window_base_rows_w(port[0], out_cap, lanes)
    assert got.dtype == torch.int32
    assert np.array_equal(np.asarray(want), got.numpy())


def test_expt_emit_wide_parity_on_cpu():
    rows = expt_emit_wide.main(["-b", "2", "--rows", "4096", "--runs", "0"],
                               device="cpu")
    assert len(rows) == len(expt_emit_wide.VARIANTS)
    assert all(r["max_abs_err"] == 0 and r["k4_err"] == 0
               and r["ms"] is None for r in rows)
    with pytest.raises(ValueError, match="CUDA"):
        expt_emit_wide.main(["-b", "2", "--rows", "4096"], device="cpu")


def test_emit_wide_rejects_what_the_kernel_does_not_take():
    off = torch.zeros((1, 300), dtype=torch.int32)
    base = EW.window_base_rows_w(off, EW.WIN, 256)
    with pytest.raises(ValueError, match="lanes"):
        EW.emit_wide(off, off, off, base, EW.WIN, lanes=64)
    with pytest.raises(ValueError, match="out_cap"):
        EW.emit_wide(off, off, off, base, EW.WIN + 8)
    with pytest.raises(ValueError, match="base_step"):
        EW.emit_wide(off, off, off, base[:, :1], EW.WIN)
