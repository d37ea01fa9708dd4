"""E2-E6, the placement experiments of K2, against the JAX package's
Pallas kernels (benchmarks/expt_place_wide.py, expt_place2.py,
expt_place.py, expt_place_narrow.py, expt_place_fixed.py, loaded by path
and run in interpret mode) on the whole (B, n_cap) output, bit-exact.  On
CPU tensors each wrapper takes its plain version (the windowed placement,
or E4's grouped summed placement, qoipp_tpu_torch.ops.place_window); the
kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Also: the experiment scripts' input generators against
the scripts', window_base_rows(_w) and E4's base rows against the scripts'
own, and the experiment scripts' parity runs at a small size.

E4's ``run`` is jitted with ``n_cap`` static from its ``__wrapped__``
function inside ``pltpu.force_tpu_interpret_mode()``: the committed jit
cannot trace another n_cap than its default."""

import importlib.util
import inspect
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from qoipp_tpu.ops import place_kernel as jpk
from qoipp_tpu_torch.benchmarks import (expt_place, expt_place2,
                                        expt_place_fixed, expt_place_narrow,
                                        expt_place_wide)
from qoipp_tpu_torch.convert import words_to_numpy, words_to_torch
from qoipp_tpu_torch.kernels import selfcheck
from qoipp_tpu_torch.ops import place_kernel
from qoipp_tpu_torch.ops import place_window as PW

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


def _port(pb, emits):
    return (torch.from_numpy(np.array(pb, np.int32)),
            words_to_torch(np.asarray(emits), device="cpu"))


def _same(want, got):
    want = np.asarray(want)
    assert want.dtype == np.uint32 and want.shape == tuple(got.shape)
    assert np.array_equal(want, words_to_numpy(got))


@pytest.mark.parametrize("lanes", PW.WIDE_LANES)
@pytest.mark.parametrize("hoist", [False, True])
def test_place_wide_matches_jax(lanes, hoist):
    # bench-like density (~7 pixels per row): five windows, Q = 5000 not
    # a multiple of any lanes
    e2 = _script("expt_place_wide")
    pbj, emj, n_cap = e2.gen_inputs(np.random.default_rng(lanes + hoist), 2,
                                    5000, density=0.40, run_p=0.20)
    assert n_cap >= 4 * PW.WIN
    want = e2.place_wide(pbj, emj, e2.window_base_rows_w(pbj, n_cap, lanes),
                         n_cap, lanes=lanes, hoist=hoist)
    pb, emits = _port(pbj, emj)
    got = PW.place_wide(pb, emits, PW.window_base_rows_w(pb, n_cap, lanes),
                        n_cap, lanes=lanes, hoist=hoist)
    _same(want, got)


@pytest.mark.parametrize("case", range(len(expt_place2.CASES)),
                         ids=[c[0] for c in expt_place2.CASES])
def test_place_fill2_matches_jax(case):
    e3 = _script("expt_place2")
    _, dens, rf = expt_place2.CASES[case]
    pbj, emj, n_cap = e3.make_case(2, 4096, dens, rf, seed=case)
    want = e3.place_fill2(pbj, emj, jpk.window_base_rows(pbj, n_cap), n_cap)
    pb, emits = _port(pbj, emj)
    got = PW.place_fill2(pb, emits, PW.window_base_rows(pb, n_cap), n_cap)
    _same(want, got)


def _longest_chunks(pb, n_cap):
    """Each window's longest chunk (pb[r+1] - pb[r] of its writers)."""
    nxt, writes = PW.writers(pb, n_cap)
    win = torch.where(writes, pb // PW.WIN, 0).long()
    return torch.zeros((pb.shape[0], n_cap // PW.WIN), dtype=pb.dtype
                       ).scatter_reduce(1, win, torch.where(writes, nxt - pb,
                                                            0), "amax")


def test_place_fill2_predicate_boundary_matches_jax():
    # a window whose longest chunk is exactly 8 beside one whose longest is
    # exactly 9: the JAX kernel fills the first to reach 7 only and runs
    # the passes of reach 8-32 in the second
    rng = np.random.default_rng(21)
    kinds = (["short", "nine"] * 2, ["nine", "short"] * 2)
    pb = np.stack([selfcheck._fill2_image(rng, k, PW.WIN)[:4096]
                   for k in kinds]).astype(np.int32)
    emits = rng.integers(0, 1 << 32, pb.shape, dtype=np.uint64).astype(
        np.uint32)
    n_cap = 4 * PW.WIN
    tpb, temits = _port(pb, emits)
    longest = _longest_chunks(tpb, n_cap)[:, :2].tolist()
    assert longest == [[8, 9], [9, 8]]
    want = _script("expt_place2").place_fill2(
        jnp.asarray(pb), jnp.asarray(emits),
        jpk.window_base_rows(jnp.asarray(pb), n_cap), n_cap)
    _same(want, PW.place_fill2(tpb, temits, PW.window_base_rows(tpb, n_cap),
                               n_cap))


@pytest.mark.parametrize("ns", expt_place_narrow.NS)
@pytest.mark.parametrize("run_frac", [0.02, 0.20])
def test_place_fill_narrow_matches_jax(ns, run_frac):
    e5 = _script("expt_place_narrow")
    pbj, emj, n_cap = e5.gen_case(np.random.default_rng(ns), 2, 8192,
                                  run_frac)
    assert n_cap >= 2 * PW.WIN
    with pltpu.force_tpu_interpret_mode():
        want = e5.place_fill_narrow(pbj, emj,
                                    jpk.window_base_rows(pbj, n_cap),
                                    n_cap=n_cap, ns=ns)
    pb, emits = _port(pbj, emj)
    got = PW.place_fill_narrow(pb, emits, PW.window_base_rows(pb, n_cap),
                               n_cap, ns=ns)
    _same(want, got)


E6_CASES = {
    "highest": dict(prec="highest"),
    "bytes4": dict(prec="bytes4"),
    "fill-3": dict(n_fill=3),
    "no-fill": dict(n_fill=0),
    "no-slabs": dict(do_slabs=False),
    "no-dma": dict(do_dma=False, do_slabs=False),
}


@pytest.mark.parametrize("name", sorted(E6_CASES))
def test_place_variant_matches_jax(name):
    # bench-like rows (runs of 5..62 pixels, four windows), so the cut
    # fills leave most pixels to the carry
    kw = E6_CASES[name]
    e6 = _script("expt_place_fixed")
    pbj, emj, n_cap = _script("expt_place2").make_case(2, 4096, 0.40, 0.20,
                                                       seed=len(name))
    assert n_cap >= 3 * PW.WIN
    with pltpu.force_tpu_interpret_mode():
        want = e6.place_variant(pbj, emj, jpk.window_base_rows(pbj, n_cap),
                                n_cap, **kw)
    pb, emits = _port(pbj, emj)
    got = PW.place_variant(pb, emits, PW.window_base_rows(pb, n_cap), n_cap,
                           **kw)
    _same(want, got)
    if not kw.get("do_slabs", True):
        assert not got.any()


def test_windowed_reference_is_the_jax_k2_whole_output():
    # rows with pb >= n_cap, runs of 1..62, a tail of empty windows
    rng = np.random.default_rng(3)
    produced = np.where(rng.random((3, 3072)) < 0.6,
                        rng.integers(1, 63, (3, 3072)), 0)
    produced[2, 1000:] = 0  # image 2 stops early: a long empty tail
    pb = (np.cumsum(produced, axis=1) - produced).astype(np.int32)
    emits = rng.integers(0, 1 << 32, pb.shape, dtype=np.uint64).astype(
        np.uint32)
    n_cap = 6 * PW.WIN
    assert pb[0, -1] >= n_cap and pb[2, -1] < 4 * PW.WIN
    want = jpk.place_fill(jnp.asarray(pb), jnp.asarray(emits),
                          jpk.window_base_rows(jnp.asarray(pb), n_cap), n_cap)
    got = place_kernel.place_fill_reference(*_port(pb, emits), n_cap)
    _same(want, got)


@pytest.mark.parametrize("lanes", PW.WIDE_LANES)
def test_window_base_rows_match_jax(lanes):
    rng = np.random.default_rng(lanes)
    q = 3 * lanes + 77
    produced = rng.integers(0, 120, (3, q))
    pb = (np.cumsum(produced, axis=1) - produced).astype(np.int32)
    n_cap = 2 * PW.WIN
    assert pb[:, -1].max() >= n_cap  # rows past n_cap, out of order with
    # the padding
    want = _script("expt_place_wide").window_base_rows_w(jnp.asarray(pb),
                                                         n_cap, lanes)
    got = PW.window_base_rows_w(torch.from_numpy(pb), n_cap, lanes)
    assert got.dtype == torch.int32
    assert np.array_equal(np.asarray(want), got.numpy())
    if lanes == PW.SLAB:
        assert np.array_equal(
            np.asarray(jpk.window_base_rows(jnp.asarray(pb), n_cap)),
            PW.window_base_rows(torch.from_numpy(pb), n_cap).numpy())


def _inline_e6_inputs():
    """The input lines of expt_place_fixed.main, run as they stand."""
    lines = inspect.getsource(_script("expt_place_fixed").main).splitlines()
    first = next(i for i, ln in enumerate(lines) if "default_rng" in ln)
    last = next(i for i, ln in enumerate(lines) if ln.strip().startswith(
        "emits ="))
    scope = {"np": np, "WIN": PW.WIN}
    exec(textwrap.dedent("\n".join(lines[first : last + 1])), scope)
    return scope["pb"], scope["emits"], scope["n_cap"], scope["b"], scope["q"]


@pytest.mark.parametrize("script", ["expt_place_wide", "expt_place2",
                                    "expt_place_narrow", "expt_place_fixed"])
def test_generators_are_the_scripts(script):
    if script == "expt_place_wide":
        args = (2, 3000)
        want = _script(script).gen_inputs(np.random.default_rng(4), *args,
                                          density=0.3, run_p=0.01)
        got = expt_place_wide.gen_inputs(np.random.default_rng(4), *args,
                                         density=0.3, run_p=0.01)
        pairs = [(want, got)]
    elif script == "expt_place2":
        pairs = [(_script(script).make_case(3, 2048, d, rf, seed=7),
                  expt_place2.make_case(3, 2048, d, rf, seed=7))
                 for _, d, rf in expt_place2.CASES]
    elif script == "expt_place_narrow":
        # one generator drawn twice, as main draws its two cases
        rj, rp = np.random.default_rng(0), np.random.default_rng(0)
        pairs = [(_script(script).gen_case(rj, 2, 3000, rf),
                  expt_place_narrow.gen_case(rp, 2, 3000, rf))
                 for _, rf in expt_place_narrow.CASES]
    else:
        pb, emits, n_cap, b, q = _inline_e6_inputs()
        pairs = [((pb, emits, n_cap), expt_place_fixed.gen_inputs(
            np.random.default_rng(0), b, q))]
    for (wpb, wem, wcap), (gpb, gem, gcap) in pairs:
        assert gpb.dtype == np.int32 and gem.dtype == np.uint32
        assert wcap == gcap
        assert np.array_equal(np.asarray(wpb, np.int32), gpb)
        assert np.array_equal(np.asarray(wem), gem)


@pytest.mark.parametrize("expt,argv", [
    (expt_place_wide, ["-b", "2", "--rows", "3000"]),
    (expt_place2, ["-b", "2", "--rows", "2048"]),
    (expt_place_narrow, ["-b", "2", "--rows", "3000"]),
    (expt_place_fixed, ["-b", "2", "--rows", "2048"]),
], ids=lambda x: getattr(x, "__name__", "").rsplit(".", 1)[-1] or None)
def test_experiment_parity_on_cpu(expt, argv):
    rows = expt.main(argv + ["--runs", "0"], device="cpu")
    assert rows and all(r["max_abs_err"] == 0 for r in rows)
    assert all(r["k2_err"] in (None, 0) and r["ms"] is None for r in rows)
    assert any(r["k2_err"] == 0 for r in rows)
    with pytest.raises(ValueError, match="CUDA"):
        expt.main(argv, device="cpu")


def test_wrappers_reject_what_the_kernels_do_not_take():
    pb = torch.zeros((1, 256), dtype=torch.int32)
    emits = torch.zeros_like(pb)
    base = PW.window_base_rows(pb, PW.WIN)
    with pytest.raises(ValueError, match="do_dma"):
        PW.place_variant(pb, emits, base, PW.WIN, do_dma=False)
    with pytest.raises(ValueError, match="n_fill"):
        PW.place_variant(pb, emits, base, PW.WIN, n_fill=7)
    with pytest.raises(ValueError, match="prec"):
        PW.place_variant(pb, emits, base, PW.WIN, prec="default")
    with pytest.raises(ValueError, match="lanes"):
        PW.place_wide(pb, emits, base, PW.WIN, lanes=64)
    with pytest.raises(ValueError, match="ns"):
        PW.place_fill_narrow(pb, emits, base, PW.WIN, ns=0)
    with pytest.raises(ValueError, match="n_cap"):
        PW.place_fill2(pb, emits, base, PW.WIN)  # n_cap % (2 WIN) != 0
    with pytest.raises(ValueError, match="multiple of 128"):
        PW.place_variant(pb[:, :200], emits[:, :200], base, PW.WIN)


# ---- E4: the grouped summed placement (benchmarks/expt_place.py) ---------

def _e4_jax(pb, emits, base, n_cap, win, g, lr_mode):
    run = _script("expt_place").make_variant(
        win, g, jax.lax.Precision.HIGHEST, False, True, lr_mode, False)
    fn = jax.jit(run.__wrapped__, static_argnames=("n_cap",))
    with pltpu.force_tpu_interpret_mode():
        out = fn(jnp.asarray(pb), jnp.asarray(emits), jnp.asarray(base),
                 n_cap=n_cap)
    return np.asarray(out).reshape(pb.shape[0], n_cap)


def _e4_crafted(rng, n_cap, q):
    """Sparse sorted rows with runs of 2 and 3 equal pb, gaps of 62 and
    100 (the fill's reach, and past it: the carry), rows at and past n_cap
    in image 1; image 0 opens on the duplicate rule's worked example."""
    inc = rng.choice([0, 1, 1, 2, 3, 5, 17, 62, 100], (2, q))
    inc[:, 40:42] = 0  # a run of 3 equal pb
    inc[:, 60] = 0  # a run of 2
    pb = np.minimum(np.cumsum(inc, axis=1) - inc + 3, n_cap + 7)
    emits = rng.integers(0, 1 << 32, (2, q), dtype=np.uint64).astype(
        np.uint32)
    pb[0, :5] = (0, 5, 5, 5, 100)
    emits[0, :5] = (7, 0xFFFF0001, 0xFFFF0002, 0x00030003, 9)
    assert pb[1, -1] >= n_cap
    return pb.astype(np.int32), emits


@pytest.mark.parametrize("lr_mode", ["cnt", "dyn", "smem"])
@pytest.mark.parametrize("win,g", [(8192, 1), (1024, 2)])
@pytest.mark.parametrize("inputs", ["generator", "crafted"])
def test_place_grouped_matches_jax(inputs, win, g, lr_mode):
    n_cap = 3 * win * g
    rng = np.random.default_rng(win + g)
    if inputs == "generator":
        pb, emits, _ = expt_place.gen_inputs(rng, 2, n_cap,
                                             128 * (n_cap // 800 + 8))
    else:
        pb, emits = _e4_crafted(rng, n_cap, 128 * (n_cap // 1600 + 4))
    tpb, temits = _port(pb, emits)
    base = expt_place.base_rows(tpb, n_cap, win, g, lr_mode)
    want = _e4_jax(pb, emits, base.numpy(), n_cap, win, g, lr_mode)
    got = PW.place_grouped(tpb, temits, base, n_cap, win=win, g=g,
                           lr_mode=lr_mode)
    _same(want, got)
    if inputs == "crafted":
        assert want[0, 5] == 0x10006


def test_place_grouped_adds_duplicates_where_k2_keeps_the_last():
    # (sum lo) | (sum hi << 16) mod 2**32: at pixel 5 the three rows give
    # lo 1 + 2 + 3 = 6 and hi 0xFFFF + 0xFFFF + 3 = 0x20001, so 0x00010006
    pb = torch.tensor([[0, 5, 5, 5, 100]], dtype=torch.int32)
    emits = words_to_torch(np.array([[7, 0xFFFF0001, 0xFFFF0002, 0x00030003,
                                      9]], np.uint32), device="cpu")
    got = words_to_numpy(PW.summed_place_reference(pb, emits, PW.WIN))
    assert got[0, 4] == 7 and got[0, 5] == 0x10006 and got[0, 68] == 0x10006
    assert got[0, 69] == 0  # past the reach of 63: the carry, 0 in step 0
    assert got[0, 100] == 9
    last = words_to_numpy(place_kernel.place_fill_reference(pb, emits,
                                                           PW.WIN))
    assert last[0, 5] == 0x00030003  # K2's rule: the run's last row


def test_place_grouped_fills_across_windows_but_not_steps():
    # G=2: a gap over the window edge inside a step fills up to 63 pixels
    # past the edge; over a step edge it takes the carry
    win, g = 1024, 2
    pb = torch.tensor([[1000, 1100, 2040, 2200]], dtype=torch.int32)
    emits = torch.tensor([[11, 22, 33, 44]], dtype=torch.int32)
    got = PW.summed_place_reference(pb, emits, 4 * win, win, g)[0]
    assert got[1024].item() == 11 and got[1063].item() == 11  # same step
    assert got[1064].item() == 0  # past the reach: the carry into step 0
    assert got[2047].item() == 33 and got[2048].item() == 33  # step 1: carry
    assert got[2199].item() == 33 and got[2200].item() == 44


def _inline_e4_inputs(b, n_cap, cap):
    """The input lines of expt_place.main at (b, n_cap, cap), run as they
    stand but for the sizes."""
    lines = inspect.getsource(_script("expt_place").main).splitlines()
    first = next(i for i, ln in enumerate(lines) if "default_rng" in ln)
    last = next(i for i, ln in enumerate(lines) if "counts[b] = c" in ln)
    block = textwrap.dedent("\n".join(lines[first : last + 1]))
    sizes = "B, n_cap, cap = 128, 2088960, 286720"
    assert sizes in block and (expt_place.B, expt_place.N_CAP,
                               expt_place.CAP) == (128, 2088960, 286720)
    scope = {"np": np}
    exec(block.replace(sizes, f"B, n_cap, cap = {b}, {n_cap}, {cap}"), scope)
    return scope["pb"], scope["em"], scope["counts"]


def test_e4_generator_is_the_script():
    want = _inline_e4_inputs(3, 6 * PW.WIN, 6144)
    got = expt_place.gen_inputs(np.random.default_rng(0), 3, 6 * PW.WIN,
                                6144)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g)


@pytest.mark.parametrize("lr_mode", ["dyn", "smem"])
def test_e4_base_rows_are_the_script(lr_mode):
    pb, _, _ = expt_place.gen_inputs(np.random.default_rng(1), 2, 4 * PW.WIN,
                                     128 * 40)
    win, g = 1024, 2
    lastpb = pb[:, 127::128]
    unit = win if lr_mode == "smem" else win * g
    bounds = (np.arange(4 * PW.WIN // unit) * unit)[None, None, :]
    want = np.sum(lastpb[:, :, None] < bounds, axis=1)
    got = expt_place.base_rows(torch.from_numpy(pb), 4 * PW.WIN, win, g,
                               lr_mode)
    assert got.dtype == torch.int32 and np.array_equal(want, got.numpy())


def test_expt_place_parity_on_cpu():
    argv = ["-b", "2", "--cap", "6144", "--n-cap", str(6 * PW.WIN)]
    rows = expt_place.main(argv + ["--runs", "0"], device="cpu")
    assert [r["max_abs_err"] for r in rows] == [None, 0]  # timing-only first
    assert rows[1]["k2_err"] == 0 and all(r["ms"] is None for r in rows)
    with pytest.raises(ValueError, match="CUDA"):
        expt_place.main(argv, device="cpu")


def test_place_grouped_rejects_what_the_kernel_does_not_take():
    pb = torch.zeros((1, 256), dtype=torch.int32)
    emits = torch.zeros_like(pb)
    base = PW.step_base_rows(pb, PW.WIN, PW.WIN)
    with pytest.raises(ValueError, match="win"):
        PW.place_grouped(pb, emits, base, PW.WIN, win=100)
    with pytest.raises(ValueError, match="n_cap"):
        PW.place_grouped(pb, emits, base, PW.WIN, g=2)
    with pytest.raises(ValueError, match="exceeds"):
        PW.place_grouped(pb, emits, base, 4 * PW.WIN, g=4)
    with pytest.raises(ValueError, match="lr_mode"):
        PW.place_grouped(pb, emits, base, PW.WIN, lr_mode="fast")
    with pytest.raises(ValueError, match="precision"):
        PW.place_grouped(pb, emits, base, PW.WIN, precision="bf16")
    with pytest.raises(ValueError, match="base_step shape"):
        PW.place_grouped(pb, emits, base, PW.WIN, win=1024, lr_mode="smem")
    with pytest.raises(ValueError, match="dtype"):
        PW.place_grouped(pb, emits, base.long(), PW.WIN)
