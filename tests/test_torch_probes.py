"""E8 and E9, the design probes of benchmarks/profile_r2.py, against the
script's own kernel bodies in interpret mode: E8's tiny_kernel as it
stands, bit-exact, and E9's place_kernel with its store written to the
squeezed (S, 128) block (``o_ref[:, :] =`` does not trace on this JAX:
"Invalid shape for swap"), within 1e-6.  On CPU tensors the wrappers
(qoipp_tpu_torch.ops.probes) take their plain versions; the kernels run on
the card (tests/test_torch_cuda.py, chip_smoke.py).  Also: E9's inputs
against the script's lines, the port's profile_r2 main at a tiny size,
and the card's latency probe (``dep_chain``, no TPU kernel's counterpart):
it refuses the CPU, and its plain loop wraps 32-bit words."""

import importlib.util
import inspect
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from qoipp_tpu_torch.benchmarks import profile_r2
from qoipp_tpu_torch.convert import words_to_numpy, words_to_torch
from qoipp_tpu_torch.ops import probes

torch.set_num_threads(1)

_LOADED = {}


def _main_lines():
    """The source lines of benchmarks/profile_r2.py's main (its probes are
    nested there), loaded by path once per process."""
    if not _LOADED:
        path = (Path(__file__).resolve().parent.parent / "benchmarks"
                / "profile_r2.py")
        spec = importlib.util.spec_from_file_location("benchmarks_profile_r2",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED["lines"] = inspect.getsource(mod.main).splitlines()
    return _LOADED["lines"]


def _nested(name, scope, replace=None):
    """Define main's nested function ``name`` in ``scope``, with the line
    pairs of ``replace`` swapped in."""
    lines = _main_lines()
    first = next(i for i, ln in enumerate(lines)
                 if ln.strip().startswith(f"def {name}("))
    indent = len(lines[first]) - len(lines[first].lstrip())
    last = next(i for i in range(first + 1, len(lines))
                if lines[i].strip() and
                len(lines[i]) - len(lines[i].lstrip()) <= indent)
    block = textwrap.dedent("\n".join(lines[first:last]))
    for old, new in replace or ():
        assert old in block
        block = block.replace(old, new)
    exec(block, scope)
    return scope[name]


def test_grid_step_matches_tiny_kernel():
    steps = 24
    x = np.random.default_rng(0).integers(0, 1 << 32, (steps, 8, 128),
                                          dtype=np.uint64).astype(np.uint32)
    x[0, 0, :5] = 0xFFFFFFFF
    kernel = _nested("tiny_kernel", {"jnp": jnp})
    want = pl.pallas_call(
        kernel, grid=(steps,),
        in_specs=[pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((steps, 8, 128), jnp.uint32),
        interpret=True)(jnp.asarray(x))
    got = probes.grid_step_probe(words_to_torch(x, device="cpu"))
    assert np.array_equal(np.asarray(want), words_to_numpy(got))
    assert not words_to_numpy(got)[0, 0, :5].any()  # 0xFFFFFFFF wraps to 0


@pytest.mark.parametrize("sort", [True, False])
def test_onehot_place_matches_place_kernel(sort):
    k, s, nblk = profile_r2.K, probes.S, 48
    rng = np.random.default_rng(7 + sort)
    t = rng.integers(0, s * 128, (nblk, k)).astype(np.int32)
    if sort:
        t.sort(axis=1)
    t[1, :40] = 77  # one bin hit 40 times
    v = rng.random((nblk, k)).astype(np.float32)
    kernel = _nested("place_kernel", {"jnp": jnp, "jax": jax, "K": k, "S": s},
                     [("o_ref[:, :] = jnp.dot", "o_ref[0] = jnp.dot")])
    want = pl.pallas_call(
        kernel, grid=(nblk,),
        in_specs=[pl.BlockSpec((1, k // 128, 128), lambda i: (i, 0, 0))] * 2,
        out_specs=pl.BlockSpec((1, s, 128), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((nblk, s, 128), jnp.float32),
        interpret=True)(jnp.asarray(t.reshape(nblk, k // 128, 128)),
                        jnp.asarray(v.reshape(nblk, k // 128, 128)))
    got = probes.onehot_place(torch.from_numpy(t), torch.from_numpy(v), s)
    assert got.shape == (nblk, s, 128) and got.dtype == torch.float32
    assert np.abs(np.asarray(want) - got.numpy()).max() <= 1e-6
    assert got[1, 0, 77].item() == pytest.approx(float(v[1, :40].sum()),
                                                 abs=1e-5)


def test_onehot_place_drops_targets_outside_the_bins():
    t = torch.tensor([[-1, 0, 17 * 128, 17 * 128 - 1, 5]], dtype=torch.int32)
    v = torch.tensor([[1.0, 2.0, 4.0, 8.0, 16.0]])
    got = probes.onehot_place(t, v).reshape(-1)
    assert got[0].item() == 2.0 and got[-1].item() == 8.0
    assert got[5].item() == 16.0 and got.sum().item() == 26.0


def test_onehot_inputs_are_the_script():
    lines = _main_lines()
    first = next(i for i, ln in enumerate(lines) if ln.strip().startswith(
        "tt = np.random.default_rng(1)"))
    scope = {"np": np, "S": probes.S, "K": profile_r2.K,
             "nblk": profile_r2.NBLK}
    exec(textwrap.dedent("\n".join(lines[first : first + 3])), scope)
    t, v = profile_r2.onehot_inputs("cpu")
    assert np.array_equal(scope["tt"], t.numpy())
    assert np.array_equal(scope["vv"], v.numpy())
    assert (profile_r2.K, profile_r2.NBLK, probes.S) == (2048, 2048, 17)


def test_profile_r2_parity_on_cpu():
    argv = ["--batch", "2", "--width", "48", "--height", "40", "--steps",
            "3", "5", "--blocks", "16"]
    out = profile_r2.main(argv + ["--runs", "0"], device="cpu")
    assert [r["steps"] for r in out["grid_step"]] == [3, 5]
    assert all(r["max_abs_err"] == 0 for r in out["grid_step"])
    assert out["onehot_place"]["max_abs_err"] <= 1e-6
    assert out["chunks"]["min"] > 0 and out["stage_ms"]["replay"] is None
    with pytest.raises(ValueError, match="CUDA"):
        profile_r2.main(argv, device="cpu")


def test_probe_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="steps"):
        probes.grid_step_probe(torch.zeros((4, 8, 64), dtype=torch.int32))
    t = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        probes.onehot_place(t, torch.zeros((2, 8)))
    with pytest.raises(ValueError, match="s must be"):
        probes.onehot_place(t, torch.zeros((2, 16)), s=0)


def test_dep_chain_measures_only_the_card():
    with pytest.raises(ValueError, match="CUDA device"):
        probes.dep_chain("cpu", 1)


def test_dep_chain_reference_wraps_32_bit_words():
    x, a, b = np.uint32(1), np.uint32(0x9E3779B9), np.uint32(0x7F4A7C15)
    with np.errstate(over="ignore"):
        for _ in range(2 * probes.CHAIN_UNROLL):
            x = (x + a) ^ b
    assert probes.dep_chain_reference(2) == int(x)
