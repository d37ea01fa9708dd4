"""E8, E9: the design probes of ``benchmarks/profile_r2.py`` (csrc/probes.cu).

E8, ``grid_step_probe``: x + 1 over (steps, 8, 128) words, one block per
step, the probe of the per-block (on the TPU per-grid-step) overhead.  Words
are int32 holding the uint32 bits (torch has no uint32 ``+``), so
0xFFFFFFFF wraps to 0.

E9, ``onehot_place``: per block of K targets t in [0, s * 128) and float32
values v, out[t // 128, t % 128] += v, the probe of one-hot matrix-unit
placement.  On Hopper it is a scatter-add (one block per row of targets,
the bins in shared memory).  The sums are taken in float64 and rounded to
float32 once, in the kernel and in the plain version alike, so neither
depends on the order in which duplicates add; against a float32 sum in
another order (the TPU's one-hot product, which also rounds v to bf16 at
its default precision, or ``torch.scatter_add_``) they agree to 1e-6 at
the probe's sizes.  Targets outside the bins are dropped, as the one-hot
product drops them.

CPU tensors take the plain versions; CUDA tensors launch the kernels and
raise on any failure.

``dep_chain`` is no TPU kernel's counterpart: it measures the card (the
latency of one dependent integer instruction and the SM clock) for the
replay chain's bound.  It needs a CUDA device; ``dep_chain_reference``
gives the x its loop must end with.
"""

from __future__ import annotations

import torch

from .. import kernels
from .place_window import _require

STEP_SHAPE = (8, 128)  # one TPU grid step's block, one CUDA block here
S = 17  # the probe's stripes of 128 bins
MAX_S = 227  # 227 * 128 float64 bins fill a block's 227 KB of shared memory
CHAIN_UNROLL = 64  # dep_chain's steps a round
CHAIN_STEP_OPS = 2  # its dependent instructions a step: an add, a xor


def grid_step_reference(x):
    """Plain version of E8."""
    return x + 1


def grid_step_probe(x):
    """E8: (steps, 8, 128) int32 -> x + 1 (wrapping), one block per step."""
    _require(x.dim() == 3 and tuple(x.shape[1:]) == STEP_SHAPE,
             f"x shape {tuple(x.shape)}, expected (steps, 8, 128)")
    if x.device.type == "cpu":
        return grid_step_reference(x)
    kernels.check(x, "x", torch.int32, tuple(x.shape), x.device)
    y = torch.empty_like(x)
    if x.shape[0]:
        kernels.launch("grid_step", "qk_grid_step", x.device, x.data_ptr(),
                       y.data_ptr(), x.shape[0])
    return y


def onehot_place_reference(t, v, s: int = S):
    """Plain version of E9: a float64 scatter-add over the flattened bins,
    rounded to float32."""
    nblk, _ = t.shape
    nbins = s * 128
    at = torch.where((t >= 0) & (t < nbins), t, nbins).long()
    out = torch.zeros((nblk, nbins + 1), dtype=torch.float64, device=t.device)
    out.scatter_add_(1, at, v.double())
    return out[:, :nbins].float().view(nblk, s, 128)


def onehot_place(t, v, s: int = S):
    """E9: t (nblk, K) int32 targets, v (nblk, K) float32 -> (nblk, s, 128)
    float32 with out[i, t // 128, t % 128] += v."""
    _require(t.dim() == 2 and tuple(v.shape) == tuple(t.shape),
             f"t {tuple(t.shape)} and v {tuple(v.shape)}: expected one "
             "(nblk, K) shape")
    _require(1 <= s <= MAX_S, f"s must be in 1..{MAX_S}, got {s}")
    if t.device.type == "cpu":
        return onehot_place_reference(t, v, s)
    nblk, k = t.shape
    dev = t.device
    kernels.check(t, "t", torch.int32, (nblk, k), dev)
    kernels.check(v, "v", torch.float32, (nblk, k), dev)
    out = torch.empty((nblk, s, 128), dtype=torch.float32, device=dev)
    if nblk:
        kernels.launch("onehot_place", "qk_onehot_place", dev, t.data_ptr(),
                       v.data_ptr(), out.data_ptr(), nblk, k, s * 128)
    return out


# dep_chain's x, a, b: arguments, not constants in the kernel, so that
# the compiler cannot fold the chain
CHAIN_X, CHAIN_A, CHAIN_B = 1, 0x9E3779B9, 0x7F4A7C15


def dep_chain_reference(rounds: int) -> int:
    """The x that ``dep_chain`` ends with: rounds x 64 steps of
    x = (x + a) ^ b on 32-bit words."""
    x, a, b = CHAIN_X, CHAIN_A, CHAIN_B
    for _ in range(rounds * CHAIN_UNROLL):
        x = ((x + a) & 0xFFFFFFFF) ^ b
    return x


def dep_chain(device, rounds: int) -> tuple:
    """One thread's chain of rounds x 64 steps of x = (x + a) ^ b on
    ``device``: (SM cycles, nanoseconds, final x).  Cycles over rounds x 64
    x CHAIN_STEP_OPS is the latency of a dependent integer instruction;
    cycles over nanoseconds the SM clock while the loop ran."""
    dev = torch.device(device)
    _require(dev.type == "cuda", "dep_chain measures the card: it needs a "
             f"CUDA device, got {dev}")
    _require(rounds >= 1, f"rounds must be at least 1, got {rounds}")
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    kernels.launch("dep_chain", "qk_dep_chain", dev, out.data_ptr(),
                   CHAIN_X, CHAIN_A, CHAIN_B, rounds)
    cycles, ns, xo = out.tolist()
    return cycles, ns, xo & 0xFFFFFFFF
