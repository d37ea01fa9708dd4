"""E2-E6: the windowed placement experiments (csrc/place_window.cu: E2;
csrc/place_fill2.cu: E3; csrc/place_grouped.cu: E4; csrc/place_narrow.cu:
E5; csrc/place_variant.cu: E6).

Four TPU layout experiments of the JAX package's K2 (``benchmarks/``
``expt_place_wide``, ``expt_place2``, ``expt_place_narrow``,
``expt_place_fixed``) compute one function, the **windowed placement**:
per image, row r writes iff pb[r+1] > pb[r] (pb[Q] := n_cap) and
pb[r] < n_cap, and puts emits[r] at pixel pb[r].  Pixels are cut into
windows of WIN.  Inside a window a pixel takes the word of the nearest
writer at or to its left in the same window, at most 2**n_fill - 1 away;
any other pixel takes the carry, the previous window's last output (0 in
the first window).  With place=False (E6's ``do_slabs=False``) nothing
writes and every pixel reads 0.  With n_fill=6 this is the JAX K2's
whole output, and the function of the port's K2 (ops/place_kernel.py).

Each wrapper keeps its experiment's signature and asserts.  CPU tensors
take the plain version; CUDA tensors launch the experiment's kernel,
which visits the candidate rows that ``base_step`` (window_base_rows, or
window_base_rows_w for E2) names, and raises on any failure.  Words are
int32 tensors holding the uint32 bits.  Knobs that only shaped the TPU
kernel (E2's ``hoist``, E6's ``prec``) are accepted and launch the same
kernel.

The plain version is K2's, place_fill_reference, which with the defaults
is the JAX K2's whole output; it and WIN and ``writers`` live in
ops/place_kernel.py.

E4 (``benchmarks/expt_place.py``) computes another function, the
**grouped summed placement** (summed_place_reference): rows that share a
pixel add where the windowed placement keeps the last, and the fill runs
over steps of g windows; ``place_grouped`` is its wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .place_kernel import WIN, fill_units, place_fill_reference, writers

SW = WIN // 128  # 128-pixel stripes per window
SLAB = 128  # candidate rows per base_step unit
WIDE_LANES = (128, 256, 512)  # E2's candidate widths
PRECS = ("highest", "bytes4")  # E6's MXU precisions on the TPU
LR_MODES = ("cnt", "dyn", "smem", "static")  # E4's candidate-row modes
DOT_PRECISIONS = ("default", "high", "highest")  # E4's MXU precisions
MAX_STEP = 16384  # csrc/place_grouped.cu kMaxStep: pixels per E4 block
REACH = 63  # E4's fill reach: six log-shift passes


def launch_shape(name: str, win: int = WIN, g: int = 1,
                 lanes: int = 256) -> tuple[int, int]:
    """(threads a block, resident blocks an SM) of E2 (``name``
    "place_wide", at lanes), E3 ("place_fill2"), E5 ("place_fill_narrow"),
    E6 ("place_variant", the full variant) or E4 ("place_grouped", lr_mode
    dyn at win and g), read from the built library (the CUDA occupancy
    calculator); builds the kernels on first use."""
    lib = kernels.library()
    threads = ctypes.c_int()
    if name == "place_grouped":
        n = lib.qk_place_grouped_occupancy(win, g, ctypes.byref(threads))
    elif name == "place_wide":
        n = lib.qk_place_wide_occupancy(lanes, ctypes.byref(threads))
    else:
        entry = {"place_fill2": "qk_place_fill2_occupancy",
                 "place_fill_narrow": "qk_place_narrow_occupancy",
                 "place_variant": "qk_place_variant_occupancy"}[name]
        n = getattr(lib, entry)(ctypes.byref(threads))
    if n <= 0:
        raise RuntimeError(f"{name}: occupancy query failed: CUDA error {-n}")
    return threads.value, n


def _slabs_below(pb, lanes: int, edges, pad: int):
    """(B, len(edges)) int32: per edge, the number of ``lanes``-row slabs
    whose last pb is below it (Q padded to ``lanes`` with pb = pad)."""
    pad_q = (-pb.shape[1]) % lanes
    if pad_q:
        pb = torch.nn.functional.pad(pb, (0, pad_q), value=pad)
    lastpb = pb[:, lanes - 1 :: lanes]
    return (lastpb[:, :, None] < edges).sum(dim=1, dtype=torch.int32)


def window_base_rows_w(pb, n_cap: int, lanes: int, pad=None):
    """(B, n_cap // WIN + 1) int32: the number of ``lanes``-row slabs whose
    last pb is below w * WIN, for every window edge w (Q padded to
    ``lanes`` with pb = pad, n_cap by default): window w's candidate rows
    are slabs base[w] to base[w + 1], both included."""
    edges = torch.arange(n_cap // WIN + 1, dtype=pb.dtype,
                         device=pb.device) * WIN
    return _slabs_below(pb, lanes, edges, n_cap if pad is None else pad)


def step_base_rows(pb, n_cap: int, step: int):
    """(B, n_cap // step) int32: E4's base_step, the number of 128-row
    slabs whose last pb is below j * step for every step j (Q padded with
    pb = n_cap).  step = win * g names each step's first candidate slab;
    step = win each window's, for lr_mode "smem"."""
    edges = torch.arange(n_cap // step, dtype=pb.dtype,
                         device=pb.device) * step
    return _slabs_below(pb, SLAB, edges, n_cap)


def window_base_rows(pb, n_cap: int):
    """window_base_rows_w in SLAB-row units (the JAX K2's base_step)."""
    return window_base_rows_w(pb, n_cap, SLAB)


def _require(ok: bool, what: str) -> None:
    """The experiments' asserts, as checks that stay under -O."""
    if not ok:
        raise ValueError(what)


def _grouped_checks(n_cap: int, win: int, g: int) -> int:
    """E4's asserts; returns the step, win * g pixels."""
    _require(win > 0 and win % 128 == 0,
             f"win {win} is not a positive multiple of 128")
    _require(g >= 1, f"g must be at least 1, got {g}")
    step = win * g
    _require(n_cap % step == 0, f"n_cap {n_cap} is not a multiple of win "
             f"* g = {step}")
    _require(step <= MAX_STEP, f"win * g = {step} exceeds {MAX_STEP}")
    return step


def summed_place_reference(pb, emits, n_cap: int, win: int = WIN,
                           g: int = 1):
    """Plain version of E4, the grouped summed placement.

    A row places at pixel pb iff 0 <= pb < n_cap; there is no next-row
    test.  The rows that share a pixel add their low 16-bit halves and
    their high halves as integers: the pixel's word is (sum lo) | (sum hi
    << 16) mod 2**32.  This equals the TPU kernel's float32 one-hot sums
    while at most 256 rows share a pixel (256 * 65535 < 2**24).  Within
    each step of g * win pixels a pixel takes the word of the nearest
    placed pixel at or to its left in the step, at most 63 away, else the
    carry: the previous step's last output, 0 at the start of each image.
    pb, emits (B, Q) int32 -> (B, n_cap) int32."""
    step = _grouped_checks(n_cap, win, g)
    b, _ = pb.shape
    dev = pb.device
    ok = (pb >= 0) & (pb < n_cap)
    at = torch.where(ok, pb, n_cap).long()  # column n_cap collects the rest
    e = emits.long()
    sums = [torch.zeros((b, n_cap + 1), dtype=torch.int64, device=dev)
            .scatter_add_(1, at, half)[:, :n_cap]
            for half in (e & 0xFFFF, (e >> 16) & 0xFFFF)]
    word = (sums[0] | (sums[1] << 16)) & 0xFFFFFFFF
    word = torch.where(word >= 1 << 31, word - (1 << 32), word).to(
        torch.int32)
    del sums
    placed = torch.zeros((b, n_cap + 1), dtype=torch.bool, device=dev)
    placed.scatter_(1, at, True)
    px = torch.arange(n_cap, dtype=torch.int32, device=dev)
    pos = torch.where(placed[:, :n_cap], px, -1)
    return fill_units(pos, word, step, REACH)


def _launch(name, entry, pb, emits, base_step, n_cap, units_per_image,
            *extra, nbase=None):
    """Check the inputs of a CUDA call, allocate the output and the
    look-back status (one word per unit of windows, then the ticket
    counter), and launch ``entry`` with ``extra`` int arguments.  base_step
    has ``nbase`` entries per image (n_cap // WIN + 1 by default)."""
    b, q = pb.shape
    dev = pb.device
    _require(nbase is not None or n_cap % WIN == 0,
             f"n_cap {n_cap} is not a multiple of {WIN}")
    kernels.check(pb, "pb", torch.int32, (b, q), dev)
    kernels.check(emits, "emits", torch.int32, (b, q), dev)
    kernels.check(base_step, "base_step", torch.int32,
                  (b, nbase or n_cap // WIN + 1), dev)
    if n_cap >= 1 << 31:
        raise ValueError(f"n_cap {n_cap} does not fit int32 offsets")
    out = torch.empty((b, n_cap), dtype=torch.int32, device=dev)
    status = torch.zeros(b * units_per_image + 1, dtype=torch.int64,
                         device=dev)
    if b and n_cap:
        kernels.launch(name, entry, dev, pb.data_ptr(), emits.data_ptr(),
                       base_step.data_ptr(), out.data_ptr(),
                       status.data_ptr(), b, q, n_cap, *extra)
    return out


def place_wide(pb, emits, base_step, n_cap: int, lanes: int = 256,
               hoist: bool = True):
    """E2: windowed placement over ``lanes``-wide candidate slabs.

    pb (B, Q) int32 nondecreasing; emits (B, Q) int32; base_step from
    window_base_rows_w(pb, n_cap, lanes); n_cap % WIN == 0.  Rows past Q
    read as pb = n_cap, the JAX wrapper's padding.  ``lanes`` is the slab
    that base_step counts; ``hoist`` shaped the TPU kernel's vector code
    only.  Returns (B, n_cap) int32."""
    b, _ = pb.shape
    _require(tuple(base_step.shape) == (b, n_cap // WIN + 1),
             f"base_step shape {tuple(base_step.shape)}")
    _require(lanes in WIDE_LANES,
             f"lanes must be one of {WIDE_LANES}, got {lanes}")
    if pb.device.type == "cpu":
        return place_fill_reference(pb, emits, n_cap)
    return _launch("place_wide", "qk_place_wide", pb, emits, base_step,
                   n_cap, n_cap // WIN, lanes)


def place_fill2(pb, emits, base_step, n_cap: int):
    """E3: windowed placement, two windows per block from one row range;
    the fill searches past 7 pixels back only in a window whose longest
    chunk exceeds 8 pixels.  Q % 128 == 0, n_cap % (2 WIN) == 0,
    base_step from window_base_rows.  Returns (B, n_cap) int32."""
    b, q = pb.shape
    _require(q % 128 == 0 and n_cap % (2 * WIN) == 0,
             f"Q {q} is not a multiple of 128 or n_cap {n_cap} of {2 * WIN}")
    _require(tuple(base_step.shape) == (b, n_cap // WIN + 1),
             f"base_step shape {tuple(base_step.shape)}")
    if pb.device.type == "cpu":
        return place_fill_reference(pb, emits, n_cap)
    return _launch("place_fill2", "qk_place_fill2", pb, emits, base_step,
                   n_cap, n_cap // (2 * WIN))


def place_fill_narrow(pb, emits, base_step, n_cap: int, ns: int = 4):
    """E5: windowed placement where each 128-row group whose writers span
    at most ``ns`` stripes of 128 pixels is written output-driven (the
    span's mask words by warp reductions), and wider groups row-driven.
    Any Q (16-byte row loads where Q % 4 == 0), base_step from
    window_base_rows.  Returns (B, n_cap) int32."""
    _require(1 <= ns <= SW, f"ns must be in 1..{SW}, got {ns}")
    if pb.device.type == "cpu":
        return place_fill_reference(pb, emits, n_cap)
    return _launch("place_fill_narrow", "qk_place_narrow", pb, emits,
                   base_step, n_cap, n_cap // WIN, ns)


def place_variant(pb, emits, base_step, n_cap: int, do_dma: bool = True,
                  do_slabs: bool = True, n_fill: int = 6,
                  prec: str = "highest"):
    """E6: the production placement with stages knocked out.  do_dma=False
    reads no candidate rows, do_slabs=False writes none (every pixel 0),
    n_fill (0-6) cuts the fill's reach to 2**n_fill - 1; ``prec`` chose the
    TPU's MXU precision only.  Q % 128 == 0, base_step from
    window_base_rows.  Returns (B, n_cap) int32."""
    _require(pb.shape[1] % SLAB == 0,
             f"Q {pb.shape[1]} is not a multiple of {SLAB}")
    _require(0 <= n_fill <= 6, f"n_fill must be in 0..6, got {n_fill}")
    _require(prec in PRECS, f"prec must be one of {PRECS}, got {prec!r}")
    _require(do_dma or not do_slabs,
             "do_slabs without do_dma places rows that were never read")
    if pb.device.type == "cpu":
        return place_fill_reference(pb, emits, n_cap, n_fill, do_slabs)
    return _launch("place_variant", "qk_place_variant", pb, emits, base_step,
                   n_cap, n_cap // WIN, int(do_dma), int(do_slabs), n_fill)


def place_grouped(pb, emits, base_step, n_cap: int, win: int = WIN,
                  g: int = 1, lr_mode: str = "dyn",
                  static_inputs: bool = False, precision: str = "highest",
                  fuse_dot: bool = False, emit_whole: bool = True):
    """E4: the grouped summed placement (summed_place_reference) over
    steps of g windows of ``win`` pixels, one block per step.

    pb (B, Q) int32 nondecreasing; emits (B, Q) int32; base_step int16 or
    int32 from step_base_rows(pb, n_cap, win * g), or (lr_mode "smem")
    step_base_rows(pb, n_cap, win).  The kernel visits every candidate slab
    of a window, never stopping at the TPU kernel's CBR / LENR slabs:
      "cnt":    win / 128 + 2 slabs from the first one (counted in the
                kernel), then on while rows fall in the window;
      "dyn":    only the slabs that intersect the window (from the first
                whose last pb reaches the window to the last whose first
                pb lies below its end, both counted in the kernel);
      "smem":   like "cnt" from base_step's per-window slab;
      "static", and static_inputs=True: timing only, as on the TPU: every
                window reads a fixed row range (win / 128 + 2 slabs from the
                step's block; with static_inputs the first g * win / 128 +
                16 slabs of the image), so the output is right only where
                that range holds every row of the window.
    ``precision``, ``fuse_dot`` and ``emit_whole`` shaped the TPU kernel's
    matrix-unit dots only and launch the same kernel.  CPU tensors take the
    plain version.  Returns (B, n_cap) int32."""
    b, _ = pb.shape
    step = _grouped_checks(n_cap, win, g)
    _require(lr_mode in LR_MODES,
             f"lr_mode must be one of {LR_MODES}, got {lr_mode!r}")
    _require(precision in DOT_PRECISIONS,
             f"precision must be one of {DOT_PRECISIONS}, got {precision!r}")
    nbase = n_cap // (win if lr_mode == "smem" else step)
    _require(tuple(base_step.shape) == (b, nbase),
             f"base_step shape {tuple(base_step.shape)}, expected "
             f"{(b, nbase)}")
    _require(base_step.dtype in (torch.int16, torch.int32),
             f"base_step dtype {base_step.dtype}")
    if pb.device.type == "cpu":
        return summed_place_reference(pb, emits, n_cap, win, g)
    return _launch("place_grouped", "qk_place_grouped", pb, emits,
                   base_step.to(torch.int32), n_cap, n_cap // step, nbase,
                   win, g, LR_MODES.index(lr_mode), int(static_inputs),
                   nbase=nbase)
