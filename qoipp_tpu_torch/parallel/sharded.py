"""Sharded codec pipelines: data-parallel batches and sequence-parallel
single-image decode and encode over a device mesh.

The port of ``qoipp_tpu.parallel.sharded``.  Each function returned here
runs on every rank of the mesh, takes this rank's block of the input
(``mesh.local_rows``) and returns this rank's block of the output; the
caller gathers blocks where it wants them whole.

DP: images shard over the ``data`` axis; each rank runs BatchPipeline (K1
and K2 to decode, K3 and K4 to encode) on its images.  The only exchange
is a checksum and the encoder's overflow flags.

SP decode: one stream's byte rows shard over the ``seq`` axis, each rank
holding ``tiles_per_device`` tiles.  Each round replays the rank's tiles
as K5 lanes from guessed in-states, passes its last tile's out-state to
the next rank, propagates the seam state through the rank's tiles from
it (rank 0 from the decoder's initial state) and stops when no rank's
guess changed.  After round r the first r tiles' in-states are exact, so
n_tiles + 1 rounds always suffice; INDEX-heavy streams take that many.

SP encode: one image's pixels shard over ``seq``; the state entering each
shard is a closed-form function of the pixels before it (the previous
shard's last pixel; runs and table by folding per-shard summaries, as
``ops.device_stream.lane_carries`` folds its lanes), so every shard
encodes at once (``ops.encode.encode_rows``: E1, K3, K4), the last
closing the stream.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..convert import resolve_device
from ..ops import decode as dec_ops
from ..ops import replay_kernel as rk
from ..ops.bitops import START_PIXEL_PACKED
from ..ops.device_stream import fold_summaries, lane_summaries
from ..ops.encode import TILE, encode_rows
from . import mesh as mesh_mod

_U32 = 1 << 32


# --------------------------------------------------------------------------
# Data-parallel batch codec
# --------------------------------------------------------------------------


def make_dp_decode(pipeline, mesh, axis="data"):
    """fn(streams (b, l_cap) uint8, sizes (b,)) -> (packed (b, n_cap) int32,
    checksum): the rank's images through pipeline.decode_packed, and the
    uint32 sum mod 2^32 of every rank's whole output along ``axis`` (an
    int64 0-d tensor, the same on every rank)."""
    def dp_decode(streams, sizes):
        packed = pipeline.decode_packed(streams, sizes)
        local = ((packed.to(torch.int64) & 0xFFFFFFFF).sum() % _U32)
        total = mesh_mod.all_reduce(mesh, local.reshape(1), axis)
        return packed, total[0] % _U32

    return dp_decode


def make_dp_encode(pipeline, mesh, axis="data"):
    """fn(packed (b, nb) int32) -> (streams (b, out_cap) uint8, lengths
    (b,)): the rank's images through the pipeline's encoder.  The overflow
    flags are gathered along ``axis``, so that every rank raises the same
    ValueError, naming the global indices of the images over the cap."""
    def dp_encode(packed):
        streams, lengths, ok = pipeline.encode_packed_checked(packed)
        ok_all = mesh_mod.all_gather(mesh, ok.to(torch.int32), axis)
        if not bool(ok_all.all()):
            bad = torch.nonzero(ok_all.reshape(-1) == 0).flatten().tolist()
            raise ValueError(
                f"dp_encode: images {bad} exceed max_encode_len; rebuild the "
                "pipeline with a larger cap (worst_size) for these images")
        return streams, lengths

    return dp_encode


# --------------------------------------------------------------------------
# Sequence-parallel single-image decode
# --------------------------------------------------------------------------


def make_sp_decode(mesh, qb: int, tiles_per_device: int, axis="seq",
                   with_rounds: bool = False, device=None):
    """Sequence-parallel byte-domain replay of one stream of qb rows
    (``ops.decode.fields_dense_batch``'s (meta, val)), qb a multiple of
    the ranks along ``axis`` times tiles_per_device.

    Returns fn(meta, val) of this rank's (qb / n_dev,) int32 block of rows
    -> (emits, prevs[, rounds]): each row's emitted pixel word and its
    prev before the step, (qb / n_dev,) int32 in row order, bit-exact with
    the sequential decode (``ops.decode.expand_pixels`` turns the gathered
    blocks into pixels), and with ``with_rounds`` the number of fixpoint
    rounds.  ``device`` (None: "cuda") holds the blocks."""
    dev = resolve_device(device)
    n_dev = mesh_mod.axis_size(mesh, axis)
    if qb % (n_dev * tiles_per_device):
        raise ValueError(f"qb {qb} does not split into {n_dev} x "
                         f"{tiles_per_device} tiles")
    s_local = tiles_per_device
    heads = torch.zeros(s_local, dtype=torch.bool, device=dev)
    heads[0] = True
    max_rounds = n_dev * s_local + 2

    def sp_decode(meta, val):
        my = mesh_mod.axis_index(mesh, axis)
        meta_t = dec_ops.lane_major_tiles(meta, s_local)
        val_t = dec_ops.lane_major_tiles(val, s_local)
        init = dec_ops.true_init_row(dev)
        # START on every tile, the seeded table on the stream's first only
        in_p, in_s = dec_ops.scan_guess(s_local, my == 0, dev)
        rounds = 0
        while True:
            emits, out_p, out_s, pupd, swr = rk.replay_batch_summary(
                meta_t, val_t, in_p, in_s)
            # this round's out-state of my last tile -> the next rank
            last = torch.cat([out_p[:, -1], out_s[:, -1]])
            states = mesh_mod.all_gather(mesh, last, axis)
            base = init if my == 0 else states[my - 1]
            want_p, want_s, _ = dec_ops.propagate(heads, out_p, out_s, pupd,
                                                  swr, base)
            same = ((want_p == in_p).all() & (want_s == in_s).all()).to(
                torch.int32).reshape(1)
            rounds += 1
            done = mesh_mod.all_reduce(mesh, same, axis, dist.ReduceOp.MIN)
            # emits came from in_p/in_s: at the fixpoint they are exact;
            # the cap is never what ends the loop (make_sp_decode's bound)
            if bool(done[0]) or rounds >= max_rounds:
                break
            in_p, in_s = want_p, want_s
        emits_q = emits.T.reshape(-1)
        prevs_q = torch.cat([in_p[0, :1], emits_q[:-1]])
        if with_rounds:
            return emits_q, prevs_q, rounds
        return emits_q, prevs_q

    return sp_decode


# --------------------------------------------------------------------------
# Sequence-parallel single-image encode
# --------------------------------------------------------------------------


def make_sp_encode(mesh, n_local: int, channels: int, axis="seq",
                   device=None):
    """Sequence-parallel encode of ONE image whose packed pixels shard over
    ``axis`` in contiguous blocks of n_local (a multiple of 64); every
    shard is full but the last.

    Returns fn(packed (n_local,) int32 of this rank's shard, n_px_last:
    the valid pixels of the last shard, 1..n_local) -> (body (w_cap,)
    uint8, length () int32).  The stream is the header, then every rank's
    body[:length] in rank order; the last rank's body ends with the
    pending run byte and the end marker.  ``device`` (None: "cuda") holds
    the shard."""
    dev = resolve_device(device)
    n_dev = mesh_mod.axis_size(mesh, axis)
    if n_local % TILE:
        raise ValueError(f"n_local {n_local} is not a multiple of {TILE}")

    def sp_encode(packed, n_px_last: int):
        if not 0 < n_px_last <= n_local:
            raise ValueError(f"n_px_last {n_px_last} is outside 1..{n_local}")
        my = mesh_mod.axis_index(mesh, axis)
        is_last = my == n_dev - 1
        n_px = n_px_last if is_last else n_local
        v = torch.tensor([n_px], dtype=torch.int32, device=dev)
        # prev: the previous shard's last pixel
        lasts = mesh_mod.all_gather(mesh, packed[-1:], axis)
        prev_in = (torch.full((1,), START_PIXEL_PACKED, dtype=torch.int32,
                              device=dev) if my == 0 else lasts[my - 1])
        # run and table: every shard's summary, folded in shard order
        summ = mesh_mod.all_gather(
            mesh, lane_summaries(packed[None], v, prev_in)[0], axis)
        run_in, seen_in = fold_summaries(
            summ, torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros(64, dtype=torch.int32, device=dev))
        # the last shard's stream closes with the pending run byte and the
        # end marker
        out, lens, *_ = encode_rows(
            packed[None], n_px, channels, carry=(
                prev_in, run_in[my : my + 1],
                seen_in[:, my : my + 1].contiguous()), close=is_last)
        return out[0], lens[0]

    return sp_encode


def sp_shard(packed, mesh, axis="seq"):
    """One image's (n_px,) int32 packed pixels as make_sp_encode takes them:
    padded to n_dev shards of n_local (the smallest multiple of 64 that
    n_dev shards cover n_px with).  Returns (this rank's shard (n_local,),
    n_local, n_px_last: the valid pixels of the last shard)."""
    n_px, n_dev = packed.shape[0], mesh_mod.axis_size(mesh, axis)
    n_local = -(-n_px // (n_dev * TILE)) * TILE
    n_last = n_px - (n_dev - 1) * n_local
    if n_last <= 0:
        raise ValueError(f"{n_px} px leave the last of {n_dev} shards of "
                         f"{n_local} empty")
    padded = torch.nn.functional.pad(packed, (0, n_dev * n_local - n_px))
    return (mesh_mod.local_rows(padded, mesh, axis).contiguous(), n_local,
            n_last)


def gather_stream(mesh, body, length, axis="seq") -> bytes:
    """The stream body that make_sp_encode's ranks wrote, on every rank:
    each rank's body[:length], gathered and joined in rank order."""
    bodies = mesh_mod.all_gather(mesh, body, axis).cpu().numpy()
    lengths = mesh_mod.all_gather(mesh, length.reshape(1), axis).flatten()
    return b"".join(bodies[s, : int(n)].tobytes()
                    for s, n in enumerate(lengths))
