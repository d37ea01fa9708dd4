"""The multi-rank dry run: one full sharded pipeline step on every rank of
a local job, each result held to the oracle.

The port of ``__graft_entry__.dryrun_multichip``, at its shapes: on a
(world / 2, 2) mesh (world, 1 for an odd world), dp decode of 2 * world
256x128 RGB images with the checksum, dp re-encode of the decoded pixels,
and, where seq has 2 ranks, sp decode of one 740x65 RGB stream at
tiles_per_device=4 and sp encode of its pixels, whose last shard is
uneven.  Every rank raises on any difference from the oracle.

    python -m qoipp_tpu_torch.parallel.dryrun 4          # on the card
    python -m qoipp_tpu_torch.parallel.dryrun 4 --cpu    # gloo on the CPU
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from .. import oracle
from ..common import Channels, Desc
from ..models.pipeline import BatchPipeline
from ..ops import boundary
from ..ops import decode as dec_ops
from ..ops.bitops import pixels_to_packed
from . import mesh as mesh_mod
from . import sharded
from .launch import rank_device, run_ranks

SP_TILES = 4  # tiles a rank: seams inside a rank and between ranks


def _expect(cond, what):
    if not cond:
        raise AssertionError(f"rank {dist.get_rank()}: {what}")


def example_batch(b: int, desc: Desc):
    """The dry run's dp images, as __graft_entry__._example_batch makes
    them: an 8-color palette an image, seed 0.  Returns (raws (b, n_px *
    channels) uint8, blobs)."""
    rng = np.random.default_rng(0)
    n = desc.width * desc.height
    ch = int(desc.channels)
    raws, blobs = [], []
    for _ in range(b):
        palette = rng.integers(0, 256, (8, ch)).astype(np.uint8)
        raw = palette[rng.integers(0, 8, n)].reshape(-1)
        raws.append(raw)
        blobs.append(oracle.encode(raw, desc)[0])
    return np.stack(raws), blobs


def sp_image():
    """The dry run's sp image: 740x65 RGB, 4 levels a channel, seed 1
    (48,100 pixels: not a multiple of 2 * 64, so the last encode shard is
    uneven).  Returns (desc, raw, stream)."""
    desc = Desc(740, 65, Channels.RGB)
    rng = np.random.default_rng(1)
    raw = (rng.integers(0, 4, desc.width * desc.height * 3) * 20).astype(
        np.uint8)
    return desc, raw, oracle.encode(raw, desc)[0]


def sp_rows(blob, n_px: int, parts: int, device):
    """One stream's byte rows for sp decode, qb widened until it splits
    into ``parts`` tiles: (meta, val) (qb,) int32 and the boundary pass's
    dict."""
    qb = dec_ops._bucket(blob.size - 14, boundary.BLOCK)
    while qb % parts:
        qb += boundary.BLOCK
    region = np.zeros(qb + 8, np.uint8)
    region[: blob.size - 14] = blob[14:]
    region = torch.from_numpy(region).to(device)
    info = boundary.analyze_region(region[:qb], blob.size - 22, n_px)
    meta, val = dec_ops.fields_dense_batch(region[None], info["real"][None])
    return meta[0], val[0], info


def _dp_step(m, world, dev):
    desc = Desc(256, 128, Channels.RGB)
    raws, blobs = example_batch(2 * world, desc)
    pipe = BatchPipeline(desc, device=dev)
    streams, sizes = pipe.pack_streams(blobs)
    streams, sizes = (mesh_mod.local_rows(torch.from_numpy(x).to(dev), m)
                      for x in (streams, sizes))
    packed, checksum = sharded.make_dp_decode(pipe, m)(streams, sizes)
    want = pixels_to_packed(mesh_mod.local_rows(
        torch.from_numpy(raws).to(dev), m), 3)
    _expect(bool((packed[:, : pipe.n_px] == want).all()),
            "dp decode differs from the oracle")
    local = (packed.to(torch.int64) & 0xFFFFFFFF).sum() % (1 << 32)
    sums = mesh_mod.all_gather(m, local.reshape(1), "data")
    _expect(int(checksum) == int(sums.sum()) % (1 << 32),
            "dp checksum differs from the sum of every rank's output")
    out, lengths = sharded.make_dp_encode(pipe, m)(torch.nn.functional.pad(
        packed[:, : pipe.n_px], (0, pipe.nb - pipe.n_px)))
    first = mesh_mod.axis_index(m, "data") * packed.shape[0]
    for i in range(packed.shape[0]):
        blob = blobs[first + i]
        _expect(int(lengths[i]) == blob.size and np.array_equal(
            out[i, : blob.size].cpu().numpy(), blob),
            f"dp encode of image {first + i} differs from the oracle")
    return int(checksum)


def _sp_step(m, sp, dev):
    desc, raw, blob = sp_image()
    n_px = desc.width * desc.height
    meta, val, info = sp_rows(blob, n_px, sp * SP_TILES, dev)
    emits, prevs = sharded.make_sp_decode(
        m, meta.shape[0], SP_TILES, device=dev)(
        mesh_mod.local_rows(meta, m, "seq"), mesh_mod.local_rows(val, m, "seq"))
    # the gather this check asks for
    emits, prevs = (mesh_mod.all_gather(m, x, "seq").reshape(-1)
                    for x in (emits, prevs))
    got = dec_ops.expand_pixels(emits, prevs, info["real"], info["produced"],
                                info["pix_before"],
                                dec_ops._bucket(n_px, 128))[:n_px]
    want = pixels_to_packed(torch.from_numpy(raw).to(dev), 3)
    _expect(bool((got == want).all()), "sp decode differs from the oracle")

    shard, n_local, n_last = sharded.sp_shard(want, m)
    _expect(n_last < n_local, "the last sp shard must be uneven")
    body, length = sharded.make_sp_encode(m, n_local, 3, device=dev)(
        shard, n_last)
    _expect(sharded.gather_stream(m, body, length) == blob[14:].tobytes(),
            "sp encode differs from the oracle")


def dryrun_rank(device_type: str) -> dict:
    """One rank of the dry run (run_ranks' fn)."""
    dev = rank_device(device_type)
    world = dist.get_world_size()
    sp = 2 if world % 2 == 0 else 1
    m = mesh_mod.make_mesh((world // sp, sp), ("data", "seq"), device_type)
    checksum = _dp_step(m, world, dev)
    if sp > 1:
        _sp_step(m, sp, dev)
    return dict(rank=dist.get_rank(), checksum=checksum)


def dryrun_multichip(world: int, device_type: str = "cuda",
                     timeout: float = 600.0) -> list:
    """Run the dry run on a local job of ``world`` ranks (gloo); returns
    each rank's {rank, checksum}.  Raises if any rank differs from the
    oracle."""
    return run_ranks(dryrun_rank, world, "gloo", device_type, timeout,
                     args=(device_type,))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("world", type=int)
    ap.add_argument("--cpu", action="store_true",
                    help="run the ranks on the CPU (gloo)")
    args = ap.parse_args(argv)
    out = dryrun_multichip(args.world, "cpu" if args.cpu else "cuda")
    print(f"dryrun ok: {args.world} ranks, checksum {out[0]['checksum']}")


if __name__ == "__main__":
    main()
