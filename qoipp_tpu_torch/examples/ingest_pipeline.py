"""Vision ingest on the card: a directory of QOI files decoded by the
batch pipeline into a tensor on the device and fed straight into a toy
vision model, with no host round trip between decode and compute.

    python -m qoipp_tpu_torch.examples.ingest_pipeline [--batch 16]
        [--size 256] [--dataset DIR] [--cpu]

The port of the repository's ``examples/ingest_pipeline.py``:

    native batch file loader (one C pass, one upload), the pipeline's
    stream cap the longest file
 -> BatchPipeline.decode: (B, H, W, 3) uint8 on the device (K1, K2)
 -> normalize to bf16, patchify 8x8, Linear(192, 256), ReLU,
    Linear(256, 128), mean pool (bf16 matmuls accumulating in fp32)

The decoded images are checked against the native oracle, and the
features against the same model in fp32 on the oracle's pixels (max abs
error at most FEATURE_RTOL of the largest feature: bf16 keeps 8 bits of
mantissa).  The step is timed on the card by ``device_time_ms``; on the
CPU by the host clock, and labelled so.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from .. import oracle
from ..common import Channels, Desc, read_header
from ..convert import resolve_device
from ..tools import add_device_args
from ..utils.timing import device_time_ms, mpix_per_s, time_ms

PATCH = 8
FEATURE_RTOL = 0.02


def make_dataset(root: Path, n: int, side: int) -> None:
    """n side x side RGB images of 12 colours with runs, as .qoi files."""
    rng = np.random.default_rng(0)
    desc = Desc(side, side, Channels.RGB)
    for i in range(n):
        base = rng.integers(0, 256, (12, 3)).astype(np.uint8)
        ids = np.maximum.accumulate(
            np.where(rng.random(side * side) < 0.04,
                     rng.integers(0, 12, side * side), 0)) % 12
        raw = base[ids].reshape(-1)
        blob, _ = oracle.encode(raw, desc)
        (root / f"img_{i:03d}.qoi").write_bytes(blob.tobytes())


class ToyTrunk(nn.Module):
    """A stand-in vision trunk: 8x8 patches, two linear layers with a
    ReLU between, mean pooling over the patches.  Weights drawn from a
    torch.Generator seeded ``seed``, normal at std 0.02, no biases."""

    def __init__(self, seed: int = 0, dtype=torch.bfloat16, device=None):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        pdim = PATCH * PATCH * 3
        self.fc1 = nn.Linear(pdim, 256, bias=False)
        self.fc2 = nn.Linear(256, 128, bias=False)
        with torch.no_grad():
            self.fc1.weight.copy_(torch.randn(256, pdim, generator=g) * 0.02)
            self.fc2.weight.copy_(torch.randn(128, 256, generator=g) * 0.02)
        self.to(device=device, dtype=dtype)

    def forward(self, images):
        """(B, H, W, 3) in the model's dtype -> (B, 128) float32."""
        b, h, w, c = images.shape
        p = PATCH
        x = images.reshape(b, h // p, p, w // p, p, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p), p * p * c)
        x = torch.relu(self.fc1(x))
        return self.fc2(x).float().mean(dim=1)


def normalize(images, dtype=torch.bfloat16):
    """uint8 pixels -> [-1, 1] in ``dtype``."""
    return images.to(dtype) / 127.5 - 1.0


def main(argv=None):
    ap = argparse.ArgumentParser(description="QOI files -> device decode -> "
                                 "toy vision forward pass")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--dataset", type=Path, default=None,
                    help="directory of same-geometry RGB .qoi files")
    ap.add_argument("--runs", type=int, default=10)
    add_device_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..models.pipeline import BatchPipeline

    with tempfile.TemporaryDirectory() as tmp:
        root = args.dataset
        if root is None:
            root = Path(tmp)
            make_dataset(root, args.batch, args.size)
            print(f"generated {args.batch} x {args.size}^2 QOI files")
        paths = sorted(root.glob("*.qoi"))[: args.batch]
        hdr = read_header(paths[0]).value()
        if hdr.width % PATCH or hdr.height % PATCH:
            raise ValueError(f"{hdr.width}x{hdr.height} is not a multiple "
                             f"of the {PATCH}-pixel patch")
        # replay depth follows the longest stream, not the worst size
        pipe = BatchPipeline(hdr, max_stream_len=max(
            p.stat().st_size for p in paths), device=dev)

        t0 = time.perf_counter()
        streams_np, sizes_np = pipe.load_files(paths)  # native C loader
        t_load = (time.perf_counter() - t0) * 1e3
        want = np.stack([oracle.decode(p.read_bytes(), hdr, Channels.RGB)
                         for p in paths])
    streams = torch.from_numpy(streams_np).to(dev)
    sizes = torch.from_numpy(sizes_np).to(dev)

    model = ToyTrunk(device=dev)

    @torch.no_grad()
    def ingest_step(streams, sizes):
        images = pipe.decode(streams, sizes, Channels.RGB)  # (B,H,W,3) u8
        return model(normalize(images))

    with torch.no_grad():
        images = pipe.decode(streams, sizes, Channels.RGB)
        if not np.array_equal(images.reshape(len(paths), -1).cpu().numpy(),
                              want):
            raise AssertionError("device decode differs from the oracle")
        out = ingest_step(streams, sizes)
        ref = ToyTrunk(dtype=torch.float32)(normalize(
            torch.from_numpy(want).reshape(images.shape), torch.float32))
    out_h = out.cpu()
    err = float((out_h - ref).abs().max())
    if not (out.shape == (len(paths), 128) and bool(out_h.isfinite().all())
            and err <= FEATURE_RTOL * float(ref.abs().max())):
        raise AssertionError(f"features off: shape {tuple(out.shape)}, max "
                             f"abs err {err} vs fp32 max "
                             f"{float(ref.abs().max())}")

    n_px = len(paths) * hdr.width * hdr.height
    if dev.type == "cuda":
        ms = device_time_ms(ingest_step, streams, sizes, runs=args.runs)
        where = f"device time on {torch.cuda.get_device_name(dev)}"
    else:
        ms = time_ms(lambda: ingest_step(streams, sizes), runs=args.runs)
        where = "host clock on the cpu"
    print(f"load (native):    {t_load:.1f} ms for {len(paths)} files")
    print(f"decode check:     {len(paths)} x {hdr.width}x{hdr.height} equal "
          f"to the oracle")
    print(f"decode+forward:   {ms:.3f} ms = {mpix_per_s(n_px, ms):.1f} "
          f"MPix/s end to end, {where}")
    print(f"features:         {tuple(out.shape)} {out.dtype}, max abs err "
          f"{err:.3g} against fp32 (max |feature| "
          f"{float(ref.abs().max()):.3g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
