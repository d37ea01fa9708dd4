"""The multi-rank cases of tests/test_torch_parallel.py and of the card
tests: their inputs (the streams and pixels of tests/test_parallel.py and
benchmarks/multiprocess_sim.py, made from seeds), the jobs that
parallel.launch.run_ranks runs on every rank, and the checks of the
gathered results against the oracle.  Imports torch and the port only
(never JAX): spawned ranks import this module by name.

A job reads its inputs from an .npz file that the test wrote, runs every
case of the sharded codec on this rank's block, writes this rank's outputs
to ``rank<r>.npz`` in ``out_dir`` and returns the rank's kernel launch
counts."""

import os
import re
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from qoipp_tpu_torch import kernels, oracle
from qoipp_tpu_torch.common import Channels, Desc, write_header
from qoipp_tpu_torch.convert import words_to_numpy
from qoipp_tpu_torch.models.pipeline import BatchPipeline
from qoipp_tpu_torch.ops import boundary
from qoipp_tpu_torch.ops import decode as dec_ops
from qoipp_tpu_torch.ops.bitops import pixels_to_packed
from qoipp_tpu_torch.parallel import mesh as mesh_mod
from qoipp_tpu_torch.parallel import sharded
from qoipp_tpu_torch.parallel.launch import rank_device, run_ranks

SP_TILES = 4
DESC = Desc(48, 32, Channels.RGB)


def make_batch(b, desc, seed):
    """test_parallel.make_batch: an 8-color palette an image."""
    rng = np.random.default_rng(seed)
    n = desc.width * desc.height
    ch = int(desc.channels)
    raws, blobs = [], []
    for _ in range(b):
        palette = rng.integers(0, 256, (8, ch)).astype(np.uint8)
        raw = palette[rng.integers(0, 8, n)].reshape(-1)
        raws.append(raw)
        blobs.append(oracle.encode(raw, desc)[0])
    return np.stack(raws), blobs


def palette_stream():
    """test_sp_sharded_decode's stream: 256x16 RGB, 16 colors."""
    desc = Desc(256, 16, Channels.RGB)
    rng = np.random.default_rng(5)
    palette = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    raw = palette[rng.integers(0, 16, 256 * 16)].reshape(-1)
    return desc, raw, oracle.encode(raw, desc)[0]


def index_stream():
    """test_sp_decode_adversarial_rounds' stream: after a 64-color
    prologue every chunk is an OP_INDEX into a slot a zero-table tile
    cannot resolve."""
    rng = np.random.default_rng(11)
    colors, seen_slots = [], set()
    while len(colors) < 64:
        c = rng.integers(0, 256, 3)
        h = (3 * c[0] + 5 * c[1] + 7 * c[2] + 11 * 255) % 64
        if h not in seen_slots:
            seen_slots.add(h)
            colors.append(c)
    palette = np.array(colors, np.uint8)
    idx = np.empty(4096, np.int64)
    idx[0] = 0
    step = rng.integers(1, 64, idx.size - 1)
    idx[1:] = np.cumsum(step) % 64
    dup = idx[1:] == idx[:-1]
    idx[1:][dup] = (idx[1:][dup] + 1) % 64
    raw = palette[idx].reshape(-1)
    desc = Desc(idx.size, 1, Channels.RGB)
    return desc, raw, oracle.encode(raw, desc)[0]


def crafted_pixels(n_total, n_px, seed=6):
    """test_sp_sharded_encode's pixels: runs (some past 62 and whole
    shards), revisits, small and luma-range steps, fresh pixels with
    alpha changes; (n_px, 4) uint8."""
    rng = np.random.default_rng(seed)
    px = np.zeros((n_total, 4), np.int64)
    px[:, 3] = 255
    cur = np.array([10, 20, 30, 255], np.int64)
    i = 0
    while i < n_px:
        mode = rng.integers(0, 5)
        if mode == 0:
            ln = int(rng.integers(1, 300))
        elif mode == 1:
            cur[:3] = (cur[:3] + rng.integers(-2, 2, 3)) % 256
            ln = 1
        elif mode == 2:
            cur[:3] = (cur[:3] + rng.integers(-30, 30, 3)) % 256
            ln = 1
        elif mode == 3:
            j = int(rng.integers(0, i)) if i else 0
            cur = px[j].copy()
            ln = 1
        else:
            cur = rng.integers(0, 256, 4)
            if rng.random() < 0.5:
                cur[3] = 255
        ln = min(ln if mode == 0 else 1, n_px - i)
        px[i : i + ln] = cur
        i += ln
    return px[:n_px].astype(np.uint8)


def _save_batch(inp, prefix, desc, raws, blobs):
    inp[f"{prefix}_desc"] = [desc.width, desc.height, int(desc.channels)]
    inp[f"{prefix}_streams"], inp[f"{prefix}_sizes"] = BatchPipeline(
        desc, device="cpu").pack_streams(blobs)


def _padded_words(raws, desc):
    """(b, n_px * channels) uint8 -> (b, nb) uint32 words, zero past n_px:
    the encoder's input."""
    pipe = BatchPipeline(desc, device="cpu")
    return torch.nn.functional.pad(
        pixels_to_packed(torch.from_numpy(raws), int(desc.channels)),
        (0, pipe.nb - pipe.n_px)).numpy().view(np.uint32)


def _save_stream(inp, name, desc, blob, parts):
    """A stream's region, widened as test_parallel widens it until qb
    splits into ``parts`` tiles."""
    n_px = desc.width * desc.height
    qb = dec_ops._bucket(blob.size - 14, boundary.BLOCK)
    while qb % parts:
        qb += boundary.BLOCK
    region = np.zeros(qb + 8, np.uint8)
    region[: blob.size - 14] = blob[14:]
    inp[f"{name}_region"] = region
    inp[f"{name}_size"] = [blob.size, n_px]


def _save_encode(inp, name, raw, channels, n_dev, n_local, n_px):
    packed = np.zeros(n_dev * n_local, np.uint32)
    packed[:n_px] = pixels_to_packed(torch.from_numpy(raw), channels).numpy(
        ).view(np.uint32)
    inp[f"{name}_packed"] = packed
    inp[f"{name}_shape"] = [n_local, n_px - (n_dev - 1) * n_local, channels]


def inputs4():
    """world4's inputs (arrays for the ranks) and, by case, what the
    oracle gives for them."""
    inp, want = {}, {}
    raws, blobs = make_batch(16, DESC, seed=3)
    _save_batch(inp, "dp_dec", DESC, raws, blobs)
    want["dp"] = (raws, blobs)
    raws, blobs = make_batch(8, DESC, seed=4)
    inp["dp_enc_packed"] = _padded_words(raws, DESC)
    want["dp_enc"] = (raws, blobs)
    # test_torch_pipeline's overflow images: noise (near the worst size)
    # and 4-level pixels over a cap of 1,024 bytes, zeros under it
    rng = np.random.default_rng(23)
    ovf = Desc(40, 32, Channels.RGBA)
    n = 40 * 32 * 4
    kinds = ("zero", "zero", "zero", "noise", "zero", "levels", "zero",
             "noise")
    raws = np.stack([
        np.zeros(n, np.uint8) if k == "zero" else
        rng.integers(0, 256, n, dtype=np.uint8) if k == "noise" else
        (rng.integers(0, 4, n) * 60).astype(np.uint8) for k in kinds])
    inp["dp_ovf_desc"] = [ovf.width, ovf.height, 4]
    inp["dp_ovf_packed"] = _padded_words(raws, ovf)
    inp["dp_ovf_cap"] = 1024
    for name, (desc, raw, blob) in (("sp", palette_stream()),
                                    ("adv", index_stream())):
        _save_stream(inp, name, desc, blob, 4 * SP_TILES)
        want[name] = (desc, raw, blob)
    n_px = 4 * 256 - 37  # the last shard partly filled
    px = crafted_pixels(4 * 256, n_px)
    for name, ch in (("enc_rgb", 3), ("enc_rgba", 4)):
        raw = np.ascontiguousarray(px[:, :ch]).reshape(-1)
        desc = Desc(n_px, 1, Channels(ch))
        _save_encode(inp, name, raw, ch, 4, 256, n_px)
        want[name] = (desc, raw, oracle.encode(raw, desc)[0])
    return inp, want


def inputs8():
    """world8_hybrid's inputs and, by case, what the oracle gives."""
    inp, want = {}, {}
    for prefix, desc, b, seed in (("hy", DESC, 8, 7),
                                  ("sim", Desc(32, 16, Channels.RGB), 16, 0)):
        raws, blobs = make_batch(b, desc, seed)
        _save_batch(inp, f"{prefix}_dec", desc, raws, blobs)
        want[prefix] = (raws, blobs)
    # test_hybrid_mesh_dcn_layout's sp encode: 256 pixels a seq rank
    rng = np.random.default_rng(8)
    palette = rng.integers(0, 256, (4, 3)).astype(np.uint8)
    raw = palette[rng.integers(0, 4, 4 * 256)].reshape(-1)
    desc = Desc(4 * 256, 1, Channels.RGB)
    _save_encode(inp, "hy_sp", raw, 3, 4, 256, 4 * 256)
    want["hy_sp"] = (desc, raw, oracle.encode(raw, desc)[0])
    return inp, want


def _desc(inp, name):
    w, h, ch = (int(x) for x in inp[f"{name}_desc"])
    return Desc(w, h, Channels(ch))


def _rows(inp, name, dev):
    """A stream's byte rows (meta, val) (qb,) int32 from its saved region
    (qb + 8,) and sizes."""
    region = torch.from_numpy(inp[f"{name}_region"]).to(dev)
    qb = region.shape[0] - 8
    size, n_px = (int(x) for x in inp[f"{name}_size"])
    info = boundary.analyze_region(region[:qb], size - 22, n_px)
    meta, val = dec_ops.fields_dense_batch(region[None], info["real"][None])
    return meta[0], val[0]


def dp_cases(m, inp, out, dev, axis="data", prefix="dp"):
    """dp decode (whole output and checksum) of the saved batch and, where
    saved, dp encode, and dp encode at a tight cap, recording the error
    every rank raises."""
    pipe = BatchPipeline(_desc(inp, f"{prefix}_dec"), device=dev)
    streams, sizes = (mesh_mod.local_rows(torch.from_numpy(
        inp[f"{prefix}_dec_{k}"]).to(dev), m, axis) for k in ("streams",
                                                              "sizes"))
    packed, checksum = sharded.make_dp_decode(pipe, m, axis)(streams, sizes)
    out[f"{prefix}_packed"] = words_to_numpy(packed)
    out[f"{prefix}_checksum"] = np.int64(int(checksum))
    if f"{prefix}_enc_packed" not in inp:
        return
    streams, lengths = sharded.make_dp_encode(pipe, m, axis)(
        _local_words(inp, f"{prefix}_enc_packed", m, axis, dev))
    out[f"{prefix}_streams"] = streams.cpu().numpy()
    out[f"{prefix}_lengths"] = lengths.cpu().numpy()
    tight = BatchPipeline(_desc(inp, f"{prefix}_ovf"), device=dev,
                          max_encode_len=int(inp[f"{prefix}_ovf_cap"]))
    try:
        sharded.make_dp_encode(tight, m, axis)(
            _local_words(inp, f"{prefix}_ovf_packed", m, axis, dev))
        out[f"{prefix}_overflow"] = ""
    except ValueError as e:
        out[f"{prefix}_overflow"] = str(e)


def _local_words(inp, key, m, axis, dev):
    """This rank's block of saved uint32 pixel words, as int32."""
    return mesh_mod.local_rows(torch.from_numpy(inp[key].view(np.int32)).to(
        dev), m, axis)


def sp_decode_case(m, inp, out, name, dev):
    meta, val = _rows(inp, name, dev)
    emits, prevs, rounds = sharded.make_sp_decode(
        m, meta.shape[0], SP_TILES, with_rounds=True, device=dev)(
        mesh_mod.local_rows(meta, m, "seq"), mesh_mod.local_rows(val, m, "seq"))
    out[f"{name}_emits"] = words_to_numpy(emits)
    out[f"{name}_prevs"] = words_to_numpy(prevs)
    out[f"{name}_rounds"] = np.int64(rounds)


def sp_encode_case(m, inp, out, name, dev):
    n_local, n_last, ch = (int(x) for x in inp[f"{name}_shape"])
    body, length = sharded.make_sp_encode(m, n_local, ch, device=dev)(
        _local_words(inp, f"{name}_packed", m, "seq", dev), n_last)
    out[f"{name}_body"] = body.cpu().numpy()
    out[f"{name}_length"] = np.int64(int(length))


def _finish(out, out_dir):
    np.savez(Path(out_dir) / f"rank{dist.get_rank()}.npz", **out)
    return kernels.launch_counts()


def world4(in_path, out_dir, device_type="cpu"):
    """Every case at world 4: dp on a (4, 1) mesh, sp on (1, 4)."""
    dev = rank_device(device_type)
    inp = np.load(in_path)
    out = {}
    dp_cases(mesh_mod.make_mesh((4, 1), device_type=device_type), inp, out,
             dev)
    m = mesh_mod.make_mesh((1, 4), device_type=device_type)
    for name in ("sp", "adv"):
        sp_decode_case(m, inp, out, name, dev)
    for name in ("enc_rgb", "enc_rgba"):
        sp_encode_case(m, inp, out, name, dev)
    try:
        mesh_mod.make_mesh((3, 1), device_type=device_type)
        out["bad_shape"] = ""
    except ValueError as e:
        out["bad_shape"] = str(e)
    return _finish(out, out_dir)


def world8_hybrid(in_path, out_dir, device_type="cpu"):
    """make_hybrid_mesh at world 8: with hosts=2 and from LOCAL_WORLD_SIZE
    4; dp decode over (host, data) of both saved batches, sp encode over
    seq."""
    dev = rank_device(device_type)
    inp = np.load(in_path)
    m = mesh_mod.make_hybrid_mesh(hosts=2, device_type=device_type)
    os.environ["LOCAL_WORLD_SIZE"] = "4"
    m_env = mesh_mod.make_hybrid_mesh(device_type=device_type)
    out = {"shape": np.array(m.shape), "shape_env": np.array(m_env.shape),
           "coords": np.array([m.get_local_rank(d) for d in range(3)])}
    for prefix in ("hy", "sim"):
        dp_cases(m, inp, out, dev, ("host", "data"), prefix)
    sp_encode_case(m, inp, out, "hy_sp", dev)
    return _finish(out, out_dir)


def fails_on_rank1():
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    dist.barrier()


# --------------------------------------------------------------------------
# The gathered results against the oracle
# --------------------------------------------------------------------------


def run_job(path, make_inputs, fn, world, device_type, timeout):
    """Write make_inputs()' arrays to path/inputs.npz, run fn on ``world``
    ranks (gloo) and load each rank's outputs.  Returns dict(inp, want,
    ranks, counts)."""
    path = Path(path)
    inp, want = make_inputs()
    np.savez(path / "inputs.npz", **inp)
    counts = run_ranks(fn, world, "gloo", device_type, timeout,
                       args=(str(path / "inputs.npz"), str(path),
                             device_type))
    ranks = [dict(np.load(path / f"rank{r}.npz")) for r in range(world)]
    return dict(inp=inp, want=want, ranks=ranks, counts=counts)


def joined(ranks, key, which=None):
    """The blocks of ``which`` ranks (all by default), in order."""
    return np.concatenate([ranks[r][key] for r in (
        range(len(ranks)) if which is None else which)])


def check_dp_decode(job, prefix, data_ranks=None):
    """The ranks' dp decode blocks against the oracle's pixels; returns
    them joined (uint32)."""
    raws, _ = job["want"][prefix]
    desc = _desc(job["inp"], f"{prefix}_dec")
    got = joined(job["ranks"], f"{prefix}_packed", data_ranks)
    n_px = desc.width * desc.height
    want = pixels_to_packed(torch.from_numpy(raws), int(desc.channels))
    assert np.array_equal(got[:, :n_px], want.numpy().view(np.uint32))
    return got


def check_dp_encode(job):
    """The ranks' dp encode blocks against the oracle's streams; returns
    (streams, lengths) joined."""
    _, blobs = job["want"]["dp_enc"]
    got, lengths = (joined(job["ranks"], k) for k in ("dp_streams",
                                                      "dp_lengths"))
    for i, b in enumerate(blobs):
        assert lengths[i] == b.size and np.array_equal(got[i, : b.size], b)
    return got, lengths


OVERFLOW_IMAGES = [3, 5, 7]  # inputs4's noise and 4-level images


def overflow_images(msg):
    """The global image indices a dp_encode overflow error names."""
    return [int(x) for x in re.search(r"images \[([\d, ]*)\]", str(msg))
            .group(1).split(",")]


def check_sp_decode(job, name):
    """The ranks' sp decode blocks, expanded, against the oracle's pixels;
    returns (emits, prevs) joined (uint32) and each rank's rounds."""
    desc, raw, blob = job["want"][name]
    ranks = job["ranks"]
    emits, prevs = (joined(ranks, f"{name}_{k}") for k in ("emits",
                                                          "prevs"))
    region = torch.from_numpy(job["inp"][f"{name}_region"])
    qb = region.shape[0] - 8
    n_px = desc.width * desc.height
    info = boundary.analyze_region(region[:qb], blob.size - 22, n_px)
    px = dec_ops.expand_pixels(
        torch.from_numpy(emits.view(np.int32)),
        torch.from_numpy(prevs.view(np.int32)), info["real"],
        info["produced"], info["pix_before"],
        dec_ops._bucket(n_px, 128))[:n_px]
    assert torch.equal(px, pixels_to_packed(torch.from_numpy(raw), 3))
    return emits, prevs, [int(r[f"{name}_rounds"]) for r in ranks]


def check_sp_encode(job, name, seq_ranks):
    """The bodies of the ranks at seq coordinates 0, 1, ... (seq_ranks)
    joined behind the header against the oracle's stream; returns each
    one's (body[:length], length)."""
    desc, _, blob = job["want"][name]
    ranks = job["ranks"]
    parts = [(ranks[r][f"{name}_body"][: int(ranks[r][f"{name}_length"])],
              int(ranks[r][f"{name}_length"])) for r in seq_ranks]
    got = b"".join(body.tobytes() for body, _ in parts)
    assert write_header(desc) + got == blob.tobytes()
    return parts
