"""A local multi-process job: ``world`` ranks on this host, one process
each, joined in one torch.distributed process group.

The port's counterpart of the JAX package's virtual 8-device mesh and of
``jax.distributed`` in ``benchmarks/multiprocess_sim.py``.  The ranks meet
through a ``file://`` store in a fresh temporary directory, so jobs that
run side by side never share a port, and each rank leaves its result
there.  The CUDA kernels and the native oracle are built in the parent
before the ranks start, so that ranks only load the libraries and no two
compilers race into one directory.  A rank that raises, exits non-zero or
outlives ``timeout`` fails the whole job: the other ranks are killed and
the parent raises.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import kernels, oracle


def rank_device(device_type: str) -> torch.device:
    """The device of this rank: on "cuda" the card run_ranks set for it
    (rank % cards: every rank shares one card where there is one), else
    the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    return torch.device("cuda", torch.cuda.current_device())


def _rank_main(rank, world, backend, device_type, tmp, timeout, fn, args):
    # every rank of the job is on this host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    # a rank that raises keeps its group until it exits, by which time its
    # traceback is on disk: a peer that fails in a collective on its exit
    # cannot take the report's place
    out = fn(*args)
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _report(job, world, first) -> str:
    """The traceback of every rank that raised (a rank's fault often ends
    its peers' collectives too), else how the first failed rank exited."""
    text = []
    for r, path in enumerate(job.error_files):
        if os.path.exists(path):
            with open(path, "rb") as f:
                text.append(f"rank {r} of {world} failed:\n{pickle.load(f)}")
            os.unlink(path)
    return "\n".join(text) or f"rank {first.error_index} of {world}: {first}"


def run_ranks(fn, world: int, backend: str = "gloo",
              device_type: str = "cuda", timeout: float = 600.0,
              args: tuple = ()) -> list:
    """Run fn(*args) on ``world`` spawned ranks of one process group
    (``backend``: "gloo" or "nccl") and return each rank's result, in rank
    order.  fn must be importable by name (a module-level function) and
    its result picklable; it reads its rank from torch.distributed and its
    device from rank_device(device_type).  Raises RuntimeError with every
    failed rank's traceback if a rank raises or exits non-zero,
    TimeoutError past ``timeout`` seconds; the other ranks are killed
    first."""
    if device_type == "cuda":
        kernels.build()
    oracle.build()
    tmp = tempfile.mkdtemp(prefix="qoipp_ranks_")
    try:
        job = mp.start_processes(
            _rank_main, (world, backend, device_type, tmp, timeout, fn, args),
            nprocs=world, join=False, daemon=True, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not job.join(max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"ranks {sorted(job.sentinels.values())} of {world} "
                        f"did not finish within {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(_report(job, world, e)) from None
        finally:
            for p in job.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
