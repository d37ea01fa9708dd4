"""Device meshes over torch.distributed, and the collectives the sharded
codec uses.

The port of ``qoipp_tpu.parallel.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the initialized default
process group, one rank a device: batches shard over a ``data`` axis (dp)
and one image's chunk rows or pixels over a ``seq`` axis (sp), whose seam
state crosses ranks in the collectives below.  JAX's ``data_sharding`` and
``replicated`` specs have no counterpart: a rank holds its block of a
sharded tensor (``local_rows``), and a replicated tensor is one that every
rank holds whole.

An axis argument is a mesh dimension's name or a tuple of names, taken
together in row-major order (dp over ``("host", "data")``).  The
collectives exchange small state: the seam state (65 words a rank), the sp
encoder's summaries (131), flags and sums.  On ``gloo`` they go through
host memory, which is what gloo takes; on ``nccl`` device tensors go as
they are.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data", "seq"),
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh of the default process group's ranks; by default all of them
    on ``data``, 1 on ``seq``.  Raises if no process group is initialized
    or the shape's product is not the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process "
                           "group (torch.distributed.init_process_group, or "
                           "qoipp_tpu_torch.parallel.launch.run_ranks)")
    world = dist.get_world_size()
    shape = (world, 1) if shape is None else tuple(shape)
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} != {world} ranks")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def hybrid_shape(world: int, hosts: int) -> Tuple[int, int, int]:
    """make_hybrid_mesh's (host, data, seq) shape: seq takes the largest
    power of two that divides a host's ranks, at most 4; data the rest."""
    if world % hosts:
        raise ValueError(f"{world} ranks do not split over {hosts} hosts")
    per_host = world // hosts
    seq = 1
    while seq * 2 <= per_host and per_host % (seq * 2) == 0 and seq < 4:
        seq *= 2
    return hosts, per_host // seq, seq


def make_hybrid_mesh(axis_names: Sequence[str] = ("host", "data", "seq"),
                     hosts: Optional[int] = None,
                     device_type: str = "cuda") -> DeviceMesh:
    """The multi-host layout: ``host`` outermost (the slow links carry only
    the batch dimension), ``seq`` innermost (the seam exchange stays among
    a host's ranks).  ``hosts`` defaults to the world size over
    LOCAL_WORLD_SIZE (1 where that is unset)."""
    world = dist.get_world_size()
    if hosts is None:
        hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return make_mesh(hybrid_shape(world, hosts), axis_names, device_type)


def _dims(mesh: DeviceMesh, axis) -> Tuple[int, ...]:
    names = mesh.mesh_dim_names
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    return tuple(names.index(a) for a in axes)


def axis_size(mesh: DeviceMesh, axis) -> int:
    """Ranks along ``axis``."""
    return math.prod(mesh.size(d) for d in _dims(mesh, axis))


def axis_index(mesh: DeviceMesh, axis) -> int:
    """This rank's coordinate along ``axis`` (row-major over a tuple)."""
    idx = 0
    for d in _dims(mesh, axis):
        idx = idx * mesh.size(d) + mesh.get_local_rank(d)
    return idx


def local_rows(x, mesh: DeviceMesh, axis="data"):
    """This rank's block of x's leading dimension, which must split evenly
    over ``axis`` (no copy)."""
    n = axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")
    blk = x.shape[0] // n
    i = axis_index(mesh, axis)
    return x[i * blk : (i + 1) * blk]


def _staged(mesh: DeviceMesh, d: int, t: torch.Tensor):
    """(the group of mesh dimension d, t as that group's backend takes
    it: in host memory on gloo)."""
    group = mesh.get_group(d)
    if dist.get_backend(group) == "gloo":
        t = t.cpu()
    return group, t.contiguous()


def all_gather(mesh: DeviceMesh, t: torch.Tensor, axis) -> torch.Tensor:
    """Every rank's t along ``axis``, stacked in coordinate order: (n,
    *t.shape) on t's device."""
    out = t
    for d in reversed(_dims(mesh, axis)):  # the innermost first
        group, x = _staged(mesh, d, out)
        parts = [torch.empty_like(x) for _ in range(mesh.size(d))]
        dist.all_gather(parts, x, group=group)
        out = torch.stack(parts)
    return out.reshape(-1, *t.shape).to(t.device)


def all_reduce(mesh: DeviceMesh, t: torch.Tensor, axis,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """t reduced by ``op`` over the ranks along ``axis``, on t's device
    (t is left as it was)."""
    out = t.clone()
    for d in _dims(mesh, axis):
        group, out = _staged(mesh, d, out)
        dist.all_reduce(out, op=op, group=group)
    return out.to(t.device)
