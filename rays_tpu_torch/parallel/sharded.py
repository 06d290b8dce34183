"""Scale-out: split the ray batch over processes, one per GPU
(``rays_tpu.parallel.sharded``).

The reference's only parallelism is an OpenMP ``parallel do`` over rays
(RAYS_project/RAYS_lib/ray_tracing.f90:62-67); the JAX package shards the
ray axis over a device mesh.  Here each process of a ``torch.distributed``
group holds its own slice of the rays on its own device and traces it with
``trace_rays``, so each GPU runs the slab RK4 kernel wherever
``trace.route`` sends the run there.  Rays are independent, so the
forward pass has no collective; what sums over rays (deposition profiles,
the gradients of the replicated Params) is summed over the processes with
``all_reduce_sum``.  Without an initialized process group everything
degrades to one process, so library code can call these unconditionally.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from rays_tpu_torch.tracing import trace as trace_mod
from rays_tpu_torch.tracing.stop import StopCode


class RayMesh(NamedTuple):
    """The processes that split the rays: the ``torch.distributed`` group
    (``None``: the default group, or no group at all when none is
    initialized), its size and this process's rank in it."""

    group: Any
    size: int
    rank: int


def distributed() -> bool:
    """Whether a ``torch.distributed`` process group is up."""
    return dist.is_available() and dist.is_initialized()


def make_ray_mesh(group=None) -> RayMesh:
    if not distributed():
        return RayMesh(None, 1, 0)
    return RayMesh(group, dist.get_world_size(group), dist.get_rank(group))


def pad_rays(v0, status0, pwr, n_shards: int):
    """Pad the ray batch to a multiple of ``n_shards``.  Padding rays are
    born with a DID_NOT_START status and zero power, so they freeze at
    once and add nothing to what is summed.  Returns (v0, status0, pwr,
    the unpadded count)."""
    B = v0.shape[0]
    pad = (-B) % n_shards
    if pad == 0:
        return v0, status0, pwr, B
    v0 = torch.cat([v0, v0.new_zeros((pad, v0.shape[1]))])
    status0 = torch.cat([status0, status0.new_full((pad,), int(StopCode.DID_NOT_START))])
    pwr = torch.cat([pwr, pwr.new_zeros((pad,))])
    return v0, status0, pwr, B


def all_reduce_sum(t, mesh: RayMesh):
    """Sum ``t`` over the mesh's processes, in place; returns ``t``.  A
    no-op without a process group."""
    if distributed():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def make_sharded_tracer(cfg, mesh: RayMesh):
    """Tracer of this process's rays: ``trace(params, v0, status0, pwr)``
    with the process's own slice, on its own device; the Params are the
    same on every process.  It calls no collective."""
    del mesh  # every process traces alone; the mesh sums what it returns

    def trace(params, v0, status0, pwr):
        return trace_mod.trace_rays(cfg, params, v0, status0, pwr)

    return trace
