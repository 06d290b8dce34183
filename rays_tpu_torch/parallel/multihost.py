"""Scale-out across processes and hosts: the ray batch split over the
processes of a ``torch.distributed`` group, one per GPU
(``rays_tpu.parallel.multihost``).

The reference tops out at shared-memory OpenMP on one node
(RAYS_project/RAYS_lib/ray_tracing.f90:62-67, openmp_m.f90).  The design:

  * every process runs the same program; ``initialize()`` joins them into
    one group (NCCL between GPUs, gloo on the CPU);
  * each process launches and holds only its own rays
    (``local_ray_slice`` of the launch grid, ``distribute_rays`` onto its
    own device): no process ever holds the whole batch;
  * the Params are replicated; what sums over rays (deposition profiles,
    the gradients of the Params) is summed with ``all_reduce``
    (``sharded.all_reduce_sum``).

On a single process every function degrades to that process alone, so
library code can call these unconditionally.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from rays_tpu_torch.parallel import sharded


def initialize(init_method=None, coordinator_address=None, num_processes=None,
               process_id=None, device="cuda", backend=None):
    """Join this process to the group (a no-op for one process given no
    address).  ``init_method`` is any ``torch.distributed`` URL
    (``tcp://host:port``, ``file:///path``); ``coordinator_address``
    ("host:port") stands for ``tcp://host:port``.  The backend is NCCL for
    a CUDA ``device`` and gloo for the CPU unless ``backend`` names one
    (NCCL refuses two processes on one GPU; such a run names gloo, which
    reduces CUDA tensors too).

        rays_tpu_torch.parallel.multihost.initialize(
            coordinator_address="10.0.0.1:29500",
            num_processes=4, process_id=int(os.environ["RANK"]))

    Returns (process_index, process_count)."""
    n = 1 if num_processes is None else int(num_processes)
    if init_method is None and coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    if n > 1 and init_method is None:
        raise ValueError("initialize: more than one process needs an init_method "
                         "or a coordinator_address")
    if init_method is not None:
        if backend is None:
            backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=init_method, world_size=n,
                                rank=int(process_id or 0))
    return rank(), world_size()


def rank() -> int:
    """This process's index in the group (0 without one)."""
    return dist.get_rank() if sharded.distributed() else 0


def world_size() -> int:
    """The number of processes in the group (1 without one)."""
    return dist.get_world_size() if sharded.distributed() else 1


def process_device(device="cuda"):
    """This process's device: for CUDA the GPU rank % device count (one
    process per GPU; processes beyond the GPUs share them), else the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", rank() % torch.cuda.device_count())


def global_ray_mesh(group=None) -> sharded.RayMesh:
    """The mesh of every process of the group (default: the whole world)."""
    return sharded.make_ray_mesh(group)


def distribute_rays(mesh: sharded.RayMesh, v0_local, status0_local, pwr_local,
                    device="cuda"):
    """Each process's own rays on its own device (``process_device`` of
    ``device``, the card unless the caller asks for the CPU): the process
    passes only the rays it launched, and no process gathers the others'."""
    del mesh
    dev = process_device(device)
    return (v0_local.to(dev).contiguous(), status0_local.to(dev).contiguous(),
            pwr_local.to(dev).contiguous())


def local_ray_slice(n_global: int, process_count: int | None = None,
                    process_index: int | None = None):
    """(start, stop) of one process's contiguous share of a global ray
    batch.  Defaults to this process's place in the live group; explicit
    (process_count, process_index) make the arithmetic testable."""
    pc = world_size() if process_count is None else int(process_count)
    pi = rank() if process_index is None else int(process_index)
    if not 0 <= pi < pc:
        raise ValueError(f"process_index {pi} outside [0, {pc})")
    per = -(-n_global // pc)
    return min(pi * per, n_global), min((pi + 1) * per, n_global)


def make_multihost_tracer(cfg, mesh: sharded.RayMesh):
    """The sharded tracer: each process traces its own rays."""
    return sharded.make_sharded_tracer(cfg, mesh)
