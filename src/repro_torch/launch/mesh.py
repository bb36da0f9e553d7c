"""The meshes of the launchers, port of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
device and no process group (the dry run imports it on a host with
neither).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.dist.sharding import MESH_DIMS


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """The production mesh as its shape, with no ranks (what
    ``dist.Plan.abstract`` takes): 16 x 16 = 256 GPUs ``("data",
    "model")``; multi-pod adds a leading dim of 2 pods, 2 x 16 x 16
    ``("pod", "data", "model")``."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_host_mesh(model_parallel: int = 1) -> DeviceMesh:
    """A ``("data", "model")`` mesh of ``(world // mp, mp)`` over the
    default process group's ranks, ``mp = max(1, min(model_parallel,
    world))``, as the JAX function builds one over the local devices: on
    the CUDA devices under NCCL, else on the CPU. Raises without an
    initialised process group."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised default "
                           "process group (torch.distributed."
                           "init_process_group)")
    world = dist.get_world_size()
    mp = max(1, min(model_parallel, world))
    if world % mp:
        raise ValueError(f"model parallelism {mp} does not divide the "
                         f"world of {world} ranks")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (world // mp, mp), mesh_dim_names=MESH_DIMS)
