"""The partitioner's parallelism plan over a ``("data", "model")`` mesh,
port of the partitioner's part of the JAX package's ``dist/sharding.py``.

A `Plan` owns a ``torch.distributed`` ``DeviceMesh`` with dims ``("data",
"model")`` (one process a rank) and the device the ranks compute on. The
"data" groups race refinement repetitions as replicas; the "model" groups
shard the pins- and pairs-sized pipelines (``segops.ShardCtx``). The
transport of each group (`dist.comm`) is fixed here and printed by
``describe``. The LM sharding rules of the JAX ``Plan`` (``fsdp``,
``param_shardings``, ...) wait for ROADMAP.md Queue A item 14.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.dist.comm import Comm

MESH_DIMS = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Plan:
    mesh: DeviceMesh
    device: torch.device
    data: Comm
    model: Comm

    @classmethod
    def make(cls, mesh: DeviceMesh, device=None) -> "Plan":
        """The plan of ``mesh`` for tensors on ``device`` (this rank's CUDA
        device unless named)."""
        if tuple(mesh.mesh_dim_names or ()) != MESH_DIMS:
            raise ValueError(f"the mesh dims must be {MESH_DIMS}, got "
                             f"{mesh.mesh_dim_names}")
        if device is None:
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        return cls(mesh=mesh, device=device,
                   data=Comm(mesh.get_group("data"), device),
                   model=Comm(mesh.get_group("model"), device))

    def shape(self) -> dict:
        return dict(zip(MESH_DIMS, self.mesh.mesh.shape))

    def dp_size(self) -> int:
        return self.shape()["data"]

    def n_devices(self) -> int:
        return self.mesh.mesh.numel()

    def transport(self) -> str:
        return self.model.transport

    def describe(self) -> str:
        sh = self.shape()
        return (f"mesh data={sh['data']} model={sh['model']} "
                f"device={self.device} transport={self.transport()}")


def make_mesh(data: int, model: int, device=None) -> Plan:
    """The `Plan` of a ``(data, model)`` mesh over the default process
    group, whose world size must be ``data * model``. The mesh's groups
    take the default group's backend: gloo for several ranks on one card
    (their CUDA tensors staged through the host) or on the CPU, NCCL with
    one card a rank."""
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"mesh ({data}, {model}) needs {data * model} "
                         f"ranks, the world has {world}")
    backend = dist.get_backend()
    mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                            (data, model), mesh_dim_names=MESH_DIMS)
    return Plan.make(mesh, device)
