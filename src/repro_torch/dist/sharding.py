"""Parallelism plans over a ``("data", "model")`` mesh, port of the JAX
package's ``dist/sharding.py``.

A `Plan` owns a ``torch.distributed`` ``DeviceMesh`` with dims ``("data",
"model")`` (one process a rank), the device the ranks compute on and the
collectives of each group (`dist.comm`, its transport fixed here and
printed by ``describe``). The partitioner's "data" groups race refinement
repetitions as replicas; its "model" groups shard the pins- and
pairs-sized pipelines (``segops.ShardCtx``).

For the LM, ``rules`` maps logical axes (declared on ``Spec``s) to mesh
dims, key for key as the JAX ``Plan.make`` builds them:

  batch     -> "data"
  embed     -> "data" under FSDP, else None
  heads/kv_heads/mlp/experts/vocab -> "model"
  kv_seq    -> "model" when the dense KV cache is sequence-sharded
  kv_pages  -> "model" for the paged pool (pages striped over "model")
  attn_seq  -> "model" for sequence-parallel attention

and the boolean flags ``attn_p_bf16``, ``mla_flash`` and
``moe_local_dispatch`` ride in the same dict. Resolution (divisibility
fallback, one tensor dim a mesh dim) is ``models.common._resolve_pspec``.
Serving on a mesh acts on the "batch", "kv_seq" and "kv_pages" splits
(``models.common.CACHE_SPLIT_AXES``); the weights stay whole on every
rank, where the JAX package lays them out by ``param_shardings`` without
changing what is computed. Weight sharding and the flags that change the
computation (``seq_parallel_attn``, ``attn_p_bf16``, ``mla_flash``,
``moe_local``) are ROADMAP.md Queue A item 14i: ``check_ported`` raises
for the flags.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.dist.comm import Comm

MESH_DIMS = ("data", "model")
# the rules of computation-changing flags, each waiting for item 14i
UNPORTED_RULES = ("attn_seq", "attn_p_bf16", "mla_flash",
                  "moe_local_dispatch")


def lm_rules(*, fsdp: bool = True, seq_shard_kv: bool = True,
             moe_local: bool = False, seq_parallel_attn: bool = False,
             attn_p_bf16: bool = False, mla_flash: bool = False) -> dict:
    """The JAX ``Plan.make``'s rules on a ``("data", "model")`` mesh."""
    dp, tp = "data", "model"
    return {
        "batch": dp,
        "embed": dp if fsdp else None,
        "heads": tp,
        "kv_heads": tp,
        "mlp": tp,
        "experts": tp,
        "vocab": tp,
        "layers": None,
        "kv_seq": tp if seq_shard_kv else None,
        "kv_pages": tp if seq_shard_kv else None,
        "attn_seq": tp if seq_parallel_attn else None,
        "attn_p_bf16": attn_p_bf16 or None,
        "mla_flash": mla_flash or None,
        "moe_local_dispatch": moe_local or None,
    }


@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    mesh: DeviceMesh
    device: torch.device
    data: Comm
    model: Comm
    rules: dict[str, Any] = dataclasses.field(default_factory=lm_rules)

    @classmethod
    def make(cls, mesh: DeviceMesh, device=None, **flags) -> "Plan":
        """The plan of ``mesh`` for tensors on ``device`` (this rank's CUDA
        device unless named); ``flags`` are `lm_rules`'s (``fsdp``,
        ``seq_shard_kv``, ``moe_local``, ``seq_parallel_attn``,
        ``attn_p_bf16``, ``mla_flash``)."""
        if tuple(mesh.mesh_dim_names or ()) != MESH_DIMS:
            raise ValueError(f"the mesh dims must be {MESH_DIMS}, got "
                             f"{mesh.mesh_dim_names}")
        rules = lm_rules(**flags)
        if device is None:
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        return cls(mesh=mesh, device=device,
                   data=Comm(mesh.get_group("data"), device),
                   model=Comm(mesh.get_group("model"), device), rules=rules)

    def shape(self) -> dict:
        return dict(zip(MESH_DIMS, self.mesh.mesh.shape))

    def coords(self) -> dict:
        """This rank's coordinate along each mesh dim."""
        return dict(zip(MESH_DIMS, self.mesh.get_coordinate()))

    def pspec(self, *axes: str | None) -> tuple:
        """Logical axis names to the mesh dims each tensor dim splits over
        (a tuple of dims, or None), as the JAX ``Plan.pspec``: no shape, so
        no divisibility fallback; a mesh dim splits one tensor dim, the
        earlier winning; trailing Nones dropped."""
        entries: list = []
        used: set[str] = set()
        for name in axes:
            mapped = self.rules.get(name) if name else None
            if mapped is None:
                entries.append(None)
                continue
            dims = (mapped,) if isinstance(mapped, str) else tuple(mapped)
            if any(d in used for d in dims):
                entries.append(None)
                continue
            used.update(dims)
            entries.append(dims)
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    def dp_size(self) -> int:
        dp = self.rules["batch"]
        sh = self.shape()
        n = 1
        for a in ((dp,) if isinstance(dp, str) else tuple(dp)):
            n *= sh[a]
        return n

    def n_devices(self) -> int:
        return self.mesh.mesh.numel()

    def check_ported(self) -> None:
        """Raise for a rule whose computation is not ported yet."""
        set_ = [k for k in UNPORTED_RULES if self.rules.get(k) is not None]
        if set_:
            raise NotImplementedError(
                f"plan rules {set_} are not ported yet: ROADMAP.md Queue A "
                f"item 14i (training on a mesh)")

    def transport(self) -> str:
        return self.model.transport

    def describe(self) -> str:
        sh = self.shape()
        return (f"mesh data={sh['data']} model={sh['model']} "
                f"device={self.device} transport={self.transport()}")


def make_mesh(data: int, model: int, device=None, **flags) -> Plan:
    """The `Plan` of a ``(data, model)`` mesh over the default process
    group, whose world size must be ``data * model``; ``flags`` go to
    `Plan.make`. The mesh's groups take the default group's backend: gloo
    for several ranks on one card (their CUDA tensors staged through the
    host) or on the CPU, NCCL with one card a rank."""
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"mesh ({data}, {model}) needs {data * model} "
                         f"ranks, the world has {world}")
    backend = dist.get_backend()
    mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                            (data, model), mesh_dim_names=MESH_DIMS)
    return Plan.make(mesh, device, **flags)
