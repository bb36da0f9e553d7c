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
fallback, one tensor dim a mesh dim) is ``models.common._resolve_pspec``;
``param_pspecs`` (and ``param_shardings``, the same splits: the port's
sharding of a tensor is its split) resolves a Spec tree, ``constraint``
an activation's logical axes at its shape, where the JAX package
constrains a layout: the port computes its splits explicitly and reads
there which dims the JAX layout splits.

Training on a mesh holds every state leaf as its shard under
``param_pspecs`` (``models.transformer.materialize_lm`` with a plan)
and computes every layer but the recurrent mixers tensor-parallel over
"model" where ``constraint`` splits its heads, hidden, vocab or expert
dims, a MoE layer's capacity over "data" (``models.transformer``,
``models.layers.ExpertParallel``); serving keeps the weights whole on
every rank and acts on the "batch", "kv_seq" and "kv_pages" splits
(``models.common.CACHE_SPLIT_AXES``). The flags that change the
computation act in the model code, in train and serving alike:
``attn_seq`` and ``attn_p_bf16`` in attention (``transformer.attn_flags``:
a rank's own query rows, bf16 probabilities before the PV product),
``mla_flash`` in MLA (``layers.mla_attention_flash``) and
``moe_local_dispatch`` in MoE (``layers.moe_apply_local_dispatch``).

``Plan.abstract`` builds the plan of a mesh that exists only as its shape
(``launch.mesh.make_production_mesh``: 16 x 16 ``("data", "model")`` or 2
x 16 x 16 ``("pod", "data", "model")``) for one rank's coordinates: no
process group, tensors on the ``meta`` device, each group a
``comm.MetaComm`` of its size. The rules then follow the JAX ``Plan.make``
on both meshes: "batch" over every dim but "model" (``("pod", "data")``
on the multi-pod mesh), "embed" over "data" alone under FSDP. It is what
the dry run (``launch.dryrun``) counts on. A process-group mesh with a
"pod" dim is ROADMAP.md Queue A item 14k.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.dist.comm import Comm, MetaComm
from repro_torch.models import common

MESH_DIMS = ("data", "model")
# the dims of a mesh Plan.abstract takes: the production meshes'
ABSTRACT_DIMS = (MESH_DIMS, ("pod",) + MESH_DIMS)


def lm_rules(*, dims: tuple = MESH_DIMS, fsdp: bool = True,
             seq_shard_kv: bool = True, moe_local: bool = False,
             seq_parallel_attn: bool = False, attn_p_bf16: bool = False,
             mla_flash: bool = False) -> dict:
    """The JAX ``Plan.make``'s rules on a mesh of ``dims``: "batch" over
    every dim but "model" (one dim's name, or a tuple of them), FSDP's
    "embed" over "data" alone."""
    dp_dims = tuple(d for d in dims if d != "model")
    dp = dp_dims[0] if len(dp_dims) == 1 else dp_dims
    tp = "model" if "model" in dims else None
    return {
        "batch": dp,
        "embed": ("data" if "data" in dims else dp) if fsdp else None,
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
    # a plan of ``abstract``: the mesh's dims, sizes and this rank's
    # coordinates, where ``mesh`` is None
    dims: tuple = MESH_DIMS
    sizes: tuple | None = None
    at: tuple | None = None

    @classmethod
    def make(cls, mesh: DeviceMesh, device=None, **flags) -> "Plan":
        """The plan of ``mesh`` for tensors on ``device`` (this rank's CUDA
        device unless named); ``flags`` are `lm_rules`'s (``fsdp``,
        ``seq_shard_kv``, ``moe_local``, ``seq_parallel_attn``,
        ``attn_p_bf16``, ``mla_flash``)."""
        if tuple(mesh.mesh_dim_names or ()) != MESH_DIMS:
            raise ValueError(
                f"the mesh dims must be {MESH_DIMS}, got "
                f"{mesh.mesh_dim_names} (a process-group mesh with a "
                f"\"pod\" dim is ROADMAP.md Queue A item 14k; "
                f"Plan.abstract takes one as a shape)")
        rules = lm_rules(**flags)
        if device is None:
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        return cls(mesh=mesh, device=device,
                   data=Comm(mesh.get_group("data"), device),
                   model=Comm(mesh.get_group("model"), device), rules=rules)

    @classmethod
    def abstract(cls, shape: dict, coords: dict | None = None,
                 **flags) -> "Plan":
        """The plan of the rank at ``coords`` (every dim 0 unless given)
        on a mesh that is only its ``shape`` ({dim: size}, the dims one of
        ``ABSTRACT_DIMS``): no process group, tensors on the meta device,
        the "data" comm a `MetaComm` over the batch's dims (their product
        on a multi-pod mesh), the "model" comm one over "model"; ``flags``
        as in `make`."""
        dims = tuple(shape)
        if dims not in ABSTRACT_DIMS:
            raise ValueError(f"the mesh dims must be one of "
                             f"{ABSTRACT_DIMS}, got {dims}")
        at = {d: 0 for d in dims} if coords is None else dict(coords)
        if set(at) != set(dims) or any(not 0 <= at[d] < shape[d]
                                       for d in dims):
            raise ValueError(f"coords {coords} on a mesh of {shape}")
        rules = lm_rules(dims=dims, **flags)
        dp = rules["batch"]
        rank, size = 0, 1
        for d in ((dp,) if isinstance(dp, str) else dp):
            rank, size = rank * shape[d] + at[d], size * shape[d]
        return cls(mesh=None, device=torch.device("meta"),
                   data=MetaComm(size, rank),
                   model=MetaComm(shape["model"], at["model"]), rules=rules,
                   dims=dims, sizes=tuple(shape[d] for d in dims),
                   at=tuple(at[d] for d in dims))

    def shape(self) -> dict:
        sizes = self.sizes if self.mesh is None else self.mesh.mesh.shape
        return dict(zip(self.dims, map(int, sizes)))

    def coords(self) -> dict:
        """This rank's coordinate along each mesh dim."""
        at = self.at if self.mesh is None else self.mesh.get_coordinate()
        return dict(zip(self.dims, at))

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

    def param_pspecs(self, spec_tree):
        """Each Spec's resolved split (``common._resolve_pspec``)."""
        return common.pspecs(spec_tree, self.rules, self.shape())

    # the port's sharding of a tensor is its split
    param_shardings = param_pspecs

    def constraint(self, x, *axes: str | None) -> tuple:
        """The split the JAX ``Plan.constraint`` imposes on ``x`` by its
        logical ``axes`` (the resolver at ``x``'s shape: a dim its mesh
        dims do not divide stays whole). The port computes on explicit
        shards, so this changes nothing and returns the split, which the
        tensor-parallel paths read. ``x`` may be a shape."""
        shape = tuple(x.shape) if hasattr(x, "shape") else tuple(x)
        return common._resolve_pspec(common.Spec(shape, tuple(axes)),
                                     self.rules, self.shape())

    def splits(self, pspec, ax: int, dim: str) -> bool:
        """Whether the split ``pspec`` splits tensor dim ``ax`` over the
        mesh dim ``dim`` (of more than one rank)."""
        return (ax < len(pspec) and pspec[ax] is not None
                and dim in pspec[ax] and self.shape()[dim] > 1)

    def comm(self, dim: str):
        """The collectives over one mesh dim: ``model``, or ``data`` where
        the batch splits over "data" alone; on an abstract multi-pod mesh
        a `MetaComm` over that one dim ("data" or "pod")."""
        if dim == "model":
            return self.model
        if self.rules["batch"] == dim:
            return self.data
        if self.mesh is None and dim in self.dims:
            return MetaComm(self.shape()[dim], self.coords()[dim])
        raise ValueError(f"no collectives over {dim!r} on a mesh of "
                         f"{self.dims}")

    def dp_size(self) -> int:
        dp = self.rules["batch"]
        sh = self.shape()
        n = 1
        for a in ((dp,) if isinstance(dp, str) else tuple(dp)):
            n *= sh[a]
        return n

    def n_devices(self) -> int:
        n = 1
        for size in self.shape().values():
            n *= size
        return n

    def transport(self) -> str:
        return self.model.transport

    def describe(self) -> str:
        dims = " ".join(f"{d}={n}" for d, n in self.shape().items())
        return (f"mesh {dims} device={self.device} "
                f"transport={self.transport()}")


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
