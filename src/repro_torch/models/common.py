"""Parameter specs and numeric primitives, port of ``repro.models.common``.

Every parameter is declared as a ``Spec(shape, axes)``, as in the JAX
package, so shapes and parameter counts compare spec by spec. A
``SpecModule`` registers one ``nn.Parameter`` per spec of a dict, with an
explicit device and dtype, and ``init_params_`` fills them with the
scales of the JAX ``materialize``: ``1/sqrt(fan_in)`` for normal leaves,
1.0 (or the spec's own scale) for ``embed``, zeros and ones where the
spec says so.
The numbers differ from JAX's (another generator); tests carry weights
across with ``models.convert.params_from_jax``.

On a mesh (``repro_torch.dist.Plan``), ``_resolve_pspec`` and ``pspecs``
resolve a Spec's logical axes to the mesh dims each tensor dim splits over
(a tuple of dims, or None a dim), as the JAX ones resolve a
``PartitionSpec``: the divisibility fallback, a mesh dim splitting one
tensor dim with the earlier dims winning, trailing Nones dropped; they read
only the mesh's shape. A serving cache takes the splits of
``CACHE_SPLIT_AXES`` ("batch" over "data", "kv_seq" and "kv_pages" over
"model"); ``shard_zeros`` allocates a rank's shards of a cache tree as a
``ShardTree`` (the tree with its Specs and resolved splits), and
``shard_of`` slices a whole leaf to a rank's shard. A serving cache keeps
its head, mlp and embed splits whole (tensor-parallel weights in serving
are ROADMAP.md Queue A item 14n).

Training on a mesh holds every parameter at its resolved split, which
gives a rank the JAX layout's bytes: ``init_shards_`` draws each leaf
whole in ``init_params_``'s generator order (the bits of one device's)
and keeps the rank's shard, so the whole state is never on one rank;
``param_pspecs`` gives a module's splits by parameter name, ``whole_of``
gathers a shard whole (a checkpoint's save) and ``mesh_weights`` hands a
block its weights for one forward: each leaf split over "data" gathered
(FSDP, the backward a sum-scatter), each leaf split over "model" kept as
the rank's shard (tensor parallelism) or gathered whole (a layer that
every "model" rank computes whole; see ``dist.autograd``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"     # normal | zeros | ones | embed
    scale: float | None = None  # default: 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def tree_map_specs(fn: Callable[[Spec], Any], tree):
    """Apply ``fn`` to every Spec of a nested dict, keeping its structure."""
    if is_spec(tree):
        return fn(tree)
    return {k: tree_map_specs(fn, v) for k, v in tree.items()}


def spec_leaves(tree, prefix: str = "") -> list[tuple[str, Spec]]:
    """``(dotted path, Spec)`` of every leaf, in dict order."""
    if is_spec(tree):
        return [(prefix, tree)]
    out = []
    for k, v in tree.items():
        out += spec_leaves(v, f"{prefix}.{k}" if prefix else k)
    return out


def leaf(tree: dict, path: str):
    """The leaf of a nested dict at a dotted ``spec_leaves`` path."""
    for k in path.split("."):
        tree = tree[k]
    return tree


def param_count(tree) -> int:
    return sum(int(np.prod(s.shape)) for _, s in spec_leaves(tree))


def stack_specs(tree, n: int, axis_name: str = "layers"):
    """Prepend a stacked leading dim (the layers axis) to every spec."""
    return tree_map_specs(
        lambda s: Spec((n,) + s.shape, (axis_name,) + s.axes, s.init, s.scale),
        tree)


def init_scale(spec: Spec) -> float:
    """Standard deviation ``materialize`` draws a normal/embed leaf with."""
    if spec.init == "embed":
        return spec.scale if spec.scale is not None else 1.0
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    return spec.scale if spec.scale is not None else \
        1.0 / math.sqrt(max(fan_in, 1))


def zeros(tree, device, dtype=torch.float32):
    """A nested dict of zero tensors with the specs' shapes."""
    return tree_map_specs(
        lambda s: torch.zeros(s.shape, dtype=dtype, device=device), tree)


# ---------------------------------------------------------------------------
# sharding on a mesh
# ---------------------------------------------------------------------------
def _resolve_pspec(spec: Spec, rules: dict[str, Any], mesh_shape) -> tuple:
    """The mesh dims each dim of ``spec`` splits over (a tuple of dims, or
    None), for ``rules`` on a mesh of ``mesh_shape`` ({dim: size}): a dim
    that its mesh dims' sizes do not divide stays whole, a mesh dim splits
    at most one tensor dim (earlier dims win: axes are declared most
    important first), trailing Nones dropped."""
    entries: list = []
    used: set[str] = set()
    for dim, name in zip(spec.shape, spec.axes):
        mapped = rules.get(name) if name else None
        if mapped is None:
            entries.append(None)
            continue
        dims = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        if any(d in used for d in dims):
            entries.append(None)
            continue
        if dim % math.prod(mesh_shape[d] for d in dims):
            entries.append(None)  # divisibility fallback: whole
        else:
            used.update(dims)
            entries.append(dims)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def pspecs(tree, rules: dict[str, Any], mesh_shape):
    return tree_map_specs(lambda s: _resolve_pspec(s, rules, mesh_shape),
                          tree)


# the logical axes whose splits a serving cache takes on a mesh
CACHE_SPLIT_AXES = ("batch", "kv_seq", "kv_pages")


def cache_pspec(spec: Spec, rules: dict[str, Any], mesh_shape) -> tuple:
    """``_resolve_pspec`` of a cache leaf, kept at the dims of
    ``CACHE_SPLIT_AXES`` (a head, mlp or embed split stays whole)."""
    ps = _resolve_pspec(spec, rules, mesh_shape)
    return tuple(e if name in CACHE_SPLIT_AXES else None
                 for e, name in zip(ps, spec.axes))


def part(dims, mesh_shape, coords) -> tuple[int, int]:
    """(index, count) of a rank's part of a tensor dim split over the mesh
    dims ``dims`` (row-major over them), the rank at ``coords``."""
    idx, n = 0, 1
    for d in dims or ():
        idx, n = idx * mesh_shape[d] + coords[d], n * mesh_shape[d]
    return idx, n


def shard_of(x, pspec: tuple, mesh_shape, coords):
    """The shard of the whole leaf ``x`` that the rank at ``coords`` holds
    under ``pspec``: its slice along each split dim (a view)."""
    for ax, dims in enumerate(pspec):
        if dims:
            i, n = part(dims, mesh_shape, coords)
            size = x.shape[ax] // n
            x = x.narrow(ax, i * size, size)
    return x


def local_shape(spec: Spec, pspec: tuple, mesh_shape) -> tuple[int, ...]:
    shape = list(spec.shape)
    for ax, dims in enumerate(pspec):
        if dims:
            shape[ax] //= math.prod(mesh_shape[d] for d in dims)
    return tuple(shape)


class ShardTree(dict):
    """A rank's shards of a tree of tensors (nested dicts, as ``zeros``
    makes them), with ``specs``, the tree's whole Specs, and ``pspecs``,
    each leaf's split (``cache_pspec``). A plain dict under a plan is a
    tree whole on every rank."""

    def __init__(self, tree: dict, specs, pspecs):
        super().__init__(tree)
        self.specs = specs
        self.pspecs = pspecs


def shard_zeros(tree, plan, device, dtype=torch.float32) -> ShardTree:
    """Zeros of a rank's shards of the cache Spec tree ``tree`` under
    ``plan``, allocated at the shard's shape (never whole, then cut)."""
    sh = plan.shape()
    ps = tree_map_specs(lambda s: cache_pspec(s, plan.rules, sh), tree)
    out = tree_map_specs(lambda s: torch.zeros(
        local_shape(s, cache_pspec(s, plan.rules, sh), sh), dtype=dtype,
        device=device), tree)
    return ShardTree(out, tree, ps)


# ---------------------------------------------------------------------------
# parameters on a mesh
# ---------------------------------------------------------------------------
def module_specs(module: nn.Module):
    """``(name, parameter, Spec)`` of every parameter of the SpecModules in
    ``module``, in ``named_parameters`` order."""
    specs = {}
    for prefix, m in module.named_modules():
        if isinstance(m, SpecModule):
            for n, s in m.specs.items():
                specs[f"{prefix}.{n}" if prefix else n] = s
    return [(n, p, specs[n]) for n, p in module.named_parameters()]


def param_pspecs(module: nn.Module, plan) -> dict[str, tuple]:
    """Each parameter's resolved split under ``plan``, by name."""
    sh = plan.shape()
    return {n: _resolve_pspec(s, plan.rules, sh)
            for n, _, s in module_specs(module)}


def set_param(module: nn.Module, name: str, t: torch.Tensor,
              requires_grad: bool = False) -> None:
    """Replace the parameter ``name`` (dotted) of ``module`` by ``t``."""
    *path, last = name.split(".")
    for k in path:
        module = getattr(module, k)
    setattr(module, last, nn.Parameter(t, requires_grad=requires_grad))


@torch.no_grad()
def init_shards_(module: nn.Module, generator: torch.Generator, plan,
                 dtype=torch.float32) -> None:
    """Give every parameter of ``module`` (made on any device, the meta
    device for one) this rank's shard under ``plan`` on ``plan.device``,
    filled as ``init_params_`` fills the whole: each leaf is drawn whole in
    its generator order, the shard kept and the rest freed."""
    sh, at = plan.shape(), plan.coords()
    for m in module.modules():
        if not isinstance(m, SpecModule):
            continue
        for name, s in m.specs.items():
            ps = _resolve_pspec(s, plan.rules, sh)
            local = local_shape(s, ps, sh)
            if s.init == "zeros":
                t = torch.zeros(local, dtype=dtype, device=plan.device)
            elif s.init == "ones":
                t = torch.ones(local, dtype=dtype, device=plan.device)
            else:
                whole = torch.empty(s.shape, dtype=dtype,
                                    device=plan.device)
                whole.normal_(0.0, init_scale(s), generator=generator)
                t = shard_of(whole, ps, sh, at).clone()
                del whole
            setattr(m, name, nn.Parameter(t, requires_grad=False))


def whole_of(x: torch.Tensor, pspec: tuple, plan) -> torch.Tensor:
    """The whole leaf of which ``x`` is this rank's shard under
    ``pspec``: gathered over each mesh dim that splits it (no
    autograd)."""
    for ax, dims in enumerate(pspec):
        for d in dims or ():
            comm = plan.comm(d)
            if comm.size > 1:
                x = torch.cat(comm.all_gather(x).unbind(0), dim=ax)
    return x


class Tree(dict):
    """A nested dict of a module's tensors, keys also read as attributes
    (``tree.encoder.pos``); a ``ModuleList``'s children are a list."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


def _tree(flat: dict):
    root: dict = {}
    for name, t in flat.items():
        *path, last = name.split(".")
        node = root
        for k in path:
            node = node.setdefault(k, {})
        node[last] = t

    def build(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [build(node[k]) for k in sorted(node, key=int)]
        return Tree({k: build(v) for k, v in node.items()})
    return build(root)


def mesh_weights(module: nn.Module, plan, how=None, only=None):
    """``module``'s weights for one forward on this rank of ``plan``, as a
    `Tree`: every leaf split over "data" all-gathered (one collective for
    all of them; the backward sums the gradients and scatters), then each
    leaf by ``how(name)`` over "model": "shard" keeps the rank's part
    (tensor parallelism), "same" (the default) gathers a split leaf whole
    for a computation that every "model" rank does alike (the backward
    keeps the rank's stripe), "diff" gathers it whole where the ranks use
    it differently (the backward sums; a leaf already whole goes through
    ``copy_to``, whose backward sums). ``only(name)`` picks the leaves
    (all by default)."""
    from repro_torch.dist import autograd as DA
    how = how or (lambda name: "same")
    leaves = [(n, p, _resolve_pspec(s, plan.rules, plan.shape()))
              for n, p, s in module_specs(module)
              if only is None or only(n)]
    out = {n: p for n, p, _ in leaves}

    def axis(ps, dim):
        for ax, dims in enumerate(ps):
            if dims and dim in dims:
                return ax
        return None

    def gather(names, dim, comm, reduce):
        names = [(n, axis(ps, dim)) for n, ps in names]
        got = DA.gather([out[n] for n, _ in names], [a for _, a in names],
                        comm, reduce)
        out.update(zip((n for n, _ in names), got))

    gather([(n, ps) for n, _, ps in leaves
            if axis(ps, "data") is not None], "data", plan.comm("data"),
           True)
    for mode in ("same", "diff"):
        gather([(n, ps) for n, _, ps in leaves if how(n) == mode
                and axis(ps, "model") is not None], "model", plan.model,
               mode == "diff")
    for n, _, ps in leaves:
        if how(n) == "diff" and axis(ps, "model") is None:
            out[n] = DA.copy_to(out[n], plan.model)
    return _tree(out)


class SpecModule(nn.Module):
    """A module whose parameters are the leaves of a dict of Specs (nested
    dicts become child SpecModules). ``p["name"]`` reads a parameter or a
    child, so the functional layers take a SpecModule or a plain dict."""

    def __init__(self, specs: dict, device=None, dtype=torch.float32):
        super().__init__()
        self.specs = {}
        for name, s in specs.items():
            if is_spec(s):
                self.specs[name] = s
                self.register_parameter(name, nn.Parameter(
                    torch.empty(s.shape, device=device, dtype=dtype),
                    requires_grad=False))
            else:
                self.add_module(name, SpecModule(s, device, dtype))

    def __getitem__(self, name: str):
        return getattr(self, name)


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator) -> None:
    """Fill the parameters of every SpecModule in ``module`` as
    ``materialize`` does, drawing from ``generator`` (which lies on the
    parameters' device)."""
    for m in module.modules():
        if not isinstance(m, SpecModule):
            continue
        for name, s in m.specs.items():
            p = getattr(m, name)
            if s.init == "zeros":
                p.zero_()
            elif s.init == "ones":
                p.fill_(1.0)
            else:
                p.normal_(0.0, init_scale(s), generator=generator)


# ---------------------------------------------------------------------------
# numeric primitives
# ---------------------------------------------------------------------------
def rms_norm(x, gamma, eps=1e-6):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * gamma


def layer_norm(x, gamma, beta, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return (((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma
            + beta)


def rope_freqs(head_dim: int, theta: float = 1e4, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 1e4):
    """x: [..., S, H, D] (D even), positions: broadcastable to [..., S].
    Rotates split halves (not interleaved pairs), angles in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # [D/2]
    ang = positions[..., :, None, None].float() * freqs     # [...,S,1,D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    return (nn.functional.silu(x @ w_gate) * (x @ w_up)) @ w_down


def softmax_cross_entropy(logits, labels, z_loss: float = 0.0):
    """Mean token CE; logits [..., V] f32-upcast; labels int (-1 = pad).

    The label logit is a gather where the JAX package sums a one-hot mask:
    the mask's sum adds exact zeros to the one logit, so both give its
    bits, and the gather's gradient lands on the same one entry."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    idx = labels.long().clamp(min=0)[..., None]
    ll = torch.gather(logits, -1, idx)[..., 0]
    return ce_from_terms(lse, ll, labels, z_loss)


def ce_from_terms(lse, ll, labels, z_loss: float = 0.0):
    """`softmax_cross_entropy` from each token's log-sum-exp ``lse`` and
    label logit ``ll`` (f32): the mean over the labels >= 0."""
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    mask = labels >= 0
    return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1)
