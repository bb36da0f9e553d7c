"""Per-level V-cycle stats (`LevelStats`): the paper's Fig. 8 / Table 2
per-level accounting as a telemetry record. Port of ``repro.obs.vcycle``.

Two halves, matched to where the drivers already have the data:

* the **structural** side (nodes, edges, pins, the live pair and
  neighbourhood counts and their capacity occupancy, the kernel path)
  comes from the scalars the coarsening loop reads back once a level
  anyway (`run_coarsen_loop` reads them in one host read);
* the **quality** side (connectivity and cut of the level's refined
  partition, block size and distinct-incident-hyperedge slack against
  Omega and Delta) needs extra device reductions over each refined level,
  so it runs only under ``collect_stats=True``. `quality_scalars` returns
  six 0-d tensors built on the plain ``refine.pins_matrix`` (never the
  pins_count kernel, as the JAX function uses the plain one), and the
  refinement loop reads every level's scalars in one host read after the
  last level.

Telemetry never writes into the solve: `quality_scalars` only reads
``(d, parts)``, so ``collect_stats`` on or off gives the same bits.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class LevelStats:
    """One V-cycle level, finest (level 0) first. Fields are ``None`` when
    the side that produces them did not run: coarsening fields on the
    coarsest level (it never re-enters coarsening), quality fields unless
    ``collect_stats=True``."""

    level: int
    nodes: int
    edges: int
    pins: int
    # coarsening side (levels 0..n_levels-1)
    pairs_live: int | None = None
    nbr_entries: int | None = None
    pair_occupancy: float | None = None   # pairs_live / caps.pairs
    nbr_occupancy: float | None = None    # nbr_entries / caps.nbrs
    kernel_coarsen: int | None = None     # 0/1 kernel path taken
    # refinement side (every level, the coarsest included)
    kernel_refine: int | None = None      # gains-kernel reps (0..theta)
    connectivity: float | None = None     # of the level's refined partition
    cut_net: float | None = None
    max_size: int | None = None
    size_slack: int | None = None         # Omega - max block size
    max_inbound: int | None = None        # distinct incident hyperedges
    inbound_slack: int | None = None      # Delta - max_inbound

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


QUALITY_KEYS = ("connectivity", "cut_net", "max_size", "size_slack",
                "max_inbound", "inbound_slack")


def quality_scalars(d, parts, caps, kcap: int, omega,
                    delta) -> dict | None:
    """Quality stats of ``parts`` on level graph ``d``: a dict of six 0-d
    tensors on ``d``'s device, which the caller reads back with every other
    level's in one host read. The float sums are ``torch.sum`` over one
    1-D tensor, a fixed order with no float atomics. ``None`` for
    memory-sharded storage (``dist.graph.ShardedHypergraph``), as in the
    JAX package: its stripes are read only by the solver's collectives,
    and the stats are not worth more of them."""
    from repro_torch.core.hypergraph import DeviceHypergraph
    from repro_torch.core.refine import partition_sizes, pins_matrix

    if not isinstance(d, DeviceHypergraph):
        return None

    dev = d.device
    pins, pins_in = pins_matrix(d, parts, caps, kcap)
    e_live = torch.arange(caps.e, device=dev) < d.n_edges
    lam = torch.where(e_live, (pins > 0).sum(0, dtype=torch.int32), 0)
    w = torch.where(e_live, d.edge_w, 0.0)
    sizes = partition_sizes(d, parts, caps, kcap)
    inbound = (pins_in > 0).sum(1, dtype=torch.int32)
    max_size = sizes.max().to(torch.int32)
    max_inbound = inbound.max()
    return dict(
        connectivity=(w * (lam - 1).clamp(min=0)).sum(),
        cut_net=(w * (lam > 1)).sum(),
        max_size=max_size,
        size_slack=int(omega) - max_size,
        max_inbound=max_inbound,
        inbound_slack=int(delta) - max_inbound)


def read_quality(quality_dev: dict) -> dict:
    """``{level: {key: tensor}}`` to ``{level: {key: number}}`` in one host
    read: every scalar is stacked as float64, which holds the f32 sums and
    the int32 counts exactly. A level whose stats are ``None`` stays
    ``None``."""
    out = {lvl: None for lvl, q in quality_dev.items() if q is None}
    lvls = sorted(lvl for lvl, q in quality_dev.items() if q is not None)
    if not lvls:
        return out
    flat = torch.stack([quality_dev[lvl][k].to(torch.float64)
                        for lvl in lvls for k in QUALITY_KEYS]).cpu().tolist()
    for i, lvl in enumerate(lvls):
        vals = flat[i * len(QUALITY_KEYS): (i + 1) * len(QUALITY_KEYS)]
        out[lvl] = {k: (v if k in ("connectivity", "cut_net") else int(v))
                    for k, v in zip(QUALITY_KEYS, vals)}
    return out


def assemble(coarsen_meta: list[dict], refine_meta: dict[int, dict]
             ) -> list[LevelStats]:
    """Zip the coarsening loop's per-level structural records with the
    refinement loop's per-level records (kernel hits and quality scalars
    read back) into the finest-first `LevelStats` list on
    `PartitionResult.level_stats`."""
    n_levels = len(coarsen_meta)
    out = []
    for lvl in range(n_levels + 1):
        if lvl < n_levels:
            m = dict(coarsen_meta[lvl])
        else:
            m = dict(refine_meta.get(lvl, {}).get("structure") or {})
        r = refine_meta.get(lvl, {})
        q = r.get("quality") or {}
        out.append(LevelStats(
            level=lvl,
            nodes=int(m.get("nodes", 0)),
            edges=int(m.get("edges", 0)),
            pins=int(m.get("pins", 0)),
            pairs_live=m.get("pairs_live"),
            nbr_entries=m.get("nbr_entries"),
            pair_occupancy=m.get("pair_occupancy"),
            nbr_occupancy=m.get("nbr_occupancy"),
            kernel_coarsen=m.get("kernel_coarsen"),
            kernel_refine=r.get("kernel_refine"),
            connectivity=(float(q["connectivity"])
                          if "connectivity" in q else None),
            cut_net=float(q["cut_net"]) if "cut_net" in q else None,
            max_size=int(q["max_size"]) if "max_size" in q else None,
            size_slack=int(q["size_slack"]) if "size_slack" in q else None,
            max_inbound=(int(q["max_inbound"])
                         if "max_inbound" in q else None),
            inbound_slack=(int(q["inbound_slack"])
                           if "inbound_slack" in q else None)))
    return out
