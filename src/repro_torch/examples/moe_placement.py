"""The paper's technique as a framework feature: place MoE experts on EP
shards with the constrained hypergraph partitioner, minimizing all-to-all
fan-out under a distinct-inbound-route budget — then *re-place* them as the
routing load shifts, using the streaming repartitioner (incremental
`GraphDelta` + warm refine-only solve) instead of a cold solve per window.

  PYTHONPATH=src python -m repro_torch.examples.moe_placement [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import metrics, planner

N_SHARDS = 8


def shifted_trace(cfg, trace: np.ndarray, frac: float,
                  seed: int) -> np.ndarray:
    """Shifting load: resample ``frac`` of the token rows from a freshly
    seeded router sample — most co-activation sets persist (their observed
    frequencies drift), a few vanish, a few appear."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(trace), size=int(len(trace) * frac), replace=False)
    out = trace.copy()
    out[idx] = planner.synth_routing_trace(cfg, n_tokens=len(idx),
                                           seed=seed)[: len(idx)]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the solves (default: CUDA)")
    args = ap.parse_args(argv)
    cfg = get_config("deepseek-v2-236b")
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, n_experts=64, top_k=6))

    # ---- window 0: cold solve -----------------------------------------------
    trace0 = planner.synth_routing_trace(cfg, seed=0)
    t0 = time.perf_counter()
    out = planner.plan_expert_placement(cfg, n_shards=N_SHARDS, trace=trace0,
                                        theta=6, device=args.device)
    t_cold = time.perf_counter() - t0
    rep = out["report"]
    print(f"experts: 64, EP shards: {N_SHARDS} (8 experts/shard)")
    print("routing-group connectivity (all-to-all spans):")
    print(f"  identity placement : {rep['connectivity_identity']:.0f}")
    print(f"  partitioned        : {rep['connectivity']:.0f}")
    print(f"  reduction          : {rep['a2a_reduction']:.2f}x")
    print(f"shard loads valid: {rep['size_ok']} (max {rep['max_size']})")
    print("expert -> slot permutation (first 16):", out["perm"][:16].tolist())
    print(f"cold solve: {t_cold:.3f}s ({out['n_levels']} V-cycle levels)")

    # ---- windows 1..3: the load shifts; re-place warm -----------------------
    print("\nshifting load (10% of tokens re-routed per window):")
    trace = trace0
    for window in range(1, 4):
        trace = shifted_trace(cfg, trace, frac=0.10, seed=window)
        prev_parts = out["parts"]
        t0 = time.perf_counter()
        out = planner.replan_expert_placement(cfg, out, n_shards=N_SHARDS,
                                              trace=trace, theta=6,
                                              device=args.device)
        t_warm = time.perf_counter() - t0
        rep = out["report"]
        # before/after on the SAME (shifted) graph: cost of keeping the stale
        # placement vs the warm re-refined one
        stale = metrics.connectivity(out["graph"], prev_parts)
        print(f"  window {window}: mode={out['mode']:<6} "
              f"{t_warm:.3f}s vs cold {t_cold:.3f}s "
              f"({t_cold / max(t_warm, 1e-9):.1f}x faster), "
              f"connectivity {stale:.0f} -> {rep['connectivity']:.0f}, "
              f"loads valid: {rep['size_ok']}")


if __name__ == "__main__":
    main()
