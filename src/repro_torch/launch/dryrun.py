"""Multi-pod dry run: one rank's step of every (arch x shape) cell on the
production meshes, counted on meta tensors, with roofline terms for an
H100; port of ``repro.launch.dryrun``.

The JAX package lowers and compiles each cell for 256 or 512 TPU chips.
The port builds the plan of one rank from the mesh's shape alone
(``dist.Plan.abstract``: no process group, no card, nothing compiles),
runs the rank's prefill or decode step on ``meta`` tensors and counts its
ops (``launch.op_cost``, the counterpart of ``hlo_cost``). A spec that
does not resolve, a shape that does not meet, an unsupported collective or
data-dependent code fails here. Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape decode_32k [--mesh single,multi] [--json out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list

What a rank's figures mean. A prefill or decode cell keeps the weights
whole on every rank (tensor-parallel weights in serving are ROADMAP.md
Queue A item 14n), so a rank computes its rows of the batch (over
"data", or over "pod" and "data") through the whole model, its positions
of the KV cache over "model". A ``train_4k`` cell runs the mesh train
step (``make_train_step(plan)``: the state at the rank's shard shapes,
autograd on meta tensors with every loop step run, the remat recompute
and the FSDP gathers counted as they run, the collectives of
``dist.autograd`` over ``MetaComm``s): attention, MLA, the MLP, the
encoder, the cross blocks, the embedding and the head tensor-parallel
over "model" where their dims split, a MoE layer's experts over "model"
on its capacity slots over "data", Mamba on its ``d_inner`` channels and
the mLSTM on its heads; only the sLSTM whole on each "model" rank
(``vis_proj`` has no "model" dim). ``hlo_flops`` is the rank's work and
``useful_flop_ratio`` (the model's FLOPs over the chips, against the
rank's) shows the redundancy that remains; nothing is scaled to look
like the JAX package's figures. A MoE layer gathers every "data" rank's
rows before its dispatch (the capacity is batch-global) and its experts'
outputs after it; ``region_flops["moe_experts"]`` holds the rank's
expert products (forward and recompute), ``"mamba"``, ``"mlstm"`` and
``"slstm"`` those of the recurrent mixers' bodies. ``memory`` holds a
rank's argument bytes (the weights or state shards, the whole batch's
inputs and the rank's cache shard), its output bytes (updated in place:
that is ``alias_size_in_bytes``, the JAX donation) and ``peak_bytes``,
the arguments plus the most bytes the step held at once. ``--no-donate``
changes nothing: the port's steps always update in place.

The record keeps the JAX package's keys: ``hlo_flops`` and ``hlo_bytes``
are the counter's ``flops`` and ``bytes``, ``xla_cost_*`` are None (no
compiler), ``t_lower_s`` is the seconds to build the inputs and count the
step (the port's lowering) and ``t_compile_s`` None. It adds
``"counted_on": "meta"`` and the rank's ``coords``.

The four flags that change the computation count as they run:
``--sp-attn`` (a rank's own query rows of prefill and train attention
where "model" does not divide the heads, their outputs gathered over
"model"), ``--p-bf16`` (bf16 probabilities before the PV product),
``--mla-flash`` (MLA's chunked absorbed form: no ``[B,H,S,S]`` scores)
and ``--moe-local`` (each rank dispatches its own rows: the rows'
all-gather before each MoE layer goes, and the balance loss's mean adds
an all-reduce). ``kernel_flops`` holds the products counted in each
kernel's plain version, by name (``flash_attn``: prefill attention).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# NVIDIA H100 SXM5 constants (per GPU)
# dense BF16 tensor-core FLOP/s (989.4 TFLOPS without sparsity) and HBM3
# bytes/s, from NVIDIA's H100 Tensor Core GPU datasheet
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
# bytes/s a GPU between hosts: one ConnectX-7 NDR port at 400 Gb/s, one a
# GPU in an HGX H100 node (NVIDIA DGX H100 documentation). A 16-wide "model"
# dim spans two 8-GPU nodes, so its ring runs at the inter-node rate, not
# NVLink's 450 GB/s a direction.
LINK_BW = 50e9


def count_params(pspecs, cfg) -> tuple[int, int]:
    """(total, active) parameter counts; MoE expert tensors scale by
    top_k/n_experts for the active count."""
    from repro_torch.models.common import spec_leaves
    total = active = 0
    for _, spec in spec_leaves(pspecs):
        n = int(np.prod(spec.shape))
        total += n
        if cfg.moe and "experts" in (spec.axes or ()):
            active += n * cfg.moe.top_k // cfg.moe.n_experts
        else:
            active += n
    return total, active


def model_flops(cfg, shape_name: str) -> float:
    """MODEL_FLOPS: 6*N_active*D for train, 2*N_active*D for prefill,
    2*N_active*B for one decode step."""
    from repro_torch.configs.registry import SHAPES
    from repro_torch.models import transformer as T
    sh = SHAPES[shape_name]
    _, active = count_params(T.lm_shapes(cfg), cfg)
    if sh["kind"] == "train":
        return 6.0 * active * sh["global_batch"] * sh["seq_len"]
    if sh["kind"] == "prefill":
        return 2.0 * active * sh["global_batch"] * sh["seq_len"]
    return 2.0 * active * sh["global_batch"]


def run_cell(arch: str, shape: str, multi_pod: bool,
             fsdp: bool = True, seq_shard_kv: bool = True,
             donate: bool = True, moe_local: bool = False,
             seq_parallel_attn: bool = False,
             attn_p_bf16: bool = False, mla_flash: bool = False,
             q_chunk: int = 0, k_chunk: int = 0,
             coords: dict | None = None) -> dict:
    """The record of one cell for the rank at ``coords`` (every dim 0
    unless given); see the module's docstring."""
    from repro_torch.configs import registry
    from repro_torch.configs.registry import cell_is_runnable

    base = registry.CONFIGS[arch]
    if q_chunk or k_chunk:
        registry.CONFIGS[arch] = base.scaled(
            q_chunk=q_chunk or base.q_chunk, k_chunk=k_chunk or base.k_chunk)
    try:
        ok, why = cell_is_runnable(arch, shape)
        if not ok:
            return dict(arch=arch, shape=shape,
                        mesh="multi" if multi_pod else "single",
                        status="skipped", reason=why)
        return _count_cell(arch, shape, multi_pod, coords, dict(
            fsdp=fsdp, seq_shard_kv=seq_shard_kv, moe_local=moe_local,
            seq_parallel_attn=seq_parallel_attn, attn_p_bf16=attn_p_bf16,
            mla_flash=mla_flash))
    finally:
        registry.CONFIGS[arch] = base


def _count_cell(arch, shape, multi_pod, coords, flags) -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.sharding import Plan
    from repro_torch.launch import op_cost, steps
    from repro_torch.launch.mesh import make_production_mesh

    t0 = time.time()
    plan = Plan.abstract(make_production_mesh(multi_pod=multi_pod), coords,
                         **flags)
    spec = steps.input_specs(arch, shape, plan)
    fn = steps.make_step(arch, shape, plan)
    args = steps.rank_args(spec, plan)
    out, walked = op_cost.count(fn, *args)
    t_lower = time.time() - t0
    arg_bytes = op_cost.tree_bytes(args)
    mem = dict(argument_size_in_bytes=arg_bytes,
               output_size_in_bytes=op_cost.tree_bytes(out),
               alias_size_in_bytes=op_cost.shared_bytes(out, args),
               peak_bytes=arg_bytes + walked["peak_bytes"])

    flops_total = float(walked["flops"])
    bytes_total = float(walked["bytes"])
    n_chips = plan.n_devices()
    mf = model_flops(get_config(arch), shape)
    compute_s = flops_total / PEAK_FLOPS
    memory_s = bytes_total / HBM_BW
    coll_s = walked["collective_bytes"] / LINK_BW
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", coll_s), key=lambda kv: kv[1])[0]
    return dict(
        arch=arch, shape=shape, mesh="multi" if multi_pod else "single",
        status="ok", n_chips=n_chips,
        t_lower_s=round(t_lower, 1), t_compile_s=None,
        hlo_flops=flops_total, hlo_bytes=bytes_total,
        xla_cost_flops=None, xla_cost_bytes=None,
        collective_bytes=walked["collective_bytes"],
        collective_counts=walked["collective_counts"],
        collective_bytes_by_op=walked["collective_bytes_by_op"],
        kernel_flops=walked["kernel_flops"],
        region_flops=walked["region_flops"],
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        dominant=dominant,
        model_flops=mf, model_flops_per_chip=mf / n_chips,
        useful_flop_ratio=(mf / n_chips) / flops_total if flops_total else 0,
        memory=mem, counted_on="meta", coords=plan.coords(),
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--json", default=None)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-seq-shard-kv", action="store_true")
    ap.add_argument("--no-donate", action="store_true")
    ap.add_argument("--moe-local", action="store_true",
                    help="rank-local MoE dispatch")
    ap.add_argument("--sp-attn", action="store_true",
                    help="sequence-parallel attention")
    ap.add_argument("--p-bf16", action="store_true",
                    help="bf16 PV probabilities")
    ap.add_argument("--mla-flash", action="store_true",
                    help="chunked latent MLA attention")
    ap.add_argument("--q-chunk", type=int, default=0)
    ap.add_argument("--k-chunk", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import SHAPES, list_configs
    if args.list:
        for a in list_configs():
            for s in SHAPES:
                print(f"{a} {s}")
        return 0

    results = []
    for mesh_kind in args.mesh.split(","):
        r = run_cell(args.arch, args.shape, multi_pod=(mesh_kind == "multi"),
                     fsdp=not args.no_fsdp,
                     seq_shard_kv=not args.no_seq_shard_kv,
                     donate=not args.no_donate, moe_local=args.moe_local,
                     seq_parallel_attn=args.sp_attn,
                     attn_p_bf16=args.p_bf16, mla_flash=args.mla_flash,
                     q_chunk=args.q_chunk, k_chunk=args.k_chunk)
        results.append(r)
        if r["status"] == "ok":
            print(f"[{r['mesh']}] {args.arch} x {args.shape}: "
                  f"counted on meta in {r['t_lower_s']}s | "
                  f"compute {r['compute_s']*1e3:.2f}ms "
                  f"memory {r['memory_s']*1e3:.2f}ms "
                  f"collective {r['collective_s']*1e3:.2f}ms "
                  f"-> {r['dominant']}-bound | "
                  f"useful-flop ratio {r['useful_flop_ratio']:.2f}")
            print("  memory:", r["memory"])
            print("  collectives:", r["collective_counts"])
        else:
            print(f"[{r['mesh']}] {args.arch} x {args.shape}: SKIP "
                  f"({r['reason']})")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
