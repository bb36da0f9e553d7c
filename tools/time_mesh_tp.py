"""Phase 22's tensor-parallel passes of ``chip_smoke.py`` alone on one
card, each held to its one-device pass.

  python3 tools/time_mesh_tp.py [--arch jamba-v0.1-52b --arch ...]
      [--plant-w-in-same]

The parent computes each ``chip_smoke.tp_case``'s one-device pass on the
card (``chip_smoke.tp_refs``), then spawns four gloo ranks of a (2, 2)
mesh on the same card, each running ``chip_smoke.mesh_pass`` of every
case, and prints for each rank the loss and its relative gap to one
device's, ``chip_smoke.grad_gaps`` (the largest norm gap and
leading-block error over the gradient shards, by leaf), the split mixer
(``chip_smoke.mixer_split``), the pass's seconds, peak memory,
host-staged collectives and kernel launches. ``--plant-w-in-same`` runs
the ranks again with a split Mamba's ``w_in`` gathered for a computation
every rank does alike (its backward keeping the rank's contiguous
stripe, the wrong columns), to show what the gradient gaps read on that
fault. Needs a CUDA device; about 2 min for jamba and xlstm.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (sets CUBLAS_WORKSPACE_CONFIG first)


def _deterministic(torch) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)


def rank(r, archs, plant):
    """One rank of the (2, 2) mesh: ``chip_smoke.mesh_pass`` of each of
    ``archs``, with ``w_in``'s fault planted where ``plant``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    _deterministic(torch)
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.models import transformer as T
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    plan = make_mesh(2, 2, dev)
    if plant:
        how = T._TP.how
        T._TP.how = lambda tp, n: ("same" if tp.mamba and n == "mixer.w_in"
                                   else how(tp, n))
    return {a: cs.mesh_pass(torch, plan, *cs.tp_case(torch, a, dev))
            for a in archs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", choices=cs.TP_ARCHS)
    ap.add_argument("--plant-w-in-same", action="store_true")
    args = ap.parse_args(argv)
    archs = tuple(args.arch or (cs.JAMBA_ARCH, cs.XLSTM_ARCH))

    import torch
    if not torch.cuda.is_available():
        print("time_mesh_tp: no CUDA device", file=sys.stderr)
        return 1
    _deterministic(torch)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.dist.spawn import run_ranks
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{card}; torch {torch.__version__} cuda {torch.version.cuda}")
    cs.TP_ARCHS = archs
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ref = cs.tp_refs(torch, card)
    print(f"one-device passes {time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    torch.cuda.empty_cache()
    for plant in (False, True) if args.plant_w_in_same else (False,):
        t0 = time.perf_counter()
        outs = run_ranks(rank, 4, archs, plant, timeout=cs.DIST_TIMEOUT)
        print(f"w_in planted same: {plant}; the spawn "
              f"{time.perf_counter() - t0:.1f} s")
        for o in outs:
            for a, t in o.items():
                want = ref[a]
                gap = abs(t["loss"] - want["loss"]) / abs(want["loss"])
                gaps = cs.grad_gaps(t["grads"],
                                    want["grads"][cs.rank_key(t["coords"])])
                st = t["staged"]
                print(f"  {a} rank {t['coords']}: loss {t['loss']!r} against "
                      f"{want['loss']!r} (gap {gap:.3g}); gradient gaps "
                      f"{gaps}; split {t['split']}; pass "
                      f"{t['wall']:.2f} s, peak "
                      f"{t['peak'] / 2**30:.3f} GiB, staged {st['copies']} "
                      f"copies {st['bytes'] / 2**30:.3f} GiB "
                      f"{st['seconds']:.2f} s; launches "
                      f"{sum(t['launches'].values())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
