"""Count one dry-run cell of the port under any source tree, with the
recurrent mixers' products counted by name.

  python3 tools/dryrun_regions.py --src <tree>/src --arch jamba-v0.1-52b \
      --shape train_4k [--mesh single] [--json out.json]

Runs ``repro_torch.launch.dryrun.run_cell`` of the package under
``--src`` (this checkout's ``src`` by default; a parent's unpacked ``git
archive`` to compare two trees) for the rank at the origin of the
production mesh, on meta tensors, with each of Mamba, the mLSTM and the
sLSTM wrapped in ``cost_hooks.region`` of its name where the model calls
it (a tree whose mixers already open their own region counts the same:
the innermost region of a name takes the products). Prints one line of
the record's FLOPs, bytes, collective bytes, roofline terms, useful
ratio, peak and ``region_flops``, and writes the whole record with
``--json``. Needs no card and no process group.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T
    from repro_torch.utils import cost_hooks

    def counted(name, fn):
        def run(*a, **k):
            with cost_hooks.region(name):
                return fn(*a, **k)
        return run

    for name, (fn, names) in list(T._RECURRENT.items()):
        T._RECURRENT[name] = (counted(name, fn), names)
    r = dryrun.run_cell(args.arch, args.shape, args.mesh == "multi")
    if r["status"] != "ok":
        print(json.dumps(r))
        return 1
    print(json.dumps(dict(
        src=args.src, arch=args.arch, shape=args.shape, mesh=args.mesh,
        flops=r["hlo_flops"], bytes=r["hlo_bytes"],
        collective_bytes=r["collective_bytes"],
        compute_s=r["compute_s"], memory_s=r["memory_s"],
        collective_s=r["collective_s"], dominant=r["dominant"],
        useful_flop_ratio=r["useful_flop_ratio"],
        peak_bytes=r["memory"]["peak_bytes"],
        region_flops=r["region_flops"], t_lower_s=r["t_lower_s"])))
    if args.json:
        Path(args.json).write_text(json.dumps(r, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
