"""Readings for the limits of a cell's check, on the chip at the cell's
own size (the benchmark's own runs do not run this).

    python3 bench/calibrate.py --workload <cell> --seeds 11 12 13 --control
    python3 bench/calibrate.py --workload <cell> --seeds 11 12 13 \\
        --fault half_batch [--seconds 2]

``--control``: the plain reference computed in the precision below the
configuration's (TF32 for float32, float8 for bfloat16) put in the
program's place, compared with the reference as a run compares the
program. ``--fault``: a whole run (short window) with the fault planted
in the program (``faults.py``). Prints one JSON line a seed with every
compared number.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import core, faults

    for seed in args.seeds:
        cell = core.load_cell(args.workload, seed, args.device)
        t0 = time.perf_counter()
        if args.control:
            path = core.load("paths", cell.config["path"]).Path(cell)
            path.inputs()
            with torch.no_grad():
                want = path.reference()
                got = path.reference(control=True)
            checks = path.compare(got, want)
            kind = "control"
        else:
            undo = faults.plant(cell.config["path"], args.fault)
            try:
                res = core.run(cell, seconds=args.seconds, trace=False,
                               t0=t0)
            finally:
                undo()
            checks = [{"name": k, **v} for k, v in res["checks"].items()]
            kind = args.fault
        print(json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                          "seconds": time.perf_counter() - t0,
                          "checks": {c["name"]: c["value"]
                                     for c in checks}}), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
