"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (build, data and weights from the seed, warm-up, the first steps
the check reads), then ``--seconds`` of timed steps (``--trace 0``: the
cell's end-to-end metrics) or a traced window (``--trace 1``: its
per-layer metrics), then the check against the plain reference. The
last line of standard output is one JSON object; the compared numbers,
each beside its limit, are the last lines of standard error. Exits
non-zero, printing no result, without a CUDA card or when a module of
the JAX package or JAX was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one process with few threads: the runs' host work is the program's
    # own launches, which other threads of this process would slow
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # every cache the program or its libraries keep lives in the checkout
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench import core

    torch.set_num_threads(1)

    cell = core.load_cell(args.workload, args.seed)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA card(s)",
              file=sys.stderr)
        return 3
    result = core.run(cell, seconds=args.seconds, trace=bool(args.trace),
                      t0=T0)
    bad = core.forbidden_modules()
    if bad:
        print(f"bench: loaded {bad}; the benchmark measures the port alone",
              file=sys.stderr)
        return 4
    lines = core.check_lines([{"name": k, **v}
                              for k, v in result["checks"].items()])
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
