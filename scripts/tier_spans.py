"""Where a tier round's device time goes, by the program's spans, on the
card; and what recording the spans costs.

    python3 scripts/tier_spans.py phi3_tier_1k 2147484203 [--pairs 4]

Sets up a cell of ``BENCHMARK.json`` as the benchmark does
(``bench/paths/``), then traces ``--pairs`` pairs of windows with
``bench/spans.py::SpanTracer``, one with its span log and one without,
in turns (on, off; then off, on; ...). Prints each window's host
seconds, busy share and what the host did over it (CPU seconds, full
garbage collections, the allocator's retries and its cudaMalloc and
cudaFree calls), and the medians with the log on and off;
then, over the windows with the log, the device milliseconds a round
under each span by kernel family (``bench.spans.FAMILIES``), the share
of device time under a span, the idle gaps by the span the host was in
when each began, and the costliest kernels outside GEMM, attention and
the prox step, by span; and, for a MoE model, the share of the MoE
layers' (token, choice) pairs over capacity (the ``moe`` spans'
``dropped`` over ``pairs``).
"""
import argparse
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def split(cell, windows) -> None:
    """Print the per-span split of ``windows`` ((TraceData, Window)
    pairs traced with the log), a round's share each."""
    from bench import spans

    n = sum(len(spans.rounds(w)) for _, w in windows) or 1
    table, names, idle = {}, {}, {}
    for t, w in windows:
        for op, sp in spans.attribute(w):
            k, f = sp[0] if sp else "(none)", spans.family(op[0])
            table[k, f] = table.get((k, f), 0.0) + op[2] / 1e3 / n
            if f not in ("gemm", "attention", "prox"):
                names[k, op[0][:90]] = names.get((k, op[0][:90]), 0.0) \
                    + op[2] / 1e3 / n
        for k, v in spans.idle_by_span(t, w).items():
            idle[k or "(none)"] = idle.get(k or "(none)", 0.0) + v * 1e3 / n
    share = min(spans.coverage(w) or 0.0 for _, w in windows)
    took = sum(t.window_s for t, _ in windows)
    busy = sum(t.busy_s for t, _ in windows)
    print(f"{cell}: {n} rounds, {1e3 * took / n:.3f} ms a round traced, "
          f"{1e3 * busy / n:.3f} busy, at least {share:.3f}% of device "
          f"time under a span")
    fams = [f for f, _ in spans.FAMILIES] + ["other"]
    print(f"{cell}: device ms a round {'':22}"
          + "".join(f"{f:>12}" for f in fams) + "         all")
    for k in sorted({k for k, _ in table}):
        row = [table.get((k, f), 0.0) for f in fams]
        print(f"{cell}: {k:40}" + "".join(f"{v:12.3f}" for v in row)
              + f"{sum(row):12.3f}")
    for k, v in sorted(idle.items(), key=lambda kv: -kv[1]):
        print(f"{cell}: idle {v:10.3f} ms a round, host in {k}")
    for (k, nm), v in sorted(names.items(), key=lambda kv: -kv[1])[:25]:
        print(f"{cell}: {v:10.3f} ms a round in {k}: {nm}")
    pairs = sum(a["pairs"] for _, w in windows for _, _, _, a in w.spans
                if "pairs" in a)
    if pairs:
        dropped = sum(int(a["dropped"]) for _, w in windows
                      for _, _, _, a in w.spans if "dropped" in a)
        print(f"{cell}: (token, choice) pairs over capacity in the MoE "
              f"layers' forwards: {dropped} of {pairs} "
              f"({100 * dropped / pairs:.3f}%)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("workload")
    ap.add_argument("seed", type=int)
    ap.add_argument("--pairs", type=int, default=1,
                    help="pairs of windows, with the span log and without")
    args = ap.parse_args(argv)

    import torch

    from bench import core
    from bench.spans import SpanTracer

    torch.set_num_threads(1)
    cell = core.load_cell(args.workload, args.seed)
    path = core.load("paths", cell.config["path"]).Path(cell)
    path.setup()
    rows, traced = {"on": [], "off": []}, []
    for i in range(args.pairs):
        for mode in ("on", "off") if i % 2 == 0 else ("off", "on"):
            with SpanTracer(cell, ROOT / "build" / "bench",
                            log=mode == "on") as tracer:
                path.traced(tracer)
            t, w = tracer.data, tracer.window
            if mode == "on":
                traced.append((t, w))
            rows[mode].append((t.window_s, 100 * t.busy_s / t.window_s))
            host = ", ".join(f"{k} {v:g}" for k, v in tracer.host.items())
            print(f"{cell.name}: log {mode}: window {t.window_s:.6f} s, "
                  f"busy {rows[mode][-1][1]:.3f}%, {len(w.spans)} spans, "
                  f"{len(w.ops)} device operations; host: {host}")
    for mode, r in rows.items():
        print(f"{cell.name}: log {mode}: median window "
              f"{statistics.median(x for x, _ in r):.6f} s, median busy "
              f"{statistics.median(b for _, b in r):.3f}% over {len(r)}")
    split(cell.name, traced)
    return 0


if __name__ == "__main__":
    sys.exit(main())
