#!/usr/bin/env python3
"""Time edited copies of the fused MoE router kernel side by side.

    python3 scripts/router_variants.py          # from the repository root
    python3 scripts/router_variants.py --trace  # each phase's time

Each variant is ``csrc/moe_router_hopper.cu`` with a few lines replaced,
each undoing or changing one step of the built design: the depth of the
ring of x stages (loading one, two or five stages ahead in place of
three), the forms of the
tile and split launches (128-token tiles over clusters of 4; the
decode's d over 8 or 4 CTAs in place of 16), two CTAs an SM (128
registers, the running sum spilled; also over clusters of 4), w in two
bf16 pieces in place of three; and cuts ("cut: ...") that leave a step
out, to show what it costs (timed only: a cut's outputs are not checked):
the products, the split of w into its pieces, the adding of each stage's
sums to the running sum, the loads of x and w, the wait on earlier
blocks' counts, the last CTA's statistics. All are compiled at once with the flags of
``repro_torch.kernels.build`` into ``build/kernels/variants/``, then run at
deepseek-moe-16b's prefill (4096 x 2048 bf16 tokens, E 64, k 6, groups of
1024) and decode (4 tokens, one group), each held against the plain
version (``chip_smoke.py::fused_errors``), its product's accuracy read
against the float64 route (``chip_smoke.py::f64_error``, k = E, beside
cuBLAS's f32 product and the limit ``PROB_REL_TOL``; a variant over the
limit is marked, not failed) and timed with the L2 cold
(``chip_smoke.py::cuda_time_ms``), in two rounds of opposite order; a
variant that disagrees makes the script exit 1, one the card refuses to
launch is reported and skipped. ``--trace`` builds the kernel with a
stamp of the global timer at the end of each phase instead and prints the
phases' times at both shapes. Needs one NVIDIA card and ``nvcc``; prints
one line per (round, shape, variant).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

_CALL = ("    stage_products<TX, BM>(stage_x(c % L::kStages), "
         "smem_u32(tiles),")
STAGES = "  static constexpr int kStages = kSmemA ? 4 : 2;"

# --trace: thread 0 of every CTA stamps the global timer at each phase's
# end into a device array the script reads back
TRACE_DEFS = """__device__ unsigned long long g_stamps[4096 * 16];
#define STAMP(i)                                                   \\
  if (threadIdx.x == 0) {                                          \\
    unsigned long long t_;                                         \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));         \\
    g_stamps[blockIdx.x * 16 + (i)] = t_;                          \\
  }

struct Args {"""
PHASES = ("start", "tile (start ticket)", "loads and products",
          "k-part sum, cluster barrier", "cluster sum (DSMEM)",
          "softmax and top-k", "row masks", "tails and wait",
          "gates, ids, positions", "exit ticket, last-CTA statistics",
          "cluster barrier at exit")
TRACE = [
    ("struct Args {", TRACE_DEFS),
    ("  const TX* x = static_cast<const TX*>(a.x);\n",
     "  const TX* x = static_cast<const TX*>(a.x);\n  STAMP(0)\n"),
    ("  const int64_t row0 = int64_t(tile) * BM;\n",
     "  STAMP(1)\n  const int64_t row0 = int64_t(tile) * BM;\n"),
    ("  // The CTA's sum", "  STAMP(2)\n  // The CTA's sum"),
    ("  // This CTA's rows [rb", "  STAMP(3)\n  // This CTA's rows [rb"),
    ("  // Softmax, top-k", "  STAMP(4)\n  // Softmax, top-k"),
    ("  // Each expert's rows", "  STAMP(5)\n  // Each expert's rows"),
    ("  // Publish this block's", "  STAMP(6)\n  // Publish this block's"),
    ("  // gates, ids, positions", "  STAMP(7)\n  // gates, ids, positions"),
    ("  // The last CTA to finish", "  STAMP(8)\n  // The last CTA to finish"),
    ("  cluster_wait();  // no CTA", "  STAMP(9)\n  cluster_wait();  // no CTA"),
    ("\n}\n\ntemplate <typename TX, int BM>\nint launch_route",
     "\n  STAMP(10)\n}\n\ntemplate <typename TX, int BM>\nint launch_route"),
    ("// dtype: 0 = float32 x", """extern "C" int router_stamps(void* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, n * 8));
}

// dtype: 0 = float32 x"""),
]

# name -> (edits, {case: (tile tokens, cluster)} forms in place of plan's)
VARIANTS = {
    "as built": ([], {}),
    "x one stage ahead": ([(STAGES, STAGES.replace("? 4", "? 2"))], {}),
    "x two stages ahead": ([(STAGES, STAGES.replace("? 4", "? 3"))], {}),
    "x five stages ahead": ([(STAGES, STAGES.replace("? 4", "? 6"))], {}),
    "tiles of 128 over clusters of 4": ([], {"prefill": (128, 4)}),
    "two CTAs an SM (128 registers), tiles of 128 over clusters of 4": (
        [("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads, 2)")],
        {"prefill": (128, 4)}),
    "two CTAs an SM (128 registers)": (
        [("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads, 2)")],
        {}),
    "split over a cluster of 8": ([], {"decode": (64, 8)}),
    "split over a cluster of 4": ([], {"decode": (64, 4)}),
    "w in two bf16 pieces (16 bits)": (
        [("      wgmma_ss_n64(acc, xa, w3, keep);\n"
          "      wgmma_ss_n64(acc, xa, w2);\n",
          "      wgmma_ss_n64(acc, xa, w2, keep);\n")], {}),
    "cut: no products": ([(_CALL, "    if (0) " + _CALL.lstrip())], {}),
    "cut: no pieces of w": ([("    store_pieces(tiles, w_c);\n", "")], {}),
    "cut: no running sum (each stage's sums dropped)": (
        [("    add_stage(c > 0);\n", "")], {}),
    "cut: no loads of x and w": (
        [("  constexpr int kPer = 16 / sizeof(TX);   // values a piece",
          "  return;\n  constexpr int kPer = 16 / sizeof(TX);"),
         ("    if (r < kk && c0 + 4 * j < e)\n",
          "    if (false)\n")], {}),
    "cut: no wait on earlier blocks": (
        [("    if (rows > 0 && ex < a.e) {", "    if (false) {")], {}),
    "cut: no last-CTA statistics": (
        [("    if (ex < a.e)\n      for (int b0 = part; b0 < blocks;",
          "    if (false)\n      for (int b0 = part; b0 < blocks;")], {}),
}


def build_variants(variants):
    """{name: ctypes library} of every variant that compiles."""
    from repro_torch.kernels import build as B

    src = B.KERNEL_SOURCES["moe_router_hopper"].read_text()
    out = B.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (edits, _)) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} not in source")
            text = text.replace(old, new, 1)
        cu = out / f"router{i}.cu"
        cu.write_text(text)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [B.nvcc_path(), *B.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc exit {proc.returncode}\n{log[-3000:]}",
                  flush=True)
            continue
        regs = [int(ln.split("Used ")[1].split()[0])
                for ln in log.splitlines() if "Used " in ln]
        notes = [ln.split("ptxas info    : ")[-1][:60]
                 for ln in log.splitlines() if "Performance Loss" in ln]
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        print(f"{name}: registers {regs}, {spills or 'no spills'}"
              + (f"; {len(notes)} x {notes[0]}" if notes else ""), flush=True)
        lib = ctypes.CDLL(str(so))
        p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.moe_route_tokens.argtypes = [i, p, n, p] + [i] * 8 + [p] * 8
        lib.moe_route_tokens.restype = ctypes.c_int
        libs[name] = lib
    return libs


def runner(lib, x, w, k, gs, form, renorm=True):
    """(fn, outputs) of one launch of the variant library ``lib`` in
    ``form`` (tile tokens, cluster), with its own scratch (kept alive by
    fn)."""
    import torch

    t, d = x.shape
    e = w.shape[1]
    bt, cl = form
    blocks = -(-t // bt) * cl
    dev = x.device
    outs = (torch.empty((t, k), device=dev),
            torch.empty((t, k), dtype=torch.int32, device=dev),
            torch.empty((t, k), dtype=torch.int32, device=dev),
            torch.empty((2, e), device=dev))
    scratch = (torch.zeros((blocks, 64), dtype=torch.int64, device=dev),
               torch.empty((blocks, 2, 64), device=dev),
               torch.zeros(3, dtype=torch.int32, device=dev))
    code = 1 if x.dtype == torch.bfloat16 else 0
    args = (code, x.data_ptr(), x.stride(0), w.data_ptr(), t, d, e, k,
            int(renorm), gs, bt, cl, *(o.data_ptr() for o in outs),
            *(s.data_ptr() for s in scratch),
            torch.cuda.current_stream().cuda_stream)

    def fn():
        assert outs and scratch            # alive as long as fn
        err = lib.moe_route_tokens(*args)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    gates, idx, pos, aux = outs
    return fn, (gates, idx, pos, {"mean_prob": aux[0],
                                  "frac_tokens": aux[1]})


def print_trace(lib, cases) -> int:
    """One launch of each case with the L2 cold, then each phase's time
    (the stamps of thread 0 of every CTA): median and largest over the
    CTAs, and when the first and the last CTA started and ended."""
    import numpy as np
    import torch

    import chip_smoke as cs

    lib.router_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, device="cuda")
    for label, x, w, k, gs, form, *_ in cases:
        fn, _ = runner(lib, x, w, k, gs, form)
        for _ in range(3):
            fn()
        flush.zero_()
        fn()
        torch.cuda.synchronize()
        n = -(-x.shape[0] // form[0]) * form[1]
        buf = np.zeros((n, 16), dtype=np.uint64)
        if lib.router_stamps(buf.ctypes.data, n * 16):
            raise RuntimeError("reading the stamps failed")
        st = buf[:, :len(PHASES)].astype(np.int64)
        st -= st[:, 0].min()
        print(f"{label}: {n} CTAs; first start 0, last start "
              f"{st[:, 0].max() / 1e3:.2f} us, first end "
              f"{st[:, -1].min() / 1e3:.2f} us, last end "
              f"{st[:, -1].max() / 1e3:.2f} us", flush=True)
        for i in range(1, len(PHASES)):
            d = st[:, i] - st[:, i - 1]
            print(f"{label}:   {PHASES[i]:36s} median {np.median(d) / 1e3:6.2f}"
                  f" us, largest {d.max() / 1e3:6.2f} us", flush=True)
    return 0


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.moe_router import plan, route_tokens

    if not torch.cuda.is_available():
        print("router_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    trace = "--trace" in sys.argv[1:]
    libs = build_variants({"traced": (TRACE, {})} if trace else VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = []
    for label, t, d, e, k, gs, dt, *_ in cs.FUSED_CASES[:2]:
        dtype = getattr(torch, dt)
        x, w = cs.router_inputs(t, d, e, dtype, gen)
        f = plan(x, w, top_k=k, group_size=gs)
        want = route_tokens(x, w, top_k=k, group_size=gs, mode="torch")
        bound = cs.fused_bound(t, d, e, k, dtype.itemsize)[0]
        g64, i64 = route_tokens(x, w, top_k=e, renormalize=False,
                                group_size=gs, mode="torch")[:2]
        print(f"{label}: cuBLAS's f32 product, probabilities within "
              f"{cs.f64_error(x, w, g64, i64):.3g} of the float64 route's "
              f"(relative, k = E)", flush=True)
        cases.append((label, x, w, k, gs, (f["block_tokens"], f["cluster"]),
                      want, bound))
    if trace:
        return print_trace(libs["traced"], cases)
    failed = False
    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for label, x, w, k, gs, form, want, bound in cases:
            times, notes = {}, {}
            for name in order:
                forms = VARIANTS[name][1]
                if forms and label not in forms:
                    continue
                fn, got = runner(libs[name], x, w, k, gs,
                                 forms.get(label, form))
                try:
                    fn()
                except RuntimeError as err:   # a launch the card refused
                    print(f"[{rnd}] {label} {name:36s} {err}", flush=True)
                    continue
                torch.cuda.synchronize()
                if not name.startswith("cut"):
                    try:
                        e_max, flips = cs.fused_errors(x, w, k, gs, got,
                                                       want)
                        notes[name] = (f", checked: max err {e_max:.2g}, "
                                       f"{flips} flips at ties")
                    except AssertionError as err:
                        failed = True
                        notes[name] = f", WRONG: {err}"
                    e = w.shape[1]
                    run, (g64, i64, *_) = runner(
                        libs[name], x, w, e, gs, forms.get(label, form),
                        renorm=False)
                    run()
                    acc = cs.f64_error(x, w, g64, i64)
                    notes[name] += (f", f64 rel err {acc:.3g}"
                                    + (" (over the limit)"
                                       if acc > cs.PROB_REL_TOL else ""))
                times[name] = cs.cuda_time_ms(fn, 100)
            for name in (n for n in names if n in times):
                ms = times[name]
                print(f"[{rnd}] {label:7s} {name:36s} {ms * 1e3:7.1f} us "
                      f"({bound / ms:.1%} of the {bound * 1e3:.2f} us bound, "
                      f"{times['as built'] / ms:.2f}x as built)"
                      + notes.get(name, ""), flush=True)
    if failed:
        print("router_variants: a variant disagrees with the plain version",
              file=sys.stderr)
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
