#!/usr/bin/env python3
"""Time edited copies of the fused MoE router backward side by side.

    python3 scripts/router_bwd_variants.py            # from the repository root
    python3 scripts/router_bwd_variants.py --trace    # one stage's timeline

Each variant is ``csrc/moe_router_bwd_hopper.cu`` (with the
``hopper.cuh`` it includes inlined) with a few lines replaced. Some are other designs of the same function, checked against
the plain version with ``chip_smoke.py::router_bwd_errors``; others
("cut: ...") leave part of the work out, to show which part sets the
pace, and are timed only. All are compiled at once with the flags of
``repro_torch.kernels.build`` into ``build/kernels/router_bwd_variants/``,
then timed at deepseek-moe-16b's training shape (4,096 x 2,048 bf16
tokens, E 64, k 6) and Jamba's (4,096 x 8,192, E 16, k 2), on the fused
forward's logits, ids and gates, with the L2 cold
(``chip_smoke.py::cuda_time_ms``), in two rounds of opposite order,
beside the chain the kernel replaced (the dl kernel, dl w^T cast to bf16,
f32(x)^T dl). Needs one NVIDIA card and ``nvcc``; prints one line per
(round, shape, variant).

``--trace`` instead builds a copy that stamps ``clock64`` at each step of
every stage in the first 64 CTAs, in a math warpgroup (the wait for the
stage, the products, the drain) and in the producer thread (the wait for
the stage's products, the next loads' issue, its dx stores), and each
CTA's phases (dl, the grid barrier, the streaming, dw's sum) on the
global timer; runs each shape once and prints each step's median and the
phases' spans.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# name -> [(text in the source, its replacement), ...]
VARIANTS = {
    "as built": [],
    "dx in 3 products": [("constexpr int kDxProducts = 6;",
                          "constexpr int kDxProducts = 3;")],
    "cut: no dx products": [("        if constexpr (DX) {\n          uint32_t "
                             "wt;", "        if constexpr (false) {\n"
                             "          uint32_t wt;")],
    "cut: no dw products": [("        if constexpr (DW) {\n          const "
                             "uint32_t xt", "        if constexpr (false) {\n"
                             "          const uint32_t xt")],
    "cut: no dx stores": [("            tma_store(&tm_dx, st, d0, 0, row, 0);\n"
                           "            tma_store(&tm_dx, st + kTile, d0 + 64, "
                           "0, row, 0);\n", "")],
    "cut: no phase 1": [("    rows_dl(a, r0,", "    if (false) rows_dl(a, r0,")],
    "cut: no grid barrier": [("  grid_barrier(a.counters);\n\n  // ---- "
                              "phase 2", "\n  // ---- phase 2")],
    "cut: no x loads": [("    mbar_expect(fb, 2 * kTile);\n"
                         "    tma_load(sl, &tm_x, fb, d0, 0, row, 0);\n"
                         "    tma_load(sl + kTile, &tm_x, fb, d0 + 64, 0, row, "
                         "0);\n", "")],
    "cut: no dl loads": [("    mbar_expect_tx(fb, 3 * kTile);\n",
                          "    mbar_arrive(fb);\n"),
                         ("      tma_load(sl + (2 + pc) * kTile, &tm_dl, fb, 0, "
                          "0, row, pc);\n", "      ;\n")],
    "cut: no drain": [("          if (sg >= 2) mbar_wait(stored(sg), ((sg >> 1) "
                       "- 1) & 1);\n", "          if (false) {\n"),
                      ("          asm volatile(\"fence.proxy.async.shared::"
                       "cta;\\n\" ::: \"memory\");\n        }\n        if "
                       "constexpr (DW) {\n#pragma unroll\n          for (int i "
                       "= 0; i < 32; ++i) run[i] += acc_dw[i];",
                       "          }\n        }\n        if constexpr (DW) {\n"
                       "#pragma unroll\n          for (int i = 0; i < 32; ++i) "
                       "run[i] += acc_dw[i];")],
}
MAX_STAGES = 40            # stages a CTA at the shapes timed: 8 and 32
STAMPS = 8                 # stamps a stage: 4 math, 4 producer
STEPS = (("math", 0, ("wait for the stage", "products", "drain, arrive")),
         ("producer", 4, ("wait for the stage's products", "next loads "
                          "issued", "dx stores, the last read out")))
PHASES = ("phase 1 (dl)", "grid barrier", "phase 2", "dw's sum")

# (text in the source, the same text with stamps) for --trace: TS(k)
# stamps step k of stage c in the first 64 CTAs (math thread 0, the
# producer thread); PS(k) a CTA's phases on the global timer
TRACE_EDITS = [
    ("constexpr int kThreads = 384;", f"""
__device__ long long g_stamp[64 * {MAX_STAGES} * {STAMPS}];
__device__ long long g_cta[1024 * 6];  // phases' ns (5), SM of a CTA
#define TS(K) if (blockIdx.x < 64 && c < {MAX_STAGES}) \\
    g_stamp[(blockIdx.x * {MAX_STAGES} + c) * {STAMPS} + (K)] = clock64();
#define PS(K) if (threadIdx.x == 0 && blockIdx.x < 1024) {{ \\
    long long ns; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns)); \\
    g_cta[blockIdx.x * 6 + (K)] = ns; }}
constexpr int kThreads = 384;"""),
    ("        mbar_wait(full(sg), (sg / kStages) & 1);\n",
     "        if (tid == 0) TS(0);\n        mbar_wait(full(sg), (sg / kStages) "
     "& 1);\n        if (tid == 0) TS(1);\n"),
    ("        wgmma_commit();\n        wgmma_wait<0>();\n",
     "        wgmma_commit();\n        wgmma_wait<0>();\n"
     "        if (tid == 0) TS(2);\n"),
    ("        mbar_arrive(done(sg));\n", "        mbar_arrive(done(sg));\n"
     "        if (tid == 0) TS(3);\n"),
    ("          mbar_wait(done(gs + c), ((gs + c) / kStages) & 1);\n",
     "          TS(4);\n          mbar_wait(done(gs + c), ((gs + c) / kStages) "
     "& 1);\n          TS(5);\n"),
    ("          if (c + kStages < mine) load(c + kStages);",
     "          if (c + kStages < mine) load(c + kStages);\n          TS(6);"),
    ("          mbar_arrive(stored(gs + c - 1));\n            }\n          }\n",
     "          mbar_arrive(stored(gs + c - 1));\n            }\n          }\n"
     "          TS(7);\n"),
    ("// x (t, d) bf16 with row stride ldx (elements), unit stride along d,\n",
     """extern "C" int read_stamps(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamp,
                                               sizeof(g_stamp)));
}
extern "C" int read_ctas(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_cta, sizeof(g_cta)));
}
// x (t, d) bf16 with row stride ldx (elements), unit stride along d,
"""),
    ("  // ---- phase 1: this CTA's rows of dl into the scratch ----\n",
     """  // ---- phase 1: this CTA's rows of dl into the scratch ----
  PS(0);
  if (threadIdx.x == 0 && blockIdx.x < 1024) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    g_cta[blockIdx.x * 6 + 5] = smid;
  }
"""),
    ("  grid_barrier(a.counters);\n\n  // ---- phase 2",
     "  PS(1);\n  grid_barrier(a.counters);\n  PS(2);\n\n  // ---- phase 2"),
    ("    gs += mine;\n", "    gs += mine;\n    PS(3);\n"),
    ("\n}\n\ntemplate <bool DX, bool DW, int KS>\nint launch(",
     "\n  PS(4);\n}\n\ntemplate <bool DX, bool DW, int KS>\nint launch("),
]


def build_variants(variants):
    """{name: (ctypes function, library)} of every variant that compiles."""
    from repro_torch.kernels import build as B

    src = B.inlined(B.KERNEL_SOURCES["moe_router_bwd_hopper"])
    out = B.BUILD_DIR / "router_bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} not in source")
            text = text.replace(old, new)
        cu = out / f"routerbwd{i}.cu"
        cu.write_text(text)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [B.nvcc_path(), *B.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc exit {proc.returncode}\n{log[-3000:]}")
            continue
        regs = [int(ln.split("Used ")[1].split()[0])
                for ln in log.splitlines() if "Used " in ln]
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        warn = [ln.strip() for ln in log.splitlines()
                if "ptxas" in ln and ("warning" in ln or "info    : (C" in ln
                                      or "Performance" in ln)]
        print(f"{name}: registers {regs}, {spills or 'no spills'}"
              + (f"; {warn}" if warn else ""), flush=True)
        lib = ctypes.CDLL(str(so))
        fn = lib.moe_router_bwd_fused
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64]
                       + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = (fn, lib)
    return libs


def inputs(shape, gen):
    """x, w, the fused forward's logits, idx, gates, cotangents dG and dM,
    and the plan for ``shape`` = (t, d, E, k), groups of 1,024."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.interface import KernelType
    from repro_torch.kernels.moe_router import plan, plan_bwd
    from repro_torch.kernels.moe_router.ops import _tokens_forward

    t, d, e, k = shape
    x, w = cs.router_inputs(t, d, e, torch.bfloat16, gen)
    opts = (k, True, cs.LLM_GROUP, KernelType.CUDA,
            plan(x, w, top_k=k, group_size=cs.LLM_GROUP))
    with torch.no_grad():
        gates, idx, _, _, _, logits = _tokens_forward(x, w, opts, True)
    dg = torch.randn(t, k, device="cuda", generator=gen)
    dm = torch.randn(e, device="cuda", generator=gen)
    return x, w, logits, idx, gates, dg, dm, plan_bwd(x, w, top_k=k)


def caller(fn, x, w, logits, idx, gates, dg, dm, form, dx, dw):
    """A no-argument launch of ``fn`` into dx, dw (the wrapper's scratch)."""
    import torch

    from repro_torch.kernels.moe_router import ops

    stream = torch.cuda.current_stream()
    t, d = x.shape
    e, k = w.shape[1], idx.shape[1]
    sc = ops._bwd_scratch(x.device, stream, form["ranges"], form["slices"],
                          -(-t // 64) * 64)
    args = (x.data_ptr(), x.stride(0), w.data_ptr(), logits.data_ptr(),
            idx.data_ptr(), gates.data_ptr(), dg.data_ptr(), dm.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), sc["part"].data_ptr(),
            sc["dlp"].data_ptr(), sc["counters"].data_ptr(), t, d, e, k, 1,
            form["ranges"], form["stages_per_range"], stream.cuda_stream)

    def run():
        if fn(*args):
            raise SystemExit("launch failed")
    return run


def trace(libs, ins):
    """Run the stamped copy once on ``ins``; print the median of
    each step over the first 64 CTAs' stages and each phase's span."""
    import numpy as np
    import torch

    fn, lib = libs["trace"]
    x, w, logits, idx, gates, dg, dm, form = ins
    dx = torch.empty(x.shape, dtype=x.dtype, device="cuda")
    dw = torch.empty(w.shape, device="cuda")
    caller(fn, *ins, dx, dw)()
    torch.cuda.synchronize()
    stamps = np.zeros(64 * MAX_STAGES * STAMPS, dtype=np.int64)
    if lib.read_stamps(ctypes.c_void_p(stamps.ctypes.data)):
        raise SystemExit("read_stamps failed")
    n = form["stages_per_range"]
    st = stamps.reshape(64, MAX_STAGES, STAMPS)[:, :n].astype(np.float64)
    print(f"stages a CTA {n}; median cycles over 64 CTAs' stages 1.."
          f"{n - 1} (stage 0 in parentheses):", flush=True)
    for role, k0, steps in STEPS:
        for i, name in enumerate(steps):
            dt = st[:, :, k0 + i + 1] - st[:, :, k0 + i]
            print(f"  {role:8s} {name:28s} {np.median(dt[:, 1:]):7.0f}  "
                  f"({np.median(dt[:, 0]):.0f})")
        print(f"  {role:8s} a stage, top to top "
              f"{np.median(np.diff(st[:, :, k0], axis=1)):.0f}", flush=True)
    ctas = np.zeros(1024 * 6, dtype=np.int64)
    if lib.read_ctas(ctypes.c_void_p(ctas.ctypes.data)):
        raise SystemExit("read_ctas failed")
    grid = min(form["slices"] * form["ranges"], 132)
    ctas = ctas.reshape(1024, 6)[:grid]
    t0 = ctas[:, 0].min()
    spans = np.diff(ctas[:, :5], axis=1) / 1e3
    print(f"CTAs ({grid}): last start {(ctas[:, 0].max() - t0) / 1e3:.2f} "
          f"us, ends {(ctas[:, 4].min() - t0) / 1e3:.2f}-"
          f"{(ctas[:, 4].max() - t0) / 1e3:.2f} us; " + ", ".join(
              f"{name} {np.median(spans[:, i]):.2f} us (median; "
              f"{spans[:, i].min():.2f}-{spans[:, i].max():.2f})"
              for i, name in enumerate(PHASES))
          + f"; CTAs an SM {np.bincount(ctas[:, 5], minlength=132).max()}",
          flush=True)


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.moe_router import logits_bwd
    from repro_torch.kernels.moe_router.ref import route_tokens_full_bwd_ref

    if not torch.cuda.is_available():
        print("router_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    shapes = {"deepseek": (cs.LLM_BATCH * cs.LLM_PROMPT, 2048, 64, 6),
              "jamba": cs.JAMBA_ROUTER}
    if "--trace" in sys.argv[1:]:
        libs = build_variants({"trace": TRACE_EDITS})
        for label, shape in shapes.items():
            print(f"{label} {shape}:", flush=True)
            trace(libs, inputs(shape, gen))
        return 0
    libs = build_variants(VARIANTS)
    failed = False
    for label, shape in shapes.items():
        ins = inputs(shape, gen)
        x, w, logits, idx, gates, dg, dm, form = ins
        _, dx_p, dw_p = route_tokens_full_bwd_ref(x, w, logits, idx, gates,
                                                  dg, dm)
        bound = cs.router_bwd_bound(*shape)[0]
        dx = torch.empty(x.shape, dtype=x.dtype, device="cuda")
        dw = torch.empty(w.shape, device="cuda")

        def chain():
            d_l = logits_bwd(logits, idx, gates, dg, dm)
            return (d_l @ w.T).to(x.dtype), x.float().T @ d_l

        for rnd, order in enumerate((list(libs), list(libs)[::-1])):
            for name in order:
                run = caller(libs[name][0], *ins, dx, dw)
                run()
                torch.cuda.synchronize()
                ex, ew, ok = cs.router_bwd_errors((dx, dw), (dx_p, dw_p))
                if not name.startswith("cut"):
                    failed |= not ok
                ms = cs.cuda_time_ms(run, 50)
                print(f"[{rnd}] {label} {name:22s} {ms * 1e3:7.1f} us "
                      f"({bound / ms:.1%} of the {bound * 1e3:.2f} us bound)"
                      + ("" if name.startswith("cut") else
                         f", dx max abs err {ex:.3g}, dw {ew:.3g}, within "
                         f"router_bwd_errors: {ok}"), flush=True)
            ms = cs.cuda_time_ms(chain, 20)
            print(f"[{rnd}] {label} {'the chain':22s} {ms * 1e3:7.1f} us",
                  flush=True)
    if failed:
        print("router_bwd_variants: a variant disagrees with the plain "
              "version", file=sys.stderr)
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
