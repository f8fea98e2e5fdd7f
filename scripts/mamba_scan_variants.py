#!/usr/bin/env python3
"""Time edited copies of the selective scan's ring kernels side by side.

    python3 scripts/mamba_scan_variants.py       # from the repository root

Each variant is ``csrc/mamba_scan_hopper.cu`` (the forward) or
``csrc/mamba_scan_bwd_hopper.cu`` (the backward), made one translation
unit with ``mamba_ring.cuh`` (``build.inlined``), with a few lines
replaced. Some are other designs of the same function, held to the
tree's kernel (max abs difference printed); others ("cut: ...") leave
part of the work out, to show what it costs, and are timed only. All are
compiled at once with the flags of ``repro_torch.kernels.build`` into
``build/kernels/mamba_variants/``, then timed at Jamba's (4, 1,024,
16,384, 16) in bf16 as training runs them (no h0, no final cotangent;
the forward with its snapshots every 8 steps), with the L2 cold
(``chip_smoke.py::cuda_time_ms``), in two rounds of opposite order,
beside the ``simt`` kernels on the same tensors. Needs one NVIDIA card
and ``nvcc``; prints the card and one line per (round, variant).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# simt's exponential: the accurate expf of dt A, A not pre-scaled
EXPF = [('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : '
         '"f"(__fmul_rn(dtv, a2)));',
         "  y = expf(__fmul_rn(dtv, a2));"),
        ("  return __fmul_rn(a, kLog2e);", "  return a;")]
# the backward's dC reduced over the warp in the window's forward pass,
# where dy and h_t are at hand; dB alone in the backward step
DC_FORWARD = [
    ("  const int vi = lane >> 2;            // 0..3 dC, 4..7 dB of n 4 ng "
     "+ vi % 4\n  float* const red_me = &sm.red[warp][0][(vi >> 2) * kN + 4 "
     "* ng + (vi & 3)];",
     """\
  const int vi = (lane >> 3) & 3;
  float* const red_c = &sm.red[warp][0][4 * ng + vi];
  float* const red_b = red_c + kN;"""),
    ("""\
                                     j ? hs[j - 1][c][q] : h0s[c][q], u[c],
                                     bv[q]);
      }""",
     """\
                                     j ? hs[j - 1][c][q] : h0s[c][q], u[c],
                                     bv[q]);
        {
          const float2 dyv =
              *reinterpret_cast<const float2*>(&sm.cdy[j][2 * cp]);
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[q] = fmaf(dyv.y, hs[j][1][q], dyv.x * hs[j][0][q]);
          scatter_level<2, 16>(v, lane);
          scatter_level<1, 8>(reinterpret_cast<float(&)[2]>(v), lane);
          v[0] += __shfl_xor_sync(kFull, v[0], 4);
          if (!(lane & 4)) red_c[j * 2 * kN] = v[0];
        }
      }"""),
    ("""        float v[8], r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[q] = fmaf(dys[1], hs[j][1][q], dys[0] * hs[j][0][q]);
          v[4 + q] = 0.f;
        }""", """        float v[4] = {0.f, 0.f, 0.f, 0.f}, r[4];"""),
    ("            v[4 + q] = fmaf(gt, u[c], v[4 + q]);",
     "            v[q] = fmaf(gt, u[c], v[q]);"),
    ("""        scatter_level<4, 16>(v, lane);
        scatter_level<2, 8>(reinterpret_cast<float(&)[4]>(v), lane);
        scatter_level<1, 4>(reinterpret_cast<float(&)[2]>(v), lane);
        red_me[j * 2 * kN] = v[0];""",
     """        scatter_level<2, 16>(v, lane);
        scatter_level<1, 8>(reinterpret_cast<float(&)[2]>(v), lane);
        v[0] += __shfl_xor_sync(kFull, v[0], 4);
        if (!(lane & 4)) red_b[j * 2 * kN] = v[0];"""),
]
# A log2 e kept in shared memory (read again each step) for registers
A2_SHARED = [
    ("  float red[kWarps][kW][2 * kN];  // each warp's sums of dC, dB a "
     "step\n",
     "  float red[kWarps][kW][2 * kN];  // each warp's sums of dC, dB a "
     "step\n  float a2s[kThreads][8];\n"),
    ("  float a2[2][4], g[2][4], da[2][4];", "  float g[2][4], da[2][4];"),
    ("      a2[c][q] = scaled_a(", "      sm.a2s[tid][4 * c + q] = scaled_a("),
    ("""      constexpr bool kFull = decltype(full)::value;
      start_state();""", """      constexpr bool kFull = decltype(full)::value;
      start_state();
      auto a2_of = [&](float (&a2)[2][4]) {
        float4 p, r;
        const unsigned ad = static_cast<unsigned>(
            __cvta_generic_to_shared(&sm.a2s[tid][0]));
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(p.x), "=f"(p.y), "=f"(p.z), "=f"(p.w) : "r"(ad));
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
                     : "r"(ad + 16));
        a2[0][0] = p.x, a2[0][1] = p.y, a2[0][2] = p.z, a2[0][3] = p.w;
        a2[1][0] = r.x, a2[1][1] = r.y, a2[1][2] = r.z, a2[1][3] = r.w;
      };"""),
    ("""        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int c = 0; c < 2; ++c)""",
     """        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        float a2[2][4];
        a2_of(a2);
#pragma unroll
        for (int c = 0; c < 2; ++c)"""),
    ("        if (j == 0) start_state();",
     "        if (j == 0) start_state();\n        float a2[2][4];\n"
     "        a2_of(a2);"),
]
# (kernel, name) -> [(text in the source, its replacement), ...]
VARIANTS = {
    ("fwd", "as built"): [],
    ("fwd", "accurate expf"): EXPF,
    ("fwd", "stages of 8 steps"): [
        ("kSteps = sizeof(T) == 2 ? 16 : 8;", "kSteps = 8;")],
    ("fwd", "cut: no y stores"): [
        ("      ys[static_cast<size_t>(j) * d_in] = from_f32<T>(acc0 + acc1);",
         "      if (acc0 + acc1 == 12345.f) ys[0] = from_f32<T>(acc0);")],
    ("bwd", "as built"): [],
    ("bwd", "accurate expf"): EXPF + [("r[2 * c + 1] = dd * kLn2;",
                                       "r[2 * c + 1] = dd;")],
    ("bwd", "one copy of the window (steps guarded)"): [
        ("    if (len == kW)\n      window(std::true_type{});\n    else\n"
         "      window(std::false_type{});",
         "    window(std::false_type{});")],
    ("bwd", "dC reduced in the forward pass"): DC_FORWARD,
    ("bwd", "A log2 e read from shared memory"): A2_SHARED,
    ("bwd", "one CTA an SM (8 warps)"): [
        ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")],
    ("bwd", "cut: no dC, dB reduce-scatter"): [
        ("        scatter_level<4, 16>(v, lane);\n"
         "        scatter_level<2, 8>(reinterpret_cast<float(&)[4]>(v), "
         "lane);\n"
         "        scatter_level<1, 4>(reinterpret_cast<float(&)[2]>(v), "
         "lane);\n", "")],
    ("bwd", "cut: no du, dd sums"): [
        ("        scatter_level<2, 2>(r, lane);\n"
         "        r[0] += __shfl_xor_sync(kFull, r[0], 1);\n"
         "        r[1] += __shfl_xor_sync(kFull, r[1], 1);\n", "")],
    ("bwd", "cut: a_t not recomputed going back"): [
        ("const float ga = decay(dts[c], a2[c][q]) * gt;",
         "const float ga = 0.96875f * gt;")],
}
SOURCES = {"fwd": ("mamba_scan_hopper", "mamba_scan_ring"),
           "bwd": ("mamba_scan_bwd_hopper", "mamba_scan_bwd_ring")}


def build_variants():
    """{(kernel, name): ctypes function} of every variant that compiles;
    prints each one's registers and spills."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels.mamba_scan import ops

    out = B.BUILD_DIR / "mamba_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, ((kind, name), edits) in enumerate(VARIANTS.items()):
        lib, _ = SOURCES[kind]
        text = B.inlined(B.KERNEL_SOURCES[lib])
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {kind} {name!r}: {old!r} not in "
                                 "source")
            text = text.replace(old, new)
        cu = out / f"mamba{i}.cu"
        cu.write_text(text)
        procs[kind, name] = (cu.with_suffix(".so"), subprocess.Popen(
            [B.nvcc_path(), *B.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for (kind, name), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{kind} {name}: nvcc exit {proc.returncode}\n"
                  f"{log[-3000:]}")
            continue
        kernel, entry = None, []
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                kernel = ln.split("'")[1]
            elif ("registers" in ln and kernel
                  and "ring_kernelI13__nv_bfloat16E" in kernel):
                entry.append(ln.split("Used ")[1].split(",")[0])
            elif ("spill" in ln and kernel
                  and "ring_kernelI13__nv_bfloat16E" in kernel):
                entry.append(ln.strip())
        print(f"{kind} {name}: bf16: {'; '.join(entry)}", flush=True)
        fn = getattr(ctypes.CDLL(str(so)), SOURCES[kind][1])
        tree = (ops._scan_ring_fn if kind == "fwd" else ops._bwd_ring_fn)()
        fn.argtypes, fn.restype = tree.argtypes, tree.restype
        fns[kind, name] = fn
    return fns


def main():
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.mamba_scan import bwd_scratch, launch, \
        launch_bwd, ops

    cs.phase_environment()
    fns = build_variants()
    b, s, d_in, n = cs.JAMBA_SCAN
    gen = torch.Generator(device="cuda").manual_seed(11)
    args = cs.mamba_inputs(b, s, d_in, torch.bfloat16, gen, False)
    xc = args[0]
    dy = torch.randn(b, s, d_in, device="cuda", generator=gen).to(xc.dtype)
    y = torch.empty_like(xc)
    h = torch.empty((b, d_in, n), device="cuda")
    snaps = torch.empty((b, -(-s // 8), d_in, n), device="cuda")

    def grads():
        return (torch.empty_like(xc), torch.empty_like(xc),
                torch.empty((b, s, n), dtype=xc.dtype, device="cuda"),
                torch.empty((b, s, n), dtype=xc.dtype, device="cuda"),
                torch.empty((d_in, n), device="cuda"), None)

    launch(*args, y, h, snaps, variant="ring")
    want_fwd = (y.clone(), h.clone(), snaps.clone())
    scratch = bwd_scratch(xc, "ring")
    want_bwd = grads()
    launch_bwd(*args[:5], snaps, dy, None, want_bwd, scratch,
               variant="ring")

    def run(kind, fn, out=None):
        attr = "_scan_ring_fn" if kind == "fwd" else "_bwd_ring_fn"
        setattr(ops, attr, lambda: fn)
        if kind == "fwd":
            o = out or (y, h, snaps)
            return lambda: launch(*args, *o, variant="ring")
        return lambda: launch_bwd(*args[:5], want_fwd[2], dy, None,
                                  out or gs, scratch, variant="ring")

    gs = grads()
    real = {"fwd": ops._scan_ring_fn, "bwd": ops._bwd_ring_fn}
    for (kind, name), fn in fns.items():
        if name.startswith("cut"):
            continue
        if kind == "fwd":
            got = (torch.empty_like(y), torch.empty_like(h),
                   torch.empty_like(snaps))
            run(kind, fn, got)()
            pairs = zip(got, want_fwd)
        else:
            got = grads()
            run(kind, fn, got)()
            pairs = zip(got[:5], want_bwd[:5])
        torch.cuda.synchronize()
        diff = [float((g.float() - w.float()).abs().max()) for g, w in pairs]
        print(f"{kind} {name}: max abs difference from the tree's kernel "
              + ", ".join(f"{d:.3g}" for d in diff), flush=True)
    setattr(ops, "_scan_ring_fn", real["fwd"])
    setattr(ops, "_bwd_ring_fn", real["bwd"])
    simt_snaps = torch.empty((b, -(-s // 32), d_in, n), device="cuda")
    launch(*args, y, h, simt_snaps, variant="simt")
    simt_scratch = bwd_scratch(xc, "simt")
    for rnd, order in enumerate((list(fns), list(fns)[::-1])):
        for key in order:
            ms = cs.cuda_time_ms(run(key[0], fns[key]), 10)
            print(f"round {rnd + 1} {key[0]} {key[1]}: {ms * 1e3:.1f} us",
                  flush=True)
        setattr(ops, "_scan_ring_fn", real["fwd"])
        setattr(ops, "_bwd_ring_fn", real["bwd"])
        ms = cs.cuda_time_ms(lambda: launch(*args, y, h, simt_snaps,
                                            variant="simt"), 10)
        ms_b = cs.cuda_time_ms(lambda: launch_bwd(
            *args[:5], simt_snaps, dy, None, gs, simt_scratch,
            variant="simt"), 10)
        print(f"round {rnd + 1} simt: forward with snapshots every 32 "
              f"{ms * 1e3:.1f} us, backward {ms_b * 1e3:.1f} us", flush=True)


if __name__ == "__main__":
    main()
