#!/usr/bin/env python3
"""Time edited copies of the tensor-core attention backward side by side.

    python3 scripts/attention_bwd_variants.py        # from the repository root

Each variant is ``csrc/flash_attention_bwd_hopper.cu`` (the shared
``csrc/hopper.cuh`` it includes inlined) with some text replaced:

  * ``pipelined``: each consumer warpgroup issues step it + 1's S and dP
    products together with step it's output products (dV and dK, or dQ)
    and forms p and ds of step it + 1 while those run, in place of
    finishing each step before the next starts;
  * ``2 stages`` / ``4 stages``: the ring of streamed tiles (3 as built);
  * ``light first``: the key blocks of the dk/dv pass and the query
    blocks of the dq pass in the other order (as built, the blocks with
    the most visible pairs under a causal mask start first).

All are compiled at once with the flags of ``repro_torch.kernels.build``
into ``build/kernels/bwd_variants/``; each variant's dq, dk and dv must be
bit-equal to the built kernel's (the same products in the same order)
and within 2e-2 of ``attention_bwd_ref(variant="wgmma")``. Then every
variant is timed with the L2 cold (``chip_smoke.py::cuda_time_ms``) at
``chip_smoke.py``'s 13g bf16 shapes, in two rounds of opposite order.
Needs one NVIDIA card and ``nvcc``; prints the card's name and power
limit, then one line per (round, variant, case).

``--trace`` instead builds a copy of the kernel as built that stamps
``clock64`` at each phase of each consumer warpgroup's loop (waiting for
the stage's tiles, issuing S and dP, waiting for S, forming p, waiting
for dP, forming ds, the output products and waiting for them) in the 64
heaviest CTAs of each pass, runs phi3's training shape (4, 1024, 32, 96)
once, and prints the median time of each phase per step.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# The pipelined variant's consumer loops: each replaces the source from
# the first text of its span up to (not including) the second.
DKV_SPAN = ("  mbar_wait(bar_kv, 0);\n  for (int it = 0; it < n; ++it) {",
            "  const int64_t ld = int64_t(p.hkv) * D;")
PIPELINED_DKV = '''\
  // Step it + 1's S^T and dP^T go out with step it's dV and dK, so that
  // p and ds of step it + 1 are formed while the tensor cores run dV, dK.
  auto probs = [&](int it) {   // p of step it into st, masked
    const int qp0 = p.q_offset + (t0 + it % nt) * kRows;
    const float* ls = lse_s + (it % kStages) * kRows;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + col);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[4 * j + e] = ex2(fmaf(st[4 * j + e], p.scale_log2,
                                 -(e % 2 ? l2.y : l2.x)));
    }
    if (edge_tile(p, kw0, qp0)) {   // masked pairs: p = 0 (ex2 may be inf)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!visible(p, key0 + 8 * ((i / 2) % 2),
                     qp0 + (i / 4) * 8 + col + i % 2))
          st[i] = 0.0f;
    }
  };
  auto grads = [&](int it) {   // ds of step it into dpt
    const float* dl = dl_s + (it % kStages) * kRows;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        dpt[i] = st[i] * (dpt[i] - (e % 2 ? d2.y : d2.x));
      }
    }
  };
  auto issue_sdp = [&](int it) {
    const int s = it % kStages;
    issue_s<D>(st, k_addr, kBlock * 128, s_base + L::kX + s * L::kTile,
               kRows * 128);
    wgmma_commit();
    issue_s<D>(dpt, v_addr, kBlock * 128, s_base + L::kY + s * L::kTile,
               kRows * 128);
    wgmma_commit();
  };
  auto issue_dkv = [&](int it) {
    const int s = it % kStages;
    issue_out<D>(dv, pa, s_base + L::kY + s * L::kTile);
    issue_out<D>(dk, da, s_base + L::kX + s * L::kTile);
    wgmma_commit();
  };
  mbar_wait(bar_kv, 0);
  if (n > 0) {
    mbar_wait(bar_f, 0);
    wgmma_fence();
    issue_sdp(0);
    wgmma_wait<1>();
    fence_regs(st);
    probs(0);
    wgmma_wait<0>();
    fence_regs(dpt);
    grads(0);
    pack_a(pa, st);
    pack_a(da, dpt);
  }
  for (int it = 0; it + 1 < n; ++it) {
    const int s1 = (it + 1) % kStages;
    mbar_wait(bar_f + 8 * s1, ((it + 1) / kStages) & 1);
    wgmma_fence();
    issue_sdp(it + 1);
    issue_dkv(it);
    wgmma_wait<2>();   // S^T of step it + 1
    fence_regs(st);
    probs(it + 1);
    wgmma_wait<1>();   // dP^T of step it + 1
    fence_regs(dpt);
    grads(it + 1);
    wgmma_wait<0>();   // dV, dK of step it
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(bar_e + 8 * (it % kStages));
    pack_a(pa, st);
    pack_a(da, dpt);
  }
  if (n > 0) {
    wgmma_fence();
    issue_dkv(n - 1);
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(bar_e + 8 * ((n - 1) % kStages));
  }

'''
DQ_SPAN = ("  mbar_wait(bar_qd, 0);\n  for (int it = 0; it < nt; ++it) {",
           "  store_rows<D>(p.dq + ")
PIPELINED_DQ = '''\
  // Step it + 1's S and dP go out with step it's dQ product.
  auto probs = [&](int it) {   // p of key tile it into sc, masked
    const int kt = (t0 + it) * kRows;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      sc[i] = ex2(fmaf(sc[i], p.scale_log2, -lse2[(i / 2) % 2]));
    if (edge_tile(p, kt, wq0)) {   // masked pairs: p = 0 (ex2 may be inf)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!visible(p, kt + (i / 4) * 8 + col + i % 2,
                     p.q_offset + ra + 8 * ((i / 2) % 2)))
          sc[i] = 0.0f;
    }
  };
  auto grads = [&]() {   // ds into dp
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dlt[(i / 2) % 2]);
  };
  auto issue_sdp = [&](int it) {
    const int s = it % kStages;
    issue_s<D>(sc, q_addr, kBlock * 128, s_base + L::kX + s * L::kTile,
               kRows * 128);
    wgmma_commit();
    issue_s<D>(dp, do_addr, kBlock * 128, s_base + L::kY + s * L::kTile,
               kRows * 128);
    wgmma_commit();
  };
  auto issue_dq = [&](int it) {
    issue_out<D>(dq, da, s_base + L::kX + (it % kStages) * L::kTile);
    wgmma_commit();
  };
  mbar_wait(bar_qd, 0);
  if (nt > 0) {
    mbar_wait(bar_f, 0);
    wgmma_fence();
    issue_sdp(0);
    wgmma_wait<1>();
    fence_regs(sc);
    probs(0);
    wgmma_wait<0>();
    fence_regs(dp);
    grads();
    pack_a(da, dp);
  }
  for (int it = 0; it + 1 < nt; ++it) {
    const int s1 = (it + 1) % kStages;
    mbar_wait(bar_f + 8 * s1, ((it + 1) / kStages) & 1);
    wgmma_fence();
    issue_sdp(it + 1);
    issue_dq(it);
    wgmma_wait<2>();   // S of tile it + 1
    fence_regs(sc);
    probs(it + 1);
    wgmma_wait<1>();   // dP of tile it + 1
    fence_regs(dp);
    grads();
    wgmma_wait<0>();   // dQ of tile it
    fence_regs(dq);
    mbar_arrive(bar_e + 8 * (it % kStages));
    pack_a(da, dp);
  }
  if (nt > 0) {
    wgmma_fence();
    issue_dq(nt - 1);
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(bar_e + 8 * ((nt - 1) % kStages));
  }

'''
STAGES = "constexpr int kStages = 3; "
# name -> [edit, ...]; an edit is (text, replacement) or (span, text)
VARIANTS = {
    "as built": [],
    "pipelined": [(DKV_SPAN, PIPELINED_DKV), (DQ_SPAN, PIPELINED_DQ)],
    "2 stages": [(STAGES, "constexpr int kStages = 2; ")],
    "4 stages": [(STAGES, "constexpr int kStages = 4; ")],
    "light first": [
        ("  const int k0 = blockIdx.y * kBlock;",
         "  const int k0 = (gridDim.y - 1 - blockIdx.y) * kBlock;"),
        ("  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;",
         "  const int q0 = blockIdx.y * kBlock;")],
}
TOL = 2e-2


def edited(src: str, edits) -> str:
    """``src`` with each edit applied; raises if its text is not there."""
    for old, new in edits:
        if isinstance(old, tuple):
            a, b = src.find(old[0]), src.find(old[1])
            if a < 0 or b < a:
                raise SystemExit(f"span {old[0][:40]!r} not in the source")
            src = src[:a] + new + src[b:]
        else:
            if old not in src:
                raise SystemExit(f"{old!r} not in the source")
            src = src.replace(old, new)
    return src


def build_variants():
    """{name: ctypes library} of every variant that compiles."""
    from repro_torch.kernels import build as B

    src = B.inlined(B.KERNEL_SOURCES["flash_attention_bwd_hopper"])
    out = B.BUILD_DIR / "bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        cu = out / f"v{i}.cu"
        cu.write_text(edited(src, edits))
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [B.nvcc_path(), *B.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc exit {proc.returncode}\n{log[-2000:]}")
            continue
        libs[name] = ctypes.CDLL(str(so))
    return libs


# (text in the source, the same text with stamps) for --trace; TR(P, I, K)
# stamps phase K of step I of pass P (0: dk/dv, 1: dq). Replaced once each.
TRACE_EDITS = [
    ("namespace {\n", """namespace {
__device__ unsigned long long g_trace[2][64][2][16][8];
__device__ unsigned long long g_start[2][64][4];  // ns, clock at start, end
#define TR(P, I, K) if (tr && t == 0) \\
    g_trace[P][blockIdx.x][wg][min((I), 15)][K] = clock64();
#define TSTAMP(P, J) if (tr && threadIdx.x == 0) { \\
    asm volatile("mov.u64 %0, %%globaltimer;" \\
                 : "=l"(g_start[P][blockIdx.x][J])); \\
    g_start[P][blockIdx.x][J + 1] = clock64(); }
"""),
    ("  const int n = nt * p.group;   // (q-head, q tile) steps\n",
     """  const int n = nt * p.group;   // (q-head, q tile) steps
  const bool tr = blockIdx.y == 0 && blockIdx.x < 64;
  TSTAMP(0, 0)
"""),
    ("""    mbar_wait(bar_f + 8 * s, (it / kStages) & 1);
    wgmma_fence();
    issue_s<D>(st,""", """    TR(0, it, 0)
    mbar_wait(bar_f + 8 * s, (it / kStages) & 1);
    TR(0, it, 1)
    wgmma_fence();
    issue_s<D>(st,"""),
    ("""    wgmma_wait<1>();   // S^T; dP^T may still run
    fence_regs(st);""", """    TR(0, it, 2)
    wgmma_wait<1>();   // S^T; dP^T may still run
    fence_regs(st);
    TR(0, it, 3)"""),
    ("""    pack_a(pa, st);
    wgmma_wait<0>();
    fence_regs(dpt);""", """    pack_a(pa, st);
    TR(0, it, 4)
    wgmma_wait<0>();
    fence_regs(dpt);
    TR(0, it, 5)"""),
    ("""    pack_a(da, dpt);
    wgmma_fence();""", """    pack_a(da, dpt);
    TR(0, it, 6)
    wgmma_fence();"""),
    ("""    fence_regs(dk);
    mbar_arrive(bar_e + 8 * s);""", """    fence_regs(dk);
    TR(0, it, 7)
    mbar_arrive(bar_e + 8 * s);"""),
    ("  const int64_t ld = int64_t(p.hkv) * D;\n",
     "  TSTAMP(0, 2)\n  const int64_t ld = int64_t(p.hkv) * D;\n"),
    ("  const int nt = hi >= lo ? hi / kRows + 1 - t0 : 0;\n",
     """  const int nt = hi >= lo ? hi / kRows + 1 - t0 : 0;
  const bool tr = blockIdx.y == 0 && blockIdx.x < 64;
  TSTAMP(1, 0)
"""),
    ("""    mbar_wait(bar_f + 8 * s, (it / kStages) & 1);
    wgmma_fence();
    issue_s<D>(sc,""", """    TR(1, it, 0)
    mbar_wait(bar_f + 8 * s, (it / kStages) & 1);
    TR(1, it, 1)
    wgmma_fence();
    issue_s<D>(sc,"""),
    ("""    wgmma_wait<1>();   // S; dP may still run
    fence_regs(sc);""", """    TR(1, it, 2)
    wgmma_wait<1>();   // S; dP may still run
    fence_regs(sc);
    TR(1, it, 3)"""),
    ("""    wgmma_wait<0>();
    fence_regs(dp);""", """    TR(1, it, 4)
    wgmma_wait<0>();
    fence_regs(dp);
    TR(1, it, 5)"""),
    ("""    pack_a(da, dp);
    wgmma_fence();""", """    pack_a(da, dp);
    TR(1, it, 6)
    wgmma_fence();"""),
    ("""    fence_regs(dq);
    mbar_arrive(bar_e + 8 * s);""", """    fence_regs(dq);
    TR(1, it, 7)
    mbar_arrive(bar_e + 8 * s);"""),
    ("  store_rows<D>(p.dq + ", "  TSTAMP(1, 2)\n  store_rows<D>(p.dq + "),
]
TRACE_READ = """
extern "C" int read_trace(void* tr, void* st) {
  cudaError_t e = cudaMemcpyFromSymbol(tr, g_trace, sizeof(g_trace));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(st, g_start, sizeof(g_start));
  return static_cast<int>(e);
}
"""
PHASES = ("wait for tiles", "issue S, dP", "wait for S", "form p",
          "wait for dP", "form ds", "output products")


def trace():
    """Build the stamped copy, run phi3's training shape once, print the
    median time of each phase per step (clock64, at the clock the stamps
    show)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build as B
    from repro_torch.kernels.flash_attention import attention_bwd, ops
    from repro_torch.kernels.interface import KernelType

    cs.phase_environment()
    text = B.inlined(B.KERNEL_SOURCES["flash_attention_bwd_hopper"])
    for old, new in TRACE_EDITS:
        if old not in text:
            raise SystemExit(f"--trace: {old[:60]!r} not in source")
        text = text.replace(old, new, 1)
    out = B.BUILD_DIR / "bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / "trace.cu").write_text(text + TRACE_READ)
    subprocess.run([B.nvcc_path(), *B.NVCC_FLAGS, "-o", str(out / "trace.so"),
                    str(out / "trace.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "trace.so"))
    fn = lib.flash_attention_bwd_wgmma
    fn.argtypes, fn.restype = ops._bwd_wgmma_fn().argtypes, ctypes.c_int
    ops._bwd_wgmma_fn = lambda: fn
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, do = (torch.randn(4, 1024, 32, 96, device="cuda", generator=gen)
             .bfloat16() for _ in range(2))
    k, v = (torch.randn(4, 1024, 32, 96, device="cuda", generator=gen)
            .bfloat16() for _ in range(2))
    out_, lse = ops._forward(q, k, v, True, 0, 0, KernelType.CUDA, True)
    for _ in range(5):
        attention_bwd(q, k, v, out_, lse, do)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    attention_bwd(q, k, v, out_, lse, do)
    t1.record()
    torch.cuda.synchronize()
    tr = np.zeros((2, 64, 2, 16, 8), dtype=np.uint64)
    st = np.zeros((2, 64, 4), dtype=np.uint64)
    if lib.read_trace(ctypes.c_void_p(tr.ctypes.data),
                      ctypes.c_void_p(st.ctypes.data)):
        raise SystemExit("--trace: reading the stamps failed")
    tr, st = tr.astype(np.int64), st.astype(np.int64)
    print(f"one call (D, dq and dk/dv launches) "
          f"{t0.elapsed_time(t1) * 1e3:.1f} us; the 64 heaviest CTAs of "
          f"each pass, 16 steps each; "
          f"medians over CTAs and steps 1-14", flush=True)
    for ps, name in enumerate(("dk/dv", "dq")):
        s = st[ps]
        ghz = float(np.median((s[:, 3] - s[:, 1]) / (s[:, 2] - s[:, 0])))

        def us(x):
            return float(np.median(x)) / ghz / 1e3

        print(f"{name} pass: SM clock {ghz:.3f} GHz; each CTA "
              f"{float(np.median(s[:, 2] - s[:, 0])) / 1e3:.2f} us")
        for wg in (0, 1):
            e = tr[ps, :, wg, 1:15]
            steps = [us(e[:, :, j + 1] - e[:, :, j]) for j in range(7)]
            per = us(np.diff(tr[ps, :, wg, 1:16, 0], axis=1))
            print(f"{name} warpgroup {wg}: per step {per:.3f} us = "
                  + ", ".join(f"{n} {x:.3f}" for n, x in zip(PHASES, steps)),
                  flush=True)


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import (attention_bwd,
                                                     attention_bwd_ref, ops)
    from repro_torch.kernels.interface import KernelType

    cs.phase_environment()
    libs = build_variants()
    tree_fn = ops._bwd_wgmma_fn
    argtypes = tree_fn().argtypes
    fns = {}
    for name, lib in libs.items():
        fn = lib.flash_attention_bwd_wgmma
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn

    def run(name, *args, **kw):
        ops._bwd_wgmma_fn = lambda: fns[name]
        try:
            return attention_bwd(*args, **kw)
        finally:
            ops._bwd_wgmma_fn = tree_fn

    cases = [c for c in cs.ATTN_BWD_CASES if c[-1] == "bfloat16"]
    gen = torch.Generator(device="cuda").manual_seed(9)
    inputs, bad = [], []
    for label, b, sq, skv, hq, hkv, d, causal, window, _ in cases:
        q, do = (torch.randn(b, sq, hq, d, device="cuda", generator=gen)
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn(b, skv, hkv, d, device="cuda", generator=gen)
                .bfloat16() for _ in range(2))
        kw = dict(causal=causal, window=window, q_offset=skv - sq)
        out, lse = ops._forward(q, k, v, causal, window, skv - sq,
                                KernelType.CUDA, True)
        args = (q, k, v, out, lse, do)
        built = attention_bwd(*args, **kw)
        want = attention_bwd_ref(*args, variant="wgmma", **kw)
        for name in fns:
            got = run(name, *args, **kw)
            torch.cuda.synchronize()
            if not (all(torch.equal(g, a) for g, a in zip(got, built))
                    and all(cs.within(g, w, TOL)
                            for g, w in zip(got, want))):
                bad.append((name, label))
        inputs.append((label, args, kw))
    if bad:
        print(f"variants that differ from the built kernel: {bad}")
        return 1
    print(f"{len(fns)} variants bit-equal to the built kernel at "
          f"{len(cases)} cases, within {TOL:g} of the plain version",
          flush=True)
    for rnd, order in enumerate((list(fns), list(fns)[::-1])):
        for name in order:
            for label, args, kw in inputs:
                ms = cs.cuda_time_ms(lambda: run(name, *args, **kw), 10)
                print(f"round {rnd} {name:>10}  {label:<24} "
                      f"{ms * 1e3:8.1f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(trace() if "--trace" in sys.argv[1:] else main())
