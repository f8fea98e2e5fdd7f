#!/usr/bin/env python3
"""Time edited copies of the chunked WKV-6 kernel side by side.

    python3 scripts/wkv_variants.py            # from the repository root
    python3 scripts/wkv_variants.py --trace    # one chunk's timeline

Each variant is ``csrc/rwkv6_scan_hopper.cu`` with a few lines replaced.
Some are other designs of the same function, checked against the plain
version with ``chip_smoke.py::wkv_errors``; others ("cut: ...") leave
part of the work out, to show which part sets the pace, and are timed
only. All are compiled at once with the flags of
``repro_torch.kernels.build`` into ``build/kernels/variants/``, then
timed at rwkv6-7b's prefill (4, 1024, 64, 64), bf16 r/k/v, f32 w, a
given state, with the L2 cold (``chip_smoke.py::cuda_time_ms``), in two
rounds of opposite order, beside the sequential ``simt`` kernel on the
same tensors. Needs one NVIDIA card and ``nvcc``; prints one line per
(round, variant).

``--trace`` instead builds a copy that stamps ``clock64`` at each step of
chunk 32 in the first 64 CTAs -- the producers' loads and wait, their
barrier, A, the wait at the chunk's __syncthreads; the consumers' chunk and
their wait -- runs the prefill once and prints each step's median.
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
    "state wait before decay": [
        ("    // the state update runs on the tensor cores meanwhile\n",
         "    state_wait(st, va);\n")],
    "decay on producers": [
        ("  bar_sync(3, 2 * kProd);             // chunk 0 has landed\n"
         "  decay_products(sm.raw[0], sm.prep[0], min(kC, t), tid);\n", ""),
        ("    if (c + 1 < nc) {\n"
         "      bar_sync(3, 2 * kProd);         // chunk c + 1 has landed\n"
         "      decay_products(sm.raw[(c + 1) % kRawStages], "
         "sm.prep[(c + 1) & 1],\n"
         "                     min(kC, t - (c + 1) * kC), tid);\n", "    {\n"),
        ("    bar_arrive(3, 2 * kProd);         // ... for the consumers too\n",
         "    decay_products(sm.raw[0], sm.prep[0], min(kC, t), p);\n"
         "    asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: "
         "\"memory\");\n"),
        ("        bar_arrive(3, 2 * kProd);     // ... for the consumers too\n",
         "        decay_products(sm.raw[(c + 1) % kRawStages], "
         "sm.prep[(c + 1) & 1],\n"
         "                       min(kC, t - (c + 1) * kC), p);\n"
         "        asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: "
         "\"memory\");\n")],
    "cut: no chunk (mma)": [("    consume(sm.prep[c & 1],",
                             "    if (false) consume(sm.prep[c & 1],")],
    "cut: no A": [("        a_entries(sm.raw[(c + 1) % kRawStages],",
                   "        if (false) a_entries(sm.raw[(c + 1) % kRawStages],")],
    "cut: no loads": [("  if (c < nc) {\n    const int len", "  if (false) {\n    const int len")],
    "cut: no decay products": [
        ("      decay_products(sm.raw[(c + 1) % kRawStages],",
         "      if (false) decay_products(sm.raw[(c + 1) % kRawStages],")],
    "cut: A loads no w": [
        ("      load4(&st.w[(tt > 0 ? tt - 1 : 0) * kN + i0], w4);",
         "      w4[0] = w4[1] = w4[2] = w4[3] = 0.99f;")],
    "cut: no cp.async wait": [
        ("        cp_wait();\n        bar_sync(1, kProd);           // chunk c + 1",
         "        bar_sync(1, kProd);           // chunk c + 1")],
}
SHAPE = (4, 1024, 64, 64)

# (text in the source, the same text with stamps) for --trace; TS(role, k)
# stamps step k of chunk 32 (role 0: consumer warp 0, 1: producer warp 4)
TRACE_EDITS = [
    ("namespace {\n", """namespace {
__device__ long long g_stamp[64 * 2 * 16];
__device__ long long g_cta[256 * 3];     // start ns, end ns, SM of a CTA
#define TS(ROLE, K) if (blockIdx.x < 64 && c == 32 && \\
    (threadIdx.x & 127) == 0) \\
    g_stamp[(blockIdx.x * 2 + (ROLE)) * 16 + (K)] = clock64();
"""),
    ("""        // chunk c's raw tiles were used up in the last iteration
        load_chunk(sm.raw[c % kRawStages], r, k, v, w, base, step,
                   c + kRawStages, nc, t, p);
        cp_wait();
        bar_sync(1, kProd);           // chunk c + 1 has landed ...
        bar_arrive(3, 2 * kProd);     // ... for the consumers too
        a_entries(sm.raw[(c + 1) % kRawStages], sm.prep[(c + 1) & 1], uk,
                  min(kC, t - (c + 1) * kC), p);
      }
      __syncthreads();""", """        TS(1, 0);
        load_chunk(sm.raw[c % kRawStages], r, k, v, w, base, step,
                   c + kRawStages, nc, t, p);
        cp_wait();
        TS(1, 1);
        bar_sync(1, kProd);
        bar_arrive(3, 2 * kProd);
        TS(1, 2);
        a_entries(sm.raw[(c + 1) % kRawStages], sm.prep[(c + 1) & 1], uk,
                  min(kC, t - (c + 1) * kC), p);
        TS(1, 3);
      }
      __syncthreads();
      TS(1, 4);"""),
    ("""    consume(sm.prep[c & 1], st, va, sm.obuf, out, base + c * kC * step, step,
            min(kC, t - c * kC), tid);
    // the state update runs on the tensor cores meanwhile
    if (c + 1 < nc) {
      bar_sync(3, 2 * kProd);         // chunk c + 1 has landed
      decay_products(sm.raw[(c + 1) % kRawStages], sm.prep[(c + 1) & 1],
                     min(kC, t - (c + 1) * kC), tid);
      // the state update's B tiles go to wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    }
    state_wait(st, va);
    __syncthreads();""", """    TS(0, 0);
    consume(sm.prep[c & 1], st, va, sm.obuf, out, base + c * kC * step, step,
            min(kC, t - c * kC), tid);
    TS(0, 1);
    if (c + 1 < nc) {
      bar_sync(3, 2 * kProd);
      TS(0, 2);
      decay_products(sm.raw[(c + 1) % kRawStages], sm.prep[(c + 1) & 1],
                     min(kC, t - (c + 1) * kC), tid);
      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
      TS(0, 3);
    }
    state_wait(st, va);
    TS(0, 4);
    __syncthreads();
    TS(0, 5);"""),
    ("}  // namespace\n", """}  // namespace
extern "C" int read_stamps(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamp,
                                               sizeof(g_stamp)));
}
extern "C" int read_ctas(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_cta, sizeof(g_cta)));
}
extern "C" int occupancy() {
  int n = -1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, wkv6_chunked_kernel<float>, kThreads, sizeof(Smem<float>));
  return n;
}
"""),
    ("  const int bh = blockIdx.x;            // b * h + head\n",
     """  const int bh = blockIdx.x;            // b * h + head
  if (threadIdx.x == 0) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    g_cta[blockIdx.x * 3] = ns;
    g_cta[blockIdx.x * 3 + 2] = smid;
  }
"""),
    ("""      s_out[state_off + key * kN + val] = st[n][e];
    }
}""", """      s_out[state_off + key * kN + val] = st[n][e];
    }
  if (threadIdx.x == 0) {
    long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    g_cta[blockIdx.x * 3 + 1] = ns;
  }
}"""),
]
# role -> (name, its steps)
ROLES = ((0, "consumers", ("chunk (mma, out)", "chunk c+1 landed",
                           "decay products", "state wgmma wait",
                           "chunk sync")),
         (1, "producers", ("loads issued + wait", "barrier", "A",
                           "chunk sync")))


def build_variants(variants):
    """{name: ctypes library} of every variant that compiles."""
    from repro_torch.kernels import build as B

    src = B.KERNEL_SOURCES["rwkv6_scan_hopper"].read_text()
    out = B.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} not in source")
            text = text.replace(old, new)
        cu = out / f"wkv{i}.cu"
        cu.write_text(text)
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
        regs = [int(ln.split("Used ")[1].split()[0])
                for ln in log.splitlines() if "registers" in ln]
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        print(f"{name}: registers {regs}, {spills or 'no spills'}",
              flush=True)
        fn = ctypes.CDLL(str(so)).rwkv6_scan_chunked
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def trace(run):
    """Build the stamped copy, run it once through ``run(fn)``, print the
    median of each step of chunk 32 over 64 CTAs."""
    import numpy as np

    from repro_torch.kernels import build as B

    run(build_variants({"trace": TRACE_EDITS})["trace"])
    lib = ctypes.CDLL(str(B.BUILD_DIR / "variants" / "wkv0.so"))
    stamps = np.zeros(64 * 2 * 16, dtype=np.int64)
    if lib.read_stamps(ctypes.c_void_p(stamps.ctypes.data)):
        raise SystemExit("read_stamps failed")
    st = stamps.reshape(64, 2, 16).astype(np.float64)
    print("chunk 32, median over 64 CTAs, cycles:", flush=True)
    for role, name, steps in ROLES:
        for i, step in enumerate(steps):
            print(f"  {name:9s} {step:20s} "
                  f"{np.median(st[:, role, i + 1] - st[:, role, i]):7.0f}")
    ctas = np.zeros(256 * 3, dtype=np.int64)
    if lib.read_ctas(ctypes.c_void_p(ctas.ctypes.data)):
        raise SystemExit("read_ctas failed")
    ctas = ctas.reshape(256, 3)
    start, end = ctas[:, 0] - ctas[:, 0].min(), ctas[:, 1] - ctas[:, 0].min()
    per_sm = np.bincount(ctas[:, 2], minlength=132)
    print(f"CTAs: occupancy {lib.occupancy()} a SM; last start "
          f"{start.max() / 1e3:.1f} us, ends {end.min() / 1e3:.1f}-"
          f"{end.max() / 1e3:.1f} us; CTAs a SM {per_sm.min()}-"
          f"{per_sm.max()}", flush=True)


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.rwkv6_scan import ops, wkv

    if not torch.cuda.is_available():
        print("wkv_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    b, t, h, n = SHAPE
    r, k, v, w, u, s0 = cs.wkv_inputs(b, t, h, n, torch.bfloat16, gen)
    want = wkv(r, k, v, w, u, s0, mode="torch")
    out, so = torch.empty_like(r), torch.empty_like(s0)
    stream = torch.cuda.current_stream().cuda_stream
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), out.data_ptr(), so.data_ptr(), b, t,
            h, stream)
    simt = ops._simt_fn()
    if "--trace" in sys.argv[1:]:
        trace(lambda fn: (fn(0, *args), torch.cuda.synchronize()))
        return 0
    libs = build_variants(VARIANTS)
    bound = cs.wkv_bound(b, t, h, n, torch.bfloat16, True)[0]
    failed = False
    for rnd, order in enumerate((list(libs), list(libs)[::-1])):
        for name in order:
            fn = libs[name]
            if fn(0, *args):
                raise SystemExit(f"{name}: launch failed")
            torch.cuda.synchronize()
            eo, es, ok, _ = cs.wkv_errors((out, so), want)
            if not name.startswith("cut"):
                failed |= not ok
            ms = cs.cuda_time_ms(lambda: fn(0, *args), 20)
            print(f"[{rnd}] {name:22s} {ms * 1e3:.1f} us "
                  f"({bound / ms:.1%} of the {bound * 1e3:.1f} us bound), "
                  f"max abs err out {eo:.3g}, state {es:.3g}"
                  + ("" if name.startswith("cut") else
                     f", within wkv_errors: {ok}"), flush=True)
        ms = cs.cuda_time_ms(lambda: simt(1, 0, n, *args), 10)
        print(f"[{rnd}] {'simt':22s} {ms * 1e3:.1f} us", flush=True)
    if failed:
        print("wkv_variants: a variant disagrees with the plain version",
              file=sys.stderr)
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
