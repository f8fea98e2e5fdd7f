#!/usr/bin/env python3
"""Time edited copies of the chunked WKV-6 backward kernel side by side.

    python3 scripts/wkv_bwd_variants.py            # from the repository root
    python3 scripts/wkv_bwd_variants.py --trace    # one CTA's timeline

Each variant is ``csrc/rwkv6_scan_bwd_hopper.cu`` with a few lines
replaced. Some are other designs of the same function, checked against
the plain version with ``chip_smoke.py::wkv_grad_errors``; others ("cut:
...") leave part of the work out, to show which part sets the pace, and
are timed only. All are compiled at once with the flags of
``repro_torch.kernels.build`` into ``build/kernels/bwd_variants/``, then
timed at rwkv6-7b's training shape (4, 1024, 64, 64), bf16 r/k/v, f32 w,
no state and a zero final cotangent (the training path's), with the L2
cold (``chip_smoke.py::cuda_time_ms``), in two rounds of opposite order,
beside the sequential ``simt`` backward on the same tensors. Needs one
NVIDIA card and ``nvcc``; prints one line per (round, variant).

``--trace`` instead builds a copy that stamps ``clock64`` at each phase
of every task in the first 64 CTAs -- a task's wait for its loads and the
barrier after them; a forward task's decay products and state update; a
chunk backward's five steps and its wait for the cluster's pushes -- runs
the training shape once and prints each phase's median by kind of task
(the first forward pass, the segments' forward tasks, the chunk
backwards), the tasks' counts, and when the CTAs started and ended on
which SMs.
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
    "3 load stages": [("constexpr int kStages = 4;",
                       "constexpr int kStages = 3;")],
    "segments of 2 chunks": [("constexpr int kSeg = 4;",
                              "constexpr int kSeg = 2;")],
    "cut: no first forward pass": [
        ("  Task tk = first_task(nc), nx = tk, ahead = tk;\n",
         "  Task tk = first_task(nc);\n  start_pass2(tk, nc);\n"
         "  Task nx = tk, ahead = tk;\n")],
    "cut: no forward tasks": [("    if (!tk.bwd) {\n      state_update",
                               "    if (!tk.bwd) {\n      continue;\n"
                               "      state_update")],
    "cut: no in-chunk sums (step 2)": [
        ("    // 2. the in-chunk sums, a thread a (key il, step ts)\n    {",
         "    // 2. the in-chunk sums, a thread a (key il, step ts)\n"
         "    if (false) {")],
    "cut: pushes to itself": [
        ("      const uint32_t bar = mapa(smem_u32(&sm.full[b]), warp >> 1);\n"
         "      const uint32_t to = mapa(smem_u32(&sm.dvin[b][q][0][0]), "
         "warp >> 1);",
         "      const uint32_t bar = mapa(smem_u32(&sm.full[b]), q);\n"
         "      const uint32_t to = mapa(smem_u32(&sm.dvin[b][q][0][0]), "
         "q);")],
    "cut: no loads": [("  if (tk.valid) {\n    const int c = tk.c;",
                       "  if (false) {\n    const int c = tk.c;")],
}
SHAPE = (4, 1024, 64, 64)
MAX_TASKS = 192            # tasks a CTA at the training shape: 175
STAMPS = 10                # stamps a task

# (text in the source, the same text with stamps) for --trace; TS(k)
# stamps point k of task i in the first 64 CTAs (thread 0)
TRACE_EDITS = [
    ("namespace {\n", f"""namespace {{
__device__ long long g_stamp[64 * {MAX_TASKS} * {STAMPS}];
__device__ long long g_cta[1024 * 3];   // start ns, end ns, SM of a CTA
#define TS(K) if (blockIdx.x < 64 && threadIdx.x == 0 && i < {MAX_TASKS}) \\
    g_stamp[(blockIdx.x * {MAX_TASKS} + i) * {STAMPS} + (K)] = clock64();
"""),
    ("    cp_wait();                          // this task's chunk and the "
     "next's\n",
     "    TS(0);\n    cp_wait();\n"),
    ("    __syncthreads();  // the stages landed; slots, G tile, decay "
     "products\n",
     "    __syncthreads();\n    TS(1);\n"),
    ("      fwd_prep(sm.raw[(i + 1) % kStages], sm, (i + 1) & 1, il, ts);\n",
     "      fwd_prep(sm.raw[(i + 1) % kStages], sm, (i + 1) & 1, il, ts);\n"
     "    TS(2);\n"),
    ("      state_update(s, sm, st, i & 1, warp, g, cq);\n",
     "      state_update(s, sm, st, i & 1, warp, g, cq);\n      TS(3);\n"),
    ("    __syncthreads();\n\n    // 2. the in-chunk sums",
     "    __syncthreads();\n    TS(3);\n\n    // 2. the in-chunk sums"),
    ("    __syncthreads();\n\n    // 3. A over",
     "    __syncthreads();\n    TS(4);\n\n    // 3. A over"),
    ("    __syncthreads();\n\n    // 4. dv's partial",
     "    __syncthreads();\n    TS(5);\n\n    // 4. dv's partial"),
    ("    // 5. the chunk before's dv, its partials pushed a task ago: "
     "wait for\n",
     "    TS(6);\n    // 5. the chunk before's dv, its partials pushed a "
     "task ago: wait for\n"),
    ("      const float dvx = dv_sum(sm, pend, tid);\n",
     "      TS(7);\n      const float dvx = dv_sum(sm, pend, tid);\n"),
    ("        a.dw[off] = from_f32<W>(sm.out[2][tt][cc]);\n      }\n"
     "    }\n  }\n",
     "        a.dw[off] = from_f32<W>(sm.out[2][tt][cc]);\n      }\n"
     "    }\n    TS(8);\n  }\n"),
    ("}  // namespace\n", """}  // namespace
extern "C" int read_stamps(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamp,
                                               sizeof(g_stamp)));
}
extern "C" int read_ctas(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_cta, sizeof(g_cta)));
}
"""),
    ("  const int q = static_cast<int>(cluster.block_rank());   // key group\n",
     """  const int q = static_cast<int>(cluster.block_rank());   // key group
  if (threadIdx.x == 0 && blockIdx.x < 1024) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    g_cta[blockIdx.x * 3] = ns;
    g_cta[blockIdx.x * 3 + 2] = smid;
  }
"""),
    ("  // CTA leaves before its pushes into the others have landed\n"
     "  cluster_arrive();\n  cluster_wait();\n}",
     """  // CTA leaves before its pushes into the others have landed
  cluster_arrive();
  cluster_wait();
  if (threadIdx.x == 0 && blockIdx.x < 1024) {
    long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    g_cta[blockIdx.x * 3 + 1] = ns;
  }
}"""),
]
# kind -> the phases between stamps 0 .. its last
PHASES = {
    "forward, first pass": ("loads wait + barrier",
                            "loads issued, next decay products",
                            "state update"),
    "forward, segment": ("loads wait + barrier",
                         "loads issued, next decay products", "state update"),
    "chunk backward": ("loads wait + barrier",
                       "loads issued, next decay products",
                       "1. X, Y, dA, rs", "2. in-chunk sums",
                       "3. A over the keys", "4. dv partial pushed, G'",
                       "5. wait for the last chunk's pushes",
                       "5. its dv; dr, dk, dw stored"),
}


def build_variants(variants):
    """{name: ctypes function} of every variant that compiles."""
    from repro_torch.kernels import build as B

    src = B.KERNEL_SOURCES["rwkv6_scan_bwd_hopper"].read_text()
    out = B.BUILD_DIR / "bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} not in source")
            text = text.replace(old, new)
        cu = out / f"wkvbwd{i}.cu"
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
                for ln in log.splitlines() if "registers" in ln]
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        print(f"{name}: registers {regs}, {spills or 'no spills'}",
              flush=True)
        lib = ctypes.CDLL(str(so))
        fn = lib.rwkv6_scan_bwd_chunked
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 15
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = (fn, lib)
    return libs


def task_kinds(nc, seg=4):
    """The kind of each task of a CTA, in order (the kernel's task_at)."""
    kinds = ["forward, first pass"] * (nc - 1)
    nseg = -(-nc // seg)
    for sg in reversed(range(nseg)):
        n = min(seg, nc - sg * seg)
        kinds += ["forward, segment"] * (n - 1) + ["chunk backward"] * n
    return kinds


def trace(run):
    """Build the stamped copy, run it once through ``run(fn)``, print the
    median of each phase by kind of task over the first 64 CTAs."""
    import numpy as np

    _, lib = run(build_variants({"trace": TRACE_EDITS})["trace"])
    stamps = np.zeros(64 * MAX_TASKS * STAMPS, dtype=np.int64)
    if lib.read_stamps(ctypes.c_void_p(stamps.ctypes.data)):
        raise SystemExit("read_stamps failed")
    st = stamps.reshape(64, MAX_TASKS, STAMPS).astype(np.float64)
    kinds = task_kinds(-(-SHAPE[1] // 16))
    print(f"tasks a CTA {len(kinds)}; median cycles over 64 CTAs:",
          flush=True)
    total = 0.0
    for kind, phases in PHASES.items():
        idx = [i for i, k in enumerate(kinds) if k == kind]
        sel = st[:, idx]
        span = np.median(sel[:, :, len(phases)] - sel[:, :, 0])
        # the gap to the next task's first stamp
        nxt = [i + 1 for i in idx if i + 1 < len(kinds)]
        gap = np.median(st[:, nxt, 0] - st[:, [i - 1 for i in nxt],
                                             len(phases)])
        total += span * len(idx)
        print(f"  {kind} x {len(idx)}: {span:.0f} a task, "
              f"{span * len(idx):.0f} in all; to the next task {gap:.0f}")
        for p, name in enumerate(phases):
            d = np.median(sel[:, :, p + 1] - sel[:, :, p])
            print(f"    {name:26s} {d:7.0f}")
    whole = np.median(st[:, len(kinds) - 1,
                         len(PHASES["chunk backward"])]
                      - st[:, 0, 0])
    print(f"  a CTA's tasks, first stamp to last: {whole:.0f} cycles "
          f"(sum of task spans {total:.0f})", flush=True)
    ctas = np.zeros(1024 * 3, dtype=np.int64)
    if lib.read_ctas(ctypes.c_void_p(ctas.ctypes.data)):
        raise SystemExit("read_ctas failed")
    ctas = ctas.reshape(1024, 3)
    start, end = ctas[:, 0] - ctas[:, 0].min(), ctas[:, 1] - ctas[:, 0].min()
    per_sm = np.bincount(ctas[:, 2], minlength=132)
    runs = (end - start) / 1e3
    print(f"CTAs: last start {start.max() / 1e3:.1f} us, ends "
          f"{end.min() / 1e3:.1f}-{end.max() / 1e3:.1f} us, a CTA "
          f"{np.median(runs):.1f} us (median; {runs.min():.1f}-"
          f"{runs.max():.1f}); CTAs a SM {per_sm.min()}-{per_sm.max()}",
          flush=True)


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.rwkv6_scan import ops, wkv_bwd

    if not torch.cuda.is_available():
        print("wkv_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    b, t, h, n = SHAPE
    r, k, v, w, u, _ = cs.wkv_inputs(b, t, h, n, torch.bfloat16, gen, False)
    dout = torch.randn(b, t, h, n, device="cuda", generator=gen).to(
        torch.bfloat16)
    dsf = torch.zeros(b, h, n, n, device="cuda")
    want = wkv_bwd(r, k, v, w, u, None, dout, dsf, mode="torch")
    grads = tuple(torch.empty_like(g) for g in want[:4]) + (
        torch.empty(b, h, n, device="cuda"), torch.empty_like(want[5]))
    # a snapshot a chunk: room for every variant's segments
    snap = torch.empty(b * h * -(-t // 16) * n * n, device="cuda")
    uc = u.contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            uc.data_ptr(), None, dout.data_ptr(), dsf.data_ptr(),
            *(g.data_ptr() for g in grads), snap.data_ptr(), b, t, h, stream)

    def got():
        dr, dk, dv, dw, dup, ds = grads
        return dr, dk, dv, dw, dup.sum(0), ds

    if "--trace" in sys.argv[1:]:
        def once(pair):
            if pair[0](0, *args):
                raise SystemExit("trace: launch failed")
            torch.cuda.synchronize()
            return pair
        trace(once)
        return 0
    libs = build_variants(VARIANTS)
    bound = cs.wkv_bwd_bound(b, t, h, n, torch.bfloat16, False)[0]
    failed = False
    for rnd, order in enumerate((list(libs), list(libs)[::-1])):
        for name in order:
            fn = libs[name][0]
            if fn(0, *args):
                raise SystemExit(f"{name}: launch failed")
            torch.cuda.synchronize()
            errs, ok = cs.wkv_grad_errors(got(), want)
            if not name.startswith("cut"):
                failed |= not ok
            ms = cs.cuda_time_ms(lambda: fn(0, *args), 10)
            print(f"[{rnd}] {name:32s} {ms * 1e3:7.1f} us "
                  f"({bound / ms:.1%} of the {bound * 1e3:.1f} us bound)"
                  + ("" if name.startswith("cut") else
                     ", max abs err dr/dk/dv/dw/du/dstate0 "
                     + ", ".join(f"{e:.3g}" for e in errs)
                     + f", within wkv_grad_errors: {ok}"), flush=True)
        simt = ops.bwd_scratch(r, "simt")
        ms = cs.cuda_time_ms(lambda: ops.launch_bwd(
            r, k, v, w, uc, None, dout, dsf, grads, simt, variant="simt"), 5)
        print(f"[{rnd}] {'simt':32s} {ms * 1e3:7.1f} us", flush=True)
        del simt
    if failed:
        print("wkv_bwd_variants: a variant disagrees with the plain version",
              file=sys.stderr)
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
