#!/usr/bin/env python3
"""Time edited copies of the Hopper attention kernels side by side.

    python3 scripts/attention_variants.py            # from the repository root
    python3 scripts/attention_variants.py --trace    # the prefill's timeline

Each variant is ``csrc/flash_attention_hopper.cu`` (the shared
``csrc/hopper.cuh`` it includes inlined) with a few constants replaced (a
ring of 2 K/V stages instead of 3, the warpgroups' turns off, another
register split, 8 rows in flight per thread in the split-kv decode,
...). All are compiled at once with the flags of
``repro_torch.kernels.build`` into ``build/kernels/variants/``, then timed
at the serving shapes and a few others with the L2 cold
(``chip_smoke.py::cuda_time_ms``), in two rounds of opposite order, beside
``scaled_dot_product_attention`` on the same tensors. The decode cases are
also timed at split counts other than the one ``plan`` picks. The
head_dim-96 cases are also timed on ``simt``, the CUDA-core kernel
(``csrc/flash_attention.cu``) that ran them before the Hopper variants took
head_dim 96. Every variant's output is checked against the plain version
(bf16 tolerance 2e-2). Needs one NVIDIA card and ``nvcc``; prints one line
per (round, variant, case).

``--trace`` instead builds a copy of the prefill kernel that stamps
``clock64`` at each step of each consumer warpgroup's loop (waiting for
K/V, waiting for its turn, issuing S and P.V, waiting for S, the softmax,
waiting for P.V, rescaling O and packing P) in the 64 heaviest CTAs,
runs deepseek's prefill shape (4, 1024, 16, 128) once, and prints the
median time of each step per loop iteration, of the prologue (the first
tile's S and softmax) and of the epilogue (the last P.V and the store).
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
    "2 stages": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "no turns": [("constexpr bool kPingpong = true;",
                  "constexpr bool kPingpong = false;")],
    "regs 240/24": [("constexpr int kConsumerRegs = 232;",
                     "constexpr int kConsumerRegs = 240;"),
                    ("constexpr int kProducerRegs = 40;",
                     "constexpr int kProducerRegs = 24;")],
    "L2 promotion 128B": [("CU_TENSOR_MAP_L2_PROMOTION_L2_256B",
                           "CU_TENSOR_MAP_L2_PROMOTION_L2_128B")],
    "decode 8 rows": [("constexpr int STEPS = 4; ",
                       "constexpr int STEPS = 8; ")],
}
# (b, sq, skv, hq, hkv, d, q_offset, split counts to force (None: plan's))
CASES = [
    (4, 1024, 1024, 16, 16, 128, 0, (None,)),      # deepseek prefill
    (1, 1024, 1024, 4, 4, 128, 0, (None,)),        # 32 CTAs: latency
    (2, 300, 300, 12, 2, 128, 0, (None,)),         # ragged, GQA 12:2
    (1, 4096, 4096, 32, 8, 128, 0, (None,)),       # long, GQA 32:8
    (4, 1, 1040, 16, 16, 128, 1030, (None, 4, 16)),  # deepseek decode
    (1, 1, 1040, 40, 8, 128, 1030, (None, 32)),    # GQA 40:8 decode
    (4, 1024, 1024, 32, 32, 96, 0, (None,)),       # phi3 prefill, head_dim 96
    (4, 1, 1040, 32, 32, 96, 1030, (None, 8, 16)),  # phi3 decode
]
TOL = 2e-2


def build_variants():
    """{name: ctypes library} of every variant that compiles."""
    from repro_torch.kernels import build as B

    src = B.inlined(B.KERNEL_SOURCES["flash_attention_hopper"])
    out = B.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} not in source")
            text = text.replace(old, new)
        cu = out / f"v{i}.cu"
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
        libs[name] = ctypes.CDLL(str(so))
    return libs


# (text in the source, the same text with stamps) for --trace; TR(i, k)
# stamps step k of loop iteration i (-1: the prologue, 14: the epilogue)
TRACE_EDITS = [
    ("namespace {\n", """namespace {
__device__ unsigned long long g_trace[64 * 2 * 16 * 8];
__device__ unsigned long long g_start[64 * 4];  // ns, clock at start, end
#define TR(IT, K) if (tr && t == 0) g_trace[((blockIdx.x * 2 + wg) * 16 + \\
    min((IT) + 1, 15)) * 8 + (K)] = clock64();
"""),
    ("""  const int wg = threadIdx.x / 128;
  if (wg == 2) {""", """  const int wg = threadIdx.x / 128;
  const bool tr = blockIdx.y == 0 && blockIdx.x < 64;
  if (tr && threadIdx.x == 0) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_start[blockIdx.x * 4]));
    g_start[blockIdx.x * 4 + 1] = clock64();
  }
  if (wg == 2) {"""),
    ("""    mbar_wait(bar_k, 0);
    take_turn();""", """    TR(-1, 0);
    mbar_wait(bar_k, 0);
    TR(-1, 1);
    take_turn();
    TR(-1, 2);"""),
    ("""    give_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    online_softmax(sc, m, l, alpha, p, t0 * kBN, rows);
    pack_p(pa, sc);""", """    give_turn();
    TR(-1, 3);
    wgmma_wait<0>();
    fence_regs(sc);
    TR(-1, 4);
    online_softmax(sc, m, l, alpha, p, t0 * kBN, rows);
    TR(-1, 5);
    pack_p(pa, sc);
    TR(-1, 7);"""),
    ("""    mbar_wait(bar_k + 8 * s1, ((it + 1) / kStages) & 1);
    mbar_wait(bar_v + 8 * s, (it / kStages) & 1);
    take_turn();""", """    TR(it, 0);
    mbar_wait(bar_k + 8 * s1, ((it + 1) / kStages) & 1);
    mbar_wait(bar_v + 8 * s, (it / kStages) & 1);
    TR(it, 1);
    take_turn();
    TR(it, 2);"""),
    ("""    give_turn();
    wgmma_wait<1>();""", """    give_turn();
    TR(it, 3);
    wgmma_wait<1>();"""),
    ("""    online_softmax(sc, m, l, alpha, p, (t0 + it + 1) * kBN, rows);
    wgmma_wait<0>();
    fence_regs(o);""", """    TR(it, 4);
    online_softmax(sc, m, l, alpha, p, (t0 + it + 1) * kBN, rows);
    TR(it, 5);
    wgmma_wait<0>();
    fence_regs(o);
    TR(it, 6);"""),
    ("""++i) o[i] *= alpha[(i / 2) % 2];
    pack_p(pa, sc);""", """++i) o[i] *= alpha[(i / 2) % 2];
    pack_p(pa, sc);
    TR(it, 7);"""),
    ("""    mbar_wait(bar_v + 8 * s, (it / kStages) & 1);
    take_turn();
    wgmma_fence();
    issue_pv<D>(o, pa, v_addr + s * L::kKV);
    wgmma_commit();
    give_turn();
    wgmma_wait<0>();""", """    TR(14, 0);
    mbar_wait(bar_v + 8 * s, (it / kStages) & 1);
    take_turn();
    wgmma_fence();
    issue_pv<D>(o, pa, v_addr + s * L::kKV);
    wgmma_commit();
    give_turn();
    TR(14, 3);
    wgmma_wait<0>();
    TR(14, 6);"""),
    ("""    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}""", """    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
  TR(14, 7);
  if (tr && threadIdx.x == 0) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_start[blockIdx.x * 4 + 2]));
    g_start[blockIdx.x * 4 + 3] = clock64();
  }
}

}  // namespace
extern "C" int read_trace(void* trace, void* start) {
  cudaError_t e = cudaMemcpyFromSymbol(trace, g_trace, sizeof(g_trace));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(start, g_start, sizeof(g_start));
  return static_cast<int>(e);
}
namespace {"""),
]
STEPS = ("K/V wait", "turn wait", "issue", "S wait", "softmax", "P.V wait",
         "rescale+pack")


def trace():
    """Build the stamped copy, run deepseek's prefill once, print the
    median time of each step (clock64, at the clock the stamps show)."""
    import numpy as np
    import torch

    from repro_torch.kernels import build as B
    from repro_torch.kernels.flash_attention import attention

    text = B.inlined(B.KERNEL_SOURCES["flash_attention_hopper"])
    for old, new in TRACE_EDITS:
        if old not in text:
            raise SystemExit(f"--trace: {old[:60]!r} not in source")
        text = text.replace(old, new, 1)
    out = B.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / "trace.cu").write_text(text)
    subprocess.run([B.nvcc_path(), *B.NVCC_FLAGS, "-o", str(out / "trace.so"),
                    str(out / "trace.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "trace.so"))
    use(lib)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(4, 1024, 16, 128, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    for _ in range(5):
        attention(q, k, v, q_offset=0)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    attention(q, k, v, q_offset=0)
    t1.record()
    torch.cuda.synchronize()
    tr = np.zeros((64, 2, 16, 8), dtype=np.uint64)
    st = np.zeros((64, 4), dtype=np.uint64)
    if lib.read_trace(ctypes.c_void_p(tr.ctypes.data),
                      ctypes.c_void_p(st.ctypes.data)):
        raise SystemExit("--trace: reading the stamps failed")
    tr, st = tr.astype(np.int64), st.astype(np.int64)
    # the SM clock over each CTA's life: clock64 cycles per globaltimer ns
    ghz = float(np.median((st[:, 3] - st[:, 1]) / (st[:, 2] - st[:, 0])))
    print(f"one launch {t0.elapsed_time(t1) * 1e3:.1f} us; SM clock "
          f"{ghz:.3f} GHz; the 64 CTAs with 8 kv tiles each, each CTA "
          f"{float(np.median(st[:, 2] - st[:, 0])) / 1e3:.2f} us (median); "
          f"medians per warpgroup")

    def us(x):
        return float(np.median(x)) / ghz / 1e3

    for wg in (0, 1):
        e = tr[:, wg]
        loop = e[:, 1:8]                      # iterations 0..6
        steps = [us(loop[:, :, j + 1] - loop[:, :, j]) for j in range(7)]
        per = us(np.diff(np.concatenate([loop[:, :, 0], e[:, 15:, 0]], 1)))
        print(f"warpgroup {wg}: per loop iteration {per:.2f} us = "
              + ", ".join(f"{n} {x:.2f}" for n, x in zip(STEPS, steps)))
        print(f"warpgroup {wg}: start to prologue "
              f"{us(e[:, 0, 0] - st[:, 1]):.2f} "
              f"us; prologue (first S and softmax) "
              f"{us(e[:, 0, 7] - e[:, 0, 0]):.2f} us; epilogue (last P.V, "
              f"O to shared memory, TMA store) "
              f"{us(e[:, 15, 7] - e[:, 15, 0]):.2f} us")


def use(lib):
    """Point the attention op at ``lib``'s entry points."""
    from repro_torch.kernels.flash_attention import ops

    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    wg, sk = lib.flash_attention_wgmma, lib.flash_attention_split_kv
    wg.argtypes = [I] + [P] * 4 + [I] * 5 + [L] * 12 + [I] * 3 + [F, P, P]
    sk.argtypes = [I] + [P] * 8 + [I] * 3 + [L] * 10 + [I] * 4 + [F, P]
    wg.restype = sk.restype = I
    ops._wgmma_fn = lambda: wg
    ops._split_fn = lambda: sk


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import attention, ops

    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if "--trace" in sys.argv[1:]:
        trace()
        return 0
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = []
    for b, sq, skv, hq, hkv, d, off, splits in CASES:
        q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   .to(torch.bfloat16)
                   for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
        data.append((q, k, v, off, splits,
                     attention(q, k, v, q_offset=off, mode="torch")))
    plan = ops.plan
    failed = False
    try:
        for rnd, order in enumerate((list(libs), list(libs)[::-1])):
            for name in order:
                use(libs[name])
                for q, k, v, off, splits, want in data:
                    for n in splits:
                        ops.plan = plan if n is None else (
                            lambda *a, _n=n, **kw: ("split_kv", _n))
                        got = attention(q, k, v, q_offset=off)
                        err = float((got.float() - want.float()).abs().max())
                        failed |= not err <= TOL
                        ms = cs.cuda_time_ms(
                            lambda: attention(q, k, v, q_offset=off), 50)
                        used = plan(q, k, v, q_offset=off) if n is None \
                            else ("split_kv", n)
                        print(f"[{rnd}] {name:18s} q {tuple(q.shape)} kv "
                              f"{k.shape[1]} {used[0]}/{used[1]}: "
                              f"{ms * 1e3:.1f} us, max abs err {err:.3g}",
                              flush=True)
        ops.plan = lambda *a, **kw: ("simt", 1)
        for q, k, v, off, _, want in data:
            if q.shape[3] != 96:
                continue
            got = attention(q, k, v, q_offset=off)
            err = float((got.float() - want.float()).abs().max())
            failed |= not err <= TOL
            ms = cs.cuda_time_ms(lambda: attention(q, k, v, q_offset=off), 20)
            print(f"simt (CUDA cores)  q {tuple(q.shape)} kv {k.shape[1]}: "
                  f"{ms * 1e3:.1f} us, max abs err {err:.3g}", flush=True)
    finally:
        ops.plan = plan
    for q, k, v, off, _, _ in data:
        ms = cs.cuda_time_ms(cs.sdpa_call(q, k, v, True, off), 50)
        print(f"scaled_dot_product_attention q {tuple(q.shape)} kv "
              f"{k.shape[1]}: {ms * 1e3:.1f} us", flush=True)
    if failed:
        print("attention_variants: a variant disagrees with the plain "
              "version", file=sys.stderr)
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
