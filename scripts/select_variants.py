#!/usr/bin/env python3
"""Time edited copies of the tiled select kernel side by side.

    python3 scripts/select_variants.py        # from the repository root

Each variant is ``csrc/select_hopper.cu`` with a few lines replaced, each
undoing or changing one step of the built design: the threads a block and
the tile size, the scan's backward walk, its programmatic dependent
launch, its streaming stores (plain stores, or ``__stwb``, in place of
``__stcs``), one persistent cooperative launch with a grid-wide barrier
in place of the two launches, a cluster of 16 CTAs per (leaf, sender)
that holds its slice in shared memory and exchanges counts through
distributed shared memory, L2 eviction policies (the count's loads kept,
the scan's evicted first); the built source called once per group of
senders whose scores fit the L2 ("groups of ..."); and cuts ("cut: ...")
that leave one launch out, to show what each costs (timed only: a cut's
output is not checked; the scan alone reads the counts an earlier launch
left). All are compiled at once with the flags of
``repro_torch.kernels.build`` into ``build/kernels/variants/``, then run
on the four select ops at the CNN LAN (40 senders) and WAN (4) uplinks of
``chip_smoke.py`` (its inputs, thresholds and bounds), each checked bit
for bit against the plain version and timed with the L2 cold
(``chip_smoke.py::cuda_time_ms``), in two rounds of opposite order; a
variant that disagrees makes the script exit 1, one the card refuses to
launch is reported and skipped. Needs one NVIDIA card and ``nvcc``;
prints one line per (round, shape, op, variant).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

_COUNT = "    count_kernel<R, E><<<grid, kThreads, 0, s>>>("

FUSED = """template <bool RANDK, bool EF>
__global__ void __launch_bounds__(kThreads)
    fused_kernel(const float* __restrict__ v, const float* __restrict__ ef,
                 const float* __restrict__ u, float* __restrict__ dq,
                 int32_t* __restrict__ ranks, float* __restrict__ ef_out,
                 const int64_t* __restrict__ segs,
                 const int32_t* __restrict__ tile0,
                 const float* __restrict__ thresh,
                 const float* __restrict__ scale, uint32_t* counts, int nseg,
                 int ntiles, int64_t senders, int64_t cols, int64_t ld_v,
                 int64_t ld_e, int64_t ld_u, int64_t ld_o, int vec) {
  const int64_t work = int64_t(ntiles) * senders;
  for (int64_t w = blockIdx.x; w < work; w += gridDim.x) {
    __syncthreads();
    count_tile<RANDK, EF>(static_cast<int>(w % ntiles), w / ntiles, ntiles,
                          v, ef, u, segs, tile0, thresh, counts, nseg, ld_v,
                          ld_e, ld_u, vec);
  }
  cooperative_groups::this_grid().sync();
  for (int64_t w = work - 1 - blockIdx.x; w >= 0; w -= gridDim.x) {
    __syncthreads();
    scan_tile<RANDK, EF>(static_cast<int>(w % ntiles), w / ntiles, ntiles, v,
                         ef, u, dq, ranks, ef_out, segs, tile0, thresh, scale,
                         counts, nseg, cols, ld_v, ld_e, ld_u, ld_o, vec);
  }
}

template <bool R, bool E>
cudaError_t launch_fused(const float* v, const float* ef, const float* u,
                         float* dq, int32_t* ranks, float* ef_out,
                         const int64_t* segs, const int32_t* tile0,
                         const float* thresh, const float* scale,
                         uint32_t* counts, int nseg, int ntiles,
                         int64_t senders, int64_t cols, int64_t ld_v,
                         int64_t ld_e, int64_t ld_u, int64_t ld_o, int vec,
                         cudaStream_t s) {
  static int per_sm = 0, sms = 0;
  if (per_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_kernel<R, E>,
                                                  kThreads, 0);
  }
  const int64_t work = int64_t(ntiles) * senders;
  const int64_t most = int64_t(per_sm) * sms;
  const dim3 grid(static_cast<unsigned>(work < most ? work : most));
  void* args[] = {&v, &ef, &u, &dq, &ranks, &ef_out, &segs, &tile0,
                  &thresh, &scale, &counts, &nseg, &ntiles, &senders, &cols,
                  &ld_v, &ld_e, &ld_u, &ld_o, &vec};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_kernel<R, E>), grid,
      dim3(kThreads), args, 0, s);
}

}  // namespace
"""
# the launch macro, replaced by one cooperative launch (the old one is
# kept under another name, unused)
FUSED_MACRO = """#define SEL_LAUNCH(R, E) \\
  return static_cast<int>(launch_fused<R, E>(                              \\
      v, ef, u, dq, ranks, ef_out, segs, tile0, thresh, scale, counts,     \\
      nseg, ntiles, senders, cols, ld_v, ld_e, ld_u, ld_o, vec, s))
#define TWO_LAUNCHES(R, E)"""

# one cluster of kCl CTAs per (leaf, sender): each CTA copies its slice
# of the leaf into shared memory (cp.async), counts it, the CTAs exchange
# their counts through distributed shared memory, and each scans its slice
# from shared memory -- every input read once
CLUSTER = """constexpr int kCl = 16;  // CTAs a cluster, one per (leaf, sender)
constexpr int kMaxSub = 8;   // sub-tiles a CTA's slice, at most
constexpr int kClParts = kMaxSub * kWarps;

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(d),
               "l"(src));
}

template <bool RANDK, bool EF>
__global__ void __launch_bounds__(kThreads)
    cluster_kernel(const float* __restrict__ v, const float* __restrict__ ef,
                   const float* __restrict__ u, float* __restrict__ dq,
                   int32_t* __restrict__ ranks, float* __restrict__ ef_out,
                   const int64_t* __restrict__ segs,
                   const float* __restrict__ thresh,
                   const float* __restrict__ scale, int nseg, int64_t cols,
                   int64_t ld_v, int64_t ld_e, int64_t ld_u, int64_t ld_o,
                   int vec, int per) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ float4 dyn[];
  __shared__ uint32_t parts[kClParts];
  __shared__ uint32_t warp_total[kWarps];
  __shared__ uint32_t slice_total;
  __shared__ int carry[3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = blockIdx.x / kCl;
  const int rank = static_cast<int>(cl.block_rank());
  const int64_t b = blockIdx.y;
  const int64_t off = segs[4 * s], len = segs[4 * s + 1], k = segs[4 * s + 2];
  const float thr = thresh[b * nseg + s];
  const float kscale = scale != nullptr ? scale[s] : 1.0f;
  const int64_t lo = int64_t(rank) * per;
  const int n =
      static_cast<int>(lo >= len ? 0 : (len - lo < per ? len - lo : per));
  const bool vok = vec != 0 && (off % 4) == 0;
  float* v_s = reinterpret_cast<float*>(dyn);
  float* e_s = v_s + per;
  float* u_s = v_s + (EF ? 2 : 1) * per;
  const float* vb = v + b * ld_v + off + lo;
  const float* eb = EF ? ef + b * ld_e + off + lo : nullptr;
  const float* ub = RANDK ? u + b * ld_u + off + lo : nullptr;
  dq += b * ld_o;
  ranks += b * ld_o;
  if (EF) ef_out += b * ld_o;
  if (s == nseg - 1 && rank == kCl - 1) {
    const float* vr = v + b * ld_v;
    const float* er = EF ? ef + b * ld_e : nullptr;
    for (int64_t c = off + len + threadIdx.x; c < cols; c += kThreads) {
      dq[c] = 0.0f;
      ranks[c] = -1;
      if (EF) ef_out[c] = __fadd_rn(vr[c], er[c]);
    }
  }
  // the slice into shared memory
  for (int i = threadIdx.x * kItems; i < n; i += kThreads * kItems) {
    if (vok && i + kItems <= n) {
      cp16(v_s + i, vb + i);
      if (EF) cp16(e_s + i, eb + i);
      if (RANDK) cp16(u_s + i, ub + i);
    } else {
      for (int j = i; j < n && j < i + kItems; ++j) {
        v_s[j] = vb[j];
        if (EF) e_s[j] = eb[j];
        if (RANDK) u_s[j] = ub[j];
      }
    }
  }
  asm volatile("cp.async.commit_group;\\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
  __syncthreads();
  // counts: the thread's values of each sub-tile (msg kept in v_s)
  uint32_t own[kMaxSub], incl[kMaxSub];
  uint32_t cnt = 0;
#pragma unroll
  for (int c = 0; c < kMaxSub; ++c) {
    const int i = c * kSubTile + threadIdx.x * kItems;
    float sc[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      sc[j] = 0.0f;
      if (i + j < n) {
        const float m = EF ? __fadd_rn(v_s[i + j], e_s[i + j]) : v_s[i + j];
        if (EF) v_s[i + j] = m;
        sc[j] = RANDK ? u_s[i + j] : fabsf(m);
      }
    }
    own[c] = count_items(sc, thr, i, n);
    cnt += own[c];
  }
  cnt = __reduce_add_sync(kFull, cnt);
  if (lane == 0) warp_total[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t = 0;
    for (int w = 0; w < kWarps; ++w) t += warp_total[w];
    slice_total = t;
  }
  cl.sync();  // every CTA's slice total is written
  if (warp == 0) {
    const uint32_t w =
        lane < kCl ? *cl.map_shared_rank(&slice_total, lane) : 0u;
    const uint32_t bs = __reduce_add_sync(kFull, lane < rank ? w >> 16 : 0u);
    const uint32_t bt =
        __reduce_add_sync(kFull, lane < rank ? w & 0xffffu : 0u);
    const uint32_t ls = __reduce_add_sync(kFull, w >> 16);
    if (lane == 0) {
      carry[0] = static_cast<int>(bs);
      carry[1] = static_cast<int>(bt);
      carry[2] = static_cast<int>(k - static_cast<int64_t>(ls));
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxSub; ++c) {
    uint32_t x = own[c];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    incl[c] = x;
    if (lane == 31) parts[c * kWarps + warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
    uint32_t run = 0;
#pragma unroll
    for (int q = 0; q < kClParts; q += 32) {
      const uint32_t x = parts[q + lane];
      uint32_t y = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t z = __shfl_up_sync(kFull, y, o);
        if (lane >= o) y += z;
      }
      parts[q + lane] = run + y - x;
      run += __shfl_sync(kFull, y, 31);
    }
  }
  __syncthreads();
  const int cap = carry[2];
#pragma unroll
  for (int c = 0; c < kMaxSub; ++c) {
    const int i = c * kSubTile + threadIdx.x * kItems;
    if (i >= n) continue;
    const uint32_t ex = parts[c * kWarps + warp] + incl[c] - own[c];
    int ps = carry[0] + static_cast<int>(ex >> 16);
    int pt = carry[1] + static_cast<int>(ex & 0xffffu);
    float d[kItems], e[kItems];
    int32_t r[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool in = i + j < n;
      const float m = in ? v_s[i + j] : 0.0f;
      const float sc = in ? (RANDK ? u_s[i + j] : fabsf(m)) : 0.0f;
      const bool strict = in && sc > thr;
      const bool tie = in && sc == thr;
      ps += strict;
      pt += tie;
      const bool sel = strict || (tie && pt <= cap);
      const float kept = scale != nullptr ? __fmul_rn(m, kscale) : m;
      d[j] = sel ? kept : 0.0f;
      r[j] = sel ? ps + (pt < cap ? pt : cap) - 1 : -1;
      e[j] = EF ? __fsub_rn(m, d[j]) : 0.0f;
    }
    const int64_t o = off + lo + i;
    if (vok && i + kItems <= n) {
      __stcs(reinterpret_cast<float4*>(dq + o),
             make_float4(d[0], d[1], d[2], d[3]));
      __stcs(reinterpret_cast<int4*>(ranks + o),
             make_int4(r[0], r[1], r[2], r[3]));
      if (EF)
        __stcs(reinterpret_cast<float4*>(ef_out + o),
               make_float4(e[0], e[1], e[2], e[3]));
    } else {
      for (int j = 0; j < kItems; ++j) {
        if (i + j < n) {
          dq[o + j] = d[j];
          ranks[o + j] = r[j];
          if (EF) ef_out[o + j] = e[j];
        }
      }
    }
  }
  cl.sync();  // no CTA leaves while another may read its slice total
}

template <bool R, bool E>
cudaError_t launch_cluster(const float* v, const float* ef, const float* u,
                           float* dq, int32_t* ranks, float* ef_out,
                           const int64_t* segs, const float* thresh,
                           const float* scale, int nseg, int64_t cols,
                           int64_t senders, int64_t ld_v, int64_t ld_e,
                           int64_t ld_u, int64_t ld_o, int vec,
                           cudaStream_t s) {
  // a slice: a multiple of 4 values, kCl of them cover the widest leaf
  const int per = static_cast<int>(((cols + kCl - 1) / kCl + 3) / 4 * 4);
  if (per > kMaxSub * kSubTile) return cudaErrorInvalidValue;
  const size_t smem = size_t(per) * 4 * (1 + (E ? 1 : 0) + (R ? 1 : 0));
  cudaFuncSetAttribute(cluster_kernel<R, E>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  cudaFuncSetAttribute(cluster_kernel<R, E>,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(kCl * nseg),
                     static_cast<unsigned>(senders));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, cluster_kernel<R, E>, v, ef, u, dq, ranks,
                            ef_out, segs, thresh, scale, nseg, cols, ld_v,
                            ld_e, ld_u, ld_o, vec, per);
}

}  // namespace
"""
CLUSTER_MACRO = """#define SEL_LAUNCH(R, E) \\
  return static_cast<int>(launch_cluster<R, E>(                            \\
      v, ef, u, dq, ranks, ef_out, segs, thresh, scale, nseg, cols,        \\
      senders, ld_v, ld_e, ld_u, ld_o, vec, s))
#define TWO_LAUNCHES(R, E)"""
CLUSTER_EDITS = [
    ("#include <cstdint>\n",
     "#include <cooperative_groups.h>\n\n#include <cstdint>\n"),
    ("}  // namespace\n", CLUSTER),
    ("#define SEL_LAUNCH(R, E)", CLUSTER_MACRO)]

# the count's loads with an L2 evict_last policy, the scan's evict_first
KEEP_LOADS = """__device__ __forceinline__ float4 ld_keep(const float* p) {
  float4 r;
  asm volatile(
      "{\\n\\t.reg .b64 pol;\\n\\t"
      "createpolicy.fractional.L2::evict_last.b64 pol, 1.0;\\n\\t"
      "ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], pol;\\n\\t}"
      : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
      : "l"(p));
  return r;
}

template <bool RANDK, bool EF>
__device__ __forceinline__ void load_scores(const float* v, const float* e,
                                            const float* u, int i, int n,
                                            bool vec, float sc[kItems]) {
  if (vec && i + kItems <= n) {
    if (RANDK) {
      unpack4(ld_keep(u + i), sc);
    } else {
      float m[kItems];
      unpack4(ld_keep(v + i), m);
      if (EF) {
        float ev[kItems];
        unpack4(ld_keep(e + i), ev);
#pragma unroll
        for (int j = 0; j < kItems; ++j) m[j] = __fadd_rn(m[j], ev[j]);
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) sc[j] = fabsf(m[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      sc[j] = 0.0f;
      if (i + j < n)
        sc[j] = RANDK ? u[i + j]
                      : fabsf(EF ? __fadd_rn(v[i + j], e[i + j]) : v[i + j]);
    }
  }
}

"""
LOAD_SCORES = """// The scores alone (rand-k reads only u).
template <bool RANDK, bool EF>
__device__ __forceinline__ void load_scores(const float* v, const float* e,
                                            const float* u, int i, int n,
                                            bool vec, float sc[kItems]) {
  if (RANDK) {
    if (vec && i + kItems <= n) {
      unpack4(*reinterpret_cast<const float4*>(u + i), sc);
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j) sc[j] = i + j < n ? u[i + j] : 0.0f;
    }
  } else {
    float m[kItems];
    load_values<false, EF>(v, e, nullptr, i, n, vec, m, sc);
  }
}

"""

# ablations of the built design, each a list of (text in the source, its
# replacement)
def _consts(threads=None, sub=None):
    out = []
    if threads:
        out.append(("constexpr int kThreads = 512;",
                    f"constexpr int kThreads = {threads};"))
    if sub:
        out.append(("constexpr int kSub = 2;", f"constexpr int kSub = {sub};"))
    return out


FORWARD = [("  scan_tile<RANDK, EF>(gridDim.x - 1 - blockIdx.x, "
            "gridDim.y - 1 - blockIdx.y,",
            "  scan_tile<RANDK, EF>(blockIdx.x, blockIdx.y,")]
NO_PDL = [("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")]
STCS = ("      __stcs(reinterpret_cast<float4*>(dq + o),\n"
        "             make_float4(d[0], d[1], d[2], d[3]));\n"
        "      __stcs(reinterpret_cast<int4*>(ranks + o),\n"
        "             make_int4(r[0], r[1], r[2], r[3]));\n"
        "      if (EF)\n"
        "        __stcs(reinterpret_cast<float4*>(ef_out + o),\n"
        "               make_float4(e[0], e[1], e[2], e[3]));")
# the stores as plain assignments, and as __stwb (write-back) intrinsics
PLAIN_STORES = [(STCS, """\
      *reinterpret_cast<float4*>(dq + o) = make_float4(d[0], d[1], d[2], d[3]);
      *reinterpret_cast<int4*>(ranks + o) = make_int4(r[0], r[1], r[2], r[3]);
      if (EF)
        *reinterpret_cast<float4*>(ef_out + o) =
            make_float4(e[0], e[1], e[2], e[3]);""")]
STWB = [(STCS, STCS.replace("__stcs", "__stwb"))]
PERSISTENT = NO_PDL + [
    ("#include <cstdint>\n",
     "#include <cooperative_groups.h>\n\n#include <cstdint>\n"),
    ("}  // namespace\n", FUSED),
    ("#define SEL_LAUNCH(R, E)", FUSED_MACRO)]
L2_POLICY = [
    (LOAD_SCORES, KEEP_LOADS),
    ("    unpack4(*reinterpret_cast<const float4*>(v + i), m);",
     "    unpack4(__ldcs(reinterpret_cast<const float4*>(v + i)), m);"),
    ("      unpack4(*reinterpret_cast<const float4*>(e + i), ev);",
     "      unpack4(__ldcs(reinterpret_cast<const float4*>(e + i)), ev);"),
    ("    if (RANDK) unpack4(*reinterpret_cast<const float4*>(u + i), sc);",
     "    if (RANDK) unpack4(__ldcs(reinterpret_cast<const float4*>(u + i)), "
     "sc);")]
CUT_SCAN = [("  return cudaLaunchKernelEx(&cfg, kernel, args...);",
             "  return cudaSuccess;")]
CUT_COUNT = [(_COUNT, "    if (0) count_kernel<R, E><<<grid, kThreads, 0, "
                      "s>>>(")]

# name -> its edits; a name with "groups of N MB" runs the built source
# once per group of senders whose scores take at most N MB
VARIANTS = {
    "as built": [],
    "128 threads": _consts(threads=128, sub=8),
    "256 threads": _consts(threads=256, sub=4),
    "tile 2048": _consts(sub=1),
    "tile 8192": _consts(sub=4),
    "forward scan": FORWARD,
    "plain stores": PLAIN_STORES,
    "__stwb stores": STWB,
    "no dependent launch": NO_PDL,
    "one persistent launch": PERSISTENT,
    "cluster of 16 per (leaf, sender)": CLUSTER_EDITS,
    "L2 evict_last count, evict_first scan": L2_POLICY,
    "L2 policy + tile 8192": L2_POLICY + _consts(sub=4),
    "L2 policy + 128 threads": L2_POLICY + _consts(threads=128, sub=8),
    "cut: count only": CUT_SCAN,
    "cut: scan only": CUT_COUNT,
}
GROUPS = {"groups of 16 MB": 16 << 20}
OPS = ("topk", "randk", "ef_topk", "ef_randk")


def build_variants(variants):
    """{name: ctypes library} of every variant that compiles."""
    from repro_torch.kernels import build as B

    src = B.KERNEL_SOURCES["select_hopper"].read_text()
    out = B.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} not in source")
            text = text.replace(old, new)
        cu = out / f"select{i}.cu"
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
                for ln in log.splitlines() if "registers" in ln]
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        print(f"{name}: registers {regs}, {spills or 'no spills'}",
              flush=True)
        lib = ctypes.CDLL(str(so))
        p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.select_tiled.argtypes = [i] + [p] * 11 + [i, i] + [n] * 6 + [i, p]
        lib.select_tiled.restype = ctypes.c_int
        libs[name] = lib
    return libs


def runner(lib, op, delta, ef, u, segs, given, cache, group_bytes=None):
    """(fn, outputs) of ``op`` on the variant library ``lib``: one call
    over all senders, or with ``group_bytes`` one call per group of
    senders whose score operands take at most that many bytes."""
    import torch

    from repro_torch.kernels import compress as K
    from repro_torch.kernels.interface import vec_aligned

    tile = lib.select_tile_values()
    starts = [0]
    for n in segs.lengths:
        starts.append(starts[-1] + -(-n // tile))
    b = delta.shape[0]
    tile0 = torch.tensor(starts, dtype=torch.int32, device=delta.device)
    counts = torch.zeros((b, starts[-1]), dtype=torch.int32,
                         device=delta.device)
    cache.append((tile0, counts))
    e = ef if op.startswith("ef_") else None
    uu = u if op.endswith("randk") else None
    dq = torch.empty_like(delta)
    ranks = torch.empty(delta.shape, dtype=torch.int32, device=delta.device)
    ef_new = None if e is None else torch.empty_like(delta)
    scale = K.unbiased_scales(segs, delta.device) if op == "randk" else None
    vec = int(vec_aligned(*[t for t in (delta, e, uu, dq, ranks, ef_new)
                            if t is not None]))
    group = b
    if group_bytes:
        per = 4 * delta.shape[1] * (2 if op == "ef_topk" else 1)
        group = min(b, max(1, group_bytes // per))
        n = -(-b // group)
        group = -(-b // n)
    calls = []
    for b0 in range(0, b, group):
        rows = slice(b0, min(b, b0 + group))
        ptr = (lambda t: None if t is None else t[rows].data_ptr())
        calls.append((int(uu is not None), ptr(delta), ptr(e), ptr(uu),
                      ptr(dq), ptr(ranks), ptr(ef_new),
                      segs.table(delta.device).data_ptr(), tile0.data_ptr(),
                      ptr(given), None if scale is None else scale.data_ptr(),
                      ptr(counts), len(segs.lengths), starts[-1],
                      delta.shape[1], rows.stop - b0, delta.stride(0),
                      0 if e is None else e.stride(0),
                      0 if uu is None else uu.stride(0), dq.stride(0), vec,
                      torch.cuda.current_stream().cuda_stream))

    def fn():
        for args in calls:
            err = lib.select_tiled(*args)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
    return fn, tuple(t for t in (dq, ranks, ef_new) if t is not None)


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.configs.paper_cnn import CONFIG as CNN
    from repro_torch.flat import Layout
    from repro_torch.models.paper_models import init_params

    if not torch.cuda.is_available():
        print("select_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    layout = Layout.of(init_params(CNN, torch.Generator().manual_seed(0)))
    libs = build_variants(VARIANTS)
    cases = []
    for label, senders in (("LAN", 40), ("WAN", 4)):
        delta, ef, u = cs.compress_inputs(layout, senders, seed=3)
        for op in OPS:
            segs = cs.op_segments(op, layout)
            given = cs.side_op(op, delta, ef, u, segs)[1]()
            want = cs.run_compress(op, delta, ef, u, segs, given,
                                   mode="torch")
            bound = cs.compress_bytes(op, senders, layout, segs) \
                / cs.HBM_BYTES_PER_S * 1e3
            cases.append((label, op, delta, ef, u, segs, given, want, bound))
    failed = False
    keep = []
    names = list(libs) + [g for g in GROUPS if "as built" in libs]
    for rnd, order in enumerate((names, names[::-1])):
        for label, op, delta, ef, u, segs, given, want, bound in cases:
            times, equals = {}, {}
            for name in order:
                fn, got = runner(libs.get(name, libs["as built"]), op, delta,
                                 ef, u, segs, given, keep, GROUPS.get(name))
                try:
                    fn()
                except RuntimeError as e:     # a launch the card refused
                    print(f"[{rnd}] {label} {op:8s} {name:40s} {e}",
                          flush=True)
                    continue
                torch.cuda.synchronize()
                equals[name] = all(torch.equal(g, w)
                                   for g, w in zip(got, want))
                if not name.startswith("cut"):
                    failed |= not equals[name]
                times[name] = cs.cuda_time_ms(fn, 50)
                keep.clear()
            for name in (n for n in names if n in times):
                ms = times[name]
                print(f"[{rnd}] {label} {op:8s} {name:40s} {ms * 1e3:7.1f} "
                      f"us ({bound / ms:.1%} of the {bound * 1e3:.1f} us "
                      f"bound, {times['as built'] / ms:.2f}x as built)"
                      + ("" if name.startswith("cut") else
                         f", bit-equal: {equals[name]}"), flush=True)
    if failed:
        print("select_variants: a variant disagrees with the plain version",
              file=sys.stderr)
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
