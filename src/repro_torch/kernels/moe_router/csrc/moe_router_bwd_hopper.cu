// The MoE router's whole backward for Hopper, sm_90a, in one kernel: the
// gradient dl of the router's float32 logits, dx = dl w^T and dw = f32(x)^T
// dl, for bf16 tokens x (t, d) and the float32 router weight w (d, E).
//
// Replaces no Pallas kernel: the reference trains through jax.grad of its
// XLA route_ref (repro/kernels/moe_router/ref.py:16) and of the router
// product f32(xp) @ w around it (repro/models/moe.py:73-74). Per token row,
// with l its float32 logits, p = softmax(l), g_j = p[idx_j], s = sum_j g_j:
//
//     dg_j  = (dG_j - sum_i dG_i gates_i) / max(s, 1e-20)   (renormalised;
//                                                              else dG_j)
//     dp[e] = sum_j [idx_j = e] dg_j + dM[e] / t
//     dl    = p * (dp - sum_e p_e dp_e)
//     dx    = bf16(dl . w^T)        dw = f32(x)^T . dl   (float32)
//
// (csrc/moe_router_bwd.cu computes dl alone, for route_topk's backward and
// float32 x.) Either product is left out when its output pointer is null.
//
// What bounds it: bytes. deepseek's training shape (t 4,096, d 2,048, E 64,
// k 6) reads x (16.78 MB bf16), the logits (1.05 MB), w (0.52 MB) and the
// ids, gates and dG (0.3 MB), and writes dx (16.78 MB) and dw (0.52 MB):
// ~35.9 MB, 10.7 us at 3.35 TB/s; six bf16 tensor-core products (three for
// each output) are 6.4 GFLOP, 6.5 us at 989 TFLOP/s. The chain it replaces
// (dl to HBM, two f32 SGEMMs, f32 copies of x and dx) moves ~170 MB.
//
// The design:
//  * Two phases in one cooperative launch (every CTA resident; a grid
//    barrier between them). Phase 1: each CTA computes dl for its share of
//    the token rows, L lanes a row (8 experts a lane; max, sums and the dot
//    product by xor butterflies; a row's dG scattered by expert through
//    shared memory), and writes it as three bf16 pieces (dl = l1 + l2 +
//    l3, each rounded to nearest: 3 x 8 bits, f32's 24) to a scratch of
//    3 x 64 bf16 a row (1.5 MB at deepseek, read back from L2). Phase 2:
//    CTAs take (slice of 128 values of d, range of token stages) items, as
//    many as the grid holds at once, and stream. A first form recomputed dl
//    in every slice, as the design asked (no dl outside shared memory):
//    16x the work at deepseek, 64x at Jamba, and dl then set the pace at
//    7,100-15,700 cycles a stage against the products' 2,700
//    (scripts/router_bwd_variants.py --trace, PERF.md).
//  * Phase 2 is warp-specialised, 384 threads: two math warpgroups, one a
//    64-wide box of d, run a stage's products and drain the sums (dx as
//    bf16 into a staging tile, dw into a running sum); one producer thread
//    keeps a ring of three stages in flight by TMA (64 tokens: x's two
//    64 x 64 boxes, 16 KB, and dl's three pieces, 24 KB; zeros past t and
//    d) and stores each stage's staged dx by TMA. mbarriers: "full" (a
//    stage in), "done" (its products and drain over: its slot free, its
//    dx staged), "stored" (a staging tile read out). Every tile is 64 x 64
//    bf16 with the 128-byte swizzle: dl's pieces serve both products, as
//    dx's A (tokens x experts, K-major) and as dw's B (N-major).
//  * dx on wgmma m64n64k16: A = dl's pieces, B = the slice's rows of w,
//    split into three bf16 pieces once an item (K = E: 16, 32 or 64
//    columns, zero past E). Six products, every term down to 2^-16 of a
//    term: l3.w1, l2.w2, l1.w3, l2.w1, l1.w2, l1.w1 (small terms first).
//    The three largest alone leave terms of 2^-16 of |dl_e w_e|, which read
//    ~1.2e-5 of the largest |dx| at deepseek's scale (dl peaked on a row's
//    chosen experts), as large as the tolerance's absolute part; six leave
//    2^-24, f32's product before the rounding to bf16 (ref.full_bwd_pieces
//    emulates the arithmetic; tests/test_torch_router_bwd.py holds it to
//    2^-20 of sum_e |dl_e w_e|).
//  * dw on wgmma m64n64k16: A = x's own stage tile read M-major (the
//    transpose bit: x is never transposed in memory), B = dl's pieces
//    (K = tokens). A bf16 x is exact, so x.l3 + x.l2 + x.l1 is f32's
//    product. K = t is long: each stage's accumulators (64 tokens) are added
//    to an f32 running sum on the CUDA cores, rounded to nearest (the
//    tensor cores' own sums truncate; over a whole d the forward's drifted
//    to 5x cuBLAS's error, moe_router_hopper.cu).
//  * No float atomics: each item writes its partial dw (128 x 64 f32) to a
//    scratch; after a second grid barrier each CTA sums a share of dw's
//    rows over the ranges in range order; two launches are bit-equal. (A
//    first form let the last item of a slice, by an exit ticket, sum the
//    slice's: up to 7.7 us for the last one.) The grid barrier's count
//    returns to 0, so the scratch (the wrapper's, per stream, made before
//    any CUDA-graph capture) needs no reset. The kernel runs on the
//    caller's stream and allocates nothing.
// Items: slices x ranges, ranges chosen by the wrapper (ops.plan_bwd) for
// about one an SM: deepseek 16 x 8, Jamba (d 8,192, E 16) 64 x 2.

#include "../../flash_attention/csrc/hopper.cuh"  // mbarriers, TMA,
                                                   // descriptors, tensor maps

namespace {

constexpr int kThreads = 384;      // two math warpgroups and a producer
constexpr int kMathThreads = 256;
constexpr int kSlice = 128;        // values of d an item
constexpr int kBM = 64;            // token rows a stage
constexpr int kStages = 3;         // the ring
constexpr int kMaxExperts = 64;
constexpr int kMaxK = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSpins = 1 << 26;  // ~2 s at the grid barrier: a fault
// dx's products (piece of dl, piece of w), small terms first: all six
// terms down to 2^-16 (f32's product), or the last three
constexpr int kDxProducts = 6;
constexpr int kWPieces = kDxProducts == 6 ? 3 : 2;
// product m's pieces: l3.w1, l2.w2, l1.w3, l2.w1, l1.w2, l1.w1
__device__ __forceinline__ constexpr int dx_a(int m) {
  return m == 0 ? 2 : (m == 1 || m == 3) ? 1 : 0;
}
__device__ __forceinline__ constexpr int dx_b(int m) {
  return m == 2 ? 2 : (m == 1 || m == 4) ? 1 : 0;
}

// Shared memory from a 1024-byte aligned base, in 64 x 64 bf16 tiles (128
// bytes a row, 128-byte swizzle): the ring (a stage: x's two boxes, dl's
// three pieces), w's pieces for the two boxes, two staging tiles of dx a
// box; then dM / t and the mbarriers. Phase 1 scatters a row's dG by expert
// (64 floats a row, kPassRows rows a pass) over the staging tiles.
constexpr int kTile = 64 * 128;
constexpr int kSlot = 5 * kTile;   // x box 0, x box 1, l1, l2, l3
constexpr int kRingOff = 0;
constexpr int kWOff = kRingOff + kStages * kSlot;
constexpr int kStOff = kWOff + kWPieces * 2 * kTile;
constexpr int kDmOff = kStOff + 2 * 2 * kTile;
constexpr int kBarOff = kDmOff + 64 * 4;  // full, done [kStages], stored[2]
constexpr int kSmem = kBarOff + (2 * kStages + 2) * 8 + 1024;  // to align
constexpr int kPassRows = 128;     // phase 1's rows a pass, at most
static_assert(kPassRows * 64 * 4 <= 2 * 2 * kTile, "phase 1's slots");

// Byte offset of row r's 16-byte chunk c in a 128-byte swizzled tile (the
// TMA's SWIZZLE_128B from a 1024-byte aligned tile).
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// wgmma descriptors of a 128-byte swizzled tile: K-major (lbo unused) or
// MN-major of one 64-wide box; sbo 1024 (8 rows of 128 bytes).
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return smem_desc(addr, kTile, 1024);
}

// D (64 x 64, f32) (+)= A . B, bf16 A and B in shared memory; TA / TB the
// transpose bits (1: MN-major); acc = 0 overwrites D.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// The float values of a packed pair of bf16.
__device__ __forceinline__ float bf_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// Eight values into P packed bf16 pieces a pair (v = p1 + p2 + ..., each
// rounded to nearest), 16 bytes a piece.
template <int P>
__device__ __forceinline__ void split8(const float (&v)[8], uint4 (&out)[P]) {
  uint32_t q[P][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float a = v[2 * j], b = v[2 * j + 1];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      q[i][j] = pack_bf16(a, b);
      a -= bf_lo(q[i][j]);
      b -= bf_hi(q[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) out[i] = make_uint4(q[i][0], q[i][1], q[i][2],
                                                  q[i][3]);
}

// Sum, max and or over the L lanes of a row (L a power of 2 up to 8).
__device__ __forceinline__ float row_sum(float v, int L) {
  for (int o = 1; o < L; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v, int L) {
  for (int o = 1; o < L; o <<= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ unsigned long long row_or(unsigned long long v,
                                                     int L) {
  for (int o = 1; o < L; o <<= 1) v |= __shfl_xor_sync(kFull, v, o);
  return v;
}

struct Args {
  const float* w;              // (d, e)
  const float* logits;         // (t, e)
  const int32_t* idx;          // (t, k)
  const float* gates;          // (t, k)
  const float* dgates;         // (t, k)
  const float* dmean;          // (e,)
  bool dx;                     // dx asked for (its tensor map's)
  float* dw;                   // (d, e) or null
  float* part;                 // (ranges, slices * 128, 64) partial dw
  __nv_bfloat16* dlp;          // (3, stages * 64, 64): dl's pieces
  unsigned* counters;          // the grid barrier's count, generation
  int t, d, e, k, renorm, slices, ranges, spr;  // spr: stages a range
};

// Phase 1, by the math warpgroups: dl of token rows [r0, r1) (rows at or
// past t give zeros) into the scratch's three pieces. L = 1 << lg lanes a
// row (the fewest that hold E at 8 experts a lane), lane l of a row
// holding experts 8l .. 8l + 7, up to kPassRows rows a pass (a warp's rows
// all in the pass or all past it; all below r1 or all at or past it). Every
// load of a pass is issued before its first use (the logits, and a lane's
// first two choices l, l + L). A row's choices go through its 64 floats
// at `slots`: each lane scatters its choices' dG by expert (a row's k ids
// are distinct, the forward's top-k), so a lane then reads its experts'
// dG and the chosen set. dmt: dM[e] / t. Divisions by a row's sums are
// products with their reciprocals (the plain version divides: one rounding
// apart).
__device__ __forceinline__ void rows_dl(const Args& a, int64_t r0,
                                        int64_t r1, float* slots,
                                        const float* dmt, int lg,
                                        int64_t rows_all) {
  const int L = 1 << lg, lane = threadIdx.x & 31, l = lane & (L - 1);
  const int e0 = 8 * l, rr = threadIdx.x >> lg;
  const int pass = min(kMathThreads >> lg, kPassRows);
  if (rr >= pass) return;  // whole warps
  for (int64_t base = r0; base < r1; base += pass) {
    const int64_t row = base + rr, o = row * a.k;
    const bool live = row < a.t && row < r1;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.0f;
    int id[2] = {-1, -1};
    float gd[2] = {0.0f, 0.0f}, gt[2] = {0.0f, 0.0f};
    if (live) {
      const float* lr = a.logits + row * a.e + e0;
      if (e0 < a.e) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(lr));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      }
      if (e0 + 4 < a.e) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(lr + 4));
        v[4] = q.x; v[5] = q.y; v[6] = q.z; v[7] = q.w;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (l + u * L < a.k) {
          id[u] = __ldg(a.idx + o + l + u * L);
          gd[u] = __ldg(a.dgates + o + l + u * L);
          gt[u] = __ldg(a.gates + o + l + u * L);
        }
    }
    float* slot = slots + rr * 64;
    *reinterpret_cast<float4*>(slot + e0) = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(slot + e0 + 4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
    float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (e0 + i < a.e) mx = fmaxf(mx, v[i]);
    mx = row_max(mx, L);
    float p[8], sum = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      p[i] = e0 + i < a.e ? expf(v[i] - mx) : 0.0f;
      sum += p[i];
    }
    const float inv = __frcp_rn(row_sum(sum, L));
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] *= inv;
    __syncwarp();  // the slots zeroed
    unsigned long long mask = 0ull;
    float c = 0.0f;
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (id[u] >= 0) {
        slot[id[u]] = gd[u];
        mask |= 1ull << id[u];
        c += gd[u] * gt[u];
      }
    if (live)  // the rest, past two a lane
      for (int j = l + 2 * L; j < a.k; j += L) {
        const int idj = __ldg(a.idx + o + j);
        const float gdj = __ldg(a.dgates + o + j);
        slot[idj] = gdj;
        mask |= 1ull << idj;
        c += gdj * __ldg(a.gates + o + j);
      }
    __syncwarp();  // the row's dG scattered
    mask = row_or(mask, L) >> e0;
    const float4 g0 = *reinterpret_cast<const float4*>(slot + e0);
    const float4 g1 = *reinterpret_cast<const float4*>(slot + e0 + 4);
    const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    float dg[8], s = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      dg[i] = gv[i];
      s += (mask >> i) & 1ull ? p[i] : 0.0f;
    }
    if (a.renorm) {
      c = row_sum(c, L);
      const float inv_s = __frcp_rn(fmaxf(row_sum(s, L), 1e-20f));
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dg[i] = (mask >> i) & 1ull ? (gv[i] - c) * inv_s : 0.0f;
    }
    float dp[8], dot = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      dp[i] = dg[i] + dmt[e0 + i];
      dot += p[i] * dp[i];
    }
    dot = row_sum(dot, L);
    float dl[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dl[i] = (live && e0 + i < a.e) ? p[i] * (dp[i] - dot) : 0.0f;
    uint4 pc[3];
    split8<3>(dl, pc);
    if (row < r1 && row < rows_all)
#pragma unroll
      for (int i = 0; i < 3; ++i)
        *reinterpret_cast<uint4*>(a.dlp + (i * rows_all + row) * 64 + e0) =
            pc[i];
    __syncwarp();  // the slots read before the next pass zeroes them
  }
}

// Every CTA's threads arrive; none leaves before all have (the launch is
// cooperative: all are resident). The last arrival sets the count back to
// 0 and advances the generation the others wait on.
__device__ __forceinline__ void grid_barrier(unsigned* counters) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = counters + 1;
    const unsigned g0 = *gen;
    __threadfence();
    if (atomicAdd(counters, 1u) == gridDim.x - 1) {
      counters[0] = 0u;
      __threadfence();
      atomicAdd(counters + 1, 1u);
    } else {
      for (int spins = 0; *gen == g0; ++spins) {
        __nanosleep(32);
        if (spins > kMaxSpins) __trap();  // a fault, never a hang
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// Adds `bytes` to the transactions the current phase of `bar` waits for,
// without an arrival.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// KS: dx's k16 steps, 16 KS >= E (dl's and w's columns past E are zeros).
// Tensor maps (hopper.cuh's make_map, boxes of 64 x 64): tm_x and tm_dx
// (d, 1, t, 1), tm_dl (64, 1, stages * 64, 3).
template <bool DX, bool DW, int KS>
__global__ void __launch_bounds__(kThreads, 1)
    router_bwd_fused(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_dl,
                     const __grid_constant__ CUtensorMap tm_dx,
                     const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) &
                                    1023u);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;  // 0, 1: the math warpgroup of box wg; 2
  const int nstages = (a.t + kBM - 1) / kBM;
  const int64_t rows_all = int64_t(nstages) * kBM;
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar = sbase + kBarOff;
  auto full = [&](int s) { return bar + 8 * (s % kStages); };
  auto done = [&](int s) { return bar + 8 * (kStages + s % kStages); };
  auto stored = [&](int s) { return bar + 8 * (2 * kStages + (s & 1)); };
  auto slot_of = [&](int s) { return sbase + kRingOff + (s % kStages) * kSlot; };
  auto staging = [&](int s) { return kStOff + (s & 1) * 2 * kTile; };

  // ---- phase 1: this CTA's rows of dl into the scratch ----
  float* dmt = reinterpret_cast<float*>(smem + kDmOff);
  if (tid < 64)
    dmt[tid] = tid < a.e ? __fdiv_rn(__ldg(a.dmean + tid),
                                     static_cast<float>(a.t))
                         : 0.0f;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full(i), 1);
      mbar_init(done(i), kMathThreads);
    }
    for (int i = 0; i < 2; ++i) mbar_init(stored(i), 1);
  }
  __syncthreads();
  // An item's slice of w into bf16 pieces, K-major (experts along the row,
  // zeros past d and e): tile (piece, box) at kWOff, by the producer
  // warpgroup (the first item's under phase 1), 8 chunks of 8 experts a
  // thread, every load in flight before the split.
  constexpr int kProd = kThreads - kMathThreads;
  constexpr int kWPer = kSlice * 8 / kProd;
  float4 wq[kWPer][2];
  auto fetch_w = [&](int d0) {
#pragma unroll
    for (int u = 0; u < kWPer; ++u) {
      const int i = tid - kMathThreads + u * kProd, r = i >> 3, c = i & 7;
      const float* wr = a.w + int64_t(d0 + r) * a.e + 8 * c;
      wq[u][0] = wq[u][1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (d0 + r < a.d && 8 * c < a.e)
        wq[u][0] = __ldg(reinterpret_cast<const float4*>(wr));
      if (d0 + r < a.d && 8 * c + 4 < a.e)
        wq[u][1] = __ldg(reinterpret_cast<const float4*>(wr + 4));
    }
  };
  auto store_w = [&]() {
#pragma unroll
    for (int u = 0; u < kWPer; ++u) {
      const int i = tid - kMathThreads + u * kProd, r = i >> 3, c = i & 7;
      const float v[8] = {wq[u][0].x, wq[u][0].y, wq[u][0].z, wq[u][0].w,
                          wq[u][1].x, wq[u][1].y, wq[u][1].z, wq[u][1].w};
      uint4 pc[kWPieces];
      split8<kWPieces>(v, pc);
      const int box = r >> 6, off = swz(r & 63, c);
#pragma unroll
      for (int pi = 0; pi < kWPieces; ++pi)
        *reinterpret_cast<uint4*>(smem + kWOff + (2 * pi + box) * kTile +
                                  off) = pc[pi];
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  // stage c of an item at (d0, first): x's boxes (transactions expected,
  // no arrival: x does not wait for phase 1), then dl's pieces (the
  // arrival); both land on the stage's full barrier
  auto load_x = [&](int s, int d0, int row) {
    const uint32_t sl = slot_of(s), fb = full(s);
    mbar_expect(fb, 2 * kTile);
    tma_load(sl, &tm_x, fb, d0, 0, row, 0);
    tma_load(sl + kTile, &tm_x, fb, d0 + 64, 0, row, 0);
  };
  auto load_dl = [&](int s, int row) {
    const uint32_t sl = slot_of(s), fb = full(s);
    mbar_expect_tx(fb, 3 * kTile);
#pragma unroll
    for (int pc = 0; pc < 3; ++pc)
      tma_load(sl + (2 + pc) * kTile, &tm_dl, fb, 0, 0, row, pc);
  };
  // the first item's w and x go in under phase 1
  const int items = a.slices * a.ranges;
  auto item_at = [&](int item, int& d0, int& first, int& mine) {
    d0 = (item % a.slices) * kSlice;
    first = (item / a.slices) * a.spr;
    mine = max(0, min(a.spr, nstages - first));
  };
  int d0, first, mine;
  item_at(blockIdx.x, d0, first, mine);  // the grid holds no more than items
  if (wg == 2) {
    if (tid == kMathThreads)
      for (int c = 0; c < kStages && c < mine; ++c)
        load_x(c, d0, (first + c) * kBM);
    if constexpr (DX) {
      fetch_w(d0);
      store_w();
    }
  } else {
    const int64_t per = (rows_all + gridDim.x - 1) / gridDim.x;
    const int64_t r0 = min(rows_all, int64_t(blockIdx.x) * per);
    const int lg = a.e > 32 ? 3 : a.e > 16 ? 2 : a.e > 8 ? 1 : 0;
    rows_dl(a, r0, min(rows_all, r0 + per),
            reinterpret_cast<float*>(smem + kStOff), dmt, lg, rows_all);
  }
  grid_barrier(a.counters);

  // ---- phase 2: items (slice, range) ----
  int gs = 0;  // this CTA's stages so far: the ring's slots and phases
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int range = item / a.slices;
    item_at(item, d0, first, mine);
    const bool pre = item == int(blockIdx.x);  // w and x loaded in phase 1
    if (!pre) {
      __syncthreads();  // the last item's products over
      if (DX && wg == 2) {
        fetch_w(d0);
        store_w();
      }
      __syncthreads();  // w's pieces in
    }

    if (wg == 2) {
      // ---- producer thread: the ring's loads and dx's stores by TMA ----
      if (tid == kMathThreads) {
        auto load = [&](int c) {  // stage c of the item
          load_x(gs + c, d0, (first + c) * kBM);
          load_dl(gs + c, (first + c) * kBM);
        };
        for (int c = 0; c < kStages && c < mine; ++c) {
          if (pre)
            load_dl(gs + c, (first + c) * kBM);
          else
            load(c);
        }
        for (int c = 0; c < mine; ++c) {
          mbar_wait(done(gs + c), ((gs + c) / kStages) & 1);
          if (c + kStages < mine) load(c + kStages);  // into stage c's slot
          if constexpr (DX) {  // then its dx out; the last stage's read out
            const uint32_t st = sbase + staging(gs + c);
            const int row = (first + c) * kBM;
            tma_store(&tm_dx, st, d0, 0, row, 0);
            tma_store(&tm_dx, st + kTile, d0 + 64, 0, row, 0);
            asm volatile("cp.async.bulk.commit_group;" ::: "memory");
            if (c > 0) {
              asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
              mbar_arrive(stored(gs + c - 1));
            }
          }
        }
        if (DX && mine > 0) {
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
          mbar_arrive(stored(gs + mine - 1));
          asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
        }
      }
    } else {
      // ---- math warpgroup wg: box wg's products and sums ----
      const int w4 = warp & 3, g = lane >> 2, q = lane & 3;
      float acc_dx[32], acc_dw[32];  // a stage's sums, written by its products
      float run[32];                 // dw's running sum over the stages
#pragma unroll
      for (int i = 0; i < 32; ++i) run[i] = 0.0f;
      for (int c = 0; c < mine; ++c) {
        const int sg = gs + c;
        mbar_wait(full(sg), (sg / kStages) & 1);
        const uint32_t sl = slot_of(sg), dl = sl + 2 * kTile;
        wgmma_fence();
        if constexpr (DX) {
          uint32_t wt;  // w's tiles (a register move: not hoisted)
          asm volatile("mov.b32 %0, %1;" : "=r"(wt)
                       : "r"(sbase + kWOff + wg * kTile));
#pragma unroll
          for (int m = 6 - kDxProducts; m < 6; ++m)
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
              wgmma_n64<0, 0>(acc_dx, desc_k(dl + dx_a(m) * kTile + ks * 32),
                              desc_k(wt + 2 * dx_b(m) * kTile + ks * 32),
                              m + ks > 6 - kDxProducts);
        }
        if constexpr (DW) {
          const uint32_t xt = sl + wg * kTile;
          // x.l3, x.l2, x.l1
#pragma unroll
          for (int m = 0; m < 3; ++m)
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma_n64<1, 1>(acc_dw, desc_mn(xt + ks * 2048),
                              desc_mn(dl + (2 - m) * kTile + ks * 2048),
                              m + ks > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_dx);
        fence_regs(acc_dw);
        if constexpr (DX) {  // dx as bf16 pairs into the staging tile
          if (sg >= 2) mbar_wait(stored(sg), ((sg >> 1) - 1) & 1);
          unsigned char* st = smem + staging(sg) + wg * kTile;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = w4 * 16 + g + 8 * h;
              *reinterpret_cast<uint32_t*>(st + swz(r, j) + 4 * q) =
                  pack_bf16(acc_dx[4 * j + 2 * h], acc_dx[4 * j + 2 * h + 1]);
            }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        if constexpr (DW) {
#pragma unroll
          for (int i = 0; i < 32; ++i) run[i] += acc_dw[i];
        }
        mbar_arrive(done(sg));
      }
      if constexpr (DW) {  // the item's partial dw: row m of the box (d),
                           // expert n
        float* part = a.part + (int64_t(range) * a.slices * kSlice + d0 +
                                64 * wg) * 64;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(part + (w4 * 16 + g + 8 * h) * 64 +
                                       8 * j + 2 * q) =
                make_float2(run[4 * j + 2 * h], run[4 * j + 2 * h + 1]);
      }
    }
    gs += mine;
  }

  // ---- dw: every item's partial in (a grid barrier), each CTA sums its
  // share of dw's rows over the ranges, in range order ----
  if constexpr (DW) {
    grid_barrier(a.counters);
    const int64_t per = (int64_t(a.d) + gridDim.x - 1) / gridDim.x;
    const int64_t r0 = int64_t(blockIdx.x) * per;
    const int64_t r1 = min(int64_t(a.d), r0 + per);
    const int q4 = a.e / 4;  // float4s a row
    const int64_t step = int64_t(a.slices) * kSlice * 64;
    for (int64_t i = r0 * q4 + tid; i < r1 * q4; i += kThreads) {
      const int64_t r = i / q4;
      const int c4 = 4 * static_cast<int>(i - r * q4);
      const float* src = a.part + r * 64 + c4;  // (range 0, slice, row)
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int rg0 = 0; rg0 < a.ranges; rg0 += 8) {
        float4 v[8];  // the ranges' loads in flight before their sum
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (rg0 + u < a.ranges)
            v[u] = __ldcg(reinterpret_cast<const float4*>(src + (rg0 + u) *
                                                          step));
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (rg0 + u < a.ranges) {
            sum.x += v[u].x;
            sum.y += v[u].y;
            sum.z += v[u].z;
            sum.w += v[u].w;
          }
      }
      *reinterpret_cast<float4*>(a.dw + r * a.e + c4) = sum;
    }
  }
}

template <bool DX, bool DW, int KS>
int launch(const CUtensorMap& tx, const CUtensorMap& tl, const CUtensorMap& td,
           const Args& a, cudaStream_t s) {
  auto kernel = router_bwd_fused<DX, DW, KS>;
  static int resident = 0;  // per instantiation: CTAs the card holds at once
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident = sms * per_sm;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  const int items = a.slices * a.ranges;
  cfg.gridDim = dim3(items < resident ? items : resident);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, tx, tl, td, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int KS>
int launch_mode(const CUtensorMap& tx, const CUtensorMap& tl,
                const CUtensorMap& td, const Args& a, cudaStream_t s) {
  if (a.dx && a.dw != nullptr) return launch<true, true, KS>(tx, tl, td, a, s);
  if (a.dx) return launch<true, false, KS>(tx, tl, td, a, s);
  return launch<false, true, KS>(tx, tl, td, a, s);
}

}  // namespace

// x (t, d) bf16 with row stride ldx (elements), unit stride along d,
// 16-byte aligned rows; w (d, e), logits (t, e), gates and dgates (t, k)
// float32, idx (t, k) int32, dmean (e,) float32, all contiguous, w and the
// logits 16-byte aligned; dx (t, d) bf16 contiguous and 16-byte aligned, or
// null (not computed); dw (d, e) float32 contiguous, 16-byte aligned, or
// null; at least one of the two. 1 <= k <= e <= 64, e % 4 == 0, d % 8 == 0.
// Items: ceil(d / 128) slices x `ranges` ranges of `spr` stages of 64
// tokens (ranges * spr >= ceil(t / 64) > (ranges - 1) * spr). Scratch: part
// (ranges, slices * 128, 64) float32; dlp (3, ceil(t / 64) * 64, 64) bf16,
// 16-byte aligned; counters (2,) uint32, zeroed once, then only written
// here. No other launch may use them until this one ends. Returns
// cudaGetLastError() after the launch (0 on success), or hopper.cuh's
// kErrNoEncode / kErrEncode + CUresult when a tensor map cannot be made.
extern "C" int moe_router_bwd_fused(const void* x, int64_t ldx, const float* w,
                                    const float* logits, const int32_t* idx,
                                    const float* gates, const float* dgates,
                                    const float* dmean, void* dx, float* dw,
                                    float* part, void* dlp,
                                    unsigned* counters, int t, int d, int e,
                                    int k, int renorm, int ranges, int spr,
                                    void* stream) {
  const int nstages = (t + kBM - 1) / kBM;
  if (t < 1 || e < 4 || e > kMaxExperts || e % 4 || k < 1 || k > e ||
      k > kMaxK || d < 8 || d % 8 || ldx < d || ldx % 8 || ranges < 1 ||
      spr < 1 || int64_t(ranges) * spr < nstages ||
      int64_t(ranges - 1) * spr >= nstages || (dx == nullptr && dw == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tl, td;
  const int64_t rows_all = int64_t(nstages) * kBM;
  int err = make_map(&tx, x, d, 1, t, 1, 0, ldx, 0, kBM);
  if (err == 0)
    err = make_map(&tl, dlp, 64, 1, static_cast<int>(rows_all), 3, 0, 64,
                   rows_all * 64, kBM);
  if (err == 0) err = make_map(&td, dx != nullptr ? dx : x, d, 1, t, 1, 0,
                               dx != nullptr ? d : ldx, 0, kBM);
  if (err != 0) return err;
  Args a;
  a.w = w;
  a.logits = logits;
  a.idx = idx;
  a.gates = gates;
  a.dgates = dgates;
  a.dmean = dmean;
  a.dx = dx != nullptr;
  a.dw = dw;
  a.part = part;
  a.dlp = static_cast<__nv_bfloat16*>(dlp);
  a.counters = counters;
  a.t = t;
  a.d = d;
  a.e = e;
  a.k = k;
  a.renorm = renorm;
  a.slices = (d + kSlice - 1) / kSlice;
  a.ranges = ranges;
  a.spr = spr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e <= 16) return launch_mode<1>(tx, tl, td, a, s);
  if (e <= 32) return launch_mode<2>(tx, tl, td, a, s);
  return launch_mode<4>(tx, tl, td, a, s);
}
