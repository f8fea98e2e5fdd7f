// Fused MoE routing for Hopper, sm_90a: the router product, softmax over
// experts, top-k, renormalised gates, each choice's position in its
// expert's capacity buffer, and the load statistics, in one launch.
//
// Replaces, in one kernel, the Pallas TPU kernel
// repro/kernels/moe_router/moe_router.py::_router_kernel together with the
// XLA ops the reference runs around it (repro/models/moe.py:73-92): the
// f32 router product, and the cumsum over the (groups, group * k, E)
// one-hot selection that gives each choice its place in capacity.
//
//     logits  = f32(x) @ w                          x (t, d) bf16 or f32,
//                                                   w (d, E) f32, E <= 64
//     p       = softmax(logits)                     per token row
//     k times: g = max(work); a = argmax(work) (lowest index on ties);
//              work[a] = -1e30; gates[j] = g; idx[j] = a; gsum += g
//     renormalise: gates[j] = gates[j] / max(gsum, 1e-20)
//     pos[t][j] = number of earlier tokens of t's group (group rows
//                 [G * group, (G + 1) * group)) that chose idx[t][j]
//     aux     = (sum of p / t, count of selections / (t * k)) per expert
//
// pos is the reference's pos_in_expert = cumsum(sel) - sel at the chosen
// expert, before capacity: a token's k choices are distinct experts, so an
// earlier choice of the same token never shares an expert.
//
// What bounds it: bytes. deepseek's prefill (4096 x 2048 bf16 x, E 64,
// k 6) reads 16.8 MB of x and 0.5 MB of w; the f32 product is 1.07 GFLOP,
// 16 us on CUDA cores, 4.3 us as two TF32 products on the tensor cores and
// 3.3 us as the three bf16 products below, under the 5.2 us of the bytes.
// The design:
//  * The product on the tensor cores at f32 accuracy: wgmma m64n64k16 in
//    bf16. A bf16 x is exact in bf16, and w is split as it is read into
//    three bf16 pieces (w = w1 + w2 + w3, 3 x 8 bits of mantissa: f32's
//    24), so x.w3 + x.w2 + x.w1 gives the logits to ~2^-24 (f32 x is
//    split the same way: 6 products, the terms below 2^-24 left out).
//    The tensor cores' f32 sums truncate, and over all of a CTA's d they
//    drifted to 5x the error of cuBLAS's f32 product (3x with two
//    pieces); so the accumulators hold one stage (64 values of d) and
//    each stage's sums are added, rounded to nearest on the CUDA cores,
//    to a running sum in registers (up to ~200 of them: one CTA an SM).
//    wgmma reads A (bf16 x) from the stage's 128-byte
//    swizzled K-major tile, B from the pieces' 128-byte swizzled MN-major
//    tiles; f32 x's pieces go to registers. TF32 mma.sync, the first
//    form, ran the product ~2x slower than everything else together
//    (scripts/router_variants.py, PERF.md).
//  * A cluster of C CTAs shares one tile of BM tokens, each CTA one C-th
//    of d: every CTA reads its share of x once and its rows of w, so the
//    L2 serves w BM-fold less often than a CTA per token tile reading all
//    of w would need, and each SM takes in ~384 KB at the prefill (BM 64,
//    C 2: 64 clusters, 128 CTAs, one an SM, the two warpgroups splitting
//    the k16 steps; 128-token tiles over clusters of 4 do not all fit one
//    CTA an SM). x streams through a ring of cp.async stages of 64 values
//    of d, three stages ahead; each thread fetches its 16 values of w two stages ahead
//    into registers and splits them into the pieces while nothing reads
//    them (the split waits for the last stage's products: a second pieces
//    buffer, to overlap the two, measured no faster). The CTAs' logits are
//    summed across the cluster through distributed shared memory (rank
//    order): each CTA ends with the logits of BM / C <= 32 rows. The
//    decode (t = 4) takes BM 64 and C 16 (the two warpgroups split the
//    k16 steps): 16 CTAs read w.
//  * The epilogue stays in shared memory and registers: 8 lanes a row, 4
//    rows a warp (a lane holds experts l, l + 8, ...); max and sum by xor
//    butterflies, expf and __fdiv_rn, k rounds of arg-max with ties to the
//    lower expert; a thread per expert gathers the rows' selections into a
//    32-bit row mask, so a choice's in-block position is a popcount.
//  * Positions across blocks: a block publishes, per expert, the count of
//    its rows in its last row's group, tagged with the launch's epoch (a
//    device counter the last CTA advances, so a replayed CUDA graph gets a
//    new one too) in one 64-bit store, then sums the counts of the earlier
//    blocks of its first row's group (spinning on their tags). Every block
//    it waits on is running: tiles go to clusters in the order they start
//    (an atomic start ticket: the decoupled look-back's order), so an
//    earlier tile's cluster has started before a later one waits on it.
//  * The statistics: each block writes its per-expert sums of p and
//    counts; the last CTA to finish (an exit ticket) sums them in block
//    order and writes mean_prob and frac_tokens. No float atomics; the
//    results do not depend on scheduling. The last CTA, after every CTA
//    has taken both tickets, sets them back to 0 for the next launch.
//  * Under a gradient the wrapper also passes `logits` (t, E) float32:
//    each row's logits, as the softmax took them, are written there for
//    the backward kernel (csrc/moe_router_bwd.cu), 1 MB at deepseek's
//    (4,096, 64). Serving passes a null pointer; the store is a branch on
//    a kernel argument, the same for every thread.
// The wrapper allocates the scratch (tails, block statistics, tickets)
// once per stream; the kernel runs on that stream and allocates nothing.
// One launch at a time may use a scratch: stream order keeps them apart.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxExperts = 64;
constexpr int kBK = 64;           // values of d a stage
constexpr int kPStride = 72;      // floats a partial-logit row
constexpr int kMaxRows = 32;      // rows a CTA routes (BM / C)
constexpr float kNegInf = -1e30f;
constexpr int kMaxSpins = 1 << 25;  // ~1 s of waiting on an earlier block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Zeros the 16 bytes at dst (cp.async reading no source bytes).
__device__ __forceinline__ void cp_async_zero16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, 0;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D (64 x 64, f32) (+)= A . B, A K-major and B MN-major (the transpose bit
// set) bf16 in shared memory; acc = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The float values of a packed pair of bf16.
__device__ __forceinline__ float bf_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// (x0, x1) = p[0] + p[1] + p[2], each a packed pair of bf16 rounded to
// nearest: 3 x 8 bits of mantissa, f32's 24.
__device__ __forceinline__ void pieces(float x0, float x1, uint32_t (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = pack_bf16(x0, x1);
    x0 -= bf_lo(p[i]);
    x1 -= bf_hi(p[i]);
  }
}

// Shared-memory matrix descriptor, 128-byte swizzle (as
// flash_attention_hopper.cu): an MN-major operand of 64 columns (128-byte
// rows), lbo the distance between 64-column boxes (one here), sbo 1024
// (8 rows along K).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(8192 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The same for a K-major operand of 64 bf16 (128-byte rows): lbo unused.
__device__ __forceinline__ uint64_t smem_desc_k(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups of wgmma are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of a register across the
// asynchronous wgmma that reads or writes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 64, f32) (+)= A . B, A bf16 in registers, B MN-major bf16 in
// shared memory (the transpose bit set); acc = 0 overwrites D
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned long long ld_volatile(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// Floats an f32 x stage row holds in shared memory: 64 values + padding,
// so that a warp's fragment loads fall in distinct banks.
constexpr int kXStride = kBK + 8;

// Shared memory, from a 1024-byte aligned base: the ring of x stages
// (bf16: 128-byte swizzled K-major tiles, wgmma's A; f32: rows padded to
// 72 values, read into registers), loaded kStages - 1 stages ahead, then
// w's three bf16 pieces of one stage (128-byte swizzled tiles, 64 rows of
// d by 64 experts). After the product: the k parts' logits and the
// epilogue's buffers from 0, the CTA's logits (read by the cluster) at
// kTSum.
template <typename TX, int BM>
struct Layout {
  static constexpr bool kSmemA = sizeof(TX) == 2;  // wgmma reads A there
  static constexpr int kStages = kSmemA ? 4 : 2;
  static constexpr int kAhead = kStages - 1;
  static constexpr int kXBytes = BM * (kSmemA ? 128 : kXStride * 4);
  static constexpr int kPieceTile = kBK * 128;
  static constexpr int kPieceOff = (kStages * kXBytes + 1023) / 1024 * 1024;
  static constexpr int kRowGroups = BM / 64;             // warpgroups on rows
  static constexpr int kKParts = 2 / kRowGroups;         // and on k16 steps
  static constexpr int kPart = BM * kPStride * 4;        // one k part's logits
  static constexpr int kEpiBytes = 29312;
  static constexpr int kTSum =
      (kEpiBytes > (kKParts - 1) * kPart ? kEpiBytes : (kKParts - 1) * kPart);
  static constexpr int kEnd = kPieceOff + 3 * kPieceTile > kTSum + kPart
                                  ? kPieceOff + 3 * kPieceTile
                                  : kTSum + kPart;
  static constexpr int kSmem = kEnd + 1024;  // room to align the base
  static_assert(BM == 64 || BM == 128, "one or two warpgroups of rows");
};

// The epilogue's buffers, in the region of the k-part partials (free once
// the CTA's sum is taken; the sum itself stays for the cluster's peers).
struct Epi {
  float* lg;           // [kMaxRows][kPStride] logits, then probabilities
  float* cgate;        // [kMaxRows][64] chosen g, by choice
  int* cidx;           // [kMaxRows][64] chosen expert, by choice
  unsigned long long* selmask;  // [kMaxRows] chosen experts of a row
  float* gsum;         // [kMaxRows]
  uint32_t* rowmask;   // [64] rows that chose each expert
  int* pre;            // [4][64] earlier blocks' counts, partial sums
  float* red;          // [4][2][64] the last CTA's partial sums
  __device__ explicit Epi(unsigned char* base) {
    lg = reinterpret_cast<float*>(base);
    cgate = lg + kMaxRows * kPStride;
    cidx = reinterpret_cast<int*>(cgate + kMaxRows * 64);
    selmask = reinterpret_cast<unsigned long long*>(cidx + kMaxRows * 64);
    gsum = reinterpret_cast<float*>(selmask + kMaxRows);
    rowmask = reinterpret_cast<uint32_t*>(gsum + kMaxRows);
    pre = reinterpret_cast<int*>(rowmask + 64);
    red = reinterpret_cast<float*>(pre + 4 * 64);
  }
};

// w's rows [k0, k0 + kk) of a stage into registers: thread t takes row
// t / 4, experts 16 (t % 4) .. + 15; past kk or e, zeros.
__device__ __forceinline__ void fetch_w(float (&v)[16],
                                        const float* __restrict__ w, int k0,
                                        int kk, int e) {
  const int r = threadIdx.x >> 2, c0 = 16 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < kk && c0 + 4 * j < e)
      q = __ldg(reinterpret_cast<const float4*>(w + int64_t(k0 + r) * e + c0 +
                                                4 * j));
    v[4 * j] = q.x;
    v[4 * j + 1] = q.y;
    v[4 * j + 2] = q.z;
    v[4 * j + 3] = q.w;
  }
}

// The thread's 16 values of w into the three bf16 pieces, 128-byte
// swizzled: row r's 16-byte chunk c (experts 8c .. 8c + 7) at r * 128 +
// ((c ^ (r % 8)) * 16).
__device__ __forceinline__ void store_pieces(unsigned char* tiles,
                                             const float (&v)[16]) {
  const int r = threadIdx.x >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t p[4][3];
#pragma unroll
    for (int j = 0; j < 4; ++j) pieces(v[8 * h + 2 * j], v[8 * h + 2 * j + 1],
                                       p[j]);
    const int c = 2 * (threadIdx.x & 3) + h;
    const int off = r * 128 + ((c ^ (r & 7)) << 4);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      *reinterpret_cast<uint4*>(tiles + i * (kBK * 128) + off) =
          make_uint4(p[0][i], p[1][i], p[2][i], p[3][i]);
  }
}

// Issue the cp.async copies of x's rows [row0, row0 + rows), columns
// [k0, k0 + kk) of this stage, zeros past kk. Rows past t are left as they
// are: they only feed logits of rows nobody reads. bf16: row r's 16-byte
// piece p at r * 128 + ((p ^ (r % 8)) * 16), wgmma's 128-byte swizzle.
template <typename TX>
__device__ __forceinline__ void load_x(unsigned char* xs,
                                       const TX* __restrict__ x, int64_t ldx,
                                       int64_t row0, int rows, int k0,
                                       int kk) {
  constexpr int kPer = 16 / sizeof(TX);   // values a piece
  constexpr int kPieces = kBK / kPer;     // pieces a full row
  const int pieces = kk / kPer;
  for (int i = threadIdx.x; i < rows * kPieces; i += kThreads) {
    const int r = i / kPieces, p = i - r * kPieces;
    void* dst = sizeof(TX) == 2 ? xs + r * 128 + ((p ^ (r & 7)) << 4)
                                : xs + (r * kXStride + p * kPer) * 4;
    const TX* src = x + (row0 + r) * ldx + k0 + (p < pieces ? p * kPer : 0);
    if (p < pieces)
      cp_async16(dst, src);
    else
      cp_async_zero16(dst, src);
  }
}

// A fragments (m16 rows from r0, the k16 step at column c0) of f32 x's
// three bf16 pieces. Columns past kk are zeros (the stage is partial).
__device__ __forceinline__ void a_frag(const float* xs, int r0, int c0,
                                       int kk, uint32_t (&a)[3][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int o = (r0 + g) * kXStride + c0 + 2 * q;
  const int at[4] = {o, o + 8 * kXStride, o + 8, o + 8 * kXStride + 8};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool live = c0 + 2 * q + (j >= 2 ? 8 : 0) < kk;
    const float2 v = live ? *reinterpret_cast<const float2*>(xs + at[j])
                          : make_float2(0.0f, 0.0f);
    uint32_t p[3];
    pieces(v.x, v.y, p);
#pragma unroll
    for (int i = 0; i < 3; ++i) a[i][j] = p[i];
  }
}

// One stage's products of this warpgroup: its 64 rows, its k16 steps of
// the stage, all 64 experts; w's pieces at `tiles`. bf16 x: x.w3 + x.w2 +
// x.w1, A read by wgmma from the stage's swizzled tile. f32 x: its three
// pieces from registers, also x3.w1, x2.w2, x2.w1 (the terms below 2^-24
// left out); small terms first.
// The stage's first product overwrites acc, which no other instruction
// writes (ptxas would serialize the wgmma): acc holds one stage's sums.
template <typename TX, int BM>
__device__ __forceinline__ void stage_products(const unsigned char* xs,
                                               uint32_t tiles, int kk,
                                               int rg, int kp,
                                               uint32_t (&a)[4][3][4],
                                               float (&acc)[32]) {
  using L = Layout<TX, BM>;
  if constexpr (!L::kSmemA) {
    const int w4 = (threadIdx.x >> 5) & 3;
#pragma unroll
    for (int s = 0; s < 4 / L::kKParts; ++s)
      a_frag(reinterpret_cast<const float*>(xs), rg * 64 + w4 * 16,
             16 * (s * L::kKParts + kp), kk, a[s]);
  }
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4 / L::kKParts; ++s) {
    const int step = s * L::kKParts + kp;
    const uint32_t b = tiles + step * 16 * 128;
    const uint64_t w1 = smem_desc(b), w2 = smem_desc(b + L::kPieceTile),
                   w3 = smem_desc(b + 2 * L::kPieceTile);
    const int keep = s > 0;
    if constexpr (L::kSmemA) {
      const uint64_t xa = smem_desc_k(smem_u32(xs) + rg * 64 * 128 + step * 32);
      wgmma_ss_n64(acc, xa, w3, keep);
      wgmma_ss_n64(acc, xa, w2);
      wgmma_ss_n64(acc, xa, w1);
    } else {
      wgmma_rs_n64(acc, a[s][2], w1, keep);
      wgmma_rs_n64(acc, a[s][1], w2);
      wgmma_rs_n64(acc, a[s][1], w1);
      wgmma_rs_n64(acc, a[s][0], w3);
      wgmma_rs_n64(acc, a[s][0], w2);
      wgmma_rs_n64(acc, a[s][0], w1);
    }
  }
  wgmma_commit();
}

struct Args {
  const void* x;
  int64_t ldx;
  const float* w;
  int t, d, e, k, renorm, group, tiles;
  float* gates;
  int32_t* idx;
  int32_t* pos;
  float* aux;                  // (2, e): mean_prob, frac_tokens
  float* logits;               // (t, e) or null: the logits, for a backward
  unsigned long long* tails;   // (blocks, 64) epoch << 32 | count
  float* stats;                // (blocks, 2, 64) sums of p, counts
  unsigned* tickets;  // [0] tiles started, [1] CTAs finished, [2] launches
};

template <typename TX, int BM>
__global__ void __launch_bounds__(kThreads, 1) route_kernel(const Args a) {
  using L = Layout<TX, BM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_tile, s_last;
  __shared__ unsigned s_epoch;
  // the swizzled tiles want a 1024-byte aligned base
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) &
                                    1023u);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows_per_cta = BM / csize;
  const TX* x = static_cast<const TX*>(a.x);

  // This CTA's share of d: chunks [c_lo, c_hi) of kBK values.
  const int nchunks = (a.d + kBK - 1) / kBK;
  const int c_lo = rank * nchunks / csize, c_hi = (rank + 1) * nchunks / csize;
  const int nmine = c_hi - c_lo;
  // (a stage past the CTA's share, which pads its count to even, is empty)
  auto chunk_len = [&](int c) {
    return c < nmine ? min(kBK, a.d - (c_lo + c) * kBK) : 0;
  };
  auto stage_x = [&](int s) { return smem + s * L::kXBytes; };
  unsigned char* tiles = smem + L::kPieceOff;

  // w's first stages do not depend on the tile: in flight before the
  // ticket. A thread holds its values of w for two stages.
  float wv[2][16];
  fetch_w(wv[0], a.w, c_lo * kBK, nmine > 0 ? chunk_len(0) : 0, a.e);
  fetch_w(wv[1], a.w, (c_lo + 1) * kBK, nmine > 1 ? chunk_len(1) : 0, a.e);
  // the launch's epoch: loaded now, stored for the block after the
  // products (the load of a cold line is off the way to them)
  const unsigned epoch_in =
      tid == 0 ? *reinterpret_cast<volatile unsigned*>(&a.tickets[2]) : 0u;
  // the cluster's tile, by start ticket: every earlier tile has started
  if (tid == 0 && rank == 0)
    s_tile = static_cast<int>(atomicAdd(&a.tickets[0], 1u));
  cluster.sync();
  const int tile = *cluster.map_shared_rank(&s_tile, 0);
  if (tile >= a.tiles) __trap();  // tickets not left at 0: a fault
  const int64_t row0 = int64_t(tile) * BM;
  const int rows_tile = static_cast<int>(a.t - row0 < BM ? a.t - row0 : BM);

#pragma unroll
  for (int s = 0; s < L::kAhead; ++s) {
    load_x(stage_x(s), x, a.ldx, row0, rows_tile, (c_lo + s) * kBK,
           chunk_len(s));
    cp_async_commit();
  }

  // warpgroup: rows [64 rg, 64 rg + 64), k16 steps kp, kp + kKParts, ...
  const int rg = (warp >> 2) % L::kRowGroups, kp = (warp >> 2) / L::kRowGroups;
  const bool live_rows = 64 * rg < rows_tile;
  float acc[32];          // one stage's sums, written by its products only
  uint32_t af[4][3][4];   // f32 x: the A fragments a stage's wgmma read
  // The running sum over the stages, in f32 on the CUDA cores (rounded to
  // nearest): the tensor cores' own sums over a long run of products
  // drift (they truncate), so each stage's sums are added here.
  float run[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) run[i] = 0.0f;
  auto add_stage = [&](bool live) {  // a select: acc is read, not written
#pragma unroll
    for (int i = 0; i < 32; ++i) run[i] += live ? acc[i] : 0.0f;
  };

  // Stage c: wait for x(c) and for the products of stage c - 1, which
  // read the pieces, the x slot refilled now and (f32) the A registers,
  // and add their sums to the running sum; split w(c) into the pieces;
  // multiply.
  auto stage = [&](int c, float (&w_c)[16]) {
    cp_async_wait<L::kAhead - 1>();
    wgmma_wait<0>();
    fence_regs(acc);
    if constexpr (!L::kSmemA) {
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int i = 0; i < 3; ++i) fence_regs(af[s][i]);
    }
    add_stage(c > 0);
    __syncthreads();
    const int next = c + L::kAhead;
    load_x(stage_x(next % L::kStages), x, a.ldx, row0, rows_tile,
           (c_lo + next) * kBK, chunk_len(next));
    cp_async_commit();
    store_pieces(tiles, w_c);
    fetch_w(w_c, a.w, (c_lo + c + 2) * kBK, chunk_len(c + 2), a.e);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    stage_products<TX, BM>(stage_x(c % L::kStages), smem_u32(tiles),
                           chunk_len(c), rg, kp, af, acc);
  };
  // in pairs with no branch around the products (ptxas would serialize
  // the wgmma behind one)
  for (int c = 0; c == 0 || c < nmine; c += 2) {  // empty stages give 0
    stage(c, wv[0]);
    stage(c + 1, wv[1]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  add_stage(true);
  cp_async_wait<0>();
  if (tid == 0) s_epoch = epoch_in % 0xffffffffu + 1u;  // never 0, the
  __syncthreads();                                      // tails' first tag

  // The CTA's sum over its k parts in order: part 1 writes its logits,
  // part 0 adds them to its own. Running sum 4j + i of a thread: row g
  // (+ 8 for i >= 2), expert 8j + 2q (+ 1 for odd i) of its warp's 16
  // rows.
  float* tsum = reinterpret_cast<float*>(smem + L::kTSum);
  {
    const int g = lane >> 2, q = lane & 3;
    const int o0 = (rg * 64 + (warp & 3) * 16 + g) * kPStride + 2 * q;
    float* part = reinterpret_cast<float*>(smem);
    if (kp > 0 && live_rows)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(part + o0 + 8 * j) =
            make_float2(run[4 * j], run[4 * j + 1]);
        *reinterpret_cast<float2*>(part + o0 + 8 * kPStride + 8 * j) =
            make_float2(run[4 * j + 2], run[4 * j + 3]);
      }
    __syncthreads();
    if (kp == 0 && live_rows)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float2 lo = make_float2(run[4 * j], run[4 * j + 1]);
        float2 hi = make_float2(run[4 * j + 2], run[4 * j + 3]);
        if (L::kKParts > 1) {
          const float2 u =
              *reinterpret_cast<const float2*>(part + o0 + 8 * j);
          const float2 v = *reinterpret_cast<const float2*>(
              part + o0 + 8 * kPStride + 8 * j);
          lo.x += u.x;
          lo.y += u.y;
          hi.x += v.x;
          hi.y += v.y;
        }
        *reinterpret_cast<float2*>(tsum + o0 + 8 * j) = lo;
        *reinterpret_cast<float2*>(tsum + o0 + 8 * kPStride + 8 * j) = hi;
      }
  }
  cluster.sync();

  // This CTA's rows [rb, rb + rows): their logits summed over the cluster
  // in rank order.
  Epi ep(smem);
  const int rb = rank * rows_per_cta;
  const int rows = max(0, min(rows_per_cta, rows_tile - rb));
  const int q4 = a.e >> 2;  // float4s a row
  for (int i = tid; i < rows * q4; i += kThreads) {
    const int r = i / q4, o = (rb + r) * kPStride + 4 * (i - r * q4);
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c0 = 0; c0 < csize; c0 += 4) {
      float4 v[4];  // four peers' loads in flight before their sum
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + u < csize)
          v[u] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(tsum, c0 + u) + o);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + u < csize) {
          sum.x += v[u].x;
          sum.y += v[u].y;
          sum.z += v[u].z;
          sum.w += v[u].w;
        }
    }
    *reinterpret_cast<float4*>(ep.lg + r * kPStride + 4 * (i - r * q4)) = sum;
  }
  cluster_arrive();  // done reading the peers; waited on before exit
  __syncthreads();

  // Softmax, top-k, renormalisation: 8 lanes a row, 4 rows a warp.
  const int blk = tile * csize + rank;   // blocks of rows_per_cta rows
  const int64_t brow = row0 + rb;        // the block's first row
  {
    const int r = warp * 4 + (lane >> 3), l = lane & 7;
    const bool live = r < rows;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ex = l + 8 * i;
      v[i] = (live && ex < a.e) ? ep.lg[r * kPStride + ex]
                                : (ex < a.e ? 0.0f : neg_inf());
    }
    if (a.logits != nullptr && live)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (l + 8 * i < a.e) a.logits[(brow + r) * a.e + l + 8 * i] = v[i];
    float mx = v[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) mx = fmaxf(mx, v[i]);
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = (l + 8 * i < a.e) ? expf(v[i] - mx) : 0.0f;
      sum += v[i];
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
    float work[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = __fdiv_rn(v[i], sum);
      work[i] = (l + 8 * i < a.e) ? v[i] : neg_inf();
      if (live && l + 8 * i < a.e) ep.lg[r * kPStride + l + 8 * i] = v[i];
    }
    float gsum = 0.0f;
    unsigned long long mask = 0ull;
    for (int j = 0; j < a.k; ++j) {
      float bv = work[0];
      int bi = l;
#pragma unroll
      for (int i = 1; i < 8; ++i)
        if (work[i] > bv) {
          bv = work[i];
          bi = l + 8 * i;
        }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, o);
        const int oi = __shfl_xor_sync(kFull, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (l + 8 * i == bi) work[i] = kNegInf;
      gsum += bv;
      mask |= 1ull << bi;
      if (live && l == 0) {
        ep.cgate[r * 64 + j] = bv;
        ep.cidx[r * 64 + j] = bi;
      }
    }
    if (l == 0 && r < kMaxRows) {
      ep.selmask[r] = live ? mask : 0ull;
      ep.gsum[r] = gsum;
    }
  }
  __syncthreads();

  // Each expert's rows, as a bit mask over the block's rows.
  if (tid < kMaxExperts) {
    uint32_t bits = 0;
    for (int r = 0; r < rows; ++r)
      bits |= static_cast<uint32_t>((ep.selmask[r] >> tid) & 1ull) << r;
    ep.rowmask[tid] = bits;
  }
  __syncthreads();

  // Publish this block's counts in its last row's group, then sum the
  // earlier blocks' counts of its first row's group.
  const unsigned epoch = s_epoch;
  const int64_t g_first = brow / a.group * a.group;  // first row's group
  if (rows > 0 && tid < a.e) {
    const int64_t g_last = (brow + rows - 1) / a.group * a.group;
    const int lo = static_cast<int>(g_last > brow ? g_last - brow : 0);
    const unsigned n = __popc(ep.rowmask[tid] >> lo);
    *reinterpret_cast<volatile unsigned long long*>(
        a.tails + int64_t(blk) * 64 + tid) =
        (static_cast<unsigned long long>(epoch) << 32) | n;
    // the block statistics
    float ps = 0.0f;
    for (int r = 0; r < rows; ++r) ps += ep.lg[r * kPStride + tid];
    float* st = a.stats + int64_t(blk) * 128;
    st[tid] = ps;
    st[64 + tid] = static_cast<float>(__popc(ep.rowmask[tid]));
  }
  {
    const int ex = tid & 63, part = tid >> 6;
    int n = 0;
    if (rows > 0 && ex < a.e) {
      const int first = static_cast<int>(g_first / rows_per_cta);
      for (int b0 = first + part; b0 < blk; b0 += 4 * 8) {
        unsigned long long v[8];  // every tail's load in flight first
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int b = b0 + 4 * u;
          v[u] = b < blk ? ld_volatile(a.tails + int64_t(b) * 64 + ex)
                         : static_cast<unsigned long long>(epoch) << 32;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const unsigned long long* p = a.tails + int64_t(b0 + 4 * u) * 64 + ex;
          for (int spins = 0; static_cast<unsigned>(v[u] >> 32) != epoch;
               v[u] = ld_volatile(p)) {
            __nanosleep(32);
            if (++spins > kMaxSpins) __trap();  // a fault, never a hang
          }
          n += static_cast<int>(v[u] & 0xffffffffu);
        }
      }
    }
    ep.pre[part * 64 + ex] = n;
  }
  __syncthreads();

  // gates, ids, positions of the block's rows, coalesced.
  for (int i = tid; i < rows * a.k; i += kThreads) {
    const int r = i / a.k, j = i - r * a.k;
    const int ex = ep.cidx[r * 64 + j];
    const float gv = ep.cgate[r * 64 + j];
    const int64_t row = brow + r;
    const int64_t g_row = row / a.group * a.group;
    const int lo = static_cast<int>(g_row > brow ? g_row - brow : 0);
    const uint32_t below = (1u << r) - 1u, from = ~((1u << lo) - 1u);
    int p = __popc(ep.rowmask[ex] & below & from);
    if (lo == 0)
      p += ep.pre[ex] + ep.pre[64 + ex] + ep.pre[128 + ex] + ep.pre[192 + ex];
    const int64_t o = row * a.k + j;
    a.gates[o] = a.renorm ? __fdiv_rn(gv, fmaxf(ep.gsum[r], 1e-20f)) : gv;
    a.idx[o] = ex;
    a.pos[o] = p;
  }

  // The last CTA to finish sums the blocks' statistics in block order.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned total = gridDim.x;
    s_last = atomicAdd(&a.tickets[1], 1u) == total - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    if (tid == 0) {  // every CTA has taken its tickets and read the epoch
      a.tickets[0] = 0u;
      a.tickets[1] = 0u;
      a.tickets[2] += 1u;
    }
    const int ex = tid & 63, part = tid >> 6;
    const int blocks = static_cast<int>((a.t + rows_per_cta - 1) /
                                        rows_per_cta);
    float ps = 0.0f, cn = 0.0f;  // blocks part, part + 4, ... in order
    if (ex < a.e)
      for (int b0 = part; b0 < blocks; b0 += 4 * 16) {
        float pv[16], cv[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int b = b0 + 4 * u;
          pv[u] = b < blocks ? __ldcg(a.stats + int64_t(b) * 128 + ex) : 0.0f;
          cv[u] = b < blocks ? __ldcg(a.stats + int64_t(b) * 128 + 64 + ex)
                             : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          ps += pv[u];
          cn += cv[u];
        }
      }
    ep.red[part * 128 + ex] = ps;
    ep.red[part * 128 + 64 + ex] = cn;
    __syncthreads();
    if (tid < a.e) {
      float s = 0.0f, n = 0.0f;
      for (int p = 0; p < 4; ++p) {
        s += ep.red[p * 128 + tid];
        n += ep.red[p * 128 + 64 + tid];
      }
      a.aux[tid] = __fdiv_rn(s, static_cast<float>(a.t));
      a.aux[a.e + tid] =
          __fdiv_rn(n, static_cast<float>(int64_t(a.t) * a.k));
    }
  }
  cluster_wait();  // no CTA leaves while a peer may read its sums
}

template <typename TX, int BM>
int launch_route(const Args& a, int csize, cudaStream_t s) {
  using L = Layout<TX, BM>;
  auto kernel = route_kernel<TX, BM>;
  static bool ready = false;  // per instantiation: attributes set once
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.tiles * csize);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int by_shape(int dtype, int block_tokens, F&& f) {
  using Rows64 = std::integral_constant<int, 64>;
  using Rows128 = std::integral_constant<int, 128>;
  if (dtype == 0 && block_tokens == 64) return f(float{}, Rows64{});
  if (dtype == 0 && block_tokens == 128) return f(float{}, Rows128{});
  if (dtype == 1 && block_tokens == 64) return f(__nv_bfloat16{}, Rows64{});
  if (dtype == 1 && block_tokens == 128) return f(__nv_bfloat16{}, Rows128{});
  return -1;
}

}  // namespace

// dtype: 0 = float32 x, 1 = bfloat16 x. x (t, d) with row stride ldx
// (elements), unit stride along d, 16-byte aligned rows; w (d, e) float32
// contiguous, 16-byte aligned; gates (t, k) float32, idx and pos (t, k)
// int32, aux (2, e) float32, all contiguous; logits (t, e) float32
// contiguous, or null (not written). 1 <= k <= e <= 64, e % 4 == 0,
// d % 8 == 0, group >= 1. block_tokens (BM) 32 or 128 rows a cluster of
// `cluster` CTAs (1, 2, 4, 8 or 16; BM / cluster <= 32 rows a CTA). tails
// (ceil(t / BM) * cluster, 64) uint64 and tickets (3,) uint32, zeroed once,
// then only written here; stats (the same blocks, 2, 64) float32; no other
// launch may use them until this one ends. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int moe_route_tokens(int dtype, const void* x, int64_t ldx,
                                const float* w, int t, int d, int e, int k,
                                int renorm, int group, int block_tokens,
                                int cluster, float* gates, int32_t* idx,
                                int32_t* pos, float* aux, float* logits,
                                unsigned long long* tails, float* stats,
                                unsigned* tickets, void* stream) {
  if (t < 1 || e < 4 || e > kMaxExperts || e % 4 || k < 1 || k > e ||
      d < 8 || d % 8 || group < 1 || cluster < 1 ||
      cluster > 16 || (cluster & (cluster - 1)) ||
      block_tokens % cluster || block_tokens / cluster > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.ldx = ldx;
  a.w = w;
  a.t = t;
  a.d = d;
  a.e = e;
  a.k = k;
  a.renorm = renorm;
  a.group = group;
  a.tiles = (t + block_tokens - 1) / block_tokens;
  a.gates = gates;
  a.idx = idx;
  a.pos = pos;
  a.aux = aux;
  a.logits = logits;
  a.tails = tails;
  a.stats = stats;
  a.tickets = tickets;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = by_shape(dtype, block_tokens, [&](auto tx, auto bm) {
    return launch_route<decltype(tx), decltype(bm)::value>(a, cluster, s);
  });
  return err < 0 ? static_cast<int>(cudaErrorInvalidValue) : err;
}
