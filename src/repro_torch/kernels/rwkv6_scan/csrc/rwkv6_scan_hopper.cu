// RWKV-6 (Finch) WKV recurrence for Hopper (sm_90a), "chunked": the scan
// taken 16 steps at a time, its products on the tensor cores. Per (batch,
// head), with state S in R^{n x n} (key i x value j):
//
//     out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j]  = w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// and the final state. Replaces the Pallas TPU kernel
// repro/kernels/rwkv6_scan/rwkv6_scan.py::_wkv6_kernel (line 25) for bf16
// r/k/v, f32 or bf16 w, head size 64 and t >= 16 (ops.py::plan); the
// CUDA-core kernel beside it (rwkv6_scan.cu, "simt") serves the rest.
//
// What bounds it: at the serving prefill (b, t, h, n) = (4, 1024, 64, 64) the
// function moves 209.7 MB, 62.6 us at 3.35 TB/s: bytes. Taken step by step on
// CUDA cores its 5 f32 operations per state element and step need >= 80.1 us
// (and the FP32 pipe's issue rate more); taken by chunks, the products go to
// the tensor cores and the CUDA cores keep O(C n) work per step.
//
// The math, for a chunk of L <= C = 16 steps from the state S_c at its start
// (ref.py::wkv6_chunked is the same in plain PyTorch). Per key i:
//   P_t = prod_{m<t} w_m,  Q_s = prod_{s<m<L} w_m,  D = prod_{m<L} w_m,
//   W(t,s) = prod_{s<m<t} w_m (s < t), as running products along t.
//   out   = (r * P) . S_c + A . v,  A[t][s] = sum_i r_t W(t,s) k_s (s < t),
//           A[t][t] = sum_i r_t u k_t, 0 above the diagonal;
//   S_c+1 = diag(D) S_c + (k * Q)^T . v.
// Every factor is a plain product of at most 16 decays: no logarithm, no
// division (k_s / P_s would overflow, and divide by 0 at w = 0), no special
// case for w = 0 or 1. The ragged last chunk runs its own L steps only: its
// operand rows past L are zeros and its decays past L enter no product.
//
// Precision. A TF32 product rounds its operands to 10 mantissa bits
// (~5e-4), too coarse for a state held to 1e-5 of its scale. So every
// operand with more bits than TF32 is split, x = hi + lo (hi = cvt.rna(x),
// lo = cvt.rna(x - hi)), and a product a.b taken as hi.hi' + hi.lo' +
// lo.hi' ("3xTF32", ~2^-21 relative). bf16 r, k, v are exact in TF32:
//   (r * P) . S   3 passes;  (k * Q)^T . v  2;  A . v  2.
// All accumulate in f32; the output is rounded once to bf16.
//
// Design (scripts/wkv_variants.py times the alternatives and the cuts
// behind these choices):
//  * One CTA per (batch, head), 2 CTAs an SM: a consumer warpgroup (warps
//    0-3) and a producer warpgroup (warps 4-7).
//  * Each consumer warp owns 16 value columns of S for the whole scan, as
//    f32 accumulators of S^T (values x keys). Holding S transposed makes
//    its m16n8 accumulator fragment (row g, columns 2c, 2c+1 of each 8-key
//    tile) the A fragment of O^T = S^T . (r * P)^T (row g, k c and c + 4)
//    once the k order inside each 8-key step is taken as (2c, 2c + 1) ->
//    (c, c + 4): the sum over keys does not care, and the B operand is read
//    from shared memory in the same order. So S never leaves the registers
//    and needs no shuffle; it is split into hi/lo in place each chunk and
//    multiplied by mma.sync m16n8k8 (48 a warp and chunk).
//  * The state update S^T = S^T * D + v^T . (k * Q) is one wgmma
//    m64n64k8 per k-step and pass (4 a chunk) on the warpgroup's whole
//    S^T: its accumulator layout is the m16n8 one stacked, A = v^T from
//    registers, B = k * Q from shared memory (K-major, no swizzle), read
//    once for the warpgroup instead of once per warp. It runs while the
//    outputs are staged and the next chunk's decay products are made.
//  * The producers keep the raw r, k, v, w tiles of the next kRawStages
//    chunks in flight by cp.async and compute A (CUDA cores, f32, once per
//    chunk for all value columns): 16 entries a thread over 4 keys, summed
//    over the 16 key groups by a transpose-reduce of shuffles. The
//    consumers, after their chunk, turn the next chunk's raw tiles into
//    r * P, k * Q (split), D and v as f32, a key a lane, every store 8 or
//    16 bytes without bank conflicts: a named barrier tells them the tiles
//    have landed. Both write the next chunk's operand stage while the last
//    one is read; one __syncthreads a chunk hands it over.
//  * What bounds it now (on the H100, the variants script's cuts): the two
//    chains a chunk, the producers' A and the consumers' chunk plus decay
//    products, are about equally long, and each CTA's chain, not the
//    card, sets the pace: 256 heads give 132 SMs 2 CTAs at most. Around
//    them ~1,400 shared-memory wavefronts a CTA and chunk (the mma.sync
//    product's B fragments loaded by all 4 warps, A's row loads and
//    shuffles, the operand tiles).
//  * The ragged last chunk runs its own L steps: rows past L are zeros in
//    every operand, and its decays past L enter no product.
//  * Types: r, k, v, out bf16; w float32 or bf16 (its type W, converted to
//    f32 as it is, never rounded further); u and the states f32. The state
//    may be read and written in place (s_out == s_in): each CTA reads its
//    own (batch, head) slice before it writes it, and no other CTA touches
//    it. Rows of r, k, v, w, out must start on 16-byte boundaries (the
//    wrapper checks).
// The kernel runs on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kN = 64;            // head size
constexpr int kC = 16;            // chunk length
constexpr int kWarpsC = 4;        // consumer warps (16 value columns each)
constexpr int kThreads = 256;     // consumer and producer warpgroups
constexpr int kProd = 128;        // threads of a warpgroup
constexpr int kRawStages = 2;     // raw stages: chunk c+1 landed, c+2 in flight
constexpr int kKeyGroups = 16;    // producers' key groups (4 keys each)
// Row strides, padded so that the consumers' fragment loads hit distinct
// banks: (r * P) as float4 {hi 2p, lo 2p, hi 2p+1, lo 2p+1} per key pair
// p; A^T as float2 {hi, lo}; v as float.
constexpr int kRpStride = 36;     // float4 a row (32 key pairs)
constexpr int kAtStride = 20;     // float2 a row (16 steps)
constexpr int kVStride = 72;      // float a row (64 values)
constexpr int kOStride = 72;      // bf16 a row of the output tile

// One stage of raw tiles: r, k, v (bf16) and w (W), 16 x 64 each.
template <typename W>
struct Raw {
  __nv_bfloat16 r[kC * kN], k[kC * kN], v[kC * kN];
  W w[kC * kN];
};

// One stage of the consumers' operands.
struct Prep {
  float4 rp[kC * kRpStride];        // (r * P)[t][key pair], hi and lo
  // (k * Q) as wgmma's B operand, K-major (the steps s) without swizzle,
  // [0] hi and [1] lo: core matrices of 8 keys x 4 steps (128 bytes), 4
  // along s (LBO 128 bytes), 8 along the keys (SBO 512 bytes)
  float kqw[2][kN * kC];
  float2 at[kC * kAtStride];        // A^T[s][t], hi and lo
  float vf[kC * kVStride];          // v[s][j]
  float d[kN];                      // D[i]
};

template <typename W>
struct Smem {
  Raw<W> raw[kRawStages];
  Prep prep[2];
  __nv_bfloat16 obuf[kC * kOStride];      // a chunk's outputs [t][j]
};

__device__ __forceinline__ float bf_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  x[0] = bf_lo(q.x); x[1] = bf_hi(q.x); x[2] = bf_lo(q.y); x[3] = bf_hi(q.y);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ float2 split2(float x) {
  uint32_t h, l;
  split(x, h, l);
  return make_float2(__uint_as_float(h), __uint_as_float(l));
}

// d += a . b, m16n8k8, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// wgmma's shared-memory descriptor of a K-major tile without swizzle:
// start address, LBO (next core matrix along K), SBO (along N), in bytes
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (m64n64, f32) += a (m64k8 TF32, registers) . b (k8n64 TF32, shared)
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[8][4],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// Keeps a register's value in place across asynchronous wgmma: the
// compiler neither reads nor reuses it early.
__device__ __forceinline__ void fence_reg(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest kRawStages - 1 commit groups have landed
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRawStages - 1) : "memory");
}

// The producers' cp.async loads of chunk ``c`` (its first len rows) into a
// raw stage; one commit group, empty past the last chunk.
template <typename W>
__device__ __forceinline__ void load_chunk(Raw<W>& st, const __nv_bfloat16* r,
                                           const __nv_bfloat16* k,
                                           const __nv_bfloat16* v, const W* w,
                                           size_t base, size_t step, int c,
                                           int nc, int t, int p) {
  if (c < nc) {
    const int len = min(kC, t - c * kC);
    {
      const int row = p >> 3, seg = p & 7;   // 8 x 16 bytes a bf16 row
      if (row < len) {
        const size_t off = base + (c * kC + row) * step + seg * 8;
        cp_async16(&st.r[row * kN + seg * 8], r + off);
        cp_async16(&st.k[row * kN + seg * 8], k + off);
        cp_async16(&st.v[row * kN + seg * 8], v + off);
      }
    }
    constexpr int kSegs = kN * sizeof(W) / 16;   // 16-byte pieces a w row
    constexpr int kPer = 16 / sizeof(W);
    for (int e = p; e < kC * kSegs; e += kProd) {
      const int row = e / kSegs, seg = e - row * kSegs;
      if (row < len)
        cp_async16(&st.w[row * kN + seg * kPer],
                   w + base + (c * kC + row) * step + seg * kPer);
    }
  }
  cp_commit();
}

// The next chunk's operands from its raw tiles, by the consumers, a key a
// lane: warps 0-1 the prefix products (r * P, split, {hi, lo} of a key an
// 8-byte store a step, D), warps 2-3 the suffix products (k * Q, split,
// 16-byte stores of 4 steps into wgmma's core matrices); then v as f32, 8
// values a thread. Rows are read 8 at a time before they are used (rows
// past len hold stale values, which selects keep out of every result).
template <typename W>
__device__ __forceinline__ void decay_products(const Raw<W>& st, Prep& pr,
                                               int len, int tid) {
  constexpr int kB = kC / 2;
  const int i = tid & (kN - 1);
  float run = 1.f;
  if (tid < kN) {
    float* rp = reinterpret_cast<float*>(pr.rp) + (i >> 1) * 4 + 2 * (i & 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float x[kB], wv[kB];
#pragma unroll
      for (int e = 0; e < kB; ++e) {
        x[e] = __bfloat162float(st.r[(half * kB + e) * kN + i]);
        wv[e] = to_f32(st.w[(half * kB + e) * kN + i]);
      }
#pragma unroll
      for (int e = 0; e < kB; ++e) {
        const int tt = half * kB + e;
        const bool on = tt < len;
        *reinterpret_cast<float2*>(rp + tt * kRpStride * 4) =
            split2(on ? x[e] * run : 0.f);
        run = on ? run * wv[e] : run;
      }
    }
    pr.d[i] = run;
  } else {
    // core matrix row of key i; 4 steps s a 16-byte run, 4 runs along s
    float* hi = pr.kqw[0] + (i & 7) * 4 + (i >> 3) * 128;
    float* lo = pr.kqw[1] + (i & 7) * 4 + (i >> 3) * 128;
#pragma unroll
    for (int half = 1; half >= 0; --half) {
      float x[kB], wv[kB];
#pragma unroll
      for (int e = 0; e < kB; ++e) {
        x[e] = __bfloat162float(st.k[(half * kB + e) * kN + i]);
        wv[e] = to_f32(st.w[(half * kB + e) * kN + i]);
      }
      float2 hl[kB];
#pragma unroll
      for (int e = kB - 1; e >= 0; --e) {
        const bool on = half * kB + e < len;
        hl[e] = split2(on ? x[e] * run : 0.f);
        run = on ? run * wv[e] : run;
      }
#pragma unroll
      for (int g4 = 0; g4 < kB / 4; ++g4) {
        const int gs = half * (kB / 4) + g4;      // steps 4 gs .. 4 gs + 3
        *reinterpret_cast<float4*>(hi + gs * 32) =
            make_float4(hl[4 * g4].x, hl[4 * g4 + 1].x, hl[4 * g4 + 2].x,
                        hl[4 * g4 + 3].x);
        *reinterpret_cast<float4*>(lo + gs * 32) =
            make_float4(hl[4 * g4].y, hl[4 * g4 + 1].y, hl[4 * g4 + 2].y,
                        hl[4 * g4 + 3].y);
      }
    }
  }
  // v: 8 values a thread, one 16-byte load
  const int row = tid >> 3, col = (tid & 7) * 8;
  const uint4 q = *reinterpret_cast<const uint4*>(&st.v[row * kN + col]);
  const bool on = row < len;
  const uint32_t qs[4] = {q.x, q.y, q.z, q.w};
  float* dst = pr.vf + row * kVStride + col;
#pragma unroll
  for (int x2 = 0; x2 < 2; ++x2)
    *reinterpret_cast<float4*>(dst + 4 * x2) = on
        ? make_float4(bf_lo(qs[2 * x2]), bf_hi(qs[2 * x2]),
                      bf_lo(qs[2 * x2 + 1]), bf_hi(qs[2 * x2 + 1]))
        : make_float4(0.f, 0.f, 0.f, 0.f);
}

// One stage of a transpose-reduce over the 16 lanes of a half-warp: lane
// kg keeps the M of its 2M partial sums whose entry has bit M equal to its
// own, adds its partner's (lane kg ^ M) for them, and sends the others.
template <int M>
__device__ __forceinline__ void reduce_half(float (&part)[kC], int kg) {
  const bool up = kg & M;
#pragma unroll
  for (int x = 0; x < M; ++x) {
    const float send = up ? part[x] : part[x + M];
    const float keep = up ? part[x + M] : part[x];
    part[x] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// A, computed by the producers. Thread p is slot q = p / 16 (0..7) and key
// group kg = p % 16 (keys 4 kg..4 kg + 3); the 16 key groups of a slot are
// the 16 lanes of a half-warp. Slot q takes 16 entries (t, s) of A's lower
// triangle, step j = 0..15: column s = q for t = q + 1 + j (j < 15 - q),
// then column s = 14 - q for t = j (q < 7; slot 7 has column 7 only),
// with k_s W(t, s) as a running product along t. Each lane sums its 4
// keys; a transpose-reduce over the 16 lanes (15 shuffles) leaves entry j
// = kg summed in lane kg, which writes it. The diagonal, A[t][t] = sum_i
// r_t u k_t, is taken at t = 2q and 2q + 1 the same way. Entries of rows
// past len are written as 0; the upper triangle was zeroed once.
template <typename W>
__device__ __forceinline__ void a_entries(const Raw<W>& st, Prep& pr,
                                          const float (&uk)[4], int len,
                                          int p) {
  const int kg = p & (kKeyGroups - 1), q = p >> 4, i0 = kg * 4;
  const int sa = q, sb = 14 - q, jb = 15 - q;   // column b from step jb
  float part[kC];
  float kw[4], kb[4];
  load4(&st.k[sa * kN + i0], kw);
  load4(&st.k[sb * kN + i0], kb);
  // branch-free, so that every step's loads can be issued early: at step
  // jb the running product restarts from k_sb
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    const int tt = j < jb ? q + 1 + j : j;
    float r4[4];
    load4(&st.r[tt * kN + i0], r4);
    if (j > 0) {
      float w4[4];
      load4(&st.w[(tt > 0 ? tt - 1 : 0) * kN + i0], w4);
#pragma unroll
      for (int x = 0; x < 4; ++x) kw[x] = j == jb ? kb[x] : kw[x] * w4[x];
    }
    part[j] = fmaf(r4[0], kw[0], r4[1] * kw[1])
              + fmaf(r4[2], kw[2], r4[3] * kw[3]);
  }
  reduce_half<8>(part, kg);
  reduce_half<4>(part, kg);
  reduce_half<2>(part, kg);
  reduce_half<1>(part, kg);
  {
    const int j = kg;
    const int tt = j < jb ? q + 1 + j : j;
    const int s = j < jb ? sa : sb;
    if (q < 7 || j < jb)
      pr.at[s * kAtStride + tt] = split2(tt < len ? part[0] : 0.f);
  }
  // the diagonal at t = 2q (lanes kg < 8 end with it) and 2q + 1
  float dg[2];
#pragma unroll
  for (int dd = 0; dd < 2; ++dd) {
    float r4[4], k4[4];
    load4(&st.r[(2 * q + dd) * kN + i0], r4);
    load4(&st.k[(2 * q + dd) * kN + i0], k4);
    dg[dd] = fmaf(r4[0] * uk[0], k4[0], r4[1] * uk[1] * k4[1])
             + fmaf(r4[2] * uk[2], k4[2], r4[3] * uk[3] * k4[3]);
  }
  const bool up = kg & 8;
  float dsum = (up ? dg[1] : dg[0])
               + __shfl_xor_sync(0xffffffffu, up ? dg[0] : dg[1], 8);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 4);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  if ((kg & 7) == 0) {
    const int tt = 2 * q + (up ? 1 : 0);
    pr.at[tt * kAtStride + tt] = split2(tt < len ? dsum : 0.f);
  }
}

// Waits for the state update's wgmma; its accumulators and A registers
// are the consumer's again.
__device__ __forceinline__ void state_wait(float (&st)[8][4],
                                           uint32_t (&va)[2][4]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_reg(st[n][e]);
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_reg(va[ks][e]);
}

// One consumer warp's chunk: its 16 value columns of the output and of
// the state. st[n][e] is S^T at value j0 + g + 8 (e >> 1), key 8 n + 2 cq
// + (e & 1).
__device__ __forceinline__ void consume(const Prep& pr, float (&st)[8][4],
                                        uint32_t (&va)[2][4],
                                        __nv_bfloat16* obuf,
                                        __nv_bfloat16* out, size_t row0,
                                        size_t step, int len, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;
  const int j0 = warp * 16;
  // v^T as the A operand (values x s), two k-steps of 8 steps
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const float* row0v = pr.vf + (8 * ks + cq) * kVStride + j0 + g;
    const float* row1v = row0v + 4 * kVStride;
    va[ks][0] = __float_as_uint(row0v[0]);
    va[ks][1] = __float_as_uint(row0v[8]);
    va[ks][2] = __float_as_uint(row1v[0]);
    va[ks][3] = __float_as_uint(row1v[8]);
  }
  // O^T at value j0 + g + 8 (e >> 1), step 8 m + 2 cq + (e & 1), in three
  // accumulators (shorter dependency chains), summed at the end
  float oa[2][4] = {}, ob[2][4] = {}, oc[2][4] = {};
  // intra-chunk part: O^T += v^T . A^T (A split)
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float2 a0 = pr.at[(8 * ks + cq) * kAtStride + 8 * m + g];
      const float2 a1 = pr.at[(8 * ks + cq + 4) * kAtStride + 8 * m + g];
      mma(oa[m], va[ks], a0.y, a1.y);
      mma(ob[m], va[ks], a0.x, a1.x);
    }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    // O^T += S_c^T . (r * P)^T over keys 8n..8n+7, k order (2cq, 2cq+1)
    uint32_t sh[4], sl[4];
    split(st[n][0], sh[0], sl[0]);
    split(st[n][2], sh[1], sl[1]);
    split(st[n][1], sh[2], sl[2]);
    split(st[n][3], sh[3], sl[3]);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float4 b = pr.rp[(8 * m + g) * kRpStride + 4 * n + cq];
      mma(oa[m], sl, b.x, b.z);
      mma(ob[m], sh, b.y, b.w);
      mma(oc[m], sh, b.x, b.z);
    }
    // S^T * D, keys 8n..8n+7, before the update accumulates onto it
    const float2 d2 = *reinterpret_cast<const float2*>(pr.d + 8 * n + 2 * cq);
    st[n][0] *= d2.x;
    st[n][1] *= d2.y;
    st[n][2] *= d2.x;
    st[n][3] *= d2.y;
  }
  // the warpgroup's whole S^T (64 values x 64 keys) += v^T . (k * Q) in 4
  // wgmma, each k-step of 8 steps two core matrices (256 bytes) along s;
  // it runs while the outputs go to shared memory
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_reg(st[n][e]);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    wgmma_m64n64k8(st, va[ks], wgmma_desc(pr.kqw[1] + ks * 64, 128, 512));
    wgmma_m64n64k8(st, va[ks], wgmma_desc(pr.kqw[0] + ks * 64, 128, 512));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  // the chunk's outputs through shared memory, one bf16 rounding
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      obuf[(8 * m + 2 * cq + (e & 1)) * kOStride + j0 + g + 8 * (e >> 1)] =
          __float2bfloat16_rn((oa[m][e] + ob[m][e]) + oc[m][e]);
  bar_sync(2, kWarpsC * 32);
  const int row = tid >> 3, seg = tid & 7;
  if (row < len)
    *reinterpret_cast<uint4*>(out + row0 + row * step + seg * 8) =
        *reinterpret_cast<const uint4*>(&obuf[row * kOStride + seg * 8]);
}

template <typename W>
__global__ void __launch_bounds__(kThreads, 2)
    wkv6_chunked_kernel(const __nv_bfloat16* __restrict__ r,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const W* __restrict__ w,
                        const float* __restrict__ u, const float* s_in,
                        __nv_bfloat16* out, float* s_out, int t, int h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<W>& sm = *reinterpret_cast<Smem<W>*>(smem_raw);

  const int bh = blockIdx.x;            // b * h + head
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int tid = threadIdx.x;
  const int nc = (t + kC - 1) / kC;
  const size_t step = static_cast<size_t>(h) * kN;   // elements per step
  const size_t base = static_cast<size_t>(bi) * t * step
                      + static_cast<size_t>(hi) * kN;
  const size_t state_off = static_cast<size_t>(bh) * kN * kN;

  if (tid >= kProd) {
    // ---- producer warpgroup: cp.async loads, A ---------------------------
    const int p = tid - kProd;
    // the zero upper triangle of A^T in both stages
    for (int e = p; e < 2 * kC * kC; e += kProd) {
      const int stg = e / (kC * kC), x = e - stg * kC * kC;
      const int s = x / kC, tt = x - s * kC;
      if (s > tt) sm.prep[stg].at[s * kAtStride + tt] = make_float2(0.f, 0.f);
    }
    float uk[4];
    {
      const int i0 = (p & (kKeyGroups - 1)) * 4;
#pragma unroll
      for (int x = 0; x < 4; ++x) uk[x] = u[hi * kN + i0 + x];
    }
#pragma unroll
    for (int c = 0; c < kRawStages; ++c)
      load_chunk(sm.raw[c], r, k, v, w, base, step, c, nc, t, p);
    cp_wait();
    bar_sync(1, kProd);               // chunk 0 has landed ...
    bar_arrive(3, 2 * kProd);         // ... for the consumers too
    a_entries(sm.raw[0], sm.prep[0], uk, min(kC, t), p);
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      if (c + 1 < nc) {
        // chunk c's raw tiles were used up in the last iteration
        load_chunk(sm.raw[c % kRawStages], r, k, v, w, base, step,
                   c + kRawStages, nc, t, p);
        cp_wait();
        bar_sync(1, kProd);           // chunk c + 1 has landed ...
        bar_arrive(3, 2 * kProd);     // ... for the consumers too
        a_entries(sm.raw[(c + 1) % kRawStages], sm.prep[(c + 1) & 1], uk,
                  min(kC, t - (c + 1) * kC), p);
      }
      __syncthreads();
    }
    return;
  }

  // ---- consumer warpgroup: the chunk, then the next one's decay products
  const int g = (tid & 31) >> 2, cq = tid & 3;
  const int j0 = (tid >> 5) * 16;       // this warp's value columns
  float st[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * n + 2 * cq + (e & 1);
      const int val = j0 + g + 8 * (e >> 1);
      st[n][e] = s_in ? s_in[state_off + key * kN + val] : 0.f;
    }
  bar_sync(3, 2 * kProd);             // chunk 0 has landed
  decay_products(sm.raw[0], sm.prep[0], min(kC, t), tid);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  for (int c = 0; c < nc; ++c) {
    uint32_t va[2][4];
    consume(sm.prep[c & 1], st, va, sm.obuf, out, base + c * kC * step, step,
            min(kC, t - c * kC), tid);
    // the state update runs on the tensor cores meanwhile
    if (c + 1 < nc) {
      bar_sync(3, 2 * kProd);         // chunk c + 1 has landed
      decay_products(sm.raw[(c + 1) % kRawStages], sm.prep[(c + 1) & 1],
                     min(kC, t - (c + 1) * kC), tid);
      // the state update's B tiles go to wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    state_wait(st, va);
    __syncthreads();
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * n + 2 * cq + (e & 1);
      const int val = j0 + g + 8 * (e >> 1);
      s_out[state_off + key * kN + val] = st[n][e];
    }
}

template <typename W>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s_in, void* out, float* s_out, int b,
           int t, int h, cudaStream_t stream) {
  constexpr int bytes = static_cast<int>(sizeof(Smem<W>));
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_chunked_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  wkv6_chunked_kernel<W><<<b * h, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(r),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const W*>(w), u, s_in,
      static_cast<__nv_bfloat16*>(out), s_out, t, h);
  return 0;
}

}  // namespace

// bf16 r, k, v, out (b, t, h, 64); w (b, t, h, 64) float32 (wdtype 0) or
// bf16 (1); u (h, 64) float32; s_in null (zero state) or (b, h, 64, 64)
// float32, possibly equal to s_out. t >= 1. Returns a CUDA error code, 0 if
// the launch was accepted.
extern "C" int rwkv6_scan_chunked(int wdtype, const void* r, const void* k,
                                  const void* v, const void* w, const void* u,
                                  const void* s_in, void* out, void* s_out,
                                  int b, int t, int h, void* stream) {
  if (b < 1 || h < 1 || t < 1 || b * h > 0x7fffffff / kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* si = static_cast<const float*>(s_in);
  float* so = static_cast<float*>(s_out);
  int err;
  if (wdtype == 0)
    err = launch<float>(r, k, v, w, uf, si, out, so, b, t, h, s);
  else if (wdtype == 1)
    err = launch<__nv_bfloat16>(r, k, v, w, uf, si, out, so, b, t, h, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
