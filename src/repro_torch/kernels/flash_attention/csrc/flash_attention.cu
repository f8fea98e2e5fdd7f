// Flash attention (causal / sliding-window / non-causal, GQA) for Hopper,
// sm_90a.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/flash_attention.py::_attn_kernel:
//
//     s   = (f32(q) * sm_scale) . f32(k)          masked to -1e30
//     m'  = max(m, rowmax(s));  p = exp(s - m'), 0 where masked
//     a   = exp(min(m - m', 0))
//     l'  = l * a + sum(p);  acc' = acc * a + p . f32(v)
//     out = acc / max(l, 1e-30)                   in q's type
//
// with the mask k_pos < kv_len, causal k_pos <= q_pos, window
// k_pos > q_pos - window, q_pos = q_offset + query index. A kv tile that
// no query of the block can see is skipped, so a decode step costs in
// proportion to its position, not to the cache's length; rows with no
// key to see come out 0.
//
// What bounds it: at the serving path's prefill (4 x 1024 queries, 16
// heads of 128) the work is ~17 GFLOP against ~67 MB, far above the
// card's ~295 operations per byte, so tensor-core throughput would be the
// bound; at decode (one query against the cache) it is the K/V bytes.
// This kernel uses no tensor cores: float32 FMAs on CUDA cores, K/V tiles
// staged through shared memory. bfloat16 prefill and decode at head_dim
// 64, 96 and 128 run on the tensor-core and split-kv kernels of
// flash_attention_hopper.cu instead (ops.py::plan); this one ("simt")
// serves float32, a bfloat16 q against a float32 cache, unaligned rows and
// head_dim 32.
//
// Design:
//  * Grid (query tiles, q-heads, batch). q-head h reads kv-head
//    h / (hq / hkv) through its strides: GQA without repeating K/V.
//  * q, k, v are read in their (b, s, h, d) layout through strides (unit
//    stride along d); the output is written in the same layout.
//  * 256 threads = 64 slots of 4 threads. A slot owns one query row and
//    a share of each kv tile; each of its 4 threads owns d/4 of the
//    head's dims (float4 chunks c*16 + sub*4), so a score is 4 partial
//    dot products summed by two xor-shuffles, the same in all 4 threads.
//  * P = 1 (prefill): 64 query rows per block, each slot sees every kv
//    row of a tile, in chunks of 8 (one online-softmax update a chunk).
//    P = 64 (a single query row, decode): the 64 slots split each kv
//    tile row by row, each with its own (m, l, acc), merged at the end.
//  * K and V tiles of 64 rows are converted to float32 once, as they are
//    staged; rows are padded by 16 floats so that the two rows a quarter
//    warp reads in decode lie in different banks.
//  * Templates on head_dim (32, 64, 96, 128) and, separately, on the type
//    of q and of k/v (float32, bfloat16): an f32 cache with a bf16 model
//    is read as it is, nothing is cast in device memory.
// The kernel runs on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTPR = 4;                   // threads per slot
constexpr int kSlots = kThreads / kTPR;   // 64
constexpr int kBKV = 64;                  // kv rows per shared-memory tile
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, sq, skv, hq, hkv;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int q_offset, causal, window, vec;
  float sm_scale;
  float* lse;   // (b, hq, sq) or null
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T from a row that is not 16-byte aligned, packed as one
// vector load would have read them.
__device__ __forceinline__ uint4 load16_scalar(const float* p) {
  return make_uint4(__float_as_uint(p[0]), __float_as_uint(p[1]),
                    __float_as_uint(p[2]), __float_as_uint(p[3]));
}
__device__ __forceinline__ uint4 load16_scalar(const __nv_bfloat16* p) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  return make_uint4(u[0] | (unsigned(u[1]) << 16), u[2] | (unsigned(u[3]) << 16),
                    u[4] | (unsigned(u[5]) << 16), u[6] | (unsigned(u[7]) << 16));
}

// Store 16 bytes of T as float32 at dst (16-byte aligned).
__device__ __forceinline__ void store_f32(float* dst, uint4 raw, float) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                  __uint_as_float(raw.z), __uint_as_float(raw.w));
}
__device__ __forceinline__ void store_f32(float* dst, uint4 raw,
                                          __nv_bfloat16) {
  // a bfloat16 is the high half of the float32 it stands for
  *reinterpret_cast<float4*>(dst) = make_float4(
      __uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
      __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
  *reinterpret_cast<float4*>(dst + 4) = make_float4(
      __uint_as_float(raw.z << 16), __uint_as_float(raw.z & 0xffff0000u),
      __uint_as_float(raw.w << 16), __uint_as_float(raw.w & 0xffff0000u));
}

// Stage kv rows [kt, kt + kBKV) of one head of K and of V into shared
// memory as float32, row stride LD floats; rows at or past skv read 0.
// vec: every row start is 16-byte aligned, so rows are read as 16-byte
// vectors. Every load of the tile is issued before the first is stored.
template <int D, int LD, typename T>
__device__ __forceinline__ void stage_tiles(float* ks, float* vs,
                                            const T* kp, const T* vp,
                                            int64_t k_ss, int64_t v_ss,
                                            int kt, int skv, bool vec) {
  constexpr int EPV = 16 / sizeof(T);   // elements per 16-byte vector
  constexpr int VPR = D / EPV;          // vectors per row
  constexpr int TOTAL = kBKV * VPR;
  constexpr int ITERS = (TOTAL + kThreads - 1) / kThreads;
  uint4 kraw[ITERS], vraw[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int row = kt + i / VPR, c = (i % VPR) * EPV;
    kraw[it] = vraw[it] = make_uint4(0u, 0u, 0u, 0u);   // 0.0 in both types
    if (i < TOTAL && row < skv) {
      const T* kr = kp + row * k_ss + c;
      const T* vr = vp + row * v_ss + c;
      if (vec) {
        kraw[it] = *reinterpret_cast<const uint4*>(kr);
        vraw[it] = *reinterpret_cast<const uint4*>(vr);
      } else {
        kraw[it] = load16_scalar(kr);
        vraw[it] = load16_scalar(vr);
      }
    }
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = it * kThreads + threadIdx.x;
    if (i >= TOTAL) continue;
    const int r = i / VPR, c = (i % VPR) * EPV;
    store_f32(ks + r * LD + c, kraw[it], T());
    store_f32(vs + r * LD + c, vraw[it], T());
  }
}

template <int D, int P, typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) attn_kernel(const Params prm) {
  constexpr int RB = kSlots / P;          // query rows per block
  constexpr int DT = D / kTPR;            // dims per thread
  constexpr int NC = DT / 4;              // float4 chunks per thread
  constexpr int LD = D + 16;              // padded shared-memory row
  constexpr int RPS = kBKV / P;           // kv rows per slot per tile
  constexpr int CH = RPS < 8 ? RPS : 8;   // kv rows per softmax update
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kBKV * LD;

  const int tid = threadIdx.x;
  const int slot = tid / kTPR, sub = tid % kTPR;
  const int r = slot % RB, part = slot / RB;
  const int q0 = blockIdx.x * RB;
  const int qi = q0 + r;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (prm.hq / prm.hkv);
  const bool row_ok = qi < prm.sq;
  const int q_pos = prm.q_offset + qi;
  const int kv_len = prm.skv;

  const TQ* qp = static_cast<const TQ*>(prm.q) + bi * prm.q_sb +
                 int64_t(row_ok ? qi : 0) * prm.q_ss + h * prm.q_sh;
  const TKV* kp = static_cast<const TKV*>(prm.k) + bi * prm.k_sb +
                  g * prm.k_sh;
  const TKV* vp = static_cast<const TKV*>(prm.v) + bi * prm.v_sb +
                  g * prm.v_sh;

  // this thread's dims: c * 16 + sub * 4 + e
  float q[DT], acc[DT];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = row_ok ? to_f32(qp[c * 16 + sub * 4 + e]) : 0.0f;
      q[c * 4 + e] = x * prm.sm_scale;
      acc[c * 4 + e] = 0.0f;
    }
  }
  float m = kNegInf, l = 0.0f;

  // query positions of the block, for skipping tiles nobody can see
  const int qmin = prm.q_offset + q0;
  const int qmax = prm.q_offset + min(q0 + RB, prm.sq) - 1;
  for (int kt = 0; kt < prm.skv; kt += kBKV) {
    if (prm.causal && kt > qmax) break;
    if (prm.window > 0 && kt + kBKV - 1 <= qmin - prm.window) continue;
    __syncthreads();   // the previous tile is consumed
    stage_tiles<D, LD, TKV>(ks, vs, kp, vp, prm.k_ss, prm.v_ss, kt, prm.skv,
                            prm.vec != 0);
    __syncthreads();
#pragma unroll 1
    for (int i0 = 0; i0 < RPS; i0 += CH) {
      float s[CH];
      bool ok[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int j = part + P * (i0 + c);
        const float* kr = ks + j * LD + sub * 4;
        float dot = 0.0f;
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + u * 16);
          dot = fmaf(q[u * 4], kk.x, dot);
          dot = fmaf(q[u * 4 + 1], kk.y, dot);
          dot = fmaf(q[u * 4 + 2], kk.z, dot);
          dot = fmaf(q[u * 4 + 3], kk.w, dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const int kpos = kt + j;
        bool valid = kpos < kv_len;
        if (prm.causal) valid = valid && kpos <= q_pos;
        if (prm.window > 0) valid = valid && kpos > q_pos - prm.window;
        ok[c] = valid;
        s[c] = valid ? dot : kNegInf;
      }
      float mx = m;
#pragma unroll
      for (int c = 0; c < CH; ++c) mx = fmaxf(mx, s[c]);
      const float alpha = expf(fminf(m - mx, 0.0f));
      float p[CH];
      float psum = 0.0f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        p[c] = ok[c] ? expf(s[c] - mx) : 0.0f;
        psum += p[c];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int d = 0; d < DT; ++d) acc[d] *= alpha;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int j = part + P * (i0 + c);
        const float* vr = vs + j * LD + sub * 4;
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + u * 16);
          acc[u * 4] = fmaf(p[c], vv.x, acc[u * 4]);
          acc[u * 4 + 1] = fmaf(p[c], vv.y, acc[u * 4 + 1]);
          acc[u * 4 + 2] = fmaf(p[c], vv.z, acc[u * 4 + 2]);
          acc[u * 4 + 3] = fmaf(p[c], vv.w, acc[u * 4 + 3]);
        }
      }
      m = mx;
    }
  }

  TQ* op = static_cast<TQ*>(prm.o) + bi * prm.o_sb + h * prm.o_sh;
  const int64_t lse_at = (int64_t(bi) * prm.hq + h) * prm.sq;
  if (P == 1) {
    if (row_ok) {
      const float den = fmaxf(l, 1e-30f);
      if (prm.lse != nullptr && sub == 0)
        prm.lse[lse_at + qi] = m + logf(den);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          op[int64_t(qi) * prm.o_ss + c * 16 + sub * 4 + e] =
              from_f32<TQ>(acc[c * 4 + e] / den);
    }
    return;
  }
  // P > 1: merge the partitions' (m, l, acc) of each query row
  __syncthreads();
  float* st = ks;                      // [kSlots][D] partial accumulators
  float* sm = ks + kSlots * D;         // [kSlots] running maxima
  float* sl = sm + kSlots;             // [kSlots] running sums
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[slot * D + c * 16 + sub * 4 + e] = acc[c * 4 + e];
  if (sub == 0) {
    sm[slot] = m;
    sl[slot] = l;
  }
  __syncthreads();
  for (int idx = tid; idx < RB * D; idx += kThreads) {
    const int rr = idx / D, d = idx % D;
    if (q0 + rr >= prm.sq) continue;
    float mm = kNegInf;
    for (int pp = 0; pp < P; ++pp) mm = fmaxf(mm, sm[pp * RB + rr]);
    float ll = 0.0f, aa = 0.0f;
    for (int pp = 0; pp < P; ++pp) {
      const int s2 = pp * RB + rr;
      const float w = expf(fminf(sm[s2] - mm, 0.0f));
      ll = fmaf(sl[s2], w, ll);
      aa = fmaf(st[s2 * D + d], w, aa);
    }
    if (prm.lse != nullptr && d == 0)
      prm.lse[lse_at + q0 + rr] = mm + logf(fmaxf(ll, 1e-30f));
    op[int64_t(q0 + rr) * prm.o_ss + d] = from_f32<TQ>(aa / fmaxf(ll, 1e-30f));
  }
}

template <int D, int P, typename TQ, typename TKV>
int launch(const Params& prm, cudaStream_t stream) {
  constexpr int RB = kSlots / P;
  const size_t smem = 2 * kBKV * (D + 16) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<D, P, TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((prm.sq + RB - 1) / RB, prm.hq, prm.b);
  attn_kernel<D, P, TQ, TKV><<<grid, kThreads, smem, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename TQ, typename TKV>
int by_rows(const Params& prm, cudaStream_t s) {
  // a single query row (decode): split each kv tile over the 64 slots
  return prm.sq == 1 ? launch<D, 64, TQ, TKV>(prm, s)
                     : launch<D, 1, TQ, TKV>(prm, s);
}

template <typename TQ, typename TKV>
int by_dim(int d, const Params& prm, cudaStream_t s) {
  switch (d) {
    case 32: return by_rows<32, TQ, TKV>(prm, s);
    case 64: return by_rows<64, TQ, TKV>(prm, s);
    case 96: return by_rows<96, TQ, TKV>(prm, s);
    case 128: return by_rows<128, TQ, TKV>(prm, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_dtype, kv_dtype: 0 = float32, 1 = bfloat16 (k and v share one type; the
// output has q's). Shapes q (b, sq, hq, d), k/v (b, skv, hkv, d), o (b, sq,
// hq, d); strides (*_sb, *_ss, *_sh) in elements for the batch, sequence and
// head axes, unit stride along d. kv_len = skv. vec = 1: every k/v row start
// is 16-byte aligned. lse: null, or float32 (b, hq, sq) that receives each
// row's log-sum-exp of its scaled scores, m + log(max(l, 1e-30)), which the
// backward (flash_attention_bwd.cu) reads. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int flash_attention(
    int q_dtype, int kv_dtype, int head_dim, const void* q, const void* k,
    const void* v, void* o, int b, int sq, int skv, int hq, int hkv,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
    int64_t o_ss, int64_t o_sh, int q_offset, int causal, int window,
    float sm_scale, int vec, float* lse, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || hq < 1 || hkv < 1 || hq % hkv ||
      b > 65535 || hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params prm{q,    k,    v,    o,    b,    sq,       skv,    hq,
                   hkv,  q_sb, q_ss, q_sh, k_sb, k_ss,     k_sh,   v_sb,
                   v_ss, v_sh, o_sb, o_ss, o_sh, q_offset, causal, window,
                   vec,  sm_scale, lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return by_dim<float, float>(head_dim, prm, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return by_dim<float, __nv_bfloat16>(head_dim, prm, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return by_dim<__nv_bfloat16, float>(head_dim, prm, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_dim<__nv_bfloat16, __nv_bfloat16>(head_dim, prm, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
