// Fused MoE routing for Hopper, sm_90a: softmax over experts, top-k,
// renormalised gates, per-expert load statistics.
//
// Replaces the Pallas TPU kernel
// repro/kernels/moe_router/moe_router.py::_router_kernel:
//
//     p       = softmax(f32(logits))            per token row
//     k times: g = max(work); a = argmax(work) (lowest index on ties);
//              work[a] = -1e30; gates[j] = T(g); idx[j] = a; gsum += g
//     renormalise: gates[j] = T(f32(gates[j]) / max(gsum, 1e-20))
//     stats[block] = (sum of p, count of selections) over the block's rows
//
// What bounds it: bytes. A token reads E logits and writes 2k values for
// a few hundred operations; at the serving path's prefill (4096 x 64) that
// is ~1.2 MB, a fraction of a microsecond at the card's memory rate, so
// launch latency dominates. The design keeps every intermediate (the
// probabilities, the k-hot mask) in registers:
//  * one warp per token row; E <= 64, so lane i holds experts i and i+32;
//  * max and sum by xor-shuffle butterflies (the sum in a fixed order that
//    the plain version repeats, so both give the same probabilities);
//    expf and IEEE division (no __expf), as the plain version rounds;
//  * k rounds of warp arg-max, ties to the lower expert index as
//    jnp.argmax and lax.top_k break them;
//  * per-block partial statistics (blocks, 2, E): each lane sums its
//    experts over its warp's rows in order, then one thread per expert sums
//    the warps in order. The wrapper sums the blocks. No float atomics, so
//    the statistics do not depend on scheduling.
// The kernel runs on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;   // short: a row is a chain of shuffles
constexpr int kBlockTokens = kWarps * kRowsPerWarp;   // BLOCK_TOKENS in ops.py
constexpr int kMaxExperts = 64;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

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

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    router_kernel(const T* __restrict__ logits, T* __restrict__ gates,
                  int* __restrict__ idx, float* __restrict__ stats,
                  int64_t ld, int t, int e, int k, int renorm) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool has0 = lane < e, has1 = lane + 32 < e;
  float psum0 = 0.0f, psum1 = 0.0f, cnt0 = 0.0f, cnt1 = 0.0f;
  const int first = blockIdx.x * kBlockTokens + warp * kRowsPerWarp;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = first + rr;
    if (row >= t) break;                         // the same in the warp
    const T* x = logits + row * ld;
    const float x0 = has0 ? to_f32(x[lane]) : neg_inf();
    const float x1 = has1 ? to_f32(x[lane + 32]) : neg_inf();
    float mx = fmaxf(x0, x1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    float p0 = has0 ? expf(x0 - mx) : 0.0f;
    float p1 = has1 ? expf(x1 - mx) : 0.0f;
    float sum = p0 + p1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
    p0 = __fdiv_rn(p0, sum);
    p1 = __fdiv_rn(p1, sum);
    psum0 += p0;
    psum1 += p1;
    float w0 = has0 ? p0 : neg_inf(), w1 = has1 ? p1 : neg_inf();
    float gsum = 0.0f, g_lo = 0.0f, g_hi = 0.0f;   // lane j holds g_j, g_{j+32}
    for (int j = 0; j < k; ++j) {
      float bv = w0;
      int bi = lane;
      if (w1 > w0) {
        bv = w1;
        bi = lane + 32;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, o);
        const int oi = __shfl_xor_sync(kFull, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      gsum += bv;
      if (bi == lane) {
        w0 = kNegInf;
        cnt0 += 1.0f;
      } else if (bi == lane + 32) {
        w1 = kNegInf;
        cnt1 += 1.0f;
      }
      if (lane == (j & 31)) {
        if (j < 32)
          g_lo = bv;
        else
          g_hi = bv;
      }
      if (lane == 0) idx[int64_t(row) * k + j] = bi;
    }
    const float den = fmaxf(gsum, 1e-20f);
    T* gr = gates + int64_t(row) * k;
    if (lane < k) {
      const T g = from_f32<T>(g_lo);
      gr[lane] = renorm ? from_f32<T>(__fdiv_rn(to_f32(g), den)) : g;
    }
    if (lane + 32 < k) {
      const T g = from_f32<T>(g_hi);
      gr[lane + 32] = renorm ? from_f32<T>(__fdiv_rn(to_f32(g), den)) : g;
    }
  }
  __shared__ float sp[kWarps][kMaxExperts], sc[kWarps][kMaxExperts];
  sp[warp][lane] = psum0;
  sp[warp][lane + 32] = psum1;
  sc[warp][lane] = cnt0;
  sc[warp][lane + 32] = cnt1;
  __syncthreads();
  if (threadIdx.x < e) {
    float a = 0.0f, c = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += sp[w][threadIdx.x];
      c += sc[w][threadIdx.x];
    }
    float* st = stats + int64_t(blockIdx.x) * 2 * e;
    st[threadIdx.x] = a;
    st[e + threadIdx.x] = c;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (logits and gates). logits (t, e) with
// row stride ld (elements), unit stride along experts; gates and idx (t, k)
// contiguous; stats (ceil(t / 16), 2, e) float32. 1 <= k <= e <= 64.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int moe_router(int dtype, const void* logits, void* gates,
                          void* idx, void* stats, int64_t ld, int t, int e,
                          int k, int renorm, void* stream) {
  if (t < 1 || e < 1 || e > kMaxExperts || k < 1 || k > e)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (t + kBlockTokens - 1) / kBlockTokens;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    router_kernel<float><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const float*>(logits), static_cast<float*>(gates),
        static_cast<int*>(idx), static_cast<float*>(stats), ld, t, e, k,
        renorm);
  else if (dtype == 1)
    router_kernel<__nv_bfloat16><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits),
        static_cast<__nv_bfloat16*>(gates), static_cast<int*>(idx),
        static_cast<float*>(stats), ld, t, e, k, renorm);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
