// What the selective scan's ring kernels (csrc/mamba_scan_hopper.cu and
// csrc/mamba_scan_bwd_hopper.cu) share: the snapshot cadence, the state
// step, whose expression the backward repeats so that its recomputed
// states are the forward's bit for bit, the cp.async ring's copies, and
// the type conversions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mamba_ring {

constexpr int kN = 16;            // state size
constexpr int kEvery = 8;         // steps between snapshots
constexpr float kLog2e = 1.44269504088896340736f;
constexpr float kLn2 = 0.693147180559945309417f;

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

// A's entry pre-scaled once a channel: exp(dt A) = 2^(dt A log2 e)
__device__ __forceinline__ float scaled_a(float a) {
  return __fmul_rn(a, kLog2e);
}

// a_t = exp(dt_t A): one multiply and one MUFU.EX2 (ex2.approx.ftz: about
// 2 ulp; a result below 2^-126 flushes to 0)
__device__ __forceinline__ float decay(float dtv, float a2) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(__fmul_rn(dtv, a2)));
  return y;
}

// h_t = a_t h_{t-1} + u_t B_t: u B rounded on its own (no contraction),
// then one fused multiply-add
__device__ __forceinline__ float state_step(float an, float h, float u,
                                            float bn) {
  return fmaf(an, h, __fmul_rn(u, bn));
}

// 16 bytes from global to shared memory, asynchronously (L2 only)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's newest groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace mamba_ring
