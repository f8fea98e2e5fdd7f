// Mamba's selective scan for Hopper, sm_90a, variant "simt" (the shapes the
// ring kernel, csrc/mamba_scan_hopper.cu, does not take: d_in not a
// multiple of 128): per (batch, channel d), with a float32 state of N = 16
// elements,
//
//     a_t = exp(dt_t A[d]),  u_t = f32(dt_t) f32(x_t)
//     h_t = a_t h_{t-1} + u_t B_t,   y_t = sum_n C_t[n] h_t[n]
//
// y rounded to the activation type once a step, and the final state. Under
// a gradient it also writes the state at the start of every 32-step segment
// (the snapshots the backward, csrc/mamba_scan_bwd.cu, recomputes from).
// It replaces no Pallas kernel: the reference runs the scan as an XLA
// lax.scan of 16 unrolled steps a chunk (repro/models/mamba.py:124), and
// the port ran it as torch ops, one in-place multiply-add a step (about
// 25 ms a layer at Jamba's prefill on an H100).
//
// What bounds it: at Jamba's (b, s, d_in, N) = (4, 1,024, 16,384, 16) in
// bf16 it reads xc, dt, B, C, A and writes y and the final state, 408.2
// MB (121.9 us at 3.35 TB/s; 134.2 MB more with the snapshots), but it
// takes b s d_in N = 1.07e9 exponentials, which the special-function units
// issue at 16 a clock per SM: 0.26 ms at 132 SMs and 1.98 GHz.
// Exponentials, then. The multiply-adds (three an element-step) and expf's
// own range reduction issue on the FMA pipes beside them.
//
// The design, a simple one first:
//  * one thread per (batch, channel): its N = 16 states and A's row in
//    registers for the whole scan; no reduction across threads (y sums over
//    the thread's own states). A CTA is 128 channels of one batch row, so
//    the loads of xc, dt and the stores of y are coalesced along d.
//  * B_t and C_t, shared by every channel of a batch row, are staged in
//    shared memory (as float32) 32 steps at a time and read as broadcasts.
//    B and C are read through their (batch, step) strides: the views of
//    x_proj's output the mixer splits, never copied. dt and x are loaded
//    8 steps at a time ahead of their use; y sums even and odd n apart
//    (two chains of 8 multiply-adds, not one of 16).
//  * the accurate expf (as torch.exp), and dt * A, u * B rounded as the
//    plain version rounds them (__fmul_rn: no contraction into an FMA);
//    h_t = fmaf(a_t, h_{t-1}, u_t B_t). The backward recomputes states with
//    the same expression, so its states are this kernel's bit for bit.
// The kernel runs on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kN = 16;            // state size
constexpr int kThreads = 128;     // channels a CTA
constexpr int kSeg = 32;          // steps a segment: staging, snapshots
constexpr int kPre = 8;           // steps whose dt and x are loaded at once

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
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      long long bc_sb, long long bc_st,
                      const float* __restrict__ A,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ h_out, float* __restrict__ snaps,
                      int s, int d_in) {
  __shared__ float bc[kSeg][2 * kN];      // a step's B (0..15), C (16..31)
  const int bi = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < d_in;
  const int nseg = (s + kSeg - 1) / kSeg;
  const size_t row = static_cast<size_t>(bi) * d_in + d;   // (b, d)
  float a[kN], h[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a[n] = live ? A[static_cast<size_t>(d) * kN + n] : 0.f;
    h[n] = (live && h0) ? h0[row * kN + n] : 0.f;
  }
  const size_t base = static_cast<size_t>(bi) * s * d_in + d;
  for (int seg = 0; seg < nseg; ++seg) {
    const int t0 = seg * kSeg;
    const int len = min(kSeg, s - t0);
    __syncthreads();                      // the last segment's reads done
    for (int i = threadIdx.x; i < len * 2 * kN; i += kThreads) {
      const int j = i / (2 * kN), c = i % (2 * kN);
      const T* src = (c < kN ? bm : cm) + bi * bc_sb + (t0 + j) * bc_st
                     + (c % kN);
      bc[j][c] = to_f32(*src);
    }
    __syncthreads();
    if (!live) continue;
    if (snaps) {
      float4* dst = reinterpret_cast<float4*>(
          snaps + ((static_cast<size_t>(bi) * nseg + seg) * d_in + d) * kN);
#pragma unroll
      for (int q = 0; q < kN / 4; ++q)
        dst[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2],
                             h[4 * q + 3]);
    }
    // kPre steps at a time: their dt and x loaded first, then computed
    for (int j0 = 0; j0 < len; j0 += kPre) {
      float dtw[kPre], xw[kPre];
#pragma unroll
      for (int i = 0; i < kPre; ++i) {
        const size_t off = base + static_cast<size_t>(t0 + j0 + i) * d_in;
        dtw[i] = j0 + i < len ? to_f32(dt[off]) : 0.f;
        xw[i] = j0 + i < len ? to_f32(x[off]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kPre; ++i) {
        if (j0 + i >= len) break;
        const float* bt = bc[j0 + i];
        const float u = __fmul_rn(dtw[i], xw[i]);
        float acc0 = 0.f, acc1 = 0.f;      // y over even and odd n
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const float an = expf(__fmul_rn(dtw[i], a[n]));
          h[n] = fmaf(an, h[n], __fmul_rn(u, bt[n]));
          if (n % 2)
            acc1 = fmaf(h[n], bt[kN + n], acc1);
          else
            acc0 = fmaf(h[n], bt[kN + n], acc0);
        }
        y[base + static_cast<size_t>(t0 + j0 + i) * d_in] =
            from_f32<T>(acc0 + acc1);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < kN; ++n) h_out[row * kN + n] = h[n];
  }
}

template <typename T>
int launch_typed(const void* x, const void* dt, const void* bm,
                 const void* cm, long long bc_sb, long long bc_st,
                 const float* A, const float* h0, void* y, float* h_out,
                 float* snaps, int b, int s, int d_in, cudaStream_t stream) {
  dim3 grid((d_in + kThreads - 1) / kThreads, b);
  mamba_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm), bc_sb, bc_st, A,
      h0, static_cast<T*>(y), h_out, snaps, s, d_in);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, dt, B, C and y). B and C are read at
// element (b, t, n) = b * bc_sb + t * bc_st + n. h0 may be null (a zero
// state), snaps null (no snapshots; else (b, ceil(s / 32), d_in, 16)
// float32). Returns a CUDA error code, 0 if the launch was accepted.
extern "C" int mamba_scan(int dtype, const void* x, const void* dt,
                          const void* bm, const void* cm, long long bc_sb,
                          long long bc_st, const void* A, const void* h0,
                          void* y, void* h_out, void* snaps, int b, int s,
                          int d_in, void* stream) {
  if (b < 1 || s < 1 || d_in < 1 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(A);
  const float* hf = static_cast<const float*>(h0);
  float* ho = static_cast<float*>(h_out);
  float* sn = static_cast<float*>(snaps);
  if (dtype == 0)
    return launch_typed<float>(x, dt, bm, cm, bc_sb, bc_st, af, hf, y, ho,
                               sn, b, s, d_in, st);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(x, dt, bm, cm, bc_sb, bc_st, af, hf,
                                       y, ho, sn, b, s, d_in, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
