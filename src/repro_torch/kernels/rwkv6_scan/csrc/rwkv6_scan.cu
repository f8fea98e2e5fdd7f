// RWKV-6 (Finch) WKV recurrence for Hopper, sm_90a: the scan over time with
// a data-dependent decay, per (batch, head), state S in R^{n x n} (key index
// i x value index j):
//
//     out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j]  = w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// and the final state. Replaces the Pallas TPU kernel
// repro/kernels/rwkv6_scan/rwkv6_scan.py::_wkv6_kernel, whose sequential
// grid over time chunks carries S in VMEM scratch and pads the last chunk.
//
// What bounds it: at the serving prefill (b, t, h, n) = (4, 1024, 64, 64),
// bf16 r/k/v/out, f32 w, the function moves ~210 MB (63 us at 3.35 TB/s) and
// needs 5 float32 operations per state element and step, 5.4 GFLOP (80 us
// at 67 TFLOP/s): operations. The 5 fold the bonus into one dot product a
// step, out_t = r_t.S + (sum_i r_i u_i k_i) v_t: r.S is one FMA, and
// S <- w S + k v^T one multiply and one FMA. This kernel does 7 (a multiply
// for k v and three FMAs: u k v + S, r (...), w S + k v). A decode step
// (t = 1) only reads and writes the state, 8.4 MB: bytes (2.6 us). Beyond
// both, the 1,024 steps are a serial chain inside each (batch, head).
//
// The design, a simple one first:
//  * value columns are independent (out[j] and S[:, j] need column j only),
//    the sum runs over the key index. One block per (batch, head) of n x KS
//    threads: each thread owns one column j and n / KS of its keys, holding
//    those state entries (and u) in registers for the whole scan; the KS
//    lanes of a column are neighbours in a warp and sum their partial
//    outputs by xor-shuffles. KS = 4 puts 4x the warps of one thread per
//    column in flight, to hide the shared-memory and FMA latencies.
//  * a thread's keys are 4-runs strided by 4 * KS, so the KS lanes of a
//    column read distinct banks when they load r, k, w as float4.
//  * time in tiles of kTile steps: r, k, v, w of a tile are staged into
//    shared memory (as float32) with coalesced loads, the steps run from
//    there, and the tile's outputs are staged and written back coalesced.
//    The loop stops at t exactly: no padding (the Pallas kernel's padded
//    steps, w = 1 and k = v = 0, leave S as it is).
//  * types: r, k, v and out share one type T (float32 or bfloat16); w has
//    its own W and is converted to float32 as it is, never rounded to
//    bf16; u and the state are float32. The state may be read and written
//    in place (s_out == s_in): each block reads its own (batch, head) slice
//    before it writes it, and no other block touches that slice.
// The kernel runs on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;         // time steps staged in shared memory
constexpr int kSplit = 4;         // threads per value column (key split)
constexpr unsigned kFull = 0xffffffffu;

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

template <int N, typename T, typename W>
__global__ void __launch_bounds__(N * kSplit)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const W* __restrict__ w,
                const float* __restrict__ u, const float* s_in, T* out,
                float* s_out, int t, int h) {
  constexpr int kThreads = N * kSplit;
  constexpr int kPer = N / kSplit;        // keys per thread
  constexpr int kQuads = kPer / 4;        // float4 runs per thread
  static_assert(kPer % 4 == 0, "head size must be a multiple of 16");

  __shared__ __align__(16) float r_s[kTile][N];
  __shared__ __align__(16) float k_s[kTile][N];
  __shared__ __align__(16) float w_s[kTile][N];
  __shared__ float v_s[kTile][N];
  __shared__ float o_s[kTile][N];

  const int bh = blockIdx.x;              // b * h + head
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int tid = threadIdx.x;
  const int j = tid / kSplit;             // value column
  const int g = tid - j * kSplit;         // key group

  // key of entry (q, c) of this thread: (q * kSplit + g) * 4 + c
  float s[kPer], uu[kPer];
  const size_t state_off = static_cast<size_t>(bh) * N * N;
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = (q * kSplit + g) * 4 + c;
      s[q * 4 + c] = s_in ? s_in[state_off + i * N + j] : 0.f;
      uu[q * 4 + c] = u[hi * N + i];
    }
  }

  const size_t step = static_cast<size_t>(h) * N;   // elements per step
  const size_t base = static_cast<size_t>(bi) * t * step
                      + static_cast<size_t>(hi) * N;
  for (int t0 = 0; t0 < t; t0 += kTile) {
    const int len = min(kTile, t - t0);
    for (int e = tid; e < len * N; e += kThreads) {
      const int tt = e / N;
      const int i = e - tt * N;
      const size_t off = base + static_cast<size_t>(t0 + tt) * step + i;
      r_s[tt][i] = to_f32(r[off]);
      k_s[tt][i] = to_f32(k[off]);
      v_s[tt][i] = to_f32(v[off]);
      w_s[tt][i] = to_f32(w[off]);
    }
    __syncthreads();
    for (int tt = 0; tt < len; ++tt) {
      const float vj = v_s[tt][j];
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const int i0 = (q * kSplit + g) * 4;
        const float4 r4 = *reinterpret_cast<const float4*>(&r_s[tt][i0]);
        const float4 k4 = *reinterpret_cast<const float4*>(&k_s[tt][i0]);
        const float4 w4 = *reinterpret_cast<const float4*>(&w_s[tt][i0]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int e = q * 4 + c;
          const float kv = kk[c] * vj;
          acc = fmaf(rr[c], fmaf(uu[e], kv, s[e]), acc);
          s[e] = fmaf(ww[c], s[e], kv);
        }
      }
#pragma unroll
      for (int m = 1; m < kSplit; m <<= 1)
        acc += __shfl_xor_sync(kFull, acc, m);
      if (g == 0) o_s[tt][j] = acc;
    }
    __syncthreads();
    for (int e = tid; e < len * N; e += kThreads) {
      const int tt = e / N;
      const int i = e - tt * N;
      out[base + static_cast<size_t>(t0 + tt) * step + i] =
          from_f32<T>(o_s[tt][i]);
    }
    // the next tile's staging writes r_s..w_s, read above before the
    // barrier; o_s is rewritten only after the next tile's barrier
  }

#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = (q * kSplit + g) * 4 + c;
      s_out[state_off + i * N + j] = s[q * 4 + c];
    }
  }
}

template <int N, typename T, typename W>
void launch_n(const void* r, const void* k, const void* v, const void* w,
              const float* u, const float* s_in, void* out, float* s_out,
              int b, int t, int h, cudaStream_t stream) {
  wkv6_kernel<N, T, W><<<b * h, N * kSplit, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const W*>(w), u, s_in,
      static_cast<T*>(out), s_out, t, h);
}

template <typename T, typename W>
int launch_typed(int n, const void* r, const void* k, const void* v,
                 const void* w, const float* u, const float* s_in, void* out,
                 float* s_out, int b, int t, int h, cudaStream_t stream) {
  if (n == 16)
    launch_n<16, T, W>(r, k, v, w, u, s_in, out, s_out, b, t, h, stream);
  else if (n == 32)
    launch_n<32, T, W>(r, k, v, w, u, s_in, out, s_out, b, t, h, stream);
  else if (n == 64)
    launch_n<64, T, W>(r, k, v, w, u, s_in, out, s_out, b, t, h, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// dtype / wdtype: 0 float32, 1 bfloat16 (r, k, v, out / w). s_in may be
// null (zero state) or equal to s_out. Returns a CUDA error code, 0 if the
// launch was accepted.
extern "C" int rwkv6_scan(int dtype, int wdtype, int n, const void* r,
                          const void* k, const void* v, const void* w,
                          const void* u, const void* s_in, void* out,
                          void* s_out, int b, int t, int h, void* stream) {
  if (b < 1 || h < 1 || t < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* si = static_cast<const float*>(s_in);
  float* so = static_cast<float*>(s_out);
  int err;
  if (dtype == 0 && wdtype == 0)
    err = launch_typed<float, float>(n, r, k, v, w, uf, si, out, so, b, t, h,
                                     s);
  else if (dtype == 1 && wdtype == 0)
    err = launch_typed<__nv_bfloat16, float>(n, r, k, v, w, uf, si, out, so,
                                             b, t, h, s);
  else if (dtype == 0 && wdtype == 1)
    err = launch_typed<float, __nv_bfloat16>(n, r, k, v, w, uf, si, out, so,
                                             b, t, h, s);
  else if (dtype == 1 && wdtype == 1)
    err = launch_typed<__nv_bfloat16, __nv_bfloat16>(n, r, k, v, w, uf, si,
                                                     out, so, b, t, h, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
