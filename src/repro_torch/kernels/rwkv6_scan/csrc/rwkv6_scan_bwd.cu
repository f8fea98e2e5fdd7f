// The RWKV-6 (Finch) WKV recurrence's backward for Hopper, sm_90a. Per
// (batch, head), with head size n, state S (key index i x value index j),
//
//     out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1}
//                                                         + k_t v_t^T,
//
// and dS the cotangent of S_t (at t = T - 1 the final state's):
//
//     dr_t = S_{t-1} dout_t + u * k_t (v_t . dout_t)
//     dk_t = dS_t v_t + u * r_t (v_t . dout_t)
//     dv_t = dS_t^T k_t + (sum_i r_t,i u_i k_t,i) dout_t
//     dw_t = rowsum(dS_t * S_{t-1})
//     du  += r_t * k_t (v_t . dout_t)
//     dS_{t-1} = diag(w_t) dS_t + r_t dout_t^T,    dstate = dS_{-1}.
//
// Replaces no Pallas kernel: the reference trains through jax.grad of its
// XLA wkv6_ref (repro/kernels/rwkv6_scan/ref.py:20), a lax.scan
// checkpointed every 128 steps.
//
// What bounds it: at rwkv6-7b's training shape (b, t, h, n) = (4, 1024, 64,
// 64), bf16 r/k/v/dout/dr/dk/dv, f32 w/dw, it moves ~340 MB (0.10 ms at
// 3.35 TB/s) and needs, per state element and step, 2 float32 operations
// to recompute S and 8 for the backward (the 4 sums and dS's update): 10.7
// GFLOP, 0.16 ms at 67 TFLOP/s on CUDA cores. The steps are a serial chain
// in each (batch, head).
//
// The design, a simple one first, on CUDA cores in float32:
//  * One block per (batch, head) of n x 4 threads: thread (i, g) owns key
//    row i and n / 4 of its value columns (4-runs strided by 16), so S and
//    dS live in registers, dr, dk and dw are sums over the thread's
//    columns and two xor-shuffles among the row's 4 lanes.
//  * Phase 1 scans forward from the initial state and writes the state
//    at the start of every chunk of kChunk steps to a float32 scratch
//    (b * h * ceil(t / kChunk) snapshots of n x n).
//  * Phase 2 walks the chunks backward: it stages the chunk's r, k, v, w
//    and dout in shared memory (as float32), recomputes the chunk's
//    states from its snapshot into shared-memory slots (S_{t-1} of each
//    step, rows padded to n + 4 floats so a warp's float4 reads spread
//    over the banks), then runs the chunk's steps backward from the
//    registers' dS, overwriting each slot with dS_t once it has read
//    S_{t-1}. Then a pass with a thread per (step, value column) sums
//    dv_t = dS_t^T k_t down the slots' columns. No step divides by w,
//    which may be 0 or 1 exactly.
//  * du: each row's sum over the steps, written per (batch, head); the
//    wrapper adds the batch's. No float atomics: repeats are bit-equal.
//  * Types: r, k, v, dout, dr, dk, dv share one type T (float32 or
//    bfloat16), w and dw one type W; u, the states and du are float32.
// The kernel runs on the caller's stream and allocates nothing: the
// wrapper gives the snapshots' scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 8;         // steps a chunk (snapshots, slots)
constexpr int kSplit = 4;         // threads per key row
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

template <int N>
struct Smem {
  static constexpr int kRow = N + 4;                  // a slot's row stride
  static constexpr int kSlots = kChunk * N * kRow;    // floats
  static constexpr int kStage = kChunk * N;           // floats an input
  // slots, then r, k, v, w, dout, dr, dk, dw staged, then v.dout, r.u.k
  static constexpr int kFloats = kSlots + 8 * kStage + 2 * kChunk;
  static constexpr int kBytes = kFloats * 4;
};

template <int N, typename T, typename W>
__global__ void __launch_bounds__(N * kSplit, 1)
    wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const W* __restrict__ w,
                    const float* __restrict__ u,
                    const float* __restrict__ s_in,
                    const T* __restrict__ dout,
                    const float* __restrict__ ds_in, T* __restrict__ dr,
                    T* __restrict__ dk, T* __restrict__ dv,
                    W* __restrict__ dw, float* __restrict__ du_part,
                    float* __restrict__ ds_out, float* __restrict__ snap,
                    int t, int h) {
  using S = Smem<N>;
  constexpr int kThreads = N * kSplit;
  constexpr int kPer = N / kSplit;        // columns per thread
  constexpr int kQuads = kPer / 4;        // float4 runs per thread
  static_assert(kPer % 4 == 0, "head size must be a multiple of 16");

  extern __shared__ __align__(16) float smem[];
  float* slots = smem;                             // [kChunk][N][kRow]
  float* r_s = slots + S::kSlots;                  // [kChunk][N] each
  float* k_s = r_s + S::kStage;
  float* v_s = k_s + S::kStage;
  float* w_s = v_s + S::kStage;
  float* d_s = w_s + S::kStage;
  float* dr_s = d_s + S::kStage;
  float* dk_s = dr_s + S::kStage;
  float* dw_s = dk_s + S::kStage;
  float* vdo_s = dw_s + S::kStage;                 // [kChunk]
  float* ruk_s = vdo_s + kChunk;                   // [kChunk]

  const int bh = blockIdx.x;              // b * h + head
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int tid = threadIdx.x;
  const int i = tid / kSplit;             // key row
  const int g = tid - i * kSplit;         // column group
  const float ui = u[hi * N + i];
  const int nchunks = (t + kChunk - 1) / kChunk;
  const size_t state_off = static_cast<size_t>(bh) * N * N;
  float* my_snap = snap + static_cast<size_t>(bh) * nchunks * N * N;
  auto col = [&](int q) { return (q * kSplit + g) * 4; };  // first of a run

  const size_t step = static_cast<size_t>(h) * N;   // elements per step
  const size_t base = static_cast<size_t>(bi) * t * step
                      + static_cast<size_t>(hi) * N;
  // stages the inputs of steps [t0, t0 + len) as float32
  auto stage = [&](int t0, int len, bool all) {
    for (int e = tid; e < len * N; e += kThreads) {
      const int tt = e / N;
      const int c = e - tt * N;
      const size_t off = base + static_cast<size_t>(t0 + tt) * step + c;
      k_s[e] = to_f32(k[off]);
      v_s[e] = to_f32(v[off]);
      w_s[e] = to_f32(w[off]);
      if (all) {
        r_s[e] = to_f32(r[off]);
        d_s[e] = to_f32(dout[off]);
      }
    }
  };

  float s[kPer];
#pragma unroll
  for (int q = 0; q < kQuads; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s[q * 4 + c] = s_in ? s_in[state_off + i * N + col(q) + c] : 0.f;

  // Phase 1: the forward scan, a snapshot at the start of every chunk.
  for (int c0 = 0, ci = 0; c0 < t; c0 += kChunk, ++ci) {
    const int len = min(kChunk, t - c0);
    float* sn = my_snap + static_cast<size_t>(ci) * N * N + i * N;
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
      *reinterpret_cast<float4*>(sn + col(q)) =
          make_float4(s[q * 4], s[q * 4 + 1], s[q * 4 + 2], s[q * 4 + 3]);
    __syncthreads();  // the last chunk's staged inputs are read
    stage(c0, len, false);
    __syncthreads();
    for (int tt = 0; tt < len; ++tt) {
      const float wi = w_s[tt * N + i], ki = k_s[tt * N + i];
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(&v_s[tt * N + col(q)]);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[q * 4 + c] = fmaf(wi, s[q * 4 + c], ki * vv[c]);
      }
    }
  }

  // Phase 2: the chunks backward.
  float ds[kPer];
#pragma unroll
  for (int q = 0; q < kQuads; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      ds[q * 4 + c] = ds_in[state_off + i * N + col(q) + c];
  float du_acc = 0.f;
  const int warp = tid >> 5, lane = tid & 31;
  for (int ci = nchunks - 1; ci >= 0; --ci) {
    const int c0 = ci * kChunk;
    const int len = min(kChunk, t - c0);
    __syncthreads();  // the last chunk's slots and staged values are read
    stage(c0, len, true);
    __syncthreads();
    // each step's v . dout and sum_i r_i u_i k_i, a warp a step
    for (int tt = warp; tt < len; tt += kThreads / 32) {
      float a = 0.f, b = 0.f;
      for (int c = lane; c < N; c += 32) {
        a = fmaf(v_s[tt * N + c], d_s[tt * N + c], a);
        b = fmaf(r_s[tt * N + c] * u[hi * N + c], k_s[tt * N + c], b);
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        a += __shfl_xor_sync(kFull, a, m);
        b += __shfl_xor_sync(kFull, b, m);
      }
      if (lane == 0) {
        vdo_s[tt] = a;
        ruk_s[tt] = b;
      }
    }
    // the chunk's states S_{t-1} into the slots, from its snapshot
    const float* sn = my_snap + static_cast<size_t>(ci) * N * N + i * N;
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const float4 s4 = *reinterpret_cast<const float4*>(sn + col(q));
      s[q * 4] = s4.x;
      s[q * 4 + 1] = s4.y;
      s[q * 4 + 2] = s4.z;
      s[q * 4 + 3] = s4.w;
    }
    for (int tt = 0; tt < len; ++tt) {
      float* sl = slots + (tt * N + i) * S::kRow;
      const float wi = w_s[tt * N + i], ki = k_s[tt * N + i];
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        *reinterpret_cast<float4*>(sl + col(q)) =
            make_float4(s[q * 4], s[q * 4 + 1], s[q * 4 + 2], s[q * 4 + 3]);
        const float4 v4 =
            *reinterpret_cast<const float4*>(&v_s[tt * N + col(q)]);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[q * 4 + c] = fmaf(wi, s[q * 4 + c], ki * vv[c]);
      }
    }
    __syncthreads();  // vdo_s, ruk_s
    // the steps backward; each thread reads and rewrites its own slots
    for (int tt = len - 1; tt >= 0; --tt) {
      float* sl = slots + (tt * N + i) * S::kRow;
      const float ri = r_s[tt * N + i], ki = k_s[tt * N + i];
      const float wi = w_s[tt * N + i];
      float pk = 0.f, pw = 0.f, pr = 0.f;
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const float4 s4 = *reinterpret_cast<const float4*>(sl + col(q));
        const float4 v4 =
            *reinterpret_cast<const float4*>(&v_s[tt * N + col(q)]);
        const float4 d4 =
            *reinterpret_cast<const float4*>(&d_s[tt * N + col(q)]);
        const float sp[4] = {s4.x, s4.y, s4.z, s4.w};
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
        const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = ds[q * 4 + c];
          pk = fmaf(x, vv[c], pk);
          pw = fmaf(x, sp[c], pw);
          pr = fmaf(sp[c], dd[c], pr);
        }
        *reinterpret_cast<float4*>(sl + col(q)) =
            make_float4(ds[q * 4], ds[q * 4 + 1], ds[q * 4 + 2],
                        ds[q * 4 + 3]);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ds[q * 4 + c] = fmaf(wi, ds[q * 4 + c], ri * dd[c]);
      }
#pragma unroll
      for (int m = 1; m < kSplit; m <<= 1) {
        pk += __shfl_xor_sync(kFull, pk, m);
        pw += __shfl_xor_sync(kFull, pw, m);
        pr += __shfl_xor_sync(kFull, pr, m);
      }
      if (g == 0) {
        const float vdo = vdo_s[tt];
        dr_s[tt * N + i] = fmaf(ui * ki, vdo, pr);
        dk_s[tt * N + i] = fmaf(ui * ri, vdo, pk);
        dw_s[tt * N + i] = pw;
        du_acc = fmaf(ri * ki, vdo, du_acc);
      }
    }
    __syncthreads();
    // dv_t = dS_t^T k_t + (r.u.k) dout_t down the slots' columns; the
    // chunk's gradients out, coalesced
    for (int e = tid; e < len * N; e += kThreads) {
      const int tt = e / N;
      const int j = e - tt * N;
      const float* sl = slots + tt * N * S::kRow + j;
      float acc = 0.f;
#pragma unroll 8
      for (int ii = 0; ii < N; ++ii)
        acc = fmaf(sl[ii * S::kRow], k_s[tt * N + ii], acc);
      const size_t off = base + static_cast<size_t>(c0 + tt) * step + j;
      dv[off] = from_f32<T>(fmaf(ruk_s[tt], d_s[e], acc));
      dr[off] = from_f32<T>(dr_s[e]);
      dk[off] = from_f32<T>(dk_s[e]);
      dw[off] = from_f32<W>(dw_s[e]);
    }
  }

#pragma unroll
  for (int q = 0; q < kQuads; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      ds_out[state_off + i * N + col(q) + c] = ds[q * 4 + c];
  if (g == 0) du_part[static_cast<size_t>(bh) * N + i] = du_acc;
}

template <int N, typename T, typename W>
int launch_n(const void* r, const void* k, const void* v, const void* w,
             const float* u, const float* s_in, const void* dout,
             const float* ds_in, void* dr, void* dk, void* dv, void* dw,
             float* du_part, float* ds_out, float* snap, int b, int t, int h,
             cudaStream_t stream) {
  auto kernel = wkv6_bwd_kernel<N, T, W>;
  const int bytes = Smem<N>::kBytes;
  static bool ready = false;  // per instantiation: the attribute set once
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  kernel<<<b * h, N * kSplit, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const W*>(w), u, s_in,
      static_cast<const T*>(dout), ds_in, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<W*>(dw), du_part,
      ds_out, snap, t, h);
  return 0;
}

template <typename T, typename W>
int launch_typed(int n, const void* r, const void* k, const void* v,
                 const void* w, const float* u, const float* s_in,
                 const void* dout, const float* ds_in, void* dr, void* dk,
                 void* dv, void* dw, float* du_part, float* ds_out,
                 float* snap, int b, int t, int h, cudaStream_t s) {
  if (n == 16)
    return launch_n<16, T, W>(r, k, v, w, u, s_in, dout, ds_in, dr, dk, dv,
                              dw, du_part, ds_out, snap, b, t, h, s);
  if (n == 32)
    return launch_n<32, T, W>(r, k, v, w, u, s_in, dout, ds_in, dr, dk, dv,
                              dw, du_part, ds_out, snap, b, t, h, s);
  if (n == 64)
    return launch_n<64, T, W>(r, k, v, w, u, s_in, dout, ds_in, dr, dk, dv,
                              dw, du_part, ds_out, snap, b, t, h, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype / wdtype: 0 float32, 1 bfloat16 (r, k, v, dout, dr, dk, dv / w,
// dw). r, k, v, w, dout, dr, dk, dv, dw (b, t, h, n), u (h, n), s_in
// (b, h, n, n) float32 or null (zeros), ds_in, ds_out (b, h, n, n) and
// du_part (b, h, n) float32, snap float32 of b * h * ceil(t / 8)
// * n * n: all contiguous, the float4-read ones 16-byte aligned. Returns a
// CUDA error code, 0 if the launch was accepted.
extern "C" int rwkv6_scan_bwd(int dtype, int wdtype, int n, const void* r,
                              const void* k, const void* v, const void* w,
                              const void* u, const void* s_in,
                              const void* dout, const void* ds_in, void* dr,
                              void* dk, void* dv, void* dw, void* du_part,
                              void* ds_out, void* snap, int b, int t, int h,
                              void* stream) {
  if (b < 1 || h < 1 || t < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* si = static_cast<const float*>(s_in);
  const float* di = static_cast<const float*>(ds_in);
  float* dup = static_cast<float*>(du_part);
  float* so = static_cast<float*>(ds_out);
  float* sn = static_cast<float*>(snap);
  int err;
  if (dtype == 0 && wdtype == 0)
    err = launch_typed<float, float>(n, r, k, v, w, uf, si, dout, di, dr, dk,
                                     dv, dw, dup, so, sn, b, t, h, s);
  else if (dtype == 1 && wdtype == 0)
    err = launch_typed<__nv_bfloat16, float>(n, r, k, v, w, uf, si, dout, di,
                                             dr, dk, dv, dw, dup, so, sn, b,
                                             t, h, s);
  else if (dtype == 0 && wdtype == 1)
    err = launch_typed<float, __nv_bfloat16>(n, r, k, v, w, uf, si, dout, di,
                                             dr, dk, dv, dw, dup, so, sn, b,
                                             t, h, s);
  else if (dtype == 1 && wdtype == 1)
    err = launch_typed<__nv_bfloat16, __nv_bfloat16>(
        n, r, k, v, w, uf, si, dout, di, dr, dk, dv, dw, dup, so, sn, b, t,
        h, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
