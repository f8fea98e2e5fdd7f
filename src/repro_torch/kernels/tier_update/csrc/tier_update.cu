// PerMFL's team and server updates at LLM scale (paper eqs. 9 and 13) for
// Hopper, sm_90a, one leaf of the parameter tree a launch:
//
//     w' = c * w + (eta * gamma) * x + (lam * eta) * theta      (eq. 9)
//     x' = (1 - beta * gamma) * x + (beta * gamma) * w'          (eq. 13)
//
// with c = 1 - eta * lam - eta * gamma. It replaces no TPU kernel: the
// reference leaves both updates to XLA, and the port ran them as eight eager
// PyTorch kernels a leaf (five scalings and three adds, each reading its
// operands from device memory and writing its result back): 19 values a
// parameter moved, where the work needs 5.
//
// What bounds it: HBM bytes. Each element costs three loads (w, x, theta)
// and two stores (w', x') for 8 flops, far under one flop per byte, so the
// card's memory rate sets the floor: 5 values a parameter, 11.4 ms for
// phi3-mini's 3.82 B bf16 parameters at 3.35 TB/s. The design moves those
// bytes once and nothing else:
//
//  * Every element is read once and both results are written once, in one
//    pass; w' stays in registers for eq. 13 and is never read back.
//  * 16-byte vector loads and stores when every operand is 16-byte aligned
//    (the caller says so with `vec`), a scalar tail after them; a view that
//    is not aligned takes the scalar path throughout.
//  * One 16-byte vector a thread, in as many blocks as the leaf needs (the
//    loop strides only past gridDim.x's limit). On phi3's tree on an H100
//    SXM at 700 W this grid read 90.4% of the bound; capped at 65,535
//    blocks (six vectors a thread on w_gate) 88.6%, at 8 blocks an SM
//    striding over the leaf 83.1%; two or four vectors a thread, or
//    streaming loads and stores, gained nothing.
//
// Same work, same bits: the plain version (kernels/tier_update/ref.py), and
// the benchmark's reference, run the updates op by op in the leaves' type,
// rounding after each of the eight operations. The kernel computes each
// operation in float32 with __fmul_rn / __fadd_rn (no FMA contraction), in
// the same order, and for a bfloat16 leaf rounds every intermediate to
// bfloat16 as each eager kernel stored it; the scalars come as float32, the
// values PyTorch casts its double scalars to. So the two agree bit for bit.
// Inputs may alias each other (the first round passes one tree as theta, w
// and x); the outputs are new buffers. The kernel runs on the caller's
// stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 2147483647;  // gridDim.x's limit

// The update's five scalars, each the float32 value of PyTorch's double.
struct Coef {
  float c, eta_gamma, lam_eta, keep, beta_gamma;
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

// x as an eager kernel stores it in T and the next one reads it back.
template <typename T>
__device__ __forceinline__ float stored(float x) {
  return to_f32(from_f32<T>(x));
}

// Eqs. 9 and 13 on one element, each operation rounded as the plain
// version's eager kernel rounds it.
template <typename T>
__device__ __forceinline__ void update(float w, float x, float theta,
                                       const Coef& k, T& w_new, T& x_new) {
  const float cw = stored<T>(__fmul_rn(k.c, w));
  const float egx = stored<T>(__fmul_rn(k.eta_gamma, x));
  const float sum = stored<T>(__fadd_rn(cw, egx));
  const float let = stored<T>(__fmul_rn(k.lam_eta, theta));
  const float wn = stored<T>(__fadd_rn(sum, let));
  const float kx = stored<T>(__fmul_rn(k.keep, x));
  const float bgw = stored<T>(__fmul_rn(k.beta_gamma, wn));
  w_new = from_f32<T>(wn);
  x_new = from_f32<T>(__fadd_rn(kx, bgw));
}

// Elements of T in one 16-byte vector access.
template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <typename T>
struct Args {
  T* w_out;
  T* x_out;
  const T* w;
  const T* x;
  const T* theta;
  int64_t n;
  Coef k;
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    tier_update_kernel(const Args<T> a) {
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nth = int64_t(gridDim.x) * blockDim.x;
  int64_t done = 0;
  if (VEC) {
    constexpr int N = kVec<T>;
    const int64_t nvec = a.n / N;
    for (int64_t i = tid; i < nvec; i += nth) {
      const int64_t j = i * N;
      const uint4 w_raw = *reinterpret_cast<const uint4*>(a.w + j);
      const uint4 x_raw = *reinterpret_cast<const uint4*>(a.x + j);
      const uint4 t_raw = *reinterpret_cast<const uint4*>(a.theta + j);
      const T* w = reinterpret_cast<const T*>(&w_raw);
      const T* x = reinterpret_cast<const T*>(&x_raw);
      const T* t = reinterpret_cast<const T*>(&t_raw);
      uint4 wo_raw, xo_raw;
      T* wo = reinterpret_cast<T*>(&wo_raw);
      T* xo = reinterpret_cast<T*>(&xo_raw);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        update<T>(to_f32(w[e]), to_f32(x[e]), to_f32(t[e]), a.k, wo[e],
                  xo[e]);
      }
      *reinterpret_cast<uint4*>(a.w_out + j) = wo_raw;
      *reinterpret_cast<uint4*>(a.x_out + j) = xo_raw;
    }
    done = nvec * N;
  }
  for (int64_t j = done + tid; j < a.n; j += nth) {
    update<T>(to_f32(a.w[j]), to_f32(a.x[j]), to_f32(a.theta[j]), a.k,
              a.w_out[j], a.x_out[j]);
  }
}

template <typename T, bool VEC>
int launch(const Args<T>& a, cudaStream_t stream) {
  const int64_t per_thread = VEC ? kVec<T> : 1;
  const int64_t work = (a.n + per_thread - 1) / per_thread;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  tier_update_kernel<T, VEC>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(void* w_out, void* x_out, const void* w, const void* x,
             const void* theta, int64_t n, const Coef& k, bool vec,
             cudaStream_t stream) {
  const Args<T> a{static_cast<T*>(w_out),     static_cast<T*>(x_out),
                  static_cast<const T*>(w),   static_cast<const T*>(x),
                  static_cast<const T*>(theta), n, k};
  return vec ? launch<T, true>(a, stream) : launch<T, false>(a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every operand). n elements of each
// contiguous operand; w_out and x_out must not overlap the inputs or each
// other. c, eta_gamma, lam_eta, keep (1 - beta * gamma) and beta_gamma: the
// update's scalars. vec = 1 asks for 16-byte accesses: every pointer must
// then be 16-byte aligned. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int tier_update(int dtype, void* w_out, void* x_out, const void* w,
                           const void* x, const void* theta, int64_t n,
                           float c, float eta_gamma, float lam_eta, float keep,
                           float beta_gamma, int vec, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Coef k{c, eta_gamma, lam_eta, keep, beta_gamma};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(w_out, x_out, w, x, theta, n, k, vec != 0, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(w_out, x_out, w, x, theta, n, k, vec != 0,
                                   s);
  return static_cast<int>(cudaErrorInvalidValue);
}
