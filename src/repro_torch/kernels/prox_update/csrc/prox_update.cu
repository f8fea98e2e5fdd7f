// PerMFL device step (paper eq. 4) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
// repro/kernels/prox_update/prox_update.py::_prox_kernel:
//
//     upd    = g + lam * (theta - anchor) + wd * theta
//     if momentum > 0:  m' = momentum * m + upd;  upd = m'
//     theta' = theta - alpha * upd
//
// What bounds it: HBM bytes. Each element costs three or four loads and one
// or two stores for about six flops (under one flop per byte), so the card's
// memory rate sets the floor and the design removes bytes and launches:
//
//  * The stacked device tier is one (rows, ld) buffer whose parameter leaves
//    are views, so one launch covers every leaf of every device:
//    blockIdx.y walks the device rows (in steps of gridDim.y, at most
//    65,535, so any number of rows takes one launch), blockIdx.x strides
//    along each row.
//  * The anchor may be the team tier, with one row per rows_per_anchor
//    device rows: device row r reads anchor row r / rows_per_anchor, so the
//    (M, N, P) broadcast of the team models is never written to memory.
//  * 16-byte vector loads and stores when every row start is 16-byte
//    aligned (the caller says so with `vec`), a scalar tail after them.
//  * With momentum == 0 the momentum buffers are neither read nor written.
//  * A hyperparameter sweep stacks S configurations' tiers on the rows:
//    alpha and lam may come from two float arrays in device memory, one
//    value per group of rows_per_group rows (row r reads group
//    r / rows_per_group), so one launch steps every configuration, as the
//    reference carries them in an SMEM operand. Null arrays keep the
//    by-value alpha and lam. Reading them from memory also lets a CUDA
//    graph replay the step with new values.
//
// Every operation rounds on its own (__fadd_rn, __fmul_rn, __fsub_rn), in
// the order of the plain PyTorch version (kernels/prox_update/ref.py), so
// the two agree bit for bit. theta/grad/anchor are float32 or bfloat16
// (upcast to float32 inside, theta' written back in theta's type); the
// momentum buffer is float32. Outputs may alias inputs (in-place update):
// each thread reads an element before it writes the same element.
// The kernel runs on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float alpha, lam, momentum, wd;
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

template <bool MOM>
__device__ __forceinline__ float prox(float t, float g, float a, float& m,
                                      const Hyper& hp) {
  float upd = __fadd_rn(__fadd_rn(g, __fmul_rn(hp.lam, __fsub_rn(t, a))),
                        __fmul_rn(hp.wd, t));
  if (MOM) {
    m = __fadd_rn(__fmul_rn(hp.momentum, m), upd);
    upd = m;
  }
  return __fsub_rn(t, __fmul_rn(hp.alpha, upd));
}

// Elements of T in one 16-byte vector access.
template <typename T>
constexpr int kVec = 16 / sizeof(T);

// One row: cols elements of theta/grad (and the momentum buffers) against
// one anchor row.
template <typename T, bool MOM, bool VEC>
__device__ __forceinline__ void prox_row(T* t_out, const T* t_in,
                                         const T* g_in, const T* a_in,
                                         float* m_out, const float* m_in,
                                         int64_t cols, int64_t tid,
                                         int64_t nth, const Hyper& hp) {
  int64_t done = 0;
  if (VEC) {
    constexpr int N = kVec<T>;
    const int64_t nvec = cols / N;
    for (int64_t i = tid; i < nvec; i += nth) {
      const int64_t j = i * N;
      const uint4 t_raw = *reinterpret_cast<const uint4*>(t_in + j);
      const uint4 g_raw = *reinterpret_cast<const uint4*>(g_in + j);
      const uint4 a_raw = *reinterpret_cast<const uint4*>(a_in + j);
      const T* t = reinterpret_cast<const T*>(&t_raw);
      const T* g = reinterpret_cast<const T*>(&g_raw);
      const T* a = reinterpret_cast<const T*>(&a_raw);
      uint4 o_raw;
      T* o = reinterpret_cast<T*>(&o_raw);
      float m[N] = {};
      if (MOM) {
#pragma unroll
        for (int k = 0; k < N; k += 4) {
          const float4 v = *reinterpret_cast<const float4*>(m_in + j + k);
          m[k] = v.x;
          m[k + 1] = v.y;
          m[k + 2] = v.z;
          m[k + 3] = v.w;
        }
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        o[k] = from_f32<T>(
            prox<MOM>(to_f32(t[k]), to_f32(g[k]), to_f32(a[k]), m[k], hp));
      }
      *reinterpret_cast<uint4*>(t_out + j) = o_raw;
      if (MOM) {
#pragma unroll
        for (int k = 0; k < N; k += 4) {
          *reinterpret_cast<float4*>(m_out + j + k) =
              make_float4(m[k], m[k + 1], m[k + 2], m[k + 3]);
        }
      }
    }
    done = nvec * N;
  }
  for (int64_t j = done + tid; j < cols; j += nth) {
    float m = MOM ? m_in[j] : 0.0f;
    t_out[j] = from_f32<T>(
        prox<MOM>(to_f32(t_in[j]), to_f32(g_in[j]), to_f32(a_in[j]), m, hp));
    if (MOM) m_out[j] = m;
  }
}

// Operands of one launch. alpha_g/lam_g: null, or one value per group of
// rows_per_group rows.
template <typename T>
struct Args {
  T* t_out;
  const T* t_in;
  const T* g_in;
  const T* a_in;
  float* m_out;
  const float* m_in;
  int64_t rows, cols, ld_t, ld_g, ld_a, ld_m, rows_per_anchor;
  const float* alpha_g;
  const float* lam_g;
  int64_t rows_per_group;
  Hyper hp;
};

template <typename T, bool MOM, bool VEC>
__global__ void __launch_bounds__(kThreads) prox_kernel(const Args<T> a) {
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nth = int64_t(gridDim.x) * blockDim.x;
  for (int64_t row = blockIdx.y; row < a.rows; row += gridDim.y) {
    Hyper hp = a.hp;
    if (a.alpha_g != nullptr) {
      hp.alpha = a.alpha_g[row / a.rows_per_group];
      hp.lam = a.lam_g[row / a.rows_per_group];
    }
    prox_row<T, MOM, VEC>(a.t_out + row * a.ld_t, a.t_in + row * a.ld_t,
                          a.g_in + row * a.ld_g,
                          a.a_in + (row / a.rows_per_anchor) * a.ld_a,
                          MOM ? a.m_out + row * a.ld_m : nullptr,
                          MOM ? a.m_in + row * a.ld_m : nullptr, a.cols, tid,
                          nth, hp);
  }
}

template <typename T, bool MOM, bool VEC>
void launch(const Args<T>& a, cudaStream_t stream) {
  const int64_t per_thread = VEC ? kVec<T> : 1;
  int64_t work = (a.cols + per_thread - 1) / per_thread;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 65535) blocks = 65535;
  const int64_t rows_y = a.rows < 65535 ? a.rows : 65535;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(rows_y));
  prox_kernel<T, MOM, VEC><<<grid, kThreads, 0, stream>>>(a);
}

template <typename T>
void dispatch(bool mom, bool vec, const Args<T>& a, cudaStream_t s) {
  if (mom && vec)
    launch<T, true, true>(a, s);
  else if (mom)
    launch<T, true, false>(a, s);
  else if (vec)
    launch<T, false, true>(a, s);
  else
    launch<T, false, false>(a, s);
}

template <typename T>
Args<T> make_args(void* theta_out, const void* theta, const void* grad,
                  const void* anchor, void* mom_out, const void* mom,
                  int64_t rows, int64_t cols, int64_t ld_theta,
                  int64_t ld_grad, int64_t ld_anchor, int64_t ld_mom,
                  int64_t rows_per_anchor, const float* alpha_g,
                  const float* lam_g, int64_t rows_per_group,
                  const Hyper& hp) {
  return Args<T>{static_cast<T*>(theta_out), static_cast<const T*>(theta),
                 static_cast<const T*>(grad), static_cast<const T*>(anchor),
                 static_cast<float*>(mom_out), static_cast<const float*>(mom),
                 rows, cols, ld_theta, ld_grad, ld_anchor, ld_mom,
                 rows_per_anchor, alpha_g, lam_g, rows_per_group, hp};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (theta, grad, anchor and theta_out).
// Strides (ld_*) are in elements between row starts. Row r of theta reads
// anchor row r / rows_per_anchor. alpha_g and lam_g: both null (alpha and
// lam by value), or both float32 arrays on the device, row r reading entry
// r / rows_per_group of each. mom/mom_out are read and written only when
// momentum > 0. vec = 1 asks for 16-byte accesses: every pointer and row
// start must then be 16-byte aligned. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int prox_update(int dtype, void* theta_out, const void* theta,
                           const void* grad, const void* anchor, void* mom_out,
                           const void* mom, int64_t rows, int64_t cols,
                           int64_t ld_theta, int64_t ld_grad,
                           int64_t ld_anchor, int64_t ld_mom,
                           int64_t rows_per_anchor, const float* alpha_g,
                           const float* lam_g, int64_t rows_per_group,
                           float alpha, float lam, float momentum,
                           float weight_decay, int vec, void* stream) {
  if (rows < 1 || cols < 1 || rows_per_anchor < 1 ||
      (alpha_g == nullptr) != (lam_g == nullptr) ||
      (alpha_g != nullptr && rows_per_group < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Hyper hp{alpha, lam, momentum, weight_decay};
  const bool use_mom = momentum > 0.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dispatch<float>(use_mom, vec != 0,
                    make_args<float>(theta_out, theta, grad, anchor, mom_out,
                                     mom, rows, cols, ld_theta, ld_grad,
                                     ld_anchor, ld_mom, rows_per_anchor,
                                     alpha_g, lam_g, rows_per_group, hp),
                    s);
  else if (dtype == 1)
    dispatch<__nv_bfloat16>(
        use_mom, vec != 0,
        make_args<__nv_bfloat16>(theta_out, theta, grad, anchor, mom_out, mom,
                                 rows, cols, ld_theta, ld_grad, ld_anchor,
                                 ld_mom, rows_per_anchor, alpha_g, lam_g,
                                 rows_per_group, hp),
        s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
