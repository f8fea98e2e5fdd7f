// Mamba's selective scan for Hopper, sm_90a, variant "ring": the function
// of csrc/mamba_scan.cu (variant "simt"), per (batch, channel d) with a
// float32 state of N = 16 elements,
//
//     a_t = exp(dt_t A[d]),  u_t = f32(dt_t) f32(x_t)
//     h_t = a_t h_{t-1} + u_t B_t,   y_t = sum_n C_t[n] h_t[n]
//
// y rounded to the activation type once a step, and the final state. Under
// a gradient it also writes the state at the start of every kEvery = 8
// steps, the snapshots the ring backward (csrc/mamba_scan_bwd_hopper.cu)
// reads. It replaces no Pallas kernel: the reference runs the scan as an
// XLA lax.scan (repro/models/mamba.py:124).
//
// What bounds it: at Jamba's (b, s, d_in, N) = (4, 1,024, 16,384, 16) in
// bf16, b s d_in N = 1.07e9 exponentials, which the special-function units
// (MUFU) issue at 16 a clock per SM: 256.8 us at 132 SMs and 1.98 GHz. The
// bytes (xc, dt read, y written: 408.2 MB, 121.9 us) are under that; the
// snapshots add 536.9 MB (160.3 us).
//
// The design:
//  * a_t = ex2.approx(dt * A log2 e), A pre-scaled once a channel: a
//    multiply and one MUFU.EX2 (mamba_ring.cuh::decay), where simt's
//    accurate expf takes about 9 instructions. The SASS loop holds 8.08
//    instructions an element-step (bf16), an issue floor of 259.2 us at
//    128 a clock an SM, level with the MUFU bound: both pipes set the pace
//    (on an H100 80GB HBM3 at 700 W it runs in about 408 us, 63% of the
//    bound; PERF.md row 16).
//  * one thread per (batch, channel): its 16 states and A's row in
//    registers, y summed over its own states (even and odd n apart). A CTA
//    is 128 channels of one batch row; d_in a multiple of 128.
//  * a three-stage cp.async ring in shared memory of each stage's dt and x
//    tiles (steps x 128 channels) and of B and C (steps x 32, from the
//    strided views of x_proj's output, 16-byte aligned), issued two stages
//    ahead: no barrier waits on a global load. A stage is 16 steps (bf16)
//    or 8 (f32); a bf16 stage's B and C are converted to float32 once, by
//    the CTA, and read as broadcasts. 29,696 B of shared memory a CTA in
//    bf16, 28,672 in f32.
// The kernel runs on the caller's stream and allocates nothing.

#include "mamba_ring.cuh"

namespace {

using namespace mamba_ring;

constexpr int kCh = 128;          // channels a CTA, a thread each
constexpr int kStages = 3;        // the ring's depth

template <typename T>
struct Fwd {
  static constexpr int kSteps = sizeof(T) == 2 ? 16 : 8;   // a stage
  T dt[kStages][kSteps][kCh];
  T x[kStages][kSteps][kCh];
  T bc[kStages][kSteps][2 * kN];  // a step's B (0..15), C (16..31)
  float bcf[kSteps][2 * kN];      // bf16: the stage's B, C in float32
};

template <typename T>
__global__ void __launch_bounds__(kCh)
    mamba_scan_ring_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                           const T* __restrict__ bm, const T* __restrict__ cm,
                           long long bc_sb, long long bc_st,
                           const float* __restrict__ A,
                           const float* __restrict__ h0, T* __restrict__ y,
                           float* __restrict__ h_out,
                           float* __restrict__ snaps, int s, int d_in) {
  constexpr int S = Fwd<T>::kSteps;
  static_assert(S % kEvery == 0, "a stage holds whole snapshot intervals");
  constexpr int kE = 16 / sizeof(T);          // elements a 16-byte chunk
  constexpr int kRow = kCh / kE;              // chunks a tile row
  constexpr int kVec = kN / kE;               // chunks of B (or C) a step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Fwd<T>& sm = *reinterpret_cast<Fwd<T>*>(smem_raw);
  const int tid = threadIdx.x, bi = blockIdx.y;
  const int d0 = blockIdx.x * kCh, d = d0 + tid;
  const int nst = (s + S - 1) / S;
  const int nseg = (s + kEvery - 1) / kEvery;
  const size_t row = static_cast<size_t>(bi) * d_in + d;   // (b, d)
  const size_t tile = static_cast<size_t>(bi) * s * d_in + d0;
  const T* bb = bm + bi * bc_sb;
  const T* cb = cm + bi * bc_sb;

  // stage k's copies into slot k % kStages, then one commit (empty past
  // the end, so that every thread counts the same groups)
  auto issue = [&](int k) {
    if (k < nst) {
      const int t0 = k * S, slot = k % kStages;
      for (int c = tid; c < S * kRow; c += kCh) {
        const int j = c / kRow, q = (c % kRow) * kE;
        if (t0 + j < s) {
          const size_t off = tile + static_cast<size_t>(t0 + j) * d_in + q;
          cp_async16(&sm.dt[slot][j][q], dt + off);
          cp_async16(&sm.x[slot][j][q], x + off);
        }
      }
      if (tid < S * 2 * kVec) {
        const int j = tid / (2 * kVec), r = tid % (2 * kVec);
        const int which = r / kVec, q = (r % kVec) * kE;
        if (t0 + j < s)
          cp_async16(&sm.bc[slot][j][which * kN + q],
                     (which ? cb : bb) + (t0 + j) * bc_st + q);
      }
    }
    cp_async_commit();
  };

  float a2[kN], h[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a2[n] = scaled_a(A[static_cast<size_t>(d) * kN + n]);
    h[n] = h0 ? h0[row * kN + n] : 0.f;
  }
  issue(0);
  issue(1);
  for (int k = 0; k < nst; ++k) {
    cp_async_wait<1>();                   // stage k landed (this thread's)
    __syncthreads();                      // everyone's; slot k - 1 free
    issue(k + 2);
    const int slot = k % kStages, t0 = k * S, len = min(S, s - t0);
    const float* bcs;
    if constexpr (sizeof(T) == 2) {
      for (int i = tid; i < S * 2 * kN; i += kCh)
        (&sm.bcf[0][0])[i] = to_f32((&sm.bc[slot][0][0])[i]);
      __syncthreads();
      bcs = &sm.bcf[0][0];
    } else {
      bcs = reinterpret_cast<const float*>(&sm.bc[slot][0][0]);
    }
    T* const ys = y + tile + tid + static_cast<size_t>(t0) * d_in;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (j >= len) continue;
      const int t = t0 + j;
      // a snapshot at each step t a multiple of kEvery (stages start on
      // multiples of S, itself a multiple of kEvery)
      if (j % kEvery == 0 && snaps) {
        float4* dst = reinterpret_cast<float4*>(
            snaps + ((static_cast<size_t>(bi) * nseg + t / kEvery) * d_in + d)
                        * kN);
#pragma unroll
        for (int q = 0; q < kN / 4; ++q)
          dst[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2],
                               h[4 * q + 3]);
      }
      const float dtv = to_f32(sm.dt[slot][j][tid]);
      const float u = __fmul_rn(dtv, to_f32(sm.x[slot][j][tid]));
      const float4* bt = reinterpret_cast<const float4*>(bcs + j * 2 * kN);
      float acc0 = 0.f, acc1 = 0.f;       // y over even and odd n
#pragma unroll
      for (int q = 0; q < kN / 4; ++q) {
        const float4 bq = bt[q], cq = bt[kN / 4 + q];
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = 4 * q + i;
          h[n] = state_step(decay(dtv, a2[n]), h[n], u, bv[i]);
          if (i % 2)
            acc1 = fmaf(h[n], cv[i], acc1);
          else
            acc0 = fmaf(h[n], cv[i], acc0);
        }
      }
      ys[static_cast<size_t>(j) * d_in] = from_f32<T>(acc0 + acc1);
    }
  }
  float4* ho = reinterpret_cast<float4*>(h_out + row * kN);
#pragma unroll
  for (int q = 0; q < kN / 4; ++q)
    ho[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
}

template <typename T>
int launch_typed(const void* x, const void* dt, const void* bm,
                 const void* cm, long long bc_sb, long long bc_st,
                 const float* A, const float* h0, void* y, float* h_out,
                 float* snaps, int b, int s, int d_in, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Fwd<T>));
  mamba_scan_ring_kernel<T>
      <<<dim3(d_in / kCh, b), kCh, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dt),
          static_cast<const T*>(bm), static_cast<const T*>(cm), bc_sb, bc_st,
          A, h0, static_cast<T*>(y), h_out, snaps, s, d_in);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, dt, B, C and y). B and C are read at
// element (b, t, n) = b * bc_sb + t * bc_st + n: both base pointers and
// both strides 16-byte aligned. x and dt contiguous (b, s, d_in), d_in a
// multiple of 128. h0 may be null (a zero state), snaps null (no
// snapshots; else (b, ceil(s / 8), d_in, 16) float32).
// Returns a CUDA error code, 0 if the launch was accepted.
extern "C" int mamba_scan_ring(int dtype, const void* x,
                               const void* dt, const void* bm,
                               const void* cm, long long bc_sb,
                               long long bc_st, const void* A,
                               const void* h0, void* y, void* h_out,
                               void* snaps, int b, int s, int d_in,
                               void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  if (b < 1 || s < 1 || d_in < kCh || d_in % kCh || b > 65535 ||
      (dtype != 0 && dtype != 1) || !aligned16(x) || !aligned16(dt) ||
      !aligned16(bm) || !aligned16(cm) || (bc_sb * es) % 16 ||
      (bc_st * es) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(A);
  const float* hf = static_cast<const float*>(h0);
  float* ho = static_cast<float*>(h_out);
  float* sn = static_cast<float*>(snaps);
  if (dtype == 0)
    return launch_typed<float>(x, dt, bm, cm, bc_sb, bc_st, af, hf, y, ho, sn,
                               b, s, d_in, st);
  return launch_typed<__nv_bfloat16>(x, dt, bm, cm, bc_sb, bc_st, af, hf, y,
                                     ho, sn, b, s, d_in, st);
}

