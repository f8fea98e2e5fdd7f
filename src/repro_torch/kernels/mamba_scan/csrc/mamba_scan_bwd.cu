// The gradient of Mamba's selective scan (csrc/mamba_scan.cu) for Hopper,
// sm_90a, variant "simt" (the shapes the ring backward,
// csrc/mamba_scan_bwd_hopper.cu, does not take). Per (batch, channel d),
// with g_t the state's cotangent (g after the last step: the final state's
// cotangent, or zero):
//
//     g_t    = a_{t+1} g_{t+1} + dy_t C_t
//     dC_t   = sum_d dy_t h_t          du_t = sum_n g_t B_t
//     dB_t   = sum_d g_t u_t           dx_t = du_t dt_t
//     ddt_t  = sum_n g_t h_{t-1} a_t A + du_t x_t
//     dA     = sum_{b,t} g_t h_{t-1} a_t dt_t,   dh0 = a_1 g_1
//
// with a_t = exp(dt_t A), u_t = dt_t x_t (float32). It replaces no Pallas
// kernel: the reference differentiates its XLA scan with jax.grad
// (repro/models/mamba.py:142, chunk_fn under jax.checkpoint).
//
// What bounds it: at Jamba's (4, 1,024, 16,384, 16) in bf16 it reads xc,
// dt, B, C, A, dy (and the final cotangent) and writes dxc, ddt, dB, dC,
// dA (and dh0), 677.9 MB (202.4 us at 3.35 TB/s; the snapshots, its own
// scratch, 134.2 MB more), and it needs at least the forward's 1.07e9
// exponentials (0.26 ms at 16 a clock per SM, 132 SMs, 1.98 GHz):
// exponentials. This kernel takes three an element-step (the segment's
// recomputation, the window's, the backward step's).
//
// The design, a simple one first:
//  * one thread per (batch, channel), its g, A's row and its dA partial in
//    registers; a CTA is 64 channels of one batch row.
//  * the states: the forward wrote one every 32 steps (134 MB at Jamba's
//    shape). A segment runs backward in three passes: from its snapshot,
//    the segment's steps forward, keeping the state every 8 steps in
//    shared memory (the sub-snapshots, 16 KB a CTA); then for each 8-step
//    window, last first, the window's 8 states recomputed into shared
//    memory (32 KB a CTA) and the window run backward. Both buffers are
//    laid out [slot][n][thread]: a thread reads only its own column, bank-
//    conflict free. The recomputation is the forward's expression, so the
//    states are the forward's bit for bit. Shared memory, not registers,
//    bounds how many channels an SM holds, so the snapshots are 32 steps
//    apart (64 would leave three CTAs an SM, not four). Two threads a
//    channel (twice the warps an SM) ran no faster: the kernel is bound by
//    its instruction issue (three exponentials an element-step, the
//    reduce-scatter's shuffles), not by latency.
//  * B_t and C_t of the segment are staged in shared memory (4 KB) as in
//    the forward; dt, x (and dy) of a window are loaded into registers
//    before its steps, one memory latency a window; du and ddt's sum over
//    n run as two chains (even and odd n).
//  * dC_t and dB_t sum over d across threads: a warp reduce-scatters its
//    32 lanes' 32 values (16 dC, 16 dB) by 31 xor-shuffles (lane c ends
//    with the warp's sum of value c), a window's warp sums meet in shared
//    memory, and the CTA's sum of each (step, value) is written to a
//    float32 partial (b, s, d_in / 64, 32), 134 MB at Jamba's shape. dA's
//    partial is each thread's sum over its steps, (b, d_in, 16). A second
//    kernel sums the partials over the CTAs and over the batch in a fixed
//    order. No atomics: repeats are bit-equal.
// 55,296 bytes of shared memory a CTA: four CTAs (256 threads) an SM, 168
// registers, no spills.
// The kernels run on the caller's stream and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kN = 16;            // state size
constexpr int kT = 64;            // channels a CTA
constexpr int kWarps = kT / 32;
constexpr int kSeg = 32;          // steps between the forward's snapshots
constexpr int kWin = 8;           // steps a window (and between sub-snaps)
constexpr int kSubs = kSeg / kWin;
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  float sub[kSubs][kN][kT];       // the state before each window
  float win[kWin][kN][kT];        // the state after each step of a window
  float bc[kSeg][2 * kN];         // a step's B (0..15), C (16..31)
  float red[kWarps][kWin][2 * kN];  // each warp's sums of dC, dB a step
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

// one forward step of the state, the forward kernel's expression
__device__ __forceinline__ void step_state(float (&h)[kN],
                                           const float (&a)[kN], float dtv,
                                           float xv, const float* bt) {
  const float u = __fmul_rn(dtv, xv);
#pragma unroll
  for (int n = 0; n < kN; ++n)
    h[n] = fmaf(expf(__fmul_rn(dtv, a[n])), h[n], __fmul_rn(u, bt[n]));
}

// one level of reduce_scatter32: each lane keeps half of its 2K values
// (the upper half where lane bit K is set) and adds its partner's copy
template <int K>
__device__ __forceinline__ void reduce_level(float (&v)[32], int lane) {
  const bool upper = lane & K;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float send = upper ? v[i] : v[i + K];
    const float keep = upper ? v[i + K] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, K);
  }
}

// lane c of the warp returns the sum over the 32 lanes of v[c]; every
// index is a constant, so v stays in registers
__device__ __forceinline__ float reduce_scatter32(float (&v)[32], int lane) {
  reduce_level<16>(v, lane);
  reduce_level<8>(v, lane);
  reduce_level<4>(v, lane);
  reduce_level<2>(v, lane);
  reduce_level<1>(v, lane);
  return v[0];
}

template <typename T>
__global__ void __launch_bounds__(kT)
    mamba_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                          const T* __restrict__ bm, const T* __restrict__ cm,
                          long long bc_sb, long long bc_st,
                          const float* __restrict__ A,
                          const float* __restrict__ snaps,
                          const T* __restrict__ dy,
                          const float* __restrict__ dh, T* __restrict__ dx,
                          T* __restrict__ ddt, float* __restrict__ dh0,
                          float* __restrict__ part_bc,
                          float* __restrict__ part_a, int s, int d_in) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bi = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int d = blk * kT + tid;
  const bool live = d < d_in;
  const int nseg = (s + kSeg - 1) / kSeg;
  const size_t row = static_cast<size_t>(bi) * d_in + d;   // (b, d)
  float a[kN], g[kN], da[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a[n] = live ? A[static_cast<size_t>(d) * kN + n] : 0.f;
    g[n] = (live && dh) ? dh[row * kN + n] : 0.f;
    da[n] = 0.f;
  }
  const size_t base = static_cast<size_t>(bi) * s * d_in + d;
  auto load = [&](const T* p, int t) {
    return live ? to_f32(p[base + static_cast<size_t>(t) * d_in]) : 0.f;
  };
  for (int seg = nseg - 1; seg >= 0; --seg) {
    const int t0 = seg * kSeg;
    const int len = min(kSeg, s - t0);
    const int nsub = (len + kWin - 1) / kWin;
    __syncthreads();                      // the last segment's reads done
    for (int i = tid; i < len * 2 * kN; i += kT) {
      const int j = i / (2 * kN), c = i % (2 * kN);
      const T* src = (c < kN ? bm : cm) + bi * bc_sb + (t0 + j) * bc_st
                     + (c % kN);
      sm.bc[j][c] = to_f32(*src);
    }
    __syncthreads();
    // pass 1: the state before each window, from the segment's snapshot;
    // each window's dt and x loaded before its steps
    float h[kN], dtw[kWin], xw[kWin];
    const float* snap =
        snaps + ((static_cast<size_t>(bi) * nseg + seg) * d_in + d) * kN;
#pragma unroll
    for (int n = 0; n < kN; ++n) h[n] = live ? snap[n] : 0.f;
    for (int k = 0; k < nsub; ++k) {
#pragma unroll
      for (int n = 0; n < kN; ++n) sm.sub[k][n][tid] = h[n];
      if (k == nsub - 1) break;
#pragma unroll
      for (int i = 0; i < kWin; ++i) {
        dtw[i] = load(dt, t0 + k * kWin + i);
        xw[i] = load(x, t0 + k * kWin + i);
      }
#pragma unroll
      for (int i = 0; i < kWin; ++i)
        step_state(h, a, dtw[i], xw[i], sm.bc[k * kWin + i]);
    }
    // pass 2: each window, last first
    for (int k = nsub - 1; k >= 0; --k) {
      const int j0 = k * kWin;
      const int L = min(kWin, len - j0);
      float dyw[kWin];
#pragma unroll
      for (int i = 0; i < kWin; ++i) {
        const bool in = i < L;
        dtw[i] = in ? load(dt, t0 + j0 + i) : 0.f;
        xw[i] = in ? load(x, t0 + j0 + i) : 0.f;
        dyw[i] = in ? load(dy, t0 + j0 + i) : 0.f;
      }
#pragma unroll
      for (int n = 0; n < kN; ++n) h[n] = sm.sub[k][n][tid];
#pragma unroll
      for (int i = 0; i < kWin; ++i) {
        if (i >= L) break;
        step_state(h, a, dtw[i], xw[i], sm.bc[j0 + i]);
#pragma unroll
        for (int n = 0; n < kN; ++n) sm.win[i][n][tid] = h[n];
      }
#pragma unroll
      for (int i = kWin - 1; i >= 0; --i) {
        if (i >= L) continue;
        const int t = t0 + j0 + i;
        const float dyv = dyw[i], dtv = dtw[i], xv = xw[i];
        const float u = __fmul_rn(dtv, xv);
        const float* bt = sm.bc[j0 + i];
        float v[2 * kN];
        float du[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};   // even, odd n
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          g[n] = fmaf(dyv, bt[kN + n], g[n]);              // g_t
          const float hc = sm.win[i][n][tid];
          const float hp = i > 0 ? sm.win[i - 1][n][tid] : sm.sub[k][n][tid];
          v[n] = dyv * hc;                                 // dC_t
          v[kN + n] = g[n] * u;                            // dB_t
          du[n % 2] = fmaf(g[n], bt[n], du[n % 2]);
          const float an = expf(__fmul_rn(dtv, a[n]));
          const float gha = g[n] * hp * an;
          dd[n % 2] = fmaf(gha, a[n], dd[n % 2]);
          da[n] = fmaf(gha, dtv, da[n]);
          g[n] = an * g[n];                                // into g_{t-1}
        }
        const float dus = du[0] + du[1];
        if (live) {
          const size_t off = base + static_cast<size_t>(t) * d_in;
          dx[off] = from_f32<T>(dus * dtv);
          ddt[off] = from_f32<T>(fmaf(dus, xv, dd[0] + dd[1]));
        }
        sm.red[warp][i][lane] = reduce_scatter32(v, lane);
      }
      __syncthreads();
      for (int e = tid; e < L * 2 * kN; e += kT) {
        const int i = e / (2 * kN), c = e % (2 * kN);
        float sum = sm.red[0][i][c];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) sum += sm.red[w][i][c];
        part_bc[((static_cast<size_t>(bi) * s + t0 + j0 + i) * nblk + blk)
                    * (2 * kN) + c] = sum;
      }
      __syncthreads();
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      part_a[row * kN + n] = da[n];
      if (dh0) dh0[row * kN + n] = g[n];
    }
  }
}

// dC and dB of each (batch, step): a warp a row, lane c summing the CTAs'
// partials of value c in order (lanes 0..15 dC, 16..31 dB)
template <typename T>
__global__ void __launch_bounds__(256)
    mamba_scan_bwd_sum_bc(const float* __restrict__ part_bc,
                          T* __restrict__ db, T* __restrict__ dc, int rows,
                          int nblk) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int c = threadIdx.x & 31;
  if (r >= rows) return;
  const float* p = part_bc + static_cast<size_t>(r) * nblk * (2 * kN) + c;
  float sum = 0.f;
#pragma unroll 8
  for (int k = 0; k < nblk; ++k) sum += p[static_cast<size_t>(k) * 2 * kN];
  if (c < kN)
    dc[static_cast<size_t>(r) * kN + c] = from_f32<T>(sum);
  else
    db[static_cast<size_t>(r) * kN + c - kN] = from_f32<T>(sum);
}

// dA: each (d, n) summing the batch rows' partials in order
__global__ void __launch_bounds__(256)
    mamba_scan_bwd_sum_a(const float* __restrict__ part_a,
                         float* __restrict__ da, int b, int count) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= count) return;
  float sum = 0.f;
  for (int k = 0; k < b; ++k)
    sum += part_a[static_cast<size_t>(k) * count + i];
  da[i] = sum;
}

template <typename T>
int launch_typed(const void* x, const void* dt, const void* bm,
                 const void* cm, long long bc_sb, long long bc_st,
                 const float* A, const float* snaps, const void* dy,
                 const float* dh, void* dx, void* ddt, void* db, void* dc,
                 float* da, float* dh0, float* part_bc, float* part_a, int b,
                 int s, int d_in, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory, on the current device
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblk = (d_in + kT - 1) / kT;
  mamba_scan_bwd_kernel<T><<<dim3(nblk, b), kT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm), bc_sb, bc_st, A,
      snaps, static_cast<const T*>(dy), dh, static_cast<T*>(dx),
      static_cast<T*>(ddt), dh0, part_bc, part_a, s, d_in);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = b * s;
  mamba_scan_bwd_sum_bc<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      part_bc, static_cast<T*>(db), static_cast<T*>(dc), rows, nblk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int count = d_in * kN;
  mamba_scan_bwd_sum_a<<<(count + 255) / 256, 256, 0, stream>>>(part_a, da,
                                                                b, count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, dt, B, C, dy, dx, ddt, dB, dC). B and C
// are read at element (b, t, n) = b * bc_sb + t * bc_st + n; dB and dC are
// written contiguous (b, s, 16). snaps: the forward's (b, ceil(s / 32),
// d_in, 16) float32. dh (the final state's cotangent) may be null (zero),
// dh0 null (not asked). part_bc: (b, s, ceil(d_in / 64), 32) float32,
// part_a: (b, d_in, 16) float32 scratch. Returns a CUDA error code, 0 if
// every launch was accepted.
extern "C" int mamba_scan_bwd(int dtype, const void* x, const void* dt,
                              const void* bm, const void* cm,
                              long long bc_sb, long long bc_st, const void* A,
                              const void* snaps, const void* dy,
                              const void* dh, void* dx, void* ddt, void* db,
                              void* dc, void* da, void* dh0, void* part_bc,
                              void* part_a, int b, int s, int d_in,
                              void* stream) {
  if (b < 1 || s < 1 || d_in < 1 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0)
    return launch_typed<float>(x, dt, bm, cm, bc_sb, bc_st, f(A), f(snaps),
                               dy, f(dh), dx, ddt, db, dc, w(da), w(dh0),
                               w(part_bc), w(part_a), b, s, d_in, st);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(
        x, dt, bm, cm, bc_sb, bc_st, f(A), f(snaps), dy, f(dh), dx, ddt, db,
        dc, w(da), w(dh0), w(part_bc), w(part_a), b, s, d_in, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
