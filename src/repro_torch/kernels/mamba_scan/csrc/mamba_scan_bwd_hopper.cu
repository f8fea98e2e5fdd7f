// The gradient of Mamba's selective scan for Hopper, sm_90a, variant
// "ring": the function of csrc/mamba_scan_bwd.cu (variant "simt") from the
// ring forward's snapshots (csrc/mamba_scan_hopper.cu). Per (batch,
// channel d), with g_t the state's cotangent (g after the last step: the
// final state's cotangent, or zero):
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
// dt, B, C, A, dy (and the final cotangent) and writes dxc, ddt, dB, dC, dA
// (and dh0): 677.9 MB, 202.4 us at 3.35 TB/s. It needs at least the
// forward's 1.07e9 exponentials, 256.8 us at 16 a clock per SM (132 SMs,
// 1.98 GHz): exponentials. This kernel takes two an element-step (a
// window's recomputation, and the backward step's a_t), so the
// special-function units alone take 513.6 us. Its issue is the floor above
// that: the SASS loop holds about 31.5 instructions an element-step (bf16),
// an issue floor of about 1,011 us at 128 a clock an SM (on an H100 80GB
// HBM3 at 700 W it runs in about 1,527 us, 66% of that floor, the
// reductions waiting on shuffle latency; PERF.md row 17).
//
// The design:
//  * a_t = ex2.approx(dt * A log2 e), the forward's expression
//    (mamba_ring.cuh::decay, ::state_step): the recomputed states are the
//    forward's bit for bit. ddt's sum over n runs on A log2 e and is
//    scaled by ln 2 once.
//  * a thread holds 4 state elements (n = 4 g .. 4 g + 3) of 2 channels:
//    a warp is 16 channels x 16 n, a CTA of 256 threads 128 channels of one
//    batch row (d_in a multiple of 128), two CTAs (16 warps) an SM. dC and
//    dB are summed over the thread's 2 channels in registers, then over
//    the warp's 8 channel pairs by a 3-level shuffle reduce-scatter (7
//    shuffles a step for 8 values, where one channel a thread took 31 for
//    32), the warps' sums meet in shared memory and the CTA's sum of each
//    (step, value) is written to a float32 partial (b, s, d_in / 128, 32),
//    67.1 MB at Jamba's shape. du and ddt's sums over n cross the 4 lanes
//    of a channel pair in 2 shuffle levels.
//  * the scan runs backward in windows of kEvery = 8 steps, the forward's
//    snapshot cadence, last window first: a window's 8 states are
//    recomputed into registers from its snapshot, then the window runs
//    backward from them.
//  * a three-stage cp.async ring of each window's dt, x, dy tiles (8 steps
//    x 128 channels), B and C (from x_proj's strided views) and snapshot
//    tile (128 channels x 16), issued two windows ahead; the CTA converts
//    a window's tiles to float32 once (two barriers a window, neither
//    waiting on a global load). 70,144 B of shared memory a CTA in bf16,
//    94,208 in f32.
//  * dA's partial is each thread's sum over its steps, (b, d_in, 16); a
//    second and third kernel sum dC, dB over the CTAs and dA over the batch
//    rows in a fixed order. No atomics: repeats are bit-equal.
// The kernels run on the caller's stream and allocate nothing.

#include <type_traits>

#include "mamba_ring.cuh"

namespace {

using namespace mamba_ring;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCh = 128;          // channels a CTA, 2 a thread
constexpr int kW = kEvery;        // steps a window: one a snapshot
constexpr int kStages = 3;        // the ring's depth
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Bwd {
  T dt[kStages][kW][kCh];
  T x[kStages][kW][kCh];
  T dy[kStages][kW][kCh];
  T bc[kStages][kW][2 * kN];      // a step's B (0..15), C (16..31)
  float snap[kStages][kCh][kN];   // the window's snapshot
  float cdt[kW][kCh], cx[kW][kCh], cdy[kW][kCh];   // the window in f32
  float cbc[kW][2 * kN];
  float red[kWarps][kW][2 * kN];  // each warp's sums of dC, dB a step
  T odx[kW][kCh], oddt[kW][kCh];  // the window's dxc, ddt
};

// lane's share of a reduce-scatter level: lanes with bit K set keep the
// upper K of their 2K values, the others the lower, each adding its
// partner's copy
template <int K, int LANE_BIT>
__device__ __forceinline__ void scatter_level(float (&v)[2 * K], int lane) {
  const bool upper = lane & LANE_BIT;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float send = upper ? v[i] : v[i + K];
    const float keep = upper ? v[i + K] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, LANE_BIT);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    mamba_scan_bwd_ring_kernel(
        const T* __restrict__ x, const T* __restrict__ dt,
        const T* __restrict__ bm, const T* __restrict__ cm, long long bc_sb,
        long long bc_st, const float* __restrict__ A,
        const float* __restrict__ snaps, const T* __restrict__ dy,
        const float* __restrict__ dh, T* __restrict__ dx, T* __restrict__ ddt,
        float* __restrict__ dh0, float* __restrict__ part_bc,
        float* __restrict__ part_a, int s, int d_in) {
  using Smem = Bwd<T>;
  constexpr int kE = 16 / sizeof(T);          // elements a 16-byte chunk
  constexpr int kRow = kCh / kE;              // chunks a tile row
  constexpr int kVec = kN / kE;               // chunks of B (or C) a step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ng = lane & 3;                    // n = 4 ng .. 4 ng + 3
  const int cp = warp * 8 + (lane >> 2);      // channels 2 cp, 2 cp + 1
  const int bi = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int d0 = blk * kCh;
  const int nwin = (s + kW - 1) / kW;
  const size_t tile = static_cast<size_t>(bi) * s * d_in + d0;
  const T* bb = bm + bi * bc_sb;
  const T* cb = cm + bi * bc_sb;

  // the i-th window's copies (window nwin - 1 - i) into slot i % kStages,
  // then one commit (empty past the end, so that every thread counts the
  // same groups)
  auto issue = [&](int i) {
    if (i < nwin) {
      const int win = nwin - 1 - i, t0 = win * kW, slot = i % kStages;
      for (int c = tid; c < kW * kRow; c += kThreads) {
        const int j = c / kRow, q = (c % kRow) * kE;
        if (t0 + j < s) {
          const size_t off = tile + static_cast<size_t>(t0 + j) * d_in + q;
          cp_async16(&sm.dt[slot][j][q], dt + off);
          cp_async16(&sm.x[slot][j][q], x + off);
          cp_async16(&sm.dy[slot][j][q], dy + off);
        }
      }
      if (tid < kW * 2 * kVec) {
        const int j = tid / (2 * kVec), r = tid % (2 * kVec);
        const int which = r / kVec, q = (r % kVec) * kE;
        if (t0 + j < s)
          cp_async16(&sm.bc[slot][j][which * kN + q],
                     (which ? cb : bb) + (t0 + j) * bc_st + q);
      }
      const float* src =                      // the window's snapshot
          snaps + ((static_cast<size_t>(bi) * nwin + win) * d_in + d0) * kN;
      for (int c = tid; c < kCh * kN / 4; c += kThreads)
        cp_async16(&sm.snap[slot][0][0] + 4 * c, src + 4 * c);
    }
    cp_async_commit();
  };

  float a2[2][4], g[2][4], da[2][4];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const size_t row = static_cast<size_t>(bi) * d_in + d0 + 2 * cp + c;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a2[c][q] = scaled_a(A[(static_cast<size_t>(d0) + 2 * cp + c) * kN
                            + 4 * ng + q]);
      g[c][q] = dh ? dh[row * kN + 4 * ng + q] : 0.f;
      da[c][q] = 0.f;
    }
  }
  // the lanes that write dxc and ddt (even lanes: channel 2 cp + oc) and
  // where each lane's dC or dB sum of a step goes
  const int oc = (lane >> 1) & 1;
  const int vi = lane >> 2;            // 0..3 dC, 4..7 dB of n 4 ng + vi % 4
  float* const red_me = &sm.red[warp][0][(vi >> 2) * kN + 4 * ng + (vi & 3)];
  T* const odx_me = &sm.odx[0][2 * cp + oc];
  T* const oddt_me = &sm.oddt[0][2 * cp + oc];
  // the last backward window, whose dC, dB sums (red) and dxc, ddt (odx,
  // oddt) are still in shared memory: written out after a barrier that
  // follows the writes
  int out_t0 = -1, out_len = 0;
  auto flush = [&]() {
    if (out_t0 < 0) return;
    const int j = tid >> 5, col = tid & 31;
    if (j < out_len) {
      float sum = sm.red[0][j][col];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += sm.red[w][j][col];
      part_bc[((static_cast<size_t>(bi) * s + out_t0 + j) * nblk + blk)
                  * (2 * kN) + col] = sum;
    }
    for (int c = tid; c < 2 * kW * kRow; c += kThreads) {
      const int which = c / (kW * kRow), r = c % (kW * kRow);
      const int jj = r / kRow, q = (r % kRow) * kE;
      if (jj < out_len)
        *reinterpret_cast<uint4*>(
            (which ? ddt : dx) + tile
            + static_cast<size_t>(out_t0 + jj) * d_in + q) =
            *reinterpret_cast<const uint4*>(
                which ? &sm.oddt[jj][q] : &sm.odx[jj][q]);
    }
  };

  issue(0);
  issue(1);
  for (int i = 0; i < nwin; ++i) {
    cp_async_wait<1>();                   // window i landed (this thread's)
    __syncthreads();                      // everyone's; slot i - 1 free
    issue(i + 2);
    const int slot = i % kStages, t0 = (nwin - 1 - i) * kW;
    const int len = min(kW, s - t0);
    for (int e = tid; e < kW * kCh; e += kThreads) {
      const int j = e / kCh, c = e % kCh;
      sm.cdt[j][c] = to_f32(sm.dt[slot][j][c]);
      sm.cx[j][c] = to_f32(sm.x[slot][j][c]);
      sm.cdy[j][c] = to_f32(sm.dy[slot][j][c]);
    }
    (&sm.cbc[0][0])[tid] = to_f32((&sm.bc[slot][0][0])[tid]);
    flush();
    out_t0 = t0;
    out_len = len;
    __syncthreads();                      // the window in f32 for all

    // the window's start state, its snapshot (read again for the last
    // backward step rather than held in registers)
    float h0s[2][4];
    auto start_state = [&]() {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(
            &sm.snap[slot][2 * cp + c][4 * ng]);
        h0s[c][0] = v.x, h0s[c][1] = v.y, h0s[c][2] = v.z, h0s[c][3] = v.w;
      }
    };
    // the window, ``full`` (a std::integral_constant) when it has kW steps:
    // forward through it (its states after each step), then backward
    // through it, last step first
    auto window = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
      start_state();
      float hs[kW][2][4];
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        if (!kFull && j >= len) continue;
        const float2 dtv =
            *reinterpret_cast<const float2*>(&sm.cdt[j][2 * cp]);
        const float2 xv = *reinterpret_cast<const float2*>(&sm.cx[j][2 * cp]);
        const float4 bq =
            *reinterpret_cast<const float4*>(&sm.cbc[j][4 * ng]);
        const float dts[2] = {dtv.x, dtv.y};
        const float u[2] = {__fmul_rn(dtv.x, xv.x), __fmul_rn(dtv.y, xv.y)};
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            hs[j][c][q] = state_step(decay(dts[c], a2[c][q]),
                                     j ? hs[j - 1][c][q] : h0s[c][q], u[c],
                                     bv[q]);
      }
#pragma unroll
      for (int j = kW - 1; j >= 0; --j) {
        if (!kFull && j >= len) continue;
        const float2 dtv =
            *reinterpret_cast<const float2*>(&sm.cdt[j][2 * cp]);
        const float2 xv = *reinterpret_cast<const float2*>(&sm.cx[j][2 * cp]);
        const float2 dyv =
            *reinterpret_cast<const float2*>(&sm.cdy[j][2 * cp]);
        const float4 bq =
            *reinterpret_cast<const float4*>(&sm.cbc[j][4 * ng]);
        const float4 cq =
            *reinterpret_cast<const float4*>(&sm.cbc[j][kN + 4 * ng]);
        const float dts[2] = {dtv.x, dtv.y};
        const float dys[2] = {dyv.x, dyv.y};
        const float u[2] = {__fmul_rn(dtv.x, xv.x), __fmul_rn(dtv.y, xv.y)};
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
        if (j == 0) start_state();
        // v: dC (0..3) and dB (4..7) of the thread's n over its 2
        // channels; r: du, dd of channel 0, then of channel 1
        float v[8], r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[q] = fmaf(dys[1], hs[j][1][q], dys[0] * hs[j][0][q]);
          v[4 + q] = 0.f;
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float du = 0.f, dd = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float gt = fmaf(dys[c], cv[q], g[c][q]);        // g_t
            v[4 + q] = fmaf(gt, u[c], v[4 + q]);
            du = fmaf(gt, bv[q], du);
            const float ga = decay(dts[c], a2[c][q]) * gt;        // g_{t-1}
            const float gha =
                ga * (j ? hs[j - 1][c][q] : h0s[c][q]);           // g h a
            dd = fmaf(gha, a2[c][q], dd);
            da[c][q] = fmaf(gha, dts[c], da[c][q]);
            g[c][q] = ga;
          }
          r[2 * c] = du;
          r[2 * c + 1] = dd * kLn2;
        }
        // du, dd over the 4 lanes of the channel pair: lanes 0, 1 end
        // with channel 0's, lanes 2, 3 with channel 1's
        scatter_level<2, 2>(r, lane);
        r[0] += __shfl_xor_sync(kFull, r[0], 1);
        r[1] += __shfl_xor_sync(kFull, r[1], 1);
        if (!(lane & 1)) {
          odx_me[j * kCh] = from_f32<T>(r[0] * (oc ? dtv.y : dtv.x));
          oddt_me[j * kCh] = from_f32<T>(fmaf(r[0], oc ? xv.y : xv.x, r[1]));
        }
        // dC, dB over the warp's 8 channel pairs: lane ends with value vi
        scatter_level<4, 16>(v, lane);
        scatter_level<2, 8>(reinterpret_cast<float(&)[4]>(v), lane);
        scatter_level<1, 4>(reinterpret_cast<float(&)[2]>(v), lane);
        red_me[j * 2 * kN] = v[0];
      }
    };
    if (len == kW)
      window(std::true_type{});
    else
      window(std::false_type{});
  }
  __syncthreads();
  flush();
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const size_t at =
        (static_cast<size_t>(bi) * d_in + d0 + 2 * cp + c) * kN + 4 * ng;
    *reinterpret_cast<float4*>(part_a + at) =
        make_float4(da[c][0], da[c][1], da[c][2], da[c][3]);
    if (dh0)
      *reinterpret_cast<float4*>(dh0 + at) =
          make_float4(g[c][0], g[c][1], g[c][2], g[c][3]);
  }
}

// dC and dB of each (batch, step): a warp a row, lane c summing the CTAs'
// partials of value c in order (lanes 0..15 dC, 16..31 dB)
template <typename T>
__global__ void __launch_bounds__(256)
    mamba_scan_bwd_ring_sum_bc(const float* __restrict__ part_bc,
                               T* __restrict__ db, T* __restrict__ dc,
                               int rows, int nblk) {
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
    mamba_scan_bwd_ring_sum_a(const float* __restrict__ part_a,
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
  const int smem = static_cast<int>(sizeof(Bwd<T>));
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_bwd_ring_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblk = d_in / kCh;
  mamba_scan_bwd_ring_kernel<T>
      <<<dim3(nblk, b), kThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dt),
          static_cast<const T*>(bm), static_cast<const T*>(cm), bc_sb, bc_st,
          A, snaps, static_cast<const T*>(dy), dh, static_cast<T*>(dx),
          static_cast<T*>(ddt), dh0, part_bc, part_a, s, d_in);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = b * s;
  mamba_scan_bwd_ring_sum_bc<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      part_bc, static_cast<T*>(db), static_cast<T*>(dc), rows, nblk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int count = d_in * kN;
  mamba_scan_bwd_ring_sum_a<<<(count + 255) / 256, 256, 0, stream>>>(
      part_a, da, b, count);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, dt, B, C, dy, dx, ddt, dB, dC). x, dt,
// dy, dx, ddt contiguous (b, s, d_in), d_in a multiple of 128; B and C are
// read at element (b, t, n) = b * bc_sb + t * bc_st + n (base pointers and
// strides 16-byte aligned); dB and dC are written contiguous (b, s, 16).
// snaps: the ring forward's (b, ceil(s / 8), d_in, 16) float32. dh (the
// final state's cotangent) may be null (zero), dh0 null (not asked).
// part_bc: (b, s, d_in / 128, 32) float32, part_a: (b, d_in, 16) float32
// scratch. Returns a CUDA error code, 0 if every launch was accepted.
extern "C" int mamba_scan_bwd_ring(int dtype, const void* x,
                                   const void* dt, const void* bm,
                                   const void* cm, long long bc_sb,
                                   long long bc_st, const void* A,
                                   const void* snaps, const void* dy,
                                   const void* dh, void* dx, void* ddt,
                                   void* db, void* dc, void* da, void* dh0,
                                   void* part_bc, void* part_a, int b, int s,
                                   int d_in, void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  if (b < 1 || s < 1 || d_in < kCh || d_in % kCh || b > 65535 ||
      (dtype != 0 && dtype != 1) || !aligned16(x) || !aligned16(dt) ||
      !aligned16(dy) || !aligned16(bm) || !aligned16(cm) ||
      !aligned16(dx) || !aligned16(ddt) ||
      !aligned16(snaps) || (bc_sb * es) % 16 || (bc_st * es) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0)
    return launch_typed<float>(x, dt, bm, cm, bc_sb, bc_st, f(A), f(snaps),
                               dy, f(dh), dx, ddt, db, dc, w(da), w(dh0),
                               w(part_bc), w(part_a), b, s, d_in, st);
  return launch_typed<__nv_bfloat16>(
      x, dt, bm, cm, bc_sb, bc_st, f(A), f(snaps), dy, f(dh), dx, ddt, db, dc,
      w(da), w(dh0), w(part_bc), w(part_a), b, s, d_in, st);
}

