// The MoE router's backward for Hopper, sm_90a: the gradient of the router
// logits from the gradients of the top-k gates and of mean_prob.
//
// Replaces no Pallas kernel: the reference trains through jax.grad of its
// XLA route_ref (repro/kernels/moe_router/ref.py:16: softmax, top_k's
// gather, the renormalisation, probs.mean(0)) and of the router product
// around it (repro/models/moe.py:73). Per token row, with l its float32
// logits, p = softmax(l), g_j = p[idx_j], s = sum_j g_j:
//
//     dg_j  = (dG_j - sum_i dG_i gates_i) / max(s, 1e-20)   (renormalised;
//                                                              else dG_j)
//     dp[e] = sum_j [idx_j = e] dg_j + dM[e] / T
//     dl    = p * (dp - sum_e p_e dp_e)
//
// T = t counts every row mean_prob averaged over (a padded group's zero
// rows are rows of the routed tensor); frac_tokens is a count and carries no gradient. The products dx = dl w^T
// and dw = f32(x)^T dl stay with the caller (the plain router product the
// reference leaves to XLA).
//
// What bounds it: bytes. deepseek's training shape (4,096 rows, E 64, k 6)
// reads 1 MB of logits and 0.3 MB of ids, gates and dG and writes 1 MB of
// dl: 0.7 us at 3.35 TB/s; ~25 float32 operations an element are 6.5
// MFLOP. A simple kernel: one warp a row, lane l holding experts l and
// l + 32; max, sum and the dot product by xor butterflies, the chosen
// experts' dg through registers; no shared memory and no float atomics, so
// two launches are bit-equal. The kernel runs on the caller's stream and
// allocates nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;          // rows a block
constexpr int kMaxExperts = 64;
constexpr int kMaxK = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
    router_bwd_kernel(const float* __restrict__ logits,
                      const int32_t* __restrict__ idx,
                      const float* __restrict__ gates,
                      const float* __restrict__ dgates,
                      const float* __restrict__ dmean, float* __restrict__ dl,
                      int t, int e, int k, int renorm) {
  const int lane = threadIdx.x & 31;
  const int64_t row = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= t) return;  // a whole warp leaves together
  const float* lr = logits + row * e;
  const bool has0 = lane < e, has1 = lane + 32 < e;
  const float neg_inf = __int_as_float(0xff800000);
  const float l0 = has0 ? lr[lane] : neg_inf;
  const float l1 = has1 ? lr[lane + 32] : neg_inf;
  const float mx = warp_max(fmaxf(l0, l1));
  float p0 = has0 ? expf(l0 - mx) : 0.0f;
  float p1 = has1 ? expf(l1 - mx) : 0.0f;
  const float sum = warp_sum(p0 + p1);
  p0 = __fdiv_rn(p0, sum);
  p1 = __fdiv_rn(p1, sum);

  // choice j's id, gate and dG in lane j (k <= 64: lanes j and j + 32)
  const int64_t o = row * k;
  int id[2] = {-1, -1};
  float dg[2] = {0.0f, 0.0f}, gt[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    if (j < k) {
      id[h] = idx[o + j];
      gt[h] = gates[o + j];
      dg[h] = dgates[o + j];
    }
  }
  if (renorm) {
    // s = sum_j p[idx_j]: each choice's p read from the lane holding it
    float s = 0.0f, c = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ex = id[h] < 0 ? 0 : id[h];
      const float pa = __shfl_sync(kFull, p0, ex & 31);
      const float pb = __shfl_sync(kFull, p1, ex & 31);
      if (id[h] >= 0) s += ex < 32 ? pa : pb;
      c += dg[h] * gt[h];
    }
    s = fmaxf(warp_sum(s), 1e-20f);
    c = warp_sum(c);
#pragma unroll
    for (int h = 0; h < 2; ++h) dg[h] = __fdiv_rn(dg[h] - c, s);
  }
  // dp of this lane's experts: dM / T plus the dg of a choice naming it
  const float rows = static_cast<float>(t);
  float dp0 = has0 ? __fdiv_rn(dmean[lane], rows) : 0.0f;
  float dp1 = has1 ? __fdiv_rn(dmean[lane + 32], rows) : 0.0f;
  for (int j = 0; j < k; ++j) {
    const int ex = __shfl_sync(kFull, j < 32 ? id[0] : id[1], j & 31);
    const float d = __shfl_sync(kFull, j < 32 ? dg[0] : dg[1], j & 31);
    if (ex == lane) dp0 += d;
    if (ex == lane + 32) dp1 += d;
  }
  const float dot = warp_sum(p0 * dp0 + p1 * dp1);
  float* dr = dl + row * e;
  if (has0) dr[lane] = p0 * (dp0 - dot);
  if (has1) dr[lane + 32] = p1 * (dp1 - dot);
}

}  // namespace

// logits (t, e) float32, idx (t, k) int32, gates and dgates (t, k)
// float32, dmean (e,) float32, dl (t, e) float32: all contiguous.
// 1 <= k <= e <= 64. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int moe_router_bwd(const float* logits, const int32_t* idx,
                              const float* gates, const float* dgates,
                              const float* dmean, float* dl, int t, int e,
                              int k, int renorm, void* stream) {
  if (t < 1 || e < 1 || e > kMaxExperts || k < 1 || k > e || k > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (t + kWarps - 1) / kWarps;
  router_bwd_kernel<<<blocks, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      logits, idx, gates, dgates, dmean, dl, t, e, k, renorm);
  return static_cast<int>(cudaGetLastError());
}
