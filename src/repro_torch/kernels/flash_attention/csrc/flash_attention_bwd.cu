// Flash-attention backward (causal / sliding-window / non-causal, GQA) for
// Hopper, sm_90a: dq, dk and dv of the attention that flash_attention.cu
// ("simt") and flash_attention_hopper.cu ("wgmma") compute forward. This is
// the CUDA-core "simt" backward: it serves what the tensor-core backward
// (flash_attention_bwd_hopper.cu, "wgmma") does not take -- float32, a
// bfloat16 q over float32 k and v, head_dim 32, rows that are not 16-byte
// aligned; ops.py::plan_bwd picks the variant.
//
// Replaces no Pallas kernel: the JAX package trains through jax.grad of its
// XLA reference, repro/kernels/flash_attention/ref.py::attention_ref. This
// kernel computes that gradient from the forward's per-row log-sum-exp,
// recomputing p instead of keeping the (sq, skv) probabilities:
//
//     s_ij  = (f32(q_i) * sm_scale) . f32(k_j)       masked pairs: p = 0
//     p_ij  = exp(s_ij - lse_i)
//     D_i   = sum_d f32(dO_id) * f32(O_id)           (pre-pass)
//     dv_j  = sum_i r(p_ij) * f32(dO_i)               r: bf16 rounding when
//                                                     q is bf16, as the
//                                                     reference rounds p
//                                                     before its PV product
//     dp_ij = f32(dO_i) . f32(v_j)
//     ds_ij = p_ij * (dp_ij - D_i)
//     dq_i  = sm_scale * sum_j ds_ij * f32(k_j)
//     dk_j  = sum_i ds_ij * (f32(q_i) * sm_scale)
//
// with the forward's mask: k_pos < kv_len, causal k_pos <= q_pos, window
// k_pos > q_pos - window, q_pos = q_offset + query index. q-head h reads
// kv-head h / (hq / hkv); dk and dv of a kv-head sum over its q-heads.
//
// What bounds it: at phi3-mini's training shape (4 x 1024 queries, 32 heads
// of 96, causal) the work is ~2.5x the forward's 25.8 GFLOP against ~150 MB,
// far above the card's ~295 operations per byte: the tensor cores are the
// bound (~65 us), and the wgmma variant takes that shape. In float32, the
// cases left here, the bound is the CUDA cores' 67 TFLOP/s. It is a simple,
// deterministic two-pass design on CUDA cores in float32:
//  * delta_kernel: D_i, one warp per (batch, query, q-head) row.
//  * dq_kernel: grid (query tiles of 64, q-heads, batch). A slot of 4
//    threads owns one query row (q, dO and dq in registers, d/4 dims per
//    thread, partial dot products summed by two xor-shuffles); K and V
//    tiles of 64 rows are staged through shared memory as float32. Only
//    the tiles some query of the block can see are visited.
//  * dkv_kernel: grid (key tiles of 64, kv-heads, batch). A slot owns one
//    key row (k, v, dk, dv in registers) and walks the group's q-heads and
//    the query tiles that can see any of its block's keys, with Q (scaled),
//    dO, lse and D staged through shared memory.
// No float atomics: every output element is written by one thread, so
// repeated runs are bit-equal. Loads are scalar (any alignment, unit stride
// along d). All three launch on the caller's stream and allocate nothing;
// the wrapper allocates D and the outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTPR = 4;                   // threads per slot
constexpr int kSlots = kThreads / kTPR;   // 64 rows per block
constexpr int kBlk = kSlots;              // rows per shared-memory tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // (b, hq, sq)
  float* delta;       // (b, hq, sq)
  void* dq;           // (b, sq, hq, d), contiguous, q's type
  void* dk;           // (b, skv, hkv, d), contiguous, k's type
  void* dv;           // (b, skv, hkv, d), contiguous, v's type
  int b, sq, skv, hq, hkv;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  int q_offset, causal, window;
  float sm_scale;
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

// p as the PV product of the forward of a q of type T saw it
__device__ __forceinline__ float pv_round(float p, float) { return p; }
__device__ __forceinline__ float pv_round(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// Rows [r0, r0 + kBlk) of one head, d = D columns, into shared memory as
// float32 times `scale`, row stride LD; rows at or past n read 0.
template <int D, int LD, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t ss,
                                      int r0, int n, float scale) {
  for (int i = threadIdx.x; i < kBlk * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = r0 + r;
    dst[r * LD + c] =
        row < n ? to_f32(src[int64_t(row) * ss + c]) * scale : 0.0f;
  }
}

__device__ __forceinline__ bool visible(const Params& p, int kpos,
                                        int q_pos) {
  bool ok = kpos < p.skv;
  if (p.causal) ok = ok && kpos <= q_pos;
  if (p.window > 0) ok = ok && kpos > q_pos - p.window;
  return ok;
}

// D_i = rowsum(dO_i * O_i): one warp per (batch, query, q-head) row.
template <typename TQ>
__global__ void __launch_bounds__(kThreads) delta_kernel(const Params p,
                                                         int d) {
  const int64_t row = int64_t(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= int64_t(p.b) * p.sq * p.hq) return;
  const int h = int(row % p.hq);
  const int i = int((row / p.hq) % p.sq);
  const int bi = int(row / (int64_t(p.hq) * p.sq));
  const TQ* op = static_cast<const TQ*>(p.o) + bi * p.o_sb +
                 int64_t(i) * p.o_ss + h * p.o_sh;
  const TQ* dp = static_cast<const TQ*>(p.dout) + bi * p.do_sb +
                 int64_t(i) * p.do_ss + h * p.do_sh;
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(to_f32(dp[c]), to_f32(op[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[(int64_t(bi) * p.hq + h) * p.sq + i] = acc;
}

template <int D, typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params p) {
  constexpr int DT = D / kTPR;   // dims per thread
  constexpr int NC = DT / 4;     // float4 chunks per thread
  constexpr int LD = D + 4;      // padded shared-memory row
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kBlk * LD;

  const int slot = threadIdx.x / kTPR, sub = threadIdx.x % kTPR;
  const int q0 = blockIdx.x * kBlk, qi = q0 + slot;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (p.hq / p.hkv);
  const bool row_ok = qi < p.sq;
  const int q_pos = p.q_offset + qi;

  const TQ* qp = static_cast<const TQ*>(p.q) + bi * p.q_sb +
                 int64_t(row_ok ? qi : 0) * p.q_ss + h * p.q_sh;
  const TQ* dop = static_cast<const TQ*>(p.dout) + bi * p.do_sb +
                  int64_t(row_ok ? qi : 0) * p.do_ss + h * p.do_sh;
  // this thread's dims: c * 16 + sub * 4 + e
  float q[DT], dov[DT], dq[DT];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = c * 16 + sub * 4 + e;
      q[c * 4 + e] = row_ok ? to_f32(qp[idx]) * p.sm_scale : 0.0f;
      dov[c * 4 + e] = row_ok ? to_f32(dop[idx]) : 0.0f;
      dq[c * 4 + e] = 0.0f;
    }
  const int64_t stat = (int64_t(bi) * p.hq + h) * p.sq + (row_ok ? qi : 0);
  const float lse = row_ok ? p.lse[stat] : 0.0f;
  const float dlt = row_ok ? p.delta[stat] : 0.0f;

  // the keys [lo, hi] some query of the block can see
  const int qmin = p.q_offset + q0;
  const int qmax = p.q_offset + min(q0 + kBlk, p.sq) - 1;
  const int lo = p.window > 0 ? max(0, qmin - p.window + 1) : 0;
  const int hi = p.causal ? min(p.skv - 1, qmax) : p.skv - 1;
  const TKV* kp = static_cast<const TKV*>(p.k) + bi * p.k_sb + g * p.k_sh;
  const TKV* vp = static_cast<const TKV*>(p.v) + bi * p.v_sb + g * p.v_sh;
  for (int kt = (lo / kBlk) * kBlk; kt <= hi; kt += kBlk) {
    __syncthreads();   // the previous tile is consumed
    stage<D, LD, TKV>(ks, kp, p.k_ss, kt, p.skv, 1.0f);
    stage<D, LD, TKV>(vs, vp, p.v_ss, kt, p.skv, 1.0f);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < kBlk; ++j) {
      const float* kr = ks + j * LD + sub * 4;
      const float* vr = vs + j * LD + sub * 4;
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int u = 0; u < NC; ++u) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + u * 16);
        const float4 vv = *reinterpret_cast<const float4*>(vr + u * 16);
        s = fmaf(q[u * 4], kk.x, s);
        s = fmaf(q[u * 4 + 1], kk.y, s);
        s = fmaf(q[u * 4 + 2], kk.z, s);
        s = fmaf(q[u * 4 + 3], kk.w, s);
        dp = fmaf(dov[u * 4], vv.x, dp);
        dp = fmaf(dov[u * 4 + 1], vv.y, dp);
        dp = fmaf(dov[u * 4 + 2], vv.z, dp);
        dp = fmaf(dov[u * 4 + 3], vv.w, dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      const bool ok = row_ok && visible(p, kt + j, q_pos);
      const float pr = ok ? expf(s - lse) : 0.0f;
      const float ds = pr * (dp - dlt);
#pragma unroll
      for (int u = 0; u < NC; ++u) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + u * 16);
        dq[u * 4] = fmaf(ds, kk.x, dq[u * 4]);
        dq[u * 4 + 1] = fmaf(ds, kk.y, dq[u * 4 + 1]);
        dq[u * 4 + 2] = fmaf(ds, kk.z, dq[u * 4 + 2]);
        dq[u * 4 + 3] = fmaf(ds, kk.w, dq[u * 4 + 3]);
      }
    }
  }
  if (!row_ok) return;
  TQ* out = static_cast<TQ*>(p.dq) +
            ((int64_t(bi) * p.sq + qi) * p.hq + h) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[c * 16 + sub * 4 + e] = from_f32<TQ>(dq[c * 4 + e] * p.sm_scale);
}

template <int D, typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Params p) {
  constexpr int DT = D / kTPR;
  constexpr int NC = DT / 4;
  constexpr int LD = D + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // q * sm_scale
  float* dos = qs + kBlk * LD;
  float* lse_s = dos + kBlk * LD;
  float* dlt_s = lse_s + kBlk;

  const int slot = threadIdx.x / kTPR, sub = threadIdx.x % kTPR;
  const int k0 = blockIdx.x * kBlk, kj = k0 + slot;
  const int g = blockIdx.y, bi = blockIdx.z;
  const int group = p.hq / p.hkv;
  const bool key_ok = kj < p.skv;

  const TKV* kp = static_cast<const TKV*>(p.k) + bi * p.k_sb +
                  int64_t(key_ok ? kj : 0) * p.k_ss + g * p.k_sh;
  const TKV* vp = static_cast<const TKV*>(p.v) + bi * p.v_sb +
                  int64_t(key_ok ? kj : 0) * p.v_ss + g * p.v_sh;
  float k[DT], v[DT], dk[DT], dv[DT];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = c * 16 + sub * 4 + e;
      k[c * 4 + e] = key_ok ? to_f32(kp[idx]) : 0.0f;
      v[c * 4 + e] = key_ok ? to_f32(vp[idx]) : 0.0f;
      dk[c * 4 + e] = 0.0f;
      dv[c * 4 + e] = 0.0f;
    }

  // the queries [i_lo, i_hi) that can see some key of the block
  const int kmax = min(k0 + kBlk, p.skv) - 1;
  const int i_lo = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int i_hi =
      p.window > 0 ? min(p.sq, kmax + p.window - p.q_offset) : p.sq;
  for (int hh = 0; hh < group; ++hh) {
    const int h = g * group + hh;
    const TQ* qp = static_cast<const TQ*>(p.q) + bi * p.q_sb + h * p.q_sh;
    const TQ* dop =
        static_cast<const TQ*>(p.dout) + bi * p.do_sb + h * p.do_sh;
    const int64_t stat = (int64_t(bi) * p.hq + h) * p.sq;
    for (int i0 = i_lo; i0 < i_hi; i0 += kBlk) {
      __syncthreads();   // the previous tile is consumed
      stage<D, LD, TQ>(qs, qp, p.q_ss, i0, p.sq, p.sm_scale);
      stage<D, LD, TQ>(dos, dop, p.do_ss, i0, p.sq, 1.0f);
      if (threadIdx.x < kBlk) {
        const int i = i0 + threadIdx.x;
        lse_s[threadIdx.x] = i < p.sq ? p.lse[stat + i] : 0.0f;
        dlt_s[threadIdx.x] = i < p.sq ? p.delta[stat + i] : 0.0f;
      }
      __syncthreads();
      const int rows = min(kBlk, i_hi - i0);
#pragma unroll 1
      for (int r = 0; r < rows; ++r) {
        const float* qr = qs + r * LD + sub * 4;
        const float* dr = dos + r * LD + sub * 4;
        float s = 0.0f, dp = 0.0f;
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          const float4 qq = *reinterpret_cast<const float4*>(qr + u * 16);
          const float4 dd = *reinterpret_cast<const float4*>(dr + u * 16);
          s = fmaf(qq.x, k[u * 4], s);
          s = fmaf(qq.y, k[u * 4 + 1], s);
          s = fmaf(qq.z, k[u * 4 + 2], s);
          s = fmaf(qq.w, k[u * 4 + 3], s);
          dp = fmaf(dd.x, v[u * 4], dp);
          dp = fmaf(dd.y, v[u * 4 + 1], dp);
          dp = fmaf(dd.z, v[u * 4 + 2], dp);
          dp = fmaf(dd.w, v[u * 4 + 3], dp);
        }
        s = quad_sum(s);
        dp = quad_sum(dp);
        const bool ok = key_ok && visible(p, kj, p.q_offset + i0 + r);
        const float pr = ok ? expf(s - lse_s[r]) : 0.0f;
        const float pb = pv_round(pr, TQ());
        const float ds = pr * (dp - dlt_s[r]);
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          const float4 qq = *reinterpret_cast<const float4*>(qr + u * 16);
          const float4 dd = *reinterpret_cast<const float4*>(dr + u * 16);
          dv[u * 4] = fmaf(pb, dd.x, dv[u * 4]);
          dv[u * 4 + 1] = fmaf(pb, dd.y, dv[u * 4 + 1]);
          dv[u * 4 + 2] = fmaf(pb, dd.z, dv[u * 4 + 2]);
          dv[u * 4 + 3] = fmaf(pb, dd.w, dv[u * 4 + 3]);
          dk[u * 4] = fmaf(ds, qq.x, dk[u * 4]);
          dk[u * 4 + 1] = fmaf(ds, qq.y, dk[u * 4 + 1]);
          dk[u * 4 + 2] = fmaf(ds, qq.z, dk[u * 4 + 2]);
          dk[u * 4 + 3] = fmaf(ds, qq.w, dk[u * 4 + 3]);
        }
      }
    }
  }
  if (!key_ok) return;
  const int64_t at = ((int64_t(bi) * p.skv + kj) * p.hkv + g) * D;
  TKV* dko = static_cast<TKV*>(p.dk) + at;
  TKV* dvo = static_cast<TKV*>(p.dv) + at;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dko[c * 16 + sub * 4 + e] = from_f32<TKV>(dk[c * 4 + e]);
      dvo[c * 16 + sub * 4 + e] = from_f32<TKV>(dv[c * 4 + e]);
    }
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int D, typename TQ, typename TKV>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int LD = D + 4;
  const size_t dq_smem = 2 * kBlk * LD * sizeof(float);
  const size_t dkv_smem = (2 * kBlk * LD + 2 * kBlk) * sizeof(float);
  int err = prepare(dq_kernel<D, TQ, TKV>, dq_smem);
  if (!err) err = prepare(dkv_kernel<D, TQ, TKV>, dkv_smem);
  if (err) return err;
  const int64_t rows = int64_t(p.b) * p.sq * p.hq;
  const int64_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<TQ><<<unsigned(blocks), kThreads, 0, stream>>>(p, D);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dq_kernel<D, TQ, TKV>
      <<<dim3((p.sq + kBlk - 1) / kBlk, p.hq, p.b), kThreads, dq_smem,
          stream>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dkv_kernel<D, TQ, TKV>
      <<<dim3((p.skv + kBlk - 1) / kBlk, p.hkv, p.b), kThreads, dkv_smem,
          stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int by_dim(int d, const Params& p, cudaStream_t s) {
  switch (d) {
    case 32: return launch<32, TQ, TKV>(p, s);
    case 64: return launch<64, TQ, TKV>(p, s);
    case 96: return launch<96, TQ, TKV>(p, s);
    case 128: return launch<128, TQ, TKV>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_dtype, kv_dtype: 0 = float32, 1 = bfloat16 (o and dout have q's type).
// Shapes q, o, dout (b, sq, hq, d), k/v (b, skv, hkv, d); strides (*_sb,
// *_ss, *_sh) in elements for the batch, sequence and head axes, unit stride
// along d. lse: the forward's float32 log-sum-exp of the scaled scores,
// (b, hq, sq) contiguous; delta: float32 scratch of the same shape. dq (q's
// type) and dk, dv (k's type) are written contiguous in the layouts of q
// and k. Three launches (D, dq, dk/dv); returns the first cudaError_t (0 on
// success).
extern "C" int flash_attention_bwd(
    int q_dtype, int kv_dtype, int head_dim, const void* q, const void* k,
    const void* v, const void* o, const void* dout, const float* lse,
    float* delta, void* dq, void* dk, void* dv, int b, int sq, int skv,
    int hq, int hkv, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t do_sb, int64_t do_ss,
    int64_t do_sh, int q_offset, int causal, int window, float sm_scale,
    void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || hq < 1 || hkv < 1 || hq % hkv ||
      b > 65535 || hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    o,    dout, lse,  delta, dq,
                 dk,   dv,   b,    sq,   skv,  hq,   hkv,   q_sb,
                 q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,  v_sh,
                 o_sb, o_ss, o_sh, do_sb, do_ss, do_sh, q_offset, causal,
                 window, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return by_dim<float, float>(head_dim, p, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return by_dim<float, __nv_bfloat16>(head_dim, p, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return by_dim<__nv_bfloat16, float>(head_dim, p, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_dim<__nv_bfloat16, __nv_bfloat16>(head_dim, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
