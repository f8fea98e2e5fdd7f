// Flash-attention backward on Hopper's tensor cores (sm_90a), the "wgmma"
// variant: dq, dk and dv of the attention that flash_attention.cu ("simt")
// and flash_attention_hopper.cu ("wgmma") compute forward, for bfloat16 q,
// k, v, out and dout, head_dim 64, 96 or 128, 16-byte aligned rows with unit
// stride along d. Everything else runs the CUDA-core backward beside it
// (flash_attention_bwd.cu, "simt"); ops.py::plan_bwd picks the variant.
//
// Replaces no Pallas kernel: the JAX package trains through jax.grad of its
// XLA reference, repro/kernels/flash_attention/ref.py::attention_ref. It
// computes that gradient from the forward's per-row log-sum-exp, with the
// mask k_pos < kv_len, causal k_pos <= q_pos, window k_pos > q_pos - window,
// q_pos = q_offset + query index; q-head h reads kv-head h / (hq / hkv), and
// dk, dv of a kv-head sum over its q-heads:
//
//     p_ij  = exp2(s_ij * sm_scale * log2(e) - lse_i * log2(e))   s = q.k
//     D_i   = sum_d dO_id * O_id
//     dv_j  = sum_i r(p_ij) dO_i         r: rounding to bf16, as the JAX
//     dp_ij = dO_i . v_j                    reference rounds p before PV
//     ds_ij = p_ij (dp_ij - D_i)
//     dq_i  = sm_scale sum_j r(ds_ij) k_j
//     dk_j  = sm_scale sum_i r(ds_ij) q_i
//
// The tensor cores take bf16 operands, so ds is rounded to bf16 before the
// dq and dk products as well (ref.py::attention_bwd_ref(variant="wgmma")
// models it; the reference keeps ds in f32).
//
// What bounds it: at phi3-mini's training shape (4 x 1,024 queries, 32 heads
// of 96, causal) 64.5 GFLOP (five products of 2 x 64 x 64 x d per live 64 x
// 64 block) against 202 MB: the tensor cores (65 us at 989 TFLOP/s). Design:
//  * Three launches, no float atomics, so two launches are bit-equal:
//    delta_kernel writes D and lse * log2(e) per query row into (b, hq,
//    sq_pad) f32 buffers (0 past sq), one warp a row; dq_kernel keeps
//    queries stationary, dkv_kernel keys. Seven products against the five
//    of the bound: the price of determinism (S and dP are formed twice).
//  * A CTA is a producer warpgroup, of which one thread issues every TMA
//    copy and the rest only give back registers (setmaxnreg 24), and two
//    consumer warpgroups of 64 rows each (setmaxnreg 240).
//  * dkv_kernel, grid (b * hkv, key blocks of 128): the block's K and V come
//    in once; the group's q-heads and the q tiles of 64 rows that can see
//    any of its keys stream through a ring of kStages stages (Q and dO by
//    TMA, lse * log2(e) and D by 1-D bulk copies), one full and one empty
//    mbarrier a stage. Per q tile a warpgroup runs S^T = K.Q^T and dP^T =
//    V.dO^T (both operands K-major in shared memory), p and ds in registers
//    (one FFMA before ex2), then dV += r(P^T).dO and dK += r(dS^T).Q with A
//    from registers (the accumulator layout of S^T is the A-fragment
//    layout) and B MN-major (the transpose bit set).
//  * Masks: p is formed for every pair, and only on a tile that crosses
//    the diagonal, the window edge or kv_len does a second loop set the
//    masked pairs' p to 0 (their ex2 may be inf). Testing each pair on
//    every tile took half of a step's time
//    (scripts/attention_bwd_variants.py --trace).
//  * dq_kernel, grid (b * hq, query blocks of 128): the block's Q and dO
//    come in once; the key tiles of 64 that any of its queries can see
//    stream through the ring. Per key tile: S = Q.K^T, dP = dO.V^T, dQ +=
//    r(dS).K.
//  * Tiles are 64-column boxes with the 128-byte swizzle. At head_dim 96 a
//    row is a full box and half a box that TMA fills with zeros; the S and
//    dP products run 6 k-steps (d = 96) and the output products n96.
//  * Key blocks run heaviest first (the first keys of a causal mask are
//    seen by the most queries), query blocks too (the last).
//  * dq, dk and dv are written from registers as bf16 pairs, contiguous.
// All launch on the caller's stream and allocate nothing.

#include "hopper.cuh"   // mbarriers, TMA, wgmma forms, tensor maps

namespace {

constexpr int kRows = 64;           // rows of a tile and of a warpgroup
constexpr int kBlock = 128;         // rows a CTA keeps: two warpgroups
constexpr int kStages = 3;          // ring of streamed tiles
constexpr int kThreads = 3 * 128;   // 2 consumer warpgroups + producer
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  int sq, skv, hq, hkv, group, q_offset, causal, window;
  int sq_pad;            // rows of lse2 and delta per (batch, q-head)
  float scale_log2;      // sm_scale * log2(e)
  float sm_scale;
  const float* lse2;     // (b, hq, sq_pad): lse * log2(e), 0 past sq
  const float* delta;    // (b, hq, sq_pad): D, 0 past sq
  __nv_bfloat16* dq;     // (b, sq, hq, d) contiguous
  __nv_bfloat16* dk;     // (b, skv, hkv, d) contiguous
  __nv_bfloat16* dv;
};

// Shared memory of either pass: the block's two stationary operands (A, B:
// K and V, or Q and dO; NB boxes of kBlock rows each), then the ring (X, Y:
// Q and dO, or K and V; NB boxes of kRows rows), then two f32 vectors of
// kRows a stage (lse2 and D; used by dkv_kernel), then the barriers.
template <int D>
struct Smem {
  static constexpr int NB = (D + kBox - 1) / kBox;   // boxes per row
  static constexpr int kStat = NB * kBlock * 128;    // bytes of A (or B)
  static constexpr int kTile = NB * kRows * 128;     // bytes of X (or Y)
  static constexpr int kA = 0, kB = kStat;
  static constexpr int kX = 2 * kStat;               // + stage * kTile
  static constexpr int kY = kX + kStages * kTile;
  static constexpr int kL = kY + kStages * kTile;    // + stage * 256
  static constexpr int kDl = kL + kStages * kRows * 4;
  static constexpr int kBar = kDl + kStages * kRows * 4;
  // stat_full, full[S], empty[S]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
};

// 1-D bulk copy of `bytes` (a multiple of 16, 16-byte aligned) into shared
// memory; completes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// kBlock rows from row r0 of (head h, batch bi) into NB boxes of kBlock rows
// (two 64-row loads a box), or kRows rows into NB boxes of kRows rows.
template <int NB, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int h, int r0,
                                          int bi) {
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int half = 0; half < ROWS / kRows; ++half)
      tma_load(dst + c * ROWS * 128 + half * kRows * 128, map, bar, c * kBox,
               h, r0 + half * kRows, bi);
}

// acc (64 x 64) = A . B^T over head_dim, 16 at a time: A (this warpgroup's
// 64 rows) and B (64 rows) K-major, each NB boxes of a_box / b_box bytes.
template <int D>
__device__ __forceinline__ void issue_s(float (&acc)[32], uint32_t a,
                                        uint32_t a_box, uint32_t b,
                                        uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(acc,
                 smem_desc(a + (kk / 4) * a_box + (kk % 4) * 32, 16, 1024),
                 smem_desc(b + (kk / 4) * b_box + (kk % 4) * 32, 16, 1024),
                 kk > 0);
}

// acc (64 x D) += A . B over a tile's 64 rows, 16 at a time: A from
// registers, B (64 rows of D columns, boxes of kRows rows) MN-major.
template <int D>
__device__ __forceinline__ void issue_out(float (&acc)[D / 2],
                                          const uint32_t (&a)[4][4],
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = smem_desc(b + kk * 16 * 128, kRows * 128, 1024);
    if constexpr (D == 128)
      wgmma_rs_n128(acc, a[kk], db);
    else if constexpr (D == 96)
      wgmma_rs_n96(acc, a[kk], db);
    else
      wgmma_rs_n64(acc, a[kk], db);
  }
}

// A 64 x 64 accumulator as bf16 A fragments: k-step kk holds columns
// [16 kk, 16 kk + 16); no data moves.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

__device__ __forceinline__ bool visible(const BwdParams& p, int kpos,
                                        int qpos) {
  bool ok = kpos < p.skv;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// Whether some (key, query) pair of keys [k0, k0 + 64) and query positions
// [qp0, qp0 + 64) is masked: the tile crosses kv_len, the diagonal or the
// window's edge.
__device__ __forceinline__ bool edge_tile(const BwdParams& p, int k0,
                                          int qp0) {
  return k0 + kRows > p.skv || (p.causal && k0 + kRows - 1 > qp0) ||
         (p.window > 0 && k0 <= qp0 + kRows - 1 - p.window);
}

// Writes acc * scale (this warpgroup's 64 rows of D columns) as bf16 into
// rows [r0, r0 + 64) of out, a row every `ld` elements, leaving out rows at
// or past n.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, int64_t ld,
                                           int r0, int n,
                                           const float (&acc)[D / 2],
                                           float scale) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + warp * 16 + lane / 4 + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* dst = out + row * ld + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r] * scale,
                    acc[4 * j + 2 * r + 1] * scale);
  }
}

// --- D pre-pass -------------------------------------------------------------

struct DeltaParams {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;   // (b, hq, sq)
  float* lse2;        // (b, hq, sq_pad)
  float* delta;       // (b, hq, sq_pad)
  int64_t o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  int sq, hq, sq_pad, d;
  int64_t rows;       // b * hq * sq_pad
};

// D_i = rowsum(dO_i * O_i) and lse_i * log2(e), 0 past sq: one warp a row,
// 16-byte loads.
__global__ void __launch_bounds__(256) delta_kernel(const DeltaParams p) {
  const int64_t row = int64_t(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.rows) return;
  const int i = int(row % p.sq_pad);
  const int64_t bh = row / p.sq_pad;
  const int h = int(bh % p.hq), bi = int(bh / p.hq);
  float acc = 0.0f;
  if (i < p.sq) {
    const __nv_bfloat16* op = p.o + bi * p.o_sb + int64_t(i) * p.o_ss +
                              h * p.o_sh;
    const __nv_bfloat16* dp = p.dout + bi * p.do_sb + int64_t(i) * p.do_ss +
                              h * p.do_sh;
    for (int c = lane * 8; c < p.d; c += 32 * 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(op + c);
      const uint4 g = *reinterpret_cast<const uint4*>(dp + c);
      const uint32_t wa[4] = {a.x, a.y, a.z, a.w};
      const uint32_t wg[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc = fmaf(__uint_as_float(wg[e] << 16), __uint_as_float(wa[e] << 16),
                   acc);
        acc = fmaf(__uint_as_float(wg[e] & 0xffff0000u),
                   __uint_as_float(wa[e] & 0xffff0000u), acc);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    p.delta[row] = acc;
    p.lse2[row] = i < p.sq ? p.lse[bh * p.sq + i] * kLog2e : 0.0f;
  }
}

// --- dK / dV: keys stationary -----------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_do,
               const BwdParams p) {
  using L = Smem<D>;
  constexpr int NB = L::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(smem);
  const float* lse_s = reinterpret_cast<const float*>(smem + L::kL);
  const float* dl_s = reinterpret_cast<const float*>(smem + L::kDl);
  const uint32_t bar_kv = s_base + L::kBar;
  const uint32_t bar_f = bar_kv + 8;                // + 8 * stage
  const uint32_t bar_e = bar_f + 8 * kStages;

  const int hk = blockIdx.x % p.hkv, bi = blockIdx.x / p.hkv;
  const int k0 = blockIdx.y * kBlock;
  // the q tiles [t0, t0 + nt) that can see some key of [k0, kmax]
  const int kmax = min(k0 + kBlock, p.skv) - 1;
  const int i_lo = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int i_hi = p.window > 0 ? min(p.sq, kmax + p.window - p.q_offset)
                                : p.sq;
  const int t0 = i_lo / kRows;
  const int nt = i_hi > i_lo ? (i_hi + kRows - 1) / kRows - t0 : 0;
  const int n = nt * p.group;   // (q-head, q tile) steps

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_f + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_kv, 2 * L::kStat);
      load_rows<NB, kBlock>(s_base + L::kA, &tm_k, bar_kv, hk, k0, bi);
      load_rows<NB, kBlock>(s_base + L::kB, &tm_v, bar_kv, hk, k0, bi);
      for (int it = 0; it < n; ++it) {
        const int s = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int h = hk * p.group + it / nt;
        const int i0 = (t0 + it % nt) * kRows;
        mbar_wait(bar_e + 8 * s, ph ^ 1);
        const uint32_t full = bar_f + 8 * s;
        mbar_expect_tx(full, 2 * L::kTile + 2 * kRows * 4);
        load_rows<NB, kRows>(s_base + L::kX + s * L::kTile, &tm_q, full, h,
                             i0, bi);
        load_rows<NB, kRows>(s_base + L::kY + s * L::kTile, &tm_do, full, h,
                             i0, bi);
        const int64_t stat = (int64_t(bi) * p.hq + h) * p.sq_pad + i0;
        bulk_load(s_base + L::kL + s * kRows * 4, p.lse2 + stat, kRows * 4,
                  full);
        bulk_load(s_base + L::kDl + s * kRows * 4, p.delta + stat, kRows * 4,
                  full);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int kw0 = k0 + wg * kRows;
  const int key0 = kw0 + warp * 16 + lane / 4;   // this thread's keys: key0,
  const int col = 2 * (lane % 4);                // key0 + 8; query columns
                                                 // col + 8 j + {0, 1}
  float dv[D / 2], dk[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv[i] = dk[i] = 0.0f;
  float st[32], dpt[32];
  uint32_t pa[4][4], da[4][4];

  const uint32_t k_addr = s_base + L::kA + wg * kRows * 128;
  const uint32_t v_addr = s_base + L::kB + wg * kRows * 128;
  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % kStages;
    const int qp0 = p.q_offset + (t0 + it % nt) * kRows;
    const uint32_t q_addr = s_base + L::kX + s * L::kTile;
    const uint32_t do_addr = s_base + L::kY + s * L::kTile;
    mbar_wait(bar_f + 8 * s, (it / kStages) & 1);
    wgmma_fence();
    issue_s<D>(st, k_addr, kBlock * 128, q_addr, kRows * 128);
    wgmma_commit();
    issue_s<D>(dpt, v_addr, kBlock * 128, do_addr, kRows * 128);
    wgmma_commit();
    wgmma_wait<1>();   // S^T; dP^T may still run
    fence_regs(st);
    const float* ls = lse_s + s * kRows;
    const float* dl = dl_s + s * kRows;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + col);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[4 * j + e] = ex2(fmaf(st[4 * j + e], p.scale_log2,
                                 -(e % 2 ? l2.y : l2.x)));
    }
    if (edge_tile(p, kw0, qp0)) {   // masked pairs: p = 0 (ex2 may be inf)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!visible(p, key0 + 8 * ((i / 2) % 2),
                     qp0 + (i / 4) * 8 + col + i % 2))
          st[i] = 0.0f;
    }
    pack_a(pa, st);
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        dpt[i] = st[i] * (dpt[i] - (e % 2 ? d2.y : d2.x));
      }
    }
    pack_a(da, dpt);
    wgmma_fence();
    issue_out<D>(dv, pa, do_addr);
    issue_out<D>(dk, da, q_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(bar_e + 8 * s);   // Q, dO, lse2, D of this stage consumed
  }

  const int64_t ld = int64_t(p.hkv) * D;
  const int64_t base = (int64_t(bi) * p.skv * p.hkv + hk) * D;
  store_rows<D>(p.dk + base, ld, kw0, p.skv, dk, p.sm_scale);
  store_rows<D>(p.dv + base, ld, kw0, p.skv, dv, 1.0f);
}

// --- dQ: queries stationary -------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_do,
              const BwdParams p) {
  using L = Smem<D>;
  constexpr int NB = L::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_qd = s_base + L::kBar;
  const uint32_t bar_f = bar_qd + 8;
  const uint32_t bar_e = bar_f + 8 * kStages;

  const int h = blockIdx.x % p.hq, bi = blockIdx.x / p.hq;
  const int hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;   // heaviest first
  // the key tiles [t0, t0 + nt) that some query of [q0, q0 + 128) can see
  const int qp0 = p.q_offset + q0;
  const int qp1 = p.q_offset + min(q0 + kBlock, p.sq) - 1;
  const int lo = p.window > 0 ? max(0, qp0 - p.window + 1) : 0;
  const int hi = p.causal ? min(p.skv - 1, qp1) : p.skv - 1;
  const int t0 = lo / kRows;
  const int nt = hi >= lo ? hi / kRows + 1 - t0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_qd, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_f + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_qd, 2 * L::kStat);
      load_rows<NB, kBlock>(s_base + L::kA, &tm_q, bar_qd, h, q0, bi);
      load_rows<NB, kBlock>(s_base + L::kB, &tm_do, bar_qd, h, q0, bi);
      for (int it = 0; it < nt; ++it) {
        const int s = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int kt = (t0 + it) * kRows;
        mbar_wait(bar_e + 8 * s, ph ^ 1);
        const uint32_t full = bar_f + 8 * s;
        mbar_expect_tx(full, 2 * L::kTile);
        load_rows<NB, kRows>(s_base + L::kX + s * L::kTile, &tm_k, full, hk,
                             kt, bi);
        load_rows<NB, kRows>(s_base + L::kY + s * L::kTile, &tm_v, full, hk,
                             kt, bi);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns queries [q0 + 64 wg, q0 + 64 wg + 64) --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int ra = q0 + wg * kRows + warp * 16 + lane / 4;   // rows ra, ra + 8
  const int col = 2 * (lane % 4);                          // key columns
  const int wq0 = p.q_offset + q0 + wg * kRows;            // col + 8 j + {0,1}
  float lse2[2], dlt[2];
  const int64_t stat = (int64_t(bi) * p.hq + h) * p.sq_pad;
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // rows < q0 + 128 <= sq_pad
    lse2[r] = p.lse2[stat + ra + 8 * r];
    dlt[r] = p.delta[stat + ra + 8 * r];
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
  float sc[32], dp[32];
  uint32_t da[4][4];

  const uint32_t q_addr = s_base + L::kA + wg * kRows * 128;
  const uint32_t do_addr = s_base + L::kB + wg * kRows * 128;
  mbar_wait(bar_qd, 0);
  for (int it = 0; it < nt; ++it) {
    const int s = it % kStages;
    const int kt = (t0 + it) * kRows;
    const uint32_t k_addr = s_base + L::kX + s * L::kTile;
    const uint32_t v_addr = s_base + L::kY + s * L::kTile;
    mbar_wait(bar_f + 8 * s, (it / kStages) & 1);
    wgmma_fence();
    issue_s<D>(sc, q_addr, kBlock * 128, k_addr, kRows * 128);
    wgmma_commit();
    issue_s<D>(dp, do_addr, kBlock * 128, v_addr, kRows * 128);
    wgmma_commit();
    wgmma_wait<1>();   // S; dP may still run
    fence_regs(sc);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      sc[i] = ex2(fmaf(sc[i], p.scale_log2, -lse2[(i / 2) % 2]));
    if (edge_tile(p, kt, wq0)) {   // masked pairs: p = 0 (ex2 may be inf)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!visible(p, kt + (i / 4) * 8 + col + i % 2,
                     p.q_offset + ra + 8 * ((i / 2) % 2)))
          sc[i] = 0.0f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dlt[(i / 2) % 2]);
    pack_a(da, dp);
    wgmma_fence();
    issue_out<D>(dq, da, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(bar_e + 8 * s);   // K and V of this stage consumed
  }

  store_rows<D>(p.dq + (int64_t(bi) * p.sq * p.hq + h) * D,
                int64_t(p.hq) * D, q0 + wg * kRows, p.sq, dq, p.sm_scale);
}

// --- host -------------------------------------------------------------------

template <int D>
int launch(const CUtensorMap (&tm)[4], const DeltaParams& dp,
           const BwdParams& p, int b, cudaStream_t stream) {
  constexpr int smem = Smem<D>::kBytes + 1024;   // + alignment slack
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  delta_kernel<<<unsigned((dp.rows + 7) / 8), 256, 0, stream>>>(dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<D><<<dim3(b * p.hq, (p.sq + kBlock - 1) / kBlock), kThreads,
                 smem, stream>>>(tm[0], tm[1], tm[2], tm[3], p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<D><<<dim3(b * p.hkv, (p.skv + kBlock - 1) / kBlock), kThreads,
                  smem, stream>>>(tm[0], tm[1], tm[2], tm[3], p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tensor-core backward. bfloat16 q, out, dout (b, sq, hq, d) and k, v (b,
// skv, hkv, d); head_dim 64, 96 or 128; strides (*_sb, *_ss, *_sh) in
// elements, unit stride along d, every stride of an axis longer than 1 a
// multiple of 8 elements and every base 16-byte aligned (TMA). lse: the
// forward's float32 log-sum-exp (b, hq, sq) contiguous; lse2 and delta:
// float32 scratch of (b, hq, sq_pad), sq_pad a multiple of 128 no smaller
// than sq, 16-byte aligned. dq (b, sq, hq, d) and dk, dv (b, skv, hkv, d)
// bfloat16, written contiguous. Three launches (D, dq, dk/dv); returns 0, a
// cudaError_t, or 10001 / 10002 + CUresult when a tensor map cannot be made.
extern "C" int flash_attention_bwd_wgmma(
    int head_dim, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* lse2, float* delta, void* dq,
    void* dk, void* dv, int b, int sq, int skv, int hq, int hkv, int sq_pad,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
    int64_t o_ss, int64_t o_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh,
    int q_offset, int causal, int window, float sm_scale, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || hkv < 1 || hq % hkv || sq_pad < sq ||
      sq_pad % kBlock || int64_t(b) * hq > 0x7fffffff ||
      (sq + kBlock - 1) / kBlock > 65535 ||
      (skv + kBlock - 1) / kBlock > 65535 ||
      (head_dim != 64 && head_dim != 96 && head_dim != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm[4];   // q, k, v, dout; boxes of 64 columns x 64 rows
  int err = make_map(&tm[0], q, head_dim, hq, sq, b, q_sh, q_ss, q_sb, kRows);
  if (!err)
    err = make_map(&tm[1], k, head_dim, hkv, skv, b, k_sh, k_ss, k_sb, kRows);
  if (!err)
    err = make_map(&tm[2], v, head_dim, hkv, skv, b, v_sh, v_ss, v_sb, kRows);
  if (!err)
    err = make_map(&tm[3], dout, head_dim, hq, sq, b, do_sh, do_ss, do_sb,
                   kRows);
  if (err) return err;
  const DeltaParams dp{static_cast<const __nv_bfloat16*>(o),
                       static_cast<const __nv_bfloat16*>(dout),
                       lse, lse2, delta, o_sb, o_ss, o_sh, do_sb, do_ss,
                       do_sh, sq, hq, sq_pad, head_dim,
                       int64_t(b) * hq * sq_pad};
  const BwdParams p{sq, skv, hq, hkv, hq / hkv, q_offset, causal, window,
                    sq_pad, sm_scale * kLog2e, sm_scale, lse2, delta,
                    static_cast<__nv_bfloat16*>(dq),
                    static_cast<__nv_bfloat16*>(dk),
                    static_cast<__nv_bfloat16*>(dv)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch<64>(tm, dp, p, b, s);
    case 96: return launch<96>(tm, dp, p, b, s);
    default: return launch<128>(tm, dp, p, b, s);
  }
}
