// Flash attention for Hopper (sm_90a): a tensor-core prefill ("wgmma") and a
// split-kv decode ("split_kv"), each at head_dim 64, 96 or 128. The CUDA-core
// kernel beside it (flash_attention.cu, "simt") serves every other case:
// float32, a bfloat16 q against a float32 cache, rows that are not 16-byte
// aligned, head_dim 32. ops.py::plan picks the variant by type and shape.
//
// Both replace the Pallas TPU kernel
// repro/kernels/flash_attention/flash_attention.py::_attn_kernel and compute
// its function (mask k_pos < kv_len, causal k_pos <= q_pos, window
// k_pos > q_pos - window; online softmax; rows with no key to see give 0;
// q-head h reads kv-head h / (hq / hkv)).
//
// wgmma (bfloat16 q, k, v; sq > 1; head_dim 64, 96 or 128). Bound: at the
// serving prefill (4 x 1024 queries, 16 heads of 128, causal) 17.2 GFLOP
// against 67 MB, above the card's ~295 operations per byte, so the tensor
// cores; likewise phi3-mini's training forward (4 x 1024, 32 heads of 96,
// causal: 25.8 GFLOP against 101 MB). Design:
//  * A CTA owns a 128-row q tile of one (batch, q-head): two consumer
//    warpgroups of 64 rows each and a producer warpgroup, of which one
//    thread issues every TMA copy and the rest only give back registers
//    (setmaxnreg: consumers 232, producer 40).
//  * Q, K, V come in by TMA with the 128-byte swizzle, through 4-D (d, h, s,
//    b) tensor maps built per call from the tensors' strides (views of a
//    stacked cache included). A row of 128 bf16 is 256 bytes, wider than the
//    swizzle span, so every tile is NB = ceil(D / 64) boxes of 64 columns
//    and the wgmma descriptors step from box to box. At head_dim 96 a row
//    is a full box and half a box that TMA fills with zeros (and counts
//    toward the barrier's bytes: the expected bytes are whole boxes); S
//    runs 6 k-steps, P.V is m64n96k16 with V MN-major across the box and
//    a half, as the backward's output products (flash_attention_bwd_
//    hopper.cu). K and V have a ring of 3 stages (224 KB of shared memory
//    with Q at head_dim 96 and 128, 112 KB at 64); full barriers (K and V
//    apart, so that S = Q.K^T starts before V lands) and one empty barrier
//    per stage.
//  * S = Q.K^T: wgmma m64n128k16, A = Q and B = K both K-major in shared
//    memory, f32 accumulators. sm_scale * log2(e) is folded into one FFMA
//    before ex2.approx. Only tiles that cross the diagonal, the window edge
//    or kv_len are masked; tiles no query of the CTA can see are never
//    loaded. q tiles run heaviest first (the last causal tile has the most
//    keys).
//  * The output is staged as bf16 in the warpgroup's rows of the Q tile
//    (which nothing reads by then) and written by TMA stores of 64-column
//    boxes, which leave out rows past sq and, at head_dim 96, columns 96-127
//    of the second box (past the map's d: the next head's columns stay
//    untouched).
//  * Overlap: a warpgroup issues S of tile j + 1 and P.V of tile j together
//    and runs the softmax of tile j + 1 while P.V runs; the two warpgroups
//    take turns to issue (named barriers), so that one's softmax runs under
//    the other's products.
//  * O += P.V: wgmma with A = P from registers (the S accumulator repacked
//    as bf16 A fragments: its layout is the A layout) and B = V from shared
//    memory, MN-major (the transpose bit set). P is rounded to bf16 here, as
//    the JAX package's own XLA reference (repro/kernels/flash_attention/
//    ref.py) rounds p to the activation type before the PV product; the row
//    sums l are taken over the f32 p.
//  * ptxas (-Xptxas -v, chip_smoke.py phase 2): 168 registers at the
//    launch bound at head_dim 64, 96 and 128 (the consumers raise theirs to
//    232 with setmaxnreg), no spills; dynamic shared memory TcSmem<D> + 1 KB
//    of alignment slack: 230,480 B at 96 and 128, 115,792 B at 64.
//
// split_kv (bfloat16 q, k, v; one query row; head_dim 64, 96 or 128). Bound:
// the K/V bytes (one query does ~1 FLOP per byte). Design:
//  * Grid (kv chunks, kv-heads x head blocks, batch). A CTA serves all
//    hq / hkv q-heads of its kv-head (up to 8 at once), so every K/V row is
//    read once. Chunks lie over the keys that can be seen only,
//    [lo, lo + n_vis), their count chosen by ops.py::plan to fill the card.
//  * 128 threads stream the chunk with 16-byte loads, LPR lanes to a row,
//    4 rows each in flight; f32 math on CUDA cores (p stays f32); each CTA
//    writes its (m, l, acc) in f32 to scratch the wrapper allocates, with
//    m = -1e30 and l = 0 for a chunk in which nothing is seen.
//  * LPR is D / 8 (8 bf16 a lane) rounded up to a power of two: a row's dot
//    product is summed by an xor butterfly over its lanes, which is a sum
//    only over a power-of-two group. At head_dim 96 a row takes 16 lanes of
//    which 12 load (192 bytes) and 4 add zeros: every K/V row is still read
//    once, with 16-byte loads, 2 rows a warp a load, and the block's 8 row
//    slots keep sh_acc at 8 x MG x 96 floats. (4 lanes a row of three loads
//    each would fill every lane but need 32 slots: 96 KB of sh_acc at MG =
//    8, past the 48 KB of static shared memory.) ptxas, head_dim 96 at MG
//    = 1, 2, 4, 8: 72, 125, 168, 236 registers (as at 64 and 128), no
//    spills, 3,664, 7,312, 14,624, 29,232 B of static shared memory (64:
//    4,752 to 37,936; 128: 4,688 to 37,424).
//  * The last CTA of each (batch, kv-head) to finish, found with an atomic
//    ticket, merges the chunks: weights exp(m_i - max m), out = sum(acc_i
//    w_i) / max(sum(l_i w_i), 1e-30), and sets its ticket back to 0. One
//    CUDA launch per op call.
// Both run on the caller's stream and allocate nothing.

#include "hopper.cuh"   // mbarriers, TMA, wgmma forms, tensor maps

#include <algorithm>
#include <cmath>

namespace {

constexpr float kNegInf = -INFINITY;

// --- wgmma prefill -----------------------------------------------------------

constexpr int kBM = 128;                // q rows per CTA
constexpr int kBN = 128;                // kv rows per tile
constexpr int kStages = 3;              // K/V ring
constexpr int kTcThreads = 3 * 128;     // 2 consumer warpgroups + producer
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
// The two consumer warpgroups take turns to issue their wgmma (named
// barriers 1 and 2), so that one's softmax runs under the other's products.
constexpr bool kPingpong = true;

struct TcParams {
  int sq, skv, hq, group, q_offset, causal, window;
  float scale_log2;   // sm_scale * log2(e)
  float* lse;         // (b, hq, sq) or null: each row's log-sum-exp
};

template <int D>
struct TcSmem {
  static constexpr int NB = (D + kBox - 1) / kBox;   // 64-column boxes a row
  // whole boxes: at head_dim 96 TMA fills the second box's last 32 columns
  // with zeros and counts their bytes toward the barrier
  static constexpr int kQ = NB * kBM * 128;    // bytes of the Q tile
  static constexpr int kKV = NB * kBN * 128;   // bytes of one K (or V) stage
  static constexpr int kK = kQ;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kBar = kV + kStages * kKV;
  // q_full, k_full[S], v_full[S], empty[S]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages);
};

// The kv tiles [t0, t0 + n) that any query of rows [q0, q0 + kBM) can see.
__device__ __forceinline__ void tile_range(const TcParams& p, int q0, int& t0,
                                           int& n) {
  const int qp0 = p.q_offset + q0;
  const int qp1 = p.q_offset + min(q0 + kBM, p.sq) - 1;
  const int lo = p.window > 0 ? max(0, qp0 - p.window + 1) : 0;
  const int hi = p.causal ? min(p.skv - 1, qp1) : p.skv - 1;
  if (hi < lo) {
    t0 = n = 0;
    return;
  }
  t0 = lo / kBN;
  n = hi / kBN + 1 - t0;
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// This thread's query positions (qa and qa + 8), its warpgroup's first
// position (its last is + 63) and its first column in a tile.
struct Rows {
  int qa, wq0, col;
};

// S (64 x kBN) = Q . K^T over head_dim, 16 at a time; each operand is one
// or two 64-column boxes (K-major, 128-byte swizzle): at head_dim 96 the
// second box's first 32 columns.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kBN / 2], uint32_t q,
                                         uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t box = kk / 4, off = (kk % 4) * 32;
    wgmma_ss_n128(sc, smem_desc(q + box * kBM * 128 + off, 16, 1024),
                  smem_desc(k + box * kBN * 128 + off, 16, 1024), kk > 0);
  }
}

// O (64 x D) += P . V over the tile's kv rows, 16 at a time; V MN-major,
// its boxes kBN * 128 bytes apart (at head_dim 96 the product reads one box
// and the first half of the next).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[kBN / 16][4],
                                         uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t dv = smem_desc(v + kk * 16 * 128, kBN * 128, 1024);
    if constexpr (D == 128)
      wgmma_rs_n128(o, pa[kk], dv);
    else if constexpr (D == 96)
      wgmma_rs_n96(o, pa[kk], dv);
    else
      wgmma_rs_n64(o, pa[kk], dv);
  }
}

// The online softmax of one tile of raw scores (kv rows [kt, kt + kBN)):
// masked where the tile crosses the diagonal, the window edge or kv_len;
// sc becomes p = exp2(s * scale_log2 - m'), m and l are updated and alpha
// is the factor the rows of O are to be scaled by. A row with nothing seen
// so far keeps m = -inf and p = 0.
__device__ __forceinline__ void online_softmax(float (&sc)[kBN / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2],
                                               const TcParams& p, int kt,
                                               const Rows& w) {
  const bool edge = kt + kBN > p.skv ||
                    (p.causal && kt + kBN - 1 > w.wq0) ||
                    (p.window > 0 && kt <= w.wq0 + 63 - p.window);
  if (edge) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int kp = kt + (i / 4) * 8 + w.col + (i % 2);
      const int qp = w.qa + ((i / 2) % 2) * 8;
      bool ok = kp < p.skv;
      if (p.causal) ok = ok && kp <= qp;
      if (p.window > 0) ok = ok && kp > qp - p.window;
      if (!ok) sc[i] = kNegInf;
    }
  }
  // row maxima and sums over 4 independent partials each (only 2 warps per
  // SM sub-partition: the chains' latency is not hidden)
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) mx[(i / 2) % 2][(i / 4) * 2 + i % 2] = sc[i];
#pragma unroll
  for (int i = 8; i < kBN / 2; ++i) {
    float& x = mx[(i / 2) % 2][((i / 4) % 2) * 2 + i % 2];
    x = fmaxf(x, sc[i]);
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mr = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    mr = fmaxf(mr, m[r]);
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 1));
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
    base[r] = (mr == kNegInf ? 0.0f : mr) * p.scale_log2;
    alpha[r] = ex2(m[r] * p.scale_log2 - base[r]);
    m[r] = mr;
#pragma unroll
    for (int j = 0; j < 4; ++j) sum[r][j] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    const int r = (i / 2) % 2;
    sc[i] = ex2(fmaf(sc[i], p.scale_log2, -base[r]));
    sum[r][((i / 4) % 2) * 2 + i % 2] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] +
           ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

// P as bf16 A fragments: k-step kk holds columns [16 kk, 16 kk + 16). The
// accumulator layout of S is the A-fragment layout, so no data moves.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kBN / 16][4],
                                       const float (&sc)[kBN / 2]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    attn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o,
                      const TcParams p) {
  using L = TcSmem<D>;
  constexpr int NB = L::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_q = s_base + L::kBar;
  const uint32_t bar_k = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_e = bar_v + 8 * kStages;

  const int bh = blockIdx.x;
  const int h = bh % p.hq, bi = bh / p.hq;
  const int hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;   // heaviest first
  int t0, nt;
  tile_range(p, q0, t0, nt);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
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
      mbar_expect_tx(bar_q, L::kQ);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load(s_base + c * kBM * 128, &tm_q, bar_q, c * kBox, h, q0, bi);
      for (int it = 0; it < nt; ++it) {
        const int s = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int kt = (t0 + it) * kBN;
        mbar_wait(bar_e + 8 * s, ph ^ 1);
        const uint32_t k_dst = s_base + L::kK + s * L::kKV;
        const uint32_t v_dst = s_base + L::kV + s * L::kKV;
        mbar_expect_tx(bar_k + 8 * s, L::kKV);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load(k_dst + c * kBN * 128, &tm_k, bar_k + 8 * s, c * kBox, hk,
                   kt, bi);
        mbar_expect_tx(bar_v + 8 * s, L::kKV);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load(v_dst + c * kBN * 128, &tm_v, bar_v + 8 * s, c * kBox, hk,
                   kt, bi);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [wg * 64, wg * 64 + 64) ----
  // S of tile j + 1 and P.V of tile j are in flight together: the softmax of
  // tile j + 1 runs while the tensor cores do P.V of tile j.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int ra = wg * 64 + warp * 16 + lane / 4;   // this thread's rows: ra,
  const int col = 2 * (lane % 4);                  // ra + 8; columns
  const Rows rows{p.q_offset + q0 + ra,            // col + 8 j + {0, 1}
                  p.q_offset + q0 + wg * 64, col};

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, alpha[2];
  float sc[kBN / 2];
  uint32_t pa[kBN / 16][4];

  // Turns: warpgroup wg waits on barrier 1 + wg before it issues, and
  // hands the turn over on 2 - wg after; warpgroup 0 goes first. Both issue
  // nt + 1 times; warpgroup 1 hands over one time fewer, so that every
  // barrier phase completes.
  const int mine = 1 + wg, other = 2 - wg;
  int turns = nt + 1;
  auto take_turn = [&]() {
    if (kPingpong) named_sync(mine);
  };
  auto give_turn = [&]() {
    if (kPingpong && (wg == 0 || --turns > 0)) named_arrive(other);
  };
  if (kPingpong && wg == 1 && nt > 0) named_arrive(other);

  mbar_wait(bar_q, 0);
  const uint32_t q_addr = s_base + wg * 64 * 128;
  const uint32_t k_addr = s_base + L::kK, v_addr = s_base + L::kV;
  if (nt > 0) {
    mbar_wait(bar_k, 0);
    take_turn();
    wgmma_fence();
    issue_qk<D>(sc, q_addr, k_addr);
    wgmma_commit();
    give_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    online_softmax(sc, m, l, alpha, p, t0 * kBN, rows);
    pack_p(pa, sc);
  }
  // every iteration issues S of tile it + 1 and P.V of tile it (the loop
  // stays free of branches around the wgmma groups, so that ptxas can
  // follow which accumulators each wait_group releases)
  for (int it = 0; it + 1 < nt; ++it) {
    const int s = it % kStages, s1 = (it + 1) % kStages;
    mbar_wait(bar_k + 8 * s1, ((it + 1) / kStages) & 1);
    mbar_wait(bar_v + 8 * s, (it / kStages) & 1);
    take_turn();
    wgmma_fence();
    issue_qk<D>(sc, q_addr, k_addr + s1 * L::kKV);
    wgmma_commit();
    issue_pv<D>(o, pa, v_addr + s * L::kKV);
    wgmma_commit();
    give_turn();
    wgmma_wait<1>();   // S of tile it + 1; P.V of tile it may still run
    fence_regs(sc);
    online_softmax(sc, m, l, alpha, p, (t0 + it + 1) * kBN, rows);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(bar_e + 8 * s);   // K and V of this stage are consumed
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
    pack_p(pa, sc);
  }
  if (nt > 0) {   // P.V of the last tile
    const int it = nt - 1, s = it % kStages;
    mbar_wait(bar_v + 8 * s, (it / kStages) & 1);
    take_turn();
    wgmma_fence();
    issue_pv<D>(o, pa, v_addr + s * L::kKV);
    wgmma_commit();
    give_turn();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(bar_e + 8 * s);
  }

  // out = O / max(l, 1e-30) in bf16, staged in this warpgroup's rows of the
  // Q tile (no longer read) with the 128-byte swizzle, then one TMA store
  // per 64-column box; TMA leaves out rows past sq and columns past D.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  // log-sum-exp of the scaled scores, (m * scale_log2 + log2 l) * ln 2,
  // for the backward (flash_attention_bwd.cu)
  if (p.lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qrow = q0 + ra + 8 * r;
      if (qrow < p.sq)
        p.lse[(int64_t(bi) * p.hq + h) * p.sq + qrow] =
            (m[r] * p.scale_log2 + log2f(l[r])) * 0.693147180559945f;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = 1.0f / l[r];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + lane / 4 + 8 * r;   // in the warpgroup's 64
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t addr = q_addr + (j / 8) * kBM * 128 + row * 128 +
                            (((j % 8) ^ (row % 8)) * 16) + (lane % 4) * 4;
      asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr),
                   "r"(pack_bf16(o[4 * j + 2 * r] * l[r],
                                 o[4 * j + 2 * r + 1] * l[r]))
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(3 + wg) : "memory");
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < NB; ++c)
      tma_store(&tm_o, q_addr + c * kBM * 128, c * kBox, h, q0 + wg * 64, bi);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// --- split-kv decode ---------------------------------------------------------

constexpr int kSkThreads = 128;
constexpr int kSkHeads = 8;        // q-heads a CTA serves at most
constexpr int kSkMaxSplits = 64;   // chunks of one query row at most

struct SkParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  float* part_m;     // (b, hq, splits)
  float* part_l;     // (b, hq, splits)
  float* part_acc;   // (b, hq, splits, D)
  int* tickets;      // one per (batch, kv-head, head block); 0 between calls
  __nv_bfloat16* o;
  int64_t q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  int hq, group, lo, n_vis, chunk, splits;
  float sm_scale;
};

// 8 bfloat16 (one 16-byte load) as float32: a bfloat16 is the high half of
// the float32 it stands for.
__device__ __forceinline__ void unpack8(const uint4 raw, float (&x)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 ldg16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// MG: the q-heads one CTA serves at most (1, 2, 4 or 8; a power of two no
// smaller than min(hq / hkv, 8)), so that MHA keeps few registers.
template <int D, int MG>
__global__ void __launch_bounds__(kSkThreads)
    attn_split_kernel(const SkParams p) {
  static_assert(D % 8 == 0 && D <= 128, "head_dim: a multiple of 8, <= 128");
  // lanes per row: D / 8 (one 16-byte load each) rounded up to a power of
  // two, so that the xor butterfly stays in the row
  constexpr int LPR = D / 8 <= 8 ? 8 : 16;
  constexpr int RPW = 32 / LPR;              // rows per warp per load
  constexpr int SLOTS = RPW * (kSkThreads / 32);
  constexpr int STEPS = 4;                   // rows each thread has in flight
  constexpr int STEP = SLOTS * STEPS;        // rows per pass of the block
  __shared__ float sh_m[SLOTS][MG], sh_l[SLOTS][MG];
  __shared__ float sh_acc[SLOTS][MG][D];

  const int split = blockIdx.x, bi = blockIdx.z;
  const int nhb = (p.group + MG - 1) / MG;
  const int hk = blockIdx.y / nhb, g0 = (blockIdx.y % nhb) * MG;
  const int ng = min(MG, p.group - g0);
  const int h0 = hk * p.group + g0;          // first q-head of the block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = warp * RPW + lane / LPR, c = (lane % LPR) * 8;
  // whether this lane holds columns of the row (at head_dim 96, 4 of a
  // row's 16 lanes do not: they load nothing and add zeros)
  const bool live = LPR * 8 == D || c < D;
  const int row0 = p.lo + split * p.chunk;
  const int row1 = min(row0 + p.chunk, p.lo + p.n_vis);

  float q[MG][8], acc[MG][8], m[MG], l[MG];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    float x[8];
    unpack8(g < ng && live
                ? ldg16(p.q + bi * p.q_sb + (h0 + g) * p.q_sh + c)
                : make_uint4(0u, 0u, 0u, 0u),
            x);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      q[g][e] = x[e] * p.sm_scale;
      acc[g][e] = 0.0f;
    }
    m[g] = kNegInf;
    l[g] = 0.0f;
  }
  const __nv_bfloat16* kp = p.k + bi * p.k_sb + hk * p.k_sh + c;
  const __nv_bfloat16* vp = p.v + bi * p.v_sb + hk * p.v_sh + c;

  for (int rb = row0; rb < row1; rb += STEP) {   // uniform over the block
    uint4 kr[STEPS], vr[STEPS];
    bool ok[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const int row = rb + u * SLOTS + slot;
      ok[u] = row < row1;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u] && live) {
        kr[u] = ldg16(kp + row * p.k_ss);
        vr[u] = ldg16(vp + row * p.v_ss);
      }
    }
    float kf[STEPS][8], vf[STEPS][8];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      unpack8(kr[u], kf[u]);
      unpack8(vr[u], vf[u]);
    }
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g >= ng) break;
      float s[STEPS];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < STEPS; ++u) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(q[g][e], kf[u][e], dot);
#pragma unroll
        for (int off = LPR / 2; off > 0; off /= 2)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u] = ok[u] ? dot : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
      const float base = mx == kNegInf ? 0.0f : mx;
      const float alpha = expf(m[g] - base);
      m[g] = mx;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < STEPS; ++u) {
        const float pu = expf(s[u] - base);
        l[g] += pu;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pu, vf[u][e], acc[g][e]);
      }
    }
  }

  // merge the block's row slots, then write the chunk's partials
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    if (g >= ng) break;
    if (lane % LPR == 0) {
      sh_m[slot][g] = m[g];
      sh_l[slot][g] = l[g];
    }
    if (live) {
#pragma unroll
      for (int e = 0; e < 8; ++e) sh_acc[slot][g][c + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ng * D; idx += kSkThreads) {
    const int g = idx / D, d = idx % D;
    float mm = kNegInf;
#pragma unroll
    for (int sl = 0; sl < SLOTS; ++sl) mm = fmaxf(mm, sh_m[sl][g]);
    const float base = mm == kNegInf ? 0.0f : mm;
    float ll = 0.0f, aa = 0.0f;
#pragma unroll
    for (int sl = 0; sl < SLOTS; ++sl) {
      const float w = expf(sh_m[sl][g] - base);
      ll = fmaf(sh_l[sl][g], w, ll);
      aa = fmaf(sh_acc[sl][g][d], w, aa);
    }
    const int64_t part = (int64_t(bi) * p.hq + h0 + g) * p.splits + split;
    p.part_acc[part * D + d] = aa;
    if (d == 0) {
      p.part_m[part] = mm == kNegInf ? -1e30f : mm;   // nothing seen
      p.part_l[part] = ll;
    }
  }

  // The last CTA of this (batch, kv-head, head block) to finish merges the
  // chunks: weights w_i = exp(m_i - max m), out = sum(acc_i w_i) /
  // max(sum(l_i w_i), 1e-30). Its ticket goes back to 0 for the next call.
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ticket = p.tickets + blockIdx.z * gridDim.y + blockIdx.y;
    last = atomicAdd(ticket, 1) == p.splits - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the chunks' m and l of the block's heads, then each head's weights
  __shared__ float sh_w[MG][kSkMaxSplits], sh_pl[MG][kSkMaxSplits];
  __shared__ float sh_den[MG];
  const int64_t row0h = int64_t(bi) * p.hq + h0;
  for (int idx = threadIdx.x; idx < ng * p.splits; idx += kSkThreads) {
    const int g = idx / p.splits, i = idx % p.splits;
    sh_w[g][i] = __ldcg(p.part_m + (row0h + g) * p.splits + i);
    sh_pl[g][i] = __ldcg(p.part_l + (row0h + g) * p.splits + i);
  }
  __syncthreads();
  if (threadIdx.x < ng) {
    const int g = threadIdx.x;
    float mm = -1e30f;
    for (int i = 0; i < p.splits; ++i) mm = fmaxf(mm, sh_w[g][i]);
    float ll = 0.0f;
    for (int i = 0; i < p.splits; ++i) {
      const float w = expf(sh_w[g][i] - mm);
      sh_w[g][i] = w;
      ll = fmaf(sh_pl[g][i], w, ll);
    }
    sh_den[g] = 1.0f / fmaxf(ll, 1e-30f);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ng * D; idx += kSkThreads) {
    const int g = idx / D, d = idx % D;
    const float* pa = p.part_acc + (row0h + g) * p.splits * D + d;
    float aa[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int i = 0;
    for (; i + 4 <= p.splits; i += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        aa[u] = fmaf(__ldcg(pa + int64_t(i + u) * D), sh_w[g][i + u], aa[u]);
    }
    for (; i < p.splits; ++i)
      aa[0] = fmaf(__ldcg(pa + int64_t(i) * D), sh_w[g][i], aa[0]);
    p.o[bi * p.o_sb + (h0 + g) * p.o_sh + d] = __float2bfloat16_rn(
        ((aa[0] + aa[1]) + (aa[2] + aa[3])) * sh_den[g]);
  }
}

// --- host --------------------------------------------------------------------

template <int D>
int launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                 const CUtensorMap& tv, const CUtensorMap& to,
                 const TcParams& p, int b, cudaStream_t stream) {
  constexpr int smem = TcSmem<D>::kBytes + 1024;   // + alignment slack
  const cudaError_t err = cudaFuncSetAttribute(
      attn_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * p.hq, (p.sq + kBM - 1) / kBM);
  attn_wgmma_kernel<D><<<grid, kTcThreads, smem, stream>>>(tq, tk, tv, to,
                                                          p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int MG>
int launch_split(const SkParams& p, int b, int hkv, cudaStream_t stream) {
  const int nhb = (p.group + MG - 1) / MG;
  attn_split_kernel<D, MG><<<dim3(p.splits, hkv * nhb, b), kSkThreads, 0,
                             stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int by_group(const SkParams& p, int b, int hkv, cudaStream_t stream) {
  switch (p.group) {
    case 1: return launch_split<D, 1>(p, b, hkv, stream);
    case 2: return launch_split<D, 2>(p, b, hkv, stream);
    case 3:
    case 4: return launch_split<D, 4>(p, b, hkv, stream);
    default: return launch_split<D, 8>(p, b, hkv, stream);
  }
}

}  // namespace

// Tensor-core prefill. bfloat16 q (b, sq, hq, d), k/v (b, skv, hkv, d), o
// (b, sq, hq, d); head_dim 64, 96 or 128; strides (*_sb, *_ss, *_sh) in
// elements, unit stride along d, every stride of an axis longer than 1 a
// multiple of 8 elements and every base 16-byte aligned (TMA). scale_log2 =
// sm_scale * log2(e). lse: null, or float32 (b, hq, sq) that receives each
// row's log-sum-exp of its scaled scores. Returns 0, a cudaError_t, or
// 10001 / 10002 + CUresult when a tensor map cannot be made.
extern "C" int flash_attention_wgmma(
    int head_dim, const void* q, const void* k, const void* v, void* o, int b,
    int sq, int skv, int hq, int hkv, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int q_offset, int causal, int window, float scale_log2, float* lse,
    void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || hkv < 1 || hq % hkv ||
      int64_t(b) * hq > 0x7fffffff || (sq + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, to;
  int err = make_map(&tq, q, head_dim, hq, sq, b, q_sh, q_ss, q_sb, kBM);
  if (!err)
    err = make_map(&tk, k, head_dim, hkv, skv, b, k_sh, k_ss, k_sb, kBN);
  if (!err)
    err = make_map(&tv, v, head_dim, hkv, skv, b, v_sh, v_ss, v_sb, kBN);
  if (!err)
    err = make_map(&to, o, head_dim, hq, sq, b, o_sh, o_ss, o_sb, 64);
  if (err) return err;
  const TcParams p{sq, skv, hq, hq / hkv, q_offset, causal, window,
                   scale_log2, lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch_wgmma<64>(tq, tk, tv, to, p, b, s);
    case 96: return launch_wgmma<96>(tq, tk, tv, to, p, b, s);
    case 128: return launch_wgmma<128>(tq, tk, tv, to, p, b, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Split-kv decode of one query row. bfloat16 q (b, 1, hq, d), k/v (b, skv,
// hkv, d), o (b, 1, hq, d); head_dim 64, 96 or 128; 16-byte aligned rows. The
// keys [lo, lo + n_vis) are the ones the query sees, cut into `splits`
// chunks of `chunk` rows; part_m, part_l (b, hq, splits) and part_acc (b,
// hq, splits, d) are float32 scratch; tickets holds b * hkv * ceil(hq / hkv
// / 8) ints that are 0, and are 0 again when the kernel ends (so calls that
// share them must not run at once: one stream). One launch.
extern "C" int flash_attention_split_kv(
    int head_dim, const void* q, const void* k, const void* v, void* o,
    float* part_m, float* part_l, float* part_acc, int* tickets, int b,
    int hq, int hkv, int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
    int64_t o_sh, int lo, int n_vis, int chunk, int splits, float sm_scale,
    void* stream) {
  if (b < 1 || b > 65535 || hkv < 1 || hq % hkv || splits < 1 ||
      splits > kSkMaxSplits || chunk < 1 ||
      hkv * ((hq / hkv + kSkHeads - 1) / kSkHeads) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const SkParams p{static_cast<const __nv_bfloat16*>(q),
                   static_cast<const __nv_bfloat16*>(k),
                   static_cast<const __nv_bfloat16*>(v),
                   part_m, part_l, part_acc, tickets,
                   static_cast<__nv_bfloat16*>(o), q_sb, q_sh, k_sb, k_ss,
                   k_sh, v_sb, v_ss, v_sh, o_sb, o_sh, hq, hq / hkv, lo,
                   std::max(n_vis, 0), chunk, splits, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return by_group<64>(p, b, hkv, s);
    case 96: return by_group<96>(p, b, hkv, s);
    case 128: return by_group<128>(p, b, hkv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
