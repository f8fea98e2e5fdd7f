// The RWKV-6 (Finch) WKV recurrence's backward for Hopper (sm_90a),
// "chunked": the reverse scan taken 16 steps at a time, its products on the
// tensor cores. Per (batch, head), with state S (key i x value j),
//
//     out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),
//     S_t   = diag(w_t) S_{t-1} + k_t v_t^T,
//
// given the output's cotangent dout and the final state's, it returns dr,
// dk, dv, dw, du (per (batch, head); the wrapper sums the batch) and the
// initial state's cotangent. Replaces no Pallas kernel: the reference
// trains through jax.grad of its XLA wkv6_ref
// (repro/kernels/rwkv6_scan/ref.py:20). It takes the training path's case:
// bf16 r, k, v, dout (and dr, dk, dv), f32 or bf16 w (and dw), head size 64
// (ops.py::plan_bwd); the CUDA-core kernel beside it (rwkv6_scan_bwd.cu,
// "simt") serves the rest.
//
// What bounds it: at rwkv6-7b's training shape (b, t, h, n) = (4, 1024, 64,
// 64) the function moves 377.5 MB (each input read once, each output
// written once), 112.7 us at 3.35 TB/s: bytes. Its products, 16.8 GFLOP
// (33.5 with the operand splits' passes, the state recomputed twice), need
// 68 us at 495 TFLOP/s of TF32. The kernel is far from both: see "What
// sets its pace" below.
//
// The math, for a chunk of L <= C = 16 steps from its start state S_c, G
// the cotangent of the state after it (ref.py::wkv6_chunked_bwd is the
// same in plain PyTorch). Per key i: P_t = prod_{m<t} w_m, Q_s =
// prod_{s<m<L} w_m, D = prod_m w_m, M(t, s) = prod_{s<m<t} w_m (s < t),
// all plain products of at most 16 decays: no logarithm, no division (w
// reaches 0 and 1 exactly). A[t][s] = sum_i r_t M(t, s) k_s (s < t),
// A[t][t] = sum_i r_t u k_t, as in the forward.
//   dA   = tril(dout . v^T)           X = S_c . dout^T,   Y = G . v^T
//   dv   = A^T . dout + (k * Q) . G   rs = rowsum(S_c * G)
//   G'   = diag(D) G + (r * P)^T . dout   (the chunk before's G)
//   S_c+1 = diag(D) S_c + (k * Q)^T . v   (the state, recomputed forward)
// and per key i and step t, with Z_m(t) = sum_{s<m} dA[t][s] M(m, s) k_s
// taken as the recurrence Z_{m+1}(t) = w_m Z_m(t) + dA[t][m] k_m:
//   dr_t = P_t X[t] + Z_t(t) + dA[t][t] u k_t
//   dk_s = Q_s Y[s] + sum_{t>s} dA[t][s] M(t, s) r_t + dA[s][s] r_s u
//   dw_m = P_m Q_m rs + sum_{t>m} M(t, m) r_t (Z_m(t) + P_m X[t])
//          + Q_m sum_{s<m} M(m, s) k_s Y[s]
//   du  += sum_t dA[t][t] r_t k_t
// (dw_m is rowsum(dS_m * S_{m-1}) split into its cross-chunk and in-chunk
// parts: O(L^2) a key with the recurrence, not the O(L^3) of its triple
// sum). A ragged last chunk is padded to 16 steps with r, k, v, dout 0 and
// w 1, which makes every padded term 0 and every product exact.
//
// Precision, as the forward (rwkv6_scan_hopper.cu): an operand with more
// bits than TF32 is split, x = hi + lo (both cvt.rna.tf32), bf16 operands
// are exact in TF32, all sums in f32: X, Y, (r * P)^T . dout, A^T . dout and
// the state update 2 passes (hi.b + lo.b), (k * Q) . G 3 (hi.hi' + hi.lo' +
// lo.hi'); dA is a bf16 product (exact terms, f32 sums).
//
// Design (scripts/wkv_bwd_variants.py times the alternatives and the cuts
// behind these choices, and --trace stamps each phase of every task):
//  * Parallelism: a cluster of 4 CTAs per (batch, head), each owning 16 of
//    the 64 keys with all 64 values: 1,024 CTAs of 256 threads at the
//    training shape, two an SM (110 KB of shared memory, 128 registers).
//    Keys, not values, are split because every sum but dv's runs over
//    values or steps of one key: S, G, X, Y, rs, dr, dk, dw, du and the
//    state update stay inside the CTA; only dv's partial (16 steps x 64
//    values, f32) crosses the cluster. dA needs whole rows of dout and v:
//    each CTA computes it.
//  * The dv exchange: each CTA pushes its partial's four 16-value blocks to
//    their owners (st.async into distributed shared memory), counted on the
//    owner's mbarrier of the chunk's buffer (kDvBufs = 4, each armed for
//    4 x 1 KB); the owner waits for it a task later and sums the 4 sources
//    in rank order. No cluster barrier in the loop (one before, to see the
//    barriers initialised, and one at the end). A buffer is reused 4 chunks
//    on: a CTA pushes chunk c - 4 after it has waited for chunk c - 2, which
//    every owner pushed after it had read (and re-armed for) chunk c.
//  * States, two levels: a forward pass over all chunks computes only the
//    state (one product a chunk) and writes S at the start of every
//    segment of kSeg = 4 chunks (64 steps) to a scratch; the backward then
//    takes the segments last to first, recomputing each segment's
//    chunk-start states into shared memory (4 slots) before running its
//    chunks backward. The scratch is b * h * ceil(t / 64) * 64 * 64 floats
//    (67.1 MB at the training shape), written once and read once; each
//    segment's snapshot is fetched during the segment after it.
//  * The walk: 175 tasks a CTA at the training shape (63 forward, then 16
//    segments of 3 forward and 4 backward), a cursor moving from task to
//    task. The chunks of the next 3 tasks are in flight by cp.async (4
//    stages; r and dout only for a backward); a forward task's decay
//    products (shuffle scans) are made a task ahead, so it has one barrier.
//  * A chunk backward, 8 warps, four __syncthreads:
//     1. tensor cores: warps 0-1 X, 2-3 Y (m16n8k8 TF32, 2 passes, float4
//        fragment loads with the k order permuted), 4-5 dA (m16n8k16
//        bf16); warps 6-7 rs, and w, k of the CTA's keys as f32 rows;
//     2. CUDA cores, a thread a (key, step t): M(t, .) by a running product
//        down from t - 1, then the recurrence above up m, which gives
//        dr_t, A's terms (to shared memory) and two 16-vectors over m summed
//        over t by a transpose-reduce of 15 shuffles each across the
//        half-warp (dw's in-chunk sums and dk's); Q and D by shuffle scans;
//     3. A summed over the CTA's 16 keys;
//     4. tensor cores, warp w values 8w..8w+7: dv's partial (4 + 6 mma),
//        pushed; G' (4 mma, G kept in registers as the accumulator and
//        written to a double-buffered tile for the next chunk's operands);
//     5. the chunk before's dv: its buffer's wait, the sum, the store; then
//        this chunk's dr, dk, dw, rows of 32 bytes.
//  * What sets its pace (the trace, on the H100): a CTA is a serial chain of
//    ~600,000 cycles, two an SM: the chunk backwards 69% (the in-chunk
//    sums the largest phase, ~2,000 cycles, issue-bound beside the other
//    CTA), the forward tasks 31% (a barrier, the loads' issue and the
//    decay products around a 4-mma update). Registers (128,
//    the launch bound's limit) keep it at two CTAs an SM.
//  * No float atomics: repeats are bit-equal.
// The kernel runs on the caller's stream and allocates nothing: the wrapper
// gives the snapshots' scratch. Rows of every tensor start on 16-byte
// boundaries (the wrapper checks).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kN = 64;                  // head size: keys and values
constexpr int kC = 16;                  // steps a chunk
constexpr int kKeys = 16;               // keys a CTA
constexpr int kCluster = kN / kKeys;    // CTAs a (batch, head)
constexpr int kThreads = 256;           // a thread a (key, step) of a chunk
constexpr int kSeg = 4;                 // chunks a segment (one snapshot)
constexpr int kStages = 4;              // load stages: 3 tasks in flight
constexpr int kDvBufs = 4;              // dv exchange buffers (module note)
// row strides, padded against shared-memory bank conflicts
constexpr int kRow = 80;                // f32 16 x 64 tiles (states, G)
constexpr int kRawRow = 80;             // bf16 16 x 64 tiles (v, dout)
constexpr int kSq = 20;                 // f32 16 x 16 tiles
constexpr int kSq17 = 17;               // f32 16 x 16 tiles read by columns
constexpr int kAq = 24;                 // A, read transposed by mma

using bf16 = __nv_bfloat16;

// One chunk's inputs as loaded: r, k, w at the CTA's 16 keys, v and dout
// at all 64 values.
template <typename W>
struct alignas(16) Raw {
  bf16 r[kC][kKeys];
  bf16 k[kC][kKeys];
  W w[kC][kKeys];
  bf16 v[kC][kRawRow];
  bf16 d[kC][kRawRow];
};

template <typename W>
struct Smem {
  Raw<W> raw[kStages];
  float slot[kSeg][kKeys][kRow];        // the segment's chunk-start states
  float g[2][kKeys][kRow];              // G, the state's cotangent
  // dv's partials of the CTA's 16 value columns, one from each CTA of the
  // cluster (written by the peers) [buffer][source rank][s][column]
  float dvin[kDvBufs][kCluster][kC][kKeys];
  float apart[kKeys][kC][kSq];          // A's terms a key [t][s]
  float aq[kC][kAq];                    // A over the CTA's keys [t][s]
  float x[kKeys][kSq];                  // X[i][t]
  float y[kKeys][kSq];                  // Y[i][s]
  float da[kC][kSq];                    // dA[t][s]
  float rp[kKeys][kSq];                 // (r * P)[i][t]
  float kq[kC][kSq];                    // (k * Q)[s][i]
  float kqt[2][kKeys][kSq];             // a forward's (k * Q) as [i][s]
  float df[2][kKeys];                   // a forward's D
  float wt[kKeys][kSq];                 // w as f32 [i][m]
  float kt[kKeys][kSq];                 // k as f32 [i][m]
  float out[3][kC][kSq17];              // dr, dk, dw [t][i]
  float dd[kKeys];                      // D
  float rs[kKeys];                      // rowsum(S_c * G)
  // a dv buffer's pushes have landed: the CTA's own arrival and the 4 CTAs'
  // bytes
  unsigned long long full[kDvBufs];
};

constexpr int kDvBytes = kCluster * kC * kKeys * 4;  // a buffer's pushes

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a . b, m16n8k8, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the bf16 at the lower / higher address of a 32-bit word, as f32
__device__ __forceinline__ uint32_t bf_lo(uint32_t x) { return x << 16; }
__device__ __forceinline__ uint32_t bf_hi(uint32_t x) {
  return x & 0xffff0000u;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// lo, hi += A . B^T over 64 columns: A 16 rows of f32 (row stride kRow, A
// split in two TF32 parts), B 8 rows of bf16 (row stride kRawRow, exact).
// Each 16 columns are two k-steps with the k order permuted (lane c takes
// columns 4c, 4c + 1, then 4c + 2, 4c + 3; the sum does not care), so a
// lane loads a float4 of each A row and 8 bytes of its B row.
__device__ __forceinline__ void mma_rows(float (&lo)[4], float (&hi)[4],
                                         const float* a, const bf16* b, int g,
                                         int c) {
#pragma unroll
  for (int kb = 0; kb < kN / 16; ++kb) {
    const int k0 = 16 * kb + 4 * c;
    const float4 x0 = ld4(a + g * kRow + k0);
    const float4 x1 = ld4(a + (g + 8) * kRow + k0);
    const uint2 bb = *reinterpret_cast<const uint2*>(b + g * kRawRow + k0);
    uint32_t ah[4], al[4];
    split(x0.x, ah[0], al[0]);
    split(x1.x, ah[1], al[1]);
    split(x0.y, ah[2], al[2]);
    split(x1.y, ah[3], al[3]);
    mma_tf32(lo, al, bf_lo(bb.x), bf_hi(bb.x));
    mma_tf32(hi, ah, bf_lo(bb.x), bf_hi(bb.x));
    split(x0.z, ah[0], al[0]);
    split(x1.z, ah[1], al[1]);
    split(x0.w, ah[2], al[2]);
    split(x1.w, ah[3], al[3]);
    mma_tf32(lo, al, bf_lo(bb.y), bf_hi(bb.y));
    mma_tf32(hi, ah, bf_lo(bb.y), bf_hi(bb.y));
  }
}

// A warp's m16n8 tile: lo, hi += A . B over KS k-steps of 8. fa(row, k) is
// an f32 element of A, split into two TF32 parts; fb(k, col) an element of
// B exact in TF32 (a bf16 value). 2 passes, A's low parts into lo. The
// accumulators' element e is (row g + 8 (e >> 1), column 2 c + (e & 1)).
template <int KS, typename FA, typename FB>
__device__ __forceinline__ void mma2(float (&lo)[4], float (&hi)[4], FA fa,
                                     FB fb, int g, int c) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k0 = 8 * ks;
    uint32_t ah[4], al[4];
    split(fa(g, k0 + c), ah[0], al[0]);
    split(fa(g + 8, k0 + c), ah[1], al[1]);
    split(fa(g, k0 + c + 4), ah[2], al[2]);
    split(fa(g + 8, k0 + c + 4), ah[3], al[3]);
    const uint32_t b0 = __float_as_uint(fb(k0 + c, g));
    const uint32_t b1 = __float_as_uint(fb(k0 + c + 4, g));
    mma_tf32(lo, al, b0, b1);
    mma_tf32(hi, ah, b0, b1);
  }
}

// As mma2 with B split too: lo += lo.hi' + hi.lo', hi += hi.hi' (3 passes).
template <int KS, typename FA, typename FB>
__device__ __forceinline__ void mma3(float (&lo)[4], float (&hi)[4], FA fa,
                                     FB fb, int g, int c) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k0 = 8 * ks;
    uint32_t ah[4], al[4], bh[2], bl[2];
    split(fa(g, k0 + c), ah[0], al[0]);
    split(fa(g + 8, k0 + c), ah[1], al[1]);
    split(fa(g, k0 + c + 4), ah[2], al[2]);
    split(fa(g + 8, k0 + c + 4), ah[3], al[3]);
    split(fb(k0 + c, g), bh[0], bl[0]);
    split(fb(k0 + c + 4, g), bh[1], bl[1]);
    mma_tf32(lo, al, bh[0], bh[1]);
    mma_tf32(lo, ah, bl[0], bl[1]);
    mma_tf32(hi, ah, bh[0], bh[1]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest kStages - 3 commit groups have landed: the task's
// chunk and the next one's
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 3) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of barrier `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// the address of the same shared-memory location in the cluster's CTA rank
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// 8 bytes into a peer's shared memory, counted on the peer's barrier bar
__device__ __forceinline__ void push2(uint32_t addr, float x, float y,
                                      uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];" ::"r"(addr),
      "f"(x), "f"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename W>
struct Args {
  const bf16 *r, *k, *v;
  const W* w;
  const float* u;
  const float* s_in;                    // null: zeros
  const bf16* dout;
  const float* ds_in;
  bf16 *dr, *dk, *dv;
  W* dw;
  float* du_part;
  float* ds_out;
  float* snap;
  int t, h;
};

// A position in the kernel's walk: the forward over chunks 0 .. nc - 2
// (pass 1, snapshots), then per segment, last to first, the forward over
// its chunks but the last (their start states into the slots) and its
// chunks backward. Moved on by advance(), a few compares and adds.
struct Task {
  int c;            // the chunk
  int bwd;          // its backward (else a forward state update)
  int pass2;        // in a segment (else the first forward pass)
  int first;        // a segment's first task: its state from the snapshot
  int seg_c0;       // the segment's first chunk
  int seg_len;      // its chunks
  int valid;        // 0 past the last task
};
static_assert(kSeg >= 2, "a full segment has a forward task");

// the first task of the segments' walk (the last segment's)
__device__ __forceinline__ void start_pass2(Task& k, int nc) {
  k.pass2 = 1;
  k.first = 1;
  k.seg_c0 = (nc - 1) / kSeg * kSeg;
  k.seg_len = nc - k.seg_c0;
  k.bwd = k.seg_len == 1;
  k.c = k.seg_c0;
}

__device__ __forceinline__ Task first_task(int nc) {
  Task k{};
  k.valid = 1;
  if (nc == 1) start_pass2(k, nc);
  return k;
}

__device__ __forceinline__ void advance(Task& k, int nc) {
  if (!k.valid) return;
  if (!k.pass2) {
    if (k.c + 1 < nc - 1)
      ++k.c;
    else
      start_pass2(k, nc);
    return;
  }
  k.first = 0;
  if (!k.bwd) {
    if (k.c + 1 < k.seg_c0 + k.seg_len - 1) {
      ++k.c;
    } else {
      k.bwd = 1;
      k.c = k.seg_c0 + k.seg_len - 1;
    }
    return;
  }
  if (k.c > k.seg_c0) {
    --k.c;
    return;
  }
  if (k.seg_c0 == 0) {
    k.valid = 0;
    return;
  }
  k.seg_c0 -= kSeg;
  k.seg_len = kSeg;
  k.first = 1;
  k.bwd = 0;
  k.c = k.seg_c0;
}

// cp.async loads of task tk's chunk into a stage (r and dout only for a
// backward); one commit group, empty past the last task.
template <typename W>
__device__ __forceinline__ void load_chunk(Raw<W>& st, const Args<W>& a,
                                           size_t base, size_t step, int key0,
                                           const Task& tk, int tid) {
  if (tk.valid) {
    const int c = tk.c;
    const int len = min(kC, a.t - c * kC);
    const size_t row0 = base + static_cast<size_t>(c) * kC * step;
    if (tid < 128) {                    // v, dout: 8 x 16 bytes a row
      const int row = tid >> 3, seg = tid & 7;
      if (row < len) {
        const size_t off = row0 + row * step + seg * 8;
        cp_async16(&st.v[row][seg * 8], a.v + off);
        if (tk.bwd) cp_async16(&st.d[row][seg * 8], a.dout + off);
      }
    } else if (tid < 160) {             // r, k: 2 x 16 bytes a row
      const int e = tid - 128, row = e >> 1, seg = e & 1;
      if (row < len) {
        const size_t off = row0 + row * step + key0 + seg * 8;
        if (tk.bwd) cp_async16(&st.r[row][seg * 8], a.r + off);
        cp_async16(&st.k[row][seg * 8], a.k + off);
      }
    } else {                            // w: 2 or 4 x 16 bytes a row
      constexpr int kSegs = kKeys * static_cast<int>(sizeof(W)) / 16;
      constexpr int kPer = 16 / static_cast<int>(sizeof(W));
      const int e = tid - 160;
      if (e < kC * kSegs) {
        const int row = e / kSegs, seg = e - row * kSegs;
        if (row < len)
          cp_async16(&st.w[row][seg * kPer],
                     a.w + row0 + row * step + key0 + seg * kPer);
      }
    }
  }
  cp_commit();
}

// A ragged chunk's rows past len: r, k, v, dout 0 and w 1.
template <typename W>
__device__ __forceinline__ void fill_tail(Raw<W>& st, int len, int tid) {
  const int row = tid >> 4, col = tid & 15;
  if (row >= len) {
    st.r[row][col] = from_f32<bf16>(0.f);
    st.k[row][col] = from_f32<bf16>(0.f);
    st.w[row][col] = from_f32<W>(1.f);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      st.v[row][col * 4 + x] = from_f32<bf16>(0.f);
      st.d[row][col * 4 + x] = from_f32<bf16>(0.f);
    }
  }
}

// A warp's fragment (keys g, g + 8; values fj, fj + 1) into a 16 x 64 tile.
__device__ __forceinline__ void store_frag(float (*tile)[kRow],
                                           const float (&f)[4], int g,
                                           int fj) {
  *reinterpret_cast<float2*>(&tile[g][fj]) = make_float2(f[0], f[1]);
  *reinterpret_cast<float2*>(&tile[g + 8][fj]) = make_float2(f[2], f[3]);
}

// One stage of a transpose-reduce over the 16 lanes of a half-warp: lane
// kg keeps the M of its 2M partial sums whose entry has bit M equal to its
// own, adds its partner's (lane kg ^ M) for them, and sends the others.
// After M = 8, 4, 2, 1, part[0] is entry kg summed over the 16 lanes.
template <int M>
__device__ __forceinline__ void reduce_half(float (&part)[kC], int kg) {
  const bool up = kg & M;
#pragma unroll
  for (int x = 0; x < M; ++x) {
    const float send = up ? part[x] : part[x + M];
    const float keep = up ? part[x + M] : part[x];
    part[x] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

__device__ __forceinline__ void reduce16(float (&part)[kC], int kg) {
  reduce_half<8>(part, kg);
  reduce_half<4>(part, kg);
  reduce_half<2>(part, kg);
  reduce_half<1>(part, kg);
}

// prod_{m >= ts} w_m over the 16 lanes ts of a half-warp, each holding
// its w_ts (a product scan by shuffles)
__device__ __forceinline__ float suffix_prod(float x, int ts) {
#pragma unroll
  for (int d = 1; d < kC; d <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, x, d, kC);
    x = ts + d < kC ? x * y : x;
  }
  return x;
}

// Q_ts = prod_{m > ts} w_m and D = prod_m w_m from the suffix products
__device__ __forceinline__ void q_and_d(float sfx, int ts, float& q,
                                        float& d) {
  const float next = __shfl_down_sync(0xffffffffu, sfx, 1, kC);
  q = ts == kC - 1 ? 1.f : next;
  d = __shfl_sync(0xffffffffu, sfx, 0, kC);
}

// A forward task's decay products, made a task ahead: thread (key il, step
// ts) writes (k * Q) at its step into buffer b, and D.
template <typename W>
__device__ __forceinline__ void fwd_prep(const Raw<W>& st, Smem<W>& sm,
                                         int b, int il, int ts) {
  float q, d;
  q_and_d(suffix_prod(to_f32(st.w[ts][il]), ts), ts, q, d);
  sm.kqt[b][il][ts] = to_f32(st.k[ts][il]) * q;
  if (ts == 0) sm.df[b][il] = d;
}

// the phase parity of chunk c's dv buffer: the chunks run backward from
// nc - 1, chunk c the ((nc - 1 - c) / kDvBufs)-th use of buffer c % kDvBufs
__device__ __forceinline__ uint32_t dv_parity(int c, int nc) {
  return static_cast<uint32_t>((nc - 1 - c) / kDvBufs) & 1u;
}

// dv of chunk c at the thread's (step tid / 16, value key0 + tid % 16):
// the 4 CTAs' partials summed in rank order
template <typename W>
__device__ __forceinline__ float dv_sum(const Smem<W>& sm, int c, int tid) {
  const float(*in)[kC][kKeys] = sm.dvin[c % kDvBufs];
  float acc = 0.f;
#pragma unroll
  for (int rk = 0; rk < kCluster; ++rk) acc += in[rk][tid >> 4][tid & 15];
  return acc;
}

template <typename W>
__device__ __forceinline__ void dv_store(const Args<W>& a, int c, float x,
                                         size_t base, size_t step, int key0,
                                         int tid) {
  const int ss = tid >> 4;
  if (ss < min(kC, a.t - c * kC))
    a.dv[base + static_cast<size_t>(c * kC + ss) * step + key0 + (tid & 15)] =
        from_f32<bf16>(x);
}

// S <- diag(D) S + (k * Q)^T . v on the warp's fragment (values 8 warp ..),
// the decay products from buffer b.
template <typename W>
__device__ __forceinline__ void state_update(float (&s)[4], const Smem<W>& sm,
                                             const Raw<W>& st, int b,
                                             int warp, int g, int cq) {
  const float(*kqt)[kSq] = sm.kqt[b];
  const float d0 = sm.df[b][g], d1 = sm.df[b][g + 8];
  float lo[4] = {0.f, 0.f, 0.f, 0.f};
  float hi[4] = {s[0] * d0, s[1] * d0, s[2] * d1, s[3] * d1};
  const int j0 = 8 * warp;
  mma2<2>(lo, hi, [&](int i, int ss) { return kqt[i][ss]; },
          [&](int ss, int j) { return to_f32(st.v[ss][j0 + j]); }, g, cq);
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = lo[e] + hi[e];
}

template <typename W>
__global__ void __launch_bounds__(kThreads, 2)
    wkv6_bwd_chunked_kernel(const Args<W> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<W>& sm = *reinterpret_cast<Smem<W>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();

  const int q = static_cast<int>(cluster.block_rank());   // key group
  const int bh = blockIdx.x / kCluster;
  const int bi = bh / a.h;
  const int hi = bh - bi * a.h;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;
  const int il = tid >> 4, ts = tid & 15;  // the thread's (key, step)
  const int key0 = q * kKeys;
  const int nc = (a.t + kC - 1) / kC;
  const int nseg = (nc + kSeg - 1) / kSeg;
  const size_t step = static_cast<size_t>(a.h) * kN;   // elements a step
  const size_t base = static_cast<size_t>(bi) * a.t * step
                      + static_cast<size_t>(hi) * kN;
  const size_t state_off = static_cast<size_t>(bh) * kN * kN;
  float* snap = a.snap + static_cast<size_t>(bh) * nseg * kN * kN;
  const float ui = a.u[hi * kN + key0 + il];
  // the warp's fragment of a 16-key x 64-value tile: keys key0 + g (+ 8),
  // values fj, fj + 1
  const int fj = 8 * warp + 2 * cq;
  auto frag_off = [&](int e) {
    return static_cast<size_t>(key0 + g + 8 * (e >> 1)) * kN + fj + (e & 1);
  };

  float s[4], gr[4], s_seg[4];  // s_seg: the next segment's snapshot
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    s[e] = a.s_in ? a.s_in[state_off + frag_off(e)] : 0.f;
    gr[e] = a.ds_in[state_off + frag_off(e)];
    snap[frag_off(e)] = s[e];           // segment 0's snapshot
    s_seg[e] = s[e];
  }
  store_frag(sm.g[0], gr, g, fj);
  int gcur = 0;
  int pend = -1;  // the chunk whose dv waits on the cluster barrier
  float du = 0.f;
  // the dv buffers' barriers, each armed for its first chunk; every CTA
  // of the cluster has started, its barriers initialised, before a peer
  // pushes into it
  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < kDvBufs; ++b) {
      mbar_init(smem_u32(&sm.full[b]), 1);
      mbar_expect_tx(smem_u32(&sm.full[b]), kDvBytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_arrive();
  cluster_wait();

  // cursors: the task, the next one, and the one whose chunk is loaded
  Task tk = first_task(nc), nx = tk, ahead = tk;
  advance(nx, nc);
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    load_chunk(sm.raw[k], a, base, step, key0, ahead, tid);
    advance(ahead, nc);
  }
  // the first task's decay products, if it is a forward
  cp_wait();
  __syncthreads();
  if (!tk.bwd) fwd_prep(sm.raw[0], sm, 0, il, ts);
  for (int i = 0; tk.valid; ++i, tk = nx, advance(nx, nc)) {
    Raw<W>& st = sm.raw[i % kStages];
    const int len = min(kC, a.t - tk.c * kC);
    cp_wait();                          // this task's chunk and the next's
    if (len < kC) fill_tail(st, len, tid);
    if (tk.first) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = s_seg[e];
    }
    if (tk.pass2 && (!tk.bwd || tk.first))
      store_frag(sm.slot[tk.c - tk.seg_c0], s, g, fj);
    __syncthreads();  // the stages landed; slots, G tile, decay products
    // a chunk into the stage task i - 1 used
    load_chunk(sm.raw[(i + kStages - 1) % kStages], a, base, step, key0,
               ahead, tid);
    advance(ahead, nc);
    // the next task's decay products, if it is a forward
    if (nx.valid && !nx.bwd)
      fwd_prep(sm.raw[(i + 1) % kStages], sm, (i + 1) & 1, il, ts);

    if (!tk.bwd) {
      state_update(s, sm, st, i & 1, warp, g, cq);
      if (!tk.pass2) {
        if ((tk.c + 1) % kSeg == 0) {
          const size_t so = static_cast<size_t>((tk.c + 1) / kSeg) * kN * kN;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            snap[so + frag_off(e)] = s[e];
            s_seg[e] = s[e];            // the last one is the first needed
          }
        }
      } else if (tk.c - tk.seg_c0 == tk.seg_len - 2) {
        store_frag(sm.slot[tk.seg_len - 1], s, g, fj);
      }
      continue;
    }

    // ---- the chunk backward ---------------------------------------------
    const int c0 = tk.c * kC;
    const float(*sc)[kRow] = sm.slot[tk.c - tk.seg_c0];
    const float(*gt)[kRow] = sm.g[gcur];
    // 1. X, Y, dA on the tensor cores; rs; w and k as f32 rows
    if (warp < 4) {
      const int nt = warp & 1;          // steps 8 nt .. 8 nt + 7
      float lo[4] = {0.f, 0.f, 0.f, 0.f}, hs[4] = {0.f, 0.f, 0.f, 0.f};
      if (warp < 2)
        mma_rows(lo, hs, &sc[0][0], &st.d[8 * nt][0], g, cq);
      else
        mma_rows(lo, hs, &gt[0][0], &st.v[8 * nt][0], g, cq);
      float(*dst)[kSq] = warp < 2 ? sm.x : sm.y;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[g + 8 * (e >> 1)][8 * nt + 2 * cq + (e & 1)] = lo[e] + hs[e];
    } else if (warp < 6) {
      const int nt = warp - 4;          // s = 8 nt .. 8 nt + 7
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < kN / 16; ++ks) {
        const int k0 = 16 * ks + 2 * cq;
        const uint32_t a4[4] = {ld32(&st.d[g][k0]), ld32(&st.d[g + 8][k0]),
                                ld32(&st.d[g][k0 + 8]),
                                ld32(&st.d[g + 8][k0 + 8])};
        mma_bf16(acc, a4, ld32(&st.v[8 * nt + g][k0]),
                 ld32(&st.v[8 * nt + g][k0 + 8]));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sm.da[g + 8 * (e >> 1)][8 * nt + 2 * cq + (e & 1)] = acc[e];
    } else {
      const int p = tid - 192, key = p >> 2, part = p & 3;
      float acc = 0.f;
#pragma unroll
      for (int x = 0; x < 4; ++x) {     // columns 4 part + 16 x, a float4
        const float4 s4 = ld4(&sc[key][4 * part + 16 * x]);
        const float4 g4 = ld4(&gt[key][4 * part + 16 * x]);
        acc = fmaf(s4.x, g4.x, acc);
        acc = fmaf(s4.y, g4.y, acc);
        acc = fmaf(s4.z, g4.z, acc);
        acc = fmaf(s4.w, g4.w, acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) sm.rs[key] = acc;
      const int m = p >> 2, k4 = part * 4;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        sm.wt[k4 + x][m] = to_f32(st.w[m][k4 + x]);
        sm.kt[k4 + x][m] = to_f32(st.k[m][k4 + x]);
      }
    }
    __syncthreads();

    // 2. the in-chunk sums, a thread a (key il, step ts)
    {
      const float rt = to_f32(st.r[ts][il]), kt = sm.kt[il][ts];
      float qt, dd;
      q_and_d(suffix_prod(sm.wt[il][ts], ts), ts, qt, dd);
      float mr[kC];                     // M(ts, m) for m < ts, else 0
      float run = 1.f;
#pragma unroll
      for (int m4 = kC - 4; m4 >= 0; m4 -= 4) {
        const float4 w4 = ld4(&sm.wt[il][m4]);
        const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int x = 3; x >= 0; --x) {
          const bool on = m4 + x < ts;
          mr[m4 + x] = on ? run : 0.f;
          run = on ? run * wq[x] : run;
        }
      }
      const float pt = run;             // P_ts
      const float xt = sm.x[il][ts];
      const float dg = rt * ui * kt;    // A's diagonal term
      float z = 0.f, f = 0.f, pm = 1.f;
      float part[kC], part3[kC];
#pragma unroll
      for (int m4 = 0; m4 < kC; m4 += 4) {
        const float4 w4 = ld4(&sm.wt[il][m4]), k4 = ld4(&sm.kt[il][m4]);
        const float4 d4 = ld4(&sm.da[ts][m4]), y4 = ld4(&sm.y[il][m4]);
        const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float dq[4] = {d4.x, d4.y, d4.z, d4.w};
        const float yq[4] = {y4.x, y4.y, y4.z, y4.w};
        float am[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int m = m4 + x;
          const float mrr = mr[m] * rt;  // M(ts, m) r_ts
          part[m] = mrr * fmaf(pm, xt, z);
          part3[m] = mrr * dq[x];
          const float cm = mr[m] * kk[x];  // M(ts, m) k_m
          f = fmaf(cm, yq[x], f);
          am[x] = m == ts ? dg : rt * cm;
          z = m < ts ? fmaf(wq[x], z, dq[x] * kk[x]) : z;
          pm *= wq[x];
        }
        *reinterpret_cast<float4*>(&sm.apart[il][ts][m4]) =
            make_float4(am[0], am[1], am[2], am[3]);
      }
      reduce16(part, ts);               // dw's in-chunk sums for m = ts
      reduce16(part3, ts);              // dk's in-chunk sum for s = ts
      const float dat = sm.da[ts][ts];
      sm.out[0][ts][il] = fmaf(pt, xt, z) + dat * ui * kt;
      sm.out[1][ts][il] = fmaf(qt, sm.y[il][ts], part3[0]) + dat * rt * ui;
      sm.out[2][ts][il] = pt * qt * sm.rs[il] + part[0] + qt * f;
      du = fmaf(dat * rt, kt, du);
      sm.rp[il][ts] = rt * pt;
      sm.kq[ts][il] = kt * qt;
      if (ts == 0) sm.dd[il] = dd;
    }
    __syncthreads();

    // 3. A over the CTA's keys
    {
      const int tt = tid >> 4, cc = tid & 15;
      float acc = 0.f;
#pragma unroll
      for (int key = 0; key < kKeys; ++key) acc += sm.apart[key][tt][cc];
      sm.aq[tt][cc] = acc;
    }
    __syncthreads();

    // 4. dv's partial and G' on the tensor cores, warp w values 8w .. 8w+7
    {
      const int j0 = 8 * warp;
      float lo[4] = {0.f, 0.f, 0.f, 0.f}, hs[4] = {0.f, 0.f, 0.f, 0.f};
      mma2<2>(lo, hs, [&](int ss, int tt) { return sm.aq[tt][ss]; },
              [&](int tt, int j) { return to_f32(st.d[tt][j0 + j]); }, g, cq);
      mma3<2>(lo, hs, [&](int ss, int i2) { return sm.kq[ss][i2]; },
              [&](int i2, int j) { return gt[i2][j0 + j]; }, g, cq);
      // to the owner of these values (rank w / 2), as source q, counted on
      // its barrier of the buffer
      const int b = tk.c % kDvBufs, jj = 8 * (warp & 1) + 2 * cq;
      const uint32_t bar = mapa(smem_u32(&sm.full[b]), warp >> 1);
      const uint32_t to = mapa(smem_u32(&sm.dvin[b][q][0][0]), warp >> 1);
      push2(to + (g * kKeys + jj) * 4, lo[0] + hs[0], lo[1] + hs[1], bar);
      push2(to + ((g + 8) * kKeys + jj) * 4, lo[2] + hs[2], lo[3] + hs[3],
            bar);
      const float d0 = sm.dd[g], d1 = sm.dd[g + 8];
      float glo[4] = {0.f, 0.f, 0.f, 0.f};
      float ghi[4] = {gr[0] * d0, gr[1] * d0, gr[2] * d1, gr[3] * d1};
      mma2<2>(glo, ghi, [&](int i2, int tt) { return sm.rp[i2][tt]; },
              [&](int tt, int j) { return to_f32(st.d[tt][j0 + j]); }, g, cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) gr[e] = glo[e] + ghi[e];
      gcur ^= 1;
      store_frag(sm.g[gcur], gr, g, fj);
    }
    // 5. the chunk before's dv, its partials pushed a task ago: wait for
    // its buffer's bytes, sum, arm the buffer for its next chunk
    if (pend >= 0) {
      mbar_wait(smem_u32(&sm.full[pend % kDvBufs]), dv_parity(pend, nc));
      const float dvx = dv_sum(sm, pend, tid);
      if (tid == 0) mbar_expect_tx(smem_u32(&sm.full[pend % kDvBufs]),
                                   kDvBytes);
      dv_store(a, pend, dvx, base, step, key0, tid);
    }
    pend = tk.c;
    // a segment's first chunk backward fetches the segment before's
    // snapshot, needed after the segment's last
    if (tk.c == tk.seg_c0 + tk.seg_len - 1 && tk.seg_c0 > 0) {
      const size_t so = static_cast<size_t>(tk.seg_c0 / kSeg - 1) * kN * kN;
#pragma unroll
      for (int e = 0; e < 4; ++e) s_seg[e] = snap[so + frag_off(e)];
    }
    {
      // dr, dk, dw of the chunk, 32-byte rows
      const int tt = tid >> 4, cc = tid & 15;
      if (tt < len) {
        const size_t off = base + static_cast<size_t>(c0 + tt) * step + key0
                           + cc;
        a.dr[off] = from_f32<bf16>(sm.out[0][tt][cc]);
        a.dk[off] = from_f32<bf16>(sm.out[1][tt][cc]);
        a.dw[off] = from_f32<W>(sm.out[2][tt][cc]);
      }
    }
  }

  mbar_wait(smem_u32(&sm.full[pend % kDvBufs]), dv_parity(pend, nc));
  dv_store(a, pend, dv_sum(sm, pend, tid), base, step, key0, tid);
#pragma unroll
  for (int e = 0; e < 4; ++e) a.ds_out[state_off + frag_off(e)] = gr[e];
  du += __shfl_xor_sync(0xffffffffu, du, 8);
  du += __shfl_xor_sync(0xffffffffu, du, 4);
  du += __shfl_xor_sync(0xffffffffu, du, 2);
  du += __shfl_xor_sync(0xffffffffu, du, 1);
  if (ts == 0) a.du_part[static_cast<size_t>(bh) * kN + key0 + il] = du;
  // every peer's pushes into this CTA landed before the wait above; no
  // CTA leaves before its pushes into the others have landed
  cluster_arrive();
  cluster_wait();
}

template <typename W>
int launch(const Args<W>& a, int b, cudaStream_t stream) {
  auto kernel = wkv6_bwd_chunked_kernel<W>;
  constexpr int bytes = static_cast<int>(sizeof(Smem<W>));
  static bool configured = false;  // per instantiation: the attribute once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * a.h * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch_typed(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* s_in, const void* dout,
                 const void* ds_in, void* dr, void* dk, void* dv, void* dw,
                 void* du_part, void* ds_out, void* snap, int b, int t, int h,
                 cudaStream_t s) {
  Args<W> a;
  a.r = static_cast<const bf16*>(r);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.w = static_cast<const W*>(w);
  a.u = static_cast<const float*>(u);
  a.s_in = static_cast<const float*>(s_in);
  a.dout = static_cast<const bf16*>(dout);
  a.ds_in = static_cast<const float*>(ds_in);
  a.dr = static_cast<bf16*>(dr);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dw = static_cast<W*>(dw);
  a.du_part = static_cast<float*>(du_part);
  a.ds_out = static_cast<float*>(ds_out);
  a.snap = static_cast<float*>(snap);
  a.t = t;
  a.h = h;
  return launch<W>(a, b, s);
}

}  // namespace

// wdtype: 0 float32, 1 bfloat16 (w, dw). bf16 r, k, v, dout, dr, dk, dv
// (b, t, h, 64); u (h, 64) float32; s_in (b, h, 64, 64) float32 or null
// (zeros); ds_in, ds_out (b, h, 64, 64) and du_part (b, h, 64) float32; snap
// float32 of b * h * ceil(ceil(t / 16) / 8) * 64 * 64. All contiguous, rows
// on 16-byte boundaries. t >= 1. Returns a CUDA error code, 0 if the launch
// was accepted.
extern "C" int rwkv6_scan_bwd_chunked(int wdtype, const void* r,
                                      const void* k, const void* v,
                                      const void* w, const void* u,
                                      const void* s_in, const void* dout,
                                      const void* ds_in, void* dr, void* dk,
                                      void* dv, void* dw, void* du_part,
                                      void* ds_out, void* snap, int b, int t,
                                      int h, void* stream) {
  if (b < 1 || h < 1 || t < 1 || b * h > 0x7fffffff / (kCluster * kThreads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wdtype == 0)
    return launch_typed<float>(r, k, v, w, u, s_in, dout, ds_in, dr, dk, dv,
                               dw, du_part, ds_out, snap, b, t, h, s);
  if (wdtype == 1)
    return launch_typed<bf16>(r, k, v, w, u, s_in, dout, ds_in, dr, dk, dv,
                              dw, du_part, ds_out, snap, b, t, h, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
