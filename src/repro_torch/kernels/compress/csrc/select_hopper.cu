// Top-k / rand-k select of the PerMFL uplinks for Hopper, sm_90a: a
// many-block count-then-scan, with error feedback (EF) and without.
//
// Replaces the Pallas TPU kernels of repro/kernels/compress/compress.py,
// each a variant of the kernel pair here:
//
//   <RANDK=0, EF=0>  _topk_kernel      compress.py:99   topk_select_flat
//   <RANDK=0, EF=1>  _ef_topk_kernel   compress.py:107  ef_topk_select_flat
//   <RANDK=1, EF=0>  _randk_kernel     compress.py:116  randk_select_flat
//   <RANDK=1, EF=1>  _ef_randk_kernel  compress.py:123  ef_randk_select_flat
//
// What it computes is the plain version's (../ref.py _select), bit for
// bit: keep every value whose score (|msg| for top-k, the given uniform u
// for rand-k) is strictly above its (sender, leaf)'s threshold, then fill
// the remaining cap = k - n_strict slots with == threshold ties in index
// order; ranks = wire slot in [0, k) or -1, dq = msg where kept (times the
// leaf's f32(p / k) for unbiased rand-k), else 0, and with EF ef' = msg -
// dq. msg = v + ef with EF, else v. Columns past the last leaf: dq 0, ranks
// -1, ef' = msg. Only the integer counts are summed in another order (tile
// by tile), and they are exact.
//
// The constraint that shapes it: a tie is kept only if its index among the
// leaf's ties is <= cap, so the leaf's WHOLE strict count must be known
// before any tie is decided. So the leaf is cut into tiles of kTile values
// (a tile never crosses a leaf's boundary) and the work takes two launches
// over every (tile, sender) of every leaf:
//   1. count_kernel: each block reads only what its score needs (|v|,
//      |v + ef|, or u) and writes its tile's packed (n_strict << 16 |
//      n_tie) into a small int32 scratch the wrapper allocates.
//   2. scan_kernel: each block loads its tile, and meanwhile warp 0 reads
//      its leaf's tile counts (49 at the CNN's dense leaf): the strict and
//      tie counts of the tiles before it and the leaf's cap. Then one
//      block-wide scan of the tile in index order, and the outputs.
// No block waits on another block of its grid, so nothing depends on which
// blocks are resident. The CNN LAN uplink (40 senders x 57 tiles) gives
// 2,280 blocks a launch, the WAN (4 senders) 228, where the one-block
// kernel this replaces had 320 and 32 (one per (sender, leaf)), its dense
// leaf walked serially by 40 or 4 blocks.
//
// The scan is a programmatic dependent launch: every count block lets it
// launch at once (griddepcontrol.launch_dependents), so its blocks take
// the SMs as the count's last ones leave, load their tiles, and wait
// (griddepcontrol.wait) only where warp 0 reads the counts. The scan walks
// the (tile, sender) grid backwards, so its first tiles are the count's
// last, the likeliest still in the L2. Its 16-byte stores go through
// __stcs: written as plain assignments they compile, at 512-thread blocks,
// to a schedule that ran ~1.4x slower on the card, while __stwb ran as
// __stcs does (scripts/select_variants.py), so it is the schedule and not
// the cache policy that counts.
//
// A thread holds kSub x kItems values: kItems consecutive values (one
// float4) in each of the tile's kSub sub-tiles of kThreads * kItems, so
// every load and store of a warp is 512 contiguous bytes. The in-tile scan
// is a warp scan of each sub-tile's packed counts, then one warp's scan of
// the kSub * kWarps warp totals in index order: two __syncthreads a tile.
//
// What bounds it on the card: HBM bytes. The bound counts each input once
// (chip_smoke.py compress_bytes); this design reads the score's operands
// twice, so with no L2 reuse it moves 16 B/value for topk (bound 12: 75%),
// 28 for ef_topk (20: 71%), 20 for randk (16: 80%), 28 for ef_randk (24:
// 86%). Other forms (scripts/select_variants.py, PERF.md) measured slower
// on the card: one persistent cooperative launch with a grid-wide barrier,
// sender groups small enough for the L2 to keep their scores, a 16-CTA
// cluster per (leaf, sender) holding its slice in shared memory (each
// input read once); 128-thread blocks, 8,192-value tiles and L2
// evict_last loads came within a few percent either way.
//
// Leaves whose offset is not a multiple of 4, or rows that are not 16-byte
// aligned (vec = 0), take the scalar path (the same layout, one value a
// load). Each operation rounds on its own, as the plain version: __fadd_rn
// for msg, __fmul_rn for the rand-k factor, __fsub_rn for ef' (build
// without --use_fast_math). The kernels run on the caller's stream and
// allocate nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kItems = 4;  // consecutive values a thread holds a sub-tile
constexpr int kSub = 2;    // sub-tiles a tile
constexpr int kWarps = kThreads / 32;
constexpr int kSubTile = kThreads * kItems;
constexpr int kTile = kSubTile * kSub;  // values a tile
constexpr int kParts = kSub * kWarps;   // warp totals a tile, in index order
static_assert(kTile < 65536, "a tile's counts are packed 16 bits each");

// Where block (t, sender) works: segment s (offset, length, k), the tile's
// first value in the leaf, its n real values, and whether its rows take
// 16-byte accesses.
struct TileAt {
  int s;
  int64_t off, len, k, start;
  int n;
  bool vec;
};

// tile0: (nseg + 1) int32, each leaf's first tile among all leaves' tiles
// and, last, the tiles of all leaves.
__device__ __forceinline__ TileAt locate_tile(const int64_t* segs,
                                              const int32_t* tile0, int nseg,
                                              int t, int vec) {
  int lo = 0, hi = nseg - 1;  // the last segment whose first tile is <= t
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tile0[mid] <= t)
      lo = mid;
    else
      hi = mid - 1;
  }
  TileAt at;
  at.s = lo;
  at.off = segs[4 * lo];
  at.len = segs[4 * lo + 1];
  at.k = segs[4 * lo + 2];
  at.start = int64_t(t - tile0[lo]) * kTile;
  const int64_t rest = at.len - at.start;
  at.n = static_cast<int>(rest < kTile ? rest : kTile);
  at.vec = vec != 0 && (at.off % 4) == 0;
  return at;
}

__device__ __forceinline__ void unpack4(const float4 a, float x[kItems]) {
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}

// The messages m and scores sc of the kItems values at i of a tile of n
// values (v, e, u point at the tile's first value); padding reads 0.
template <bool RANDK, bool EF>
__device__ __forceinline__ void load_values(const float* v, const float* e,
                                            const float* u, int i, int n,
                                            bool vec, float m[kItems],
                                            float sc[kItems]) {
  if (vec && i + kItems <= n) {
    unpack4(*reinterpret_cast<const float4*>(v + i), m);
    if (EF) {
      float ev[kItems];
      unpack4(*reinterpret_cast<const float4*>(e + i), ev);
#pragma unroll
      for (int j = 0; j < kItems; ++j) m[j] = __fadd_rn(m[j], ev[j]);
    }
    if (RANDK) unpack4(*reinterpret_cast<const float4*>(u + i), sc);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      m[j] = 0.0f;
      sc[j] = 0.0f;
      if (i + j < n) {
        m[j] = EF ? __fadd_rn(v[i + j], e[i + j]) : v[i + j];
        if (RANDK) sc[j] = u[i + j];
      }
    }
  }
  if (!RANDK) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) sc[j] = fabsf(m[j]);
  }
}

// The scores alone (rand-k reads only u).
template <bool RANDK, bool EF>
__device__ __forceinline__ void load_scores(const float* v, const float* e,
                                            const float* u, int i, int n,
                                            bool vec, float sc[kItems]) {
  if (RANDK) {
    if (vec && i + kItems <= n) {
      unpack4(*reinterpret_cast<const float4*>(u + i), sc);
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j) sc[j] = i + j < n ? u[i + j] : 0.0f;
    }
  } else {
    float m[kItems];
    load_values<false, EF>(v, e, nullptr, i, n, vec, m, sc);
  }
}

// Packed (strict << 16 | tie) count of the kItems values at i.
__device__ __forceinline__ uint32_t count_items(const float sc[kItems],
                                                float thr, int i, int n) {
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool in = i + j < n;
    c += (static_cast<uint32_t>(in && sc[j] > thr) << 16) |
         static_cast<uint32_t>(in && sc[j] == thr);
  }
  return c;
}

// Phase 1 for tile t of sender b (ntiles tiles a sender): counts
// (senders, ntiles) gets the tile's packed strict and tie counts.
template <bool RANDK, bool EF>
__device__ __forceinline__ void count_tile(
    int t, int64_t b, int ntiles, const float* __restrict__ v,
    const float* __restrict__ ef, const float* __restrict__ u,
    const int64_t* __restrict__ segs, const int32_t* __restrict__ tile0,
    const float* __restrict__ thresh, uint32_t* __restrict__ counts,
    int nseg, int64_t ld_v, int64_t ld_e, int64_t ld_u, int vec) {
  __shared__ uint32_t warp_total[kWarps];
  const TileAt at = locate_tile(segs, tile0, nseg, t, vec);
  const float thr = thresh[b * nseg + at.s];
  const int64_t col = at.off + at.start;
  const float* vb = RANDK ? nullptr : v + b * ld_v + col;
  const float* eb = EF && !RANDK ? ef + b * ld_e + col : nullptr;
  const float* ub = RANDK ? u + b * ld_u + col : nullptr;
  float sc[kSub][kItems];
#pragma unroll
  for (int c = 0; c < kSub; ++c)  // all loads in flight before any count
    load_scores<RANDK, EF>(vb, eb, ub, c * kSubTile + threadIdx.x * kItems,
                           at.n, at.vec, sc[c]);
  uint32_t cnt = 0;
#pragma unroll
  for (int c = 0; c < kSub; ++c)
    cnt += count_items(sc[c], thr, c * kSubTile + threadIdx.x * kItems, at.n);
  cnt = __reduce_add_sync(kFull, cnt);
  if ((threadIdx.x & 31) == 0) warp_total[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_total[w];
    counts[b * ntiles + t] = total;
  }
}

// Phase 2 for tile t of sender b: the tile's dq, ranks (and ef' with EF).
// Outputs share the row stride ld_o. scale: (nseg,) kept-value factors
// (unbiased rand-k) or null. The last tile also writes the columns [end,
// cols) past the last leaf.
template <bool RANDK, bool EF>
__device__ __forceinline__ void scan_tile(
    int t, int64_t b, int ntiles, const float* __restrict__ v,
    const float* __restrict__ ef, const float* __restrict__ u,
    float* __restrict__ dq, int32_t* __restrict__ ranks,
    float* __restrict__ ef_out, const int64_t* __restrict__ segs,
    const int32_t* __restrict__ tile0, const float* __restrict__ thresh,
    const float* __restrict__ scale, const uint32_t* __restrict__ counts,
    int nseg, int64_t cols, int64_t ld_v, int64_t ld_e, int64_t ld_u,
    int64_t ld_o, int vec) {
  __shared__ uint32_t parts[kParts];
  __shared__ int carry[3];  // strict and tie counts before the tile; cap
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const TileAt at = locate_tile(segs, tile0, nseg, t, vec);
  const float thr = thresh[b * nseg + at.s];
  const float kscale = scale != nullptr ? scale[at.s] : 1.0f;
  v += b * ld_v;
  if (EF) ef += b * ld_e;
  dq += b * ld_o;
  ranks += b * ld_o;
  if (EF) ef_out += b * ld_o;
  if (t == ntiles - 1) {  // the last leaf's last tile
    for (int64_t c = at.off + at.len + threadIdx.x; c < cols; c += kThreads) {
      dq[c] = 0.0f;
      ranks[c] = -1;
      if (EF) ef_out[c] = __fadd_rn(v[c], ef[c]);
    }
  }
  const int64_t col = at.off + at.start;
  float m[kSub][kItems], sc[kSub][kItems];
#pragma unroll
  for (int c = 0; c < kSub; ++c)
    load_values<RANDK, EF>(v + col, EF ? ef + col : nullptr,
                           RANDK ? u + b * ld_u + col : nullptr,
                           c * kSubTile + threadIdx.x * kItems, at.n, at.vec,
                           m[c], sc[c]);
  if (warp == 0) {  // the leaf's tile counts, while the loads are in flight
    // the count kernel has ended and its counts are visible (the scan is a
    // programmatic dependent launch: it may start while the count runs)
    asm volatile("griddepcontrol.wait;" ::: "memory");
    const int first = tile0[at.s];
    const int nt = tile0[at.s + 1] - first;
    const int mine = t - first;
    const uint32_t* cb = counts + b * ntiles + first;
    uint32_t before_s = 0, before_t = 0, leaf_s = 0;
    for (int i = lane; i < nt; i += 32) {
      const uint32_t w = __ldcg(cb + i);  // the count just wrote it
      leaf_s += w >> 16;
      if (i < mine) {
        before_s += w >> 16;
        before_t += w & 0xffffu;
      }
    }
    before_s = __reduce_add_sync(kFull, before_s);
    before_t = __reduce_add_sync(kFull, before_t);
    leaf_s = __reduce_add_sync(kFull, leaf_s);
    if (lane == 0) {
      carry[0] = static_cast<int>(before_s);
      carry[1] = static_cast<int>(before_t);
      carry[2] = static_cast<int>(at.k - static_cast<int64_t>(leaf_s));
    }
  }
  // in-tile: each sub-tile's packed counts scanned over the warp's lanes
  uint32_t own[kSub], incl[kSub];
#pragma unroll
  for (int c = 0; c < kSub; ++c) {
    own[c] = count_items(sc[c], thr, c * kSubTile + threadIdx.x * kItems,
                         at.n);
    uint32_t x = own[c];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    incl[c] = x;
  }
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < kSub; ++c) parts[c * kWarps + warp] = incl[c];
  }
  __syncthreads();
  if (warp == 0) {  // the warp totals in index order (sub-tile, warp)
    uint32_t run = 0;
#pragma unroll
    for (int q = 0; q < kParts; q += 32) {
      const bool real = q + lane < kParts;
      const uint32_t x = real ? parts[q + lane] : 0u;
      uint32_t y = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t z = __shfl_up_sync(kFull, y, o);
        if (lane >= o) y += z;
      }
      if (real) parts[q + lane] = run + y - x;
      run += __shfl_sync(kFull, y, 31);
    }
  }
  __syncthreads();
  const int cap = carry[2];
#pragma unroll
  for (int c = 0; c < kSub; ++c) {
    const int i = c * kSubTile + threadIdx.x * kItems;
    // packed exclusive count of the values before the thread's in the tile
    const uint32_t ex = parts[c * kWarps + warp] + incl[c] - own[c];
    int ps = carry[0] + static_cast<int>(ex >> 16);
    int pt = carry[1] + static_cast<int>(ex & 0xffffu);
    float d[kItems], e[kItems];
    int32_t r[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool in = i + j < at.n;
      const bool strict = in && sc[c][j] > thr;
      const bool tie = in && sc[c][j] == thr;
      ps += strict;
      pt += tie;
      const bool sel = strict || (tie && pt <= cap);
      const float kept = scale != nullptr ? __fmul_rn(m[c][j], kscale)
                                          : m[c][j];
      d[j] = sel ? kept : 0.0f;
      r[j] = sel ? ps + (pt < cap ? pt : cap) - 1 : -1;
      e[j] = EF ? __fsub_rn(m[c][j], d[j]) : 0.0f;
    }
    const int64_t o = col + i;
    if (at.vec && i + kItems <= at.n) {
      __stcs(reinterpret_cast<float4*>(dq + o),
             make_float4(d[0], d[1], d[2], d[3]));
      __stcs(reinterpret_cast<int4*>(ranks + o),
             make_int4(r[0], r[1], r[2], r[3]));
      if (EF)
        __stcs(reinterpret_cast<float4*>(ef_out + o),
               make_float4(e[0], e[1], e[2], e[3]));
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (i + j < at.n) {
          dq[o + j] = d[j];
          ranks[o + j] = r[j];
          if (EF) ef_out[o + j] = e[j];
        }
      }
    }
  }
}

// blockIdx.x = tile among all leaves' tiles, blockIdx.y = sender. Each
// block lets the scan launch at once: its blocks take the SMs as the
// count's last blocks leave them.
template <bool RANDK, bool EF>
__global__ void __launch_bounds__(kThreads)
    count_kernel(const float* __restrict__ v, const float* __restrict__ ef,
                 const float* __restrict__ u, const int64_t* __restrict__ segs,
                 const int32_t* __restrict__ tile0,
                 const float* __restrict__ thresh,
                 uint32_t* __restrict__ counts, int nseg, int64_t ld_v,
                 int64_t ld_e, int64_t ld_u, int vec) {
  asm volatile("griddepcontrol.launch_dependents;");
  count_tile<RANDK, EF>(blockIdx.x, blockIdx.y, gridDim.x, v, ef, u, segs,
                        tile0, thresh, counts, nseg, ld_v, ld_e, ld_u, vec);
}

// Over the same grid as count_kernel, backwards: the scan's first tiles are
// the count's last, the likeliest still in the L2.
template <bool RANDK, bool EF>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const float* __restrict__ v, const float* __restrict__ ef,
                const float* __restrict__ u, float* __restrict__ dq,
                int32_t* __restrict__ ranks, float* __restrict__ ef_out,
                const int64_t* __restrict__ segs,
                const int32_t* __restrict__ tile0,
                const float* __restrict__ thresh,
                const float* __restrict__ scale,
                const uint32_t* __restrict__ counts, int nseg, int64_t cols,
                int64_t ld_v, int64_t ld_e, int64_t ld_u, int64_t ld_o,
                int vec) {
  scan_tile<RANDK, EF>(gridDim.x - 1 - blockIdx.x, gridDim.y - 1 - blockIdx.y,
                       gridDim.x, v, ef, u, dq, ranks, ef_out, segs, tile0,
                       thresh, scale, counts, nseg, cols, ld_v, ld_e, ld_u,
                       ld_o, vec);
}

// Launch the scan as a programmatic dependent launch of the count before
// it on stream s: it may start before the count ends, and waits for it
// (griddepcontrol.wait) before it reads the counts.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                             cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// The values a tile holds: the wrapper builds tile0 from it.
extern "C" int select_tile_values() { return kTile; }

// Pointers are device pointers on the caller's stream; ld_* are row strides
// in elements. segs is the (nseg, 4) int64 segment table (offset, length in
// [1, 2^31), k, first wire row) in row order, the leaves back to back from
// column 0; tile0 the (nseg + 1) int32 first tile of each leaf (tiles of
// select_tile_values() values, none across a leaf's end) and, last, ntiles,
// all leaves' tiles; counts a (senders, ntiles) int32 scratch. cols >= the
// last leaf's end is the width of the rows. randk = 0: top-k on |msg|;
// randk = 1: rand-k on u. thresh is (senders, nseg), the k-th largest score
// of each (sender, leaf); scale is (nseg,) factors of the kept values
// (unbiased rand-k without EF) or null. ef and ef_out are both given (error
// feedback: msg = v + ef, ef' written) or both null (msg = v). vec = 1
// vouches that every pointer and row start is 16-byte aligned, so leaves
// whose offset is a multiple of 4 take 16-byte accesses. Two launches;
// returns cudaGetLastError() after them (0 on success).
extern "C" int select_tiled(int randk, const float* v, const float* ef,
                            const float* u, float* dq, int32_t* ranks,
                            float* ef_out, const int64_t* segs,
                            const int32_t* tile0, const float* thresh,
                            const float* scale, uint32_t* counts, int nseg,
                            int ntiles, int64_t cols, int64_t senders,
                            int64_t ld_v, int64_t ld_e, int64_t ld_u,
                            int64_t ld_o, int vec, void* stream) {
  if (nseg < 1 || ntiles < nseg || senders < 1 || senders > 65535 ||
      (ef == nullptr) != (ef_out == nullptr) || (ef != nullptr && scale) ||
      (randk != 0) != (u != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(ntiles),
                  static_cast<unsigned>(senders));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SEL_LAUNCH(R, E)                                                     \
  do {                                                                       \
    count_kernel<R, E><<<grid, kThreads, 0, s>>>(                            \
        v, ef, u, segs, tile0, thresh, counts, nseg, ld_v, ld_e, ld_u, vec); \
    if (const cudaError_t err = cudaGetLastError())                          \
      return static_cast<int>(err);                                          \
    if (const cudaError_t err = launch_dependent(                            \
            scan_kernel<R, E>, grid, s, v, ef, u, dq, ranks, ef_out, segs,   \
            tile0, thresh, scale, static_cast<const uint32_t*>(counts),      \
            nseg, cols, ld_v, ld_e, ld_u, ld_o, vec))                        \
      return static_cast<int>(err);                                          \
  } while (0)
  if (ef != nullptr) {
    if (randk)
      SEL_LAUNCH(true, true);
    else
      SEL_LAUNCH(false, true);
  } else {
    if (randk)
      SEL_LAUNCH(true, false);
    else
      SEL_LAUNCH(false, false);
  }
#undef SEL_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
