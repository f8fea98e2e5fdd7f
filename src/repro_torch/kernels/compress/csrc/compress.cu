// Compression of the PerMFL uplinks for Hopper, sm_90a: int8 and sign, with
// error feedback (EF) and without, and the bare int8 quantize. (Top-k and
// rand-k are select_hopper.cu.)
//
// Replaces the Pallas TPU kernels of repro/kernels/compress/compress.py and
// repro/kernels/quantize/quantize.py, each a variant of one kernel template
// here (EF = with error feedback):
//
//   int8_kernel<EF=1>             _ef_quant_kernel   compress.py:133
//   int8_kernel<EF=0>             _quant_kernel      quantize.py:23
//   sign_kernel<EF=1>             _ef_sign_kernel    compress.py:168
//   sign_kernel<EF=0>             _sign_kernel       compress.py:161
//
// Semantics are pinned by the plain PyTorch versions in ../ref.py and
// ../../quantize/ref.py (and the reference's ref.py files). With EF every
// kernel first forms msg = delta + ef and finally writes dq (what the
// receiver adds) and the new residual ef' = msg - dq; without EF the message
// is the input v and only dq (and the wire outputs) are written:
//
//   int8    per 128-value row of the leaf: scale = max(absmax * f32(1/127),
//           1e-12), q = clip(floor(msg / scale + u), -127, 127), dq = q*scale.
//   sign    bits (rows, 16) u8 per leaf, lane 8c+j of a row at bit j of byte
//           c, 1 where msg >= 0; dq = scale * sign(msg), sign(0) = 0, with
//           the leaf's scale given.
//
// Layout. A tier is one flat row per sender with the parameter leaves packed
// back to back (repro_torch/flat.py), so every launch covers ALL senders and
// ALL leaves at once: a segment table (int64 x 4 per leaf: offset in the
// row, length p, k, first wire row) says where each leaf lies, and int8
// scales / sign bytes are per 128-value row OF THE LEAF, counted from the
// leaf's first value, the last row zero-padded. Leaf offsets are mostly not
// 16-byte aligned, so 16-byte vector accesses are taken only where the
// caller vouches for the base pointers and row strides (`vec`) AND the
// leaf's offset is a multiple of 4; everything else takes the scalar path.
//
// What bounds them on the card: HBM bytes (a handful of flops per value).
// At the CNN LAN uplink, 40 senders x 206,922 f32 values, 3.35 TB/s:
//   ef_int8   delta, ef, u read; dq, ef' written; q i8 written: 21 B/value
//             + 4 B per scale, 174.1 MB -> 52.0 us; quantize 13 B/value
//   ef_sign   delta, ef read; dq, ef' written: 16 B/value + 16 B per row of
//             bits, 133.5 MB -> 39.8 us; sign 8 B/value
// What the design does about it:
//  * int8 and sign give one warp to each 128-value row: 4 values per lane
//    (one float4 where aligned), the row absmax by warp shuffles, the sign
//    byte by one shuffle between lane pairs. All sender rows of all leaves
//    run at once (~65k warps at the CNN LAN uplink), so they stream.
//  * Without EF the variants read and write less and nothing else changes:
//    the EF operands are compile-time absent, not branched on per value.
//
// Each operation rounds on its own, in the plain version's order: __fadd_rn
// for msg, __fsub_rn for ef', __fmul_rn for absmax * (1/127) and q * scale,
// __fdiv_rn for msg / scale. So no multiply-add contracts into an FMA, and
// the kernels agree with the plain versions bit for bit (build without
// --use_fast_math). The kernels run on the caller's stream
// and allocate nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 128;         // values per int8 scale / sign row
constexpr int kRowWarps = 8;        // leaf rows (one warp each) per block
constexpr float kInv127 = 0x1.020408p-7f;  // f32(1/127), as the reference

struct Seg {
  int64_t off, len, k, row0;
};

__device__ __forceinline__ Seg load_seg(const int64_t* segs, int s) {
  return Seg{segs[4 * s], segs[4 * s + 1], segs[4 * s + 2], segs[4 * s + 3]};
}

// The segment that holds wire row `row`: the last one whose first row is
// <= row (segments are in row order and none is empty).
__device__ __forceinline__ int find_seg(const int64_t* segs, int nseg,
                                        int64_t row) {
  int lo = 0, hi = nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (segs[4 * mid + 3] <= row)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// The message at i: v + ef with error feedback, else v itself.
template <bool EF>
__device__ __forceinline__ float msg_at(const float* v, const float* e,
                                        int64_t i) {
  return EF ? __fadd_rn(v[i], e[i]) : v[i];
}

// The messages of 4 consecutive values at an aligned i (16-byte loads).
template <bool EF>
__device__ __forceinline__ void msg4(const float* v, const float* e,
                                     int64_t i, float m[4]) {
  const float4 dv = *reinterpret_cast<const float4*>(v + i);
  m[0] = dv.x;
  m[1] = dv.y;
  m[2] = dv.z;
  m[3] = dv.w;
  if (EF) {
    const float4 ev = *reinterpret_cast<const float4*>(e + i);
    m[0] = __fadd_rn(m[0], ev.x);
    m[1] = __fadd_rn(m[1], ev.y);
    m[2] = __fadd_rn(m[2], ev.z);
    m[3] = __fadd_rn(m[3], ev.w);
  }
}

// Where a warp's row lies: lane values start at column `start + 4 * lane`
// of the flat row, `n` of the row's 128 values are real.
struct RowAt {
  int s;
  int64_t start;
  int n;
  bool vec;
};

__device__ __forceinline__ RowAt locate_row(const int64_t* segs, int nseg,
                                            int64_t row, int vec) {
  const int s = find_seg(segs, nseg, row);
  const Seg sg = load_seg(segs, s);
  const int64_t r = row - sg.row0;
  const int64_t rest = sg.len - r * kLanes;
  return RowAt{s, sg.off + r * kLanes,
               static_cast<int>(rest < kLanes ? rest : kLanes),
               vec != 0 && (sg.off % 4) == 0};
}

// The messages of the lane's 4 values; padding lanes read 0.
template <bool EF>
__device__ __forceinline__ void load_msg(const float* v, const float* e,
                                         int j0, int n, bool vec, float m[4]) {
  if (vec && j0 + 4 <= n) {
    msg4<EF>(v, e, j0, m);
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) m[t] = j0 + t < n ? msg_at<EF>(v, e, j0 + t) : 0.0f;
  }
}

// dq (and ef' with EF) of the lane's 4 values.
template <bool EF>
__device__ __forceinline__ void store_out(float* dq, float* ef_out, int j0,
                                          int n, bool vec, const float d[4],
                                          const float e[4]) {
  if (vec && j0 + 4 <= n) {
    *reinterpret_cast<float4*>(dq + j0) = make_float4(d[0], d[1], d[2], d[3]);
    if (EF)
      *reinterpret_cast<float4*>(ef_out + j0) =
          make_float4(e[0], e[1], e[2], e[3]);
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (j0 + t < n) {
        dq[j0 + t] = d[t];
        if (EF) ef_out[j0 + t] = e[t];
      }
    }
  }
}

// Columns [end, cols) past the last leaf, by the warp of the last wire
// row: nothing sent, dq 0 (and q 0), ef' = msg.
template <bool EF>
__device__ __forceinline__ void write_tail(const float* v, const float* ef,
                                           float* dq, float* ef_out, int8_t* q,
                                           int64_t end, int64_t cols,
                                           int lane) {
  for (int64_t c = end + lane; c < cols; c += 32) {
    dq[c] = 0.0f;
    if (EF) ef_out[c] = msg_at<EF>(v, ef, c);
    if (q) q[c] = 0;
  }
}

// One warp per 128-value leaf row: blockIdx.x * kRowWarps + warp = the
// sender's wire row (over all leaves), blockIdx.y = sender. dq, q (and
// ef_out with EF) share the row stride ld_o; scales (senders, rows_total).
template <bool EF>
__global__ void __launch_bounds__(kRowWarps * 32)
    int8_kernel(const float* __restrict__ v, const float* __restrict__ ef,
                const float* __restrict__ noise, int8_t* __restrict__ q,
                float* __restrict__ scales, float* __restrict__ dq,
                float* __restrict__ ef_out, const int64_t* __restrict__ segs,
                int nseg, int64_t rows_total, int64_t end, int64_t cols,
                int64_t ld_v, int64_t ld_e, int64_t ld_n, int64_t ld_o,
                int vec) {
  const int lane = threadIdx.x & 31;
  const int64_t row = int64_t(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows_total) return;  // the whole warp
  const int64_t b = blockIdx.y;
  const float* vb = v + b * ld_v;
  const float* eb = EF ? ef + b * ld_e : nullptr;
  float* ob = EF ? ef_out + b * ld_o : nullptr;
  if (row == rows_total - 1)
    write_tail<EF>(vb, eb, dq + b * ld_o, ob, q + b * ld_o, end, cols, lane);
  const RowAt at = locate_row(segs, nseg, row, vec);
  const int j0 = 4 * lane;
  float m[4], u[4];
  load_msg<EF>(vb + at.start, EF ? eb + at.start : nullptr, j0, at.n, at.vec,
               m);
  const float* nz = noise + b * ld_n + at.start;
  if (at.vec && j0 + 4 <= at.n) {
    const float4 uv = *reinterpret_cast<const float4*>(nz + j0);
    u[0] = uv.x;
    u[1] = uv.y;
    u[2] = uv.z;
    u[3] = uv.w;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) u[t] = j0 + t < at.n ? nz[j0 + t] : 0.0f;
  }
  float amax = fmaxf(fmaxf(fabsf(m[0]), fabsf(m[1])),
                     fmaxf(fabsf(m[2]), fabsf(m[3])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, o));
  const float scale = fmaxf(__fmul_rn(amax, kInv127), 1e-12f);
  float d[4], e[4];
  int8_t qi[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float qf = fminf(
        fmaxf(floorf(__fadd_rn(__fdiv_rn(m[t], scale), u[t])), -127.0f),
        127.0f);
    qi[t] = static_cast<int8_t>(qf);
    d[t] = __fmul_rn(qf, scale);
    e[t] = EF ? __fsub_rn(m[t], d[t]) : 0.0f;
  }
  store_out<EF>(dq + b * ld_o + at.start, EF ? ob + at.start : nullptr, j0,
                at.n, at.vec, d, e);
  int8_t* qrow = q + b * ld_o + at.start;
  if (at.vec && j0 + 4 <= at.n) {
    *reinterpret_cast<char4*>(qrow + j0) = make_char4(qi[0], qi[1], qi[2], qi[3]);
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (j0 + t < at.n) qrow[j0 + t] = qi[t];
  }
  if (lane == 0) scales[b * rows_total + row] = scale;
}

// One warp per 128-value leaf row, as int8_kernel. scale: (senders, nseg),
// the leaf's mean |msg|; bits: (senders, rows_total, 16).
template <bool EF>
__global__ void __launch_bounds__(kRowWarps * 32)
    sign_kernel(const float* __restrict__ v, const float* __restrict__ ef,
                const float* __restrict__ scale, uint8_t* __restrict__ bits,
                float* __restrict__ dq, float* __restrict__ ef_out,
                const int64_t* __restrict__ segs, int nseg,
                int64_t rows_total, int64_t end, int64_t cols, int64_t ld_v,
                int64_t ld_e, int64_t ld_o, int vec) {
  const int lane = threadIdx.x & 31;
  const int64_t row = int64_t(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows_total) return;  // the whole warp
  const int64_t b = blockIdx.y;
  const float* vb = v + b * ld_v;
  const float* eb = EF ? ef + b * ld_e : nullptr;
  float* ob = EF ? ef_out + b * ld_o : nullptr;
  if (row == rows_total - 1)
    write_tail<EF>(vb, eb, dq + b * ld_o, ob, nullptr, end, cols, lane);
  const RowAt at = locate_row(segs, nseg, row, vec);
  const int j0 = 4 * lane;
  float m[4];
  load_msg<EF>(vb + at.start, EF ? eb + at.start : nullptr, j0, at.n, at.vec,
               m);
  const float sc = scale[b * nseg + at.s];
  uint32_t nib = 0;
  float d[4], e[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    nib |= (m[t] >= 0.0f ? 1u : 0u) << t;
    const float sg = m[t] > 0.0f ? 1.0f : (m[t] < 0.0f ? -1.0f : 0.0f);
    d[t] = __fmul_rn(sc, sg);
    e[t] = EF ? __fsub_rn(m[t], d[t]) : 0.0f;
  }
  // byte c of the row = lanes 2c (bits 0-3) and 2c+1 (bits 4-7)
  const uint32_t hi = __shfl_down_sync(kFull, nib, 1);
  if ((lane & 1) == 0)
    bits[(b * rows_total + row) * (kLanes / 8) + (lane >> 1)] =
        static_cast<uint8_t>(nib | (hi << 4));
  store_out<EF>(dq + b * ld_o + at.start, EF ? ob + at.start : nullptr, j0,
                at.n, at.vec, d, e);
}

int row_grid(int64_t rows_total, int64_t senders, dim3* grid) {
  const int64_t bx = (rows_total + kRowWarps - 1) / kRowWarps;
  if (rows_total < 1 || senders < 1 || senders > 65535 || bx > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  *grid = dim3(static_cast<unsigned>(bx), static_cast<unsigned>(senders));
  return 0;
}

}  // namespace

// All functions: pointers are device pointers on the caller's stream;
// ld_* are row strides in elements; segs is the (nseg, 4) int64 segment
// table (offset, length >= 1, k, first wire row) in row order, the leaves
// back to back from column 0; cols >= the last leaf's end is the width of
// the rows, and columns past the last leaf get dq 0 (q 0) and ef' = msg; vec = 1 vouches that every pointer and row start is 16-byte
// aligned, so leaves whose offset is a multiple of 4 take 16-byte
// accesses. ef and ef_out are both given (error feedback: msg = v + ef,
// ef' written) or both null (msg = v). Each returns cudaGetLastError()
// after its launch (0 on success).

// q shares dq's row stride ld_o; scales is (senders, rows_total).
extern "C" int compress_int8(const float* v, const float* ef,
                             const float* noise, int8_t* q, float* scales,
                             float* dq, float* ef_out, const int64_t* segs,
                             int nseg, int64_t rows_total, int64_t end,
                             int64_t cols, int64_t senders, int64_t ld_v,
                             int64_t ld_e, int64_t ld_n, int64_t ld_o,
                             int vec, void* stream) {
  dim3 grid;
  if (nseg < 1 || (ef == nullptr) != (ef_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = row_grid(rows_total, senders, &grid)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ef != nullptr)
    int8_kernel<true><<<grid, kRowWarps * 32, 0, s>>>(
        v, ef, noise, q, scales, dq, ef_out, segs, nseg, rows_total, end,
        cols, ld_v, ld_e, ld_n, ld_o, vec);
  else
    int8_kernel<false><<<grid, kRowWarps * 32, 0, s>>>(
        v, ef, noise, q, scales, dq, ef_out, segs, nseg, rows_total, end,
        cols, ld_v, ld_e, ld_n, ld_o, vec);
  return static_cast<int>(cudaGetLastError());
}

// scale is (senders, nseg); bits is (senders, rows_total, 16).
extern "C" int compress_sign(const float* v, const float* ef,
                             const float* scale, uint8_t* bits, float* dq,
                             float* ef_out, const int64_t* segs, int nseg,
                             int64_t rows_total, int64_t end, int64_t cols,
                             int64_t senders, int64_t ld_v, int64_t ld_e,
                             int64_t ld_o, int vec, void* stream) {
  dim3 grid;
  if (nseg < 1 || (ef == nullptr) != (ef_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = row_grid(rows_total, senders, &grid)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ef != nullptr)
    sign_kernel<true><<<grid, kRowWarps * 32, 0, s>>>(
        v, ef, scale, bits, dq, ef_out, segs, nseg, rows_total, end, cols,
        ld_v, ld_e, ld_o, vec);
  else
    sign_kernel<false><<<grid, kRowWarps * 32, 0, s>>>(
        v, ef, scale, bits, dq, ef_out, segs, nseg, rows_total, end, cols,
        ld_v, ld_e, ld_o, vec);
  return static_cast<int>(cudaGetLastError());
}
