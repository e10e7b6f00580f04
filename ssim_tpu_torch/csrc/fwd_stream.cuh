// The row stream's constants and steps: the strip, the staged row, the
// symmetric blurs of steps (b) and (c), the warp sum and the formulas.
// Included by fwd_stream_kernel.cuh (ssim_fwd_stream_kernel, the main-path
// modes) and fwd_batch_kernel.cuh (ssim_fwd_batch_stream_kernel, the batch
// modes), and through them by each translation unit of the forward.
#pragma once

#include "band_mma.cuh"
#include "fwd_common.cuh"

namespace {

// The streaming block: kStripW output columns, one thread each; segments of
// at most kMaxSegTiles tiles (the tile mask holds one word per tile row, a
// bit per tile column); the register window's radius; blocks per SM asked
// of ptxas: in the f32 modes 8 (64 registers, a few spilled) measured
// fastest at every main-path shape, against 4 (no spills) to 7 (the
// components modes, whose second sum and pool spill more, measured the same
// at 7 on an H100 at 1080p x4); in the
// precise modes 4 (128 registers), with the last kStreamPreciseRing of the
// window's four signals (s_dd) in a per-thread shared-memory ring, the
// fastest of the windows measured (PERF.md): all four in registers (176
// registers of window) fits only 2-3 blocks per SM, and each signal moved
// to the ring adds 11 shared-memory loads a pixel.
constexpr int kStripW = 128;
constexpr int kStreamThreads = kStripW;
constexpr int kMaxSegTiles = 16;
constexpr int kStreamR = 5;
constexpr int kStreamInW = kStripW + 2 * kStreamR;  // staged columns
constexpr int kStreamBlocks = 8;
constexpr int kStreamPreciseBlocks = 4;
constexpr int kStreamPreciseRing = 1;
// The relaxed modes (kSplit = band_mma::ksteps(kStreamR)): the heavy
// horizontal blurs of a row as band products whose 8 lines are the strip's
// 8 column tiles of 16 (kStripW / 16 == 8), one plane by one warp; every
// other step the block's four warps blur the next two rows, so that no warp
// issues more than one plane's 6 mma in a step (measured on an H100: the
// mma cost grows with the number a warp issues in a step, whatever the
// chains' depth); the window keeps mu_a and mu_b in registers and reads
// (a+b)^2 and (a-b)^2 from a ring of kStreamRing blurred rows in shared
// memory (row q in slot q mod kStreamRing: twice the window's rows, so that
// with s = kP m + k each row's slot is k's and m's parity's). Shared memory:
// kStreamStaged staged {a, b} rows (one past the staged columns is read, as
// a product with a zero of the band, from the next row or the ring, all
// finite), the ring's two planes, the band's fragments and the taps, 29.1 KB
// a block: 7 blocks on an SM (1 KB reserved each), 72 registers, no spills.
constexpr int kStreamSplit = band_mma::ksteps(kStreamR);
constexpr int kStreamRelaxedBlocks = 7;
// The relaxed components and pooled modes (the relaxed score and map's
// body with the components epilogue; kPooled's raw ring adds 4 KB): 6
// blocks per SM (80 registers, 4 bytes spilled in f32) measured 4-7% faster
// than 7 (72 registers) for the components mode at 1080p x4 and 3 x 1080p
// on an H100 (PERF.md).
constexpr int kStreamRelaxedCompBlocks = 6;
constexpr int kStreamStaged = 4;
constexpr int kStreamRing = 2 * (2 * kStreamR + 1);
static_assert(kStripW == 16 * 8, "the row's band product takes 8 tiles of 16 columns");
static_assert((kStreamStaged & (kStreamStaged - 1)) == 0, "a power of two");

// The runtime-radius instantiation (kR = 0, ssim_fwd_stream_rt.cu): any
// radius from 1 to kMaxStreamR, the window's 2r + 1 rows of all four
// signals in a ring in dynamic shared memory (ssim_fwd_stream_rt.cu
// stream_rt_smem_bytes), the taps in shared memory; the blocks per SM asked
// of ptxas as at kStreamR (64 registers, 128 in the precise modes; no
// spills), which the ring's size lowers from radius 6 up: on an H100 8 at
// radii 1-4 to 3 at 13-16, precise 4 to 1 (PERF.md). The relaxed modes'
// runtime-radius instantiations (kSplit = band_mma::ksteps(r), 2 up to
// radius 8 and 3 above, ssim_fwd_stream_rt_relaxed.cu) keep the standard
// one's ring of 2r + 1 rows of four signals, mu_a and mu_b from the f32
// pass and (a+b)^2, (a-b)^2 from the band products, and before it in
// dynamic shared memory the kStreamStaged staged {a, b} rows (kStripW + 2
// kMaxStreamR columns each, so that a band product's reads stay inside a
// row) and the heavy blurs of kStreamRtHres rows (two planes of kStripW
// floats, ring_col order): the row a step reads and the two an even step
// blurs ahead.
constexpr int kMaxStreamR = kMaxTaps / 2;
constexpr int kStreamRtHres = 4;
constexpr int kStreamRtAbBytes = 8 * kStreamStaged * (kStripW + 2 * kMaxStreamR);
constexpr int kStreamRtHresBytes = 4 * 2 * kStreamRtHres * kStripW;
__host__ __device__ constexpr size_t stream_rt_relaxed_smem_bytes(int r) {
  return kStreamRtAbBytes + kStreamRtHresBytes + (size_t)(2 * r + 1) * kStreamThreads * 16;
}

template <int kMode, int kSplit = 0>
constexpr int kStreamBlocksOf =
    kSplit > 0 ? (kMode == kComponents || kMode == kPooled ? kStreamRelaxedCompBlocks
                                                           : kStreamRelaxedBlocks)
    : kIsPrecise<kMode> ? kStreamPreciseBlocks
                        : kStreamBlocks;
template <int kMode>
constexpr int kStreamRingOf = kIsPrecise<kMode> ? kStreamPreciseRing : 0;

// The stream's taps, kernel parameters: the 2 kR + 1 of the register-window
// radius; with kR = 0 up to kMaxTaps and the radius r itself.
template <typename P, int kR = kStreamR>
struct StreamTaps {
  P t[2 * kR + 1];
};
template <typename P>
struct StreamTaps<P, 0> {
  P t[kMaxTaps];
  int r;
};
// The radius of a StreamTaps: with kR > 0 an object whose type carries the
// value (so the kernel's code, written for a runtime radius, folds as
// written for kR), else the runtime tp.r.
template <int kR>
struct StreamRadius {
  __host__ __device__ constexpr operator int() const { return kR; }
};
template <typename P, int kR>
__host__ __device__ __forceinline__ constexpr StreamRadius<kR> stream_radius(
    const StreamTaps<P, kR>&) {
  return {};
}
template <typename P>
__host__ __device__ __forceinline__ int stream_radius(const StreamTaps<P, 0>& tp) {
  return tp.r;
}

// The four signals of one column, in the blur's type.
template <typename P>
struct Vec4 {
  P x, y, z, w;
};

// A staged row of N columns (kStreamInW; the batch modes' kBatchInW),
// {a, b, (a+b)^2, (a-b)^2} per staged column: one float4 in the f32 modes;
// two double2 planes in the precise modes, so that a warp's 16-byte loads of
// consecutive columns stay conflict-free.
template <typename P, int N = kStreamInW>
struct StagedRow;
template <int N>
struct StagedRow<float, N> {
  float4 v[N];
  __device__ __forceinline__ void put(int j, float va, float vb) {
    const float sm = va + vb, df = va - vb;
    v[j] = make_float4(va, vb, sm * sm, df * df);
  }
  __device__ __forceinline__ Vec4<float> get(int j) const {
    const float4 q = v[j];
    return {q.x, q.y, q.z, q.w};
  }
};
template <int N>
struct StagedRow<double, N> {
  // One padding column puts sd 16 bytes off ab's banks (mod 32 bytes), so
  // that a warp reading both planes at every other column is conflict-free.
  double2 ab[N + 1];
  double2 sd[N];
  // The f32 values widen exactly; the products are formed in double.
  __device__ __forceinline__ void put(int j, float va, float vb) {
    const double da = va, db = vb;
    const double sm = da + db, df = da - db;
    ab[j] = make_double2(da, db);
    sd[j] = make_double2(sm * sm, df * df);
  }
  __device__ __forceinline__ Vec4<double> get(int j) const {
    const double2 p = ab[j], q = sd[j];
    return {p.x, p.y, q.x, q.y};
  }
};

// Symmetric taps over 2r + 1 four-signal values: sum_{d=r..1} t[r-d]
// (v(-d) + v(d)) + t[r] v(0), per component, v(i) the value at offset i
// from the centre, tap(i) the tap t[i]; the sum starts at the d = r term,
// as the twin's. r: a StreamRadius (the loop unrolled) or an int (the
// runtime-radius instantiation: a loop).
template <typename P, typename R, typename Tap, typename V>
__device__ __forceinline__ void sym4(R r, Tap&& tap, V&& v, P (&acc)[4]) {
  {
    const P t = tap(0);
    const Vec4<P> lo = v(-r), hi = v(r);
    acc[0] = t * (lo.x + hi.x);
    acc[1] = t * (lo.y + hi.y);
    acc[2] = t * (lo.z + hi.z);
    acc[3] = t * (lo.w + hi.w);
  }
#pragma unroll
  for (int d = r - 1; d >= 1; --d) {
    const P t = tap(r - d);
    const Vec4<P> lo = v(-d), hi = v(d);
    acc[0] += t * (lo.x + hi.x);
    acc[1] += t * (lo.y + hi.y);
    acc[2] += t * (lo.z + hi.z);
    acc[3] += t * (lo.w + hi.w);
  }
  const P tc = tap(r);
  const Vec4<P> ce = v(0);
  acc[0] = acc[0] + tc * ce.x;
  acc[1] = acc[1] + tc * ce.y;
  acc[2] = acc[2] + tc * ce.z;
  acc[3] = acc[3] + tc * ce.w;
}
// sym4 with the kernel parameters' taps at the register window's radius.
template <typename P, typename V>
__device__ __forceinline__ void sym4(const StreamTaps<P>& tp, V&& v, P (&acc)[4]) {
  sym4(stream_radius(tp), [&](int i) { return tp.t[i]; }, v, acc);
}
// sym4's sums of two signals (one double2 plane) for two adjacent columns:
// v points at the staged column 2r to the left of the first, o0 and o1 the
// results for it and the next, each in sym4's order of operations.
__device__ __forceinline__ void sym2x2(const StreamTaps<double>& tp, const double2* v,
                                       double2& o0, double2& o1) {
  constexpr int r = kStreamR;
  double2 w[2 * r + 2];
#pragma unroll
  for (int i = 0; i < 2 * r + 2; ++i) w[i] = v[i];
  {
    const double t = tp.t[0];
    o0.x = t * (w[0].x + w[2 * r].x);
    o0.y = t * (w[0].y + w[2 * r].y);
    o1.x = t * (w[1].x + w[2 * r + 1].x);
    o1.y = t * (w[1].y + w[2 * r + 1].y);
  }
#pragma unroll
  for (int d = r - 1; d >= 1; --d) {
    const double t = tp.t[r - d];
    o0.x += t * (w[r - d].x + w[r + d].x);
    o0.y += t * (w[r - d].y + w[r + d].y);
    o1.x += t * (w[r + 1 - d].x + w[r + 1 + d].x);
    o1.y += t * (w[r + 1 - d].y + w[r + 1 + d].y);
  }
  const double tc = tp.t[r];
  o0.x = o0.x + tc * w[r].x;
  o0.y = o0.y + tc * w[r].y;
  o1.x = o1.x + tc * w[r + 1].x;
  o1.y = o1.y + tc * w[r + 1].y;
}

// sym4's sums of the two signals {a, b} of one column of the relaxed modes'
// staged rows: v points at the centre; r and tap as sym4's.
template <typename R, typename Tap>
__device__ __forceinline__ void sym2(R r, Tap&& tap, const float2* v, float (&acc)[2]) {
  {
    const float t = tap(0);
    const float2 lo = v[-r], hi = v[r];
    acc[0] = t * (lo.x + hi.x);
    acc[1] = t * (lo.y + hi.y);
  }
#pragma unroll
  for (int d = r - 1; d >= 1; --d) {
    const float t = tap(r - d);
    const float2 lo = v[-d], hi = v[d];
    acc[0] += t * (lo.x + hi.x);
    acc[1] += t * (lo.y + hi.y);
  }
  const float tc = tap(r);
  const float2 ce = v[0];
  acc[0] = acc[0] + tc * ce.x;
  acc[1] = acc[1] + tc * ce.y;
}
// sym2 with the kernel parameters' taps at the register window's radius.
__device__ __forceinline__ void sym2(const StreamTaps<float>& tp, const float2* v,
                                     float (&acc)[2]) {
  sym2(stream_radius(tp), [&](int i) { return tp.t[i]; }, v, acc);
}

// The ring's column of output column c: c with bits 3-4 XORed by its warp
// (c / 32 mod 4), so that row_pass's stores (8 columns on each of 4 tiles
// 32 apart) and a warp's reads of its 32 columns are conflict-free.
__device__ __forceinline__ int ring_col(int c) { return c ^ (8 * ((c >> 5) & 3)); }

// One of the relaxed modes' heavy horizontal blurs of one staged row ({a, b}
// columns at row) by one warp: band_mma::sweep over one tile of 16 outputs
// with 8 lines, line g reading staged columns line_at(g) + i (even: 16-byte
// loads), of (a+b)^2 (plane 0) or (a-b)^2 (plane 1), formed as the columns
// are loaded; output m of line n goes to strip column c = col_of(16 n + m)
// (-1: none), out[ring_col(c)]. The main-path stream's lines are the strip's
// 8 tiles (line_at(g) = 16 g, col_of(o) = o: every read inside the row or
// one past it); the batch stream's come from its line tables.
template <int kSplit, typename LineAt, typename ColOf>
__device__ __forceinline__ void row_pass(const float2* row, float* out, int plane,
                                         const uint4* s_band, LineAt line_at, ColOf col_of) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  band_mma::Band<kSplit> bd;
#pragma unroll
  for (int ks = 0; ks < kSplit; ++ks) {
    const uint4 h = s_band[ks * 32 + lane], l = s_band[(kSplit + ks) * 32 + lane];
    bd.hi[ks][0] = h.x, bd.hi[ks][1] = h.y, bd.hi[ks][2] = h.z, bd.hi[ks][3] = h.w;
    bd.lo[ks][0] = l.x, bd.lo[ks][1] = l.y, bd.lo[ks][2] = l.z, bd.lo[ks][3] = l.w;
  }
  const float2* line = row + line_at(g);
  band_mma::sweep<1>(
      bd, 0, 1,
      [&](int i, float(&v)[2][1]) {
        // Columns i and i + 1 of the line: {a, b} each, one 16-byte load.
        const float4 q = *reinterpret_cast<const float4*>(line + i);
        const float x0 = plane ? q.x - q.y : q.x + q.y;
        const float x1 = plane ? q.z - q.w : q.z + q.w;
        v[0][0] = x0 * x0;
        v[1][0] = x1 * x1;
      },
      [&](int, const float(&acc)[1][4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = col_of(16 * (2 * t + (e & 1)) + g + 8 * (e >> 1));
          if (c >= 0) out[ring_col(c)] = acc[0][e];
        }
      });
}
// The main-path stream's lines: the strip's 8 tiles.
template <int kSplit>
__device__ __forceinline__ void row_pass(const float2* row, float* out, int plane,
                                         const uint4* s_band) {
  row_pass<kSplit>(row, out, plane, s_band, [](int g) { return 16 * g; },
                   [](int o) { return o; });
}

// The sum of v over a warp's lanes, in lane 0: shuffles down by 16 .. 1.
template <typename P>
__device__ __forceinline__ P warp_sum(P v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// _ssim_from_blurs (ssim_pallas.py:465-477), as the tile body: in f32, or in
// native fp64 with c1 and c2 unrounded in the precise modes.
template <typename P>
__device__ __forceinline__ P ssim_of(const P (&m)[4], P c1, P c2) {
  const P mu_a = m[0], mu_b = m[1], s_ss = m[2], s_dd = m[3];
  const P mu_a2 = mu_a * mu_a;
  const P mu_b2 = mu_b * mu_b;
  const P mu_ab = mu_a * mu_b;
  const P sigma_ab_x4 = (s_ss - s_dd) - (P)4 * mu_ab;
  const P sigma_sum_x2 = (s_ss + s_dd) - (P)2 * (mu_a2 + mu_b2);
  const P num = ((P)2 * mu_ab + c1) * ((P)0.5 * sigma_ab_x4 + c2);
  const P den = (mu_a2 + mu_b2 + c1) * ((P)0.5 * sigma_sum_x2 + c2);
  return num / den;
}

// _l_cs_from_blurs (ssim_pallas.py:480-490), as the tile body: lum and cs
// from the four blurs in f32; returns ssim = lum * cs, cs in `cs`.
__device__ __forceinline__ float components_of(const float (&m)[4], float c1, float c2,
                                               float& cs) {
  const float mu_a = m[0], mu_b = m[1], s_ss = m[2], s_dd = m[3];
  const float mu_a2 = mu_a * mu_a;
  const float mu_b2 = mu_b * mu_b;
  const float mu_ab = mu_a * mu_b;
  const float sigma_ab_x4 = (s_ss - s_dd) - 4.0f * mu_ab;
  const float sigma_sum_x2 = (s_ss + s_dd) - 2.0f * (mu_a2 + mu_b2);
  const float lum = (2.0f * mu_ab + c1) / (mu_a2 + mu_b2 + c1);
  cs = (0.5f * sigma_ab_x4 + c2) / (0.5f * sigma_sum_x2 + c2);
  return lum * cs;
}

}  // namespace
