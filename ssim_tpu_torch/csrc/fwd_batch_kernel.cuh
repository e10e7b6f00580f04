// The batch modes' packed row-streaming kernel, ssim_fwd_batch_stream_kernel,
// and its second pass. Included by ssim_fwd_batch.cu (the instantiations at
// radius kStreamR, the window in registers) and ssim_fwd_batch_rt.cu (kR =
// 0: any other radius, read at run time, the staged rows and the window in
// dynamic shared memory), each a translation unit of its own.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "band_mma.cuh"
#include "fwd_common.cuh"
#include "fwd_stream.cuh"

namespace {

// At most kBatchPieces images meet one strip (batch_pack: at W >= 12 a strip
// of 128 columns meets at most 12; narrower images are packed at most 12 to
// a row, in one strip), each staged with r clamped columns on either side:
// two staged columns a thread.
constexpr int kBatchPieces = 12;
constexpr int kBatchInW = kStripW + 2 * kStreamR * kBatchPieces;
// kBatch sums each column's ssim - 1 in f32 over at most kBatchRun rows.
constexpr int kBatchRun = 32;
// Blocks per SM asked of ptxas, and the window's signals kept in a
// per-thread shared-memory ring (the precise modes' as the main-path stream;
// kBatch: kBatchRing). kBatch's window of all four signals in registers
// spilled one signal to local memory at 64 registers (~20 local loads a
// step, beside the main-path stream's ~9: the batch step's own state, which
// row a push is); with s_dd in the ring (11 shared loads a step) it measured
// fastest of ring or not at 7 or 8 blocks per SM, at every routed shape on
// an H100 (PERF.md).
constexpr int kBatchBlocks = 8;
constexpr int kBatchRing = 1;
// The relaxed kBatch (kSplit = kStreamSplit): 34.7 KB of shared memory
// (the staged {a, b} rows, the ring of heavy blurs, the band, the line
// tables and the column sums), 6 blocks per SM.
constexpr int kBatchRelaxedBlocks = 6;
template <int kMode, int kSplit = 0>
constexpr int kBatchBlocksOf = kSplit > 0            ? kBatchRelaxedBlocks
                               : kIsPrecise<kMode> ? kStreamPreciseBlocks
                                                   : kBatchBlocks;
template <int kMode>
constexpr int kBatchRingOf = kIsPrecise<kMode> ? kStreamPreciseRing : kBatchRing;
// The relaxed row's heavy blurs are band products (band_mma::sweep, 8 lines
// of 16 outputs a sweep). Where every 16-column tile of the strip lies in
// one image (W a multiple of 16, or one piece), line g is the strip's tile
// g, read from its piece's staged columns (8 lines, as the main-path
// stream). Elsewhere a tile may straddle two images, whose staged columns
// are not contiguous: the lines are the staged row's own tiles of 16
// (outputs at staged columns, up to kBatchLines of them, two sweeps), and
// each strip column reads its output at its staged centre. kBatchAbW staged
// columns a row: a sweep reads all 8 of its lines, so the second sweep's
// last line (line 15, past the kBatchLines that hold outputs) starts at
// column 16 * 15 and reads kStreamSplit k-steps of 16; every line's reads
// end inside its row, and the columns past a row's staged ones stay zero
// (finite, times the band's zeros). A pitch of 16 (kBatchLines - 1 +
// kStreamSplit) put line 15's last 16 reads in the next row's slot, which
// the push stages in the same step: a race between warps.
constexpr int kBatchLines = (kBatchInW - 2 * kStreamR + 15) / 16;
constexpr int kBatchAbW = 16 * (2 * 8 - 1 + kStreamSplit);
static_assert(kBatchLines <= 16, "two sweeps of 8 lines");
// The runtime-radius instantiation's line tables: at radius 16 and 12
// pieces a strip the staged row's tiles number 30, four sweeps of 8.
constexpr int kBatchRtLines = 32;
static_assert((kStripW + 2 * kMaxStreamR * (kBatchPieces - 1) + 15) / 16 <= kBatchRtLines,
              "four sweeps of 8 lines");

// The runtime-radius instantiation's dynamic shared memory for images of
// width W packed k to a row at radius r: the staged rows, sized for the
// most pieces a strip of this pack meets (min(k, 127 / W + 2)), then the
// window's ring of 2r + 1 rows of four signals, one Vec4 of the blurs'
// type a column (fp64: two double2, kStreamThreads apart). Standard and
// precise: two staged rows (by parity) of cols = kStripW + 2r pieces
// columns, a StagedRow's layout (f32: one float4 a column; fp64: the {a, b}
// plane of cols + 1 double2, then the {(a+b)^2, (a-b)^2} plane). Relaxed
// (kSplit > 0): kStreamStaged staged {a, b} rows of `pitch` float2 (every
// line's band product reads inside its row; the columns past the staged
// ones stay zero), then the heavy blurs of kStreamRtHres rows (two planes
// of kStripW floats, ring_col order), then the ring.
struct BatchRtLayout {
  int cols;      // staged columns a row
  int pitch;     // relaxed: a staged row's float2
  size_t ring;   // the ring's byte offset
  size_t bytes;  // in all
};
template <typename P, int kSplit>
__host__ __device__ __forceinline__ BatchRtLayout batch_rt_layout(int r, int W, int k) {
  const int most = (kStripW - 1) / W + 2;
  const int cols = kStripW + 2 * r * (k < most ? k : most);
  BatchRtLayout l{cols, 0, 0, 0};
  if (kSplit > 0) {
    const int sweeps = ((cols - 2 * r + 15) / 16 + 7) / 8;
    l.pitch = 16 * (8 * sweeps - 1 + kSplit);
    l.ring = (size_t)8 * kStreamStaged * l.pitch + kStreamRtHresBytes;
  } else {
    l.ring = 2 * (sizeof(P) == 4 ? (size_t)16 * cols : (size_t)16 * (2 * cols + 1));
  }
  l.bytes = l.ring + (size_t)(2 * r + 1) * kStreamThreads * 4 * sizeof(P);
  return l;
}

// A staged row of the runtime-radius instantiation in dynamic shared
// memory: StagedRow<P, cols>'s layout and operations at a pitch read at run
// time.
template <typename P>
struct StagedRowAt;
template <>
struct StagedRowAt<float> {
  float4* v;
  __device__ __forceinline__ StagedRowAt(unsigned char* base, int buf, int cols)
      : v(reinterpret_cast<float4*>(base) + (size_t)buf * cols) {}
  __device__ __forceinline__ void put(int j, float va, float vb) const {
    const float sm = va + vb, df = va - vb;
    v[j] = make_float4(va, vb, sm * sm, df * df);
  }
  __device__ __forceinline__ Vec4<float> get(int j) const {
    const float4 q = v[j];
    return {q.x, q.y, q.z, q.w};
  }
};
template <>
struct StagedRowAt<double> {
  double2* ab;
  double2* sd;
  __device__ __forceinline__ StagedRowAt(unsigned char* base, int buf, int cols)
      : ab(reinterpret_cast<double2*>(base) + (size_t)buf * (2 * cols + 1)),
        sd(ab + cols + 1) {}
  __device__ __forceinline__ void put(int j, float va, float vb) const {
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

// sym2x2's sums for one column (its pair's other column lies in another
// image): v points at the staged column r to the left of it; the same
// order of operations.
__device__ __forceinline__ void sym1x2(const StreamTaps<double>& tp, const double2* v,
                                       double2& o) {
  constexpr int r = kStreamR;
  {
    const double t = tp.t[0];
    o.x = t * (v[0].x + v[2 * r].x);
    o.y = t * (v[0].y + v[2 * r].y);
  }
#pragma unroll
  for (int d = r - 1; d >= 1; --d) {
    const double t = tp.t[r - d];
    o.x += t * (v[r - d].x + v[r + d].x);
    o.y += t * (v[r - d].y + v[r + d].y);
  }
  const double tc = tp.t[r];
  o.x = o.x + tc * v[r].x;
  o.y = o.y + tc * v[r].y;
}

// partials: (B, 2) [sum(ssim - 1), H*W], f32 in kBatch and f64 in
// kBatchPrecise, written where pieces is NULL (each image within one strip,
// S >= H); else pieces: (B, nseg, nps) f64, each block's sum of each image
// it meets in slot [image][segment][strip - the image's first strip]. k:
// images a packed row; S: output rows a block takes; nstrip, nseg: strips
// of a packed row, segments of H. Block order: strips fastest, then
// segments, then packed rows. kSplit > 0: the relaxed kBatch (kSplit =
// kStreamSplit at kStreamR; the relaxed main-path stream's steps, below).
// kR: the window's radius, kStreamR (the window in registers, the push loop
// unrolled by 2r + 1), or 0: the radius tp.r, 1 to kMaxStreamR, read at run
// time, with the relaxed kBatch's kSplit = band_mma::ksteps(r): the staged
// rows and the window in dynamic shared memory (batch_rt_layout), the
// window a ring of 2r + 1 pushes of all four signals (relaxed: mu_a, mu_b
// from the f32 pass and the heavy blurs copied from the rows' band
// products), one push a loop iteration, each thread blurring its own
// column (kBatchPrecise too), the taps in shared memory, up to four
// sweeps of relaxed lines; the same operations in the same order.
template <typename T, int kMode, int kSplit = 0, int kR = kStreamR>
__global__ void __launch_bounds__(kStreamThreads, kBatchBlocksOf<kMode, kSplit>)
ssim_fwd_batch_stream_kernel(const T* __restrict__ a, const T* __restrict__ b,
                             Blur<kMode>* __restrict__ partials,
                             double* __restrict__ pieces, int B, int H, int W, int k,
                             int S, int nstrip, int nseg, int nps,
                             StreamTaps<Blur<kMode>, kR> tp, Blur<kMode> c1, Blur<kMode> c2,
                             float clip_bound) {
  using P = Blur<kMode>;
  constexpr bool kRt = kR == 0;  // the runtime radius
  const auto r = stream_radius(tp);  // StreamRadius<kR> where kR > 0
  constexpr int kP = kRt ? 1 : 2 * kR + 1;  // window rows = steps unrolled
  constexpr int kNT = kStreamThreads;
  constexpr int kLoads =
      ((kRt ? kStripW + 2 * kMaxStreamR * kBatchPieces : kBatchInW) + kNT - 1) / kNT;
  constexpr bool kFloat = sizeof(T) == 4;
  constexpr bool kPrec = kIsPrecise<kMode>;
  constexpr bool kRelaxed = kSplit > 0;
  // Relaxed: mu_a and mu_b in registers, the heavy blurs in a ring.
  constexpr int kRing = kRelaxed || kRt ? 0 : kBatchRingOf<kMode>;
  constexpr int kRegS = kRelaxed ? 2 : 4 - kRing;
  // Relaxed: rows staged ahead of the push that blurs them, as the main stream.
  constexpr int kLead = 3;
  // The line tables' lines (two sweeps of 8 at kStreamR, four at a runtime r).
  constexpr int kLines = kRt ? kBatchRtLines : 16;
  static_assert(kMode == kBatch || kMode == kBatchPrecise, "the batch modes");
  static_assert(!kRelaxed || (kMode == kBatch && (kR == kStreamR ? kSplit == kStreamSplit
                                                                 : kRt && (kSplit == 2 ||
                                                                           kSplit == 3))),
                "relaxed: kBatch, the band's k-steps at kStreamR or ksteps(r) at a runtime r");

  __shared__ StagedRow<P, kRelaxed || kRt ? 1 : kBatchInW> s_in[2];  // staged rows, by parity
  // Each column's sum over the block's rows (kBatch adds its f32 runs
  // here), then the segmented warp sums.
  __shared__ double s_sum[kNT];
  // Bit p: piece p holds a non-finite pixel.
  __shared__ unsigned s_bad;
  __shared__ P s_ring[kRing > 0 ? kRing * kP * kNT : 1];
  // Relaxed: staged row u (the u-th image row the block stages) in slot u
  // mod kStreamStaged of s_ab, {a, b} per staged column; then the ring
  // s_hres, the heavy blurs of (a+b)^2, then of (a-b)^2, of push q in slot
  // q mod kStreamRing, kStripW strip columns (ring_col) a slot; the band's
  // fragments; the taps; each line's first staged column (s_lofs) and each
  // line output's strip column (s_dst, -1 for none). With kRt s_ab and
  // s_hres are in dynamic shared memory (batch_rt_layout), s_hres push q's
  // in slot q mod kStreamRtHres.
  constexpr int kAbFloats = 2 * kStreamStaged * kBatchAbW;
  constexpr int kRingFloats = 2 * kStreamRing * kStripW;
  __shared__ __align__(16) float s_rel[kRelaxed && !kRt ? kAbFloats + kRingFloats : 1];
  [[maybe_unused]] float2* s_ab = reinterpret_cast<float2*>(s_rel);
  [[maybe_unused]] float* s_hres = s_rel + kAbFloats;
  __shared__ uint4 s_band[kRelaxed ? 2 * kSplit * 32 : 1];
  __shared__ float s_taps[kRelaxed && !kRt ? kP : 1];
  __shared__ int s_lofs[kRelaxed ? kLines : 1];
  __shared__ signed char s_dst[kRelaxed ? kLines * 16 : 1];
  // kRt: the taps; the dynamic shared memory's staged rows (rt_in) and the
  // window's ring, this thread's column of slot q at rt_ring[q kNT + tid].
  __shared__ P s_rtaps[kRt ? kMaxTaps : 1];
  [[maybe_unused]] unsigned char* rt_in = nullptr;
  [[maybe_unused]] unsigned char* rt_ring = nullptr;
  [[maybe_unused]] int rt_cols = 0;
  [[maybe_unused]] int ab_w = kBatchAbW;  // s_ab's row pitch
  if constexpr (kRt) {
    extern __shared__ __align__(16) unsigned char fwd_stream_smem[];
    const BatchRtLayout lay = batch_rt_layout<P, kSplit>(r, W, k);
    rt_in = fwd_stream_smem;
    rt_ring = fwd_stream_smem + lay.ring;
    rt_cols = lay.cols;
    if constexpr (kRelaxed) {
      s_ab = reinterpret_cast<float2*>(fwd_stream_smem);
      s_hres = reinterpret_cast<float*>(fwd_stream_smem + (size_t)8 * kStreamStaged * lay.pitch);
      ab_w = lay.pitch;
    }
  }

  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  const int strip = blk % nstrip;
  blk /= nstrip;
  const int seg = blk % nseg;
  const int g = blk / nseg;  // the packed row
  const int x0 = strip * kStripW;
  // The strip's output columns (the last packed row may hold fewer than k
  // images, and end before this strip).
  const int sw = min(kStripW, min(k, B - g * k) * W - x0);
  if (sw <= 0) return;
  if (tid == 0) s_bad = 0u;
  s_sum[tid] = 0.0;
  if constexpr (kRt) {
    if (tid < 2 * r + 1) s_rtaps[tid] = tp.t[tid];
  }

  const int y0 = seg * S;
  const int vh = min(S, H - y0);   // output rows
  const int npush = vh + 2 * r;    // window pushes
  const int ylo = max(y0 - r, 0);  // the rows staged
  const int yhi = min(y0 + vh - 1 + r, H - 1);
  const int i0 = x0 / W;           // the strip's first image in the packed row
  const int e = x0 - i0 * W;       // and the strip's first column in it
  // Staged columns: the pieces' columns plus r on either side.
  const int nw = sw + 2 * r * ((x0 + sw - 1) / W - i0 + 1);
  const T* const ga = a + (size_t)g * (size_t)k * (size_t)H * (size_t)W;
  const T* const gb = b + (size_t)g * (size_t)k * (size_t)H * (size_t)W;

  // The centre in the staged row of strip column t's window (idle columns:
  // r, inside the row).
  auto centre = [&](int t) { return t < sw ? t + 2 * r * ((t + e) / W) + r : r; };
  // kRt: each thread blurs its own column, kBatchPrecise too (the precise
  // thread pairs keep 2r + 2 staged values in registers, which a runtime
  // radius cannot).
  constexpr bool kPairs = kPrec && !kRt;
  [[maybe_unused]] const int ctr = kPairs ? 0 : centre(tid);
  [[maybe_unused]] const int ce = kPairs ? centre(tid & ~1) : 0;  // the pair's columns
  [[maybe_unused]] const int co = kPairs ? centre(tid | 1) : 0;

  // Relaxed: the lines' tables (strip tiles where each lies in one image,
  // else the staged row's tiles) and their sweeps (one or two of 8 lines;
  // up to four with kRt).
  [[maybe_unused]] int ngroups = 1;
  if constexpr (kRelaxed) {
    const bool aligned = (W & 15) == 0 || nw == sw + 2 * r;
    if constexpr (kRt) {
      ngroups = aligned ? 1 : (nw - 2 * r + 8 * 16 - 1) / (8 * 16);
      // Zeros in the columns no row is staged to, which row_pass reads
      // (times zeros of the band: they must be finite); a row's reads end
      // inside it.
      float* ab = reinterpret_cast<float*>(s_ab);
      for (int i = tid; i < 2 * kStreamStaged * ab_w; i += kNT) ab[i] = 0.0f;
    } else {
      ngroups = aligned || nw - 2 * r <= 8 * 16 ? 1 : 2;
      for (int i = tid; i < kAbFloats + kRingFloats; i += kNT) s_rel[i] = 0.0f;
    }
    if (tid < kLines) s_lofs[tid] = aligned ? (tid < 8 ? centre(16 * tid) - r : 0) : 16 * tid;
    for (int o = tid; o < kLines * 16; o += kNT) {
      int c = -1;
      if (aligned) {
        if (o < sw) c = o;
      } else {
        // Output o of the staged row: the blur centred on staged column
        // o + r, strip column o - 2 r p of piece p if that is an image column.
        const int jp = o + r + e, p = jp / (W + 2 * r), col = jp - p * (W + 2 * r) - r;
        const int t = o - 2 * r * p;
        if (o + 2 * r < nw && col >= 0 && col < W && t >= 0 && t < sw) c = t;
      }
      s_dst[o] = (signed char)c;
    }
    if constexpr (!kRt) {
      if (tid == 0) {
#pragma unroll
        for (int q = 0; q < kP; ++q) s_taps[q] = tp.t[q];
      }
    }
  }
  // Before the prologue's staging, which may mark pieces in s_bad.
  __syncthreads();
  if constexpr (kRelaxed) {
    if (tid < 32) {
      const float* taps = s_taps;
      if constexpr (kRt) taps = s_rtaps;
      const band_mma::Band<kSplit> bd = band_mma::make_band<kSplit>(taps, r);
#pragma unroll
      for (int ks = 0; ks < kSplit; ++ks) {
        s_band[ks * 32 + tid] = make_uint4(bd.hi[ks][0], bd.hi[ks][1], bd.hi[ks][2],
                                           bd.hi[ks][3]);
        s_band[(kSplit + ks) * 32 + tid] = make_uint4(bd.lo[ks][0], bd.lo[ks][1],
                                                      bd.lo[ks][2], bd.lo[ks][3]);
      }
    }
  }

  // Staged column tid + q kNT: the offset of its source in the packed row's
  // images at row 0 (its image's column, clamped).
  int soff[kLoads];
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int jp = tid + q * kNT + e;
    const int p = jp / (W + 2 * r);
    const int col = min(max(jp - p * (W + 2 * r) - r, 0), W - 1);
    soff[q] = i0 + p < k ? (i0 + p) * H * W + col : 0;
  }
  T pa[kLoads], pb[kLoads];
  auto fetch = [&](int y) {
    const size_t o = (size_t)y * (size_t)W;
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      if (tid + q * kNT < nw) {
        pa[q] = __ldg(ga + o + soff[q]);
        pb[q] = __ldg(gb + o + soff[q]);
      }
    }
  };
  // Into s_in[buf] (relaxed: s_ab's slot buf; kRt: the dynamic staged row buf).
  auto stage = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int j = tid + q * kNT;
      if (j < nw) {
        float va = to_f32(pa[q]);
        float vb = to_f32(pb[q]);
        if (kFloat) {
          if (!(finite_f32(va) && finite_f32(vb))) {
            atomicOr(&s_bad, 1u << ((j + e) / (W + 2 * r)));  // rare path
          }
          va = sanitize(va, clip_bound);
          vb = sanitize(vb, clip_bound);
        }
        if constexpr (kRelaxed) {
          s_ab[buf * ab_w + j] = make_float2(va, vb);
        } else if constexpr (kRt) {
          StagedRowAt<P>(rt_in, buf, rt_cols).put(j, va, vb);
        } else {
          s_in[buf].put(j, va, vb);
        }
      }
    }
  };

  P win[kRegS > 0 && !kRt ? kRegS : 1][kP];
  auto win_put = [&](int p, int kk, P v) {
    if (p >= kRegS) {
      s_ring[(kk * kRing + (p - kRegS)) * kNT + tid] = v;
    } else {
      win[p][kk] = v;
    }
  };
  auto win_get = [&](int p, int kk) -> P {
    return p >= kRegS ? s_ring[(kk * kRing + (p - kRegS)) * kNT + tid] : win[p][kk];
  };
  // kRt: push q in the ring's slot q mod 2r + 1; rt_slot the current push's.
  [[maybe_unused]] const int rt_rows = 2 * r + 1;
  [[maybe_unused]] int rt_slot = 0;
  auto rt_put = [&](int q, const P (&h)[4]) {
    if constexpr (sizeof(P) == 4) {
      reinterpret_cast<float4*>(rt_ring)[q * kNT + tid] = make_float4(h[0], h[1], h[2], h[3]);
    } else {
      double2* v = reinterpret_cast<double2*>(rt_ring) + 2 * q * kNT + tid;
      v[0] = make_double2(h[0], h[1]);
      v[kNT] = make_double2(h[2], h[3]);
    }
  };
  auto rt_get = [&](int q) -> Vec4<P> {
    if constexpr (sizeof(P) == 4) {
      const float4 v = reinterpret_cast<const float4*>(rt_ring)[q * kNT + tid];
      return {v.x, v.y, v.z, v.w};
    } else {
      const double2* v = reinterpret_cast<const double2*>(rt_ring) + 2 * q * kNT + tid;
      const double2 u = v[0], w = v[kNT];
      return {u.x, u.y, w.x, w.y};
    }
  };
  // kRt: the push before's four signals again (a clamped row above row 0
  // or below row H - 1).
  auto rt_repeat = [&]() {
    const Vec4<P> v = rt_get(rt_slot == 0 ? rt_rows - 1 : rt_slot - 1);
    const P h[4] = {v.x, v.y, v.z, v.w};
    rt_put(rt_slot, h);
  };
  // kRt: step (c)'s vertical blur from the ring into m (P[4]): the centre
  // push (age r) in slot c0, push j - r + i in slot c0 + i mod 2r + 1. A
  // generic lambda, so that only the kRt instantiations compile its body.
  auto rt_vblur = [&](auto& m) {
    const int c0 = rt_slot >= r ? rt_slot - r : rt_slot - r + rt_rows;
    sym4(
        r, [&](int i) { return s_rtaps[i]; },
        [&](int i) {
          int sl = c0 + i;
          sl += sl < 0 ? rt_rows : 0;
          sl -= sl >= rt_rows ? rt_rows : 0;
          return rt_get(sl);
        },
        m);
  };

  const bool col_on = tid < sw;  // this column is one of the images'
  [[maybe_unused]] float acc = 0.0f;    // kBatch: the column's f32 run
  [[maybe_unused]] double dacc = 0.0;  // kBatchPrecise: the column's sum
  // cy: the next image row to stage, loaded while cy <= yhi.
  int cy = ylo;

  if constexpr (kRelaxed) {
    // Push q is stream row q of the main stream: image row y0 - r + q,
    // clamped; its staged row u(q) = that row - ylo, in slot u(q) mod
    // kStreamStaged. A push that repeats the row before it (the clamped rows
    // above row 0 and below row H - 1) copies that push's blurs, this
    // thread's column (window registers and ring); the others are staged 3
    // pushes ahead and their heavy blurs made every other push for the
    // next two, as the main stream's rows, one barrier a push.
    auto blurred = [&](int q) {
      const int vy = y0 - r + q;
      return q == 0 || (vy >= 1 && vy <= H - 1);
    };
    auto slot = [&](int q) {
      return (min(max(y0 - r + q, 0), H - 1) - ylo) & (kStreamStaged - 1);
    };
    // Rows staged so far (the next one's slot); the staged rows of pushes
    // 0 .. kLead - 1.
    int ns = 0;
    fetch(cy);
    for (int q = 0; q < kLead && q < npush; ++q) {
      if (blurred(q)) {
        stage(ns++ & (kStreamStaged - 1));
        if (++cy <= yhi) fetch(cy);
      }
    }
    __syncthreads();
    if constexpr (kRt) {
      // Push 0's heavy blurs into s_hres's slot 0: warp w plane w % 2,
      // sweeps w / 2, w / 2 + 2.
      const int w = tid >> 5;
      for (int grp = w >> 1; grp < ngroups; grp += 2) {
        const int* lofs = s_lofs + 8 * grp;
        const signed char* dst = s_dst + 128 * grp;
        row_pass<kSplit>(
            s_ab, s_hres + (w & 1) * kStreamRtHres * kStripW, w & 1, s_band,
            [&](int l) { return lofs[l]; }, [&](int o) { return (int)dst[o]; });
      }
    } else {
      // Push 0's heavy blurs: warp w plane w % 2, lines of sweep w / 2.
      const int w = tid >> 5;
      if ((w >> 1) < ngroups) {
        const int* lofs = s_lofs + 8 * (w >> 1);
        const signed char* dst = s_dst + 128 * (w >> 1);
        row_pass<kSplit>(
            s_ab, s_hres + (w & 1) * kStreamRing * kStripW, w & 1, s_band,
            [&](int l) { return lofs[l]; }, [&](int o) { return (int)dst[o]; });
      }
    }
    __syncthreads();

    for (int s0 = 0; s0 < npush; s0 += kP) {
      // The ring's slots of pushes s0 + d, d >= 0 in hr0 + d, d < 0 in
      // hr1 + d (kStripW floats a slot, this thread's column).
      const int par = (s0 / kP) & 1;
      float* const hr0 = s_hres + (par ? kP : 0) * kStripW + ring_col(tid);
      float* const hr1 = s_hres + (par ? kP : 2 * kP) * kStripW + ring_col(tid);
#pragma unroll
      for (int kk = 0; kk < kP; ++kk) {
        const int j = s0 + kk;
        if (j < npush) {
          // Even pushes: pushes j + 1 and j + 2's heavy blurs where they are
          // blurred, push j + 1 + w / 2's plane w % 2 by warp w, each
          // sweep of its lines; both rows were staged before the last barrier.
          if ((j & 1) == 0) {
            const int w = tid >> 5;
            const int q = j + 1 + (w >> 1), plane = w & 1;
            if (q < npush && blurred(q)) {
              // kRt: push q's slot of s_hres, q mod kStreamRtHres (pushes
              // j + 1 and j + 2 written while push j reads its own).
              float* out = s_hres + (plane * (kRt ? kStreamRtHres : kStreamRing) +
                                     (kRt ? q & (kStreamRtHres - 1) : q % kStreamRing)) *
                                        kStripW;
              // A row's reads end inside it (ab_w: kBatchAbW, or
              // batch_rt_layout's pitch), so none meets a row staged now.
              const float2* row = s_ab + slot(q) * ab_w;
              for (int grp = 0; grp < ngroups; ++grp) {
                const int* lofs = s_lofs + 8 * grp;
                const signed char* dst = s_dst + 128 * grp;
                row_pass<kSplit>(
                    row, out, plane, s_band, [&](int l) { return lofs[l]; },
                    [&](int o) { return (int)dst[o]; });
              }
            }
          }

          // (b) mu_a, mu_b of push j into the window's slot kk (the heavy
          // blurs are in the ring), or push j - 1's copied; kRt: all four
          // signals into the ring's slot, the heavy blurs from s_hres.
          if (col_on) {
            if constexpr (kRt) {
              if (blurred(j)) {
                float mu[2];
                sym2(
                    r, [&](int i) { return s_rtaps[i]; }, s_ab + slot(j) * ab_w + ctr, mu);
                const float* hh =
                    s_hres + (j & (kStreamRtHres - 1)) * kStripW + ring_col(tid);
                const P h[4] = {mu[0], mu[1], hh[0], hh[kStreamRtHres * kStripW]};
                rt_put(rt_slot, h);
              } else {
                rt_repeat();
              }
            } else if (blurred(j)) {
              float h[2];
              sym2(tp, s_ab + slot(j) * kBatchAbW + ctr, h);
              win_put(0, kk, h[0]);
              win_put(1, kk, h[1]);
            } else {
              const int pk = (kk + kP - 1) % kP;
              win_put(0, kk, win_get(0, pk));
              win_put(1, kk, win_get(1, pk));
              const float* prev = kk >= 1 ? hr0 + (kk - 1) * kStripW : hr1 - kStripW;
              hr0[kk * kStripW] = prev[0];
              hr0[kk * kStripW + kStreamRing * kStripW] = prev[kStreamRing * kStripW];
            }
          }

          // (c) Output row y0 + j - 2r from pushes j - 2r .. j.
          if (j >= 2 * r) {
            if (col_on) {
              float m[4];
              if constexpr (kRt) {
                rt_vblur(m);
              } else {
                sym4(tp,
                     [&](int i) {
                       const int sl = (kk - r + i + 2 * kP) % kP;
                       const int d = kk - r + i;  // push s0 + d
                       const float* h = (d >= 0 ? hr0 : hr1) + d * kStripW;
                       return Vec4<float>{win_get(0, sl), win_get(1, sl), h[0],
                                          h[kStreamRing * kStripW]};
                     },
                     m);
              }
              acc += ssim_of(m, c1, c2) - 1.0f;
            }
            if (((j - 2 * r) & (kBatchRun - 1)) == kBatchRun - 1) {
              if (col_on) s_sum[tid] += (double)acc;
              acc = 0.0f;
            }
          }

          // (d) Push j + kLead's row staged where it is a new one, from the
          // registers loaded one staging before, and the next row loaded.
          if (j + kLead < npush && blurred(j + kLead)) {
            stage(ns++ & (kStreamStaged - 1));
            if (++cy <= yhi) fetch(cy);
          }
          __syncthreads();
          if constexpr (kRt) rt_slot = rt_slot + 1 == rt_rows ? 0 : rt_slot + 1;
        }
      }
    }
  } else {
    fetch(cy);
    stage(0);
    if (++cy <= yhi) fetch(cy);
    __syncthreads();

    int nb = 0;  // rows blurred
    for (int s0 = 0; s0 < npush; s0 += kP) {
#pragma unroll
      for (int kk = 0; kk < kP; ++kk) {
        const int j = s0 + kk;
        if (j < npush) {
          // Push j: image row clamp(y0 - r + j, 0, H - 1), blurred where it
          // differs from push j - 1's, else push j - 1's blur again.
          const int vy = y0 - r + j;
          const bool blur = j == 0 || (vy >= 1 && vy <= H - 1);

          // (b) The horizontal blur of the staged row into the window's slot kk
          // (kRt: the ring's slot rt_slot).
          if constexpr (kRt) {
            if (col_on) {
              if (blur) {
                const StagedRowAt<P> row(rt_in, nb & 1, rt_cols);
                P h[4];
                sym4(
                    r, [&](int i) { return s_rtaps[i]; },
                    [&](int i) { return row.get(ctr + i); }, h);
                rt_put(rt_slot, h);
              } else {
                rt_repeat();
              }
            }
            if (blur) ++nb;
          } else if (blur) {
            const StagedRow<P, kBatchInW>& row = s_in[nb & 1];
            if constexpr (kPrec) {
              // The thread pairs of the precise stream; a pair whose two
              // columns lie in two images blurs each from its own window.
              const bool odd = tid & 1;
              const double2* pl = odd ? row.sd : row.ab;
              double2 o0, o1;
              if (co == ce + 1) {
                sym2x2(tp, pl + ce - r, o0, o1);
              } else {
                sym1x2(tp, pl + ce - r, o0);
                sym1x2(tp, pl + co - r, o1);
              }
              const double2 give = odd ? o0 : o1;
              const double2 got = make_double2(__shfl_xor_sync(0xffffffffu, give.x, 1),
                                               __shfl_xor_sync(0xffffffffu, give.y, 1));
              const double2 ab = odd ? got : o0, sd = odd ? o1 : got;
              if (col_on) {
                win_put(0, kk, ab.x);
                win_put(1, kk, ab.y);
                win_put(2, kk, sd.x);
                win_put(3, kk, sd.y);
              }
            } else if (col_on) {
              P h[4];
              sym4(tp, [&](int i) { return row.get(ctr + i); }, h);
#pragma unroll
              for (int p = 0; p < 4; ++p) win_put(p, kk, h[p]);
            }
            ++nb;
          } else if (col_on) {
            // A clamped row above row 0 or below row H - 1.
#pragma unroll
            for (int p = 0; p < 4; ++p) win_put(p, kk, win_get(p, (kk + kP - 1) % kP));
          }

          // (c) Output row y0 + j - 2r from pushes j - 2r .. j.
          if (j >= 2 * r) {
            if (col_on) {
              P m[4];
              if constexpr (kRt) {
                rt_vblur(m);
              } else {
                sym4(tp,
                     [&](int i) {
                       const int sl = (kk - r + i + 2 * kP) % kP;
                       return Vec4<P>{win_get(0, sl), win_get(1, sl), win_get(2, sl),
                                      win_get(3, sl)};
                     },
                     m);
              }
              const P v = ssim_of(m, c1, c2);
              if constexpr (kPrec) {
                dacc += v - 1.0;
              } else {
                acc += v - 1.0f;
              }
            }
            if constexpr (!kPrec) {
              if (((j - 2 * r) & (kBatchRun - 1)) == kBatchRun - 1) {
                if (col_on) s_sum[tid] += (double)acc;
                acc = 0.0f;
              }
            }
          }

          // (d) The next row staged from the registers loaded at the last
          // blur, and the row after it loaded.
          if (blur) {
            if (cy <= yhi) {
              stage(nb & 1);
              if (++cy <= yhi) fetch(cy);
            }
            __syncthreads();
          }
          if constexpr (kRt) rt_slot = rt_slot + 1 == rt_rows ? 0 : rt_slot + 1;
        }
      }
    }
  }

  // The columns' sums complete in s_sum, then a segmented warp reduction
  // (lane l ends with the sum of its piece's lanes from l on in its warp),
  // then in the thread of each piece's first column the piece's warps in
  // order, NaN where s_bad marks the piece.
  if (col_on) {
    if constexpr (kPrec) {
      s_sum[tid] = dacc;
    } else {
      s_sum[tid] += (double)acc;
    }
  }
  const int pc = (tid + e) / W;  // this column's piece: image i0 + pc
  const int pfirst = max(0, pc * W - e);
  const int pe = min((pc + 1) * W - e, sw);
  const int lane = tid & 31;
  const int lim = min(pe, (tid & ~31) + 32) - (tid & ~31);
  double w = s_sum[tid];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_down_sync(0xffffffffu, w, off);
    if (lane + off < lim) w += o;
  }
  s_sum[tid] = w;
  __syncthreads();
  if (tid < sw && tid == pfirst) {
    double sum = s_sum[tid];
    for (int wi = (tid >> 5) + 1; wi <= (pe - 1) >> 5; ++wi) sum += s_sum[wi * 32];
    if ((s_bad >> pc) & 1u) sum = (double)__int_as_float(0x7fc00000);
    const size_t img = (size_t)g * (size_t)k + (size_t)(i0 + pc);
    if (pieces == nullptr) {
      partials[2 * img] = (P)sum;
      partials[2 * img + 1] = (P)((double)H * (double)W);
    } else {
      pieces[(img * (size_t)nseg + (size_t)seg) * (size_t)nps +
             (size_t)(strip - (i0 + pc) * W / kStripW)] = sum;
    }
  }
}

// The batch stream's second pass where an image's rows or columns were
// split over blocks: each image's pieces (B, nseg, nps) added in order,
// segments outer and strips inner, in double, then its partial pair
// [sum(ssim - 1), n]. One thread per image.
template <typename Out>
__global__ void batch_pieces_reduce_kernel(const double* __restrict__ pieces,
                                           Out* __restrict__ partials, int B, int W, int k,
                                           int nseg, int nps, double n) {
  const int img = blockIdx.x * blockDim.x + threadIdx.x;
  if (img >= B) return;
  const int i = img % k;  // its place in its packed row
  const int ns = ((i + 1) * W - 1) / kStripW - i * W / kStripW + 1;  // strips it meets
  const double* p = pieces + (size_t)img * nseg * nps;
  double s = 0.0;
  for (int sg = 0; sg < nseg; ++sg) {
    for (int t = 0; t < ns; ++t) s += p[(size_t)sg * nps + t];
  }
  partials[2 * (size_t)img] = (Out)s;
  partials[2 * (size_t)img + 1] = (Out)n;
}

}  // namespace
