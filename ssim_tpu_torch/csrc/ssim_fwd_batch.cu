// The batch modes' packed row stream: kBatch (standard and relaxed) and
// kBatchPrecise at radius kStreamR (ssim_cuda.stream_applies; other radii
// run the tile body in ssim_fwd.cu).
//
// They run the row stream's steps (b)-(d) (fwd_stream.cuh) over batches of
// small images. Images lie k to a packed row, side by side
// (ssim_cuda.batch_pack: where W >= 12 is a multiple of 8, the smallest k
// whose row k W is a multiple of kStripW, as the TPU's bpack_count packs
// lanes; other widths floor(kStripW / W), at most 12, or 1); the packed
// rows are cut into strips of kStripW output columns, one thread each, so a
// strip may hold parts of several images and an image may span two or more
// strips. Each image's piece of a strip is staged with its own r clamped
// columns on each side (kBatchInW columns at most), so no pixel of one image
// enters another's horizontal blur, and nothing is padded in device memory.
// A block takes one strip of one packed row, down all its rows or, where
// the packed rows alone would leave the card idle, down a segment of S
// rows. The window starts at the images' top: the r clamped rows above row
// 0 are row 0's horizontal blur pushed again (the window's last slot
// copied), not staged or blurred again, and so the r rows below row H - 1;
// so a packed row costs H staged rows and H barriers. Each thread sums its
// column's ssim - 1 (kBatch: in f32 over at most kBatchRun rows, then into
// a double; kBatchPrecise in double); at the end a segmented warp reduction
// (each lane adds the lanes of its own piece, shuffles down by 1 .. 16) and
// then, in the thread of each piece's first column, the piece's warps in
// order form the block's sum of each image it meets. Where a block holds an
// image's every row and column, that thread writes the image's pair; else
// it writes its piece to a (B, nseg, nps) f64 array that
// batch_pieces_reduce_kernel adds in order. A non-finite pixel staged for
// an image (every staged pixel is one of its image's own, clamped or not)
// marks its image's piece, and the image's sum is NaN. No atomics on the
// sums: they are deterministic. Each pixel's SSIM is the tile modes' (and
// the twin's) bit for bit; only the order of the sums differs. What bounds
// it: the main-path stream's step (issue and one barrier a row), at strips
// filled by whole images (W = 32, 64, 128, 192), plus 11 shared-memory
// loads a step for the ring.
//
// The relaxed kBatch (kSplit = kStreamSplit; K1h's relaxed tier on the
// batch route, ssim_pallas.py:2284-2291) runs the relaxed main-path
// stream's steps over the same packed rows: mu_a and mu_b by the f32
// symmetric pass of the staged {a, b} row, the heavy blurs of (a+b)^2 and
// (a-b)^2 as bf16x3 band products (band_mma.cuh) made every other push for
// the next two, into a ring of blurred rows addressed by push, rows staged
// three pushes ahead. A band product's line is 16 consecutive outputs from
// 16 + 2r consecutive staged columns, and a tile of 16 strip columns that
// holds two images has no such run of columns: where W is a multiple of 16
// (32, 64, 128, 192, ...) or a strip meets one image, no tile straddles, and
// the 8 lines are the strip's tiles, each read from its piece's staged
// columns; elsewhere (68 of the routed widths up to 192: 24, 40, 56, ...
// and the narrow ones packed 2 to 12 a strip) the lines are the staged
// row's own tiles (up to kBatchLines, two sweeps of 8) and each column's
// blur is the output at its staged centre (s_dst maps outputs to columns;
// outputs between pieces are dropped), so no pixel of one image enters
// another's blur. Measured on an H100, the staged lines at the aligned
// widths took 1.09-1.17x the strip's; at widths that take them (12, 24,
// 40, 50, 60, 120, 184) the stream took 0.45-0.84x the relaxed tile body
// (PERF.md). A push that repeats the row before it (the clamped rows above
// row 0 and below row H - 1) copies that push's blurs, its own column of the
// ring and its window registers; every push ends with a barrier. 34.2 KB of
// shared memory, 6 blocks per SM. What bounds it: the relaxed stream's step
// (the mma a warp issues in a step hold its block at the barrier).

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
// The relaxed kBatch (kSplit = kStreamSplit): 34.2 KB of shared memory
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
// columns a row: the last line starts at most at column 16 (kBatchLines -
// 1) and reads kStreamSplit k-steps of 16; the columns past a row's staged
// ones stay zero (finite, times the band's zeros).
constexpr int kBatchLines = (kBatchInW - 2 * kStreamR + 15) / 16;
constexpr int kBatchAbW = 16 * (kBatchLines - 1 + kStreamSplit);
static_assert(kBatchLines <= 16, "two sweeps of 8 lines");

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
// kStreamSplit; the relaxed main-path stream's steps, below).
template <typename T, int kMode, int kSplit = 0>
__global__ void __launch_bounds__(kStreamThreads, kBatchBlocksOf<kMode, kSplit>)
ssim_fwd_batch_stream_kernel(const T* __restrict__ a, const T* __restrict__ b,
                             Blur<kMode>* __restrict__ partials,
                             double* __restrict__ pieces, int B, int H, int W, int k,
                             int S, int nstrip, int nseg, int nps,
                             StreamTaps<Blur<kMode>> tp, Blur<kMode> c1, Blur<kMode> c2,
                             float clip_bound) {
  using P = Blur<kMode>;
  constexpr int r = kStreamR;
  constexpr int kP = 2 * r + 1;  // window rows = steps unrolled
  constexpr int kNT = kStreamThreads;
  constexpr int kLoads = (kBatchInW + kNT - 1) / kNT;
  constexpr bool kFloat = sizeof(T) == 4;
  constexpr bool kPrec = kIsPrecise<kMode>;
  constexpr bool kRelaxed = kSplit > 0;
  // Relaxed: mu_a and mu_b in registers, the heavy blurs in a ring.
  constexpr int kRing = kRelaxed ? 0 : kBatchRingOf<kMode>;
  constexpr int kRegS = kRelaxed ? 2 : 4 - kRing;
  // Relaxed: rows staged ahead of the push that blurs them, as the main stream.
  constexpr int kLead = 3;
  static_assert(kMode == kBatch || kMode == kBatchPrecise, "the batch modes");
  static_assert(!kRelaxed || (kMode == kBatch && kSplit == kStreamSplit),
                "relaxed: kBatch, the band's k-steps at kStreamR");

  __shared__ StagedRow<P, kRelaxed ? 1 : kBatchInW> s_in[2];  // staged rows, by parity
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
  // line output's strip column (s_dst, -1 for none).
  constexpr int kAbFloats = 2 * kStreamStaged * kBatchAbW;
  constexpr int kRingFloats = 2 * kStreamRing * kStripW;
  __shared__ __align__(16) float s_rel[kRelaxed ? kAbFloats + kRingFloats : 1];
  [[maybe_unused]] float2* s_ab = reinterpret_cast<float2*>(s_rel);
  [[maybe_unused]] float* s_hres = s_rel + kAbFloats;
  __shared__ uint4 s_band[kRelaxed ? 2 * kSplit * 32 : 1];
  __shared__ float s_taps[kRelaxed ? kP : 1];
  __shared__ int s_lofs[kRelaxed ? 16 : 1];
  __shared__ signed char s_dst[kRelaxed ? 16 * 16 : 1];

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
  [[maybe_unused]] const int ctr = kPrec ? 0 : centre(tid);
  [[maybe_unused]] const int ce = kPrec ? centre(tid & ~1) : 0;  // the pair's columns
  [[maybe_unused]] const int co = kPrec ? centre(tid | 1) : 0;

  // Relaxed: the lines' tables (strip tiles where each lies in one image,
  // else the staged row's tiles) and their sweeps (one or two of 8 lines).
  [[maybe_unused]] int ngroups = 1;
  if constexpr (kRelaxed) {
    const bool aligned = (W & 15) == 0 || nw == sw + 2 * r;
    ngroups = aligned || nw - 2 * r <= 8 * 16 ? 1 : 2;
    for (int i = tid; i < kAbFloats + kRingFloats; i += kNT) s_rel[i] = 0.0f;
    if (tid < 16) s_lofs[tid] = aligned ? (tid < 8 ? centre(16 * tid) - r : 0) : 16 * tid;
    for (int o = tid; o < 16 * 16; o += kNT) {
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
    if (tid == 0) {
#pragma unroll
      for (int q = 0; q < kP; ++q) s_taps[q] = tp.t[q];
    }
  }
  // Before the prologue's staging, which may mark pieces in s_bad.
  __syncthreads();
  if constexpr (kRelaxed) {
    if (tid < 32) {
      const band_mma::Band<kSplit> bd = band_mma::make_band<kSplit>(s_taps, r);
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
  // Into s_in[buf] (relaxed: s_ab's slot buf).
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
          s_ab[buf * kBatchAbW + j] = make_float2(va, vb);
        } else {
          s_in[buf].put(j, va, vb);
        }
      }
    }
  };

  P win[kRegS > 0 ? kRegS : 1][kP];
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
    {
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
              float* out = s_hres + (plane * kStreamRing + q % kStreamRing) * kStripW;
              const float2* row = s_ab + slot(q) * kBatchAbW;
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
          // blurs are in the ring), or push j - 1's copied.
          if (col_on) {
            if (blurred(j)) {
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
              sym4(tp,
                   [&](int i) {
                     const int sl = (kk - r + i + 2 * kP) % kP;
                     const int d = kk - r + i;  // push s0 + d
                     const float* h = (d >= 0 ? hr0 : hr1) + d * kStripW;
                     return Vec4<float>{win_get(0, sl), win_get(1, sl), h[0],
                                        h[kStreamRing * kStripW]};
                   },
                   m);
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

          // (b) The horizontal blur of the staged row into the window's slot kk.
          if (blur) {
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
              sym4(tp,
                   [&](int i) {
                     const int sl = (kk - r + i + 2 * kP) % kP;
                     return Vec4<P>{win_get(0, sl), win_get(1, sl), win_get(2, sl),
                                    win_get(3, sl)};
                   },
                   m);
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

template <typename T, int kMode, int kSplit>
cudaError_t launch_batch_stream(const void* a, const void* b, void* partials, void* pieces,
                                int B, int H, int W, int k, int S,
                                const double* taps_host, double c1, double c2,
                                float clip_bound, cudaStream_t stream) {
  using P = Blur<kMode>;
  StreamTaps<P> tp;
  for (int i = 0; i < 2 * kStreamR + 1; ++i) tp.t[i] = (P)taps_host[i];
  const int nstrip = (k * W + kStripW - 1) / kStripW;
  const int nseg = (H + S - 1) / S;
  const int nps = (W + kStripW - 1) / kStripW + 1;
  const long long blocks = (long long)nstrip * nseg * ((B + k - 1) / k);
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  ssim_fwd_batch_stream_kernel<T, kMode, kSplit>
      <<<(unsigned)blocks, kStreamThreads, 0, stream>>>(
          static_cast<const T*>(a), static_cast<const T*>(b), static_cast<P*>(partials),
          static_cast<double*>(pieces), B, H, W, k, S, nstrip, nseg, nps, tp, (P)c1, (P)c2,
          clip_bound);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || pieces == nullptr) return err;
  batch_pieces_reduce_kernel<P><<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const double*>(pieces), static_cast<P*>(partials), B, W, k, nseg, nps,
      (double)H * (double)W);
  return cudaGetLastError();
}

template <typename T, int kMode, int kSplit>
cudaError_t batch_stream_occupancy(int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ssim_fwd_batch_stream_kernel<T, kMode, kSplit>, kStreamThreads, 0);
}

}  // namespace

// The batch modes' packed row-streaming kernel (radius kStreamR), for
// ctypes: precise 0 (kBatch, f32 partials) or 1 (kBatchPrecise, f64);
// relaxed 1: the relaxed kBatch (precise 0 only), else 0; is_float as in
// ssim_fwd_launch. partials: (B, 2) [sum(ssim - 1), H*W].
// pieces: NULL where each block holds its images' every row and column (S
// >= H, and k W <= 128 or W divides 128), else (B, ceil(H / S),
// ceil(W / 128) + 1) f64 for the second pass. k: images a packed row (1 to
// B; k H W < 2^31; W < 12: k <= 12 and k W <= 128); S: output rows a block
// takes of each image (1 to H). taps_host: 2 kStreamR + 1 doubles; c1, c2,
// clip_bound and stream as in ssim_fwd_launch. Returns the launch's
// cudaError_t.
extern "C" int ssim_fwd_batch_launch(int precise, int relaxed, int is_float, const void* a,
                                     const void* b, void* partials, void* pieces, int B,
                                     int H, int W, int k, int S, const double* taps_host,
                                     double c1, double c2, float clip_bound, void* stream) {
  if (B < 1 || H < 1 || W < 1 || k < 1 || k > B || S < 1 || (precise && relaxed) ||
      (long long)k * H * W > 0x7fffffffLL ||
      (W < 12 && (k > kBatchPieces || k * W > kStripW)) ||
      (pieces == nullptr && (S < H || (k * W > kStripW && kStripW % W != 0)))) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSIM_FWD_BATCH(T, M, K)                                                          \
  launch_batch_stream<T, M, K>(a, b, partials, pieces, B, H, W, k, S, taps_host, c1, c2, \
                               clip_bound, s)
  if (precise) {
    return is_float ? SSIM_FWD_BATCH(float, kBatchPrecise, 0)
                    : SSIM_FWD_BATCH(uint8_t, kBatchPrecise, 0);
  }
  if (relaxed) {
    return is_float ? SSIM_FWD_BATCH(float, kBatch, kStreamSplit)
                    : SSIM_FWD_BATCH(uint8_t, kBatch, kStreamSplit);
  }
  return is_float ? SSIM_FWD_BATCH(float, kBatch, 0) : SSIM_FWD_BATCH(uint8_t, kBatch, 0);
#undef SSIM_FWD_BATCH
}

// Blocks of the batch modes' packed stream that one SM of the current device
// holds at once (precise 0: kBatch, 1: kBatchPrecise; relaxed 1: the relaxed
// kBatch) for uint8 (is_float = 0) or float32 inputs: the CUDA runtime's
// occupancy for the instantiation that ssim_fwd_batch_launch takes. Returns
// a cudaError_t.
extern "C" int ssim_fwd_batch_occupancy(int precise, int relaxed, int is_float,
                                        int* blocks_per_sm) {
  if (precise && relaxed) return cudaErrorInvalidValue;
  if (precise) {
    return is_float ? batch_stream_occupancy<float, kBatchPrecise, 0>(blocks_per_sm)
                    : batch_stream_occupancy<uint8_t, kBatchPrecise, 0>(blocks_per_sm);
  }
  if (relaxed) {
    return is_float ? batch_stream_occupancy<float, kBatch, kStreamSplit>(blocks_per_sm)
                    : batch_stream_occupancy<uint8_t, kBatch, kStreamSplit>(blocks_per_sm);
  }
  return is_float ? batch_stream_occupancy<float, kBatch, 0>(blocks_per_sm)
                  : batch_stream_occupancy<uint8_t, kBatch, 0>(blocks_per_sm);
}
