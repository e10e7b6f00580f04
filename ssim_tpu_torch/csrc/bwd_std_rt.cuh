// The standard backward at a radius read at run time: two row streams
// through device memory. Included by ssim_bwd_rt.cu, a translation unit of
// its own.
//
// What held the one-pass stream back at these radii (ssim_bwd_stream_kernel
// <0, G> before this stream): both vertical windows, the horizontal blurs' and
// the weight maps', were float4 rings of 2r + 1 rows per thread in one
// block's shared memory, 114 KB at radius 8 and 211 KB at 16, so from
// radius 8 an SM held one block of 5 warps, whose chain of rows (one
// barrier each) nothing hid; and every tap indexed the rings by a runtime
// modulo. Here each pass holds one of the two windows, so a block needs
// half the bytes:
//
//  pass A (ssim_bwd_rt_weights_kernel): a block owns kRtMidW columns of the
//    mid grid (the image plus an r margin) and a segment of its rows, one
//    thread a mid column. Each step stages kRtRows input rows (sanitised,
//    their product signals formed, every non-finite value marking the NaN
//    tiles it reaches in a per-tile mask in device memory), blurs each
//    across into the thread's ring of the last 2r + kRtRows rows, blurs the
//    ring down for kRtRows mid rows, forms their weight maps W_u, W_v, W_ss,
//    W_dd (zero by index outside the image) and writes each as one float4
//    to the scratch map (mid grid x 16 bytes);
//  pass B (ssim_bwd_rt_adjoint_kernel): a block owns kStripW output columns
//    and a segment of rows, one thread for each of the strip's kStripW + 2r
//    mid columns. Each step reads kRtRows rows of the map into the thread's
//    ring, takes their vertical adjoints with the clamp fold at rows 0 and
//    H - 1 into shared rows, and, after the barrier, the horizontal adjoints
//    of the previous step's rows with the fold at columns 0 and W - 1, then
//    da / db from a and b read again, NaN over the masked tiles: one writer
//    per output, written once.
//
// Shared memory bounds both passes (per tap pair a window's two float4
// loads, 8 of the SM's 32-bank wavefronts a warp, against 12 f32
// operations), so each step takes two rows: the two vertical windows one
// row apart share their loads (2r + 2 for both, rt_ring_sym4x2), and the
// taps come from the kernel's parameters (__grid_constant__: the constant
// cache) rather than shared memory; measured against one row a step and
// against shared-memory taps on an H100 (PERF.md §6). Both rings advance by
// running slots, and a window's reads walk two pointers inward from its
// oldest and newest rows, each wrapping with a compare: no division on a
// step's path. The order of operations is the plain twin's
// (ops/ssim_grad.py::ssim_grad_plain) and the one-pass stream's: symmetric
// tap pairs, smallest taps first, then the centre tap; the folds between
// the passes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "bwd_common.cuh"

namespace {

// Pass A's block: kRtMidW mid columns, one thread each.
constexpr int kRtMidW = 128;
// Stream rows a step, in both passes.
constexpr int kRtRows = 2;
// Pass B's block: kStripW + 2r threads, one per mid column of the strip.
constexpr int kRtMaxThreadsB = kStripW + 2 * kMaxRadius;  // 160

// sum_{d=r..1} t[r-d] (v(-d) + v(d)) + t[r] v(0) per component over a row
// of float4 whose centre is c (v(i) = c[i]); the sum starts at the d = r
// term, as the twin's.
__device__ __forceinline__ void rt_row_sym4(int r, const float* t, const float4* c,
                                            float (&acc)[4]) {
  const float4* lo = c - r;
  const float4* hi = c + r;
  {
    const float tk = t[0];
    const float4 l = *lo, h = *hi;
    acc[0] = tk * (l.x + h.x);
    acc[1] = tk * (l.y + h.y);
    acc[2] = tk * (l.z + h.z);
    acc[3] = tk * (l.w + h.w);
  }
  for (int k = 1; k < r; ++k) {
    ++lo;
    --hi;
    const float tk = t[k];
    const float4 l = *lo, h = *hi;
    acc[0] += tk * (l.x + h.x);
    acc[1] += tk * (l.y + h.y);
    acc[2] += tk * (l.z + h.z);
    acc[3] += tk * (l.w + h.w);
  }
  const float tc = t[r];
  const float4 v = *c;
  acc[0] = acc[0] + tc * v.x;
  acc[1] = acc[1] + tc * v.y;
  acc[2] = acc[2] + tc * v.z;
  acc[3] = acc[3] + tc * v.w;
}

// A thread's ring of P = 2r + 1 rows: slot k at col[k * nt]. Steps a slot
// pointer one row newer / older, wrapping with a compare.
struct RtRing {
  float4* first;  // slot 0
  float4* end;    // one past slot P - 1
  int nt;
  __device__ __forceinline__ float4* newer(float4* p) const {
    p += nt;
    return p == end ? first : p;
  }
  __device__ __forceinline__ float4* older(float4* p) const {
    return (p == first ? end : p) - nt;
  }
};

// rt_row_sym4's sums for two windows one row apart down a ring (RtRing),
// sharing their loads: window
// 0 from the oldest row `lo` (v0(-r)) to the row before the newest, window 1
// from the row after `lo` to the newest `hi` (v1(r)); 2r + 2 loads for the
// two. Each sum keeps the one-window order. c0 / c1 receive the centre
// rows' slots.
__device__ __forceinline__ void rt_ring_sym4x2(int r, const float* t, const RtRing& q,
                                               float4* lo, float4* hi, float (&acc0)[4],
                                               float (&acc1)[4], float4*& c0, float4*& c1) {
  // Window 0's low row is window 1's low row of the step before; window
  // 1's high row is window 0's high row of the step before.
  float4* pl = q.newer(lo);  // window 1's low row
  float4* ph = q.older(hi);  // window 0's high row
  float4 l0 = *lo, l1 = *pl, h1 = *hi, h0 = *ph;
  {
    const float tk = t[0];
    acc0[0] = tk * (l0.x + h0.x);
    acc0[1] = tk * (l0.y + h0.y);
    acc0[2] = tk * (l0.z + h0.z);
    acc0[3] = tk * (l0.w + h0.w);
    acc1[0] = tk * (l1.x + h1.x);
    acc1[1] = tk * (l1.y + h1.y);
    acc1[2] = tk * (l1.z + h1.z);
    acc1[3] = tk * (l1.w + h1.w);
  }
  for (int k = 1; k < r; ++k) {
    pl = q.newer(pl);
    ph = q.older(ph);
    const float4 nl = *pl, nh = *ph;
    const float tk = t[k];
    acc0[0] += tk * (l1.x + nh.x);
    acc0[1] += tk * (l1.y + nh.y);
    acc0[2] += tk * (l1.z + nh.z);
    acc0[3] += tk * (l1.w + nh.w);
    acc1[0] += tk * (nl.x + h0.x);
    acc1[1] += tk * (nl.y + h0.y);
    acc1[2] += tk * (nl.z + h0.z);
    acc1[3] += tk * (nl.w + h0.w);
    l1 = nl;
    h0 = nh;
  }
  // The centres: window 0's is the last low row of window 1, window 1's
  // the last high row of window 0.
  const float tc = t[r];
  acc0[0] = acc0[0] + tc * l1.x;
  acc0[1] = acc0[1] + tc * l1.y;
  acc0[2] = acc0[2] + tc * l1.z;
  acc0[3] = acc0[3] + tc * l1.w;
  acc1[0] = acc1[0] + tc * h0.x;
  acc1[1] = acc1[1] + tc * h0.y;
  acc1[2] = acc1[2] + tc * h0.z;
  acc1[3] = acc1[3] + tc * h0.w;
  c0 = pl;
  c1 = ph;
}

// Pass A. Mid row i of the block is mid-grid row mr0 + i (image row
// mr0 - r + i); stream row s is image row mr0 - 2r + s (clamped, or a halo
// operand's row), taken kRtRows a step (group j: rows kRtRows j ..). wmap:
// (B, H + 2r, W + 2r) float4; bad: (B, ceil(H / TH), ceil(W / kTileW))
// words, zero before the launch.
template <bool kGmap>
__global__ void __launch_bounds__(kRtMidW)
ssim_bwd_rt_weights_kernel(const float* __restrict__ a, const float* __restrict__ b,
                           const float* __restrict__ w_s, const float* __restrict__ w_cs,
                           const float* __restrict__ gmap, float4* __restrict__ wmap,
                           unsigned* __restrict__ bad, Halo halo, int H, int W, int r,
                           int TH, int S, int nstrip, int nseg,
                           const __grid_constant__ Coeffs co, float c1,
                           float c2, float clip_bound) {
  constexpr int kNT = kRtMidW;
  constexpr int kRows = kRtRows;
  constexpr int kLoads = (kRtMidW + 2 * kMaxRadius + kNT - 1) / kNT;
  const int P = 2 * r + kRows;
  const int INW = kRtMidW + 2 * r;  // staged input columns

  extern __shared__ float4 bwd_rt_smem[];
  float4* in = bwd_rt_smem;              // [2][kRows][INW]
  float4* ring = in + 2 * kRows * INW;   // [P][kNT]
  const float* taps = co.t;
  const int tid = threadIdx.x;

  int blk = blockIdx.x;
  const int strip = blk % nstrip;
  blk /= nstrip;
  const int seg = blk % nseg;
  const int img = blk / nseg;
  const int Hm = H + 2 * r, Wm = W + 2 * r;
  const int mc0 = strip * kRtMidW;  // first mid column (image column mc0 - r)
  const int mr0 = seg * S;          // first mid row (image row mr0 - r)
  const int vw = min(kRtMidW, Wm - mc0);
  const int vh = min(S, Hm - mr0);
  const size_t base = (size_t)img * (size_t)H * (size_t)W;
  const float ws = w_s[img];
  const float wcs = w_cs[img];
  const bool vhalo = halo.at != nullptr;
  const bool edge_top = !vhalo || halo.is_top;
  const bool edge_bot = !vhalo || halo.is_bot;
  const int n = vh + 2 * r;
  const int steps = (n + kRows - 1) / kRows;
  const int gx = mc0 - r + tid;  // this thread's mid column, in image columns
  const bool mid_on = tid < vw;
  const bool col_in = gx >= 0 && gx < W;
  const int ntr = (H + TH - 1) / TH;
  const int ntc = (W + kTileW - 1) / kTileW;
  unsigned* img_bad = bad + (size_t)img * (size_t)ntr * (size_t)ntc;

  // Stage 0: input column c is image column mc0 - 2r + c, clamped.
  float pa[kRows][kLoads], pb[kRows][kLoads];
  int gxl[kLoads];
#pragma unroll
  for (int q = 0; q < kLoads; ++q) gxl[q] = min(max(mc0 - 2 * r + tid + q * kNT, 0), W - 1);
  // Group j's rows into registers.
  auto fetch = [&](int j) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int vi = mr0 - 2 * r + kRows * j + i;
      const float* ra;
      const float* rb;
      if (vi < 0 && !edge_top) {
        const size_t o = ((size_t)img * 2 * r + (size_t)(vi + 2 * r)) * (size_t)W;
        ra = halo.at + o;
        rb = halo.bt + o;
      } else if (vi >= H && !edge_bot) {
        // Rows past the stream's last (a group's tail) read the operand's
        // last row, never used.
        const size_t o = ((size_t)img * 2 * r + (size_t)min(vi - H, 2 * r - 1)) * (size_t)W;
        ra = halo.ab + o;
        rb = halo.bb + o;
      } else {
        const size_t o = base + (size_t)min(max(vi, 0), H - 1) * (size_t)W;
        ra = a + o;
        rb = b + o;
      }
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        if (tid + q * kNT < vw + 2 * r) {
          pa[i][q] = __ldg(ra + gxl[q]);
          pb[i][q] = __ldg(rb + gxl[q]);
        }
      }
    }
  };
  // The NaN tiles that a non-finite value at image row vi, column xv
  // (unclamped) reaches: those with a pixel within 2r of it (rare path).
  auto mark_bad = [&](int vi, int xv) {
    const int y_lo = max(vi - 2 * r, 0), y_hi = min(vi + 2 * r, H - 1);
    const int x_lo = max(xv - 2 * r, 0), x_hi = min(xv + 2 * r, W - 1);
    if (y_lo > y_hi || x_lo > x_hi) return;
    for (int kr = y_lo / TH; kr <= y_hi / TH; ++kr) {
      for (int kc = x_lo / kTileW; kc <= x_hi / kTileW; ++kc) {
        atomicOr(img_bad + (size_t)kr * ntc + kc, 1u);
      }
    }
  };
  // Group j staged from the registers (its rows inside the stream).
  auto stage = [&](int j) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int s = kRows * j + i;
      if (s >= n) break;
      float4* dst = in + ((j & 1) * kRows + i) * INW;
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int c = tid + q * kNT;
        if (c < vw + 2 * r) {
          float va = pa[i][q], vb = pb[i][q];
          if (!(finite_f32(va) && finite_f32(vb))) mark_bad(mr0 - 2 * r + s, mc0 - 2 * r + c);
          va = sanitize(va, clip_bound);
          vb = sanitize(vb, clip_bound);
          const float sm = va + vb, df = va - vb;
          dst[c] = make_float4(va, vb, sm * sm, df * df);
        }
      }
    }
  };
  // g_map at the mid positions of group j's windows (mid row kRows j - 2r
  // + i, image row mr0 - 3r + kRows j + i), inside the image only.
  float gcur[kRows];
  auto gload = [&](int j) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int s = kRows * j + i;
      const int m = mr0 - 3 * r + s;
      gcur[i] = s >= 2 * r && s < n && mid_on && col_in && m >= 0 && m < H
                    ? __ldg(gmap + base + (size_t)m * (size_t)W + (size_t)gx)
                    : 0.0f;
    }
  };

  const RtRing rq{ring + tid, ring + tid + P * kNT, kNT};
  float4* put = ring + tid;  // the slot of the next row
  fetch(0);
  stage(0);
  if (steps > 1) fetch(1);
  if constexpr (kGmap) gload(0);
  __syncthreads();

  for (int j = 0; j < steps; ++j) {
    if (mid_on) {
      // Group j's rows across, into the ring (a slot also for a row past
      // the stream's end, unwritten and never used).
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (kRows * j + i < n) {
          float h[4];
          rt_row_sym4(r, taps, in + ((j & 1) * kRows + i) * INW + tid + r, h);
          *put = make_float4(h[0], h[1], h[2], h[3]);
        }
        put = rq.newer(put);
      }
      const int i0 = kRows * j - 2 * r;  // the mid row of group j's first window
      if (i0 >= 0) {
        // Mid rows i0 .. i0 + kRows - 1 from stream rows i0 .. i0 + 2r +
        // kRows - 1: the oldest in the slot that comes next.
        float u4[kRows][4];
        float4* ce[kRows];
        rt_ring_sym4x2(r, taps, rq, put, rq.older(put), u4[0], u4[1], ce[0], ce[1]);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (i0 + i >= vh) break;
          const int m = mr0 - r + i0 + i;
          // Mid positions outside the image (rows beyond a flagged edge)
          // carry zero weight, set by index.
          const bool outside = (m < 0 && edge_top) || (m >= H && edge_bot) || !col_in;
          float w4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (!outside) {
            float coeff = ws;
            if constexpr (kGmap) coeff = ws + gcur[i];
            weights4(u4[i][0], u4[i][1], u4[i][2], u4[i][3], coeff, wcs, c1, c2, w4);
          }
          wmap[((size_t)img * Hm + (size_t)(mr0 + i0 + i)) * (size_t)Wm +
               (size_t)(mc0 + tid)] = make_float4(w4[0], w4[1], w4[2], w4[3]);
        }
      }
    }
    // Group j + 1 staged from the registers loaded last step; group j + 2
    // loaded; g_map for group j + 1.
    if (j + 1 < steps) {
      stage(j + 1);
      if (j + 2 < steps) fetch(j + 2);
    }
    if constexpr (kGmap) gload(j + 1);
    __syncthreads();
  }
}

// Pass B, with kStripW + 2r threads: thread c holds mid column x0 - r + c
// (image columns) in the vertical adjoint, output column x0 + c in the
// horizontal one. Stream row s is mid-grid row y0 + s (image row y0 - r +
// s), taken kRtRows a step; output row y0 + s - 2r leaves the vertical
// adjoint at the step that takes stream row s and the horizontal one at the
// next. fold_top / fold_bot: the vertical clamp fold at image row 0 / H - 1
// (the band's edge without a neighbour).
__global__ void __launch_bounds__(kRtMaxThreadsB)
ssim_bwd_rt_adjoint_kernel(const float* __restrict__ a, const float* __restrict__ b,
                           const float4* __restrict__ wmap, const unsigned* __restrict__ bad,
                           float* __restrict__ da, float* __restrict__ db, int H, int W,
                           int r, int TH, int S, int nstrip, int nseg, int fold_top,
                           int fold_bot, const __grid_constant__ Coeffs co,
                           float clip_bound) {
  constexpr int kRows = kRtRows;
  const int nt = kStripW + 2 * r;
  const int P = 2 * r + kRows;

  extern __shared__ float4 bwd_rt_smem[];
  float4* vt = bwd_rt_smem;             // [2][kRows][nt]: the vertical adjoint's rows
  float4* ring = vt + 2 * kRows * nt;   // [P][nt]
  const float* taps = co.t;
  const int tid = threadIdx.x;

  int blk = blockIdx.x;
  const int strip = blk % nstrip;
  blk /= nstrip;
  const int seg = blk % nseg;
  const int img = blk / nseg;
  const int Hm = H + 2 * r, Wm = W + 2 * r;
  const int x0 = strip * kStripW;
  const int y0 = seg * S;
  const int vw = min(kStripW, W - x0);  // valid output columns
  const int vh = min(S, H - y0);        // valid output rows
  const size_t base = (size_t)img * (size_t)H * (size_t)W;
  const int n = vh + 2 * r;
  const int steps = (n + kRows - 1) / kRows;
  const bool mid_on = tid < vw + 2 * r;
  const bool out_on = tid < vw;
  const float4* wcol = wmap + (size_t)img * Hm * (size_t)Wm + (size_t)(x0 + tid);

  // This output column's NaN tiles down the segment (at most kMaxSegTiles):
  // bit k for tile row y0 / TH + k.
  unsigned mybad = 0u;
  if (out_on) {
    const int ntr = (H + TH - 1) / TH;
    const int ntc = (W + kTileW - 1) / kTileW;
    const unsigned* col = bad + ((size_t)img * ntr + y0 / TH) * ntc + (x0 + tid) / kTileW;
    for (int k = 0; k * TH < vh; ++k) mybad |= (col[(size_t)k * ntc] != 0u) << k;
  }

  // Group j's map rows, and a, b at the output rows whose horizontal
  // adjoint the next step takes, loaded a step ahead.
  float4 wnext[kRows];
  auto wload = [&](int j) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int s = kRows * j + i;
      if (s < n && mid_on) wnext[i] = wcol[(size_t)(y0 + s) * Wm];
    }
  };
  float an[kRows], bn[kRows];
  wload(0);
  __syncthreads();

  const RtRing rq{ring + tid, ring + tid + P * nt, nt};
  float4* put = ring + tid;
  int trow = 0, ktile = 0;  // the horizontal adjoint's row in its tile, tile
  for (int j = 0; j <= steps; ++j) {
    // (a) Output rows y0 + kRows (j - 1) - 2r + i: the horizontal adjoint
    // of the rows the previous step left in vt, with the fold at columns 0
    // and W - 1.
    const int o_prev = kRows * (j - 1) - 2 * r;
    if (j >= 1 && o_prev >= 0 && out_on) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int ly = o_prev + i;
        if (ly >= vh) break;
        const float4* row = vt + (((j - 1) & 1) * kRows + i) * nt + tid + r;  // centre
        float g[4];
        rt_row_sym4(r, taps, row, g);
        const int gx = x0 + tid;
        // Image column e lies e columns right of column 0, W-1-e e columns
        // left of column W-1.
        auto hfold = [&](int sign) {
          float cr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int e = 0; e < r; ++e) {
            const float f = co.cl[e];
            const float4 v = row[sign * e];
            cr[0] += f * v.x;
            cr[1] += f * v.y;
            cr[2] += f * v.z;
            cr[3] += f * v.w;
          }
#pragma unroll
          for (int p = 0; p < 4; ++p) g[p] += cr[p];
        };
        if (gx == 0) hfold(1);
        if (gx == W - 1) hfold(-1);
        const float va = sanitize(an[i], clip_bound), vb = sanitize(bn[i], clip_bound);
        const float sm = va + vb;
        const float df = va - vb;
        float ga = g[0] + 2.0f * sm * g[2] + 2.0f * df * g[3];
        float gb = g[1] + 2.0f * sm * g[2] - 2.0f * df * g[3];
        if ((mybad >> ktile) & 1u) ga = gb = __int_as_float(0x7fc00000);
        const size_t p = base + (size_t)(y0 + ly) * (size_t)W + (size_t)gx;
        da[p] = ga;
        db[p] = gb;
        if (++trow == TH) {
          trow = 0;
          ++ktile;
        }
      }
    }

    // (b) Group j's map rows into the ring; the vertical adjoint of output
    // rows y = y0 + kRows j - 2r + i from map rows y - r .. y + r.
    if (j < steps && mid_on) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (kRows * j + i < n) *put = wnext[i];
        put = rq.newer(put);
      }
      const int o0 = kRows * j - 2 * r;
      if (o0 >= 0) {
        float t4[kRows][4];
        float4* ce[kRows];
        rt_ring_sym4x2(r, taps, rq, put, rq.older(put), t4[0], t4[1], ce[0], ce[1]);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (o0 + i >= vh) break;
          const int y = y0 + o0 + i;
          // The clamp fold: image row e lies e rows below row 0 (newer),
          // H-1-e e rows above row H-1 (older).
          auto vfold = [&](bool down) {
            float cr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            float4* v = ce[i];
            for (int e = 0; e < r; ++e) {
              const float f = co.cl[e];
              const float4 x = *v;
              cr[0] += f * x.x;
              cr[1] += f * x.y;
              cr[2] += f * x.z;
              cr[3] += f * x.w;
              v = down ? rq.newer(v) : rq.older(v);
            }
#pragma unroll
            for (int p = 0; p < 4; ++p) t4[i][p] += cr[p];
          };
          if (y == 0 && fold_top) vfold(true);
          if (y == H - 1 && fold_bot) vfold(false);
          vt[((j & 1) * kRows + i) * nt + tid] =
              make_float4(t4[i][0], t4[i][1], t4[i][2], t4[i][3]);
        }
      }
    }

    // (c) Group j + 1's map rows; a, b at group j's output rows for step
    // j + 1.
    if (j + 1 < steps) wload(j + 1);
    const int o0 = kRows * j - 2 * r;
    if (j < steps && o0 >= 0 && out_on) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (o0 + i < vh) {
          const size_t p = base + (size_t)(y0 + o0 + i) * (size_t)W + (size_t)(x0 + tid);
          an[i] = __ldg(a + p);
          bn[i] = __ldg(b + p);
        }
      }
    }
    __syncthreads();
  }
}

// Dynamic shared memory of pass A and pass B at radius r (mirrored by
// std_smem_bytes in ops/ssim_grad.py): A two groups of kRtRows staged rows
// and a ring of 2r + kRtRows rows of kRtMidW threads, B two groups of
// kRtRows vertical-adjoint rows and a ring of 2r + kRtRows rows of
// kStripW + 2r threads, float4 each.
inline size_t rt_smem_a(int r) {
  return sizeof(float4) *
         (size_t)(2 * kRtRows * (kRtMidW + 2 * r) + (2 * r + kRtRows) * kRtMidW);
}
inline size_t rt_smem_b(int r) {
  return sizeof(float4) * (size_t)(2 * r + 3 * kRtRows) * (size_t)(kStripW + 2 * r);
}

// Bytes of scratch the two passes need for (B, H, W) at radius r and NaN
// tile height TH (mirrored by std_rt_scratch_bytes in ops/ssim_grad.py): the
// weight map on the mid grid, then the tile mask.
inline size_t rt_map_bytes(int B, int H, int W, int r) {
  return sizeof(float4) * (size_t)B * (size_t)(H + 2 * r) * (size_t)(W + 2 * r);
}
inline size_t rt_mask_bytes(int B, int H, int W, int TH) {
  return sizeof(unsigned) * (size_t)B * (size_t)((H + TH - 1) / TH) *
         (size_t)((W + kTileW - 1) / kTileW);
}

// Launchers from here (the host build of the kernels' source,
// tests/fwd_stream_emu, takes what is above).

template <bool kGmap>
cudaError_t rt_prepare_a(int r, size_t* smem) {
  static int done[64] = {};
  static std::mutex mu;
  *smem = rt_smem_a(r);
  return allow_smem(ssim_bwd_rt_weights_kernel<kGmap>, *smem, done, mu);
}

inline cudaError_t rt_prepare_b(int r, size_t* smem) {
  static int done[64] = {};
  static std::mutex mu;
  *smem = rt_smem_b(r);
  return allow_smem(ssim_bwd_rt_adjoint_kernel, *smem, done, mu);
}

// Both passes on `stream`: the mask cleared, pass A, pass B. scratch:
// rt_map_bytes + rt_mask_bytes, 16-byte aligned.
template <bool kGmap>
cudaError_t launch_rt(const float* a, const float* b, const float* w_s, const float* w_cs,
                      const float* gmap, float* da, float* db, const Halo& halo, int B,
                      int H, int W, int r, int TH, int S, const Coeffs& co, float c1,
                      float c2, float clip_bound, void* scratch, cudaStream_t stream) {
  const int Hm = H + 2 * r, Wm = W + 2 * r;
  const long long na = (long long)B * ((Hm + S - 1) / S) * ((Wm + kRtMidW - 1) / kRtMidW);
  const long long nb = (long long)B * ((H + S - 1) / S) * ((W + kStripW - 1) / kStripW);
  if (na > 0x7fffffffLL || nb < 1 || nb > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (scratch == nullptr) return cudaErrorInvalidValue;
  float4* wmap = static_cast<float4*>(scratch);
  unsigned* bad = reinterpret_cast<unsigned*>(static_cast<char*>(scratch) +
                                              rt_map_bytes(B, H, W, r));
  cudaError_t err = cudaMemsetAsync(bad, 0, rt_mask_bytes(B, H, W, TH), stream);
  if (err != cudaSuccess) return err;
  size_t smem = 0;
  if ((err = rt_prepare_a<kGmap>(r, &smem)) != cudaSuccess) return err;
  ssim_bwd_rt_weights_kernel<kGmap><<<(unsigned)na, kRtMidW, smem, stream>>>(
      a, b, w_s, w_cs, gmap, wmap, bad, halo, H, W, r, TH, S,
      (Wm + kRtMidW - 1) / kRtMidW, (Hm + S - 1) / S, co, c1, c2, clip_bound);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = rt_prepare_b(r, &smem)) != cudaSuccess) return err;
  const bool vhalo = halo.at != nullptr;
  ssim_bwd_rt_adjoint_kernel<<<(unsigned)nb, kStripW + 2 * r, smem, stream>>>(
      a, b, wmap, bad, da, db, H, W, r, TH, S, (W + kStripW - 1) / kStripW, (H + S - 1) / S,
      !vhalo || halo.is_top, !vhalo || halo.is_bot, co, clip_bound);
  return cudaGetLastError();
}

// Blocks of pass A (with / without g_map) and of pass B that one SM holds at
// once at radius r: the fewer of the two.
template <bool kGmap>
cudaError_t rt_occupancy(int r, int* blocks_per_sm) {
  size_t smem = 0;
  int na = 0, nb = 0;
  cudaError_t err = rt_prepare_a<kGmap>(r, &smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &na, ssim_bwd_rt_weights_kernel<kGmap>, kRtMidW, smem);
  if (err != cudaSuccess) return err;
  if ((err = rt_prepare_b(r, &smem)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, ssim_bwd_rt_adjoint_kernel,
                                                      kStripW + 2 * r, smem);
  if (err != cudaSuccess) return err;
  *blocks_per_sm = min(na, nb);
  return cudaSuccess;
}

}  // namespace
