// The standard backward tier's row stream with its weight-map window in
// registers (ssim_bwd_stream_kernel<kR, kGmap>, the radius compiled in),
// its shared memory and launch helpers. Included by ssim_bwd.cu (radius 5)
// and ssim_bwd_rt.cu (the other radii that keep this design: ops/
// ssim_grad.py STD_WINDOW_RADII). The design is ssim_bwd.cu's header
// comment's.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "bwd_common.cuh"

namespace {

// The standard tier's streaming block: kStripW output columns (two NaN
// tiles of kTileW), one thread per mid column at every radius.
constexpr int kStreamThreads = kStripW + 2 * kMaxRadius;  // 160

// The blocks per SM asked of ptxas at a compiled-in radius, whose
// weight-map window is registers (96 registers a thread at kWindowRadius).
constexpr int kWindowBlocks = 4;

// ---------------------------------------------------------------------------
// The standard tier: row-streaming column strips.

// Dynamic shared-memory floats of the streaming kernel at radius r (mirrored
// by std_smem_bytes(r, False) in ops/ssim_grad.py): two staged input rows of
// float4 {a, b, (a+b)^2, (a-b)^2} over kStripW + 4r columns; two
// vertical-adjoint rows of float4, one per thread; a ring of 2r + 3 rows
// of the strip's sanitised a, b (float2) for da/db; and float4 window rings
// of 2r + 1 rows per thread: at the register radius the horizontal blurs',
// at the others both.
__host__ __device__ inline size_t stream_smem_floats(int r, bool windows) {
  const size_t in = 2 * 4 * (size_t)(kStripW + 4 * r);
  const size_t vt = 2 * 4 * (size_t)kStreamThreads;
  const size_t ab = 2 * (size_t)(2 * r + 3) * kStripW;
  const size_t ring = 4 * (size_t)(2 * r + 1) * kStreamThreads;
  return in + vt + ab + (windows ? ring : 2 * ring);
}

// Symmetric taps over 2r + 1 float4s: sum_{d=r..1} t[r-d] (v(-d) + v(d)) +
// t[r] v(0), v(i) the value at offset i from the centre, per component;
// the sum starts at the d = r term, as the twin's (no 0 + x to issue).
template <typename Tap, typename V>
__device__ __forceinline__ void sym4(int r, Tap&& tap, V&& v, float (&acc)[4]) {
  {
    const float t = tap(0);
    const float4 lo = v(-r), hi = v(r);
    acc[0] = t * (lo.x + hi.x);
    acc[1] = t * (lo.y + hi.y);
    acc[2] = t * (lo.z + hi.z);
    acc[3] = t * (lo.w + hi.w);
  }
#pragma unroll
  for (int d = r - 1; d >= 1; --d) {
    const float t = tap(r - d);
    const float4 lo = v(-d), hi = v(d);
    acc[0] += t * (lo.x + hi.x);
    acc[1] += t * (lo.y + hi.y);
    acc[2] += t * (lo.z + hi.z);
    acc[3] += t * (lo.w + hi.w);
  }
  const float tc = tap(r);
  const float4 ce = v(0);
  acc[0] = acc[0] + tc * ce.x;
  acc[1] = acc[1] + tc * ce.y;
  acc[2] = acc[2] + tc * ce.z;
  acc[3] = acc[3] + tc * ce.w;
}

// kR > 0: the register-window instantiation at that radius (r_rt = kR); kR
// == 0: the runtime radius r_rt, windows in shared memory. Only kR > 0 is
// instantiated (radius 5 in ssim_bwd.cu, STD_WINDOW_RADII in
// ssim_bwd_rt.cu; the two-pass stream serves the other radii); the kR == 0
// branches are kept so that radius 5's code stays as it was compiled
// before (tools/sass_diff.py: without them its SASS differed). TH: the NaN
// tile's height; S: the segment's rows (a multiple of TH, at most
// kMaxSegTiles tiles).
template <int kR, bool kGmap>
__global__ void __launch_bounds__(kStreamThreads, kR > 0 ? kWindowBlocks : 1)
ssim_bwd_stream_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ w_s,
                       const float* __restrict__ w_cs,
                       const float* __restrict__ gmap, float* __restrict__ da,
                       float* __restrict__ db, Halo halo, int H, int W, int r_rt,
                       int TH, int S, int nstrip, int nseg, Coeffs co, float c1,
                       float c2, float clip_bound) {
  constexpr bool kWin = kR > 0;
  constexpr int kP = kWin ? 2 * kR + 1 : 1;  // register window rows = steps unrolled
  constexpr int kNT = kStreamThreads;
  // Input columns a thread loads: kStripW + 4r over kNT threads.
  constexpr int kLoads = (kStripW + 4 * (kWin ? kR : kMaxRadius) + kNT - 1) / kNT;
  const int r = kWin ? kR : r_rt;
  const int P = 2 * r + 1;      // window rows
  const int RAB = 2 * r + 3;    // a, b ring rows
  const int INW = kStripW + 4 * r;

  extern __shared__ float4 stream_smem[];
  float4* in = stream_smem;                   // [2][INW]
  float4* vt = in + 2 * INW;                  // [2][kNT]
  float2* abr = reinterpret_cast<float2*>(vt + 2 * kNT);  // [RAB][kStripW]
  float4* hring = reinterpret_cast<float4*>(abr + RAB * kStripW);  // [P][kNT]
  float4* wring = hring + P * kNT;  // [P][kNT], without kWin only
  __shared__ float s_t[kMaxTaps];
  __shared__ float s_cl[kMaxRadius];
  __shared__ unsigned s_bad;  // bit 2 * tile row + tile column

  const int tid = threadIdx.x;
  if constexpr (!kWin) {
    if (tid < kMaxTaps) s_t[tid] = co.t[tid];
    if (tid < kMaxRadius) s_cl[tid] = co.cl[tid];
  }
  if (tid == 0) s_bad = 0u;
  // Before the prologue's stage(0), which may mark tiles in s_bad.
  __syncthreads();
  // Taps and fold mass: kernel parameters at the register-window radius
  // (constant operands once the loops unroll), shared memory otherwise.
  auto tap = [&](int i) -> float {
    if constexpr (kWin) return co.t[i]; else return s_t[i];
  };
  auto fold = [&](int i) -> float {
    if constexpr (kWin) return co.cl[i]; else return s_cl[i];
  };

  int blk = blockIdx.x;
  const int strip = blk % nstrip;
  blk /= nstrip;
  const int seg = blk % nseg;
  const int img = blk / nseg;
  const int x0 = strip * kStripW;
  const int y0 = seg * S;
  const int vw = min(kStripW, W - x0);  // valid output columns
  const int vh = min(S, H - y0);        // valid output rows
  const size_t base = (size_t)img * (size_t)H * (size_t)W;
  const float ws = w_s[img];
  const float wcs = w_cs[img];
  const bool vhalo = halo.at != nullptr;
  // Loss rows above 0 / below H - 1 exist (and carry no clamp fold) only
  // in a band with a neighbour there.
  const bool edge_top = !vhalo || halo.is_top;
  const bool edge_bot = !vhalo || halo.is_bot;
  const int n = vh + 4 * r;  // stream rows: virtual row y0 - 2r + s

  // This thread: mid column c = tid (image column x0 - r + c) in the
  // vertical passes, output column tid in the horizontal adjoint.
  const int c = tid;
  const int gxm = x0 - r + c;
  const bool mid_on = c < vw + 2 * r;
  const bool col_in = gxm >= 0 && gxm < W;

  // Stage 0: stream row s loaded into registers (fetch), then staged
  // (stage). Input column j is image column x0 - 2r + j, clamped.
  float pa[kLoads], pb[kLoads];
  int gxl[kLoads];
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    gxl[q] = min(max(x0 - 2 * r + tid + q * kNT, 0), W - 1);
  }
  auto fetch = [&](int s) {
    const int vi = y0 - 2 * r + s;
    const float* ra;
    const float* rb;
    if (vi < 0 && !edge_top) {
      const size_t o = ((size_t)img * 2 * r + (size_t)(vi + 2 * r)) * (size_t)W;
      ra = halo.at + o;
      rb = halo.bt + o;
    } else if (vi >= H && !edge_bot) {
      const size_t o = ((size_t)img * 2 * r + (size_t)(vi - H)) * (size_t)W;
      ra = halo.ab + o;
      rb = halo.bb + o;
    } else {
      const size_t o = base + (size_t)min(max(vi, 0), H - 1) * (size_t)W;
      ra = a + o;
      rb = b + o;
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      if (tid + q * kNT < vw + 4 * r) {
        pa[q] = __ldg(ra + gxl[q]);
        pb[q] = __ldg(rb + gxl[q]);
      }
    }
  };
  // The NaN tiles that a non-finite input at stream row s, input column j
  // reaches: those whose pixels lie within 2r of it (rare path).
  auto mark_bad = [&](int s, int j) {
    const int vi = y0 - 2 * r + s;
    const int xv = x0 - 2 * r + j;
    const int ntc = (vw + kTileW - 1) / kTileW;
    const int ntr = (vh + TH - 1) / TH;
    unsigned bits = 0u;
    for (int kr = 0; kr < ntr; ++kr) {
      const int ty0 = y0 + kr * TH;
      const int vth = min(TH, H - ty0);
      if (vi < ty0 - 2 * r || vi > ty0 + vth - 1 + 2 * r) continue;
      for (int kc = 0; kc < ntc; ++kc) {
        const int tx0 = x0 + kc * kTileW;
        const int vtw = min(kTileW, W - tx0);
        if (xv >= tx0 - 2 * r && xv <= tx0 + vtw - 1 + 2 * r) {
          bits |= 1u << (2 * kr + kc);
        }
      }
    }
    if (bits) atomicOr(&s_bad, bits);
  };
  // The a, b ring: stream row q in slot q mod RAB, staged at step q - 1
  // and read by the horizontal adjoint at step q + 2r + 1. Two running
  // slots stand in for the division per step.
  int ab_put = 0;  // slot of the next row staged
  auto stage = [&](int s) {
    float4* dst = in + (s & 1) * INW;
    float2* abd = abr + ab_put * kStripW;
    if (++ab_put == RAB) ab_put = 0;
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int j = tid + q * kNT;
      if (j < vw + 4 * r) {
        float va = pa[q], vb = pb[q];
        if (!(finite_f32(va) && finite_f32(vb))) mark_bad(s, j);
        va = sanitize(va, clip_bound);
        vb = sanitize(vb, clip_bound);
        const float sm = va + vb, df = va - vb;
        dst[j] = make_float4(va, vb, sm * sm, df * df);
        const int x = j - 2 * r;
        if (x >= 0 && x < vw) abd[x] = make_float2(va, vb);
      }
    }
  };
  int ab_get = 2 * r;  // slot of the next row the horizontal adjoint reads

  // Stage 2b and da/db: the horizontal adjoint of the vertical-adjoint row
  // written at step sr (output row y0 + sr - 4r), with the fold at columns
  // 0 and W-1.
  auto hadjoint = [&](int sr) {
    const float4* row = vt + (sr & 1) * kNT + tid + r;  // centre row[0]
    const float2* abrow = abr + ab_get * kStripW;
    if (++ab_get == RAB) ab_get = 0;
    if (tid >= vw) return;
    float g[4];
    sym4(r, tap, [&](int i) { return row[i]; }, g);
    const int gx = x0 + tid;
    // The fold: image column e at offset e from column 0, W-1-e at -e
    // from column W-1.
    auto hfold = [&](int sign) {
      float cr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int e = 0; e < r; ++e) {
        const float f = fold(e);
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
    const float2 v = abrow[tid];
    const float sm = v.x + v.y;
    const float df = v.x - v.y;
    const float ga = g[0] + 2.0f * sm * g[2] + 2.0f * df * g[3];
    const float gb = g[1] + 2.0f * sm * g[2] - 2.0f * df * g[3];
    const size_t p = base + (size_t)(y0 + sr - 4 * r) * (size_t)W + (size_t)gx;
    da[p] = ga;
    db[p] = gb;
  };

  // The vertical windows: the horizontal blurs of the last 2r + 1 stream
  // rows (hring) and the weight maps of the last 2r + 1 mid rows (ww, or
  // wring), four planes each. With kWin the row of stream index q lives in
  // slot q mod kP, static once the step loop is unrolled by kP (k = s mod
  // kP): a register of ww, and this thread's column of hring. Without kWin,
  // in slot q mod P of this thread's columns of hring and wring.
  float ww[4][kP];
  // g_map at this step's and the next step's mid positions, loaded two
  // steps ahead.
  float gnow = 0.0f, gnext = 0.0f;

  // Prologue: stream row 0 staged, row 1 loading.
  fetch(0);
  stage(0);
  if (n > 1) fetch(1);
  __syncthreads();

  const int n_step = n + 1;  // the last step only finishes row n - 1's adjoint
  for (int s0 = 0; s0 < n_step; s0 += kP) {
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      const int s = s0 + k;
      if (s < n_step) {
        // (a) The row whose vertical adjoint the previous step wrote.
        if (s >= 4 * r + 1) hadjoint(s - 1);

        // (b) Stream row s: horizontal blur, vertical blur of mid row
        // s - r, weight maps, vertical adjoint of output row s - 2r.
        if (s < n && mid_on) {
          const float4* row = in + (s & 1) * INW + c + r;  // centre row[0]
          float h[4];
          sym4(r, tap, [&](int i) { return row[i]; }, h);
          hring[(kWin ? k : s % P) * kNT + c] = make_float4(h[0], h[1], h[2], h[3]);
          // Row of age j (stream row s - j): slot (k - j) mod kP with kWin,
          // else (s - j) mod P; weight row of age j (mid row s - r - j)
          // likewise from k - r and s - r.
          auto hrow = [&](int j) {
            const int sl = kWin ? (k - j + 2 * kP) % kP : (s - j) % P;
            return hring[sl * kNT + c];
          };
          auto wrow = [&](int j) {
            if constexpr (kWin) {
              const int sl = (k - kR - j + 3 * kP) % kP;
              return make_float4(ww[0][sl], ww[1][sl], ww[2][sl], ww[3][sl]);
            } else {
              return wring[((s - r - j) % P) * kNT + c];
            }
          };
          if (s >= 2 * r) {
            // Mid row m = y0 - 3r + s (stream row s - r).
            float u4[4];  // rows s - r -+ d: ages r +- d
            sym4(r, tap, [&](int i) { return hrow(r - i); }, u4);
            const int m = y0 - 3 * r + s;
            // Mid positions outside the image (rows beyond a flagged edge)
            // carry zero weight, set by index.
            const bool outside =
                (m < 0 && edge_top) || (m >= H && edge_bot) || !col_in;
            float w4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (!outside) {
              float coeff = ws;
              if constexpr (kGmap) coeff = ws + gnow;
              weights4(u4[0], u4[1], u4[2], u4[3], coeff, wcs, c1, c2, w4);
            }
            if constexpr (kWin) {
#pragma unroll
              for (int p = 0; p < 4; ++p) ww[p][(k - kR + 2 * kP) % kP] = w4[p];
            } else {
              wring[((s - r) % P) * kNT + c] = make_float4(w4[0], w4[1], w4[2], w4[3]);
            }
            if (s >= 4 * r) {
              // Stage 2a: output row y = y0 + s - 4r (stream row s - 2r)
              // from mid rows s - 3r .. s - r (weight ages 2r .. 0).
              float t4[4];
              sym4(r, tap, [&](int i) { return wrow(r - i); }, t4);
              // The clamp fold: image row e (< r) lies e rows below y = 0
              // (age r - e), row H-1-e e rows above y = H-1 (age r + e).
              const int y = y0 + s - 4 * r;
              auto vfold = [&](int sign) {
                float cr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
                for (int e = 0; e < (kWin ? kR : kMaxRadius); ++e) {
                  if (e < r) {
                    const float4 v = wrow(r - sign * e);
                    const float f = fold(e);
                    cr[0] += f * v.x;
                    cr[1] += f * v.y;
                    cr[2] += f * v.z;
                    cr[3] += f * v.w;
                  }
                }
#pragma unroll
                for (int p = 0; p < 4; ++p) t4[p] += cr[p];
              };
              if (y == 0 && edge_top) vfold(1);
              if (y == H - 1 && edge_bot) vfold(-1);
              vt[(s & 1) * kNT + c] = make_float4(t4[0], t4[1], t4[2], t4[3]);
            }
          }
        }

        // (c) Stream row s + 1 staged from the registers loaded last step;
        // row s + 2 loaded; g_map at the mid position of step s + 2.
        if (s + 1 < n) {
          stage(s + 1);
          if (s + 2 < n) fetch(s + 2);
        }
        if constexpr (kGmap) {
          gnow = gnext;
          const int m = y0 - 3 * r + s + 2;
          if (s + 2 >= 2 * r && s + 2 < n && mid_on && col_in && m >= 0 && m < H) {
            gnext = __ldg(gmap + base + (size_t)m * (size_t)W + (size_t)gxm);
          }
        }
        __syncthreads();
      }
    }
  }

  // NaN over the tiles a non-finite input reached (after every finite
  // write of this block: the last step ended with a barrier).
  const unsigned bad = s_bad;
  if (bad) {
    const float nan = __int_as_float(0x7fc00000);
    for (int i = tid; i < vh * vw; i += kNT) {
      const int y = i / vw;
      const int x = i - y * vw;
      if ((bad >> (2 * (y / TH) + x / kTileW)) & 1u) {
        const size_t p = base + (size_t)(y0 + y) * (size_t)W + (size_t)(x0 + x);
        da[p] = nan;
        db[p] = nan;
      }
    }
  }
}

// Launchers from here (the host build of the kernels' source,
// tests/fwd_stream_emu, takes what is above).

// The instantiation's dynamic shared memory at radius r, its limit set once
// per device and size.
template <int kR, bool kGmap>
cudaError_t prepare_stream(int r, size_t* smem) {
  static int done[64] = {};
  static std::mutex mu;
  *smem = sizeof(float) * stream_smem_floats(r, kR > 0);
  return allow_smem(ssim_bwd_stream_kernel<kR, kGmap>, *smem, done, mu);
}

template <int kR, bool kGmap>
cudaError_t launch_stream(const float* a, const float* b, const float* w_s,
                          const float* w_cs, const float* gmap, float* da,
                          float* db, const Halo& halo, int B, int H, int W,
                          int r, int TH, int S, const Coeffs& co, float c1,
                          float c2, float clip_bound, cudaStream_t stream) {
  const int nstrip = (W + kStripW - 1) / kStripW;
  const int nseg = (H + S - 1) / S;
  const long long blocks = (long long)B * nseg * nstrip;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  size_t smem = 0;
  cudaError_t err = prepare_stream<kR, kGmap>(r, &smem);
  if (err != cudaSuccess) return err;
  ssim_bwd_stream_kernel<kR, kGmap>
      <<<(unsigned)blocks, kStreamThreads, smem, stream>>>(
          a, b, w_s, w_cs, gmap, da, db, halo, H, W, r, TH, S, nstrip, nseg, co,
          c1, c2, clip_bound);
  return cudaGetLastError();
}

template <int kR, bool kGmap>
cudaError_t stream_occupancy(int r, int* blocks_per_sm) {
  size_t smem = 0;
  cudaError_t err = prepare_stream<kR, kGmap>(r, &smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ssim_bwd_stream_kernel<kR, kGmap>, kStreamThreads, smem);
}

}  // namespace
