// Fused analytic SSIM backward for NVIDIA Hopper (sm_90a), standard f32 and
// relaxed tiers.
//
// Replaces the JAX package's backward TPU kernel
// ssim_tpu/ops/ssim_grad.py::_grad_call in its scalar w_s, per-pixel g_map,
// w_cs, vhalo / vmask and relaxed modes: for
// L = sum_p (w_s + g_map(p)) * S(p) + w_cs * sum_p cs(p) per image it
// writes dL/da and dL/db. The math is that module's docstring
// (ssim_grad.py:10-40): with s = a + b, d = a - b and the clamped blur G,
//
//     dL/da = G^T[W_u] + 2 s . G^T[W_ss] + 2 d . G^T[W_dd]
//     dL/db = G^T[W_v] + 2 s . G^T[W_ss] - 2 d . G^T[W_dd]
//
// where the weight maps W are pointwise functions of the four blurred
// signals u, v, ss, dd. The TPU's band matmuls, roll passes, MXU/VPU split
// and 7680-lane column chunking are not carried over.
//
// What bounds it on this card: per output pixel it reads 8 bytes (a, b),
// writes 8 (da, db) and reads 4 more with g_map, while the function needs
// 48r + 116 f32 operations (356 at radius 5, one more with g_map; counted
// stage by stage in chip_smoke.py). At 67 TFLOP/s against 3.35 TB/s the two
// bounds nearly meet (0.044 ms of operations against 0.040 ms of bytes at
// 4 x 1080 x 1920). Built with --fmad=false (below), every multiply and add
// issues on its own, so the arithmetic alone needs twice the FMA-rate
// bound; the rest is on chip: issue slots (about as many address, control
// and load instructions as arithmetic ones), the latency of one step's
// dependent chain (the weight maps' two divisions in it), registers and
// shared-memory traffic. The first design (a 2-D tile per block, every pass
// through shared memory) spent ~220 shared-memory accesses per output
// pixel, recomputed a 2r halo of every stage, formed (a+b)^2 and (a-b)^2
// once per tap pair, and held 111 KB per block (two blocks per SM).
//
// The standard tier's design (ssim_bwd_stream_kernel): a block owns a strip
// of kStripW = 128 output columns and walks down a segment of S output rows
// (a multiple of the NaN tile's height, chosen by the wrapper to fill the
// card), one input row per step, one thread per mid column (the strip plus
// r each side). Each step, with one __syncthreads:
//  (a) the horizontal adjoint of the row finished in the step before, with
//      da/db;
//  (b) the horizontal blur of the new input row from a shared-memory row of
//      float4 {a, b, (a+b)^2, (a-b)^2} (the product signals formed once per
//      pixel); then, down the thread's column, the vertical blur of the four
//      signals, the weight maps and the vertical adjoint, each over a window
//      of the last 2r + 1 rows. At radius 5 (windows.RADIUS, every main-path
//      shape) the weight maps' window is registers (44 floats: the step loop
//      is unrolled by 2r + 1, so each row keeps its register) and the
//      horizontal blurs' window a ring of the thread's own column in shared
//      memory, with slots known at compile time; 96 registers and 51 KB a
//      block, four blocks per SM. Other radii (1-16) run one runtime-radius
//      instantiation of the same structure with both windows as rings.
//      Only the vertical adjoint's row crosses threads, through shared
//      memory, on its way to (a);
//  (c) the next input row staged (sanitised, finiteness noted, its product
//      signals formed) from registers loaded one step earlier, and the row
//      after it loaded, so device-memory latency overlaps a step's work.
// Vertical recompute falls to (S + 4r) / S for the horizontal pass and
// (S + 2r) / S for the vertical blur; no stage reads device memory twice
// (da/db take a and b from a ring of the block's own rows). Designs tried
// (PERF.md): both windows in registers (128 registers, spills,
// three blocks per SM), both in rings at radius 5 too, two warp groups
// (blur and weights / adjoints) with one window each, windows shifted by
// one register a step instead of the unrolled loop.
//
// Stages, in the order of operations of the plain twin
// (ops/ssim_grad.py::ssim_grad_plain), r = window radius:
//  0. inputs with a 2r margin, clamped indices (the clamp-to-edge border),
//     nan_to_num + clip;
//  1. forward blurs u, v, ss, dd on the mid grid (the image plus an r
//     margin), horizontal then vertical, symmetric tap pairs smallest taps
//     first, then the centre tap; then the weight maps W_u, W_v, W_ss, W_dd
//     (ssim_grad.py:535-560), zero by index at mid positions outside the
//     image (never by multiplying: a garbage value times 0 may be NaN);
//  2. the transposed clamped blur back to the image's pixels: the vertical
//     adjoint with the clamp fold at image rows 0 and H-1, then the
//     horizontal adjoint with the fold at columns 0 and W-1 (the fold
//     between the two passes, ssim_grad.py:204-275); then da/db.
// NaN contract: a non-finite input pixel makes NaN every gradient of the
// NaN tiles (default_tile in ops/ssim_grad.py: 32 x 64, 16 x 64 at radius
// 16) within 2r of it, and never reaches another image. Strips and segments
// are whole tiles, so each tile lies in one block; a block notes the tiles
// that each non-finite input it loads reaches, and writes NaN over them
// after its last row (a rare path).
//
// Halo operands (the vhalo / vmask mode, ssim_grad.py:149-202 and :391-470,
// for a row band of a taller image in spatial sharding): virtual rows
// [-2r, 0) and [H, H + 2r) are read from four (B, 2r, W) operands instead
// of clamped, unless is_top (is_bot) is set, where the band holds the
// image's edge row: then the clamp applies and the operand is never read
// (the in-kernel replica substitution). Loss rows then span the band plus r
// rows each side: the weight maps are zero at mid rows above 0 (below
// H - 1) only where is_top (is_bot) is set, the runtime loss-row mask of
// ssim_grad.py:462-470, and the vertical clamp fold at rows 0 (H - 1)
// applies only there (cl_v, ssim_grad.py:570-590). Elsewhere the
// neighbour's loss rows reach the band's edge rows through the plain
// symmetric part, the true adjoint. Only the band's own rows are written.
//
// Relaxed (accuracy="relaxed"; ssim_grad.py:324-328, :500-516, :522-529,
// :563-567): every band pass of the four horizontal and four vertical
// blurs and their eight adjoints a bf16x3 band product on the tensor cores
// (band_mma.cuh), each output's epilogue (the weight maps, the clamp folds
// in f32 between the two adjoints, da/db) the standard pass's. The wrapper
// launches it at W >= 512, the JAX gate (use_mxu). Orthogonal to the halo
// operands, as in the JAX kernel. It streams rows at every radius
// (ssim_bwd_relaxed_stream_kernel, bwd_relaxed_stream.cuh): the standard
// tier's segments, NaN mask and halo-operand rows, advancing 8 rows a
// step, the mma's N. At radius 5 (every main-path shape, compiled in, this
// file) nine warps, each owning one 16-column tile of the strip's 144 mid
// columns: per 8-row chunk it blurs the chunk's staged rows across (the
// band as the A operand, the 8 rows as the mma's lines, the four planes
// formed and split as the f32 {a, b} pairs are loaded), down (the band as
// B, the data as A: 16 columns x 18 rows, kept split in bf16 hi / lo in a
// ring of 18 rows per warp, read by ldmatrix.trans and written by
// stmatrix.trans), forms the weight maps into a second such ring, takes
// the vertical adjoint into an f32 row buffer, and after a barrier the
// horizontal adjoint of that buffer (band as A, split as loaded) and
// da/db, a and b read again from device memory. Each value is split once;
// the folds use f32 values (the vertical one summed row by row into
// per-column sums as the weight maps are made, in the order of the rows);
// four barriers per 8 rows, ~108 KB and 2 blocks per SM, 96 registers.
// PERF.md lists the designs measured. The other radii run the same
// body with the radius read at run time (ssim_bwd_relaxed_rt_kernel,
// ssim_bwd_relaxed_rt.cu): rings of 8 + 2r rows, the k-steps of its group
// of radii, and a strip of 128 columns or one 64-column NaN tile
// (ops/ssim_grad.py RELAXED_STRIP_W).
//
// Build without --use_fast_math and with --fmad=false: every multiply and
// add rounds on its own, in the order of the plain twin, so the kernel's
// gradients can be held against the twin's closely. One writer per output
// pixel, no atomics on the result: it is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "band_mma.cuh"
#include "bwd_common.cuh"
#include "bwd_relaxed_stream.cuh"

namespace {

// The standard tier's streaming block: kStripW output columns (two NaN
// tiles of kTileW), one thread per mid column at every radius.
constexpr int kStreamThreads = kStripW + 2 * kMaxRadius;  // 160

// The blocks per SM asked of ptxas at kWindowRadius, whose weight-map
// window is registers (96 registers a thread); every other radius runs
// both windows as rings.
constexpr int kWindowBlocks = 4;

// ---------------------------------------------------------------------------
// The standard tier: row-streaming column strips.

// Dynamic shared-memory floats of the streaming kernel at radius r (mirrored
// by stream_smem_bytes in ops/ssim_grad.py): two staged input rows of
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

// kR > 0: the register-window instantiation at that radius; kR == 0: the
// runtime radius r_rt, windows in shared memory. TH: the NaN tile's height;
// S: the segment's rows (a multiple of TH, at most kMaxSegTiles tiles).
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

// ssim_bwd_relaxed_rt.cu: the relaxed streaming launches at the other radii
// and strips.
extern "C" int ssim_bwd_relaxed_rt_launch(const void* a, const void* b, const void* w_s,
                                          const void* w_cs, const void* gmap, void* da,
                                          void* db, const void* a_top, const void* a_bot,
                                          const void* b_top, const void* b_bot, int is_top,
                                          int is_bot, int B, int H, int W, int r, int TH,
                                          int S, int SW, const float* taps_host,
                                          const float* fold_host, float c1, float c2,
                                          float clip_bound, void* stream);
extern "C" int ssim_bwd_relaxed_rt_occupancy(int r, int gmap, int SW, int* blocks_per_sm);

// C entry for ctypes. relaxed: 1 for the relaxed mode, else 0. a, b, da,
// db: (B, H, W) f32; w_s, w_cs: (B,) f32 on the device; gmap: (B, H, W)
// f32 or NULL. a_top, a_bot, b_top, b_bot: the halo operands, (B, 2r, W)
// f32, all four or none, never with gmap; is_top, is_bot: their flags (0
// or 1). TH x TW: the NaN tile (default_tile; TW must be 64); S: the
// segment rows (a multiple of TH, at most 16 tiles); SW: the strip
// columns, 128 (the standard stream's only strip), or 64 in the relaxed one
// (ops/ssim_grad.py relaxed_strip_w). taps_host: 2r+1 floats and
// fold_host: r floats, in host memory. Returns the launch's cudaError_t.
extern "C" int ssim_bwd_launch(int relaxed, const void* a, const void* b,
                               const void* w_s, const void* w_cs,
                               const void* gmap, void* da,
                               void* db, const void* a_top, const void* a_bot,
                               const void* b_top, const void* b_bot,
                               int is_top, int is_bot, int B, int H, int W,
                               int r, int TH, int TW, int S, int SW,
                               const float* taps_host, const float* fold_host,
                               float c1, float c2, float clip_bound,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  const float* fws = static_cast<const float*>(w_s);
  const float* fwcs = static_cast<const float*>(w_cs);
  const float* fg = static_cast<const float*>(gmap);
  float* fda = static_cast<float*>(da);
  float* fdb = static_cast<float*>(db);
  const Halo halo{static_cast<const float*>(a_top),
                  static_cast<const float*>(a_bot),
                  static_cast<const float*>(b_top),
                  static_cast<const float*>(b_bot), is_top, is_bot};
  const int n_halo = (a_top != nullptr) + (a_bot != nullptr) +
                     (b_top != nullptr) + (b_bot != nullptr);
  if (n_halo != 0 && (n_halo != 4 || fg != nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (r < 1 || r > kMaxRadius || H < 1 || W < 1 || TH < 1) {
    return cudaErrorInvalidValue;
  }
  Coeffs co;
  for (int k = 0; k < kMaxTaps; ++k) co.t[k] = k < 2 * r + 1 ? taps_host[k] : 0.0f;
  for (int k = 0; k < kMaxRadius; ++k) co.cl[k] = k < r ? fold_host[k] : 0.0f;
  const bool seg_ok = TW == kTileW && S >= TH && S % TH == 0 && S / TH <= kMaxSegTiles &&
                      (SW == kStripW || (relaxed && SW == kTileW));
  if (relaxed) {
    if (!seg_ok) return cudaErrorInvalidValue;
    if (r == kRelR && SW == kStripW) {
      constexpr int kG = rel_groups(kRelR);
      return fg ? launch_relaxed_stream<kRelR, kG, kStripW, true>(
                      fa, fb, fws, fwcs, fg, fda, fdb, halo, B, H, W, r, TH, S, co, c1, c2,
                      clip_bound, s)
                : launch_relaxed_stream<kRelR, kG, kStripW, false>(
                      fa, fb, fws, fwcs, fg, fda, fdb, halo, B, H, W, r, TH, S, co, c1, c2,
                      clip_bound, s);
    }
    return ssim_bwd_relaxed_rt_launch(a, b, w_s, w_cs, gmap, da, db, a_top, a_bot, b_top,
                                      b_bot, is_top, is_bot, B, H, W, r, TH, S, SW,
                                      taps_host, fold_host, c1, c2, clip_bound, stream);
  }
  if (!seg_ok) return cudaErrorInvalidValue;
#define SSIM_BWD_STREAM(R, G)                                                 \
  return launch_stream<R, G>(fa, fb, fws, fwcs, fg, fda, fdb, halo, B, H, W, \
                             r, TH, S, co, c1, c2, clip_bound, s)
  if (r == kWindowRadius) {
    if (fg) SSIM_BWD_STREAM(kWindowRadius, true);
    SSIM_BWD_STREAM(kWindowRadius, false);
  }
  if (fg) SSIM_BWD_STREAM(0, true);
  SSIM_BWD_STREAM(0, false);
#undef SSIM_BWD_STREAM
}

// Blocks of a streaming kernel that one SM of the current device holds at
// once, for radius r with (gmap = 1) or without the g_map operand: the
// CUDA runtime's occupancy for the instantiation that ssim_bwd_launch
// takes, the standard one (relaxed = 0; SW 128) or the relaxed one
// (relaxed = 1) at a strip of SW columns. Returns a cudaError_t.
extern "C" int ssim_bwd_stream_occupancy(int relaxed, int r, int gmap, int SW,
                                         int* blocks_per_sm) {
  if (r < 1 || r > kMaxRadius || (SW != kStripW && !(relaxed && SW == kTileW))) {
    return cudaErrorInvalidValue;
  }
  if (relaxed && r == kRelR && SW == kStripW) {
    constexpr int kG = rel_groups(kRelR);
    return gmap ? relaxed_stream_occupancy<kRelR, kG, kStripW, true>(r, blocks_per_sm)
                : relaxed_stream_occupancy<kRelR, kG, kStripW, false>(r, blocks_per_sm);
  }
  if (relaxed) return ssim_bwd_relaxed_rt_occupancy(r, gmap, SW, blocks_per_sm);
  if (r == kWindowRadius) {
    return gmap ? stream_occupancy<kWindowRadius, true>(r, blocks_per_sm)
                : stream_occupancy<kWindowRadius, false>(r, blocks_per_sm);
  }
  return gmap ? stream_occupancy<0, true>(r, blocks_per_sm)
              : stream_occupancy<0, false>(r, blocks_per_sm);
}

