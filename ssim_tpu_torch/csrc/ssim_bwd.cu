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
// operands, as in the JAX kernel. At radius 5 (every main-path shape) it
// streams rows (ssim_bwd_relaxed_stream_kernel): the standard tier's
// strips and segments, NaN mask and halo-operand rows, advancing 8 rows a
// step, the mma's N. Nine warps, each owning one 16-column tile of the
// strip's 144 mid columns: per 8-row chunk it blurs the chunk's staged
// rows across (the band as the A operand, the 8 rows as the mma's lines,
// the four planes formed and split as the f32 {a, b} pairs are loaded),
// down (the band as B, the data as A: 16 columns x 18 rows, kept split in
// bf16 hi / lo in a ring of 18 rows per warp, read by ldmatrix.trans and
// written by stmatrix.trans), forms the weight maps into a second such
// ring, takes the vertical adjoint into an f32 row buffer, and after a
// barrier the horizontal adjoint of that buffer (band as A, split as
// loaded) and da/db, a and b read again from device memory. Each value is
// split once; the folds use f32 values (the vertical one summed row by row
// into per-column sums as the weight maps are made, in the order of the
// rows); four barriers per 8 rows, ~108 KB and 2 blocks per SM, 96
// registers. PERF.md (PR 14) lists the designs measured. Other radii run
// ssim_bwd_tile_kernel: one 2-D grid of TH x TW output tiles (batch folded
// into blockIdx.x), every pass a band_mma::sweep over four planes through
// shared memory (kSplit = band_mma::ksteps(r)).
//
// Build without --use_fast_math and with --fmad=false: every multiply and
// add rounds on its own, in the order of the plain twin, so the kernel's
// gradients can be held against the twin's closely. One writer per output
// pixel, no atomics on the result: it is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "band_mma.cuh"

namespace {

constexpr int kThreads = 256;   // the relaxed tile kernel's block
constexpr int kMaxTaps = 33;    // radius <= 16
constexpr int kMaxRadius = 16;

// The standard tier's streaming block: kStripW output columns (two NaN
// tiles of kTileW), one thread per mid column at every radius.
constexpr int kStripW = 128;
constexpr int kTileW = 64;
constexpr int kStreamThreads = kStripW + 2 * kMaxRadius;  // 160
// NaN tiles down one segment: the block's tile mask holds 2 x 16 bits.
constexpr int kMaxSegTiles = 16;

// The radius whose weight-map window is registers (windows.RADIUS, every
// main-path shape), and the blocks per SM asked of ptxas there (96
// registers a thread); every other radius runs both windows as rings.
constexpr int kWindowRadius = 5;
constexpr int kWindowBlocks = 4;

struct Coeffs {
  float t[kMaxTaps];     // Gaussian taps, 2r + 1 used
  float cl[kMaxRadius];  // clamp-fold mass: cl[x] = sum_{k > r + x} t[k]
};

// The halo operands of a row band: virtual rows [-2r, 0) in at / bt and
// [H, H + 2r) in ab / bb, each (B, 2r, W) f32; all NULL without them.
// is_top / is_bot: the band holds the image's first / last row.
struct Halo {
  const float* at;
  const float* ab;
  const float* bt;
  const float* bb;
  int is_top;
  int is_bot;
};

__device__ __forceinline__ bool finite_f32(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
}

// nan_to_num followed by a clip to +-bound (ssim_grad.py:381-383).
__device__ __forceinline__ float sanitize(float v, float bound) {
  if ((__float_as_uint(v) & 0x7fffffffu) > 0x7f800000u) return 0.0f;
  return fminf(fmaxf(v, -bound), bound);
}

// The weight maps W_u, W_v, W_ss, W_dd from the four blurred signals, in
// the order of ssim_grad.py:536-560.
__device__ __forceinline__ void weights4(float u, float v, float ss, float dd,
                                         float coeff, float wcs, float c1,
                                         float c2, float (&w)[4]) {
  const float uv = u * v;
  const float usq = u * u + v * v;
  const float a1 = 2.0f * uv + c1;
  const float a2 = 0.5f * (ss - dd) - 2.0f * uv + c2;
  const float b1 = usq + c1;
  const float b2 = 0.5f * (ss + dd) - usq + c2;
  const float rb1 = 1.0f / b1;
  const float rb2 = 1.0f / b2;
  const float lum = a1 * rb1;
  const float cs = a2 * rb2;
  const float s_val = lum * cs;
  const float half_rb2 = 0.5f * rb2;
  const float d_ss_c = half_rb2 * (1.0f - cs);
  const float d_dd_c = -half_rb2 * (1.0f + cs);
  const float q = a2 - a1;
  const float rb12 = rb1 * rb2;
  const float drb = rb1 - rb2;
  w[0] = coeff * (2.0f * v * q * rb12 - 2.0f * u * s_val * drb) +
         wcs * ((2.0f * u * cs - 2.0f * v) * rb2);
  w[1] = coeff * (2.0f * u * q * rb12 - 2.0f * v * s_val * drb) +
         wcs * ((2.0f * v * cs - 2.0f * u) * rb2);
  w[2] = (coeff * lum + wcs) * d_ss_c;
  w[3] = (coeff * lum + wcs) * d_dd_c;
}

// The NaN tiles of a block (output rows y0 .. y0 + vh - 1, columns x0 ..
// x0 + vw - 1, tiles TH x kTileW) that a non-finite input at virtual row
// vi, image column xv reaches: those whose pixels lie within 2r of it; bit
// 2 * tile row + tile column (rare path). The relaxed stream's; the
// standard stream keeps the same code inline (mark_bad), as calling these
// changed its instantiations' SASS.
__device__ __forceinline__ unsigned nan_tile_bits(int vi, int xv, int y0, int x0,
                                                  int vh, int vw, int H, int W,
                                                  int TH, int r) {
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
  return bits;
}

// NaN over the tiles set in `bad` (nan_tile_bits) of a block's vh x vw
// outputs at da / db + base, by its nt threads (after every finite write of
// the block: the caller's last barrier).
__device__ __forceinline__ void poison_tiles(unsigned bad, float* da, float* db,
                                             size_t base, int y0, int x0, int vh,
                                             int vw, int W, int TH, int tid, int nt) {
  const float nan = __int_as_float(0x7fc00000);
  for (int i = tid; i < vh * vw; i += nt) {
    const int y = i / vw;
    const int x = i - y * vw;
    if ((bad >> (2 * (y / TH) + x / kTileW)) & 1u) {
      const size_t p = base + (size_t)(y0 + y) * (size_t)W + (size_t)(x0 + x);
      da[p] = nan;
      db[p] = nan;
    }
  }
}

// Sets a kernel's dynamic shared-memory limit once per instantiation,
// device and size (the largest asked so far), not on every launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int (&done)[64],
                       std::mutex& mu) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < 64 && (int)bytes <= done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = (int)bytes;
  return err;
}

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

// ---------------------------------------------------------------------------
// The relaxed tier at radius 5: row-streaming column strips, every band pass
// a bf16x3 band product on the tensor cores.

// The block: a strip of kStripW output columns down a segment of rows, as in
// the standard stream, advancing kRelChunk stream rows a step (the mma's N:
// 8 lines of a horizontal pass, 8 outputs of a vertical one); kRelWarps
// warps, warp w the 16-column tile w of the strip's kRelMidW mid columns
// (kStripW + 2r, rounded up to tiles) in the vertical passes and of its
// output columns in the horizontal adjoint. The vertical passes' inputs
// (the horizontal blurs, the weight maps) are kept split, bf16 hi and lo,
// in rings of kRelRing rows per warp; the horizontal passes' inputs (the
// staged rows, the vertical adjoints) in f32, split as they are loaded,
// once per value.
constexpr int kRelR = kWindowRadius;
constexpr int kRelChunk = 8;
constexpr int kRelWarps = 9;
constexpr int kRelThreads = 32 * kRelWarps;
constexpr int kRelBlocks = 2;
constexpr int kRelKs = band_mma::ksteps(kRelR);
constexpr int kRelRing = kRelChunk + 2 * kRelR;   // a vertical pass's input rows
constexpr int kRelMidW = 16 * kRelWarps;
constexpr int kRelInCols = kStripW + 4 * kRelR;   // staged input columns
// Row pitches: staged rows of float2 {a, b} (16-byte loads of rows g and
// g + 1 fall 64 bytes apart), vertical-adjoint rows of f32 (8-byte loads
// of rows g .. g + 3 fall in different banks).
constexpr int kRelInW = 168;
constexpr int kRelVtW = 152;
constexpr int kRelItems = kRelChunk * kRelInCols;
constexpr int kRelLoads = (kRelItems + kRelThreads - 1) / kRelThreads;
// One warp's ring: 4 planes x {hi, lo} x kRelRing rows x 16 bf16.
constexpr int kRelRingHalfs = 4 * 2 * kRelRing * 16;
static_assert(kRelKs == 2, "two k-steps of 16 inputs at radius 5");
static_assert(kRelMidW >= kStripW + 2 * kRelR && kRelMidW - 16 < kStripW + 2 * kRelR,
              "one warp per 16-column tile of the mid columns");
static_assert(16 * (kRelWarps - 1) + 32 <= kRelInW, "the horizontal blur's reads");
static_assert(kStripW + 16 <= kRelVtW && kRelMidW <= kRelVtW,
              "the horizontal adjoint's reads");
static_assert(kRelChunk + 2 * kRelR <= 24, "a vertical pass's inputs in 1.5 k-steps");

// Dynamic shared memory, in bytes: the staged rows, later the vertical
// adjoints, in one region; the two rings; the clamp-fold sums of the first and last image
// rows, f32 per plane and mid column; the band's fragments, as the A
// operand (hi, lo per k-step: uint4 a lane) and as the B operand (uint2).
constexpr int kRelXvBytes = 8 * kRelChunk * kRelInW > 16 * kRelChunk * kRelVtW
                                ? 8 * kRelChunk * kRelInW
                                : 16 * kRelChunk * kRelVtW;
constexpr int kRelRingBytes = 2 * kRelWarps * kRelRingHalfs;
constexpr int kRelFoldBytes = 4 * 2 * 4 * kRelMidW;
constexpr int kRelBandBytes = (16 + 8) * 2 * kRelKs * 32;
constexpr int kRelSmemBytes =
    kRelXvBytes + 2 * kRelRingBytes + kRelFoldBytes + kRelBandBytes;

// Row `slot` of one plane part of a ring (kRelRing rows of 16 bf16, 32
// bytes), 8-column half c: the halves swap in rows 4-7 of every 8, so that
// 8 consecutive rows of one half lie in 8 different 16-byte bank groups
// for ldmatrix and stmatrix.
__device__ __forceinline__ uint16_t* ring_row(uint16_t* part, int slot, int c) {
  return part + slot * 16 + ((c ^ ((slot >> 2) & 1)) << 3);
}

// TH: the NaN tile's height; S: the segment's rows (a multiple of TH, at
// most kMaxSegTiles tiles). Stream row s is virtual row y0 - 2r + s, mid
// row i virtual row y0 - r + i, output row y image row y0 + y. Chunk ch
// stages and blurs across stream rows 8 ch .. 8 ch + 7, blurs down onto
// mid rows 8 ch - 2r .. + 7 (the weight maps), and takes the vertical and
// horizontal adjoints of output rows 8 ch - 4r .. + 7 (da, db).
template <bool kGmap>
__global__ void __launch_bounds__(kRelThreads, kRelBlocks)
ssim_bwd_relaxed_stream_kernel(const float* __restrict__ a, const float* __restrict__ b,
                               const float* __restrict__ w_s,
                               const float* __restrict__ w_cs,
                               const float* __restrict__ gmap, float* __restrict__ da,
                               float* __restrict__ db, Halo halo, int H, int W, int TH,
                               int S, int nstrip, int nseg, Coeffs co, float c1,
                               float c2, float clip_bound) {
  constexpr int r = kRelR;
  constexpr int C = kRelChunk;
  constexpr int R = kRelRing;
  constexpr int kNT = kRelThreads;
  constexpr int kKs = kRelKs;
  extern __shared__ __align__(16) unsigned char rel_smem[];
  float2* xin = reinterpret_cast<float2*>(rel_smem);  // [C][kRelInW]
  float* vt = reinterpret_cast<float*>(rel_smem);     // [4][C][kRelVtW]
  uint16_t* hring = reinterpret_cast<uint16_t*>(rel_smem + kRelXvBytes);
  uint16_t* wring = hring + kRelWarps * kRelRingHalfs;
  float* fold = reinterpret_cast<float*>(wring + kRelWarps * kRelRingHalfs);  // [2][4][kRelMidW]
  uint4* band_a = reinterpret_cast<uint4*>(fold + 2 * 4 * kRelMidW);  // [2 kKs][32]
  uint2* band_b = reinterpret_cast<uint2*>(band_a + 2 * kKs * 32);    // [2 kKs][32]
  __shared__ unsigned s_bad;  // bit 2 * tile row + tile column

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // Zeros everywhere: rows and columns past the valid ones are read as
  // products with zeros of the band, so they must be finite.
  for (int i = tid; i < (kRelSmemBytes - kRelBandBytes) / 16; i += kNT) {
    reinterpret_cast<uint4*>(rel_smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) s_bad = 0u;
  if (warp == 0) {
    const band_mma::Band<kKs> ba = band_mma::make_band<kKs>(co.t, r);
    const band_mma::BandB<kKs> bb = band_mma::make_band_b<kKs>(co.t, r);
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      band_a[ks * 32 + lane] =
          make_uint4(ba.hi[ks][0], ba.hi[ks][1], ba.hi[ks][2], ba.hi[ks][3]);
      band_a[(kKs + ks) * 32 + lane] =
          make_uint4(ba.lo[ks][0], ba.lo[ks][1], ba.lo[ks][2], ba.lo[ks][3]);
      band_b[ks * 32 + lane] = make_uint2(bb.hi[ks][0], bb.hi[ks][1]);
      band_b[(kKs + ks) * 32 + lane] = make_uint2(bb.lo[ks][0], bb.lo[ks][1]);
    }
  }
  // Before the first stage, which may mark tiles in s_bad.
  __syncthreads();

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
  const int n = vh + 4 * r;  // stream rows
  const int nchunk = (n + C - 1) / C;

  // Stage 0: a chunk's stream rows loaded into registers (fetch), then
  // staged (stage), sanitised, as {a, b}; input column j is image column
  // x0 - 2r + j, clamped. A thread's item q is element tid + q kNT of the
  // chunk's C x kRelInCols.
  float pa[kRelLoads], pb[kRelLoads];
  auto item = [&](int ch, int q, int& row, int& j, int& s) {
    const int it = tid + q * kNT;
    row = it / kRelInCols;
    j = it - row * kRelInCols;
    s = ch * C + row;
    return it < kRelItems && s < n && j < vw + 4 * r;
  };
  auto fetch = [&](int ch) {
#pragma unroll
    for (int q = 0; q < kRelLoads; ++q) {
      int row, j, s;
      if (item(ch, q, row, j, s)) {
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
        const int gx = min(max(x0 - 2 * r + j, 0), W - 1);
        pa[q] = __ldg(ra + gx);
        pb[q] = __ldg(rb + gx);
      }
    }
  };
  auto stage = [&](int ch) {
#pragma unroll
    for (int q = 0; q < kRelLoads; ++q) {
      int row, j, s;
      if (item(ch, q, row, j, s)) {
        const float va = pa[q], vb = pb[q];
        if (!(finite_f32(va) && finite_f32(vb))) {
          const unsigned bits = nan_tile_bits(y0 - 2 * r + s, x0 - 2 * r + j, y0, x0, vh,
                                              vw, H, W, TH, r);
          if (bits) atomicOr(&s_bad, bits);
        }
        xin[row * kRelInW + j] =
            make_float2(sanitize(va, clip_bound), sanitize(vb, clip_bound));
      }
    }
  };

  auto band_a_of = [&](int ks, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
    const uint4 h = band_a[ks * 32 + lane], l = band_a[(kKs + ks) * 32 + lane];
    hi[0] = h.x, hi[1] = h.y, hi[2] = h.z, hi[3] = h.w;
    lo[0] = l.x, lo[1] = l.y, lo[2] = l.z, lo[3] = l.w;
  };
  // This lane's ring rows for ldmatrix / stmatrix: lane 8 mi + mj gives row
  // mj of matrix mi.
  const int mi = lane >> 3, mj = lane & 7;
  uint16_t* const hmine = hring + warp * kRelRingHalfs;
  uint16_t* const wmine = wring + warp * kRelRingHalfs;
  auto part = [&](uint16_t* mine, int p, int lo) { return mine + (2 * p + lo) * R * 16; };
  auto slot_of = [&](int row) { return (row + 4 * R) % R; };  // rows >= -4R

  // The four planes' accumulators of a tile, stored split into a ring at
  // rows row0 + k: element e of acc[p] is column g + 8 (e >> 1) of the
  // tile, row 2t + (e & 1).
  auto store_split = [&](uint16_t* mine, int row0, const float(&acc)[4][4]) {
    const int sl = slot_of(row0 + mj);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t f[4];  // hi of columns 0-7, 8-15, lo of columns 0-7, 8-15
      band_mma::split2(acc[p][0], acc[p][1], f[0], f[2]);
      band_mma::split2(acc[p][2], acc[p][3], f[1], f[3]);
      band_mma::stsm_x4_trans(ring_row(part(mine, p, mi >> 1), sl, mi & 1), f);
    }
  };

  // Stage 1a: the horizontal blur of the chunk's 8 staged rows (the mma
  // lines) onto mid columns 16 warp .. + 15, the four planes a, b, (a+b)^2,
  // (a-b)^2 formed and split as the staged columns are loaded; into the
  // blur ring at stream rows 8 ch + k.
  auto hblur = [&](int ch) {
    float acc[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      uint32_t ah[4], al[4];
      band_a_of(ks, ah, al);
      // Row g, input columns 16 (warp + ks) + 2t, + 1 and + 8, + 9.
      const float2* src = xin + g * kRelInW + 16 * (warp + ks) + 2 * t;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(src + 8 * q);
        const float s0 = v.x + v.y, s1 = v.z + v.w;
        const float d0 = v.x - v.y, d1 = v.z - v.w;
        band_mma::split2(v.x, v.z, bh[0][q], bl[0][q]);
        band_mma::split2(v.y, v.w, bh[1][q], bl[1][q]);
        band_mma::split2(s0 * s0, s1 * s1, bh[2][q], bl[2][q]);
        band_mma::split2(d0 * d0, d1 * d1, bh[3][q], bl[3][q]);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        band_mma::mma(acc[p], ah, bl[p][0], bl[p][1]);
        band_mma::mma(acc[p], al, bh[p][0], bh[p][1]);
        band_mma::mma(acc[p], ah, bh[p][0], bh[p][1]);
      }
    }
    store_split(hmine, ch * C, acc);
  };

  // A vertical pass down this warp's 16 columns: outputs row0 + k (k < 8)
  // from ring rows row0 .. row0 + 2r + 7, the data as the A operand (16
  // columns x 16 rows a k-step, ldmatrix.trans from the split ring), the
  // band as B; element e of acc[p] is column g + 8 (e >> 1), output
  // row0 + 2t + (e & 1). The second k-step's rows 8-15 lie past the inputs
  // (zeros of the band) and are not loaded.
  auto vpass = [&](uint16_t* mine, int row0, float(&acc)[4][4]) {
    uint32_t bh[kKs][2], bl[kKs][2];
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      const uint2 h = band_b[ks * 32 + lane], l = band_b[(kKs + ks) * 32 + lane];
      bh[ks][0] = h.x, bh[ks][1] = h.y, bl[ks][0] = l.x, bl[ks][1] = l.y;
    }
    const int sl0 = slot_of(row0 + mj + 8 * (mi >> 1));
    const int sl1 = slot_of(row0 + 16 + mj);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t xh[kKs][4], xl[kKs][4];
      band_mma::ldsm_x4_trans(xh[0], ring_row(part(mine, p, 0), sl0, mi & 1));
      band_mma::ldsm_x4_trans(xl[0], ring_row(part(mine, p, 1), sl0, mi & 1));
      uint32_t h2[2], l2[2];
      band_mma::ldsm_x2_trans(h2, ring_row(part(mine, p, 0), sl1, mi & 1));
      band_mma::ldsm_x2_trans(l2, ring_row(part(mine, p, 1), sl1, mi & 1));
      xh[1][0] = h2[0], xh[1][1] = h2[1], xh[1][2] = 0u, xh[1][3] = 0u;
      xl[1][0] = l2[0], xl[1][1] = l2[1], xl[1][2] = 0u, xl[1][3] = 0u;
      acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kKs; ++ks) {
        band_mma::mma(acc[p], xl[ks], bh[ks][0], bh[ks][1]);
        band_mma::mma(acc[p], xh[ks], bl[ks][0], bl[ks][1]);
        band_mma::mma(acc[p], xh[ks], bh[ks][0], bh[ks][1]);
      }
    }
  };

  // Stage 1b: the vertical blur onto mid rows i0 = 8 ch - 2r .. + 7 and the
  // weight maps there (zero by index outside the segment's mid rows and the
  // image), into the weight ring. The clamp-fold sums of the first (last) r
  // image rows, when this segment holds image row 0 (H - 1) at a flagged
  // edge: sum_e cl[e] W(row e) (W(row H - 1 - e)), one row at a time in the
  // order of the rows.
  auto vblur = [&](int ch) {
    const int i0 = ch * C - 2 * r;
    float acc[4][4];
    vpass(hmine, i0, acc);
    float wv[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 16 * warp + g + 8 * (e >> 1);
      const int i = i0 + 2 * t + (e & 1);
      const int gx = x0 - r + c;
      const int my = y0 - r + i;
      const bool outside = i < 0 || i >= vh + 2 * r || c >= vw + 2 * r || gx < 0 ||
                           gx >= W || (my < 0 && edge_top) || (my >= H && edge_bot);
      float w4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (!outside) {
        float coeff = ws;
        if constexpr (kGmap) coeff = ws + __ldg(gmap + base + (size_t)my * (size_t)W + gx);
        weights4(acc[0][e], acc[1][e], acc[2][e], acc[3][e], coeff, wcs, c1, c2, w4);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) wv[p][e] = w4[p];
    }
    const bool ftop = edge_top && y0 == 0 && i0 < 2 * r && i0 + C > r;
    const bool fbot = edge_bot && y0 + vh == H && i0 < vh + r && i0 + C > vh;
    if (ftop || fbot) {  // rare path, the same for the warp's lanes
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 16 * warp + g + 8 * h;
          float ft = fold[p * kRelMidW + c];
          float fb = fold[(4 + p) * kRelMidW + c];
#pragma unroll
          for (int k = 0; k < C; ++k) {
            const float v =
                __shfl_sync(0xffffffffu, wv[p][2 * h + (k & 1)], 4 * g + (k >> 1));
            const int i = i0 + k;
            if (ftop && i >= r && i < 2 * r) ft = ft + co.cl[i - r] * v;
            if (fbot && i >= vh && i < vh + r) fb = fb + co.cl[vh + r - 1 - i] * v;
          }
          if (t == 0) {
            fold[p * kRelMidW + c] = ft;
            fold[(4 + p) * kRelMidW + c] = fb;
          }
        }
      }
    }
    store_split(wmine, i0, wv);
  };

  // Stage 2a: the vertical adjoint onto output rows 8 ch - 4r .. + 7 at this
  // warp's mid columns, with the clamp fold at image rows 0 and H - 1, into
  // vt (f32).
  auto vadjoint = [&](int ch) {
    const int yb = ch * C - 4 * r;
    float acc[4][4];
    vpass(wmine, yb, acc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 16 * warp + g + 8 * (e >> 1);
      const int k = 2 * t + (e & 1);
      const int y = y0 + yb + k;  // image row
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float v = acc[p][e];
        if (y == 0 && edge_top) v = v + fold[p * kRelMidW + c];
        if (y == H - 1 && edge_bot) v = v + fold[(4 + p) * kRelMidW + c];
        vt[(p * C + k) * kRelVtW + c] = v;
      }
    }
  };

  // Stage 2b and da/db: the horizontal adjoint of vt's 8 rows (the mma
  // lines) onto output columns 16 warp .. + 15, with the fold at image
  // columns 0 and W - 1; a and b read again (sanitised) for da/db.
  auto hadjoint = [&](int ch) {
    const int yb = ch * C - 4 * r;
    float acc[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      uint32_t ah[4], al[4];
      band_a_of(ks, ah, al);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float* src = vt + (p * C + g) * kRelVtW + 16 * (warp + ks) + 2 * t;
        const float2 v0 = *reinterpret_cast<const float2*>(src);
        const float2 v1 = *reinterpret_cast<const float2*>(src + 8);
        uint32_t bh0, bh1, bl0, bl1;
        band_mma::split2(v0.x, v0.y, bh0, bl0);
        band_mma::split2(v1.x, v1.y, bh1, bl1);
        band_mma::mma(acc[p], ah, bl0, bl1);
        band_mma::mma(acc[p], al, bh0, bh1);
        band_mma::mma(acc[p], ah, bh0, bh1);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 16 * warp + g + 8 * (e >> 1);
      const int k = 2 * t + (e & 1);
      const int y = yb + k;
      if (x >= vw || y < 0 || y >= vh) continue;
      float g4[4] = {acc[0][e], acc[1][e], acc[2][e], acc[3][e]};
      const int gx = x0 + x;
      // The fold: image column q at mid column x + r + q from column 0,
      // W - 1 - q at x + r - q from column W - 1.
      auto hfold = [&](int sign) {
        float cr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int q = 0; q < r; ++q) {
          const float f = co.cl[q];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            cr[p] += f * vt[(p * C + k) * kRelVtW + x + r + sign * q];
          }
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) g4[p] += cr[p];
      };
      if (gx == 0) hfold(1);
      if (gx == W - 1) hfold(-1);
      const size_t pix = base + (size_t)(y0 + y) * (size_t)W + (size_t)gx;
      const float av = sanitize(__ldg(a + pix), clip_bound);
      const float bv = sanitize(__ldg(b + pix), clip_bound);
      const float sm = av + bv;
      const float df = av - bv;
      da[pix] = g4[0] + 2.0f * sm * g4[2] + 2.0f * df * g4[3];
      db[pix] = g4[1] + 2.0f * sm * g4[2] - 2.0f * df * g4[3];
    }
  };

  // Four barriers a chunk: after the staging (the horizontal blur reads
  // every warp's columns), after the horizontal blur (vt overwrites the
  // staged rows), after the vertical passes (the horizontal adjoint reads
  // the next warp's columns) and after the horizontal adjoint (the next
  // staging overwrites vt). Each warp's rings are its own: __syncwarp
  // between its vertical passes.
  fetch(0);
  for (int ch = 0; ch < nchunk; ++ch) {
    stage(ch);
    if (ch + 1 < nchunk) fetch(ch + 1);
    __syncthreads();
    hblur(ch);
    __syncthreads();
    const bool adj = ch * C - 4 * r + C > 0;  // output rows >= 0 in this chunk
    if (ch * C - 2 * r + C > 0) {
      vblur(ch);
      __syncwarp();
    }
    if (adj) vadjoint(ch);
    __syncthreads();
    if (adj && warp < kStripW / 16 && 16 * warp < vw) hadjoint(ch);
    __syncthreads();
  }

  // NaN over the tiles a non-finite input reached (after every finite
  // write of this block: the last chunk ended with a barrier).
  const unsigned bad = s_bad;
  if (bad) poison_tiles(bad, da, db, base, y0, x0, vh, vw, W, TH, tid, kNT);
}

template <bool kGmap>
cudaError_t prepare_relaxed_stream() {
  static int done[64] = {};
  static std::mutex mu;
  return allow_smem(ssim_bwd_relaxed_stream_kernel<kGmap>, kRelSmemBytes, done, mu);
}

template <bool kGmap>
cudaError_t launch_relaxed_stream(const float* a, const float* b, const float* w_s,
                                  const float* w_cs, const float* gmap, float* da,
                                  float* db, const Halo& halo, int B, int H, int W,
                                  int TH, int S, const Coeffs& co, float c1, float c2,
                                  float clip_bound, cudaStream_t stream) {
  const int nstrip = (W + kStripW - 1) / kStripW;
  const int nseg = (H + S - 1) / S;
  const long long blocks = (long long)B * nseg * nstrip;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = prepare_relaxed_stream<kGmap>();
  if (err != cudaSuccess) return err;
  ssim_bwd_relaxed_stream_kernel<kGmap>
      <<<(unsigned)blocks, kRelThreads, kRelSmemBytes, stream>>>(
          a, b, w_s, w_cs, gmap, da, db, halo, H, W, TH, S, nstrip, nseg, co, c1, c2,
          clip_bound);
  return cudaGetLastError();
}

template <bool kGmap>
cudaError_t relaxed_stream_occupancy(int* blocks_per_sm) {
  cudaError_t err = prepare_relaxed_stream<kGmap>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ssim_bwd_relaxed_stream_kernel<kGmap>, kRelThreads, kRelSmemBytes);
}

// ---------------------------------------------------------------------------
// The relaxed tier at the other radii: one output tile per block, every band
// pass a bf16x3 band product on the tensor cores.

// Stores the weight maps at mid position o of the four planes.
__device__ __forceinline__ void store_weights(float* wm, int mid_plane, int o,
                                              float u, float v, float ss,
                                              float dd, float coeff, float wcs,
                                              float c1, float c2) {
  float w[4];
  weights4(u, v, ss, dd, coeff, wcs, c1, c2, w);
#pragma unroll
  for (int p = 0; p < 4; ++p) wm[p * mid_plane + o] = w[p];
}

// Shared-memory floats of one block: region X holds the a/b halo tile, then
// the four weight-map planes; region Y holds the four horizontally blurred
// planes, then the four vertical-adjoint planes. Mirrored by smem_bytes in
// ops/ssim_grad.py.
__host__ __device__ inline int region_x_floats(int TH, int TW, int r) {
  const int in = 2 * (TH + 4 * r) * (TW + 4 * r);
  const int mid = 4 * (TH + 2 * r) * (TW + 2 * r);
  return in > mid ? in : mid;
}
__host__ __device__ inline int region_y_floats(int TH, int TW, int r) {
  return 4 * (TH + 4 * r) * (TW + 2 * r);
}

template <bool kGmap, int kSplit>
__global__ void __launch_bounds__(kThreads)
ssim_bwd_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ w_s, const float* __restrict__ w_cs,
                     const float* __restrict__ gmap, float* __restrict__ da,
                     float* __restrict__ db, Halo halo, int H, int W, int r,
                     int TH, int TW, int ntx, int tiles_per_image, Coeffs co,
                     float c1, float c2, float clip_bound) {
  static_assert(kSplit > 0, "the tile kernel serves the relaxed tier only");
  extern __shared__ float smem[];
  __shared__ float s_t[kMaxTaps];
  __shared__ float s_cl[kMaxRadius];

  const int HC = TW + 4 * r;  // halo tile columns (row stride)
  const int MC = TW + 2 * r;  // mid-region columns (row stride)
  const int in_plane = (TH + 4 * r) * HC;
  const int hp_plane = (TH + 4 * r) * MC;
  const int mid_plane = (TH + 2 * r) * MC;
  const int vt_plane = TH * MC;
  float* sa = smem;            // stage 0-1: halo tiles
  float* sb = sa + in_plane;
  float* wm = smem;            // stage 1-2: weight maps W_u, W_v, W_ss, W_dd
  float* hp = smem + region_x_floats(TH, TW, r);  // stage 1: u, v, ss, dd rows
  float* vt = hp;              // stage 2: vertical adjoints

  const int tid = threadIdx.x;
  if (tid < kMaxTaps) s_t[tid] = co.t[tid];
  if (tid < kMaxRadius) s_cl[tid] = co.cl[tid];

  const int tile = blockIdx.x;
  const int img = tile / tiles_per_image;
  const int rem = tile - img * tiles_per_image;
  const int y0 = (rem / ntx) * TH;
  const int x0 = (rem % ntx) * TW;
  const int vh = min(TH, H - y0);  // valid output rows of this tile
  const int vw = min(TW, W - x0);  // valid output columns
  const size_t base = (size_t)img * (size_t)H * (size_t)W;
  const float ws = w_s[img];
  const float wcs = w_cs[img];
  const bool vhalo = halo.at != nullptr;
  const bool edge_top = !vhalo || halo.is_top;
  const bool edge_bot = !vhalo || halo.is_bot;

  // Stage 0: the halo tile, each row from the image (clamped) or from a
  // halo operand, each column clamped; sanitised.
  const int lr = vh + 4 * r;
  const int lc = vw + 4 * r;
  int bad = 0;
  for (int i = tid; i < lr * lc; i += kThreads) {
    const int ly = i / lc;
    const int lx = i - ly * lc;
    const int uy = y0 - 2 * r + ly;
    const int gx = min(max(x0 - 2 * r + lx, 0), W - 1);
    const float* pa = a;
    const float* pb = b;
    size_t p;
    if (uy < 0 && !edge_top) {
      p = ((size_t)img * 2 * r + (size_t)(uy + 2 * r)) * (size_t)W + (size_t)gx;
      pa = halo.at;
      pb = halo.bt;
    } else if (uy >= H && !edge_bot) {
      p = ((size_t)img * 2 * r + (size_t)(uy - H)) * (size_t)W + (size_t)gx;
      pa = halo.ab;
      pb = halo.bb;
    } else {
      const int gy = min(max(uy, 0), H - 1);
      p = base + (size_t)gy * (size_t)W + (size_t)gx;
    }
    const float va = pa[p];
    const float vb = pb[p];
    if (!(finite_f32(va) && finite_f32(vb))) bad = 1;
    sa[ly * HC + lx] = sanitize(va, clip_bound);
    sb[ly * HC + lx] = sanitize(vb, clip_bound);
  }
  bad = __syncthreads_or(bad);

  // Every band pass of stages 1a-2b runs as bf16x3 band products on the
  // tensor cores (band_mma::sweep, all four planes at once): the horizontal
  // passes with columns along the sweep and rows across it, the vertical
  // ones with rows along and columns across. Each output's epilogue is the
  // standard pass's. This thread's place in the fragments (lane = 4 grp +
  // tig).
  const int grp = (tid & 31) >> 2, tig = tid & 3;

  // Stage 1a: horizontal blur of the four signals over every halo row, at
  // the mid columns.
  const int mc = vw + 2 * r;
  band_mma::for_jobs(lr, (mc + 15) >> 4, [&](int strip, int t0, int t1) {
    const int row = min(8 * strip + grp, lr - 1) * HC;
    band_mma::sweep<4, kSplit>(
        s_t, r, t0, t1,
        [&](int c, float(&v)[4]) {
          float x = 0.0f, y = 0.0f;
          if (c < lc) {
            x = sa[row + c];
            y = sb[row + c];
          }
          const float s = x + y, d = x - y;
          v[0] = x;
          v[1] = y;
          v[2] = s * s;
          v[3] = d * d;
        },
        [&](int ti, const float(&acc)[4][4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int mx = 16 * ti + grp + 8 * (e >> 1);
            const int ly = 8 * strip + 2 * tig + (e & 1);
            if (ly < lr && mx < mc) {
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                hp[k * hp_plane + ly * MC + mx] = acc[k][e];
              }
            }
          }
        });
  });
  __syncthreads();

  // Stage 1b: vertical blur at the mid rows, then the weight maps.
  const int mr = vh + 2 * r;
  // Mid positions outside the image (rows beyond a flagged edge) carry
  // zero weight, set by index.
  auto outside = [&](int gy, int gx) {
    return (gy < 0 && edge_top) || (gy >= H && edge_bot) || gx < 0 || gx >= W;
  };
  auto coeff_at = [&](int gy, int gx) {
    float coeff = ws;
    if (kGmap) coeff = ws + gmap[base + (size_t)gy * (size_t)W + (size_t)gx];
    return coeff;
  };
  band_mma::for_jobs(mc, (mr + 15) >> 4, [&](int strip, int t0, int t1) {
    const int col = min(8 * strip + grp, mc - 1);
    band_mma::sweep<4, kSplit>(
        s_t, r, t0, t1,
        [&](int ly, float(&v)[4]) {
          const float* c = hp + ly * MC + col;
#pragma unroll
          for (int p = 0; p < 4; ++p) v[p] = ly < lr ? c[p * hp_plane] : 0.0f;
        },
        [&](int ti, const float(&acc)[4][4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int my = 16 * ti + grp + 8 * (e >> 1);
            const int mx = 8 * strip + 2 * tig + (e & 1);
            if (my >= mr || mx >= mc) continue;
            const int gy = y0 - r + my;
            const int gx = x0 - r + mx;
            const int o = my * MC + mx;
            if (outside(gy, gx)) {
#pragma unroll
              for (int p = 0; p < 4; ++p) wm[p * mid_plane + o] = 0.0f;
              continue;
            }
            store_weights(wm, mid_plane, o, acc[0][e], acc[1][e], acc[2][e],
                          acc[3][e], coeff_at(gy, gx), wcs, c1, c2);
          }
        });
  });
  __syncthreads();

  // Stage 2a: vertical adjoint onto the tile's own rows, at the mid
  // columns. Zeroed out-of-image weights make the plain part the
  // zero-extended symmetric blur; rows 0 and H-1 add the folded clamp mass.
  // vfold: that fold, for tile row y (image row gy) at mid column mx.
  auto vfold = [&](float acc, const float* plane, int gy, int mx) {
    if (gy == 0 && edge_top) {  // mid row of image row g is g + r here
      float corr = 0.0f;
      for (int g = 0; g < r; ++g) corr += s_cl[g] * plane[(r + g) * MC + mx];
      acc += corr;
    }
    if (gy == H - 1 && edge_bot) {  // row H-1-x at mid row H-1-x-y0+r
      float corr = 0.0f;
      for (int x = 0; x < r; ++x) {
        corr += s_cl[x] * plane[(H - 1 - x - y0 + r) * MC + mx];
      }
      acc += corr;
    }
    return acc;
  };
  band_mma::for_jobs(mc, (vh + 15) >> 4, [&](int strip, int t0, int t1) {
    const int col = min(8 * strip + grp, mc - 1);
    band_mma::sweep<4, kSplit>(
        s_t, r, t0, t1,
        [&](int my, float(&v)[4]) {
          const float* c = wm + my * MC + col;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            v[p] = my < mr ? c[p * mid_plane] : 0.0f;
          }
        },
        [&](int ti, const float(&acc)[4][4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int y = 16 * ti + grp + 8 * (e >> 1);
            const int mx = 8 * strip + 2 * tig + (e & 1);
            if (y >= vh || mx >= mc) continue;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              vt[k * vt_plane + y * MC + mx] =
                  vfold(acc[k][e], wm + k * mid_plane, y0 + y, mx);
            }
          }
        });
  });
  __syncthreads();

  // Stage 2b: horizontal adjoint onto the tile's own columns, with the
  // fold at columns 0 and W-1 (hfold, for tile column x of a row of vt),
  // then da/db (store_grads).
  auto hfold = [&](float acc, const float* row, int x) {
    const int gx = x0 + x;
    if (gx == 0) {
      float corr = 0.0f;
      for (int g = 0; g < r; ++g) corr += s_cl[g] * row[r + g];
      acc += corr;
    }
    if (gx == W - 1) {
      float corr = 0.0f;
      for (int q = 0; q < r; ++q) corr += s_cl[q] * row[W - 1 - q - x0 + r];
      acc += corr;
    }
    return acc;
  };
  auto store_grads = [&](const float (&g4)[4], int y, int x) {
    const size_t p = base + (size_t)(y0 + y) * (size_t)W + (size_t)(x0 + x);
    const float av = sanitize(a[p], clip_bound);
    const float bv = sanitize(b[p], clip_bound);
    const float s = av + bv;
    const float d = av - bv;
    float ga = g4[0] + 2.0f * s * g4[2] + 2.0f * d * g4[3];
    float gb = g4[1] + 2.0f * s * g4[2] - 2.0f * d * g4[3];
    if (bad) {
      ga = __int_as_float(0x7fc00000);  // NaN
      gb = ga;
    }
    da[p] = ga;
    db[p] = gb;
  };
  band_mma::for_jobs(vh, (vw + 15) >> 4, [&](int strip, int t0, int t1) {
    const int row = min(8 * strip + grp, vh - 1) * MC;
    band_mma::sweep<4, kSplit>(
        s_t, r, t0, t1,
        [&](int c, float(&v)[4]) {
          const float* src = vt + row + c;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            v[p] = c < mc ? src[p * vt_plane] : 0.0f;
          }
        },
        [&](int ti, const float(&acc)[4][4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 16 * ti + grp + 8 * (e >> 1);
            const int y = 8 * strip + 2 * tig + (e & 1);
            if (y >= vh || x >= vw) continue;
            float g4[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              g4[k] = hfold(acc[k][e], vt + k * vt_plane + y * MC, x);
            }
            store_grads(g4, y, x);
          }
        });
  });
}

template <bool kGmap, int kSplit>
cudaError_t launch_tile(const float* a, const float* b, const float* w_s,
                        const float* w_cs, const float* gmap, float* da,
                        float* db, const Halo& halo, int B, int H, int W, int r,
                        int TH, int TW, const Coeffs& co, float c1, float c2,
                        float clip_bound, cudaStream_t stream) {
  static int done[64] = {};
  static std::mutex mu;
  if (TH < 1 || TW < 1) return cudaErrorInvalidValue;
  const int ntx = (W + TW - 1) / TW;
  const int nty = (H + TH - 1) / TH;
  const int tiles_per_image = ntx * nty;
  const long long blocks = (long long)B * tiles_per_image;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * ((size_t)region_x_floats(TH, TW, r) +
                                       (size_t)region_y_floats(TH, TW, r));
  cudaError_t err =
      allow_smem(ssim_bwd_tile_kernel<kGmap, kSplit>, smem, done, mu);
  if (err != cudaSuccess) return err;
  ssim_bwd_tile_kernel<kGmap, kSplit>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(
          a, b, w_s, w_cs, gmap, da, db, halo, H, W, r, TH, TW, ntx,
          tiles_per_image, co, c1, c2, clip_bound);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes. relaxed: 1 for the relaxed mode, else 0. a, b, da,
// db: (B, H, W) f32; w_s, w_cs: (B,) f32 on the device; gmap: (B, H, W)
// f32 or NULL. a_top, a_bot, b_top, b_bot: the halo operands, (B, 2r, W)
// f32, all four or none, never with gmap; is_top, is_bot: their flags (0
// or 1). TH x TW: the NaN tile (default_tile), also the relaxed kernel's
// output tile; S: the standard kernel's segment rows (a multiple of TH, at
// most 16 tiles; TW must be 64 there), unused by the relaxed one. taps_host:
// 2r+1 floats and fold_host: r floats, in host memory. Returns the launch's
// cudaError_t.
extern "C" int ssim_bwd_launch(int relaxed, const void* a, const void* b,
                               const void* w_s, const void* w_cs,
                               const void* gmap, void* da,
                               void* db, const void* a_top, const void* a_bot,
                               const void* b_top, const void* b_bot,
                               int is_top, int is_bot, int B, int H, int W,
                               int r, int TH, int TW, int S,
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
  const bool seg_ok = TW == kTileW && S >= TH && S % TH == 0 && S / TH <= kMaxSegTiles;
  if (relaxed && r == kRelR) {
    if (!seg_ok) return cudaErrorInvalidValue;
    return fg ? launch_relaxed_stream<true>(fa, fb, fws, fwcs, fg, fda, fdb, halo, B, H, W,
                                            TH, S, co, c1, c2, clip_bound, s)
              : launch_relaxed_stream<false>(fa, fb, fws, fwcs, fg, fda, fdb, halo, B, H,
                                             W, TH, S, co, c1, c2, clip_bound, s);
  }
  const int split = relaxed ? band_mma::ksteps(r) : 0;
  if (split) {
#define SSIM_BWD_TILE(G, K)                                                  \
  return launch_tile<G, K>(fa, fb, fws, fwcs, fg, fda, fdb, halo, B, H, W, r, \
                           TH, TW, co, c1, c2, clip_bound, s)
    if (fg) {
      if (split == 2) SSIM_BWD_TILE(true, 2);
      SSIM_BWD_TILE(true, 3);
    }
    if (split == 2) SSIM_BWD_TILE(false, 2);
    SSIM_BWD_TILE(false, 3);
#undef SSIM_BWD_TILE
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
// takes, the standard one (relaxed = 0) or the relaxed one (relaxed = 1,
// radius 5 only). Returns a cudaError_t.
extern "C" int ssim_bwd_stream_occupancy(int relaxed, int r, int gmap, int* blocks_per_sm) {
  if (r < 1 || r > kMaxRadius || (relaxed && r != kRelR)) return cudaErrorInvalidValue;
  if (relaxed) {
    return gmap ? relaxed_stream_occupancy<true>(blocks_per_sm)
                : relaxed_stream_occupancy<false>(blocks_per_sm);
  }
  if (r == kWindowRadius) {
    return gmap ? stream_occupancy<kWindowRadius, true>(r, blocks_per_sm)
                : stream_occupancy<kWindowRadius, false>(r, blocks_per_sm);
  }
  return gmap ? stream_occupancy<0, true>(r, blocks_per_sm)
              : stream_occupancy<0, false>(r, blocks_per_sm);
}
