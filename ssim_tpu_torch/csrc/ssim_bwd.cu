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
//      block, four blocks per SM. Radii 1-4 run the same design with their
//      radius compiled in (ssim_bwd_rt.cu), every other radius a two-pass
//      stream through a scratch map of the weight maps (bwd_std_rt.cuh).
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

#include "bwd_std_stream.cuh"

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
// ssim_bwd_rt.cu: the standard launches at the other radii (the two-pass
// stream with scratch, else the one-pass stream where it is built).
extern "C" int ssim_bwd_std_rt_launch(const void* a, const void* b, const void* w_s,
                                      const void* w_cs, const void* gmap, void* da, void* db,
                                      const void* a_top, const void* a_bot, const void* b_top,
                                      const void* b_bot, int is_top, int is_bot, int B, int H,
                                      int W, int r, int TH, int S, void* scratch,
                                      const float* taps_host, const float* fold_host,
                                      float c1, float c2, float clip_bound, void* stream);
extern "C" int ssim_bwd_std_rt_occupancy(int r, int gmap, int two_pass, int* blocks_per_sm);

// C entry for ctypes. relaxed: 1 for the relaxed mode, else 0. a, b, da,
// db: (B, H, W) f32; w_s, w_cs: (B,) f32 on the device; gmap: (B, H, W)
// f32 or NULL. a_top, a_bot, b_top, b_bot: the halo operands, (B, 2r, W)
// f32, all four or none, never with gmap; is_top, is_bot: their flags (0
// or 1). TH x TW: the NaN tile (default_tile; TW must be 64); S: the
// segment rows (a multiple of TH, at most 16 tiles); SW: the strip
// columns, 128 (the standard stream's only strip), or 64 in the relaxed one
// (ops/ssim_grad.py relaxed_strip_w). scratch: NULL, or (the standard tier
// at a radius other than 5) the two-pass stream's scratch
// (ops/ssim_grad.py std_rt_scratch_bytes), which selects that design;
// without it a radius other than 5 runs the one-pass stream where
// ssim_bwd_rt.cu builds it. taps_host: 2r+1 floats and fold_host: r
// floats, in host memory. Returns the launch's cudaError_t.
extern "C" int ssim_bwd_launch(int relaxed, const void* a, const void* b,
                               const void* w_s, const void* w_cs,
                               const void* gmap, void* da,
                               void* db, const void* a_top, const void* a_bot,
                               const void* b_top, const void* b_bot,
                               int is_top, int is_bot, int B, int H, int W,
                               int r, int TH, int TW, int S, int SW,
                               void* scratch, const float* taps_host, const float* fold_host,
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
if (r == kWindowRadius) {
    if (scratch != nullptr) return cudaErrorInvalidValue;
    return fg ? launch_stream<kWindowRadius, true>(fa, fb, fws, fwcs, fg, fda, fdb, halo, B, H,
                                                   W, r, TH, S, co, c1, c2, clip_bound, s)
              : launch_stream<kWindowRadius, false>(fa, fb, fws, fwcs, fg, fda, fdb, halo, B,
                                                    H, W, r, TH, S, co, c1, c2, clip_bound, s);
  }
  return ssim_bwd_std_rt_launch(a, b, w_s, w_cs, gmap, da, db, a_top, a_bot, b_top, b_bot,
                                is_top, is_bot, B, H, W, r, TH, S, scratch, taps_host,
                                fold_host, c1, c2, clip_bound, stream);
}

// Blocks of a streaming kernel that one SM of the current device holds at
// once, for radius r with (gmap = 1) or without the g_map operand: the
// CUDA runtime's occupancy for the instantiation that ssim_bwd_launch
// takes, the standard one (relaxed = 0; SW 128; at a radius other than 5
// the design ssim_bwd_rt.cu routes there) or the relaxed one (relaxed = 1)
// at a strip of SW columns. Returns a cudaError_t.
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
  return ssim_bwd_std_rt_occupancy(r, gmap, -1, blocks_per_sm);
}

