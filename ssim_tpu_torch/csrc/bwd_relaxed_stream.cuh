// The relaxed tier's backward stream: row-streaming column strips, every
// band pass a bf16x3 band product on the tensor cores (band_mma.cuh), at
// every radius 1-16, in two kernels of one body: ssim_bwd_relaxed_stream_kernel
// (radius 5 compiled in, instantiated by ssim_bwd.cu) and
// ssim_bwd_relaxed_rt_kernel (the radius read at run time, instantiated by
// ssim_bwd_relaxed_rt.cu), each translation unit of its own.
//
// Replaces ssim_tpu/ops/ssim_grad.py::_grad_call's relaxed mode
// (use_mxu: the split band matmuls of :324-328 and the vpass of :500-516,
// built at any radius). What bounds it: the mma (16 band passes of
// ksteps(r) or fewer k-steps a tile) and the four barriers of every 8 rows,
// and the shared memory of its two rings, 256 (8 + 2r) bytes a warp each,
// which sets the blocks per SM: 2 at 128 columns up to radius 5, and fewer
// from 6 up (RelGeom). What the design does about it: the strip narrows to
// one 64-column tile (kSW), which halves the rings' warps, where that keeps
// more blocks on an SM (ops/ssim_grad.py relaxed_strip_w, measured on an
// H100); the k-step counts are compile-time per group of radii (kG), the
// radius itself a runtime value.
#pragma once

#include "band_mma.cuh"
#include "bwd_common.cuh"

namespace {

// The block: a strip of kSW output columns (kStripW, or one NaN tile of
// kTileW at large radii) down a segment of rows, as in the standard
// stream, advancing kRelChunk stream rows a step (the mma's N: 8 lines of a
// horizontal pass, 8 outputs of a vertical one); Geo::kWarps warps, warp w
// the 16-column tile w of the strip's kMidW mid columns (kSW + 2r, rounded
// up to tiles) in the vertical passes and of its output columns in the
// horizontal adjoint. The vertical passes' inputs (the horizontal blurs,
// the weight maps) are kept split, bf16 hi and lo, in rings of 8 + 2r rows
// per warp; the horizontal passes' inputs (the staged rows, the vertical
// adjoints) in f32, split as they are loaded, once per value.
constexpr int kRelR = kWindowRadius;
constexpr int kRelChunk = 8;
constexpr int kRelBlocks = 2;

// The groups of 8 rows a vertical pass reads at radius r: 8 + 2r rows, 2
// up to radius 4, 3 up to 8, 4 up to 12, 5 up to 16.
__host__ __device__ constexpr int rel_groups(int r) { return 1 + (r + 3) / 4; }

// The geometry of the radii of kG groups (up to kMaxR = 4 (kG - 1)) at a
// strip of kSW columns: the horizontal passes' k-steps (band_mma::ksteps,
// 2 up to radius 8, 3 up to 16), the vertical ones' (kG / 2 rounded up),
// the warps, one per 16-column tile of the mid columns, and the row
// pitches: staged rows of float2 {a, b} (16-byte loads of rows g and g + 1
// fall 64 bytes apart: kInW = 8 mod 16) and vertical-adjoint rows of f32
// (8-byte loads of rows g .. g + 3 fall in different banks: kVtW = 8 or 24
// mod 32), each covering its pass's reads. Dynamic shared memory, in
// bytes: the staged rows, later the vertical adjoints, in one region
// (kXvBytes); the two rings (rel_smem_bytes); the clamp-fold sums of the
// first and last image rows, f32 per plane and mid column; the band's
// fragments, as the A operand (hi, lo per k-step: uint4 a lane) and as the
// B operand (uint2).
template <int kG, int kSW>
struct RelGeom {
  static constexpr int kMaxR = 4 * (kG - 1);
  static constexpr int kKh = band_mma::ksteps(kMaxR);
  static constexpr int kKv = (kG + 1) / 2;
  static constexpr int kWarps = kSW / 16 + kKh - 1;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMidW = 16 * kWarps;
  static constexpr int kInW = kSW + 32 * kKh - 24;
  static constexpr int kVtW = kSW + 16 * kKh - 8;
  static constexpr int kXvBytes = 8 * kRelChunk * kInW > 16 * kRelChunk * kVtW
                                      ? 8 * kRelChunk * kInW
                                      : 16 * kRelChunk * kVtW;
  static constexpr int kFoldBytes = 4 * 2 * 4 * kMidW;
  static constexpr int kBandBytes = (16 * kKh + 8 * kKv) * 2 * 32;
  static_assert(kG >= 2 && kG <= rel_groups(kMaxRadius) && kSW % kTileW == 0 &&
                    kSW <= kStripW, "a group of radii, a strip of whole NaN tiles");
  static_assert(kMidW >= kSW + 2 * kMaxR && kMidW - 16 < kSW + 2 * (4 * kG - 7),
                "one warp per 16-column tile of the mid columns");
  static_assert(16 * (kWarps - 1) + 16 * kKh <= kInW && kSW + 4 * kMaxR <= kInW,
                "the horizontal blur's reads");
  static_assert(kSW + 16 * (kKh - 1) <= kVtW && kMidW <= kVtW,
                "the horizontal adjoint's reads");
  static_assert(kInW % 16 == 8 && kVtW % 16 == 8, "the pitches' banks");
};

// The dynamic shared memory of a block at radius r (RelGeom).
template <int kG, int kSW>
__host__ __device__ constexpr int rel_smem_bytes(int r) {
  using Geo = RelGeom<kG, kSW>;
  return Geo::kXvBytes + 2 * (2 * Geo::kWarps * 4 * 2 * (kRelChunk + 2 * r) * 16) +
         Geo::kFoldBytes + Geo::kBandBytes;
}

// Row `slot` of one plane part of a ring (8 + 2r rows of 16 bf16, 32
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
// horizontal adjoints of output rows 8 ch - 4r .. + 7 (da, db). The two
// kernels share one body (bwd_relaxed_stream_body.cuh).

// Radius 5 (kRelR) compiled in, at a strip of kStripW columns.
template <bool kGmap>
__global__ void __launch_bounds__(RelGeom<rel_groups(kRelR), kStripW>::kThreads, kRelBlocks)
ssim_bwd_relaxed_stream_kernel(const float* __restrict__ a, const float* __restrict__ b,
                               const float* __restrict__ w_s,
                               const float* __restrict__ w_cs,
                               const float* __restrict__ gmap, float* __restrict__ da,
                               float* __restrict__ db, Halo halo, int H, int W, int TH,
                               int S, int nstrip, int nseg, Coeffs co, float c1,
                               float c2, float clip_bound) {
  constexpr int kG = rel_groups(kRelR), kSW = kStripW;
  using Geo = RelGeom<kG, kSW>;
  constexpr int r = kRelR;
  constexpr int C = kRelChunk;
  constexpr int R = C + 2 * r;
  constexpr int kNT = Geo::kThreads;
  constexpr int kKh = Geo::kKh, kKv = Geo::kKv;
  constexpr int kWarps = Geo::kWarps, kInW = Geo::kInW, kVtW = Geo::kVtW;
  constexpr int kMidW = Geo::kMidW, kXvBytes = Geo::kXvBytes;
  constexpr int ring_halfs = 4 * 2 * R * 16;
  constexpr int in_cols = kSW + 4 * r;
  constexpr int items = C * in_cols;
  constexpr int kLoads = (items + kNT - 1) / kNT;
  constexpr int zeros = (rel_smem_bytes<kG, kSW>(r) - Geo::kBandBytes) / 16;
#include "bwd_relaxed_stream_body.cuh"
}

// Radius r_rt (1 to kMaxRadius) read at run time, kG = rel_groups(r_rt), at
// a strip of kSW columns.
template <int kG, int kSW, bool kGmap>
__global__ void __launch_bounds__(RelGeom<kG, kSW>::kThreads, kRelBlocks)
ssim_bwd_relaxed_rt_kernel(const float* __restrict__ a, const float* __restrict__ b,
                           const float* __restrict__ w_s, const float* __restrict__ w_cs,
                           const float* __restrict__ gmap, float* __restrict__ da,
                           float* __restrict__ db, Halo halo, int H, int W, int TH, int S,
                           int nstrip, int nseg, Coeffs co, float c1, float c2,
                           float clip_bound, int r_rt) {
  using Geo = RelGeom<kG, kSW>;
  const int r = r_rt;
  constexpr int C = kRelChunk;
  const int R = C + 2 * r;
  constexpr int kNT = Geo::kThreads;
  constexpr int kKh = Geo::kKh, kKv = Geo::kKv;
  constexpr int kWarps = Geo::kWarps, kInW = Geo::kInW, kVtW = Geo::kVtW;
  constexpr int kMidW = Geo::kMidW, kXvBytes = Geo::kXvBytes;
  const int ring_halfs = 4 * 2 * R * 16;
  const int in_cols = kSW + 4 * r;
  const int items = C * in_cols;
  constexpr int kLoads = (C * (kSW + 4 * Geo::kMaxR) + kNT - 1) / kNT;
  const int zeros = (rel_smem_bytes<kG, kSW>(r) - Geo::kBandBytes) / 16;
#include "bwd_relaxed_stream_body.cuh"
}

// Launchers from here (the host build of the kernel's source,
// tests/fwd_stream_emu, takes what is above).

// kR: kRelR (ssim_bwd_relaxed_stream_kernel, kG and kSW its own) or 0
// (ssim_bwd_relaxed_rt_kernel<kG, kSW, kGmap>).
template <int kR, int kG, int kSW, bool kGmap>
constexpr auto relaxed_kernel() {
  if constexpr (kR > 0) {
    return ssim_bwd_relaxed_stream_kernel<kGmap>;
  } else {
    return ssim_bwd_relaxed_rt_kernel<kG, kSW, kGmap>;
  }
}

template <int kR, int kG, int kSW, bool kGmap>
cudaError_t prepare_relaxed_stream(int r, size_t* smem) {
  static int done[64] = {};
  static std::mutex mu;
  *smem = rel_smem_bytes<kG, kSW>(r);
  return allow_smem(relaxed_kernel<kR, kG, kSW, kGmap>(), *smem, done, mu);
}

// r: the radius (kR where kR > 0).
template <int kR, int kG, int kSW, bool kGmap>
cudaError_t launch_relaxed_stream(const float* a, const float* b, const float* w_s,
                                  const float* w_cs, const float* gmap, float* da,
                                  float* db, const Halo& halo, int B, int H, int W,
                                  int r, int TH, int S, const Coeffs& co, float c1,
                                  float c2, float clip_bound, cudaStream_t stream) {
  static_assert(kR == 0 || (kR == kRelR && kG == rel_groups(kRelR) && kSW == kStripW),
                "radius 5 compiled in at its own geometry");
  if ((kR > 0 && r != kR) || rel_groups(r) != kG) return cudaErrorInvalidValue;
  const int nstrip = (W + kSW - 1) / kSW;
  const int nseg = (H + S - 1) / S;
  const long long blocks = (long long)B * nseg * nstrip;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  size_t smem = 0;
  cudaError_t err = prepare_relaxed_stream<kR, kG, kSW, kGmap>(r, &smem);
  if (err != cudaSuccess) return err;
  constexpr int kThreads = RelGeom<kG, kSW>::kThreads;
  if constexpr (kR > 0) {
    ssim_bwd_relaxed_stream_kernel<kGmap><<<(unsigned)blocks, kThreads, smem, stream>>>(
        a, b, w_s, w_cs, gmap, da, db, halo, H, W, TH, S, nstrip, nseg, co, c1, c2,
        clip_bound);
  } else {
    ssim_bwd_relaxed_rt_kernel<kG, kSW, kGmap><<<(unsigned)blocks, kThreads, smem, stream>>>(
        a, b, w_s, w_cs, gmap, da, db, halo, H, W, TH, S, nstrip, nseg, co, c1, c2,
        clip_bound, r);
  }
  return cudaGetLastError();
}

template <int kR, int kG, int kSW, bool kGmap>
cudaError_t relaxed_stream_occupancy(int r, int* blocks_per_sm) {
  size_t smem = 0;
  cudaError_t err = prepare_relaxed_stream<kR, kG, kSW, kGmap>(r, &smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, relaxed_kernel<kR, kG, kSW, kGmap>(), RelGeom<kG, kSW>::kThreads, smem);
}

}  // namespace
