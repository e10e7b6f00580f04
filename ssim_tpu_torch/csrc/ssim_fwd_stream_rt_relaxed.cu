// The relaxed tier's row stream at a radius read at run time: the
// instantiations ssim_fwd_stream_kernel<T, kMode, kSplit, 0>
// (fwd_stream_kernel.cuh) of the relaxed score, map, components and pooled
// modes, kSplit = band_mma::ksteps(r) (2 up to radius 8, 3 up to 16), which
// serve every radius from 1 to kMaxStreamR but kStreamR (ssim_fwd.cu keeps
// its register-window instantiations there). A translation unit of its own,
// so that the build's one nvcc process per source compiles these beside the
// others.
//
// Replaces, at those radii, the relaxed tile body (ssim_fwd_kernel<T, mode,
// kSplit> in ssim_fwd.cu) as the counterpart of the JAX package's relaxed
// tier with a custom window: ssim_tpu/ops/ssim_pallas.py::_make_hpass_mxu
// (:168, exact=False, built at any radius) in _nopad_overlap_call (:710) and
// _chunked_overlap_call (:1409): the same modes, outputs and numerics (the
// heavy horizontal blurs as bf16x3 band products, band_mma.cuh; mu_a, mu_b,
// the vertical pass and the formulas in f32).
//
// What bounds it: as at kStreamR, the mma that a warp issues in a step and
// the step's one barrier (the 24 mma of two rows' heavy blurs go to all four
// warps every other step; 36 at three k-steps from radius 9), and here also
// shared memory, as in the standard runtime-radius stream: a ring of the
// last 2r + 1 rows' four blurs (mu_a, mu_b from the f32 pass, (a+b)^2 and
// (a-b)^2 from the band products), one float4 a column a row, written once
// a step and read 2r + 1 times by the vertical blur, beside the mu pass's
// 2r + 1 8-byte loads a pixel. Its shared memory, 9 KB of staged rows and
// heavy blurs plus 2 KB a ring slot, grows with r, so blocks per SM fall
// from the registers' 7 (6 in the components modes) at small radii to 2 at
// radius 16. What the design does about it against the tile body: each
// input pixel is staged once per segment instead of once per tile plus its
// halo ((TH + 2r)(TW + 2r) inputs for TH TW outputs, 3x at radius 16), and
// each row's heavy blurs are one band product of the strip's 8 column
// tiles, made once.

#include "fwd_stream_rt.cuh"

namespace {

template <int kMode>
cudaError_t launch_relaxed_rt(int is_float, const void* a, const void* b, void* partials,
                              void* map, void* pool_a, void* pool_b, int B, int H, int W,
                              int r, int TH, int TW, int seg, const double* taps_host,
                              double c1, double c2, float clip_bound, cudaStream_t s) {
  // No halo operands: the relaxed tier has no row modes.
#define SSIM_FWD_RT_RELAXED(K)                                                           \
  return is_float ? launch_stream_rt<float, kMode, K>(a, b, partials, map, pool_a, pool_b, \
                                                      nullptr, Halo<float>{}, B, H, W, r,  \
                                                      TH, TW, seg, taps_host, c1, c2,      \
                                                      clip_bound, s)                       \
                  : launch_stream_rt<uint8_t, kMode, K>(a, b, partials, map, pool_a,       \
                                                        pool_b, nullptr, Halo<uint8_t>{},  \
                                                        B, H, W, r, TH, TW, seg,           \
                                                        taps_host, c1, c2, clip_bound, s);
  if (band_mma::ksteps(r) == 2) SSIM_FWD_RT_RELAXED(2)
  SSIM_FWD_RT_RELAXED(3)
#undef SSIM_FWD_RT_RELAXED
}

template <int kMode>
cudaError_t occupancy_relaxed_rt(int is_float, int r, int* blocks_per_sm) {
  if (band_mma::ksteps(r) == 2) {
    return is_float ? occupancy_rt<float, kMode, 2>(r, blocks_per_sm)
                    : occupancy_rt<uint8_t, kMode, 2>(r, blocks_per_sm);
  }
  return is_float ? occupancy_rt<float, kMode, 3>(r, blocks_per_sm)
                  : occupancy_rt<uint8_t, kMode, 3>(r, blocks_per_sm);
}

}  // namespace

// ssim_fwd_launch's relaxed streaming launches at a radius other than
// kStreamR (its arguments, checked there): modes 0-3, 1 <= r <= kMaxStreamR,
// no halo operands. Returns the launch's cudaError_t.
extern "C" int ssim_fwd_stream_rt_relaxed_launch(int mode, int is_float, const void* a,
                                                 const void* b, void* partials, void* map,
                                                 void* pool_a, void* pool_b, int B, int H,
                                                 int W, int r, int TH, int TW, int seg,
                                                 const double* taps_host, double c1,
                                                 double c2, float clip_bound, void* stream) {
  if (r < 1 || r > kMaxStreamR) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSIM_FWD_RT_RELAXED_MODE(M)                                                  \
  case M:                                                                            \
    return launch_relaxed_rt<M>(is_float, a, b, partials, map, pool_a, pool_b, B, H, W, \
                                r, TH, TW, seg, taps_host, c1, c2, clip_bound, s);
  switch (mode) {
    SSIM_FWD_RT_RELAXED_MODE(kScore)
    SSIM_FWD_RT_RELAXED_MODE(kMap)
    SSIM_FWD_RT_RELAXED_MODE(kComponents)
    SSIM_FWD_RT_RELAXED_MODE(kPooled)
    default:
      return cudaErrorInvalidValue;
  }
#undef SSIM_FWD_RT_RELAXED_MODE
}

// Blocks of the relaxed runtime-radius stream that one SM of the current
// device holds at once in `mode` (0-3) at radius r (its dynamic shared
// memory included), for uint8 (is_float = 0) or float32 inputs. Returns a
// cudaError_t.
extern "C" int ssim_fwd_stream_rt_relaxed_occupancy(int mode, int is_float, int r,
                                                    int* blocks_per_sm) {
  if (r < 1 || r > kMaxStreamR) return cudaErrorInvalidValue;
  switch (mode) {
    case kScore:
      return occupancy_relaxed_rt<kScore>(is_float, r, blocks_per_sm);
    case kMap:
      return occupancy_relaxed_rt<kMap>(is_float, r, blocks_per_sm);
    case kComponents:
      return occupancy_relaxed_rt<kComponents>(is_float, r, blocks_per_sm);
    case kPooled:
      return occupancy_relaxed_rt<kPooled>(is_float, r, blocks_per_sm);
    default:
      return cudaErrorInvalidValue;
  }
}
