// The relaxed backward's row stream at a radius read at run time: the
// instantiations ssim_bwd_relaxed_rt_kernel<kG, kSW, kGmap>
// (bwd_relaxed_stream.cuh) for the groups of radii kG = rel_groups(r) (2:
// radii 1-4, 3: 5-8, 4: 9-12, 5: 13-16) at the strips that
// ops/ssim_grad.py RELAXED_STRIP_W picks in them (128 columns at 1-4 and
// 12-15, 64 at 6-11 and 16; measured on an H100), with and without g_map,
// which serve every radius from 1 to kMaxRadius but 5 (ssim_bwd.cu keeps
// its instantiation with the radius compiled in; radius 5 at the 64-column
// strip runs here too). A translation unit of its own, so that the build's
// one nvcc process per source compiles these beside ssim_bwd.cu's.
//
// The counterpart, at those radii, of ssim_tpu/ops/ssim_grad.py::
// _grad_call's relaxed mode with a custom window (ssim_loss's radius and
// sigma): the same gradients, NaN tiles and halo operands.

#include "bwd_relaxed_stream.cuh"

namespace {

template <int kG, int kSW>
cudaError_t launch_group(const float* a, const float* b, const float* w_s,
                         const float* w_cs, const float* gmap, float* da, float* db,
                         const Halo& halo, int B, int H, int W, int r, int TH, int S,
                         const Coeffs& co, float c1, float c2, float clip_bound,
                         cudaStream_t stream) {
  return gmap ? launch_relaxed_stream<0, kG, kSW, true>(a, b, w_s, w_cs, gmap, da, db, halo,
                                                         B, H, W, r, TH, S, co, c1, c2,
                                                         clip_bound, stream)
              : launch_relaxed_stream<0, kG, kSW, false>(a, b, w_s, w_cs, gmap, da, db,
                                                          halo, B, H, W, r, TH, S, co, c1,
                                                          c2, clip_bound, stream);
}

template <int kG, int kSW>
cudaError_t occupancy_group(int r, int gmap, int* blocks_per_sm) {
  return gmap ? relaxed_stream_occupancy<0, kG, kSW, true>(r, blocks_per_sm)
              : relaxed_stream_occupancy<0, kG, kSW, false>(r, blocks_per_sm);
}

}  // namespace

// ssim_bwd_launch's relaxed streaming launches at a strip of SW columns
// (128 or 64) other than radius 5's compiled-in one (its arguments, checked
// there): 1 <= r <= kMaxRadius, at an instantiated group and strip (else
// cudaErrorInvalidValue). Returns the launch's cudaError_t.
extern "C" int ssim_bwd_relaxed_rt_launch(const void* a, const void* b, const void* w_s,
                                          const void* w_cs, const void* gmap, void* da,
                                          void* db, const void* a_top, const void* a_bot,
                                          const void* b_top, const void* b_bot, int is_top,
                                          int is_bot, int B, int H, int W, int r, int TH,
                                          int S, int SW, const float* taps_host,
                                          const float* fold_host, float c1, float c2,
                                          float clip_bound, void* stream) {
  if (r < 1 || r > kMaxRadius) return cudaErrorInvalidValue;
  Coeffs co;
  for (int k = 0; k < kMaxTaps; ++k) co.t[k] = k < 2 * r + 1 ? taps_host[k] : 0.0f;
  for (int k = 0; k < kMaxRadius; ++k) co.cl[k] = k < r ? fold_host[k] : 0.0f;
  const Halo halo{static_cast<const float*>(a_top), static_cast<const float*>(a_bot),
                  static_cast<const float*>(b_top), static_cast<const float*>(b_bot),
                  is_top, is_bot};
#define SSIM_BWD_RT(G, SWC)                                                              \
  if (rel_groups(r) == G && SW == SWC) {                                                 \
    return launch_group<G, SWC>(                                                         \
        static_cast<const float*>(a), static_cast<const float*>(b),                      \
        static_cast<const float*>(w_s), static_cast<const float*>(w_cs),                 \
        static_cast<const float*>(gmap), static_cast<float*>(da), static_cast<float*>(db), \
        halo, B, H, W, r, TH, S, co, c1, c2, clip_bound,                                 \
        static_cast<cudaStream_t>(stream));                                              \
  }
  SSIM_BWD_RT(2, 128)
  SSIM_BWD_RT(3, 64)
  SSIM_BWD_RT(4, 128)
  SSIM_BWD_RT(4, 64)
  SSIM_BWD_RT(5, 128)
  SSIM_BWD_RT(5, 64)
#undef SSIM_BWD_RT
  return cudaErrorInvalidValue;
}

// Blocks of the runtime-radius relaxed stream that one SM of the current
// device holds at once at radius r and a strip of SW columns (an
// instantiated group and strip), with (gmap = 1) or without the g_map
// operand, its dynamic shared memory at r included. Returns a cudaError_t.
extern "C" int ssim_bwd_relaxed_rt_occupancy(int r, int gmap, int SW, int* blocks_per_sm) {
  if (r < 1 || r > kMaxRadius) return cudaErrorInvalidValue;
#define SSIM_BWD_RT_OCC(G, SWC) \
  if (rel_groups(r) == G && SW == SWC) return occupancy_group<G, SWC>(r, gmap, blocks_per_sm);
  SSIM_BWD_RT_OCC(2, 128)
  SSIM_BWD_RT_OCC(3, 64)
  SSIM_BWD_RT_OCC(4, 128)
  SSIM_BWD_RT_OCC(4, 64)
  SSIM_BWD_RT_OCC(5, 128)
  SSIM_BWD_RT_OCC(5, 64)
#undef SSIM_BWD_RT_OCC
  return cudaErrorInvalidValue;
}
