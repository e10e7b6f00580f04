// The standard backward at every radius but 5: the two-pass row stream
// (bwd_std_rt.cuh: ssim_bwd_rt_weights_kernel<kGmap>, then
// ssim_bwd_rt_adjoint_kernel, through a scratch map of the weight maps on
// the mid grid) and, at the radii with_window_radius names, the one-pass stream with
// its weight-map window in registers (bwd_std_stream.cuh:
// ssim_bwd_stream_kernel<kR, kGmap>, radius 5's design with another radius
// compiled in). A translation unit of its own, so that the build's one nvcc
// process per source compiles these beside ssim_bwd.cu's, whose radius-5
// instantiations keep their code.
//
// The counterpart, at those radii, of ssim_tpu/ops/ssim_grad.py::_grad_call
// (:278) in its w_s, g_map, w_cs and vhalo / vmask modes with a custom
// window (ssim_loss's radius and sigma): the same gradients, NaN tiles and
// halo operands.

#include <type_traits>

#include "bwd_std_rt.cuh"
#include "bwd_std_stream.cuh"

namespace {

// The radii whose one-pass instantiation is built here, which it also
// serves when no scratch is given (mirrored by STD_WINDOW_RADII in
// ops/ssim_grad.py; measured faster than the two-pass stream there on an
// H100, PERF.md).
template <typename F>
cudaError_t with_window_radius(int r, F&& f) {
  switch (r) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ssim_bwd_launch's standard launches at a radius other than 5 (its
// arguments, checked there): with scratch (std_rt_scratch_bytes in
// ops/ssim_grad.py, 16-byte aligned) the two-pass stream, without it the
// one-pass stream at a radius it is built for (else cudaErrorInvalidValue).
// Returns the launch's cudaError_t.
extern "C" int ssim_bwd_std_rt_launch(const void* a, const void* b, const void* w_s,
                                      const void* w_cs, const void* gmap, void* da, void* db,
                                      const void* a_top, const void* a_bot, const void* b_top,
                                      const void* b_bot, int is_top, int is_bot, int B, int H,
                                      int W, int r, int TH, int S, void* scratch,
                                      const float* taps_host, const float* fold_host,
                                      float c1, float c2, float clip_bound, void* stream) {
  if (r < 1 || r > kMaxRadius) return cudaErrorInvalidValue;
  Coeffs co;
  for (int k = 0; k < kMaxTaps; ++k) co.t[k] = k < 2 * r + 1 ? taps_host[k] : 0.0f;
  for (int k = 0; k < kMaxRadius; ++k) co.cl[k] = k < r ? fold_host[k] : 0.0f;
  const Halo halo{static_cast<const float*>(a_top), static_cast<const float*>(a_bot),
                  static_cast<const float*>(b_top), static_cast<const float*>(b_bot),
                  is_top, is_bot};
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  const float* fws = static_cast<const float*>(w_s);
  const float* fwcs = static_cast<const float*>(w_cs);
  const float* fg = static_cast<const float*>(gmap);
  float* fda = static_cast<float*>(da);
  float* fdb = static_cast<float*>(db);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch != nullptr) {
    return fg ? launch_rt<true>(fa, fb, fws, fwcs, fg, fda, fdb, halo, B, H, W, r, TH, S, co,
                                c1, c2, clip_bound, scratch, s)
              : launch_rt<false>(fa, fb, fws, fwcs, fg, fda, fdb, halo, B, H, W, r, TH, S, co,
                                 c1, c2, clip_bound, scratch, s);
  }
  return with_window_radius(r, [&](auto R) {
    return fg ? launch_stream<decltype(R)::value, true>(fa, fb, fws, fwcs, fg, fda, fdb, halo, B, H, W, r,
                                             TH, S, co, c1, c2, clip_bound, s)
              : launch_stream<decltype(R)::value, false>(fa, fb, fws, fwcs, fg, fda, fdb, halo, B, H, W,
                                              r, TH, S, co, c1, c2, clip_bound, s);
  });
}

// Blocks that one SM of the current device holds at once at radius r, with
// (gmap = 1) or without the g_map operand: of the two-pass stream (two_pass
// = 1; the fewer of its two passes', each with its dynamic shared memory at
// r), of the one-pass stream where it is built (0), or of the design
// ssim_bwd_launch routes there (-1: the one-pass stream where it is built).
// Returns a cudaError_t.
extern "C" int ssim_bwd_std_rt_occupancy(int r, int gmap, int two_pass, int* blocks_per_sm) {
  if (r < 1 || r > kMaxRadius) return cudaErrorInvalidValue;
  if (two_pass < 0) {
    two_pass = with_window_radius(r, [](auto) { return cudaSuccess; }) != cudaSuccess;
  }
  if (two_pass) {
    return gmap ? rt_occupancy<true>(r, blocks_per_sm) : rt_occupancy<false>(r, blocks_per_sm);
  }
  return with_window_radius(r, [&](auto R) {
    return gmap ? stream_occupancy<decltype(R)::value, true>(r, blocks_per_sm)
                : stream_occupancy<decltype(R)::value, false>(r, blocks_per_sm);
  });
}
