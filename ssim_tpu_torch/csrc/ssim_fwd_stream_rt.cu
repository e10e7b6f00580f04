// The forward's row stream at a radius read at run time: the instantiations
// ssim_fwd_stream_kernel<T, kMode, 0, 0> (fwd_stream_kernel.cuh) of the
// standard tier's score, map and row modes, the MS-SSIM components and
// pooled modes and the precise tier's two modes, which serve every radius
// from 1 to kMaxStreamR but kStreamR (ssim_fwd.cu keeps its register-window
// instantiations there). A translation unit of its own, so that the build's
// one nvcc process per source compiles these beside ssim_fwd.cu's.
//
// Replaces, at those radii, the tile body (ssim_fwd_kernel in ssim_fwd.cu)
// as the counterpart of ssim_tpu/ops/ssim_pallas.py::_nopad_overlap_call
// (:710) and ::_chunked_overlap_call (:1364) with a custom window
// (compute_ssim's radius and sigma): the same modes, outputs and numerics,
// and the same one grid for every width.
//
// What bounds it: as at kStreamR, the instructions a step issues and its one
// barrier, and here also shared memory: the window is a ring of the last
// 2r + 1 rows' four horizontal blurs, this thread's column of each slot one
// float4 (fp64: two double2), written once a step and read 2r + 1 times by
// the vertical blur, beside the horizontal blur's 2r + 1 reads of the staged
// row: 2 (2r + 1) 16-byte loads a pixel (fp64 twice that). Its shared memory
// grows with r, 16 (2r + 1) bytes a thread (fp64 32), so blocks per SM fall
// from 8 (4 precise) at small radii to 3 (1) at radius 16. What the design
// does about it against the tile body: each input pixel is staged once per
// segment instead of once per tile plus its halo (the tile body stages
// (TH + 2r)(TW + 2r) for TH TW outputs, 3x at radius 16), the horizontal
// blur runs once a stream row, and no barrier separates the passes of a
// tile.

#include "fwd_stream_rt.cuh"

// ssim_fwd_launch's streaming launches at a radius other than kStreamR (its
// arguments, checked there): modes 0-5, 8 and 9, 1 <= r <= kMaxStreamR.
// Returns the launch's cudaError_t.
extern "C" int ssim_fwd_stream_rt_launch(int mode, int is_float, const void* a,
                                         const void* b, void* partials, void* map,
                                         void* pool_a, void* pool_b, void* scratch,
                                         const void* const* halo, int is_top, int is_bot,
                                         int B, int H, int W, int r, int TH, int TW,
                                         int seg, const double* taps_host, double c1,
                                         double c2, float clip_bound, void* stream) {
  if (r < 1 || r > kMaxStreamR) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSIM_FWD_RT(M)                                                               \
  case M:                                                                            \
    return is_float ? launch_stream_rt<float, M, 0>(a, b, partials, map, pool_a, pool_b,  \
                                                 scratch,                              \
                                                 make_halo<float>(halo, is_top, is_bot), \
                                                 B, H, W, r, TH, TW, seg, taps_host,   \
                                                 c1, c2, clip_bound, s)                \
                    : launch_stream_rt<uint8_t, M, 0>(                                    \
                          a, b, partials, map, pool_a, pool_b, scratch,                \
                          make_halo<uint8_t>(halo, is_top, is_bot), B, H, W, r, TH,    \
                          TW, seg, taps_host, c1, c2, clip_bound, s);
  switch (mode) {
    SSIM_FWD_RT(kScore)
    SSIM_FWD_RT(kMap)
    SSIM_FWD_RT(kRowsum)
    SSIM_FWD_RT(kRowsumMap)
    SSIM_FWD_RT(kPrecise)
    SSIM_FWD_RT(kPreciseMap)
    SSIM_FWD_RT(kComponents)
    SSIM_FWD_RT(kPooled)
    default:
      return cudaErrorInvalidValue;
  }
#undef SSIM_FWD_RT
}

// Blocks of the runtime-radius stream that one SM of the current device holds
// at once in `mode` at radius r (its dynamic shared memory included), for
// uint8 (is_float = 0) or float32 inputs. Returns a cudaError_t.
extern "C" int ssim_fwd_stream_rt_occupancy(int mode, int is_float, int r,
                                            int* blocks_per_sm) {
  if (r < 1 || r > kMaxStreamR) return cudaErrorInvalidValue;
#define SSIM_FWD_RT_OCC(M)                                               \
  case M:                                                                \
    return is_float ? occupancy_rt<float, M, 0>(r, blocks_per_sm)           \
                    : occupancy_rt<uint8_t, M, 0>(r, blocks_per_sm);
  switch (mode) {
    SSIM_FWD_RT_OCC(kScore)
    SSIM_FWD_RT_OCC(kMap)
    SSIM_FWD_RT_OCC(kRowsum)
    SSIM_FWD_RT_OCC(kRowsumMap)
    SSIM_FWD_RT_OCC(kPrecise)
    SSIM_FWD_RT_OCC(kPreciseMap)
    SSIM_FWD_RT_OCC(kComponents)
    SSIM_FWD_RT_OCC(kPooled)
    default:
      return cudaErrorInvalidValue;
  }
#undef SSIM_FWD_RT_OCC
}
