// The batch modes' packed row stream at a radius read at run time: the
// instantiations ssim_fwd_batch_stream_kernel<T, kMode, kSplit, 0>
// (fwd_batch_kernel.cuh) of kBatch, kBatchPrecise and the relaxed kBatch
// (kSplit = band_mma::ksteps(r): 2 up to radius 8, 3 up to 16), which serve
// every radius from 1 to kMaxStreamR but kStreamR (ssim_fwd_batch.cu keeps
// its register-window instantiations there). A translation unit of its own,
// so that the build's one nvcc process per source compiles these beside the
// others.
//
// Replaces, at those radii, the tile body's batch branch (ssim_fwd_kernel in
// ssim_fwd.cu, ops/ssim_cuda.batch_geometry's tiles) as the counterpart of
// ssim_tpu/ops/ssim_pallas.py::ssim_parts_pallas_bpacked (:2334) with a
// custom window: one [sum(ssim - 1), H W] pair per image (f32; f64 in
// kBatchPrecise; relaxed: the heavy horizontal blurs as bf16x3 band
// products), clamp-to-edge borders, a non-finite pixel poisoning its own
// image alone.
//
// What bounds it: as at kStreamR, the instructions a push issues and its
// one barrier, and here also shared memory: the window is a ring of the
// last 2r + 1 pushes' four horizontal blurs, this thread's column of each
// slot one float4 (fp64: two double2), written once a push and read 2r + 1
// times by the vertical blur, beside the horizontal blur's 2r + 1 reads of
// the staged row (relaxed: of {a, b} only). Its shared memory grows with r:
// the ring, 16 (2r + 1) bytes a thread (fp64 32), and the staged rows, 128
// + 2r columns a piece a strip meets (batch_rt_layout), so blocks per SM
// fall as r grows. What the design does about it against the tile body: a
// strip of 128 columns is filled by whole packed images (the tile body's
// tile is an image's width rounded up to a power of two), each input pixel
// is staged once per block instead of once per tile plus its halo ((TH + 2r)
// (TW + 2r) for TH TW outputs), the horizontal blur runs once a row, and an
// image's clamped rows repeat a push, not a blur.

#include <mutex>

#include "fwd_batch_kernel.cuh"

namespace {

// The instantiation's dynamic shared-memory limit, set once per device and
// size (the largest asked so far), not on every launch: at every size, for
// the static shared memory counts against the default 48 KB too.
template <typename T, int kMode, int kSplit>
cudaError_t prepare_batch_rt(int r, int W, int k, size_t* smem) {
  static int done[64] = {};
  static std::mutex mu;
  *smem = batch_rt_layout<Blur<kMode>, kSplit>(r, W, k).bytes;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < 64 && (int)*smem <= done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(ssim_fwd_batch_stream_kernel<T, kMode, kSplit, 0>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (err == cudaSuccess && dev < 64) done[dev] = (int)*smem;
  return err;
}

template <typename T, int kMode, int kSplit>
cudaError_t launch_batch_rt(const void* a, const void* b, void* partials, void* pieces, int B,
                            int H, int W, int k, int S, int r, const double* taps_host,
                            double c1, double c2, float clip_bound, cudaStream_t stream) {
  using P = Blur<kMode>;
  StreamTaps<P, 0> tp;
  for (int i = 0; i < kMaxTaps; ++i) tp.t[i] = i < 2 * r + 1 ? (P)taps_host[i] : P(0);
  tp.r = r;
  const int nstrip = (k * W + kStripW - 1) / kStripW;
  const int nseg = (H + S - 1) / S;
  const int nps = (W + kStripW - 1) / kStripW + 1;
  const long long blocks = (long long)nstrip * nseg * ((B + k - 1) / k);
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  size_t smem = 0;
  cudaError_t err = prepare_batch_rt<T, kMode, kSplit>(r, W, k, &smem);
  if (err != cudaSuccess) return err;
  ssim_fwd_batch_stream_kernel<T, kMode, kSplit, 0>
      <<<(unsigned)blocks, kStreamThreads, smem, stream>>>(
          static_cast<const T*>(a), static_cast<const T*>(b), static_cast<P*>(partials),
          static_cast<double*>(pieces), B, H, W, k, S, nstrip, nseg, nps, tp, (P)c1, (P)c2,
          clip_bound);
  return cudaGetLastError();
}

template <typename T, int kMode, int kSplit>
cudaError_t occupancy_batch_rt(int r, int W, int k, int* blocks_per_sm) {
  size_t smem = 0;
  cudaError_t err = prepare_batch_rt<T, kMode, kSplit>(r, W, k, &smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ssim_fwd_batch_stream_kernel<T, kMode, kSplit, 0>, kStreamThreads, smem);
}

}  // namespace

// ssim_fwd_batch_launch's first pass at a radius other than kStreamR (its
// arguments, checked there; 1 <= r <= kMaxStreamR). Returns the launch's
// cudaError_t.
extern "C" int ssim_fwd_batch_rt_launch(int precise, int relaxed, int is_float, const void* a,
                                        const void* b, void* partials, void* pieces, int B,
                                        int H, int W, int k, int S, int r,
                                        const double* taps_host, double c1, double c2,
                                        float clip_bound, void* stream) {
  if (r < 1 || r > kMaxStreamR || (precise && relaxed)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSIM_FWD_BATCH_RT(M, K)                                                          \
  return is_float ? launch_batch_rt<float, M, K>(a, b, partials, pieces, B, H, W, k, S, r, \
                                                 taps_host, c1, c2, clip_bound, s)         \
                  : launch_batch_rt<uint8_t, M, K>(a, b, partials, pieces, B, H, W, k, S,  \
                                                   r, taps_host, c1, c2, clip_bound, s);
  if (precise) SSIM_FWD_BATCH_RT(kBatchPrecise, 0)
  if (!relaxed) SSIM_FWD_BATCH_RT(kBatch, 0)
  if (band_mma::ksteps(r) == 2) SSIM_FWD_BATCH_RT(kBatch, 2)
  SSIM_FWD_BATCH_RT(kBatch, 3)
#undef SSIM_FWD_BATCH_RT
}

// Blocks of the runtime-radius batch stream that one SM of the current
// device holds at once (ssim_fwd_batch_occupancy's arguments at a radius
// other than kStreamR). Returns a cudaError_t.
extern "C" int ssim_fwd_batch_rt_occupancy(int precise, int relaxed, int is_float, int r,
                                           int W, int k, int* blocks_per_sm) {
  if (r < 1 || r > kMaxStreamR || (precise && relaxed)) return cudaErrorInvalidValue;
#define SSIM_FWD_BATCH_RT_OCC(M, K)                                            \
  return is_float ? occupancy_batch_rt<float, M, K>(r, W, k, blocks_per_sm)   \
                  : occupancy_batch_rt<uint8_t, M, K>(r, W, k, blocks_per_sm);
  if (precise) SSIM_FWD_BATCH_RT_OCC(kBatchPrecise, 0)
  if (!relaxed) SSIM_FWD_BATCH_RT_OCC(kBatch, 0)
  if (band_mma::ksteps(r) == 2) SSIM_FWD_BATCH_RT_OCC(kBatch, 2)
  SSIM_FWD_BATCH_RT_OCC(kBatch, 3)
#undef SSIM_FWD_BATCH_RT_OCC
}
