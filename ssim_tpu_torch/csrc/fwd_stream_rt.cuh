// The runtime-radius row stream's launch helpers (ssim_fwd_stream_kernel<T,
// kMode, kSplit, 0>, fwd_stream_kernel.cuh): its dynamic shared memory, the
// limit set once per device, the launch and the occupancy query. Included by
// ssim_fwd_stream_rt.cu (the standard, row, components and precise modes,
// kSplit = 0) and ssim_fwd_stream_rt_relaxed.cu (the relaxed modes, kSplit =
// band_mma::ksteps(r)), each a translation unit of its own.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "fwd_common.cuh"
#include "fwd_stream_kernel.cuh"

namespace {

// Dynamic shared memory of the runtime-radius stream at radius r: the
// window's ring, 2r + 1 slots of one Vec4 of the blurs' type per thread;
// relaxed (kSplit > 0) the staged rows and the ring of
// stream_rt_relaxed_smem_bytes (tests/test_torch_port_cuda.py holds the
// occupancy each leaves against this model on an H100).
template <typename P, int kSplit>
size_t stream_rt_smem_bytes(int r) {
  if (kSplit > 0) return stream_rt_relaxed_smem_bytes(r);
  return (size_t)(2 * r + 1) * kStreamThreads * 4 * sizeof(P);
}

// The instantiation's dynamic shared-memory limit, set once per device and
// size (the largest asked so far), not on every launch: at every size, for
// the static shared memory counts against the default 48 KB too.
template <typename T, int kMode, int kSplit>
cudaError_t prepare_rt(int r, size_t* smem) {
  static int done[64] = {};
  static std::mutex mu;
  *smem = stream_rt_smem_bytes<Blur<kMode>, kSplit>(r);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < 64 && (int)*smem <= done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(ssim_fwd_stream_kernel<T, kMode, kSplit, 0>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (err == cudaSuccess && dev < 64) done[dev] = (int)*smem;
  return err;
}

template <typename T, int kMode, int kSplit>
cudaError_t launch_stream_rt(const void* a, const void* b, void* partials, void* map,
                             void* pool_a, void* pool_b, void* scratch,
                             const Halo<T>& halo, int B, int H, int W, int r, int TH,
                             int TW, int S, const double* taps_host, double c1, double c2,
                             float clip_bound, cudaStream_t stream) {
  using P = Blur<kMode>;
  constexpr bool kRows = kMode == kRowsum || kMode == kRowsumMap;
  if (kMode == kPooled && ((TH | TW) & 1)) return cudaErrorInvalidValue;
  // The f32 modes round the taps and c1, c2 to float; the precise modes
  // keep the f64 taps and the unrounded constants.
  StreamTaps<P, 0> tp;
  for (int k = 0; k < kMaxTaps; ++k) tp.t[k] = k < 2 * r + 1 ? (P)taps_host[k] : P(0);
  tp.r = r;
  const int nstrip = (W + kStripW - 1) / kStripW;
  const int nseg = (H + S - 1) / S;
  const int ntx = (W + TW - 1) / TW;
  const int nty = (H + TH - 1) / TH;
  const long long blocks = (long long)B * nseg * nstrip;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  size_t smem = 0;
  cudaError_t err = prepare_rt<T, kMode, kSplit>(r, &smem);
  if (err != cudaSuccess) return err;
  ssim_fwd_stream_kernel<T, kMode, kSplit, 0>
      <<<(unsigned)blocks, kStreamThreads, smem, stream>>>(
          static_cast<const T*>(a), static_cast<const T*>(b), static_cast<P*>(partials),
          static_cast<float*>(map), static_cast<float*>(scratch), halo, H, W, TH, TW, S,
          nstrip, nseg, ntx, nty, tp, (P)c1, (P)c2, clip_bound, static_cast<float*>(pool_a),
          static_cast<float*>(pool_b));
  err = cudaGetLastError();
  if (err != cudaSuccess || !kRows) return err;
  const long long n = (long long)B * H;
  rowsum_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                         stream>>>(static_cast<const float*>(scratch),
                                   static_cast<float*>(partials), B, ntx, H,
                                   (float)W);
  return cudaGetLastError();
}

template <typename T, int kMode, int kSplit>
cudaError_t occupancy_rt(int r, int* blocks_per_sm) {
  size_t smem = 0;
  cudaError_t err = prepare_rt<T, kMode, kSplit>(r, &smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ssim_fwd_stream_kernel<T, kMode, kSplit, 0>, kStreamThreads, smem);
}

}  // namespace
