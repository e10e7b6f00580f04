// The batch modes' packed row stream: kBatch (standard and relaxed) and
// kBatchPrecise at radius kStreamR, the kernel (fwd_batch_kernel.cuh) with
// its window in registers, and the C entries of every radius (the others
// run its runtime-radius instantiation, ssim_fwd_batch_rt.cu).
//
// They run the row stream's steps (b)-(d) (fwd_stream.cuh) over batches of
// small images. Images lie k to a packed row, side by side
// (ssim_cuda.batch_pack: where W >= 12 is a multiple of 8, the smallest k
// whose row k W is a multiple of kStripW, as the TPU's bpack_count packs
// lanes; other widths floor(kStripW / W), at most 12, or 1); the packed
// rows are cut into strips of kStripW output columns, one thread each, so a
// strip may hold parts of several images and an image may span two or more
// strips. Each image's piece of a strip is staged with its own r clamped
// columns on each side (kBatchInW columns at most), so no pixel of one image
// enters another's horizontal blur, and nothing is padded in device memory.
// A block takes one strip of one packed row, down all its rows or, where
// the packed rows alone would leave the card idle, down a segment of S
// rows. The window starts at the images' top: the r clamped rows above row
// 0 are row 0's horizontal blur pushed again (the window's last slot
// copied), not staged or blurred again, and so the r rows below row H - 1;
// so a packed row costs H staged rows and H barriers. Each thread sums its
// column's ssim - 1 (kBatch: in f32 over at most kBatchRun rows, then into
// a double; kBatchPrecise in double); at the end a segmented warp reduction
// (each lane adds the lanes of its own piece, shuffles down by 1 .. 16) and
// then, in the thread of each piece's first column, the piece's warps in
// order form the block's sum of each image it meets. Where a block holds an
// image's every row and column, that thread writes the image's pair; else
// it writes its piece to a (B, nseg, nps) f64 array that
// batch_pieces_reduce_kernel adds in order. A non-finite pixel staged for
// an image (every staged pixel is one of its image's own, clamped or not)
// marks its image's piece, and the image's sum is NaN. No atomics on the
// sums: they are deterministic. Each pixel's SSIM is the tile modes' (and
// the twin's) bit for bit; only the order of the sums differs. What bounds
// it: the main-path stream's step (issue and one barrier a row), at strips
// filled by whole images (W = 32, 64, 128, 192), plus 11 shared-memory
// loads a step for the ring.
//
// The relaxed kBatch (kSplit = kStreamSplit; K1h's relaxed tier on the
// batch route, ssim_pallas.py:2284-2291) runs the relaxed main-path
// stream's steps over the same packed rows: mu_a and mu_b by the f32
// symmetric pass of the staged {a, b} row, the heavy blurs of (a+b)^2 and
// (a-b)^2 as bf16x3 band products (band_mma.cuh) made every other push for
// the next two, into a ring of blurred rows addressed by push, rows staged
// three pushes ahead. A band product's line is 16 consecutive outputs from
// 16 + 2r consecutive staged columns, and a tile of 16 strip columns that
// holds two images has no such run of columns: where W is a multiple of 16
// (32, 64, 128, 192, ...) or a strip meets one image, no tile straddles, and
// the 8 lines are the strip's tiles, each read from its piece's staged
// columns; elsewhere (68 of the routed widths up to 192: 24, 40, 56, ...
// and the narrow ones packed 2 to 12 a strip) the lines are the staged
// row's own tiles (up to kBatchLines, two sweeps of 8) and each column's
// blur is the output at its staged centre (s_dst maps outputs to columns;
// outputs between pieces are dropped), so no pixel of one image enters
// another's blur. Measured on an H100, the staged lines at the aligned
// widths took 1.09-1.17x the strip's; at widths that take them (12, 24,
// 40, 50, 60, 120, 184) the stream took 0.45-0.84x the relaxed tile body
// (PERF.md). A push that repeats the row before it (the clamped rows above
// row 0 and below row H - 1) copies that push's blurs, its own column of the
// ring and its window registers; every push ends with a barrier. 34.7 KB of
// shared memory, 6 blocks per SM. What bounds it: the relaxed stream's step
// (the mma a warp issues in a step hold its block at the barrier).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fwd_batch_kernel.cuh"

namespace {

// The kernel at radius kStreamR; its second pass is ssim_fwd_batch_launch's.
template <typename T, int kMode, int kSplit>
cudaError_t launch_batch_stream(const void* a, const void* b, void* partials, void* pieces,
                                int B, int H, int W, int k, int S,
                                const double* taps_host, double c1, double c2,
                                float clip_bound, cudaStream_t stream) {
  using P = Blur<kMode>;
  StreamTaps<P> tp;
  for (int i = 0; i < 2 * kStreamR + 1; ++i) tp.t[i] = (P)taps_host[i];
  const int nstrip = (k * W + kStripW - 1) / kStripW;
  const int nseg = (H + S - 1) / S;
  const int nps = (W + kStripW - 1) / kStripW + 1;
  const long long blocks = (long long)nstrip * nseg * ((B + k - 1) / k);
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  ssim_fwd_batch_stream_kernel<T, kMode, kSplit>
      <<<(unsigned)blocks, kStreamThreads, 0, stream>>>(
          static_cast<const T*>(a), static_cast<const T*>(b), static_cast<P*>(partials),
          static_cast<double*>(pieces), B, H, W, k, S, nstrip, nseg, nps, tp, (P)c1, (P)c2,
          clip_bound);
  return cudaGetLastError();
}

template <typename T, int kMode, int kSplit>
cudaError_t batch_stream_occupancy(int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ssim_fwd_batch_stream_kernel<T, kMode, kSplit>, kStreamThreads, 0);
}

// The second pass where pieces is not NULL.
template <typename P>
cudaError_t launch_batch_reduce(void* partials, const void* pieces, int B, int H, int W,
                                int k, int S, cudaStream_t stream) {
  const int nseg = (H + S - 1) / S;
  const int nps = (W + kStripW - 1) / kStripW + 1;
  batch_pieces_reduce_kernel<P><<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const double*>(pieces), static_cast<P*>(partials), B, W, k, nseg, nps,
      (double)H * (double)W);
  return cudaGetLastError();
}

}  // namespace

// ssim_fwd_batch_rt.cu: the kernel at the other radii (its first pass only).
extern "C" int ssim_fwd_batch_rt_launch(int precise, int relaxed, int is_float, const void* a,
                                        const void* b, void* partials, void* pieces, int B,
                                        int H, int W, int k, int S, int r,
                                        const double* taps_host, double c1, double c2,
                                        float clip_bound, void* stream);
extern "C" int ssim_fwd_batch_rt_occupancy(int precise, int relaxed, int is_float, int r,
                                           int W, int k, int* blocks_per_sm);

// The batch modes' packed row-streaming kernel, for ctypes: precise 0
// (kBatch, f32 partials) or 1 (kBatchPrecise, f64); relaxed 1: the relaxed
// kBatch (precise 0 only), else 0; is_float as in ssim_fwd_launch.
// partials: (B, 2) [sum(ssim - 1), H*W]. pieces: NULL where each block
// holds its images' every row and column (S >= H, and k W <= 128 or W
// divides 128), else (B, ceil(H / S), ceil(W / 128) + 1) f64 for the second
// pass. k: images a packed row (1 to B; k H W < 2^31; W < 12: k <= 12 and
// k W <= 128); S: output rows a block takes of each image (1 to H). r: the
// radius, 1 to kMaxStreamR (kStreamR: the register window, here; the others
// ssim_fwd_batch_rt.cu's runtime radius). taps_host: 2r + 1 doubles; c1,
// c2, clip_bound and stream as in ssim_fwd_launch. Returns the launch's
// cudaError_t.
extern "C" int ssim_fwd_batch_launch(int precise, int relaxed, int is_float, const void* a,
                                     const void* b, void* partials, void* pieces, int B,
                                     int H, int W, int k, int S, int r,
                                     const double* taps_host, double c1, double c2,
                                     float clip_bound, void* stream) {
  if (B < 1 || H < 1 || W < 1 || k < 1 || k > B || S < 1 || (precise && relaxed) ||
      r < 1 || r > kMaxStreamR || (long long)k * H * W > 0x7fffffffLL ||
      (W < 12 && (k > kBatchPieces || k * W > kStripW)) ||
      (pieces == nullptr && (S < H || (k * W > kStripW && kStripW % W != 0)))) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (r != kStreamR) {
    err = (cudaError_t)ssim_fwd_batch_rt_launch(precise, relaxed, is_float, a, b, partials,
                                                pieces, B, H, W, k, S, r, taps_host, c1, c2,
                                                clip_bound, stream);
  } else {
#define SSIM_FWD_BATCH(T, M, K)                                                          \
  launch_batch_stream<T, M, K>(a, b, partials, pieces, B, H, W, k, S, taps_host, c1, c2, \
                               clip_bound, s)
    if (precise) {
      err = is_float ? SSIM_FWD_BATCH(float, kBatchPrecise, 0)
                     : SSIM_FWD_BATCH(uint8_t, kBatchPrecise, 0);
    } else if (relaxed) {
      err = is_float ? SSIM_FWD_BATCH(float, kBatch, kStreamSplit)
                     : SSIM_FWD_BATCH(uint8_t, kBatch, kStreamSplit);
    } else {
      err = is_float ? SSIM_FWD_BATCH(float, kBatch, 0) : SSIM_FWD_BATCH(uint8_t, kBatch, 0);
    }
#undef SSIM_FWD_BATCH
  }
  if (err != cudaSuccess || pieces == nullptr) return err;
  return precise ? launch_batch_reduce<double>(partials, pieces, B, H, W, k, S, s)
                 : launch_batch_reduce<float>(partials, pieces, B, H, W, k, S, s);
}

// Blocks of the batch modes' packed stream that one SM of the current device
// holds at once (precise 0: kBatch, 1: kBatchPrecise; relaxed 1: the relaxed
// kBatch) for uint8 (is_float = 0) or float32 inputs at radius r, for
// images of width W packed k to a row (which size the runtime-radius
// instantiation's staged rows; radius kStreamR ignores them): the CUDA
// runtime's occupancy for the instantiation that ssim_fwd_batch_launch
// takes, its dynamic shared memory included. Returns a cudaError_t.
extern "C" int ssim_fwd_batch_occupancy(int precise, int relaxed, int is_float, int r, int W,
                                        int k, int* blocks_per_sm) {
  if ((precise && relaxed) || r < 1 || r > kMaxStreamR || W < 1 || k < 1) {
    return cudaErrorInvalidValue;
  }
  if (r != kStreamR) {
    return ssim_fwd_batch_rt_occupancy(precise, relaxed, is_float, r, W, k, blocks_per_sm);
  }
  if (precise) {
    return is_float ? batch_stream_occupancy<float, kBatchPrecise, 0>(blocks_per_sm)
                    : batch_stream_occupancy<uint8_t, kBatchPrecise, 0>(blocks_per_sm);
  }
  if (relaxed) {
    return is_float ? batch_stream_occupancy<float, kBatch, kStreamSplit>(blocks_per_sm)
                    : batch_stream_occupancy<uint8_t, kBatch, kStreamSplit>(blocks_per_sm);
  }
  return is_float ? batch_stream_occupancy<float, kBatch, 0>(blocks_per_sm)
                  : batch_stream_occupancy<uint8_t, kBatch, 0>(blocks_per_sm);
}
