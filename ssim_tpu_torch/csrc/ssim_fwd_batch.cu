// The batch modes' packed row stream: kBatch and kBatchPrecise at radius
// kStreamR (ssim_cuda.stream_applies; relaxed kBatch and other radii run
// the tile body in ssim_fwd.cu).
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "band_mma.cuh"
#include "fwd_common.cuh"
#include "fwd_stream.cuh"

namespace {

// At most kBatchPieces images meet one strip (batch_pack: at W >= 12 a strip
// of 128 columns meets at most 12; narrower images are packed at most 12 to
// a row, in one strip), each staged with r clamped columns on either side:
// two staged columns a thread.
constexpr int kBatchPieces = 12;
constexpr int kBatchInW = kStripW + 2 * kStreamR * kBatchPieces;
// kBatch sums each column's ssim - 1 in f32 over at most kBatchRun rows.
constexpr int kBatchRun = 32;
// Blocks per SM asked of ptxas, and the window's signals kept in a
// per-thread shared-memory ring (the precise modes' as the main-path stream;
// kBatch: kBatchRing). kBatch's window of all four signals in registers
// spilled one signal to local memory at 64 registers (~20 local loads a
// step, beside the main-path stream's ~9: the batch step's own state, which
// row a push is); with s_dd in the ring (11 shared loads a step) it measured
// fastest of ring or not at 7 or 8 blocks per SM, at every routed shape on
// an H100 (PERF.md).
constexpr int kBatchBlocks = 8;
constexpr int kBatchRing = 1;
template <int kMode>
constexpr int kBatchBlocksOf = kIsPrecise<kMode> ? kStreamPreciseBlocks : kBatchBlocks;
template <int kMode>
constexpr int kBatchRingOf = kIsPrecise<kMode> ? kStreamPreciseRing : kBatchRing;

// sym2x2's sums for one column (its pair's other column lies in another
// image): v points at the staged column r to the left of it; the same
// order of operations.
__device__ __forceinline__ void sym1x2(const StreamTaps<double>& tp, const double2* v,
                                       double2& o) {
  constexpr int r = kStreamR;
  {
    const double t = tp.t[0];
    o.x = t * (v[0].x + v[2 * r].x);
    o.y = t * (v[0].y + v[2 * r].y);
  }
#pragma unroll
  for (int d = r - 1; d >= 1; --d) {
    const double t = tp.t[r - d];
    o.x += t * (v[r - d].x + v[r + d].x);
    o.y += t * (v[r - d].y + v[r + d].y);
  }
  const double tc = tp.t[r];
  o.x = o.x + tc * v[r].x;
  o.y = o.y + tc * v[r].y;
}

// partials: (B, 2) [sum(ssim - 1), H*W], f32 in kBatch and f64 in
// kBatchPrecise, written where pieces is NULL (each image within one strip,
// S >= H); else pieces: (B, nseg, nps) f64, each block's sum of each image
// it meets in slot [image][segment][strip - the image's first strip]. k:
// images a packed row; S: output rows a block takes; nstrip, nseg: strips
// of a packed row, segments of H. Block order: strips fastest, then
// segments, then packed rows.
template <typename T, int kMode>
__global__ void __launch_bounds__(kStreamThreads, kBatchBlocksOf<kMode>)
ssim_fwd_batch_stream_kernel(const T* __restrict__ a, const T* __restrict__ b,
                             Blur<kMode>* __restrict__ partials,
                             double* __restrict__ pieces, int B, int H, int W, int k,
                             int S, int nstrip, int nseg, int nps,
                             StreamTaps<Blur<kMode>> tp, Blur<kMode> c1, Blur<kMode> c2,
                             float clip_bound) {
  using P = Blur<kMode>;
  constexpr int r = kStreamR;
  constexpr int kP = 2 * r + 1;  // window rows = steps unrolled
  constexpr int kNT = kStreamThreads;
  constexpr int kLoads = (kBatchInW + kNT - 1) / kNT;
  constexpr bool kFloat = sizeof(T) == 4;
  constexpr bool kPrec = kIsPrecise<kMode>;
  constexpr int kRing = kBatchRingOf<kMode>;
  constexpr int kRegS = 4 - kRing;
  static_assert(kMode == kBatch || kMode == kBatchPrecise, "the batch modes");

  __shared__ StagedRow<P, kBatchInW> s_in[2];  // staged rows, by parity
  // Each column's sum over the block's rows (kBatch adds its f32 runs
  // here), then the segmented warp sums.
  __shared__ double s_sum[kNT];
  // Bit p: piece p holds a non-finite pixel.
  __shared__ unsigned s_bad;
  __shared__ P s_ring[kRing > 0 ? kRing * kP * kNT : 1];

  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  const int strip = blk % nstrip;
  blk /= nstrip;
  const int seg = blk % nseg;
  const int g = blk / nseg;  // the packed row
  const int x0 = strip * kStripW;
  // The strip's output columns (the last packed row may hold fewer than k
  // images, and end before this strip).
  const int sw = min(kStripW, min(k, B - g * k) * W - x0);
  if (sw <= 0) return;
  if (tid == 0) s_bad = 0u;
  s_sum[tid] = 0.0;
  // Before the prologue's stage(0), which may mark pieces in s_bad.
  __syncthreads();

  const int y0 = seg * S;
  const int vh = min(S, H - y0);   // output rows
  const int npush = vh + 2 * r;    // window pushes
  const int ylo = max(y0 - r, 0);  // the rows staged
  const int yhi = min(y0 + vh - 1 + r, H - 1);
  const int i0 = x0 / W;           // the strip's first image in the packed row
  const int e = x0 - i0 * W;       // and the strip's first column in it
  // Staged columns: the pieces' columns plus r on either side.
  const int nw = sw + 2 * r * ((x0 + sw - 1) / W - i0 + 1);
  const T* const ga = a + (size_t)g * (size_t)k * (size_t)H * (size_t)W;
  const T* const gb = b + (size_t)g * (size_t)k * (size_t)H * (size_t)W;

  // The centre in the staged row of strip column t's window (idle columns:
  // r, inside the row).
  auto centre = [&](int t) { return t < sw ? t + 2 * r * ((t + e) / W) + r : r; };
  [[maybe_unused]] const int ctr = kPrec ? 0 : centre(tid);
  [[maybe_unused]] const int ce = kPrec ? centre(tid & ~1) : 0;  // the pair's columns
  [[maybe_unused]] const int co = kPrec ? centre(tid | 1) : 0;

  // Staged column tid + q kNT: the offset of its source in the packed row's
  // images at row 0 (its image's column, clamped).
  int soff[kLoads];
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int jp = tid + q * kNT + e;
    const int p = jp / (W + 2 * r);
    const int col = min(max(jp - p * (W + 2 * r) - r, 0), W - 1);
    soff[q] = i0 + p < k ? (i0 + p) * H * W + col : 0;
  }
  T pa[kLoads], pb[kLoads];
  auto fetch = [&](int y) {
    const size_t o = (size_t)y * (size_t)W;
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      if (tid + q * kNT < nw) {
        pa[q] = __ldg(ga + o + soff[q]);
        pb[q] = __ldg(gb + o + soff[q]);
      }
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int j = tid + q * kNT;
      if (j < nw) {
        float va = to_f32(pa[q]);
        float vb = to_f32(pb[q]);
        if (kFloat) {
          if (!(finite_f32(va) && finite_f32(vb))) {
            atomicOr(&s_bad, 1u << ((j + e) / (W + 2 * r)));  // rare path
          }
          va = sanitize(va, clip_bound);
          vb = sanitize(vb, clip_bound);
        }
        s_in[buf].put(j, va, vb);
      }
    }
  };

  P win[kRegS > 0 ? kRegS : 1][kP];
  auto win_put = [&](int p, int kk, P v) {
    if (p >= kRegS) {
      s_ring[(kk * kRing + (p - kRegS)) * kNT + tid] = v;
    } else {
      win[p][kk] = v;
    }
  };
  auto win_get = [&](int p, int kk) -> P {
    return p >= kRegS ? s_ring[(kk * kRing + (p - kRegS)) * kNT + tid] : win[p][kk];
  };

  // cy: the next image row to stage, loaded while cy <= yhi.
  int cy = ylo;
  fetch(cy);
  stage(0);
  if (++cy <= yhi) fetch(cy);
  __syncthreads();

  // nb: rows blurred; col_on: this column is one of the images'.
  int nb = 0;
  const bool col_on = tid < sw;
  [[maybe_unused]] float acc = 0.0f;    // kBatch: the column's f32 run
  [[maybe_unused]] double dacc = 0.0;  // kBatchPrecise: the column's sum

  for (int s0 = 0; s0 < npush; s0 += kP) {
#pragma unroll
    for (int kk = 0; kk < kP; ++kk) {
      const int j = s0 + kk;
      if (j < npush) {
        // Push j: image row clamp(y0 - r + j, 0, H - 1), blurred where it
        // differs from push j - 1's, else push j - 1's blur again.
        const int vy = y0 - r + j;
        const bool blur = j == 0 || (vy >= 1 && vy <= H - 1);

        // (b) The horizontal blur of the staged row into the window's slot kk.
        if (blur) {
          const StagedRow<P, kBatchInW>& row = s_in[nb & 1];
          if constexpr (kPrec) {
            // The thread pairs of the precise stream; a pair whose two
            // columns lie in two images blurs each from its own window.
            const bool odd = tid & 1;
            const double2* pl = odd ? row.sd : row.ab;
            double2 o0, o1;
            if (co == ce + 1) {
              sym2x2(tp, pl + ce - r, o0, o1);
            } else {
              sym1x2(tp, pl + ce - r, o0);
              sym1x2(tp, pl + co - r, o1);
            }
            const double2 give = odd ? o0 : o1;
            const double2 got = make_double2(__shfl_xor_sync(0xffffffffu, give.x, 1),
                                             __shfl_xor_sync(0xffffffffu, give.y, 1));
            const double2 ab = odd ? got : o0, sd = odd ? o1 : got;
            if (col_on) {
              win_put(0, kk, ab.x);
              win_put(1, kk, ab.y);
              win_put(2, kk, sd.x);
              win_put(3, kk, sd.y);
            }
          } else if (col_on) {
            P h[4];
            sym4(tp, [&](int i) { return row.get(ctr + i); }, h);
#pragma unroll
            for (int p = 0; p < 4; ++p) win_put(p, kk, h[p]);
          }
          ++nb;
        } else if (col_on) {
          // A clamped row above row 0 or below row H - 1.
#pragma unroll
          for (int p = 0; p < 4; ++p) win_put(p, kk, win_get(p, (kk + kP - 1) % kP));
        }

        // (c) Output row y0 + j - 2r from pushes j - 2r .. j.
        if (j >= 2 * r) {
          if (col_on) {
            P m[4];
            sym4(tp,
                 [&](int i) {
                   const int sl = (kk - r + i + 2 * kP) % kP;
                   return Vec4<P>{win_get(0, sl), win_get(1, sl), win_get(2, sl),
                                  win_get(3, sl)};
                 },
                 m);
            const P v = ssim_of(m, c1, c2);
            if constexpr (kPrec) {
              dacc += v - 1.0;
            } else {
              acc += v - 1.0f;
            }
          }
          if constexpr (!kPrec) {
            if (((j - 2 * r) & (kBatchRun - 1)) == kBatchRun - 1) {
              if (col_on) s_sum[tid] += (double)acc;
              acc = 0.0f;
            }
          }
        }

        // (d) The next row staged from the registers loaded at the last
        // blur, and the row after it loaded.
        if (blur) {
          if (cy <= yhi) {
            stage(nb & 1);
            if (++cy <= yhi) fetch(cy);
          }
          __syncthreads();
        }
      }
    }
  }

  // The columns' sums complete in s_sum, then a segmented warp reduction
  // (lane l ends with the sum of its piece's lanes from l on in its warp),
  // then in the thread of each piece's first column the piece's warps in
  // order, NaN where s_bad marks the piece.
  if (col_on) {
    if constexpr (kPrec) {
      s_sum[tid] = dacc;
    } else {
      s_sum[tid] += (double)acc;
    }
  }
  const int pc = (tid + e) / W;  // this column's piece: image i0 + pc
  const int pfirst = max(0, pc * W - e);
  const int pe = min((pc + 1) * W - e, sw);
  const int lane = tid & 31;
  const int lim = min(pe, (tid & ~31) + 32) - (tid & ~31);
  double w = s_sum[tid];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_down_sync(0xffffffffu, w, off);
    if (lane + off < lim) w += o;
  }
  s_sum[tid] = w;
  __syncthreads();
  if (tid < sw && tid == pfirst) {
    double sum = s_sum[tid];
    for (int wi = (tid >> 5) + 1; wi <= (pe - 1) >> 5; ++wi) sum += s_sum[wi * 32];
    if ((s_bad >> pc) & 1u) sum = (double)__int_as_float(0x7fc00000);
    const size_t img = (size_t)g * (size_t)k + (size_t)(i0 + pc);
    if (pieces == nullptr) {
      partials[2 * img] = (P)sum;
      partials[2 * img + 1] = (P)((double)H * (double)W);
    } else {
      pieces[(img * (size_t)nseg + (size_t)seg) * (size_t)nps +
             (size_t)(strip - (i0 + pc) * W / kStripW)] = sum;
    }
  }
}

// The batch stream's second pass where an image's rows or columns were
// split over blocks: each image's pieces (B, nseg, nps) added in order,
// segments outer and strips inner, in double, then its partial pair
// [sum(ssim - 1), n]. One thread per image.
template <typename Out>
__global__ void batch_pieces_reduce_kernel(const double* __restrict__ pieces,
                                           Out* __restrict__ partials, int B, int W, int k,
                                           int nseg, int nps, double n) {
  const int img = blockIdx.x * blockDim.x + threadIdx.x;
  if (img >= B) return;
  const int i = img % k;  // its place in its packed row
  const int ns = ((i + 1) * W - 1) / kStripW - i * W / kStripW + 1;  // strips it meets
  const double* p = pieces + (size_t)img * nseg * nps;
  double s = 0.0;
  for (int sg = 0; sg < nseg; ++sg) {
    for (int t = 0; t < ns; ++t) s += p[(size_t)sg * nps + t];
  }
  partials[2 * (size_t)img] = (Out)s;
  partials[2 * (size_t)img + 1] = (Out)n;
}

template <typename T, int kMode>
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
  ssim_fwd_batch_stream_kernel<T, kMode><<<(unsigned)blocks, kStreamThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<P*>(partials),
      static_cast<double*>(pieces), B, H, W, k, S, nstrip, nseg, nps, tp, (P)c1, (P)c2,
      clip_bound);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || pieces == nullptr) return err;
  batch_pieces_reduce_kernel<P><<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const double*>(pieces), static_cast<P*>(partials), B, W, k, nseg, nps,
      (double)H * (double)W);
  return cudaGetLastError();
}

template <typename T, int kMode>
cudaError_t batch_stream_occupancy(int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ssim_fwd_batch_stream_kernel<T, kMode>, kStreamThreads, 0);
}

}  // namespace

// The batch modes' packed row-streaming kernel (radius kStreamR), for
// ctypes: precise 0 (kBatch, f32 partials) or 1 (kBatchPrecise, f64);
// is_float as in ssim_fwd_launch. partials: (B, 2) [sum(ssim - 1), H*W].
// pieces: NULL where each block holds its images' every row and column (S
// >= H, and k W <= 128 or W divides 128), else (B, ceil(H / S),
// ceil(W / 128) + 1) f64 for the second pass. k: images a packed row (1 to
// B; k H W < 2^31; W < 12: k <= 12 and k W <= 128); S: output rows a block
// takes of each image (1 to H). taps_host: 2 kStreamR + 1 doubles; c1, c2,
// clip_bound and stream as in ssim_fwd_launch. Returns the launch's
// cudaError_t.
extern "C" int ssim_fwd_batch_launch(int precise, int is_float, const void* a, const void* b,
                                     void* partials, void* pieces, int B, int H, int W,
                                     int k, int S, const double* taps_host,
                                     double c1, double c2, float clip_bound, void* stream) {
  if (B < 1 || H < 1 || W < 1 || k < 1 || k > B || S < 1 ||
      (long long)k * H * W > 0x7fffffffLL ||
      (W < 12 && (k > kBatchPieces || k * W > kStripW)) ||
      (pieces == nullptr && (S < H || (k * W > kStripW && kStripW % W != 0)))) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSIM_FWD_BATCH(T, M)                                                          \
  launch_batch_stream<T, M>(a, b, partials, pieces, B, H, W, k, S, taps_host, c1, c2, \
                            clip_bound, s)
  if (precise) {
    return is_float ? SSIM_FWD_BATCH(float, kBatchPrecise)
                    : SSIM_FWD_BATCH(uint8_t, kBatchPrecise);
  }
  return is_float ? SSIM_FWD_BATCH(float, kBatch) : SSIM_FWD_BATCH(uint8_t, kBatch);
#undef SSIM_FWD_BATCH
}

// Blocks of the batch modes' packed stream that one SM of the current device
// holds at once (precise 0: kBatch, 1: kBatchPrecise) for uint8 (is_float =
// 0) or float32 inputs: the CUDA runtime's occupancy for the instantiation
// that ssim_fwd_batch_launch takes. Returns a cudaError_t.
extern "C" int ssim_fwd_batch_occupancy(int precise, int is_float, int* blocks_per_sm) {
  if (precise) {
    return is_float ? batch_stream_occupancy<float, kBatchPrecise>(blocks_per_sm)
                    : batch_stream_occupancy<uint8_t, kBatchPrecise>(blocks_per_sm);
  }
  return is_float ? batch_stream_occupancy<float, kBatch>(blocks_per_sm)
                  : batch_stream_occupancy<uint8_t, kBatch>(blocks_per_sm);
}
