// Runs ssim_fwd_stream_kernel's source on the host (see cuda_runtime.h):
//   harness IN OUT
// IN holds int32 [mode, is_float, B, H, W, TH, TW, S, has_halo, is_top,
// is_bot, precise, relaxed, r], the taps[2r + 1] and [c1, c2, clip_bound]
// (f64 with precise, else f32), a, b (B*H*W of u8 or f32) and, with
// has_halo, a_top, a_bot, b_top, b_bot (B*r*W each). r = 5 runs the
// register-window instantiations, any other radius (1 to 16) the
// runtime-radius ones (kR = 0; relaxed with kSplit = band_mma::ksteps(r)). Every output buffer starts as NaN, and the
// block's shared memory is NaN (bytes 0xff) at each block's start
// (emu_threads.h: the test rewrites the kernels' __shared__ arrays into its
// arena), so an entry the kernel never writes, or a shared value it reads
// before writing, shows as a mismatch.
// OUT receives the partials (B, nty*ntx)
// (f64 with precise, else f32; (B, nty*ntx, 2) f32 in the components modes)
// or the row sums (B, H) f32, then the map (B, H, W) f32 in the map modes,
// or the pooled images (B, H/2, W/2) f32 of a, then of b, in kPooled.
// precise must be 1 exactly in the precise
// modes; relaxed (kScore, kMap, kComponents and kPooled) runs the relaxed
// instantiation, its band products through band_mma.cuh's host model of
// mma. The batch modes (6 kBatch, 7 kBatchPrecise:
// ssim_fwd_batch_stream_kernel) read [mode, is_float, B, H, W, k, S,
// pieces, 0, 0, 0, precise, relaxed, r] (pieces: 1 for the second pass,
// batch_pieces_reduce_kernel; relaxed: kBatch only; r = 5 the
// register-window instantiations, any other radius the runtime-radius ones,
// relaxed with kSplit = band_mma::ksteps(r)) and write the (B, 2)
// partials. The blocks run one after another, each with one std::thread per
// CUDA thread.
#include "cuda_runtime.h"

#include "emu_threads.h"

#include <limits>

#include "ssim_fwd_stream.cu"  // the kernel's source, cut by the test
#include "fwd_batch_kernel.cuh"  // the batch modes' kernels, rewritten by the test

template <class T> static std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) {
    fprintf(stderr, "short input\n");
    exit(1);
  }
  return v;
}

template <class T, int M, int S, int R>
static void run(FILE* f, FILE* o, const std::vector<int>& h) {
  using P = Blur<M>;
  const int B = h[2], H = h[3], W = h[4], TH = h[5], TW = h[6], seg = h[7], r = h[13];
  const auto taps = take<P>(f, 2 * r + 1);
  const auto cc = take<P>(f, 3);
  const size_t np = (size_t)B * H * W;
  const auto a = take<T>(f, np), b = take<T>(f, np);
  std::vector<T> ops[4];
  if (h[8]) for (auto& x : ops) x = take<T>(f, (size_t)B * r * W);
  const Halo<T> halo{h[8] ? ops[0].data() : nullptr, h[8] ? ops[1].data() : nullptr,
                     h[8] ? ops[2].data() : nullptr, h[8] ? ops[3].data() : nullptr,
                     h[9], h[10]};
  StreamTaps<P, R> tp{};
  for (int k = 0; k < 2 * r + 1; ++k) tp.t[k] = taps[k];
  if constexpr (R == 0) tp.r = r;
  const int nstrip = (W + kStripW - 1) / kStripW, nseg = (H + seg - 1) / seg;
  const int ntx = (W + TW - 1) / TW, nty = (H + TH - 1) / TH;
  constexpr bool kRows = M == kRowsum || M == kRowsumMap;
  constexpr bool kWithMap = M == kMap || M == kRowsumMap || M == kPreciseMap;
  constexpr bool kComp = M == kComponents || M == kPooled;
  const P pnan = std::numeric_limits<P>::quiet_NaN();
  const float fnan = std::numeric_limits<float>::quiet_NaN();
  std::vector<P> partials((size_t)B * nty * ntx * (kComp ? 2 : 1), pnan);
  std::vector<float> map(np, fnan), pieces((size_t)B * ntx * H, fnan);
  const size_t npool = (size_t)B * (H / 2) * (W / 2);
  std::vector<float> pool_a(npool, fnan), pool_b(npool, fnan);
  const size_t dynamic = S > 0 ? stream_rt_relaxed_smem_bytes(r)
                               : (size_t)(2 * r + 1) * kStreamThreads * 4 * sizeof(P);
  if (R == 0 && dynamic > kEmuDynamic) {
    fprintf(stderr, "the ring exceeds the dynamic shared memory\n");
    exit(1);
  }
  run_blocks(B * nseg * nstrip, kStreamThreads, [&] {
    ssim_fwd_stream_kernel<T, M, S, R>(a.data(), b.data(), partials.data(),
                                       kWithMap ? map.data() : nullptr, pieces.data(), halo,
                                       H, W, TH, TW, seg, nstrip, nseg, ntx, nty, tp, cc[0],
                                       cc[1], (float)cc[2], pool_a.data(), pool_b.data());
  });
  if (kRows) {  // rowsum_reduce_kernel's arithmetic
    std::vector<float> rows((size_t)B * H);
    for (int i = 0; i < B; ++i) {
      for (int y = 0; y < H; ++y) {
        double s = 0.0;
        for (int t = 0; t < ntx; ++t) s += pieces[((size_t)i * ntx + t) * H + y];
        rows[(size_t)i * H + y] = (float)s + (float)W;
      }
    }
    fwrite(rows.data(), 4, rows.size(), o);
  } else {
    fwrite(partials.data(), sizeof(P), partials.size(), o);
  }
  if (kWithMap) fwrite(map.data(), 4, map.size(), o);
  if (M == kPooled) {
    fwrite(pool_a.data(), 4, npool, o);
    fwrite(pool_b.data(), 4, npool, o);
  }
}

template <class T, int M, int K, int R>
static void run_batch(FILE* f, FILE* o, const std::vector<int>& h) {
  using P = Blur<M>;
  const int B = h[2], H = h[3], W = h[4], k = h[5], S = h[6], r = h[13];
  const auto taps = take<P>(f, 2 * r + 1);
  const auto cc = take<P>(f, 3);
  const size_t np = (size_t)B * H * W;
  const auto a = take<T>(f, np), b = take<T>(f, np);
  StreamTaps<P, R> tp{};
  for (int i = 0; i < 2 * r + 1; ++i) tp.t[i] = taps[i];
  if constexpr (R == 0) tp.r = r;
  if (R == 0 && batch_rt_layout<P, K>(r, W, k).bytes > kEmuDynamic) {
    fprintf(stderr, "the staged rows and the ring exceed the dynamic shared memory\n");
    exit(1);
  }
  const int nstrip = (k * W + kStripW - 1) / kStripW, nseg = (H + S - 1) / S;
  const int nps = (W + kStripW - 1) / kStripW + 1;
  std::vector<P> partials((size_t)B * 2, std::numeric_limits<P>::quiet_NaN());
  std::vector<double> pieces((size_t)B * nseg * nps, std::numeric_limits<double>::quiet_NaN());
  double* pp = h[7] ? pieces.data() : nullptr;
  run_blocks(nstrip * nseg * ((B + k - 1) / k), kStreamThreads, [&] {
    ssim_fwd_batch_stream_kernel<T, M, K, R>(a.data(), b.data(), partials.data(), pp, B, H, W,
                                             k, S, nstrip, nseg, nps, tp, cc[0], cc[1],
                                             (float)cc[2]);
  });
  if (pp) {
    run_blocks((B + 255) / 256, 256, [&] {
      batch_pieces_reduce_kernel<P>(pp, partials.data(), B, W, k, nseg, nps,
                                    (double)H * (double)W);
    });
  }
  fwrite(partials.data(), sizeof(P), partials.size(), o);
}

// The batch modes at radius h[13]: the register-window instantiations at
// kStreamR, else the runtime-radius ones (relaxed: kSplit = ksteps(r)).
template <int R>
static int run_batch_modes(FILE* f, FILE* o, const std::vector<int>& h) {
  if (h[0] == kBatch && h[12]) {
    if constexpr (R == 0) {
      const bool two = band_mma::ksteps(h[13]) == 2;
      if (two && h[1]) run_batch<float, kBatch, 2, 0>(f, o, h);
      else if (two) run_batch<uint8_t, kBatch, 2, 0>(f, o, h);
      else if (h[1]) run_batch<float, kBatch, 3, 0>(f, o, h);
      else run_batch<uint8_t, kBatch, 3, 0>(f, o, h);
    } else {
      if (h[1]) run_batch<float, kBatch, kStreamSplit, R>(f, o, h);
      else run_batch<uint8_t, kBatch, kStreamSplit, R>(f, o, h);
    }
  } else if (h[0] == kBatch) {
    if (h[1]) run_batch<float, kBatch, 0, R>(f, o, h);
    else run_batch<uint8_t, kBatch, 0, R>(f, o, h);
  } else if (!h[12]) {
    if (h[1]) run_batch<float, kBatchPrecise, 0, R>(f, o, h);
    else run_batch<uint8_t, kBatchPrecise, 0, R>(f, o, h);
  } else {
    return 2;
  }
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* f = fopen(argv[1], "rb");
  FILE* o = fopen(argv[2], "wb");
  if (!f || !o) return 2;
  const auto h = take<int>(f, 14);
  if (h[11] != (h[0] == kPrecise || h[0] == kPreciseMap || h[0] == kBatchPrecise)) return 2;
  if (h[13] < 1 || h[13] > kMaxStreamR) return 2;
  if (h[0] == kBatch || h[0] == kBatchPrecise) {
    const int rc = h[13] == kStreamR ? run_batch_modes<kStreamR>(f, o, h)
                                     : run_batch_modes<0>(f, o, h);
    fclose(o);
    return rc;
  }
#define SSIM_EMU_RUN_R(M, S, R)                 \
  case M:                                       \
    if (h[1]) run<float, M, S, R>(f, o, h);     \
    else run<uint8_t, M, S, R>(f, o, h);        \
    break;
#define SSIM_EMU_RUN(M, S) SSIM_EMU_RUN_R(M, S, kStreamR)
  if (h[13] != kStreamR && h[12]) {
    const bool two = band_mma::ksteps(h[13]) == 2;
#define SSIM_EMU_RUN_RT_RELAXED(M)                                  \
  case M:                                                           \
    if (two && h[1]) run<float, M, 2, 0>(f, o, h);                  \
    else if (two) run<uint8_t, M, 2, 0>(f, o, h);                   \
    else if (h[1]) run<float, M, 3, 0>(f, o, h);                    \
    else run<uint8_t, M, 3, 0>(f, o, h);                            \
    break;
    switch (h[0]) {
      SSIM_EMU_RUN_RT_RELAXED(kScore)
      SSIM_EMU_RUN_RT_RELAXED(kMap)
      SSIM_EMU_RUN_RT_RELAXED(kComponents)
      SSIM_EMU_RUN_RT_RELAXED(kPooled)
      default:
        return 2;
    }
#undef SSIM_EMU_RUN_RT_RELAXED
  } else if (h[13] != kStreamR) {
    switch (h[0]) {
      SSIM_EMU_RUN_R(kScore, 0, 0)
      SSIM_EMU_RUN_R(kMap, 0, 0)
      SSIM_EMU_RUN_R(kPrecise, 0, 0)
      SSIM_EMU_RUN_R(kPreciseMap, 0, 0)
      SSIM_EMU_RUN_R(kRowsum, 0, 0)
      SSIM_EMU_RUN_R(kRowsumMap, 0, 0)
      SSIM_EMU_RUN_R(kComponents, 0, 0)
      SSIM_EMU_RUN_R(kPooled, 0, 0)
      default:
        return 2;
    }
  } else if (h[12]) {
    switch (h[0]) {
      SSIM_EMU_RUN(kScore, kStreamSplit)
      SSIM_EMU_RUN(kMap, kStreamSplit)
      SSIM_EMU_RUN(kComponents, kStreamSplit)
      SSIM_EMU_RUN(kPooled, kStreamSplit)
      default:
        return 2;
    }
  } else {
    switch (h[0]) {
      SSIM_EMU_RUN(kScore, 0)
      SSIM_EMU_RUN(kMap, 0)
      SSIM_EMU_RUN(kPrecise, 0)
      SSIM_EMU_RUN(kPreciseMap, 0)
      SSIM_EMU_RUN(kRowsum, 0)
      SSIM_EMU_RUN(kRowsumMap, 0)
      SSIM_EMU_RUN(kComponents, 0)
      SSIM_EMU_RUN(kPooled, 0)
      default:
        return 2;
    }
  }
  fclose(o);
  return 0;
}
