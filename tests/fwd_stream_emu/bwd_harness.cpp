// Runs the relaxed backward stream (ssim_bwd_relaxed_stream_kernel and
// ssim_bwd_relaxed_rt_kernel, bwd_relaxed_stream.cuh) on the host (see
// cuda_runtime.h and emu_threads.h):
//   bwd_harness IN OUT
// IN holds int32 [B, H, W, TH, S, has_gmap, has_halo, is_top, is_bot, r,
// SW], then f32 taps[2r + 1], fold mass[r], [c1, c2, clip_bound], a and b
// (B*H*W each), w_s and w_cs (B each), with has_gmap g_map (B*H*W) and with
// has_halo a_top, a_bot, b_top, b_bot (B*2r*W each). r = 5 with SW = 128
// runs the instantiation with the radius compiled in, anything else the
// runtime-radius one of its group (rel_groups(r)) and strip, where the
// card's build has it (ssim_bwd_relaxed_rt.cu). OUT receives
// da, db (B*H*W f32 each), NaN where the kernel wrote nothing. The test
// copies the kernel's headers without their host code and points its
// dynamic shared memory at the arena's (emu_dynamic_shared), which is NaN
// (bytes 0xff) at each block's start.
#include "emu_threads.h"

#include <type_traits>

#include "bwd_relaxed_stream.cuh"  // the kernel's header, cut by the test

template <class T> static std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) {
    fprintf(stderr, "short input\n");
    exit(1);
  }
  return v;
}

template <int kR, int kG, int kSW>
static void run(const std::vector<int>& h, const float* a, const float* b, const float* ws,
                const float* wcs, const float* gmap, float* da, float* db, const Halo& halo,
                const Coeffs& co, const std::vector<float>& cc) {
  const int B = h[0], H = h[1], W = h[2], TH = h[3], S = h[4], r = h[9];
  if ((size_t)rel_smem_bytes<kG, kSW>(r) > kEmuDynamic) {
    fprintf(stderr, "the block's shared memory exceeds the buffer\n");
    exit(1);
  }
  const int nstrip = (W + kSW - 1) / kSW, nseg = (H + S - 1) / S;
  auto kernel = [&](auto gm) {
    constexpr bool kGmap = decltype(gm)::value;
    const float* g = kGmap ? gmap : nullptr;
    if constexpr (kR > 0) {
      ssim_bwd_relaxed_stream_kernel<kGmap>(a, b, ws, wcs, g, da, db, halo, H, W, TH, S,
                                            nstrip, nseg, co, cc[0], cc[1], cc[2]);
    } else {
      ssim_bwd_relaxed_rt_kernel<kG, kSW, kGmap>(a, b, ws, wcs, g, da, db, halo, H, W, TH, S,
                                                 nstrip, nseg, co, cc[0], cc[1], cc[2], r);
    }
  };
  run_blocks(B * nseg * nstrip, RelGeom<kG, kSW>::kThreads, [&] {
    if (h[5]) {
      kernel(std::true_type{});
    } else {
      kernel(std::false_type{});
    }
  });
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* f = fopen(argv[1], "rb");
  FILE* o = fopen(argv[2], "wb");
  if (!f || !o) return 2;
  const auto h = take<int>(f, 11);
  const int B = h[0], H = h[1], W = h[2], r = h[9], SW = h[10];
  if (r < 1 || r > kMaxRadius || (SW != kStripW && SW != kTileW)) return 2;
  const auto taps = take<float>(f, 2 * r + 1);
  const auto cl = take<float>(f, r);
  const auto cc = take<float>(f, 3);
  const size_t np = (size_t)B * H * W;
  const auto a = take<float>(f, np), b = take<float>(f, np);
  const auto ws = take<float>(f, B), wcs = take<float>(f, B);
  const auto gmap = take<float>(f, h[5] ? np : 0);
  std::vector<float> ops[4];
  if (h[6]) for (auto& x : ops) x = take<float>(f, (size_t)B * 2 * r * W);
  const Halo halo{h[6] ? ops[0].data() : nullptr, h[6] ? ops[1].data() : nullptr,
                  h[6] ? ops[2].data() : nullptr, h[6] ? ops[3].data() : nullptr, h[7],
                  h[8]};
  Coeffs co;
  for (int k = 0; k < kMaxTaps; ++k) co.t[k] = k < 2 * r + 1 ? taps[k] : 0.0f;
  for (int k = 0; k < kMaxRadius; ++k) co.cl[k] = k < r ? cl[k] : 0.0f;
  std::vector<float> da(np, NAN), db(np, NAN);
  const float* g = h[5] ? gmap.data() : nullptr;
#define SSIM_EMU_BWD(R, G, SWC)                                                         \
  run<R, G, SWC>(h, a.data(), b.data(), ws.data(), wcs.data(), g, da.data(), db.data(), \
                 halo, co, cc)
  const int groups = rel_groups(r);
  if (r == kRelR && SW == kStripW) SSIM_EMU_BWD(kRelR, 3, kStripW);
  else if (groups == 2 && SW == kStripW) SSIM_EMU_BWD(0, 2, kStripW);
  else if (groups == 3 && SW == kTileW) SSIM_EMU_BWD(0, 3, kTileW);
  else if (groups == 4 && SW == kStripW) SSIM_EMU_BWD(0, 4, kStripW);
  else if (groups == 4) SSIM_EMU_BWD(0, 4, kTileW);
  else if (SW == kStripW) SSIM_EMU_BWD(0, 5, kStripW);
  else if (groups == 5) SSIM_EMU_BWD(0, 5, kTileW);
  else return 2;  // not instantiated on the card either (ssim_bwd_relaxed_rt.cu)
#undef SSIM_EMU_BWD
  fwrite(da.data(), 4, np, o);
  fwrite(db.data(), 4, np, o);
  fclose(o);
  return 0;
}
