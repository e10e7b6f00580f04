// Runs ssim_bwd.cu's relaxed streaming kernel (ssim_bwd_relaxed_stream_kernel)
// on the host (see cuda_runtime.h and emu_threads.h):
//   bwd_harness IN OUT
// IN holds int32 [B, H, W, TH, S, has_gmap, has_halo, is_top, is_bot], then
// f32 taps[11], fold mass[5], [c1, c2, clip_bound], a and b (B*H*W each),
// w_s and w_cs (B each), with has_gmap g_map (B*H*W) and with has_halo
// a_top, a_bot, b_top, b_bot (B*10*W each). OUT receives da, db (B*H*W f32
// each), NaN where the kernel wrote nothing. The test cuts the kernel's
// source out of ssim_bwd.cu and points its dynamic shared memory at
// g_rel_smem.
#include "emu_threads.h"

alignas(16) static unsigned char g_rel_smem[1 << 17];

#include "ssim_bwd_stream.cu"  // the kernel's source, cut by the test

template <class T> static std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) {
    fprintf(stderr, "short input\n");
    exit(1);
  }
  return v;
}

int main(int argc, char** argv) {
  static_assert(kRelSmemBytes <= (int)sizeof(g_rel_smem), "the block's shared memory");
  if (argc != 3) return 2;
  FILE* f = fopen(argv[1], "rb");
  FILE* o = fopen(argv[2], "wb");
  if (!f || !o) return 2;
  const auto h = take<int>(f, 9);
  const int B = h[0], H = h[1], W = h[2], TH = h[3], S = h[4];
  constexpr int r = kRelR;
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
  const int nstrip = (W + kStripW - 1) / kStripW, nseg = (H + S - 1) / S;
  run_blocks(B * nseg * nstrip, kRelThreads, [&] {
    if (h[5]) {
      ssim_bwd_relaxed_stream_kernel<true>(a.data(), b.data(), ws.data(), wcs.data(),
                                           gmap.data(), da.data(), db.data(), halo, H, W,
                                           TH, S, nstrip, nseg, co, cc[0], cc[1], cc[2]);
    } else {
      ssim_bwd_relaxed_stream_kernel<false>(a.data(), b.data(), ws.data(), wcs.data(),
                                            nullptr, da.data(), db.data(), halo, H, W, TH,
                                            S, nstrip, nseg, co, cc[0], cc[1], cc[2]);
    }
  });
  fwrite(da.data(), 4, np, o);
  fwrite(db.data(), 4, np, o);
  fclose(o);
  return 0;
}
