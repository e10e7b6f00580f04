// Runs the standard tier's backward stream (ssim_bwd_stream_kernel,
// csrc/ssim_bwd.cu) on the host (see cuda_runtime.h and emu_threads.h):
//   bwd_std_harness IN OUT
// IN as bwd_harness.cpp's: int32 [B, H, W, TH, S, has_gmap, has_halo,
// is_top, is_bot, r, SW] (SW must be 128, the standard stream's strip),
// then f32 taps[2r + 1], fold mass[r], [c1, c2, clip_bound], a and b
// (B*H*W each), w_s and w_cs (B each), with has_gmap g_map (B*H*W) and with
// has_halo a_top, a_bot, b_top, b_bot (B*2r*W each). r = 5 runs the
// register-window instantiation (kR = kWindowRadius), any other radius the
// runtime-radius one (kR = 0). OUT receives da, db (B*H*W f32 each), NaN
// where the kernel wrote nothing. The test copies ssim_bwd.cu up to its
// launchers and points its dynamic shared memory at the arena's
// (emu_dynamic_shared), which is NaN (bytes 0xff) at each block's start, as
// are its static shared arrays.
#include "emu_threads.h"

#include "ssim_bwd_stream.cu"  // the kernel's source, cut by the test

template <class T> static std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) {
    fprintf(stderr, "short input\n");
    exit(1);
  }
  return v;
}

template <int kR, bool kGmap>
static void run(const std::vector<int>& h, const float* a, const float* b, const float* ws,
                const float* wcs, const float* gmap, float* da, float* db, const Halo& halo,
                const Coeffs& co, const std::vector<float>& cc) {
  const int B = h[0], H = h[1], W = h[2], TH = h[3], S = h[4], r = h[9];
  if (sizeof(float) * stream_smem_floats(r, kR > 0) > kEmuDynamic) {
    fprintf(stderr, "the block's shared memory exceeds the buffer\n");
    exit(1);
  }
  const int nstrip = (W + kStripW - 1) / kStripW, nseg = (H + S - 1) / S;
  run_blocks(B * nseg * nstrip, kStreamThreads, [&] {
    ssim_bwd_stream_kernel<kR, kGmap>(a, b, ws, wcs, gmap, da, db, halo, H, W, r, TH, S,
                                      nstrip, nseg, co, cc[0], cc[1], cc[2]);
  });
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* f = fopen(argv[1], "rb");
  FILE* o = fopen(argv[2], "wb");
  if (!f || !o) return 2;
  const auto h = take<int>(f, 11);
  const int B = h[0], H = h[1], W = h[2], r = h[9];
  if (r < 1 || r > kMaxRadius || h[10] != kStripW) return 2;
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
#define SSIM_EMU_BWD(R, G) \
  run<R, G>(h, a.data(), b.data(), ws.data(), wcs.data(), g, da.data(), db.data(), halo, co, cc)
  if (r == kWindowRadius && g) SSIM_EMU_BWD(kWindowRadius, true);
  else if (r == kWindowRadius) SSIM_EMU_BWD(kWindowRadius, false);
  else if (g) SSIM_EMU_BWD(0, true);
  else SSIM_EMU_BWD(0, false);
#undef SSIM_EMU_BWD
  fwrite(da.data(), 4, np, o);
  fwrite(db.data(), 4, np, o);
  fclose(o);
  return 0;
}
