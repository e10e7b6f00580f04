// Runs the standard tier's backward streams on the host (see cuda_runtime.h
// and emu_threads.h):
//   bwd_std_harness IN OUT [MAP]
// IN as bwd_harness.cpp's: int32 [B, H, W, TH, S, has_gmap, has_halo,
// is_top, is_bot, r, SW, two_pass] (SW must be 128, the standard stream's
// strip), then f32 taps[2r + 1], fold mass[r], [c1, c2, clip_bound], a and b
// (B*H*W each), w_s and w_cs (B each), with has_gmap g_map (B*H*W) and with
// has_halo a_top, a_bot, b_top, b_bot (B*2r*W each). two_pass = 0 runs the
// one-pass stream with the weight maps' window in registers
// (ssim_bwd_stream_kernel<r, G>, bwd_std_stream.cuh: radius 5 and the radii
// ssim_bwd_rt.cu builds it at), 1 the two-pass stream (bwd_std_rt.cuh:
// pass A into a scratch map that starts as NaN, then pass B). OUT receives
// da, db (B*H*W f32 each), NaN where the kernel wrote nothing; MAP (two-pass
// only) pass A's scratch: the tile mask (B * ceil(H / TH) * ceil(W / 64)
// words), then the weight maps (B * (H + 2r) * (W + 2r) float4). The test
// copies the headers without their host code and points their dynamic
// shared memory at the arena's (emu_dynamic_shared), which is NaN (bytes
// 0xff) at each block's start, as are their static shared arrays.
#include "emu_threads.h"

#include "bwd_std_rt.cuh"      // the kernels' source, cut by the test
#include "bwd_std_stream.cuh"  // likewise

template <class T> static std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) {
    fprintf(stderr, "short input\n");
    exit(1);
  }
  return v;
}

struct Args {
  int B, H, W, TH, S, r;
  const float *a, *b, *ws, *wcs, *gmap;
  float *da, *db;
  Halo halo;
  Coeffs co;
  float c1, c2, clip;
};

template <int kR, bool kGmap> static void run_window(const Args& x) {
  if (sizeof(float) * stream_smem_floats(x.r, true) > kEmuDynamic) {
    fprintf(stderr, "the block's shared memory exceeds the buffer\n");
    exit(1);
  }
  const int nstrip = (x.W + kStripW - 1) / kStripW, nseg = (x.H + x.S - 1) / x.S;
  run_blocks(x.B * nseg * nstrip, kStreamThreads, [&] {
    ssim_bwd_stream_kernel<kR, kGmap>(x.a, x.b, x.ws, x.wcs, x.gmap, x.da, x.db, x.halo, x.H,
                                      x.W, x.r, x.TH, x.S, nstrip, nseg, x.co, x.c1, x.c2,
                                      x.clip);
  });
}

template <bool kGmap> static void run_two_pass(const Args& x, FILE* dump) {
  const int r = x.r, Hm = x.H + 2 * r, Wm = x.W + 2 * r;
  if (rt_smem_a(r) > kEmuDynamic || rt_smem_b(r) > kEmuDynamic) {
    fprintf(stderr, "the block's shared memory exceeds the buffer\n");
    exit(1);
  }
  const float nan = NAN;
  std::vector<float4> wmap(rt_map_bytes(x.B, x.H, x.W, r) / sizeof(float4),
                           float4{nan, nan, nan, nan});
  std::vector<unsigned> bad(rt_mask_bytes(x.B, x.H, x.W, x.TH) / sizeof(unsigned), 0u);
  const int na_strip = (Wm + kRtMidW - 1) / kRtMidW, na_seg = (Hm + x.S - 1) / x.S;
  run_blocks(x.B * na_seg * na_strip, kRtMidW, [&] {
    ssim_bwd_rt_weights_kernel<kGmap>(x.a, x.b, x.ws, x.wcs, x.gmap, wmap.data(), bad.data(),
                                      x.halo, x.H, x.W, r, x.TH, x.S, na_strip, na_seg, x.co,
                                      x.c1, x.c2, x.clip);
  });
  const bool vhalo = x.halo.at != nullptr;
  const int nb_strip = (x.W + kStripW - 1) / kStripW, nb_seg = (x.H + x.S - 1) / x.S;
  run_blocks(x.B * nb_seg * nb_strip, kStripW + 2 * r, [&] {
    ssim_bwd_rt_adjoint_kernel(x.a, x.b, wmap.data(), bad.data(), x.da, x.db, x.H, x.W, r,
                               x.TH, x.S, nb_strip, nb_seg, !vhalo || x.halo.is_top,
                               !vhalo || x.halo.is_bot, x.co, x.clip);
  });
  if (dump) {
    fwrite(bad.data(), sizeof(unsigned), bad.size(), dump);
    fwrite(wmap.data(), sizeof(float4), wmap.size(), dump);
    fclose(dump);
  }
}

int main(int argc, char** argv) {
  if (argc != 3 && argc != 4) return 2;
  FILE* f = fopen(argv[1], "rb");
  FILE* o = fopen(argv[2], "wb");
  FILE* dump = argc == 4 ? fopen(argv[3], "wb") : nullptr;
  if (!f || !o || (argc == 4 && !dump)) return 2;
  const auto h = take<int>(f, 12);
  const int B = h[0], H = h[1], W = h[2], r = h[9], two_pass = h[11];
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
  std::vector<float> da(np, NAN), db(np, NAN);
  Args x{B, H, W, h[3], h[4], r, a.data(), b.data(), ws.data(), wcs.data(),
         h[5] ? gmap.data() : nullptr, da.data(), db.data(),
         Halo{h[6] ? ops[0].data() : nullptr, h[6] ? ops[1].data() : nullptr,
              h[6] ? ops[2].data() : nullptr, h[6] ? ops[3].data() : nullptr, h[7], h[8]},
         Coeffs{}, cc[0], cc[1], cc[2]};
  for (int k = 0; k < kMaxTaps; ++k) x.co.t[k] = k < 2 * r + 1 ? taps[k] : 0.0f;
  for (int k = 0; k < kMaxRadius; ++k) x.co.cl[k] = k < r ? cl[k] : 0.0f;
  const bool g = h[5] != 0;
  if (two_pass) {
    if (g) run_two_pass<true>(x, dump);
    else run_two_pass<false>(x, dump);
  } else {
#define SSIM_EMU_WINDOW(R)                    \
  case R:                                     \
    if (g) run_window<R, true>(x);            \
    else run_window<R, false>(x);             \
    break;
    switch (r) {
      SSIM_EMU_WINDOW(1)
      SSIM_EMU_WINDOW(2)
      SSIM_EMU_WINDOW(3)
      SSIM_EMU_WINDOW(4)
      SSIM_EMU_WINDOW(5)
      default:
        fprintf(stderr, "no one-pass stream at radius %d\n", r);
        return 2;
    }
#undef SSIM_EMU_WINDOW
  }
  fwrite(da.data(), 4, np, o);
  fwrite(db.data(), 4, np, o);
  fclose(o);
  return 0;
}
