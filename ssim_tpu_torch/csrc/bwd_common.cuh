// The backward kernels' common definitions: the bounds, the strip and NaN
// tile, the coefficients and halo operands, the input sanitising, the weight
// maps of ssim_grad.py:535-560, the NaN tiles, and the dynamic
// shared-memory limit. Included by ssim_bwd.cu (the standard stream, the
// relaxed stream at radius 5) and ssim_bwd_relaxed_rt.cu (the relaxed stream
// at the other radii), each a translation unit of its own.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxTaps = 33;    // radius <= 16
constexpr int kMaxRadius = 16;

// The streaming blocks' strip: kStripW output columns (two NaN tiles of
// kTileW; the relaxed stream's strip is one tile wide at some radii).
constexpr int kStripW = 128;
constexpr int kTileW = 64;
// NaN tiles down one segment: the block's tile mask holds 2 x 16 bits.
constexpr int kMaxSegTiles = 16;

// The radius whose weight-map window is registers in the standard stream
// and which the relaxed stream compiles in (windows.RADIUS, every
// main-path shape).
constexpr int kWindowRadius = 5;

struct Coeffs {
  float t[kMaxTaps];     // Gaussian taps, 2r + 1 used
  float cl[kMaxRadius];  // clamp-fold mass: cl[x] = sum_{k > r + x} t[k]
};

// The halo operands of a row band: virtual rows [-2r, 0) in at / bt and
// [H, H + 2r) in ab / bb, each (B, 2r, W) f32; all NULL without them.
// is_top / is_bot: the band holds the image's first / last row.
struct Halo {
  const float* at;
  const float* ab;
  const float* bt;
  const float* bb;
  int is_top;
  int is_bot;
};

__device__ __forceinline__ bool finite_f32(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
}

// nan_to_num followed by a clip to +-bound (ssim_grad.py:381-383).
__device__ __forceinline__ float sanitize(float v, float bound) {
  if ((__float_as_uint(v) & 0x7fffffffu) > 0x7f800000u) return 0.0f;
  return fminf(fmaxf(v, -bound), bound);
}

// The weight maps W_u, W_v, W_ss, W_dd from the four blurred signals, in
// the order of ssim_grad.py:536-560.
__device__ __forceinline__ void weights4(float u, float v, float ss, float dd,
                                         float coeff, float wcs, float c1,
                                         float c2, float (&w)[4]) {
  const float uv = u * v;
  const float usq = u * u + v * v;
  const float a1 = 2.0f * uv + c1;
  const float a2 = 0.5f * (ss - dd) - 2.0f * uv + c2;
  const float b1 = usq + c1;
  const float b2 = 0.5f * (ss + dd) - usq + c2;
  const float rb1 = 1.0f / b1;
  const float rb2 = 1.0f / b2;
  const float lum = a1 * rb1;
  const float cs = a2 * rb2;
  const float s_val = lum * cs;
  const float half_rb2 = 0.5f * rb2;
  const float d_ss_c = half_rb2 * (1.0f - cs);
  const float d_dd_c = -half_rb2 * (1.0f + cs);
  const float q = a2 - a1;
  const float rb12 = rb1 * rb2;
  const float drb = rb1 - rb2;
  w[0] = coeff * (2.0f * v * q * rb12 - 2.0f * u * s_val * drb) +
         wcs * ((2.0f * u * cs - 2.0f * v) * rb2);
  w[1] = coeff * (2.0f * u * q * rb12 - 2.0f * v * s_val * drb) +
         wcs * ((2.0f * v * cs - 2.0f * u) * rb2);
  w[2] = (coeff * lum + wcs) * d_ss_c;
  w[3] = (coeff * lum + wcs) * d_dd_c;
}

// The NaN tiles of a block (output rows y0 .. y0 + vh - 1, columns x0 ..
// x0 + vw - 1, tiles TH x kTileW) that a non-finite input at virtual row
// vi, image column xv reaches: those whose pixels lie within 2r of it; bit
// 2 * tile row + tile column (rare path). The relaxed stream's; the
// standard stream keeps the same code inline (mark_bad), as calling these
// changed its instantiations' SASS.
__device__ __forceinline__ unsigned nan_tile_bits(int vi, int xv, int y0, int x0,
                                                  int vh, int vw, int H, int W,
                                                  int TH, int r) {
  const int ntc = (vw + kTileW - 1) / kTileW;
  const int ntr = (vh + TH - 1) / TH;
  unsigned bits = 0u;
  for (int kr = 0; kr < ntr; ++kr) {
    const int ty0 = y0 + kr * TH;
    const int vth = min(TH, H - ty0);
    if (vi < ty0 - 2 * r || vi > ty0 + vth - 1 + 2 * r) continue;
    for (int kc = 0; kc < ntc; ++kc) {
      const int tx0 = x0 + kc * kTileW;
      const int vtw = min(kTileW, W - tx0);
      if (xv >= tx0 - 2 * r && xv <= tx0 + vtw - 1 + 2 * r) {
        bits |= 1u << (2 * kr + kc);
      }
    }
  }
  return bits;
}

// NaN over the tiles set in `bad` (nan_tile_bits) of a block's vh x vw
// outputs at da / db + base, by its nt threads (after every finite write of
// the block: the caller's last barrier).
__device__ __forceinline__ void poison_tiles(unsigned bad, float* da, float* db,
                                             size_t base, int y0, int x0, int vh,
                                             int vw, int W, int TH, int tid, int nt) {
  const float nan = __int_as_float(0x7fc00000);
  for (int i = tid; i < vh * vw; i += nt) {
    const int y = i / vw;
    const int x = i - y * vw;
    if ((bad >> (2 * (y / TH) + x / kTileW)) & 1u) {
      const size_t p = base + (size_t)(y0 + y) * (size_t)W + (size_t)(x0 + x);
      da[p] = nan;
      db[p] = nan;
    }
  }
}

// Host code from here (the host build of the kernels' source,
// tests/fwd_stream_emu, takes what is above).

// Sets a kernel's dynamic shared-memory limit once per instantiation,
// device and size (the largest asked so far), not on every launch; at every
// size, for the kernel's static arrays count against the default 48 KB too.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int (&done)[64],
                       std::mutex& mu) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < 64 && (int)bytes <= done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = (int)bytes;
  return err;
}

}  // namespace
