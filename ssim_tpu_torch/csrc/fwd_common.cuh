// The forward kernels' common definitions: block size, tap bound, modes,
// halo operands, the blur type of each mode and the input conversions.
// Included by ssim_fwd.cu (the tile body and the row stream) and
// ssim_fwd_batch.cu (the batch modes' packed stream).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 33;  // radius <= 16

enum Mode {
  kScore = 0,
  kMap = 1,
  kComponents = 2,
  kPooled = 3,
  kPrecise = 4,
  kPreciseMap = 5,
  kBatch = 6,
  kBatchPrecise = 7,
  kRowsum = 8,
  kRowsumMap = 9,
};

// The halo operands of a row band: virtual rows [-r, 0) in at / bt and
// [H, H + r) in ab / bb, each (B, r, W); all NULL without them. is_top /
// is_bot: the band holds the image's first / last row, so the clamp
// applies there and the operand is not read.
template <typename T>
struct Halo {
  const T* at;
  const T* ab;
  const T* bt;
  const T* bb;
  int is_top;
  int is_bot;
};

template <typename T>
Halo<T> make_halo(const void* const* halo, int is_top, int is_bot) {
  return Halo<T>{static_cast<const T*>(halo[0]), static_cast<const T*>(halo[1]),
                 static_cast<const T*>(halo[2]), static_cast<const T*>(halo[3]),
                 is_top, is_bot};
}

// The precise modes blur in fp64 with the f64 taps; the others in f32.
template <int kMode>
constexpr bool kIsPrecise =
    kMode == kPrecise || kMode == kPreciseMap || kMode == kBatchPrecise;
template <int kMode>
using Blur = typename std::conditional<kIsPrecise<kMode>, double, float>::type;

template <typename P>
struct Taps {
  P t[kMaxTaps];
};

__device__ __forceinline__ float to_f32(uint8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ bool finite_f32(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
}

// nan_to_num followed by a clip to +-bound (ssim_pallas.py:879-882).
// NaN is tested first: fmaxf(NaN, x) would return x.
__device__ __forceinline__ float sanitize(float v, float bound) {
  if ((__float_as_uint(v) & 0x7fffffffu) > 0x7f800000u) return 0.0f;
  return fminf(fmaxf(v, -bound), bound);
}

}  // namespace
