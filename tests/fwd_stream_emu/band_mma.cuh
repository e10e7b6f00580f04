// The kernels' band_mma.cuh (ssim_tpu_torch/csrc, next on the include
// path) with its one PTX instruction, mma.sync m16n8k16 bf16 -> f32,
// modelled on the host: the warp's 32 lanes leave their fragments in a
// per-warp buffer (between two __syncwarp, the harness's per-warp
// barrier), and each lane forms its four outputs in the fragment layouts
// the header documents. Each output is its accumulator plus the 16
// products (exact in double, added in k order in double), rounded once to
// f32: the tensor cores' own order of adds is not specified, so kernel
// and twin are held to a tolerance, not bit for bit.
#pragma once
#include "cuda_runtime.h"
#define BAND_MMA_HOST_MODEL
#include_next "band_mma.cuh"

namespace band_mma {

inline uint32_t g_frag[32][32][6];  // [warp][lane]: a[0..3], b0, b1

inline float bf16_half(uint32_t word, int half) {
  return __emu_bf16_f32((uint16_t)(half ? word >> 16 : word & 0xffffu));
}

void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  uint32_t* mine = g_frag[w][l];
  for (int q = 0; q < 4; ++q) mine[q] = a[q];
  mine[4] = b0;
  mine[5] = b1;
  __syncwarp();
  // A[m][k]: lane 4 (m % 8) + (k % 8) / 2, register (m / 8) + 2 (k / 8),
  // half k % 2; B[k][n]: lane 4 n + (k % 8) / 2, register 4 + k / 8, half
  // k % 2; D[m][n] in lane 4 (m % 8) + n / 2, element 2 (m / 8) + n % 2.
  auto A = [&](int m, int k) {
    return bf16_half(g_frag[w][4 * (m % 8) + (k % 8) / 2][m / 8 + 2 * (k / 8)], k % 2);
  };
  auto B = [&](int k, int n) {
    return bf16_half(g_frag[w][4 * n + (k % 8) / 2][4 + k / 8], k % 2);
  };
  const int g = l >> 2, t = l & 3;
  for (int e = 0; e < 4; ++e) {
    const int m = g + 8 * (e >> 1), n = 2 * t + (e & 1);
    double s = 0.0;
    for (int k = 0; k < 16; ++k) s += (double)A(m, k) * (double)B(k, n);
    d[e] = (float)((double)d[e] + s);
  }
  __syncwarp();
}

}  // namespace band_mma
