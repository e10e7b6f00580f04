// The kernels' band_mma.cuh (ssim_tpu_torch/csrc, next on the include
// path) with its PTX instructions modelled on the host: mma.sync m16n8k16
// bf16 -> f32, and ldmatrix / stmatrix below. For mma, the warp's 32 lanes
// leave their fragments in a per-warp buffer (between two __syncwarp, the
// harness's per-warp barrier), and each lane forms its four outputs in the
// fragment layouts the header documents. Each output is its accumulator plus the 16
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

// ldmatrix / stmatrix (.trans) over the same exchange: each lane leaves its
// row address (and stmatrix's registers); lane 8i + j's address is row j of
// matrix i. ldmatrix.trans gives lane 4g + t of matrix i its rows 2t and
// 2t + 1 at column g; stmatrix.trans writes row j of matrix i with column j
// of the fragment (element c from lane 4c + j / 2, half j % 2).
inline const void* g_row[32][32];
inline uint32_t g_stsm[32][32][4];

inline uint16_t row_half(const void* row, int c) {
  return static_cast<const uint16_t*>(row)[c];
}

template <int N>
void ldsm_trans(uint32_t (&d)[N], const void* row) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_row[w][l] = row;
  __syncwarp();
  const int g = l >> 2, t = l & 3;
  for (int i = 0; i < N; ++i) {
    const uint32_t lo = row_half(g_row[w][8 * i + 2 * t], g);
    const uint32_t hi = row_half(g_row[w][8 * i + 2 * t + 1], g);
    d[i] = lo | (hi << 16);
  }
  __syncwarp();
}
void ldsm_x4_trans(uint32_t (&d)[4], const void* row) { ldsm_trans<4>(d, row); }
void ldsm_x2_trans(uint32_t (&d)[2], const void* row) { ldsm_trans<2>(d, row); }

void stsm_x4_trans(void* row, const uint32_t (&s)[4]) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_row[w][l] = row;
  for (int q = 0; q < 4; ++q) g_stsm[w][l][q] = s[q];
  __syncwarp();
  const int i = l >> 3, j = l & 7;
  uint16_t* dst = static_cast<uint16_t*>(const_cast<void*>(g_row[w][l]));
  for (int c = 0; c < 8; ++c) {
    const uint32_t word = g_stsm[w][4 * c + j / 2][i];
    dst[c] = (uint16_t)(j % 2 ? word >> 16 : word & 0xffffu);
  }
  __syncwarp();
}

}  // namespace band_mma
