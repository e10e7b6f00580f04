// Band products on Hopper's tensor cores with a 3-term bf16 split: the
// relaxed accuracy tier (accuracy="relaxed") of ssim_fwd.cu and ssim_bwd.cu.
//
// Replaces the split MXU dots of the JAX package's relaxed tier
// (ssim_tpu/ops/ssim_pallas.py::_make_hpass_mxu(exact=False), :168-215, and
// the vpass of ssim_tpu/ops/ssim_grad.py::_grad_call, :500-516): a blur
// out[m] = sum_{j=0..2r} taps[j] * x[m + j] is a product with the Toeplitz
// band H[m][k] = taps[k - m]. x and H are each split into bf16 parts,
// x1 = bf16(x) (round to nearest even) and x2 = bf16(x - x1), likewise
// h1, h2 for H, and three products are added in f32: x1 h1 + x1 h2 + x2 h1.
// bf16 products are exact in f32, so the error is the dropped x2 h2 term
// and the split's residual, ~2^-17 relative (the JAX package measured that
// a fourth product does not help, ssim_pallas.py:137-148).
//
// One warp sweeps a strip of 8 lines (rows for a horizontal pass, columns
// for a vertical one) along the pass, one tile of 16 outputs at a time,
// with mma.sync m16n8k16 (bf16 inputs, f32 accumulators): A (16 outputs x
// 16 k) is the band, the same for every tile, and B (16 k x 8 lines) the
// data. A tile's 16 + 2r inputs span ksteps(r) k-steps of 16 (2 up to
// r = 8, 3 up to r = 16); the next tile starts one k-step later, so a
// sweep loads and splits each k-step of data once and keeps it in
// registers for the tiles that read it. The data comes from the caller's
// f32 values in shared memory, two adjacent inputs of a line at a time,
// and is split in registers as it is loaded, so the tile kernels use no
// shared memory beyond their standard modes' (and keep their blocks per
// SM); the caller's loader zeroes inputs past the valid ones (a NaN or inf
// there, times a zero of the band, would poison the sum) and clamps lines
// past the valid ones, whose outputs it drops. The band's fragments are
// made from the taps at the sweep's start, or once per block by a caller
// that keeps them (the streaming kernels, in shared memory). The relaxed
// backward's streaming kernel also runs vertical passes with the band as
// the B operand (make_band_b) on data kept split in shared memory, moved
// by ldmatrix / stmatrix. The mma adds in another order than a chain of
// IEEE f32 adds, so the kernels are held against their PyTorch twins
// (band_bf16x3_plain in ops/ssim_cuda.py) at a stated tolerance, not bit
// for bit. A host build (tests/fwd_stream_emu) defines BAND_MMA_HOST_MODEL
// and supplies its own model of mma, ldmatrix and stmatrix, the PTX
// instructions here.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace band_mma {

// k-steps of 16 inputs feeding a tile of 16 outputs at radius r: 2 up to
// r = 8, 3 up to r = 16 (the kernels' largest radius).
__host__ __device__ constexpr int ksteps(int r) { return (16 + 2 * r + 15) / 16; }

// x0, x1 into packed bf16x2 hi = bf16(x) and lo = bf16(x - hi), both
// rounded to nearest even (as torch's .to(torch.bfloat16)); x0 in the low
// half, the fragment layouts' order.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d += a * b for one m16n8k16 tile: a 4 registers (16 x 16 bf16, row major),
// b 2 registers (16 x 8 bf16, column major), d 16 x 8 f32.
#ifdef BAND_MMA_HOST_MODEL
void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1);
#else
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
#endif

// The band's A fragments, hi and lo, per k-step: A[m][16 ks + k] =
// taps[16 ks + k - m] (zero outside 0..2r) for the 16 outputs m of a tile
// along the pass. Register q holds rows m = g + 8 (q & 1) and columns
// k = 2t + 8 (q >> 1) + {0, 1} (lane = 4g + t), the m16n8k16 layout.
template <int NKS>
struct Band {
  uint32_t hi[NKS][4];
  uint32_t lo[NKS][4];
};

template <int NKS>
__device__ __forceinline__ Band<NKS> make_band(const float* taps, int r) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto tap = [&](int j) {
    return (j >= 0 && j <= 2 * r) ? taps[min(max(j, 0), 2 * r)] : 0.0f;
  };
  Band<NKS> bd;
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 16 * ks + 2 * t + 8 * (q >> 1) - (g + 8 * (q & 1));
      split2(tap(j), tap(j + 1), bd.hi[ks][q], bd.lo[ks][q]);
    }
  }
  return bd;
}

// One warp's sweep along a pass (NKS = ksteps(r), a template parameter so
// that each kernel holds the registers of one sweep only): output tiles T
// in [t0, t1) of 16 outputs along it (out[16 T + m] = sum_j taps[j]
// in[16 T + m + j]) for one strip of 8 lines across it, P planes at once,
// with the band's fragments bd. Tile T reads the k-steps of 16 inputs
// T .. T + NKS - 1, so each k-step's B fragments (the data, split in
// registers) are loaded once and kept for the NKS tiles that read them.
// load2(i, v) fills v[0][0..P) and v[1][0..P) with the planes' inputs at
// indices i and i + 1 (i even) along the pass on this thread's line g of
// the strip; store(T, acc) takes the tile's fragments, whose element e is
// output 16 T + g + 8 (e >> 1) along the pass on line 2t + (e & 1) of the
// strip.
template <int P, int NKS, typename Load2, typename Store>
__device__ __forceinline__ void sweep(const Band<NKS>& bd, int t0, int t1,
                                      Load2&& load2, Store&& store) {
  const int t = threadIdx.x & 3;
  uint32_t win[NKS][P][4];  // [k-step][plane][b0 hi, b1 hi, b0 lo, b1 lo]
  auto fetch = [&](uint32_t(&w)[P][4], int j) {
    float lo[2][P], hi[2][P];  // inputs 2t, 2t + 1 and 2t + 8, 2t + 9
    load2(16 * j + 2 * t, lo);
    load2(16 * j + 2 * t + 8, hi);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      split2(lo[0][p], lo[1][p], w[p][0], w[p][2]);
      split2(hi[0][p], hi[1][p], w[p][1], w[p][3]);
    }
  };
#pragma unroll
  for (int s = 0; s < NKS - 1; ++s) fetch(win[s], t0 + s);
  for (int T = t0; T < t1; ++T) {
    fetch(win[NKS - 1], T + NKS - 1);
    float acc[P][4];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        mma(acc[p], bd.hi[ks], win[ks][p][2], win[ks][p][3]);
        mma(acc[p], bd.lo[ks], win[ks][p][0], win[ks][p][1]);
        mma(acc[p], bd.hi[ks], win[ks][p][0], win[ks][p][1]);
      }
    }
    store(T, acc);
#pragma unroll
    for (int s = 0; s < NKS - 1; ++s) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) win[s][p][q] = win[s + 1][p][q];
      }
    }
  }
}

// The band as the B operand, for a pass whose 8 outputs lie along the mma's
// N and its inputs along K (the data is A, 16 lines x 16 inputs): per
// k-step, B[16 ks + k][n] = taps[16 ks + k - n] (zero outside 0..2r), hi
// and lo. Register q holds k = 2t + 8q + {0, 1} and n = g (lane = 4g + t),
// the m16n8k16 layout of B.
template <int NKS>
struct BandB {
  uint32_t hi[NKS][2];
  uint32_t lo[NKS][2];
};

template <int NKS>
__device__ __forceinline__ BandB<NKS> make_band_b(const float* taps, int r) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto tap = [&](int j) {
    return (j >= 0 && j <= 2 * r) ? taps[min(max(j, 0), 2 * r)] : 0.0f;
  };
  BandB<NKS> bd;
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = 16 * ks + 2 * t + 8 * q - g;
      split2(tap(j), tap(j + 1), bd.hi[ks][q], bd.lo[ks][q]);
    }
  }
  return bd;
}

// Fragments to and from shared memory, 8 x 8 matrices of b16 (bf16 parts),
// each row 16 bytes at the address one lane gives (ldmatrix / stmatrix,
// .trans): lane 8i + j gives row j of matrix i. ldsm_x4_trans fills d[i]
// with rows 2t, 2t + 1 of matrix i at column g (lane = 4g + t): with rows
// along the pass and columns across it, the A fragment of 16 lines x 16
// inputs is matrices {inputs 0-7, lines 0-7}, {0-7, 8-15}, {8-15, 0-7},
// {8-15, 8-15}. ldsm_x2_trans: matrices 0 and 1 (lanes 0-15 give the
// rows). stsm_x4_trans stores s[i], an accumulator's pair (row g, columns
// 2t and 2t + 1) of matrix i, transposed: the matrix's column j to row j.
#ifdef BAND_MMA_HOST_MODEL
void ldsm_x4_trans(uint32_t (&d)[4], const void* row);
void ldsm_x2_trans(uint32_t (&d)[2], const void* row);
void stsm_x4_trans(void* row, const uint32_t (&s)[4]);
#else
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&d)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_addr(row))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&d)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(d[0]), "=r"(d[1])
               : "r"(smem_addr(row))
               : "memory");
}
__device__ __forceinline__ void stsm_x4_trans(void* row, const uint32_t (&s)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :
               : "r"(smem_addr(row)), "r"(s[0]), "r"(s[1]), "r"(s[2]), "r"(s[3])
               : "memory");
}
#endif

// The same sweep with the band made from the taps (in shared memory) at its
// start, living only during it, and the data loaded one input at a time:
// load(i, v) fills v[0..P) with the planes' inputs at index i.
template <int P, int NKS, typename Load, typename Store>
__device__ __forceinline__ void sweep(const float* taps, int r, int t0, int t1,
                                      Load&& load, Store&& store) {
  sweep<P, NKS>(
      make_band<NKS>(taps, r), t0, t1,
      [&](int i, float(&v)[2][P]) {
        load(i, v[0]);
        load(i + 1, v[1]);
      },
      store);
}

// Warp jobs of a pass: `lines` lines across it in strips of 8, each strip's
// `tiles` output tiles in runs of at most 4 (a run reloads NKS - 1 k-steps
// at its start). Calls job(strip, t0, t1) for this warp's jobs.
template <typename Job>
__device__ __forceinline__ void for_jobs(int lines, int tiles, Job&& job) {
  const int nrun = (tiles + 3) / 4;
  const int run = (tiles + nrun - 1) / nrun;
  const int jobs = ((lines + 7) >> 3) * nrun;
  for (int j = threadIdx.x >> 5; j < jobs; j += blockDim.x >> 5) {
    const int strip = j / nrun, t0 = (j - strip * nrun) * run;
    job(strip, t0, min(tiles, t0 + run));
  }
}

}  // namespace band_mma
