// Fused SSIM forward for NVIDIA Hopper (sm_90a), standard f32 tier.
//
// Replaces the two TPU forward kernels of the JAX package in their
// standard and map modes: ssim_tpu/ops/ssim_pallas.py::_nopad_overlap_call
// (full-width row tiles, widths up to 16384 lanes) and
// ::_chunked_overlap_call (the same over lane chunks for wider images).
// That split exists only for TPU lane widths and VMEM; here one 2-D grid
// of output tiles covers every width.
//
// What bounds it on this card: per output pixel it reads 2 input values
// (u8 or f32) and writes at most one f32 map value, while it does about
// 4 signals x 2 passes x (3r + 1) f32 operations plus the formula (~150
// at radius 5). Device memory (3.35 TB/s) would allow ~1 Tpix/s for u8
// without a map, so the kernel is bound on chip, not by HBM: by the
// blurs' shared-memory traffic (~80 32-bit accesses per output pixel at
// radius 5) and instruction issue. It measured 30-39 Gpix/s on an H100,
// the same with and without FMA contraction, and the same with the L2
// flushed between launches.
// What the design does about it: each pixel of the halo tile is read from
// device memory once and converted to f32 on load; both blur passes run
// out of shared memory with symmetric tap pairs (r + 1 multiplies per
// pass), warp-contiguous addresses (no bank conflicts) and the four
// signals a, b, (a+b)^2, (a-b)^2 computed in one sweep. Later work: a
// compile-time radius, register-resident vertical passes and TMA loads.
//
// Numerics follow the JAX kernel: clamp-to-edge borders (indices are
// clamped as the halo tile is loaded; nothing is padded in device
// memory), nan_to_num + clip of float inputs with NaN poisoning of the
// tile when one of its own pixels is not finite, the four-signal formula
// of _ssim_from_blurs, and one f32 partial per tile holding
// sum(ssim - 1) + n_valid. One partial per block, no atomics: the result
// is deterministic. Build without --use_fast_math (it would flush
// subnormals and approximate the division) and with --fmad=false: each
// multiply and add then rounds as in the plain PyTorch twin
// (ops/ssim_cuda.py::ssim_parts_plain), which does the same operations
// in the same order, so per-pixel values match the twin bit for bit and
// only the order of the tile sums differs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 33;  // radius <= 16

struct Taps {
  float t[kMaxTaps];
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

template <typename T, bool kMap>
__global__ void __launch_bounds__(kThreads)
ssim_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                float* __restrict__ partials, float* __restrict__ map,
                int H, int W, int r, int TH, int TW, int ntx,
                int tiles_per_image, Taps taps, float c1, float c2,
                float clip_bound) {
  constexpr bool kFloat = sizeof(T) == 4;
  extern __shared__ float smem[];
  __shared__ float s_taps[kMaxTaps];
  __shared__ float s_warp[kThreads / 32];

  const int HR = TH + 2 * r;  // halo rows
  const int HW = TW + 2 * r;  // halo columns
  float* sa = smem;           // HR x HW
  float* sb = sa + HR * HW;   // HR x HW
  float* hp = sb + HR * HW;   // 4 planes of HR x TW: mu_a, mu_b, ss, dd
  const int plane = HR * TW;

  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) s_taps[k] = taps.t[k];
  }

  const int tile = blockIdx.x;
  const int img = tile / tiles_per_image;
  const int rem = tile - img * tiles_per_image;
  const int y0 = (rem / ntx) * TH;
  const int x0 = (rem % ntx) * TW;
  const int vh = min(TH, H - y0);  // valid output rows of this tile
  const int vw = min(TW, W - x0);  // valid output columns
  const size_t base = (size_t)img * (size_t)H * (size_t)W;

  // TW is a power of two in [32, 256], so TW threads cover a row.
  const int tx = tid % TW;
  const int ty = tid / TW;
  const int ystep = kThreads / TW;

  // Load the halo tile with clamped indices, converting to f32.
  int bad = 0;
  for (int ly = ty; ly < vh + 2 * r; ly += ystep) {
    const int uy = y0 - r + ly;
    const int gy = min(max(uy, 0), H - 1);
    const size_t row = base + (size_t)gy * (size_t)W;
    for (int lx = tx; lx < vw + 2 * r; lx += TW) {
      const int ux = x0 - r + lx;
      const int gx = min(max(ux, 0), W - 1);
      float va = to_f32(a[row + gx]);
      float vb = to_f32(b[row + gx]);
      if (kFloat) {
        // Poison source: the tile's own valid pixels, unsanitised.
        const bool own = ly >= r && ly < r + vh && lx >= r && lx < r + vw;
        if (own && !(finite_f32(va) && finite_f32(vb))) bad = 1;
        va = sanitize(va, clip_bound);
        vb = sanitize(vb, clip_bound);
      }
      sa[ly * HW + lx] = va;
      sb[ly * HW + lx] = vb;
    }
  }
  bad = __syncthreads_or(bad);

  // Horizontal pass over every halo row: four signals, symmetric pairs,
  // smallest taps first.
  for (int ly = ty; ly < vh + 2 * r; ly += ystep) {
    for (int lx = tx; lx < vw; lx += TW) {
      const float* ra = sa + ly * HW + lx + r;
      const float* rb = sb + ly * HW + lx + r;
      float ma = 0.0f, mb = 0.0f, ss = 0.0f, dd = 0.0f;
      for (int d = r; d >= 1; --d) {
        const float t = s_taps[r - d];
        const float al = ra[-d], ah = ra[d], bl = rb[-d], bh = rb[d];
        const float sl = al + bl, sh = ah + bh, dl = al - bl, dh = ah - bh;
        ma += t * (al + ah);
        mb += t * (bl + bh);
        ss += t * (sl * sl + sh * sh);
        dd += t * (dl * dl + dh * dh);
      }
      const float tc = s_taps[r];
      const float ac = ra[0], bc = rb[0];
      const float sc = ac + bc, dc = ac - bc;
      const int o = ly * TW + lx;
      hp[o] = ma + tc * ac;
      hp[plane + o] = mb + tc * bc;
      hp[2 * plane + o] = ss + tc * (sc * sc);
      hp[3 * plane + o] = dd + tc * (dc * dc);
    }
  }
  __syncthreads();

  // Vertical pass, the SSIM formula, the map and the tile sum.
  float local = 0.0f;
  for (int ly = ty; ly < vh; ly += ystep) {
    for (int lx = tx; lx < vw; lx += TW) {
      const float* c = hp + (ly + r) * TW + lx;
      float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f, m3 = 0.0f;
      for (int d = r; d >= 1; --d) {
        const float t = s_taps[r - d];
        const int o = d * TW;
        m0 += t * (c[-o] + c[o]);
        m1 += t * (c[plane - o] + c[plane + o]);
        m2 += t * (c[2 * plane - o] + c[2 * plane + o]);
        m3 += t * (c[3 * plane - o] + c[3 * plane + o]);
      }
      const float tc = s_taps[r];
      const float mu_a = m0 + tc * c[0];
      const float mu_b = m1 + tc * c[plane];
      const float s_ss = m2 + tc * c[2 * plane];
      const float s_dd = m3 + tc * c[3 * plane];
      // _ssim_from_blurs (ssim_pallas.py:465-477).
      const float mu_a2 = mu_a * mu_a;
      const float mu_b2 = mu_b * mu_b;
      const float mu_ab = mu_a * mu_b;
      const float sigma_ab_x4 = (s_ss - s_dd) - 4.0f * mu_ab;
      const float sigma_sum_x2 = (s_ss + s_dd) - 2.0f * (mu_a2 + mu_b2);
      const float num = (2.0f * mu_ab + c1) * (0.5f * sigma_ab_x4 + c2);
      const float den = (mu_a2 + mu_b2 + c1) * (0.5f * sigma_sum_x2 + c2);
      float v = num / den;
      if (kFloat && bad) v = __int_as_float(0x7fc00000);  // NaN
      if (kMap) {
        map[base + (size_t)(y0 + ly) * (size_t)W + (size_t)(x0 + lx)] = v;
      }
      local += v - 1.0f;
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    local += __shfl_down_sync(0xffffffffu, local, off);
  }
  if ((tid & 31) == 0) s_warp[tid >> 5] = local;
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += s_warp[w];
    partials[tile] = s + (float)(vh * vw);
  }
}

template <typename T, bool kMap>
cudaError_t launch(const void* a, const void* b, void* partials, void* map,
                   int B, int H, int W, int r, int TH, int TW,
                   const float* taps_host, float c1, float c2,
                   float clip_bound, cudaStream_t stream) {
  Taps taps;
  for (int k = 0; k < kMaxTaps; ++k) {
    taps.t[k] = k < 2 * r + 1 ? taps_host[k] : 0.0f;
  }
  const int ntx = (W + TW - 1) / TW;
  const int nty = (H + TH - 1) / TH;
  const int tiles_per_image = ntx * nty;
  const long long blocks = (long long)B * tiles_per_image;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem =
      sizeof(float) * ((size_t)2 * (TH + 2 * r) * (TW + 2 * r) +
                       (size_t)4 * (TH + 2 * r) * TW);
  cudaError_t err = cudaFuncSetAttribute(
      ssim_fwd_kernel<T, kMap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssim_fwd_kernel<T, kMap><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(partials), static_cast<float*>(map), H, W, r, TH,
      TW, ntx, tiles_per_image, taps, c1, c2, clip_bound);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes. is_float: 0 = uint8 inputs, 1 = float32 inputs.
// partials: (B, ceil(H/TH) * ceil(W/TW)) f32; map: (B, H, W) f32 or NULL.
// taps_host: 2r+1 floats in host memory. Returns the launch's cudaError_t.
extern "C" int ssim_fwd_launch(int is_float, const void* a, const void* b,
                               void* partials, void* map, int B, int H, int W,
                               int r, int TH, int TW, const float* taps_host,
                               float c1, float c2, float clip_bound,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float) {
    return map ? launch<float, true>(a, b, partials, map, B, H, W, r, TH, TW,
                                     taps_host, c1, c2, clip_bound, s)
               : launch<float, false>(a, b, partials, map, B, H, W, r, TH, TW,
                                      taps_host, c1, c2, clip_bound, s);
  }
  return map ? launch<uint8_t, true>(a, b, partials, map, B, H, W, r, TH, TW,
                                     taps_host, c1, c2, clip_bound, s)
             : launch<uint8_t, false>(a, b, partials, map, B, H, W, r, TH, TW,
                                      taps_host, c1, c2, clip_bound, s);
}
