// Fused SSIM forward for NVIDIA Hopper (sm_90a): the standard f32 tier,
// the precise (fp64) tier, and the MS-SSIM components modes.
//
// Replaces the two TPU forward kernels of the JAX package:
// ssim_tpu/ops/ssim_pallas.py::_nopad_overlap_call (:710; full-width row
// tiles, widths up to 16384 lanes) in its modes a (standard, with or
// without the map), b (precise), c (components) and d (pool_out, u8 and
// f32), and ::_chunked_overlap_call (:1364; the same over lane chunks for
// wider images) in its standard, map, precise and components modes. That
// split exists only for TPU lane widths and VMEM; here one 2-D grid of
// output tiles covers every width, so K2's modes need no kernel of their
// own.
//
// Modes (compile time, one copy of the halo load and the two blurs):
// - kScore / kMap: one f32 partial per tile, sum(ssim - 1) + n_valid, with
//   the SSIM formula of _ssim_from_blurs; kMap also writes the map.
// - kPrecise / kPreciseMap (precision="f64", the counterpart of the
//   reference's RMGR_SSIM_USE_DOUBLE build): the same f32 blurs, bit for
//   bit the standard modes', then the four blurred signals widened to
//   double and the formula of _ssim_from_blurs evaluated in native fp64
//   (num / den, the algebra the TPU kernel compensates in df32,
//   _ssim_from_blurs_df32, ssim_pallas.py:621-644), the tile's
//   sum(ssim - 1) accumulated in double, and ONE fp64 partial per tile,
//   sum(ssim - 1) + n_valid. The TPU kernel writes two f32 partials per
//   tile (the df32 hi and lo + e, :1188-1195); both are summed in f64 by
//   engine.finalize_mean, so the score is the same quantity. kPreciseMap
//   also writes the map as the f32 rounding of the fp64 value (the TPU
//   map is the df32 hi). c1 and c2 arrive as doubles, so the precise
//   formula sees them unrounded; the f32 modes take them rounded to
//   float on the host (c1f, c2f), as before the precise modes existed.
// - kComponents (MS-SSIM, _l_cs_from_blurs, ssim_pallas.py:480-490 and
//   :1196-1199): lum and cs from the four blurs, ssim = lum * cs (not the
//   standard num / den, so the last bits differ from kScore), and two
//   partials per tile, sum(cs - 1) + n_valid and sum(ssim - 1) + n_valid.
// - kPooled: kComponents plus the 2x2-mean images (B, H/2, W/2) f32 of a
//   and b, the MS-SSIM pyramid's next scale (ssim_pallas.py:1100-1174).
//   Each tile pools its own pixels (TH and TW even), from the raw inputs
//   in device memory, not the sanitised halo: a u8 value converts
//   exactly, and a NaN in f32 input reaches its own pooled pixel as
//   _downsample2's reduce_window carries it. Vertical pairs are added
//   first, then horizontal, then * 0.25; only pooled rows < H/2 and
//   columns < W/2 are written, so an odd last row or column is dropped
//   and no row past the image is read. (The Pallas f32 pool fed the
//   unmasked rows of a ragged tile into a matrix product, which made its
//   pooled images NaN; reading only rows inside the image repairs that.)
//
// What bounds it on this card: per output pixel it reads 2 input values
// (u8 or f32) and writes at most one f32 map value (kPooled: half an f32
// per input pixel), while the function needs 24r + 43 f32 operations
// (163 at radius 5: 4 signals x 2 passes x (3r + 2), the signals and the
// formula; kComponents 24r + 45, kPooled 24r + 47; kPrecise 24r + 20 in
// f32 and 27 in fp64; counted in chip_smoke.py). Device memory (3.35
// TB/s) would allow ~1 Tpix/s for u8 without a map and the f32 peak ~410
// Gpix/s, so the kernel is bound on chip: by the blurs' shared-memory
// traffic (~80 32-bit accesses per output pixel at radius 5) and
// instruction issue. It measured 30-39 Gpix/s in mode kScore on an H100,
// the same with and without FMA contraction, and the same with the L2
// flushed between launches. The pool adds 2 operations and reads the
// tile's inputs once more, from L1 or L2, where the halo load has just
// brought them. The precise formula is ~27 fp64 operations, one of them a
// division (a short software sequence), against ~140 f32 blur operations
// per pixel.
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
// tile (its ssim and cs alike) when one of its own pixels is not finite,
// the four-signal formulas, and per-tile partials of x - 1 plus n_valid.
// One partial per block and value, no atomics: the result is
// deterministic. Build without --use_fast_math (it would flush subnormals
// and approximate the division) and with --fmad=false: each multiply and
// add, f32 or fp64, then rounds as in the plain PyTorch twins
// (ops/ssim_cuda.py), which do the same operations in the same order, and
// fp64 division is IEEE, so per-pixel values and pooled images match the
// twins bit for bit and only the order of the tile sums differs.

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
};

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

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
ssim_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                void* __restrict__ partials, float* __restrict__ map,
                float* __restrict__ pool_a, float* __restrict__ pool_b,
                int H, int W, int r, int TH, int TW, int ntx,
                int tiles_per_image, Taps taps, float c1f, float c2f,
                double c1, double c2, float clip_bound) {
  constexpr bool kFloat = sizeof(T) == 4;
  constexpr bool kComp = kMode == kComponents || kMode == kPooled;
  constexpr bool kPrec = kMode == kPrecise || kMode == kPreciseMap;
  constexpr bool kWithMap = kMode == kMap || kMode == kPreciseMap;
  // The tile sums' type: double in the precise modes, else float.
  using Acc = typename std::conditional<kPrec, double, float>::type;
  extern __shared__ float smem[];
  __shared__ float s_taps[kMaxTaps];
  __shared__ Acc s_warp[kComp ? 2 : 1][kThreads / 32];  // [0]: ssim, [1]: cs

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

  // Vertical pass, the SSIM formula, the map and the tile sums.
  Acc local = 0, local_cs = 0;
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
      Acc v, cs = 0;
      if constexpr (kPrec) {
        // _ssim_from_blurs (ssim_pallas.py:465-477) in fp64 on the
        // widened f32 blurs.
        const double da = mu_a, db = mu_b, dss = s_ss, ddd = s_dd;
        const double mu_a2 = da * da;
        const double mu_b2 = db * db;
        const double mu_ab = da * db;
        const double sigma_ab_x4 = (dss - ddd) - 4.0 * mu_ab;
        const double sigma_sum_x2 = (dss + ddd) - 2.0 * (mu_a2 + mu_b2);
        const double num = (2.0 * mu_ab + c1) * (0.5 * sigma_ab_x4 + c2);
        const double den = (mu_a2 + mu_b2 + c1) * (0.5 * sigma_sum_x2 + c2);
        v = num / den;
      } else {
        // _ssim_from_blurs (ssim_pallas.py:465-477) or, for the
        // components, _l_cs_from_blurs (:480-490).
        const float mu_a2 = mu_a * mu_a;
        const float mu_b2 = mu_b * mu_b;
        const float mu_ab = mu_a * mu_b;
        const float sigma_ab_x4 = (s_ss - s_dd) - 4.0f * mu_ab;
        const float sigma_sum_x2 = (s_ss + s_dd) - 2.0f * (mu_a2 + mu_b2);
        if (kComp) {
          const float lum = (2.0f * mu_ab + c1f) / (mu_a2 + mu_b2 + c1f);
          cs = (0.5f * sigma_ab_x4 + c2f) / (0.5f * sigma_sum_x2 + c2f);
          v = lum * cs;
        } else {
          const float num = (2.0f * mu_ab + c1f) * (0.5f * sigma_ab_x4 + c2f);
          const float den =
              (mu_a2 + mu_b2 + c1f) * (0.5f * sigma_sum_x2 + c2f);
          v = num / den;
        }
      }
      if (kFloat && bad) {
        v = (Acc)__int_as_float(0x7fc00000);  // NaN
        cs = v;
      }
      if (kWithMap) {
        map[base + (size_t)(y0 + ly) * (size_t)W + (size_t)(x0 + lx)] =
            (float)v;
      }
      local += v - (Acc)1;
      if (kComp) local_cs += cs - (Acc)1;
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    local += __shfl_down_sync(0xffffffffu, local, off);
    if (kComp) local_cs += __shfl_down_sync(0xffffffffu, local_cs, off);
  }
  if ((tid & 31) == 0) {
    s_warp[0][tid >> 5] = local;
    if constexpr (kComp) s_warp[1][tid >> 5] = local_cs;
  }
  __syncthreads();
  if (tid == 0) {
    const Acc n_valid = (Acc)(vh * vw);
    Acc s = 0, s_cs = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      s += s_warp[0][w];
      if constexpr (kComp) s_cs += s_warp[1][w];
    }
    if constexpr (kComp) {
      float* p = static_cast<float*>(partials);
      p[2 * (size_t)tile] = s_cs + n_valid;
      p[2 * (size_t)tile + 1] = s + n_valid;
    } else {
      static_cast<Acc*>(partials)[tile] = s + n_valid;
    }
  }

  if (kMode == kPooled) {
    // The tile's own 2x2 blocks: pooled rows y0/2 .. and columns x0/2 ..,
    // TW/2 threads (a power of two in [16, 128]) across a pooled row.
    const int H2 = H / 2, W2 = W / 2;
    const int py0 = y0 / 2, px0 = x0 / 2;
    const int ph = min(TH / 2, H2 - py0);
    const int pw = min(TW / 2, W2 - px0);
    const int PW = TW / 2;
    const int px = tid % PW;
    const size_t pbase = (size_t)img * (size_t)H2 * (size_t)W2;
    for (int py = tid / PW; py < ph && px < pw; py += kThreads / PW) {
      const size_t r0 =
          base + (size_t)(2 * (py0 + py)) * (size_t)W + (size_t)(2 * (px0 + px));
      const size_t r1 = r0 + (size_t)W;
      const size_t o =
          pbase + (size_t)(py0 + py) * (size_t)W2 + (size_t)(px0 + px);
      const float ya0 = to_f32(a[r0]) + to_f32(a[r1]);
      const float ya1 = to_f32(a[r0 + 1]) + to_f32(a[r1 + 1]);
      pool_a[o] = (ya0 + ya1) * 0.25f;
      const float yb0 = to_f32(b[r0]) + to_f32(b[r1]);
      const float yb1 = to_f32(b[r0 + 1]) + to_f32(b[r1 + 1]);
      pool_b[o] = (yb0 + yb1) * 0.25f;
    }
  }
}

template <typename T, int kMode>
cudaError_t launch(const void* a, const void* b, void* partials, void* map,
                   void* pool_a, void* pool_b, int B, int H, int W, int r,
                   int TH, int TW, const float* taps_host, double c1,
                   double c2, float clip_bound, cudaStream_t stream) {
  if (kMode == kPooled && ((TH | TW) & 1)) return cudaErrorInvalidValue;
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
      ssim_fwd_kernel<T, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssim_fwd_kernel<T, kMode><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), partials,
      static_cast<float*>(map), static_cast<float*>(pool_a),
      static_cast<float*>(pool_b), H, W, r, TH, TW, ntx, tiles_per_image, taps,
      (float)c1, (float)c2, c1, c2, clip_bound);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_typed(int is_float, const void* a, const void* b,
                         void* partials, void* map, void* pool_a,
                         void* pool_b, int B, int H, int W, int r, int TH,
                         int TW, const float* taps_host, double c1, double c2,
                         float clip_bound, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_float
             ? launch<float, kMode>(a, b, partials, map, pool_a, pool_b, B, H,
                                    W, r, TH, TW, taps_host, c1, c2,
                                    clip_bound, s)
             : launch<uint8_t, kMode>(a, b, partials, map, pool_a, pool_b, B,
                                      H, W, r, TH, TW, taps_host, c1, c2,
                                      clip_bound, s);
}

}  // namespace

// The C entry for ctypes. mode: 0 = kScore, 1 = kMap, 2 = kComponents,
// 3 = kPooled, 4 = kPrecise, 5 = kPreciseMap; any other value is refused
// (the precise tier has no components or pooled mode). is_float: 0 =
// uint8 inputs, 1 = float32 inputs. partials: (B, ceil(H/TH) *
// ceil(W/TW)) f32, with a trailing 2 of [cs, ssim] in the components
// modes, and f64 in the precise modes. map: (B, H, W) f32 in kMap and
// kPreciseMap, else NULL. pool_a, pool_b: (B, H/2, W/2) f32 each in
// kPooled (TH and TW even), else NULL. taps_host: 2r+1 floats in host
// memory. c1, c2: the stabilising constants (rounded to float by the f32
// modes). Returns the launch's cudaError_t.
extern "C" int ssim_fwd_launch(int mode, int is_float, const void* a,
                               const void* b, void* partials, void* map,
                               void* pool_a, void* pool_b, int B, int H,
                               int W, int r, int TH, int TW,
                               const float* taps_host, double c1, double c2,
                               float clip_bound, void* stream) {
  if ((map != nullptr) != (mode == kMap || mode == kPreciseMap) ||
      (pool_a != nullptr) != (mode == kPooled) ||
      (pool_b != nullptr) != (mode == kPooled)) {
    return cudaErrorInvalidValue;
  }
  switch (mode) {
    case kScore:
      return launch_typed<kScore>(is_float, a, b, partials, map, pool_a,
                                  pool_b, B, H, W, r, TH, TW, taps_host, c1,
                                  c2, clip_bound, stream);
    case kMap:
      return launch_typed<kMap>(is_float, a, b, partials, map, pool_a, pool_b,
                                B, H, W, r, TH, TW, taps_host, c1, c2,
                                clip_bound, stream);
    case kComponents:
      return launch_typed<kComponents>(is_float, a, b, partials, map, pool_a,
                                       pool_b, B, H, W, r, TH, TW, taps_host,
                                       c1, c2, clip_bound, stream);
    case kPooled:
      return launch_typed<kPooled>(is_float, a, b, partials, map, pool_a,
                                   pool_b, B, H, W, r, TH, TW, taps_host, c1,
                                   c2, clip_bound, stream);
    case kPrecise:
      return launch_typed<kPrecise>(is_float, a, b, partials, map, pool_a,
                                    pool_b, B, H, W, r, TH, TW, taps_host, c1,
                                    c2, clip_bound, stream);
    case kPreciseMap:
      return launch_typed<kPreciseMap>(is_float, a, b, partials, map, pool_a,
                                       pool_b, B, H, W, r, TH, TW, taps_host,
                                       c1, c2, clip_bound, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
