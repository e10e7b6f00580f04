// Fused analytic SSIM backward for NVIDIA Hopper (sm_90a), standard f32 tier.
//
// Replaces the JAX package's backward TPU kernel
// ssim_tpu/ops/ssim_grad.py::_grad_call in its scalar w_s, per-pixel g_map
// and w_cs modes: for L = sum_p (w_s + g_map(p)) * S(p) + w_cs * sum_p cs(p)
// per image it writes dL/da and dL/db. The math is that module's docstring
// (ssim_grad.py:10-40): with s = a + b, d = a - b and the clamped blur G,
//
//     dL/da = G^T[W_u] + 2 s . G^T[W_ss] + 2 d . G^T[W_dd]
//     dL/db = G^T[W_v] + 2 s . G^T[W_ss] - 2 d . G^T[W_dd]
//
// where the weight maps W are pointwise functions of the four blurred
// signals u, v, ss, dd. The TPU's band matmuls, roll passes, MXU/VPU split
// and 7680-lane column chunking are not carried over: one 2-D grid of
// TH x TW output tiles (batch folded into blockIdx.x) covers every width.
//
// What bounds it on this card: per output pixel it reads 8 bytes (a, b),
// writes 8 (da, db) and reads 4 more with g_map, while the function needs
// 48r + 116 f32 operations (356 at radius 5, one more with g_map; counted
// stage by stage in chip_smoke.py, with the product signals formed once
// per pixel and no halo recompute). At 67 TFLOP/s against 3.35 TB/s the
// two bounds nearly meet (0.044 ms of operations against 0.040 ms of
// bytes at 4 x 1080 x 1920; with g_map the bytes bound it, 0.050 ms). This
// kernel does more: it forms (a+b)^2 and (a-b)^2 again for every tap pair
// (20r + 12 in its horizontal pass, not 12r + 12) and recomputes the
// stage-1 halo of each tile. In practice the bound is on chip:
// each stage streams its four planes through shared memory (~220 32-bit
// accesses per output pixel at radius 5, counting the halo recompute), the
// runtime-radius loops cost instruction slots, and a block holds ~111 KB
// of shared memory, so at most two blocks share an SM.
// What the design does about it: everything between the input load and
// the output store stays in shared memory, as the TPU kernel keeps it in
// VMEM; each input pixel of the 2r-margin halo tile is read from device
// memory once and sanitised on load; the four signals share every sweep;
// buffers are reused between stages (the weight maps overwrite the input
// tile, the vertical adjoint overwrites the blurred planes) to keep two
// blocks per SM at radius 5. Later work: a compile-time radius,
// register-resident vertical passes, TMA loads.
//
// Stages of one block (r = window radius):
//  0. load the a/b tile with a 2r margin, clamped indices (the clamp-to-edge
//     border), nan_to_num + clip; note whether any loaded pixel is not
//     finite (that is every input pixel within 2r of the tile's own);
//  1. forward blurs u, v, ss, dd on the mid region (the tile plus an r
//     margin): horizontal, then vertical, as in ssim_fwd.cu; then the
//     weight maps W_u, W_v, W_ss, W_dd (ssim_grad.py:535-560), set to zero
//     by index at mid positions outside the image (never by multiplying: a
//     garbage value times 0 may be NaN);
//  2. the transposed clamped blur back to the tile's own pixels: the
//     vertical adjoint over the mid columns, with the clamp fold at image
//     rows 0 and H-1, then the horizontal adjoint with the fold at columns
//     0 and W-1 (the fold between the two passes, ssim_grad.py:204-275);
//     then da/db, NaN for the whole tile when stage 0 saw a non-finite pixel.
//
// Build without --use_fast_math and with --fmad=false: every multiply and
// add rounds on its own, in the order of the plain twin
// (ops/ssim_grad.py::ssim_grad_plain), so the kernel's gradients can be held
// against the twin's closely. One writer per output pixel, no atomics: the
// result is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 33;    // radius <= 16
constexpr int kMaxRadius = 16;

struct Coeffs {
  float t[kMaxTaps];     // Gaussian taps, 2r + 1 used
  float cl[kMaxRadius];  // clamp-fold mass: cl[x] = sum_{k > r + x} t[k]
};

__device__ __forceinline__ bool finite_f32(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
}

// nan_to_num followed by a clip to +-bound (ssim_grad.py:381-383).
__device__ __forceinline__ float sanitize(float v, float bound) {
  if ((__float_as_uint(v) & 0x7fffffffu) > 0x7f800000u) return 0.0f;
  return fminf(fmaxf(v, -bound), bound);
}

// Shared-memory floats of one block: region X holds the a/b halo tile, then
// the four weight-map planes; region Y holds the four horizontally blurred
// planes, then the four vertical-adjoint planes. Mirrored by smem_bytes in
// ops/ssim_grad.py.
__host__ __device__ inline int region_x_floats(int TH, int TW, int r) {
  const int in = 2 * (TH + 4 * r) * (TW + 4 * r);
  const int mid = 4 * (TH + 2 * r) * (TW + 2 * r);
  return in > mid ? in : mid;
}
__host__ __device__ inline int region_y_floats(int TH, int TW, int r) {
  return 4 * (TH + 4 * r) * (TW + 2 * r);
}

template <bool kGmap>
__global__ void __launch_bounds__(kThreads)
ssim_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ w_s, const float* __restrict__ w_cs,
                const float* __restrict__ gmap, float* __restrict__ da,
                float* __restrict__ db, int H, int W, int r, int TH, int TW,
                int ntx, int tiles_per_image, Coeffs co, float c1, float c2,
                float clip_bound) {
  extern __shared__ float smem[];
  __shared__ float s_t[kMaxTaps];
  __shared__ float s_cl[kMaxRadius];

  const int HC = TW + 4 * r;  // halo tile columns (row stride)
  const int MC = TW + 2 * r;  // mid-region columns (row stride)
  const int in_plane = (TH + 4 * r) * HC;
  const int hp_plane = (TH + 4 * r) * MC;
  const int mid_plane = (TH + 2 * r) * MC;
  const int vt_plane = TH * MC;
  float* sa = smem;            // stage 0-1: halo tiles
  float* sb = sa + in_plane;
  float* wm = smem;            // stage 1-2: weight maps W_u, W_v, W_ss, W_dd
  float* hp = smem + region_x_floats(TH, TW, r);  // stage 1: u, v, ss, dd rows
  float* vt = hp;              // stage 2: vertical adjoints

  const int tid = threadIdx.x;
  if (tid < kMaxTaps) s_t[tid] = co.t[tid];
  if (tid < kMaxRadius) s_cl[tid] = co.cl[tid];

  const int tile = blockIdx.x;
  const int img = tile / tiles_per_image;
  const int rem = tile - img * tiles_per_image;
  const int y0 = (rem / ntx) * TH;
  const int x0 = (rem % ntx) * TW;
  const int vh = min(TH, H - y0);  // valid output rows of this tile
  const int vw = min(TW, W - x0);  // valid output columns
  const size_t base = (size_t)img * (size_t)H * (size_t)W;
  const float ws = w_s[img];
  const float wcs = w_cs[img];

  // Stage 0: the halo tile, clamped, sanitised.
  const int lr = vh + 4 * r;
  const int lc = vw + 4 * r;
  int bad = 0;
  for (int i = tid; i < lr * lc; i += kThreads) {
    const int ly = i / lc;
    const int lx = i - ly * lc;
    const int gy = min(max(y0 - 2 * r + ly, 0), H - 1);
    const int gx = min(max(x0 - 2 * r + lx, 0), W - 1);
    const size_t p = base + (size_t)gy * (size_t)W + (size_t)gx;
    const float va = a[p];
    const float vb = b[p];
    if (!(finite_f32(va) && finite_f32(vb))) bad = 1;
    sa[ly * HC + lx] = sanitize(va, clip_bound);
    sb[ly * HC + lx] = sanitize(vb, clip_bound);
  }
  bad = __syncthreads_or(bad);

  // Stage 1a: horizontal blur of the four signals over every halo row, at
  // the mid columns (symmetric pairs, smallest taps first).
  const int mc = vw + 2 * r;
  for (int i = tid; i < lr * mc; i += kThreads) {
    const int ly = i / mc;
    const int mx = i - ly * mc;
    const float* ra = sa + ly * HC + mx + r;
    const float* rb = sb + ly * HC + mx + r;
    float ma = 0.0f, mb = 0.0f, ss = 0.0f, dd = 0.0f;
    for (int d = r; d >= 1; --d) {
      const float t = s_t[r - d];
      const float al = ra[-d], ah = ra[d], bl = rb[-d], bh = rb[d];
      const float sl = al + bl, sh = ah + bh, dl = al - bl, dh = ah - bh;
      ma += t * (al + ah);
      mb += t * (bl + bh);
      ss += t * (sl * sl + sh * sh);
      dd += t * (dl * dl + dh * dh);
    }
    const float tc = s_t[r];
    const float ac = ra[0], bc = rb[0];
    const float sc = ac + bc, dc = ac - bc;
    const int o = ly * MC + mx;
    hp[o] = ma + tc * ac;
    hp[hp_plane + o] = mb + tc * bc;
    hp[2 * hp_plane + o] = ss + tc * (sc * sc);
    hp[3 * hp_plane + o] = dd + tc * (dc * dc);
  }
  __syncthreads();

  // Stage 1b: vertical blur at the mid rows, then the weight maps.
  const int mr = vh + 2 * r;
  for (int i = tid; i < mr * mc; i += kThreads) {
    const int my = i / mc;
    const int mx = i - my * mc;
    const int gy = y0 - r + my;
    const int gx = x0 - r + mx;
    const int o = my * MC + mx;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
      wm[o] = 0.0f;
      wm[mid_plane + o] = 0.0f;
      wm[2 * mid_plane + o] = 0.0f;
      wm[3 * mid_plane + o] = 0.0f;
      continue;
    }
    const float* c = hp + (my + r) * MC + mx;
    float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f, m3 = 0.0f;
    for (int d = r; d >= 1; --d) {
      const float t = s_t[r - d];
      const int off = d * MC;
      m0 += t * (c[-off] + c[off]);
      m1 += t * (c[hp_plane - off] + c[hp_plane + off]);
      m2 += t * (c[2 * hp_plane - off] + c[2 * hp_plane + off]);
      m3 += t * (c[3 * hp_plane - off] + c[3 * hp_plane + off]);
    }
    const float tc = s_t[r];
    const float u = m0 + tc * c[0];
    const float v = m1 + tc * c[hp_plane];
    const float ss = m2 + tc * c[2 * hp_plane];
    const float dd = m3 + tc * c[3 * hp_plane];
    float coeff = ws;
    if (kGmap) coeff = ws + gmap[base + (size_t)gy * (size_t)W + (size_t)gx];
    // Pointwise partials, in the order of ssim_grad.py:536-560.
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
    wm[o] = coeff * (2.0f * v * q * rb12 - 2.0f * u * s_val * drb) +
            wcs * ((2.0f * u * cs - 2.0f * v) * rb2);
    wm[mid_plane + o] = coeff * (2.0f * u * q * rb12 - 2.0f * v * s_val * drb) +
                        wcs * ((2.0f * v * cs - 2.0f * u) * rb2);
    wm[2 * mid_plane + o] = (coeff * lum + wcs) * d_ss_c;
    wm[3 * mid_plane + o] = (coeff * lum + wcs) * d_dd_c;
  }
  __syncthreads();

  // Stage 2a: vertical adjoint onto the tile's own rows, at the mid
  // columns. Zeroed out-of-image weights make the plain part the
  // zero-extended symmetric blur; rows 0 and H-1 add the folded clamp mass.
  for (int i = tid; i < vh * mc; i += kThreads) {
    const int y = i / mc;
    const int mx = i - y * mc;
    const int gy = y0 + y;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* plane = wm + k * mid_plane;
      const float* c = plane + (y + r) * MC + mx;
      float acc = 0.0f;
      for (int d = r; d >= 1; --d) {
        acc += s_t[r - d] * (c[-d * MC] + c[d * MC]);
      }
      acc = acc + s_t[r] * c[0];
      if (gy == 0) {  // mid row of image row g is g + r here
        float corr = 0.0f;
        for (int g = 0; g < r; ++g) corr += s_cl[g] * plane[(r + g) * MC + mx];
        acc += corr;
      }
      if (gy == H - 1) {  // image row H-1-x sits at mid row H-1-x-y0+r
        float corr = 0.0f;
        for (int x = 0; x < r; ++x) {
          corr += s_cl[x] * plane[(H - 1 - x - y0 + r) * MC + mx];
        }
        acc += corr;
      }
      vt[k * vt_plane + y * MC + mx] = acc;
    }
  }
  __syncthreads();

  // Stage 2b: horizontal adjoint onto the tile's own columns, with the
  // fold at columns 0 and W-1, then da/db.
  for (int i = tid; i < vh * vw; i += kThreads) {
    const int y = i / vw;
    const int x = i - y * vw;
    const int gx = x0 + x;
    float g4[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* row = vt + k * vt_plane + y * MC;
      const float* c = row + x + r;
      float acc = 0.0f;
      for (int d = r; d >= 1; --d) acc += s_t[r - d] * (c[-d] + c[d]);
      acc = acc + s_t[r] * c[0];
      if (gx == 0) {
        float corr = 0.0f;
        for (int g = 0; g < r; ++g) corr += s_cl[g] * row[r + g];
        acc += corr;
      }
      if (gx == W - 1) {
        float corr = 0.0f;
        for (int q = 0; q < r; ++q) corr += s_cl[q] * row[W - 1 - q - x0 + r];
        acc += corr;
      }
      g4[k] = acc;
    }
    const size_t p = base + (size_t)(y0 + y) * (size_t)W + (size_t)gx;
    const float av = sanitize(a[p], clip_bound);
    const float bv = sanitize(b[p], clip_bound);
    const float s = av + bv;
    const float d = av - bv;
    float ga = g4[0] + 2.0f * s * g4[2] + 2.0f * d * g4[3];
    float gb = g4[1] + 2.0f * s * g4[2] - 2.0f * d * g4[3];
    if (bad) {
      ga = __int_as_float(0x7fc00000);  // NaN
      gb = ga;
    }
    da[p] = ga;
    db[p] = gb;
  }
}

template <bool kGmap>
cudaError_t launch(const float* a, const float* b, const float* w_s,
                   const float* w_cs, const float* gmap, float* da, float* db,
                   int B, int H, int W, int r, int TH, int TW,
                   const float* taps_host, const float* fold_host, float c1,
                   float c2, float clip_bound, cudaStream_t stream) {
  if (r < 1 || r > kMaxRadius || TH < 1 || TW < 1) {
    return cudaErrorInvalidValue;
  }
  Coeffs co;
  for (int k = 0; k < kMaxTaps; ++k) co.t[k] = k < 2 * r + 1 ? taps_host[k] : 0.0f;
  for (int k = 0; k < kMaxRadius; ++k) co.cl[k] = k < r ? fold_host[k] : 0.0f;
  const int ntx = (W + TW - 1) / TW;
  const int nty = (H + TH - 1) / TH;
  const int tiles_per_image = ntx * nty;
  const long long blocks = (long long)B * tiles_per_image;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * ((size_t)region_x_floats(TH, TW, r) +
                                       (size_t)region_y_floats(TH, TW, r));
  cudaError_t err = cudaFuncSetAttribute(
      ssim_bwd_kernel<kGmap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssim_bwd_kernel<kGmap><<<(unsigned)blocks, kThreads, smem, stream>>>(
      a, b, w_s, w_cs, gmap, da, db, H, W, r, TH, TW, ntx, tiles_per_image, co,
      c1, c2, clip_bound);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes. a, b, da, db: (B, H, W) f32; w_s, w_cs: (B,) f32 on the
// device; gmap: (B, H, W) f32 or NULL. taps_host: 2r+1 floats and fold_host:
// r floats, in host memory. Returns the launch's cudaError_t.
extern "C" int ssim_bwd_launch(const void* a, const void* b, const void* w_s,
                               const void* w_cs, const void* gmap, void* da,
                               void* db, int B, int H, int W, int r, int TH,
                               int TW, const float* taps_host,
                               const float* fold_host, float c1, float c2,
                               float clip_bound, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  const float* fws = static_cast<const float*>(w_s);
  const float* fwcs = static_cast<const float*>(w_cs);
  const float* fg = static_cast<const float*>(gmap);
  float* fda = static_cast<float*>(da);
  float* fdb = static_cast<float*>(db);
  if (fg) {
    return launch<true>(fa, fb, fws, fwcs, fg, fda, fdb, B, H, W, r, TH, TW,
                        taps_host, fold_host, c1, c2, clip_bound, s);
  }
  return launch<false>(fa, fb, fws, fwcs, fg, fda, fdb, B, H, W, r, TH, TW,
                       taps_host, fold_host, c1, c2, clip_bound, s);
}
