// Fused analytic SSIM backward for NVIDIA Hopper (sm_90a), standard f32 and
// relaxed tiers.
//
// Replaces the JAX package's backward TPU kernel
// ssim_tpu/ops/ssim_grad.py::_grad_call in its scalar w_s, per-pixel g_map,
// w_cs, vhalo / vmask and relaxed modes: for
// L = sum_p (w_s + g_map(p)) * S(p) + w_cs * sum_p cs(p) per image it
// writes dL/da and dL/db. The math is that module's docstring
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
// Halo operands (the vhalo / vmask mode, ssim_grad.py:149-202 and :391-470,
// for a row band of a taller image in spatial sharding): virtual rows
// [-2r, 0) and [H, H + 2r) are read in stage 0 from four (B, 2r, W)
// operands instead of clamped, unless is_top (is_bot) is set, where the
// band holds the image's edge row: then the clamp applies and the operand
// is never read (the in-kernel replica substitution). Loss rows then span
// the band plus r rows each side: stage 1 zeroes the weight maps at mid
// rows above 0 (below H - 1) only where is_top (is_bot) is set, the
// runtime loss-row mask of ssim_grad.py:462-470, and stage 2a adds the
// vertical clamp fold at rows 0 (H - 1) only there, between the vertical
// and horizontal adjoints (cl_v, ssim_grad.py:570-590). Elsewhere the
// neighbour's loss rows reach the band's edge rows through the plain
// symmetric part, the true adjoint. Only the band's own rows are written.
//
// Relaxed (kSplit > 0, accuracy="relaxed"; ssim_grad.py:324-328,
// :500-516, :522-529, :563-567): every band pass of stages 1a-2b, the four
// horizontal and four vertical blurs and their eight adjoints, runs as a
// bf16x3 band product on the tensor cores (band_mma.cuh; kSplit = its
// k-steps at this radius), four planes per sweep, each output's epilogue
// (the weight maps, the clamp folds in f32 between the two adjoints, da/db)
// the standard pass's. The wrapper launches it at W >= 512, the JAX gate
// (use_mxu). It takes no shared memory beyond the standard mode's; with
// four planes per sweep it holds 128 registers and spills ~0.1 KB a
// thread, within the two blocks per SM that the shared memory allows.
// Orthogonal to the halo operands, as in the JAX kernel.
//
// Build without --use_fast_math and with --fmad=false: every multiply and
// add rounds on its own, in the order of the plain twin
// (ops/ssim_grad.py::ssim_grad_plain), so the kernel's gradients can be held
// against the twin's closely. One writer per output pixel, no atomics: the
// result is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "band_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 33;    // radius <= 16
constexpr int kMaxRadius = 16;

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

// The weight maps W_u, W_v, W_ss, W_dd at mid position o from the four
// blurred signals, in the order of ssim_grad.py:536-560.
__device__ __forceinline__ void store_weights(float* wm, int mid_plane, int o,
                                              float u, float v, float ss,
                                              float dd, float coeff, float wcs,
                                              float c1, float c2) {
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

template <bool kGmap, int kSplit>
__global__ void __launch_bounds__(kThreads)
ssim_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ w_s, const float* __restrict__ w_cs,
                const float* __restrict__ gmap, float* __restrict__ da,
                float* __restrict__ db, Halo halo, int H, int W, int r, int TH,
                int TW, int ntx, int tiles_per_image, Coeffs co, float c1,
                float c2, float clip_bound) {
  // The relaxed mode: kSplit = band_mma::ksteps(r), 0 in the standard one.
  constexpr bool kRelaxed = kSplit > 0;
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
  const bool vhalo = halo.at != nullptr;
  // Loss rows above 0 / below H - 1 exist (and carry no clamp fold) only
  // in a band with a neighbour there.
  const bool edge_top = !vhalo || halo.is_top;
  const bool edge_bot = !vhalo || halo.is_bot;

  // Stage 0: the halo tile, each row from the image (clamped) or from a
  // halo operand, each column clamped; sanitised.
  const int lr = vh + 4 * r;
  const int lc = vw + 4 * r;
  int bad = 0;
  for (int i = tid; i < lr * lc; i += kThreads) {
    const int ly = i / lc;
    const int lx = i - ly * lc;
    const int uy = y0 - 2 * r + ly;
    const int gx = min(max(x0 - 2 * r + lx, 0), W - 1);
    const float* pa = a;
    const float* pb = b;
    size_t p;
    if (uy < 0 && !edge_top) {
      p = ((size_t)img * 2 * r + (size_t)(uy + 2 * r)) * (size_t)W + (size_t)gx;
      pa = halo.at;
      pb = halo.bt;
    } else if (uy >= H && !edge_bot) {
      p = ((size_t)img * 2 * r + (size_t)(uy - H)) * (size_t)W + (size_t)gx;
      pa = halo.ab;
      pb = halo.bb;
    } else {
      const int gy = min(max(uy, 0), H - 1);
      p = base + (size_t)gy * (size_t)W + (size_t)gx;
    }
    const float va = pa[p];
    const float vb = pb[p];
    if (!(finite_f32(va) && finite_f32(vb))) bad = 1;
    sa[ly * HC + lx] = sanitize(va, clip_bound);
    sb[ly * HC + lx] = sanitize(vb, clip_bound);
  }
  bad = __syncthreads_or(bad);

  // The relaxed mode runs every band pass of stages 1a-2b as bf16x3 band
  // products on the tensor cores (band_mma::sweep, all four planes at
  // once): the horizontal passes with columns along the sweep and rows
  // across it, the vertical ones with rows along and columns across. Each
  // output's epilogue is the standard pass's.
  // This thread's place in the fragments (lane = 4 grp + tig).
  [[maybe_unused]] const int grp = (tid & 31) >> 2, tig = tid & 3;

  // Stage 1a: horizontal blur of the four signals over every halo row, at
  // the mid columns (symmetric pairs, smallest taps first).
  const int mc = vw + 2 * r;
  if constexpr (kRelaxed) {
    band_mma::for_jobs(lr, (mc + 15) >> 4, [&](int strip, int t0, int t1) {
      const int row = min(8 * strip + grp, lr - 1) * HC;
      band_mma::sweep<4, kSplit>(
          s_t, r, t0, t1,
          [&](int c, float(&v)[4]) {
            float x = 0.0f, y = 0.0f;
            if (c < lc) {
              x = sa[row + c];
              y = sb[row + c];
            }
            const float s = x + y, d = x - y;
            v[0] = x;
            v[1] = y;
            v[2] = s * s;
            v[3] = d * d;
          },
          [&](int ti, const float(&acc)[4][4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int mx = 16 * ti + grp + 8 * (e >> 1);
              const int ly = 8 * strip + 2 * tig + (e & 1);
              if (ly < lr && mx < mc) {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  hp[k * hp_plane + ly * MC + mx] = acc[k][e];
                }
              }
            }
          });
    });
  } else {
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
  }
  __syncthreads();

  // Stage 1b: vertical blur at the mid rows, then the weight maps.
  const int mr = vh + 2 * r;
  // Mid positions outside the image (rows beyond a flagged edge) carry
  // zero weight, set by index.
  auto outside = [&](int gy, int gx) {
    return (gy < 0 && edge_top) || (gy >= H && edge_bot) || gx < 0 || gx >= W;
  };
  auto coeff_at = [&](int gy, int gx) {
    float coeff = ws;
    if (kGmap) coeff = ws + gmap[base + (size_t)gy * (size_t)W + (size_t)gx];
    return coeff;
  };
  if constexpr (kRelaxed) {
    band_mma::for_jobs(mc, (mr + 15) >> 4, [&](int strip, int t0, int t1) {
      const int col = min(8 * strip + grp, mc - 1);
      band_mma::sweep<4, kSplit>(
          s_t, r, t0, t1,
          [&](int ly, float(&v)[4]) {
            const float* c = hp + ly * MC + col;
#pragma unroll
            for (int p = 0; p < 4; ++p) v[p] = ly < lr ? c[p * hp_plane] : 0.0f;
          },
          [&](int ti, const float(&acc)[4][4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int my = 16 * ti + grp + 8 * (e >> 1);
              const int mx = 8 * strip + 2 * tig + (e & 1);
              if (my >= mr || mx >= mc) continue;
              const int gy = y0 - r + my;
              const int gx = x0 - r + mx;
              const int o = my * MC + mx;
              if (outside(gy, gx)) {
#pragma unroll
                for (int p = 0; p < 4; ++p) wm[p * mid_plane + o] = 0.0f;
                continue;
              }
              store_weights(wm, mid_plane, o, acc[0][e], acc[1][e], acc[2][e],
                            acc[3][e], coeff_at(gy, gx), wcs, c1, c2);
            }
          });
    });
  } else {
    for (int i = tid; i < mr * mc; i += kThreads) {
      const int my = i / mc;
      const int mx = i - my * mc;
      const int gy = y0 - r + my;
      const int gx = x0 - r + mx;
      const int o = my * MC + mx;
      if (outside(gy, gx)) {
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
      store_weights(wm, mid_plane, o, u, v, ss, dd, coeff_at(gy, gx), wcs, c1,
                    c2);
    }
  }
  __syncthreads();

  // Stage 2a: vertical adjoint onto the tile's own rows, at the mid
  // columns. Zeroed out-of-image weights make the plain part the
  // zero-extended symmetric blur; rows 0 and H-1 add the folded clamp mass.
  // vfold: that fold, for tile row y (image row gy) at mid column mx.
  auto vfold = [&](float acc, const float* plane, int gy, int mx) {
    if (gy == 0 && edge_top) {  // mid row of image row g is g + r here
      float corr = 0.0f;
      for (int g = 0; g < r; ++g) corr += s_cl[g] * plane[(r + g) * MC + mx];
      acc += corr;
    }
    if (gy == H - 1 && edge_bot) {  // row H-1-x at mid row H-1-x-y0+r
      float corr = 0.0f;
      for (int x = 0; x < r; ++x) {
        corr += s_cl[x] * plane[(H - 1 - x - y0 + r) * MC + mx];
      }
      acc += corr;
    }
    return acc;
  };
  if constexpr (kRelaxed) {
    band_mma::for_jobs(mc, (vh + 15) >> 4, [&](int strip, int t0, int t1) {
      const int col = min(8 * strip + grp, mc - 1);
      band_mma::sweep<4, kSplit>(
          s_t, r, t0, t1,
          [&](int my, float(&v)[4]) {
            const float* c = wm + my * MC + col;
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              v[p] = my < mr ? c[p * mid_plane] : 0.0f;
            }
          },
          [&](int ti, const float(&acc)[4][4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int y = 16 * ti + grp + 8 * (e >> 1);
              const int mx = 8 * strip + 2 * tig + (e & 1);
              if (y >= vh || mx >= mc) continue;
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                vt[k * vt_plane + y * MC + mx] =
                    vfold(acc[k][e], wm + k * mid_plane, y0 + y, mx);
              }
            }
          });
    });
  } else {
    for (int i = tid; i < vh * mc; i += kThreads) {
      const int y = i / mc;
      const int mx = i - y * mc;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float* plane = wm + k * mid_plane;
        const float* c = plane + (y + r) * MC + mx;
        float acc = 0.0f;
        for (int d = r; d >= 1; --d) {
          acc += s_t[r - d] * (c[-d * MC] + c[d * MC]);
        }
        acc = acc + s_t[r] * c[0];
        vt[k * vt_plane + y * MC + mx] = vfold(acc, plane, y0 + y, mx);
      }
    }
  }
  __syncthreads();

  // Stage 2b: horizontal adjoint onto the tile's own columns, with the
  // fold at columns 0 and W-1 (hfold, for tile column x of a row of vt),
  // then da/db (store_grads).
  auto hfold = [&](float acc, const float* row, int x) {
    const int gx = x0 + x;
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
    return acc;
  };
  auto store_grads = [&](const float (&g4)[4], int y, int x) {
    const size_t p = base + (size_t)(y0 + y) * (size_t)W + (size_t)(x0 + x);
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
  };
  if constexpr (kRelaxed) {
    band_mma::for_jobs(vh, (vw + 15) >> 4, [&](int strip, int t0, int t1) {
      const int row = min(8 * strip + grp, vh - 1) * MC;
      band_mma::sweep<4, kSplit>(
          s_t, r, t0, t1,
          [&](int c, float(&v)[4]) {
            const float* src = vt + row + c;
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              v[p] = c < mc ? src[p * vt_plane] : 0.0f;
            }
          },
          [&](int ti, const float(&acc)[4][4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int x = 16 * ti + grp + 8 * (e >> 1);
              const int y = 8 * strip + 2 * tig + (e & 1);
              if (y >= vh || x >= vw) continue;
              float g4[4];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                g4[k] = hfold(acc[k][e], vt + k * vt_plane + y * MC, x);
              }
              store_grads(g4, y, x);
            }
          });
    });
  } else {
    for (int i = tid; i < vh * vw; i += kThreads) {
      const int y = i / vw;
      const int x = i - y * vw;
      float g4[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float* row = vt + k * vt_plane + y * MC;
        const float* c = row + x + r;
        float acc = 0.0f;
        for (int d = r; d >= 1; --d) acc += s_t[r - d] * (c[-d] + c[d]);
        acc = acc + s_t[r] * c[0];
        g4[k] = hfold(acc, row, x);
      }
      store_grads(g4, y, x);
    }
  }
}

template <bool kGmap, int kSplit>
cudaError_t launch(const float* a, const float* b, const float* w_s,
                   const float* w_cs, const float* gmap, float* da, float* db,
                   const Halo& halo, int B, int H, int W, int r, int TH, int TW,
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
      ssim_bwd_kernel<kGmap, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssim_bwd_kernel<kGmap, kSplit><<<(unsigned)blocks, kThreads, smem, stream>>>(
      a, b, w_s, w_cs, gmap, da, db, halo, H, W, r, TH, TW, ntx,
      tiles_per_image, co, c1, c2, clip_bound);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes. relaxed: 1 for the relaxed mode, else 0. a, b, da,
// db: (B, H, W) f32; w_s, w_cs: (B,) f32 on the device; gmap: (B, H, W)
// f32 or NULL. a_top, a_bot, b_top, b_bot: the halo operands, (B, 2r, W)
// f32, all four or none, never with gmap; is_top, is_bot: their flags (0
// or 1). taps_host: 2r+1 floats and fold_host: r floats, in host memory.
// Returns the launch's cudaError_t.
extern "C" int ssim_bwd_launch(int relaxed, const void* a, const void* b,
                               const void* w_s, const void* w_cs,
                               const void* gmap, void* da,
                               void* db, const void* a_top, const void* a_bot,
                               const void* b_top, const void* b_bot,
                               int is_top, int is_bot, int B, int H, int W,
                               int r, int TH, int TW, const float* taps_host,
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
  const Halo halo{static_cast<const float*>(a_top),
                  static_cast<const float*>(a_bot),
                  static_cast<const float*>(b_top),
                  static_cast<const float*>(b_bot), is_top, is_bot};
  const int n_halo = (a_top != nullptr) + (a_bot != nullptr) +
                     (b_top != nullptr) + (b_bot != nullptr);
  if (n_halo != 0 && (n_halo != 4 || fg != nullptr)) {
    return cudaErrorInvalidValue;
  }
#define SSIM_BWD_LAUNCH(G, S)                                                 \
  return launch<G, S>(fa, fb, fws, fwcs, fg, fda, fdb, halo, B, H, W, r, TH, \
                      TW, taps_host, fold_host, c1, c2, clip_bound, s)
  if (r < 1 || r > kMaxRadius) return cudaErrorInvalidValue;
  const int split = relaxed ? band_mma::ksteps(r) : 0;
  if (fg) {
    if (split == 2) SSIM_BWD_LAUNCH(true, 2);
    if (split == 3) SSIM_BWD_LAUNCH(true, 3);
    SSIM_BWD_LAUNCH(true, 0);
  }
  if (split == 2) SSIM_BWD_LAUNCH(false, 2);
  if (split == 3) SSIM_BWD_LAUNCH(false, 3);
  SSIM_BWD_LAUNCH(false, 0);
#undef SSIM_BWD_LAUNCH
}
