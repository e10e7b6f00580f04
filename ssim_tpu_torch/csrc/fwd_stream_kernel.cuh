// The main-path modes' row-streaming kernel, ssim_fwd_stream_kernel, and the
// row modes' second pass. Included by ssim_fwd.cu (the instantiations at
// radius kStreamR, the register window) and ssim_fwd_stream_rt.cu (kR = 0:
// any other radius, read at run time, the window in dynamic shared memory),
// each a translation unit of its own.
#pragma once

#include "fwd_stream.cuh"

namespace {

// The row modes' second pass: each row's ntx pieces added in order, in
// double, rounded to f32, plus W in f32 (rows + w, ssim_pallas.py:1328-1330).
// One thread per row.
__global__ void rowsum_reduce_kernel(const float* __restrict__ pieces,
                                     float* __restrict__ rows, int B, int ntx,
                                     int H, float w) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * H) return;
  const int img = (int)(i / H);
  const int y = (int)(i - (long long)img * H);
  const float* p = pieces + (size_t)img * ntx * (size_t)H + (size_t)y;
  double s = 0.0;
  for (int t = 0; t < ntx; ++t) s += p[(size_t)t * H];
  rows[i] = (float)s + w;
}

// kScore / kMap: partials (B, nty * ntx) f32 as the tile body writes them
// (kSplit > 0: the relaxed modes, kSplit = kStreamSplit); kPrecise /
// kPreciseMap: the same in f64, the blurs, formula and sums in fp64
// (Blur<kMode>); kRowsum / kRowsumMap: pieces (B, ntx, H) f32, each tile's
// piece of each of its rows, for rowsum_reduce_kernel; kComponents /
// kPooled: partials (B, nty * ntx, 2) f32, [sum(cs - 1), sum(ssim - 1)] +
// n_valid, and in kPooled the 2x2-mean images pool_a, pool_b (B, H/2, W/2)
// f32 of the block's own rows and columns (TH even). TH x TW: the tile (TW
// a power of two in [32, kStripW]); S: the segment's rows (a multiple of TH,
// at most kMaxSegTiles tiles). kR: the window's radius, kStreamR (the
// window in registers, the step loop unrolled by 2r + 1), or 0: the radius
// tp.r, 1 to kMaxStreamR, read at run time: the window's 2r + 1 rows of all
// four signals in a ring in dynamic shared memory (stream_rt_smem_bytes),
// one step a loop iteration, the taps in shared memory; the same operations
// in the same order. Relaxed with kR = 0 (kSplit = band_mma::ksteps(r)):
// the staged rows, the heavy blurs of the next rows and the same ring in
// dynamic shared memory (stream_rt_relaxed_smem_bytes), the ring's four
// signals mu_a, mu_b from the f32 pass and (a+b)^2, (a-b)^2 from the band
// products.
template <typename T, int kMode, int kSplit = 0, int kR = kStreamR>
__global__ void __launch_bounds__(kStreamThreads, kStreamBlocksOf<kMode, kSplit>)
ssim_fwd_stream_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       Blur<kMode>* __restrict__ partials, float* __restrict__ map,
                       float* __restrict__ pieces, Halo<T> halo, int H, int W,
                       int TH, int TW, int S, int nstrip, int nseg, int ntx,
                       int nty, StreamTaps<Blur<kMode>, kR> tp, Blur<kMode> c1,
                       Blur<kMode> c2, float clip_bound, float* __restrict__ pool_a,
                       float* __restrict__ pool_b) {
  using P = Blur<kMode>;
  constexpr bool kRt = kR == 0;  // the runtime radius
  const auto r = stream_radius(tp);  // StreamRadius<kR> where kR > 0
  constexpr int kP = kRt ? 1 : 2 * kR + 1;  // window rows = steps unrolled
  constexpr int kNT = kStreamThreads;
  constexpr int kInW = kStripW + 2 * (kRt ? kMaxStreamR : kR);  // staged columns
  constexpr int kLoads = (kInW + kNT - 1) / kNT;
  constexpr bool kFloat = sizeof(T) == 4;
  constexpr bool kFloatBlur = sizeof(P) == 4;
  constexpr bool kWithMap = kMode == kMap || kMode == kRowsumMap || kMode == kPreciseMap;
  constexpr bool kRows = kMode == kRowsum || kMode == kRowsumMap;
  constexpr int kRing = kRt ? 0 : kStreamRingOf<kMode>;  // signals in the shared ring
  constexpr bool kRelaxed = kSplit > 0;
  constexpr bool kComp = kMode == kComponents || kMode == kPooled;
  constexpr bool kPool = kMode == kPooled;
  // Signals in registers (relaxed: mu_a and mu_b; the other two are read
  // from the blurred rows' ring).
  constexpr int kRegS = kRelaxed ? 2 : 4 - kRing;
  // Rows staged ahead of the step that blurs them.
  constexpr int kLead = kRelaxed ? 3 : 1;
  static_assert(kMode == kScore || kMode == kMap || kComp ||
                    (!kRelaxed && (kRows || kMode == kPrecise || kMode == kPreciseMap)),
                "main-path, components and precise modes only; relaxed: kScore, kMap, "
                "kComponents and kPooled");
  static_assert(!kRelaxed || (kR == kStreamR ? kSplit == kStreamSplit
                                             : kRt && (kSplit == 2 || kSplit == 3)),
                "the band's k-steps: kStreamSplit at kStreamR, ksteps(r) at a runtime r");

  __shared__ StagedRow<P, kInW> s_in[2];    // staged rows, by step parity
  __shared__ P s_red[2][kNT / 32];          // warp sums, by step parity
  __shared__ unsigned s_bad[kMaxSegTiles];  // bit per tile column, word per tile row
  // The components modes: the cs warp sums, by step parity.
  __shared__ P s_red_cs[kComp ? 2 * (kNT / 32) : 1];
  // kPooled: the raw inputs (unsanitised, in f32) of the strip's own
  // columns, a then b, stream row q in slot q mod 4: step s pools rows
  // s + kLead - 2 and s + kLead - 1 while row s + kLead is staged (slot
  // (s + kLead - 4) mod 4, read at step s - 2 or before).
  __shared__ __align__(16) float s_raw[kPool ? 4 * 2 * kStripW : 1];
  // The window's ring: slot k, signal kRegS + p, this thread's column.
  __shared__ P s_ring[kRing > 0 ? kRing * kP * kNT : 1];
  // Relaxed (instead of s_in): staged row q in slot q mod kStreamStaged of
  // s_ab, followed by the ring, s_hres: the horizontal blurs of (a+b)^2,
  // then of (a-b)^2, of row q in slot q mod kStreamRing, kStripW columns
  // (ring_col) a slot; the band's fragments, per lane (hi then lo, one
  // uint4 per k-step); the taps, for make_band. With kRt all in dynamic
  // shared memory (below).
  // s_ab's row pitch: every line of a band product reads inside its row.
  constexpr int kAbW = kRt ? kInW : kStreamAbW;
  constexpr int kAbFloats = 2 * kStreamStaged * kAbW;
  constexpr int kRingFloats = 2 * kStreamRing * kStripW;
  __shared__ __align__(16) float s_rel[kRelaxed && !kRt ? kAbFloats + kRingFloats : 1];
  [[maybe_unused]] float2* s_ab = reinterpret_cast<float2*>(s_rel);
  [[maybe_unused]] float* s_hres = s_rel + kAbFloats;
  __shared__ uint4 s_band[kRelaxed ? 2 * kSplit * 32 : 1];
  __shared__ float s_taps[kRelaxed && !kRt ? kP : 1];
  // kRt: the taps, and the window's ring, this thread's column of slot k at
  // rt_ring[k * kNT + tid], a Vec4 of the blurs' type (f32: one float4;
  // fp64: two double2, mu_a and mu_b then s_ss and s_dd, kNT apart).
  // Relaxed: s_ab, then s_hres (the heavy blurs of row q in slot q mod
  // kStreamRtHres of each plane), then the ring.
  __shared__ P s_rtaps[kRt ? kMaxTaps : 1];
  [[maybe_unused]] unsigned char* rt_ring = nullptr;
  if constexpr (kRt) {
    extern __shared__ __align__(16) unsigned char fwd_stream_smem[];
    rt_ring = fwd_stream_smem;
    if constexpr (kRelaxed) {
      s_ab = reinterpret_cast<float2*>(fwd_stream_smem);
      s_hres = reinterpret_cast<float*>(fwd_stream_smem + kStreamRtAbBytes);
      rt_ring = fwd_stream_smem + kStreamRtAbBytes + kStreamRtHresBytes;
    }
  }

  const int tid = threadIdx.x;
  if (tid < kMaxSegTiles) s_bad[tid] = 0u;
  if constexpr (kRt) {
    if (tid < 2 * r + 1) s_rtaps[tid] = tp.t[tid];
  }
  if constexpr (kRelaxed) {
    // Zeros in the columns no row is staged to, which row_pass reads (times
    // zeros of the band: they must be finite); a row's reads end inside it.
    float* ab = reinterpret_cast<float*>(s_ab);
    for (int i = tid; i < kAbFloats; i += kNT) ab[i] = 0.0f;
  }
  if constexpr (kRelaxed && !kRt) {
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < kP; ++k) s_taps[k] = tp.t[k];
    }
  }
  // Before the prologue's stage(0), which may mark tiles in s_bad.
  __syncthreads();
  if constexpr (kRelaxed) {
    if (tid < 32) {
      const float* taps = s_taps;
      if constexpr (kRt) taps = s_rtaps;
      const band_mma::Band<kSplit> bd = band_mma::make_band<kSplit>(taps, r);
#pragma unroll
      for (int ks = 0; ks < kSplit; ++ks) {
        s_band[ks * 32 + tid] = make_uint4(bd.hi[ks][0], bd.hi[ks][1], bd.hi[ks][2],
                                           bd.hi[ks][3]);
        s_band[(kSplit + ks) * 32 + tid] = make_uint4(bd.lo[ks][0], bd.lo[ks][1],
                                                      bd.lo[ks][2], bd.lo[ks][3]);
      }
    }
  }

  int blk = blockIdx.x;
  const int strip = blk % nstrip;
  blk /= nstrip;
  const int seg = blk % nseg;
  const int img = blk / nseg;
  const int x0 = strip * kStripW;
  const int y0 = seg * S;
  const int vw = min(kStripW, W - x0);  // valid output columns
  const int vh = min(S, H - y0);        // valid output rows
  const size_t base = (size_t)img * (size_t)H * (size_t)W;
  const int n = vh + 2 * r;  // stream rows: virtual row y0 - r + q
  const bool col_on = tid < vw;  // this thread's output column x0 + tid
  const int tcol = tid / TW;     // its tile column in the strip
  const bool lead = tid == tcol * TW && col_on;  // combines its tile's sums
  const int txg = x0 / TW + tcol;  // its tile column in the image
  const int ty_base = y0 / TH;     // the segment's first tile row

  // Staging: stream row q loaded into registers (fetch), then staged
  // (stage). Staged column j is image column x0 - r + j, clamped.
  T pa[kLoads], pb[kLoads];
  int gxl[kLoads];
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    gxl[q] = min(max(x0 - r + tid + q * kNT, 0), W - 1);
  }
  auto fetch = [&](int q) {
    const int vi = y0 - r + q;
    const T* ra;
    const T* rb;
    if (kRows && vi < 0 && halo.at != nullptr && !halo.is_top) {
      const size_t o = ((size_t)img * r + (size_t)(vi + r)) * (size_t)W;
      ra = halo.at + o;
      rb = halo.bt + o;
    } else if (kRows && vi >= H && halo.ab != nullptr && !halo.is_bot) {
      const size_t o = ((size_t)img * r + (size_t)(vi - H)) * (size_t)W;
      ra = halo.ab + o;
      rb = halo.bb + o;
    } else {
      const size_t o = base + (size_t)min(max(vi, 0), H - 1) * (size_t)W;
      ra = a + o;
      rb = b + o;
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      if (tid + k * kNT < vw + 2 * r) {
        pa[k] = __ldg(ra + gxl[k]);
        pb[k] = __ldg(rb + gxl[k]);
      }
    }
  };
  auto stage = [&](int q) {
    const int ly = q - r;  // the segment's output row this input row is
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int j = tid + k * kNT;
      if (j < vw + 2 * r) {
        float va = to_f32(pa[k]);
        float vb = to_f32(pb[k]);
        if constexpr (kPool) {
          // The pool's source: the strip's own columns, raw (a u8 value
          // converts exactly; an f32 NaN reaches its own pooled pixel).
          const int xo = j - r;
          if (xo >= 0 && xo < vw) {
            float* raw = s_raw + (q & 3) * 2 * kStripW;
            raw[xo] = va;
            raw[kStripW + xo] = vb;
          }
        }
        if (kFloat) {
          // Poison source: the segment's own pixels, unsanitised (rare path).
          if (!(finite_f32(va) && finite_f32(vb))) {
            const int xo = j - r;
            if (ly >= 0 && ly < vh && xo >= 0 && xo < vw) {
              atomicOr(&s_bad[ly / TH], 1u << (xo / TW));
            }
          }
          va = sanitize(va, clip_bound);
          vb = sanitize(vb, clip_bound);
        }
        if constexpr (kRelaxed) {
          s_ab[(q & (kStreamStaged - 1)) * kAbW + j] = make_float2(va, vb);
        } else {
          s_in[q & 1].put(j, va, vb);
        }
      }
    }
  };

  // The window: the horizontal blurs of the last 2r + 1 stream rows, per
  // signal, the row of stream index q in slot q mod kP; signals kRegS..3 in
  // the shared ring where it has them. acc: this column's sum(ssim - 1) over
  // the current tile's rows (the tile modes), acc_cs its sum(cs - 1) (the
  // components modes).
  P win[kRegS > 0 ? kRegS : 1][kP];
  auto win_put = [&](int p, int k, P v) {
    if (p >= kRegS) {
      s_ring[(k * kRing + (p - kRegS)) * kNT + tid] = v;
    } else {
      win[p][k] = v;
    }
  };
  auto win_get = [&](int p, int k) -> P {
    return p >= kRegS ? s_ring[(k * kRing + (p - kRegS)) * kNT + tid] : win[p][k];
  };
  // kRt: the ring's slot of stream row q is q mod 2r + 1; rt_slot that of
  // the current step's row.
  [[maybe_unused]] const int rt_rows = 2 * r + 1;
  [[maybe_unused]] int rt_slot = 0;
  auto rt_put = [&](int k, const P (&h)[4]) {
    if constexpr (kFloatBlur) {
      reinterpret_cast<float4*>(rt_ring)[k * kNT + tid] = make_float4(h[0], h[1], h[2], h[3]);
    } else {
      double2* q = reinterpret_cast<double2*>(rt_ring) + 2 * k * kNT + tid;
      q[0] = make_double2(h[0], h[1]);
      q[kNT] = make_double2(h[2], h[3]);
    }
  };
  auto rt_get = [&](int k) -> Vec4<P> {
    if constexpr (kFloatBlur) {
      const float4 v = reinterpret_cast<const float4*>(rt_ring)[k * kNT + tid];
      return {v.x, v.y, v.z, v.w};
    } else {
      const double2* q = reinterpret_cast<const double2*>(rt_ring) + 2 * k * kNT + tid;
      const double2 u = q[0], v = q[kNT];
      return {u.x, u.y, v.x, v.y};
    }
  };
  P acc = 0;
  [[maybe_unused]] P acc_cs = 0;
  int trow = 0;  // row within the current tile
  int kt = 0;    // the current tile's row in the segment
  // Warp sums waiting in s_red[(s - 1) & 1] for step s to combine: the
  // tile row (tile modes) or the output row (row modes), else -1; and in
  // the row modes the tile row that ended there, else -1.
  int pend = -1, pend_end = -1;

  auto tile_bad = [&](int t) -> bool {
    return kFloat && ((s_bad[t] >> tcol) & 1u);
  };
  // Step s's combine of the warp sums written in step s - 1: the tile's
  // warps in order.
  auto combine = [&](int s) {
    if (pend < 0) return;
    const P* red = s_red[(s - 1) & 1] + tid / 32;
    if (lead) {
      P sum = 0;
      for (int k = 0; k < TW / 32; ++k) sum += red[k];
      if constexpr (kRows) {
        const size_t prow = ((size_t)img * ntx + (size_t)txg) * (size_t)H;
        pieces[prow + (size_t)(y0 + pend)] = sum;
        if (pend_end >= 0 && tile_bad(pend_end)) {
          // The tile ended at this row and holds a non-finite pixel: NaN
          // over its rows' pieces, after their finite writes (this thread's).
          const int ty0 = y0 + pend_end * TH;
          for (int y = ty0; y <= y0 + pend; ++y) {
            pieces[prow + (size_t)y] = __int_as_float(0x7fc00000);
          }
        }
      } else {
        const int tyg = ty_base + pend;
        const int vth = min(TH, H - tyg * TH);
        const int vtw = min(TW, W - txg * TW);
        const P nan = (P)__int_as_float(0x7fc00000);
        if constexpr (kComp) {
          // [sum(cs - 1), sum(ssim - 1)] + n_valid, NaN in both.
          const P* red_cs = s_red_cs + ((s - 1) & 1) * (kNT / 32) + tid / 32;
          P sum_cs = 0;
          for (int k = 0; k < TW / 32; ++k) sum_cs += red_cs[k];
          const bool bad = tile_bad(pend);
          const size_t t = ((size_t)img * nty + (size_t)tyg) * (size_t)ntx + (size_t)txg;
          partials[2 * t] = bad ? nan : sum_cs + (P)(vth * vtw);
          partials[2 * t + 1] = bad ? nan : sum + (P)(vth * vtw);
        } else {
          partials[((size_t)img * nty + (size_t)tyg) * (size_t)ntx + (size_t)txg] =
              tile_bad(pend) ? nan : sum + (P)(vth * vtw);
        }
      }
    }
    pend = -1;
    pend_end = -1;
  };

  // Prologue: stream rows 0 .. kLead - 1 staged, row kLead loading (n >=
  // 2r + 1 rows).
  fetch(0);
  stage(0);
  if constexpr (kRelaxed) {
#pragma unroll
    for (int q = 1; q < kLead; ++q) {
      fetch(q);
      stage(q);
    }
  }
  if (n > kLead) fetch(kLead);
  __syncthreads();
  if constexpr (kRelaxed) {
    // Row 0's heavy blurs, warp p plane p; each even step s then blurs rows
    // s + 1 and s + 2.
    if (tid < 64) {
      const int plane = tid >> 5;
      row_pass<kSplit>(s_ab, s_hres + plane * (kRt ? kStreamRtHres : kStreamRing) * kStripW,
                       plane, s_band);
    }
    __syncthreads();
  }

  for (int s0 = 0; s0 < n; s0 += kP) {
    // Relaxed: the ring's slots of rows s0 + d, d >= 0 in hr0 + d, d < 0 in
    // hr1 + d (kStripW floats a slot, this thread's column).
    [[maybe_unused]] const float* hr0 = nullptr;
    [[maybe_unused]] const float* hr1 = nullptr;
    if constexpr (kRelaxed && !kRt) {
      const int par = (s0 / kP) & 1;
      hr0 = s_hres + (par ? kP : 0) * kStripW + ring_col(tid);
      hr1 = s_hres + (par ? kP : 2 * kP) * kStripW + ring_col(tid);
    }
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      const int s = s0 + k;
      if (s < n) {
        if constexpr (kRelaxed) {
          // Even steps: rows s + 1 and s + 2's heavy blurs into their ring
          // slots, row s + 1 + w / 2's plane w % 2 by warp w. Both rows were
          // staged before the last barrier; steps from s + 1 read them, and
          // each slot's last reader was step s - 2r or earlier.
          if ((s & 1) == 0) {
            const int q = s + 1 + (tid >> 6), plane = (tid >> 5) & 1;
            if (q < n) {
              // kRt: row q's slot of s_hres, q mod kStreamRtHres (4: rows
              // s + 1 and s + 2 written while step s reads row s's).
              const int slot = kRt ? q & (kStreamRtHres - 1) : q % kStreamRing;
              // Row q's reads end inside its slot (kAbW), so none meets row
              // s + kLead, which (d) stages in this step.
              row_pass<kSplit>(s_ab + (q & (kStreamStaged - 1)) * kAbW,
                               s_hres + (plane * (kRt ? kStreamRtHres : kStreamRing) + slot) *
                                            kStripW,
                               plane, s_band);
            }
          }
        }
        // (a) The warp sums of the step before.
        combine(s);

        // (b) Stream row s: horizontal blur into the window's slot k.
        if constexpr (kRt) {
          // Each thread its own column's four signals (the precise thread
          // pairs below keep 2r + 2 staged values in registers, which a
          // runtime radius cannot).
          if (col_on) {
            if constexpr (kRelaxed) {
              // mu_a, mu_b by the f32 symmetric pass; (a+b)^2 and (a-b)^2
              // blurred by row_pass, from s_hres.
              float mu[2];
              sym2(
                  r, [&](int i) { return s_rtaps[i]; },
                  s_ab + (s & (kStreamStaged - 1)) * kAbW + tid + r, mu);
              const float* hh = s_hres + (s & (kStreamRtHres - 1)) * kStripW + ring_col(tid);
              const P h[4] = {mu[0], mu[1], hh[0], hh[kStreamRtHres * kStripW]};
              rt_put(rt_slot, h);
            } else {
              const StagedRow<P, kInW>& row = s_in[s & 1];
              P h[4];
              sym4(
                  r, [&](int i) { return s_rtaps[i]; },
                  [&](int i) { return row.get(tid + r + i); }, h);
              rt_put(rt_slot, h);
            }
          }
        } else if constexpr (kIsPrecise<kMode>) {
          // A thread pair blurs two columns: the even thread the (a, b)
          // plane, the odd one the ((a+b)^2, (a-b)^2) plane, each for both
          // columns; then each passes the other its column's half (every
          // lane takes part in the shuffle).
          const StagedRow<P, kInW>& row = s_in[s & 1];
          const bool odd = tid & 1;
          double2 o0, o1;
          sym2x2(tp, (odd ? row.sd : row.ab) + (tid & ~1), o0, o1);
          const double2 give = odd ? o0 : o1;
          const double2 got = make_double2(__shfl_xor_sync(0xffffffffu, give.x, 1),
                                           __shfl_xor_sync(0xffffffffu, give.y, 1));
          const double2 ab = odd ? got : o0, sd = odd ? o1 : got;
          if (col_on) {
            win_put(0, k, ab.x);
            win_put(1, k, ab.y);
            win_put(2, k, sd.x);
            win_put(3, k, sd.y);
          }
        } else if (col_on) {
          if constexpr (kRelaxed) {
            // mu_a, mu_b by the f32 symmetric pass ((a+b)^2 and (a-b)^2:
            // row_pass, in the ring).
            float h[2];
            sym2(tp, s_ab + (s & (kStreamStaged - 1)) * kAbW + tid + r, h);
            win_put(0, k, h[0]);
            win_put(1, k, h[1]);
          } else {
            const StagedRow<P, kInW>& row = s_in[s & 1];
            P h[4];
            sym4(tp, [&](int i) { return row.get(tid + r + i); }, h);
#pragma unroll
            for (int p = 0; p < 4; ++p) win_put(p, k, h[p]);
          }
        }

        // (c) Output row ly = s - 2r from stream rows s - 2r .. s (ages 2r
        // .. 0: the row of age j in slot (k - j) mod kP).
        if (s >= 2 * r) {
          const int ly = s - 2 * r;
          P v = 0;
          [[maybe_unused]] P cs = 0;
          if (col_on) {
            P m[4];
            if constexpr (kRt) {
              // The centre row (age r) in slot c0; row s - r + i in slot
              // c0 + i mod 2r + 1.
              const int c0 = rt_slot >= r ? rt_slot - r : rt_slot - r + rt_rows;
              sym4(
                  r, [&](int i) { return s_rtaps[i]; },
                  [&](int i) {
                    int sl = c0 + i;
                    sl += sl < 0 ? rt_rows : 0;
                    sl -= sl >= rt_rows ? rt_rows : 0;
                    return rt_get(sl);
                  },
                  m);
            } else if constexpr (kRelaxed) {
              sym4(tp,
                   [&](int i) {
                     const int sl = (k - r + i + 2 * kP) % kP;
                     const int d = k - r + i;  // row s0 + d
                     const float* h = (d >= 0 ? hr0 : hr1) + d * kStripW;
                     return Vec4<P>{win_get(0, sl), win_get(1, sl), h[0],
                                    h[kStreamRing * kStripW]};
                   },
                   m);
            } else {
              sym4(tp,
                   [&](int i) {
                     const int sl = (k - r + i + 2 * kP) % kP;
                     return Vec4<P>{win_get(0, sl), win_get(1, sl), win_get(2, sl),
                                    win_get(3, sl)};
                   },
                   m);
            }
            if constexpr (kComp) {
              v = components_of(m, c1, c2, cs);
            } else {
              v = ssim_of(m, c1, c2);
            }
            if (kWithMap) {
              map[base + (size_t)(y0 + ly) * (size_t)W + (size_t)(x0 + tid)] = (float)v;
            }
          }
          const bool tile_end = ++trow == TH || ly == vh - 1;
          if constexpr (kRows) {
            // The tile body's row piece: (ssim - 1) of each column, each
            // warp's 32 columns by shuffles (idle columns add 0).
            const float w = warp_sum(col_on ? v - 1.0f : 0.0f);
            if ((tid & 31) == 0) s_red[s & 1][tid / 32] = w;
            pend = ly;
            pend_end = tile_end ? kt : -1;
          } else {
            if (col_on) {
              acc += v - (P)1;
              if constexpr (kComp) acc_cs += cs - (P)1;
            }
            if (tile_end) {
              const P w = warp_sum(acc);
              if ((tid & 31) == 0) s_red[s & 1][tid / 32] = w;
              if constexpr (kComp) {
                const P wc = warp_sum(acc_cs);
                if ((tid & 31) == 0) s_red_cs[(s & 1) * (kNT / 32) + tid / 32] = wc;
                acc_cs = 0;
              }
              acc = 0;
              pend = kt;
            }
          }
          if (tile_end) {
            if (kWithMap && kFloat && col_on && tile_bad(kt)) {
              // NaN over the tile's map rows in this column, after their
              // finite writes (rare path).
              for (int y = y0 + kt * TH; y <= y0 + ly; ++y) {
                map[base + (size_t)y * (size_t)W + (size_t)(x0 + tid)] =
                    __int_as_float(0x7fc00000);
              }
            }
            trow = 0;
            ++kt;
          }
        }

        if constexpr (kPool) {
          // The 2x2 means of the segment's output rows ly - 1 and ly = s +
          // kLead - 1 - r, the last two rows staged (ly odd; S is even, so
          // pooled row (y0 + ly) / 2 is this block's alone): thread i the
          // strip's columns 2i and 2i + 1. Vertical pairs first, then
          // horizontal, then * 0.25 (ops/pool.downsample2).
          const int ly = s + kLead - 1 - r;
          const int px = x0 / 2 + tid;
          if (ly > 0 && (ly & 1) && ly < vh && tid < kStripW / 2 && px < W / 2) {
            const float* r0 = s_raw + ((s + kLead - 2) & 3) * 2 * kStripW + 2 * tid;
            const float* r1 = s_raw + ((s + kLead - 1) & 3) * 2 * kStripW + 2 * tid;
            const float2 a0 = *reinterpret_cast<const float2*>(r0);
            const float2 a1 = *reinterpret_cast<const float2*>(r1);
            const float2 b0 = *reinterpret_cast<const float2*>(r0 + kStripW);
            const float2 b1 = *reinterpret_cast<const float2*>(r1 + kStripW);
            const size_t o = ((size_t)img * (size_t)(H / 2) + (size_t)((y0 + ly) / 2)) *
                                 (size_t)(W / 2) + (size_t)px;
            pool_a[o] = ((a0.x + a1.x) + (a0.y + a1.y)) * 0.25f;
            pool_b[o] = ((b0.x + b1.x) + (b0.y + b1.y)) * 0.25f;
          }
        }

        // (d) Stream row s + kLead staged from the registers loaded last
        // step; row s + kLead + 1 loaded.
        if (s + kLead < n) {
          stage(s + kLead);
          if (s + (kLead + 1) < n) fetch(s + (kLead + 1));
        }
        __syncthreads();
        if constexpr (kRt) rt_slot = rt_slot + 1 == rt_rows ? 0 : rt_slot + 1;
      }
    }
  }
  combine(n);
}

}  // namespace
