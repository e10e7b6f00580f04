// The body of the relaxed backward stream's two kernels
// (bwd_relaxed_stream.cuh: ssim_bwd_relaxed_stream_kernel, radius 5 compiled
// in, and ssim_bwd_relaxed_rt_kernel, the radius read at run time),
// included inside each after it declares what the body reads: r, C, R,
// kNT, kKh, kKv, kG, kSW, kGmap, kWarps, kInW, kVtW, kMidW, kXvBytes,
// ring_halfs, in_cols, items, kLoads and zeros, all constexpr at radius 5
// (so that its code is compiled exactly as when the kernel served radius 5
// alone) and read at run time in the other kernel where they follow from r.
// No include guard: it is included once in each kernel.

  extern __shared__ __align__(16) unsigned char rel_smem[];
  float2* xin = reinterpret_cast<float2*>(rel_smem);  // [C][kInW]
  float* vt = reinterpret_cast<float*>(rel_smem);     // [4][C][kVtW]
  uint16_t* hring = reinterpret_cast<uint16_t*>(rel_smem + kXvBytes);
  uint16_t* wring = hring + kWarps * ring_halfs;
  float* fold = reinterpret_cast<float*>(wring + kWarps * ring_halfs);  // [2][4][kMidW]
  uint4* band_a = reinterpret_cast<uint4*>(fold + 2 * 4 * kMidW);  // [2 kKh][32]
  uint2* band_b = reinterpret_cast<uint2*>(band_a + 2 * kKh * 32);  // [2 kKv][32]
  __shared__ unsigned s_bad;  // bit 2 * tile row + tile column

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // Zeros everywhere: rows and columns past the valid ones are read as
  // products with zeros of the band, so they must be finite.
  for (int i = tid; i < zeros; i += kNT) {
    reinterpret_cast<uint4*>(rel_smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) s_bad = 0u;
  if (warp == 0) {
    const band_mma::Band<kKh> ba = band_mma::make_band<kKh>(co.t, r);
    const band_mma::BandB<kKv> bb = band_mma::make_band_b<kKv>(co.t, r);
#pragma unroll
    for (int ks = 0; ks < (kKh > kKv ? kKh : kKv); ++ks) {
      if (ks < kKh) {
        band_a[ks * 32 + lane] =
            make_uint4(ba.hi[ks][0], ba.hi[ks][1], ba.hi[ks][2], ba.hi[ks][3]);
        band_a[(kKh + ks) * 32 + lane] =
            make_uint4(ba.lo[ks][0], ba.lo[ks][1], ba.lo[ks][2], ba.lo[ks][3]);
      }
      if (ks < kKv) {
        band_b[ks * 32 + lane] = make_uint2(bb.hi[ks][0], bb.hi[ks][1]);
        band_b[(kKv + ks) * 32 + lane] = make_uint2(bb.lo[ks][0], bb.lo[ks][1]);
      }
    }
  }
  // Before the first stage, which may mark tiles in s_bad.
  __syncthreads();

  int blk = blockIdx.x;
  const int strip = blk % nstrip;
  blk /= nstrip;
  const int seg = blk % nseg;
  const int img = blk / nseg;
  const int x0 = strip * kSW;
  const int y0 = seg * S;
  const int vw = min(kSW, W - x0);  // valid output columns
  const int vh = min(S, H - y0);        // valid output rows
  const size_t base = (size_t)img * (size_t)H * (size_t)W;
  const float ws = w_s[img];
  const float wcs = w_cs[img];
  const bool vhalo = halo.at != nullptr;
  // Loss rows above 0 / below H - 1 exist (and carry no clamp fold) only
  // in a band with a neighbour there.
  const bool edge_top = !vhalo || halo.is_top;
  const bool edge_bot = !vhalo || halo.is_bot;
  const int n = vh + 4 * r;  // stream rows
  const int nchunk = (n + C - 1) / C;

  // Stage 0: a chunk's stream rows loaded into registers (fetch), then
  // staged (stage), sanitised, as {a, b}; input column j is image column
  // x0 - 2r + j, clamped. A thread's item q is element tid + q kNT of the
  // chunk's C x in_cols.
  float pa[kLoads], pb[kLoads];
  auto item = [&](int ch, int q, int& row, int& j, int& s) {
    const int it = tid + q * kNT;
    row = it / in_cols;
    j = it - row * in_cols;
    s = ch * C + row;
    return it < items && s < n && j < vw + 4 * r;
  };
  auto fetch = [&](int ch) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      int row, j, s;
      if (item(ch, q, row, j, s)) {
        const int vi = y0 - 2 * r + s;
        const float* ra;
        const float* rb;
        if (vi < 0 && !edge_top) {
          const size_t o = ((size_t)img * 2 * r + (size_t)(vi + 2 * r)) * (size_t)W;
          ra = halo.at + o;
          rb = halo.bt + o;
        } else if (vi >= H && !edge_bot) {
          const size_t o = ((size_t)img * 2 * r + (size_t)(vi - H)) * (size_t)W;
          ra = halo.ab + o;
          rb = halo.bb + o;
        } else {
          const size_t o = base + (size_t)min(max(vi, 0), H - 1) * (size_t)W;
          ra = a + o;
          rb = b + o;
        }
        const int gx = min(max(x0 - 2 * r + j, 0), W - 1);
        pa[q] = __ldg(ra + gx);
        pb[q] = __ldg(rb + gx);
      }
    }
  };
  auto stage = [&](int ch) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      int row, j, s;
      if (item(ch, q, row, j, s)) {
        const float va = pa[q], vb = pb[q];
        if (!(finite_f32(va) && finite_f32(vb))) {
          const unsigned bits = nan_tile_bits(y0 - 2 * r + s, x0 - 2 * r + j, y0, x0, vh,
                                              vw, H, W, TH, r);
          if (bits) atomicOr(&s_bad, bits);
        }
        xin[row * kInW + j] =
            make_float2(sanitize(va, clip_bound), sanitize(vb, clip_bound));
      }
    }
  };

  auto band_a_of = [&](int ks, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
    const uint4 h = band_a[ks * 32 + lane], l = band_a[(kKh + ks) * 32 + lane];
    hi[0] = h.x, hi[1] = h.y, hi[2] = h.z, hi[3] = h.w;
    lo[0] = l.x, lo[1] = l.y, lo[2] = l.z, lo[3] = l.w;
  };
  // This lane's ring rows for ldmatrix / stmatrix: lane 8 mi + mj gives row
  // mj of matrix mi.
  const int mi = lane >> 3, mj = lane & 7;
  uint16_t* const hmine = hring + warp * ring_halfs;
  uint16_t* const wmine = wring + warp * ring_halfs;
  auto part = [&](uint16_t* mine, int p, int lo) { return mine + (2 * p + lo) * R * 16; };
  auto slot_of = [&](int row) { return (row + 4 * R) % R; };  // rows >= -4R

  // The four planes' accumulators of a tile, stored split into a ring at
  // rows row0 + k: element e of acc[p] is column g + 8 (e >> 1) of the
  // tile, row 2t + (e & 1).
  auto store_split = [&](uint16_t* mine, int row0, const float(&acc)[4][4]) {
    const int sl = slot_of(row0 + mj);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t f[4];  // hi of columns 0-7, 8-15, lo of columns 0-7, 8-15
      band_mma::split2(acc[p][0], acc[p][1], f[0], f[2]);
      band_mma::split2(acc[p][2], acc[p][3], f[1], f[3]);
      band_mma::stsm_x4_trans(ring_row(part(mine, p, mi >> 1), sl, mi & 1), f);
    }
  };

  // Stage 1a: the horizontal blur of the chunk's 8 staged rows (the mma
  // lines) onto mid columns 16 warp .. + 15, the four planes a, b, (a+b)^2,
  // (a-b)^2 formed and split as the staged columns are loaded; into the
  // blur ring at stream rows 8 ch + k.
  auto hblur = [&](int ch) {
    float acc[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kKh; ++ks) {
      uint32_t ah[4], al[4];
      band_a_of(ks, ah, al);
      // Row g, input columns 16 (warp + ks) + 2t, + 1 and + 8, + 9: a row's
      // reads end inside it (kInW, RelGeom's "the horizontal blur's reads").
      const float2* src = xin + g * kInW + 16 * (warp + ks) + 2 * t;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(src + 8 * q);
        const float s0 = v.x + v.y, s1 = v.z + v.w;
        const float d0 = v.x - v.y, d1 = v.z - v.w;
        band_mma::split2(v.x, v.z, bh[0][q], bl[0][q]);
        band_mma::split2(v.y, v.w, bh[1][q], bl[1][q]);
        band_mma::split2(s0 * s0, s1 * s1, bh[2][q], bl[2][q]);
        band_mma::split2(d0 * d0, d1 * d1, bh[3][q], bl[3][q]);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        band_mma::mma(acc[p], ah, bl[p][0], bl[p][1]);
        band_mma::mma(acc[p], al, bh[p][0], bh[p][1]);
        band_mma::mma(acc[p], ah, bh[p][0], bh[p][1]);
      }
    }
    store_split(hmine, ch * C, acc);
  };

  // A vertical pass down this warp's 16 columns: outputs row0 + k (k < 8)
  // from ring rows row0 .. row0 + 2r + 7 (kG groups of 8 rows), the data as
  // the A operand (16 columns x 16 rows a k-step, ldmatrix.trans from the
  // split ring), the band as B; element e of acc[p] is column g + 8
  // (e >> 1), output row0 + 2t + (e & 1). With kG odd the last k-step's
  // rows 8-15 lie past the inputs (zeros of the band) and are not loaded;
  // rows read past 2r + 7 wrap onto other rows of the ring (finite, times
  // zeros of the band): the warp's own ring, which no other warp writes.
  auto vpass = [&](uint16_t* mine, int row0, float(&acc)[4][4]) {
    uint32_t bh[kKv][2], bl[kKv][2];
#pragma unroll
    for (int ks = 0; ks < kKv; ++ks) {
      const uint2 h = band_b[ks * 32 + lane], l = band_b[(kKv + ks) * 32 + lane];
      bh[ks][0] = h.x, bh[ks][1] = h.y, bl[ks][0] = l.x, bl[ks][1] = l.y;
    }
    if constexpr (kG == 3) {
      // One whole k-step and a last odd group (radii 5-8), spelt out: the
      // general loop below compiles radius 5 to other SASS (its registers
      // allocated otherwise; tools/sass_diff.py against a build with radius
      // 5 alone).
      const int sl0 = slot_of(row0 + mj + 8 * (mi >> 1));
      const int sl1 = slot_of(row0 + 16 + mj);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t xh[kKv][4], xl[kKv][4];
        band_mma::ldsm_x4_trans(xh[0], ring_row(part(mine, p, 0), sl0, mi & 1));
        band_mma::ldsm_x4_trans(xl[0], ring_row(part(mine, p, 1), sl0, mi & 1));
        uint32_t h2[2], l2[2];
        band_mma::ldsm_x2_trans(h2, ring_row(part(mine, p, 0), sl1, mi & 1));
        band_mma::ldsm_x2_trans(l2, ring_row(part(mine, p, 1), sl1, mi & 1));
        xh[1][0] = h2[0], xh[1][1] = h2[1], xh[1][2] = 0u, xh[1][3] = 0u;
        xl[1][0] = l2[0], xl[1][1] = l2[1], xl[1][2] = 0u, xl[1][3] = 0u;
        acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < kKv; ++ks) {
          band_mma::mma(acc[p], xl[ks], bh[ks][0], bh[ks][1]);
          band_mma::mma(acc[p], xh[ks], bl[ks][0], bl[ks][1]);
          band_mma::mma(acc[p], xh[ks], bh[ks][0], bh[ks][1]);
        }
      }
    } else {
      // A whole k-step's rows (two groups) by ldmatrix x4, a last odd group's
      // by x2.
      auto whole = [&](int ks) { return 2 * ks + 1 < kG; };
      int sl[kKv];
#pragma unroll
      for (int ks = 0; ks < kKv; ++ks) {
        sl[ks] = whole(ks) ? slot_of(row0 + 16 * ks + mj + 8 * (mi >> 1))
                           : slot_of(row0 + 16 * ks + mj);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t xh[kKv][4], xl[kKv][4];
#pragma unroll
        for (int ks = 0; ks < kKv; ++ks) {
          if (whole(ks)) {
            band_mma::ldsm_x4_trans(xh[ks], ring_row(part(mine, p, 0), sl[ks], mi & 1));
            band_mma::ldsm_x4_trans(xl[ks], ring_row(part(mine, p, 1), sl[ks], mi & 1));
          } else {
            uint32_t h2[2], l2[2];
            band_mma::ldsm_x2_trans(h2, ring_row(part(mine, p, 0), sl[ks], mi & 1));
            band_mma::ldsm_x2_trans(l2, ring_row(part(mine, p, 1), sl[ks], mi & 1));
            xh[ks][0] = h2[0], xh[ks][1] = h2[1], xh[ks][2] = 0u, xh[ks][3] = 0u;
            xl[ks][0] = l2[0], xl[ks][1] = l2[1], xl[ks][2] = 0u, xl[ks][3] = 0u;
          }
        }
        acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < kKv; ++ks) {
          band_mma::mma(acc[p], xl[ks], bh[ks][0], bh[ks][1]);
          band_mma::mma(acc[p], xh[ks], bl[ks][0], bl[ks][1]);
          band_mma::mma(acc[p], xh[ks], bh[ks][0], bh[ks][1]);
        }
      }
    }
  };

  // Stage 1b: the vertical blur onto mid rows i0 = 8 ch - 2r .. + 7 and the
  // weight maps there (zero by index outside the segment's mid rows and the
  // image), into the weight ring. The clamp-fold sums of the first (last) r
  // image rows, when this segment holds image row 0 (H - 1) at a flagged
  // edge: sum_e cl[e] W(row e) (W(row H - 1 - e)), one row at a time in the
  // order of the rows.
  auto vblur = [&](int ch) {
    const int i0 = ch * C - 2 * r;
    float acc[4][4];
    vpass(hmine, i0, acc);
    float wv[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 16 * warp + g + 8 * (e >> 1);
      const int i = i0 + 2 * t + (e & 1);
      const int gx = x0 - r + c;
      const int my = y0 - r + i;
      const bool outside = i < 0 || i >= vh + 2 * r || c >= vw + 2 * r || gx < 0 ||
                           gx >= W || (my < 0 && edge_top) || (my >= H && edge_bot);
      float w4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (!outside) {
        float coeff = ws;
        if constexpr (kGmap) coeff = ws + __ldg(gmap + base + (size_t)my * (size_t)W + gx);
        weights4(acc[0][e], acc[1][e], acc[2][e], acc[3][e], coeff, wcs, c1, c2, w4);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) wv[p][e] = w4[p];
    }
    const bool ftop = edge_top && y0 == 0 && i0 < 2 * r && i0 + C > r;
    const bool fbot = edge_bot && y0 + vh == H && i0 < vh + r && i0 + C > vh;
    if (ftop || fbot) {  // rare path, the same for the warp's lanes
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 16 * warp + g + 8 * h;
          float ft = fold[p * kMidW + c];
          float fb = fold[(4 + p) * kMidW + c];
#pragma unroll
          for (int k = 0; k < C; ++k) {
            const float v =
                __shfl_sync(0xffffffffu, wv[p][2 * h + (k & 1)], 4 * g + (k >> 1));
            const int i = i0 + k;
            if (ftop && i >= r && i < 2 * r) ft = ft + co.cl[i - r] * v;
            if (fbot && i >= vh && i < vh + r) fb = fb + co.cl[vh + r - 1 - i] * v;
          }
          if (t == 0) {
            fold[p * kMidW + c] = ft;
            fold[(4 + p) * kMidW + c] = fb;
          }
        }
      }
    }
    store_split(wmine, i0, wv);
  };

  // Stage 2a: the vertical adjoint onto output rows 8 ch - 4r .. + 7 at this
  // warp's mid columns, with the clamp fold at image rows 0 and H - 1, into
  // vt (f32).
  auto vadjoint = [&](int ch) {
    const int yb = ch * C - 4 * r;
    float acc[4][4];
    vpass(wmine, yb, acc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 16 * warp + g + 8 * (e >> 1);
      const int k = 2 * t + (e & 1);
      const int y = y0 + yb + k;  // image row
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float v = acc[p][e];
        if (y == 0 && edge_top) v = v + fold[p * kMidW + c];
        if (y == H - 1 && edge_bot) v = v + fold[(4 + p) * kMidW + c];
        vt[(p * C + k) * kVtW + c] = v;
      }
    }
  };

  // Stage 2b and da/db: the horizontal adjoint of vt's 8 rows (the mma
  // lines) onto output columns 16 warp .. + 15, with the fold at image
  // columns 0 and W - 1; a and b read again (sanitised) for da/db.
  auto hadjoint = [&](int ch) {
    const int yb = ch * C - 4 * r;
    float acc[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kKh; ++ks) {
      uint32_t ah[4], al[4];
      band_a_of(ks, ah, al);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        // A row's reads end inside it (kVtW, RelGeom's "the horizontal
        // adjoint's reads").
        const float* src = vt + (p * C + g) * kVtW + 16 * (warp + ks) + 2 * t;
        const float2 v0 = *reinterpret_cast<const float2*>(src);
        const float2 v1 = *reinterpret_cast<const float2*>(src + 8);
        uint32_t bh0, bh1, bl0, bl1;
        band_mma::split2(v0.x, v0.y, bh0, bl0);
        band_mma::split2(v1.x, v1.y, bh1, bl1);
        band_mma::mma(acc[p], ah, bl0, bl1);
        band_mma::mma(acc[p], al, bh0, bh1);
        band_mma::mma(acc[p], ah, bh0, bh1);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 16 * warp + g + 8 * (e >> 1);
      const int k = 2 * t + (e & 1);
      const int y = yb + k;
      if (x >= vw || y < 0 || y >= vh) continue;
      float g4[4] = {acc[0][e], acc[1][e], acc[2][e], acc[3][e]};
      const int gx = x0 + x;
      // The fold: image column q at mid column x + r + q from column 0,
      // W - 1 - q at x + r - q from column W - 1.
      auto hfold = [&](int sign) {
        float cr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int q = 0; q < r; ++q) {
          const float f = co.cl[q];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            cr[p] += f * vt[(p * C + k) * kVtW + x + r + sign * q];
          }
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) g4[p] += cr[p];
      };
      if (gx == 0) hfold(1);
      if (gx == W - 1) hfold(-1);
      const size_t pix = base + (size_t)(y0 + y) * (size_t)W + (size_t)gx;
      const float av = sanitize(__ldg(a + pix), clip_bound);
      const float bv = sanitize(__ldg(b + pix), clip_bound);
      const float sm = av + bv;
      const float df = av - bv;
      da[pix] = g4[0] + 2.0f * sm * g4[2] + 2.0f * df * g4[3];
      db[pix] = g4[1] + 2.0f * sm * g4[2] - 2.0f * df * g4[3];
    }
  };

  // Four barriers a chunk: after the staging (the horizontal blur reads
  // every warp's columns), after the horizontal blur (vt overwrites the
  // staged rows), after the vertical passes (the horizontal adjoint reads
  // the next warp's columns) and after the horizontal adjoint (the next
  // staging overwrites vt). Each warp's rings are its own: __syncwarp
  // between its vertical passes.
  fetch(0);
  for (int ch = 0; ch < nchunk; ++ch) {
    stage(ch);
    if (ch + 1 < nchunk) fetch(ch + 1);
    __syncthreads();
    hblur(ch);
    __syncthreads();
    const bool adj = ch * C - 4 * r + C > 0;  // output rows >= 0 in this chunk
    if (ch * C - 2 * r + C > 0) {
      vblur(ch);
      __syncwarp();
    }
    if (adj) vadjoint(ch);
    __syncthreads();
    if (adj && warp < kSW / 16 && 16 * warp < vw) hadjoint(ch);
    __syncthreads();
  }

  // NaN over the tiles a non-finite input reached (after every finite
  // write of this block: the last chunk ended with a barrier).
  const unsigned bad = s_bad;
  if (bad) poison_tiles(bad, da, db, base, y0, x0, vh, vw, W, TH, tid, kNT);
