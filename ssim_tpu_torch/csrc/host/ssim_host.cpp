// Native CPU backend for ssim_tpu.
//
// Role parity with the reference's CPU engine (the whole of
// the reference's src/ssim.cpp + its SIMD backends): a fast host-side
// SSIM for deployments without a TPU. The design is NOT a port of the
// reference's scatter-style blur; it is the same gather-style separable
// formulation as our TPU kernel (ops/ssim_pallas.py):
//
//   - clamp-to-edge borders (reference semantics, src/ssim.cpp:515-583)
//   - 11-tap separable Gaussian, radius 5, sigma 1.5, taps normalized in
//     double then rounded to float (windows.py parity)
//   - four blurred signals a, b, (a+b)^2, (a-b)^2; the sigma terms are
//     recovered by linearity (see ops/ssim_pallas.py)
//   - f32 pixel math, f64 row accumulation (reference contract,
//     src/ssim.cpp:594)
//   - OpenMP parallelism over row bands; compiler autovectorization does
//     the SIMD (no per-ISA intrinsics: that is the reference's approach,
//     not ours). Loop shapes are vec-report-driven: x-contiguous
//     shifted-load blurs (a tap-inner reduction vectorizes ~4x worse)
//     and no control flow inside vectorized loops.
//   - The two separable passes are FUSED through a ring buffer of the
//     11 live horizontally-blurred rows per signal (~350 KiB at 1080p,
//     cache-resident) instead of materializing four full-image
//     intermediates — the TPU kernel's VMEM-residency idea, on L2.
//
// Built as libssim_host.so (see Makefile), loaded via ctypes by
// ssim_tpu/ops/host.py.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int kRadius = 5;
constexpr int kTaps = 2 * kRadius + 1;

void make_taps(float taps[kTaps]) {
    double g[kTaps];
    double sum = 0.0;
    for (int i = 0; i < kTaps; ++i) {
        const double d = i - kRadius;
        g[i] = std::exp(-(d * d) / (2.0 * 1.5 * 1.5));
        sum += g[i];
    }
    for (int i = 0; i < kTaps; ++i) taps[i] = static_cast<float>(g[i] / sum);
}

inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Horizontal 11-tap clamped blur of image row y into the four signal
// rows (mu_a, mu_b, (a+b)^2, (a-b)^2). `pad*` are caller scratch rows of
// width + 2*kRadius floats.
void hblur_row(const uint8_t* a, const uint8_t* b, int width, int y,
               const float taps[kTaps], float* pad_a, float* pad_b,
               float* pad_s, float* pad_d, float* oa, float* ob, float* os,
               float* od) {
    const uint8_t* ra = a + static_cast<size_t>(y) * width;
    const uint8_t* rb = b + static_cast<size_t>(y) * width;
    for (int x = -kRadius; x < width + kRadius; ++x) {
        const int xi = clampi(x, 0, width - 1);
        const float va = ra[xi];
        const float vb = rb[xi];
        const float s = va + vb;
        const float d = va - vb;
        pad_a[x + kRadius] = va;
        pad_b[x + kRadius] = vb;
        pad_s[x + kRadius] = s * s;
        pad_d[x + kRadius] = d * d;
    }
    const float* pa = pad_a + kRadius;
    const float* pb = pad_b + kRadius;
    const float* ps = pad_s + kRadius;
    const float* pd = pad_d + kRadius;
#pragma omp simd
    for (int x = 0; x < width; ++x) {
        float sa = taps[kRadius] * pa[x];
        float sb = taps[kRadius] * pb[x];
        float ss = taps[kRadius] * ps[x];
        float sd = taps[kRadius] * pd[x];
        for (int d = kRadius; d > 0; --d) {  // smallest taps first
            const float t = taps[kRadius - d];
            sa += t * (pa[x - d] + pa[x + d]);
            sb += t * (pb[x - d] + pb[x + d]);
            ss += t * (ps[x - d] + ps[x + d]);
            sd += t * (pd[x - d] + pd[x + d]);
        }
        oa[x] = sa;
        ob[x] = sb;
        os[x] = ss;
        od[x] = sd;
    }
}

}  // namespace

extern "C" int ssim_host_compute(const uint8_t* a, const uint8_t* b,
                                 int width, int height, double data_range,
                                 double* out_ssim, float* out_map) {
    if (a == nullptr || b == nullptr || out_ssim == nullptr || width < 1 ||
        height < 1) {
        return 22;  // EINVAL, reference errno convention
    }
    float taps[kTaps];
    make_taps(taps);
    const float c1 = static_cast<float>((0.01 * data_range) * (0.01 * data_range));
    const float c2 = static_cast<float>((0.03 * data_range) * (0.03 * data_range));

    std::vector<double> band_sums;
    int n_bands = 0;

#pragma omp parallel
    {
#ifdef _OPENMP
        const int tid = omp_get_thread_num();
        const int nthreads = omp_get_num_threads();
#else
        const int tid = 0;
        const int nthreads = 1;
#endif
#pragma omp single
        {
            n_bands = nthreads;
            band_sums.assign(n_bands, 0.0);
        }
        // Contiguous row band per thread; each thread owns a ring of the
        // 11 live h-blurred rows per signal and recomputes its band's
        // leading halo rows itself (10 rows of duplicate work per band —
        // the reference's tile-margin recompute, src/ssim.cpp:230-239).
        const int band_h = (height + nthreads - 1) / nthreads;
        const int y0 = tid * band_h;
        const int y1 = y0 + band_h < height ? y0 + band_h : height;

        const size_t w = static_cast<size_t>(width);
        std::vector<float> ring(4 * kTaps * w);
        std::vector<float> pad(4 * (w + 2 * kRadius));
        std::vector<float> vrow_buf(w);
        float* pad_a = pad.data();
        float* pad_b = pad_a + (w + 2 * kRadius);
        float* pad_s = pad_b + (w + 2 * kRadius);
        float* pad_d = pad_s + (w + 2 * kRadius);
        auto slot = [&](int sig, int yi) -> float* {
            // Ring slot for image row yi (clamped); slots keyed mod kTaps.
            const int yc = clampi(yi, 0, height - 1);
            return ring.data() + (static_cast<size_t>(sig) * kTaps +
                                  static_cast<size_t>(yc % kTaps)) * w;
        };
        double acc_band = 0.0;

        if (y0 < y1) {
            // Prime the ring with rows y0-kRadius .. y0+kRadius (clamped,
            // deduplicated — clamped duplicates share a slot).
            int primed_lo = clampi(y0 - kRadius, 0, height - 1);
            int primed_hi = clampi(y0 + kRadius, 0, height - 1);
            for (int yi = primed_lo; yi <= primed_hi; ++yi) {
                hblur_row(a, b, width, yi, taps, pad_a, pad_b, pad_s, pad_d,
                          slot(0, yi), slot(1, yi), slot(2, yi), slot(3, yi));
            }
            for (int y = y0; y < y1; ++y) {
                // Rows y-kRadius..y+kRadius are live; compute the next
                // row needed for y (row y+kRadius) unless already primed.
                const int need = y + kRadius;
                if (need > primed_hi && need < height) {
                    hblur_row(a, b, width, need, taps, pad_a, pad_b, pad_s,
                              pad_d, slot(0, need), slot(1, need),
                              slot(2, need), slot(3, need));
                    primed_hi = need;
                }
                const float* rows_a[kTaps];
                const float* rows_b[kTaps];
                const float* rows_s[kTaps];
                const float* rows_d[kTaps];
                for (int k = 0; k < kTaps; ++k) {
                    const int yi = y - kRadius + k;
                    rows_a[k] = slot(0, yi);
                    rows_b[k] = slot(1, yi);
                    rows_s[k] = slot(2, yi);
                    rows_d[k] = slot(3, yi);
                }
                // Per-pixel values land in a scratch row first: a
                // conditional map write inside the loop is "control flow
                // in loop" to the vectorizer and blocks it (vec report).
                float* vr = vrow_buf.data();
#pragma omp simd
                for (int x = 0; x < width; ++x) {
                    float mu_a = 0.f, mu_b = 0.f, s_ss = 0.f, s_dd = 0.f;
                    for (int k = 0; k < kTaps; ++k) {
                        const float t = taps[k];
                        mu_a += t * rows_a[k][x];
                        mu_b += t * rows_b[k][x];
                        s_ss += t * rows_s[k][x];
                        s_dd += t * rows_d[k][x];
                    }
                    const float mu_a2 = mu_a * mu_a;
                    const float mu_b2 = mu_b * mu_b;
                    const float mu_ab = mu_a * mu_b;
                    const float sigma_ab_x4 = (s_ss - s_dd) - 4.f * mu_ab;
                    const float sigma_sum_x2 =
                        (s_ss + s_dd) - 2.f * (mu_a2 + mu_b2);
                    const float num =
                        (2.f * mu_ab + c1) * (0.5f * sigma_ab_x4 + c2);
                    const float den =
                        (mu_a2 + mu_b2 + c1) * (0.5f * sigma_sum_x2 + c2);
                    vr[x] = num / den;
                }
                if (out_map) {
                    std::memcpy(out_map + static_cast<size_t>(y) * width, vr,
                                w * sizeof(float));
                }
                double acc = 0.0;
#pragma omp simd reduction(+ : acc)
                for (int x = 0; x < width; ++x)
                    acc += static_cast<double>(vr[x]);
                acc_band += acc;
            }
        }
        band_sums[tid] = acc_band;
    }

    double total = 0.0;
    for (int i = 0; i < n_bands; ++i) total += band_sums[i];
    *out_ssim = total / (static_cast<double>(width) * height);
    return 0;
}

extern "C" int ssim_host_thread_count(void) {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}
