"""Gaussian window constants for SSIM.

Counterpart of `ssim_tpu/windows.py`, copied as it is (NumPy only):
`gaussian_taps` must stay bitwise equal to the JAX package's, since the
taps are the only state the two packages share.

The reference uses an 11x11 Gaussian window (radius 5, sigma 1.5), built by
sampling exp(-(x^2+y^2)/(2 sigma^2)) and normalizing the full 11x11 table to
sum 1 (src/ssim.cpp:272-318). Its SIMD kernels hard-code the 21 unique
coefficients of that normalized table (e.g. src/ssim_sse.cpp:204-212).

TPU-first design: the sampled 2-D Gaussian is an exact outer product
g(x)*g(y), and normalizing by the full-table sum (= (sum g)^2) keeps it an
exact outer product of *normalized 1-D taps*. We therefore run two 1-D
passes (rows then columns) with the 11 taps below — mathematically equal to
the reference's 2-D window, and the natural gather-style formulation for the
TPU VPU (the reference's scatter-style blur, src/ssim.cpp:451-462, does not
map to TPU). Verified against the frozen 21-coefficient table to < 3e-9
(the residual is the reference's own f32 rounding of the table).
"""

import numpy as np

#: Window radius (reference src/ssim.cpp:227).
RADIUS = 5

#: Window standard deviation (reference src/ssim.cpp:228).
SIGMA = 1.5

#: Stabilization constants, (k1*L)^2 and (k2*L)^2 with k1=0.01, k2=0.03,
#: L=255 (reference src/ssim.cpp:956-960).
K1 = 0.01
K2 = 0.03
L = 255.0
C1 = (K1 * L) ** 2  # 6.5025
C2 = (K2 * L) ** 2  # 58.5225

#: The reference's frozen 21 unique normalized-window coefficients
#: (src/ssim_sse.cpp:204-212; identical tables in ssim_avx/fma/avx512/neon).
#: Row-major lower triangle: entry (x, y) with x <= y lives at
#: index y*(y+1)/2 + x and equals window[radius - y, radius - x].
#: Kept for parity tests only — compute paths use the 1-D taps.
FROZEN_COEFFS_21 = np.array(
    [
        7.07622393965721130e-02,
        5.66619709134101868e-02, 4.53713610768318176e-02,
        2.90912277996540070e-02, 2.32944320887327194e-02, 1.19597595185041428e-02,
        9.57662798464298248e-03, 7.66836293041706085e-03, 3.93706932663917542e-03,
        1.29605561960488558e-03,
        2.02135881409049034e-03, 1.61857774946838617e-03, 8.31005279906094074e-04,
        2.73561221547424793e-04, 5.77411265112459660e-05,
        2.73561221547424793e-04, 2.19050692976452410e-04, 1.12464345875196159e-04,
        3.70224843209143728e-05, 7.81441485742107034e-06, 1.05756600987660931e-06,
    ],
    dtype=np.float64,
)


def window_is_default(radius, sigma, k1, k2) -> bool:
    """Whether the window parameters are the reference contract
    (radius 5, sigma 1.5, k1 0.01, k2 0.03 — src/ssim.cpp:227-228,
    :956-960). One helper for every routing gate (engine host-impl gate,
    routing's packed-path gate) so the literals cannot drift."""
    return radius == RADIUS and sigma == SIGMA and k1 == K1 and k2 == K2


def gaussian_taps(dtype=np.float64, radius: int = RADIUS, sigma: float = SIGMA) -> np.ndarray:
    """Normalized 1-D Gaussian taps of length 2*radius+1.

    Computed in float64 then cast, so every compute path sees the same
    rounded taps. The 1/(2 pi sigma^2) amplitude of the reference's sampled
    Gaussian (src/ssim.cpp:272-277) cancels in normalization and is omitted.
    """
    d = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-(d * d) / (2.0 * float(sigma) ** 2))
    t = g / g.sum()
    return t.astype(dtype)


def gaussian_kernel_2d(dtype=np.float64, radius: int = RADIUS, sigma: float = SIGMA) -> np.ndarray:
    """Full normalized (2r+1)x(2r+1) window, as the reference precomputes it
    (src/ssim.cpp:281-318). Exactly the outer product of `gaussian_taps`."""
    t = gaussian_taps(np.float64, radius, sigma)
    return np.outer(t, t).astype(dtype)


def frozen_kernel_2d() -> np.ndarray:
    """Reconstruct the full 11x11 window from the reference's frozen 21
    coefficients (symmetry: k(x,y)=k(y,x)=k(-x,y)=k(x,-y))."""
    k = np.zeros((11, 11), dtype=np.float64)
    idx = 0
    for y in range(RADIUS + 1):
        for x in range(y + 1):
            v = FROZEN_COEFFS_21[idx]
            idx += 1
            for sy in (-1, 1):
                for sx in (-1, 1):
                    k[RADIUS + sy * y, RADIUS + sx * x] = v
                    k[RADIUS + sy * x, RADIUS + sx * y] = v
    return k
