// Edge-pad-and-align: (B, H, W) -> (B, hp, wp) of the same element type,
// image pixel (0, 0) at (ROW_OFF, COL_OFF) = (8, 128) and every cell
// outside the image an edge replica (clamp to edge).
//
// Replaces the TPU kernel ssim_tpu/ops/pad.py::pad_align_pallas (K4), a
// DMA copy into (8, 128)-aligned VMEM blocks with the halos broadcast by
// the vector unit, which needed H % 8 == 0, W % 128 == 0 and H >= tile_h
// (the JAX dispatch sent every other layout to jnp.pad). This kernel serves
// every layout that fits (hp >= H + ROW_OFF, wp >= W + COL_OFF).
//
// Bound on the H100: bytes only, one read of B*H*W and one write of
// B*hp*wp elements at 3.35 TB/s; it does no arithmetic. Design: one block
// per (output row, image) walks the row in 16-byte vectors, so every store
// is one 16-byte transaction and neighbouring threads write neighbouring
// addresses. Output row r reads source row clamp(r - ROW_OFF, 0, H - 1);
// output column c reads clamp(c - COL_OFF, 0, W - 1). Where the destination
// pitch and base are 16-byte aligned, each vector is one store; where the
// source pitch and base are too, a vector of the row's interior is one
// 16-byte load (COL_OFF * itemsize is a multiple of 16, so the source
// offset of an aligned destination vector is aligned as well). At the
// edges, and where the source is not aligned, each element is fetched at
// its clamped column. With an unaligned destination every element is
// stored on its own.
//
// The kernel moves bytes, never values: the element is an unsigned integer
// of the itemsize (1, 2, 4 or 8 bytes), so one instantiation serves every
// dtype of that size and NaN payloads and -0.0 pass through bit for bit.
// Offsets are 64-bit: an output may hold more than 2^31 elements.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kRowOff = 8;
constexpr int kColOff = 128;
constexpr int kMaxThreads = 256;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ int clamp_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
pad_align_kernel(const T* __restrict__ x, T* __restrict__ out, int b, int h,
                 int w, int hp, int wp, bool vec_out, bool vec_in) {
  const int r = blockIdx.x;
  const int src_r = clamp_index(r - kRowOff, h);
  for (int img = blockIdx.y; img < b; img += gridDim.y) {
    const T* src = x + (static_cast<int64_t>(img) * h + src_r) * w;
    T* dst = out + (static_cast<int64_t>(img) * hp + r) * wp;
    if (vec_out) {
      constexpr int V = 16 / sizeof(T);
      const int nvec = wp / V;
#pragma unroll 4
      for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
        const int c0 = j * V - kColOff;  // source column of its first element
        uint4 v;
        if (vec_in && c0 >= 0 && c0 + V <= w) {
          v = __ldg(reinterpret_cast<const uint4*>(src + c0));
        } else {
          union { uint4 u; T e[V]; } pack;
#pragma unroll
          for (int k = 0; k < V; ++k) pack.e[k] = __ldg(src + clamp_index(c0 + k, w));
          v = pack.u;
        }
        reinterpret_cast<uint4*>(dst)[j] = v;
      }
    } else {
      for (int c = threadIdx.x; c < wp; c += blockDim.x)
        dst[c] = __ldg(src + clamp_index(c - kColOff, w));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, int b, int h, int w, int hp,
                   int wp, cudaStream_t stream) {
  const bool vec_out = (static_cast<int64_t>(wp) * sizeof(T)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool vec_in = (static_cast<int64_t>(w) * sizeof(T)) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int items = vec_out ? wp / static_cast<int>(16 / sizeof(T)) : wp;
  // Threads: the row's vectors rounded up to whole warps, at most 256.
  const int threads = std::min(kMaxThreads, std::max(32, (items + 31) / 32 * 32));
  const dim3 grid(hp, std::min(b, kMaxGridY));
  pad_align_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), b, h, w, hp, wp,
      vec_out, vec_in);
  return cudaGetLastError();
}

}  // namespace

// C entry: pads x (B, H, W), contiguous, elements of `itemsize` bytes, into
// out (B, hp, wp), contiguous, on `stream`; no synchronisation. Returns a
// CUDA error code (cudaErrorInvalidValue for a layout or itemsize the
// kernel does not take).
extern "C" int pad_align_launch(const void* x, void* out, int itemsize, int b,
                                int h, int w, int hp, int wp, void* stream) {
  if (b < 1 || h < 1 || w < 1 || hp < h + kRowOff || wp < w + kColOff)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 1: return launch<uint8_t>(x, out, b, h, w, hp, wp, s);
    case 2: return launch<uint16_t>(x, out, b, h, w, hp, wp, s);
    case 4: return launch<uint32_t>(x, out, b, h, w, hp, wp, s);
    case 8: return launch<unsigned long long>(x, out, b, h, w, hp, wp, s);
    default: return cudaErrorInvalidValue;
  }
}
