// A shared-memory poisoner and its probe: checks of the port's kernels on
// the card (chip_smoke.py), not a port of a TPU kernel and never launched by
// the package's wrappers.
//
// A kernel that reads a shared-memory word before any thread of its block
// wrote it (a missing barrier, a race between warps, an array never
// initialised) reads whatever the SM's shared memory held: on a warm launch
// most likely the same kernel's values from the block before, nearly right.
// smem_poison_kernel fills the shared memory of every SM with 0xff bytes
// (NaN in f32 and f64): SMs x its resident blocks, twice over, each block
// with the largest dynamic shared memory the card allows, so that a launch
// right after it on the same stream that reads an unwritten word reads NaN.
// Whether the card keeps shared memory's contents from one kernel to the
// next is the card's own affair, and so is how much of an SM's L1 it gives
// shared memory for each kernel (the carveout, sized for the kernel's
// blocks): smem_probe_kernel, launched right after the poisoner in the
// shape of a held kernel's launch (its shared memory a block and its
// blocks an SM), counts the 0xff words in its own unwritten dynamic shared
// memory, and chip_smoke.py prints that share before it relies on the
// poisoner. What bounds them: one pass over the SMs' shared memory each.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned n;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(n));
  return n;
}

__global__ void smem_poison_kernel() {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned n = dynamic_smem_bytes() / 16;
  for (unsigned i = threadIdx.x; i < n; i += blockDim.x) {
    // asm volatile: a store that no load of this kernel reads is still made.
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::"r"(base + 16 * i), "r"(~0u)
                 : "memory");
  }
}

// counts[0] += the 0xff words of the block's dynamic shared memory,
// counts[1] += its words, read before any thread writes one.
__global__ void smem_probe_kernel(unsigned long long* counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const volatile uint32_t* w = reinterpret_cast<const volatile uint32_t*>(smem);
  const unsigned n = dynamic_smem_bytes() / 4;
  unsigned long long ff = 0;
  for (unsigned i = threadIdx.x; i < n; i += blockDim.x) ff += w[i] == 0xffffffffu;
  atomicAdd(&counts[0], ff);
  if (threadIdx.x == 0) atomicAdd(&counts[1], (unsigned long long)n);
}

constexpr int kThreads = 256;

// The kernel's dynamic shared memory, `bytes` or the card's largest (0),
// its limit raised once per device and size, and the card's SMs and
// threads an SM holds.
template <typename Kernel>
cudaError_t setup(Kernel kernel, int bytes, int* smem, int* sms, int* sm_threads) {
  static std::mutex mu;  // one of each per kernel: the template's instantiation
  static int done[64] = {};
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sm_threads, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64 || bytes < 0 || bytes > most) return cudaErrorInvalidValue;
  *smem = bytes > 0 ? bytes : most;
  std::lock_guard<std::mutex> lock(mu);
  if (done[dev] < *smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (err != cudaSuccess) return err;
    done[dev] = *smem;
  }
  return cudaSuccess;
}

}  // namespace

// Fills every SM's shared memory with 0xff bytes on `stream`: two waves of
// blocks with the card's largest dynamic shared memory each. Returns the
// launch's cudaError_t.
extern "C" int smem_poison_launch(void* stream) {
  int smem = 0, sms = 0, sm_threads = 0, per_sm = 0;
  cudaError_t err = setup(smem_poison_kernel, 0, &smem, &sms, &sm_threads);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, smem_poison_kernel, kThreads,
                                                        smem);
  }
  if (err != cudaSuccess) return err;
  const int blocks = 2 * sms * (per_sm > 0 ? per_sm : 1);
  smem_poison_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// One wave of probe blocks, `per_sm` to an SM, each with `bytes` of dynamic
// shared memory (0: the card's largest), adding to counts (2 u64 on the
// card: 0xff words, words). The probe takes the shape of a held kernel's
// launch: its blocks are as wide as an SM's threads allow per_sm of them,
// so that the card sizes the SMs' shared memory (the carveout) for
// per_sm blocks of `bytes`, as for a kernel that holds per_sm blocks of
// that size; *resident: the blocks an SM holds of the probe at that shape.
// Returns the launch's cudaError_t.
extern "C" int smem_probe_launch(int bytes, int per_sm, void* counts, int* resident,
                                 void* stream) {
  int smem = 0, sms = 0, sm_threads = 0;
  cudaError_t err = setup(smem_probe_kernel, bytes, &smem, &sms, &sm_threads);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  int threads = sm_threads / per_sm / 32 * 32;
  threads = threads < 32 ? 32 : threads > 1024 ? 1024 : threads;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, smem_probe_kernel, threads, smem);
  if (err != cudaSuccess) return err;
  smem_probe_kernel<<<sms * per_sm, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(counts));
  return cudaGetLastError();
}
