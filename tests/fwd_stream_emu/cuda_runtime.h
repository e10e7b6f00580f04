// Host stand-ins for the CUDA names the streaming kernels use, so that g++
// can build their sources for tests/test_torch_port_fwd_stream.py and
// tests/test_torch_port_bwd_stream.py: each CUDA thread of a block is a
// std::thread (emu_threads.h), shared arrays are statics shared by the
// block's threads (dynamic shared memory a buffer of the harness's),
// __syncthreads is a std::barrier and a warp shuffle goes through a
// per-warp buffer.
#pragma once
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __grid_constant__
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
struct dim3x { unsigned x, y, z; };
extern thread_local dim3x threadIdx, blockIdx, blockDim;
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline double2 make_double2(double a, double b) { return {a, b}; }
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
using std::max;
using std::min;
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
template <class T> inline T __ldg(const T* p) { return *p; }
void __syncthreads();
void __syncwarp(unsigned mask = 0xffffffffu);
float __shfl_down_sync(unsigned mask, float v, int offset);
double __shfl_down_sync(unsigned mask, double v, int offset);
double __shfl_xor_sync(unsigned mask, double v, int lane_mask);
float __shfl_sync(unsigned mask, float v, int src_lane);
unsigned atomicOr(unsigned* p, unsigned v);
typedef int cudaError_t;
typedef void* cudaStream_t;
