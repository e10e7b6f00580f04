// Host stand-ins for the bf16 conversions band_mma.cuh uses: round to
// nearest even (NaN to a quiet NaN), as the device's cvt.rn.bf16x2.f32.
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat162 { uint16_t x, y; };  // x in the low half
inline uint16_t __emu_bf16_rn(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;
  u += 0x7fffu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}
inline float __emu_bf16_f32(uint16_t h) { return __int_as_float((int)((uint32_t)h << 16)); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__emu_bf16_rn(a), __emu_bf16_rn(b)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 h) {
  return {__emu_bf16_f32(h.x), __emu_bf16_f32(h.y)};
}
