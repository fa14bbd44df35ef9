// Small device helpers shared by the decode kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mmt {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// Round-to-nearest-even to bf16 and back: the rounding a bf16 store applies.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The rounding a store to T applies (none for float).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) { return round_bf16(x); }
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Reductions over the four lanes that hold one row of an mma accumulator.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFullMask, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFullMask, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFullMask, v, 1);
  return v + __shfl_xor_sync(kFullMask, v, 2);
}

// Two floats rounded to bf16 and packed low, high: one register of an mma
// operand.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Eight consecutive elements as float. The caller guarantees 8-element
// alignment of `p` (head_dim % 8 == 0 and a 16-byte aligned base).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float out[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// int8 to float without the quarter-rate conversion unit: x + 128 (the
// byte with its sign bit flipped) becomes the low mantissa bits of 2^23,
// and subtracting 2^23 + 128 leaves x exactly.
__device__ __forceinline__ float byte_to_f32(uint32_t word, uint32_t selector) {
  return __int_as_float(__byte_perm(word, 0x4B000000u, selector)) - 8388736.f;
}

__device__ __forceinline__ void load8(const int8_t* p, float out[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const uint32_t lo = raw.x ^ 0x80808080u;
  const uint32_t hi = raw.y ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = byte_to_f32(lo, 0x7540u + i);
    out[4 + i] = byte_to_f32(hi, 0x7540u + i);
  }
}

__device__ __forceinline__ void load8(const float* p, float out[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

}  // namespace mmt
