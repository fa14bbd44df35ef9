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

__device__ __forceinline__ void load8(const int8_t* p, float out[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
}

__device__ __forceinline__ void load8(const float* p, float out[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// fp32 dot product of a query slice (float, in shared memory) with one
// stored key row of `head_dim` elements, summed in index order.
template <typename T>
__device__ __forceinline__ float row_dot(const float* q, const T* row, int head_dim) {
  float acc = 0.f;
  for (int d = 0; d < head_dim; d += 8) {
    float k[8];
    load8(row + d, k);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = fmaf(q[d + i], k[i], acc);
  }
  return acc;
}

}  // namespace mmt
