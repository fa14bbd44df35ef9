// Inverted dropout with its random bits made inside the kernel, for Hopper
// (sm_90a).
//
// Replaces multimodalanalytical_tpu/ops/fused_dropout.py _run (Pallas
// _kernel of pallas_dropout). The TPU kernel draws its bits from the TPU
// core's PRNG; this one computes Philox4x32-10 (Salmon et al., SC'11, the
// generator of Random123 and cuRAND) in registers: the key is the 64-bit
// seed, the counter is the element's flat index divided by 4, and the four
// 32-bit words of one counter serve four consecutive elements. So the mask
// is a pure function of (seed, index): the backward regenerates it by
// running this kernel on the gradient with the same seed, and no mask or
// bit tensor is ever stored.
//
// Semantics, as the Pallas _kernel: drop iff bits < threshold, where
// threshold = min(round(rate * 2^32), 2^32 - 1); a kept value is
// float32(x) * float32(1 / (1 - rate)), rounded once to x's type.
//
// Bound on the H100: bytes. Each element is read once and written once
// (4 bytes per bf16 element in all) against ~10 integer multiplies per
// element for the bits, far below the card's integer throughput, so the
// kernel is a streaming pass: one thread per counter, a 4-element vector
// load and store, a grid-stride loop. The seed is read from device memory
// (an int64 drawn by the caller's generator), so the host never waits.

#include "common.cuh"

namespace mmt {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;   // grid-stride beyond 32 blocks per SM

template <typename T>
struct alignas(4 * sizeof(T)) Pack4 {
  T v[4];
};

// Philox4x32 with 10 rounds; Random123's philox4x32_R(10, ctr, key).
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return ctr;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_dropout_kernel(
    const T* __restrict__ x, T* __restrict__ out, const int64_t* __restrict__ seed, int64_t n,
    uint32_t threshold, float inv) {
  const uint64_t s = static_cast<uint64_t>(*seed);
  const uint2 key = make_uint2(static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32));
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; c < groups;
       c += stride) {
    const uint64_t cu = static_cast<uint64_t>(c);
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(cu), static_cast<uint32_t>(cu >> 32), 0u, 0u), key);
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
    const int64_t i0 = 4 * c;
    if (i0 + 3 < n) {
      const Pack4<T> in = *reinterpret_cast<const Pack4<T>*>(x + i0);
      Pack4<T> o;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o.v[j] = from_f32<T>(bits[j] >= threshold ? __fmul_rn(to_f32(in.v[j]), inv) : 0.f);
      }
      *reinterpret_cast<Pack4<T>*>(out + i0) = o;
    } else {
      for (int j = 0; i0 + j < n; ++j) {
        out[i0 + j] = from_f32<T>(bits[j] >= threshold ? __fmul_rn(to_f32(x[i0 + j]), inv) : 0.f);
      }
    }
  }
}

}  // namespace
}  // namespace mmt

extern "C" {

// x, out: n contiguous bf16 (is_bf16) or fp32 elements, 16-byte aligned;
// seed: one int64 in device memory. Returns the cudaError_t of the launch.
int mmt_fused_dropout(int is_bf16, const void* x, void* out, const void* seed, long long n,
                      unsigned int threshold, float inv, void* stream) {
  using namespace mmt;
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const long long groups = (n + 3) / 4;
  const int blocks = static_cast<int>(
      groups / kThreads + 1 < kMaxBlocks ? groups / kThreads + 1 : kMaxBlocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sd = static_cast<const int64_t*>(seed);
  if (is_bf16) {
    fused_dropout_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), sd, n, threshold,
        inv);
  } else {
    fused_dropout_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), sd, n, threshold, inv);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
