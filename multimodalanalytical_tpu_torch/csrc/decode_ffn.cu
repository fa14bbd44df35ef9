// Decode-step feed-forward for Hopper (sm_90a): x W1^T + b1 -> exact-erf
// GELU -> (optional gate x (x Wg^T + bg)) -> W2^T + b2, in bf16 with fp32
// accumulation, rounding to bf16 after every product and every bias add as
// flax Dense(dtype=bfloat16) does.
//
// Replaces multimodalanalytical_tpu/ops/decode_ffn.py geglu_ffn (Pallas
// _ffn_kernel).
//
// Bound on the H100: at the flagship decode shape (M = 1280 rows, D = 512,
// F = 2048) the two products are 5.4 GFLOP against ~4.2 MB of weights, so
// the card could be compute-bound, but a simple kernel is far from either
// roof and is limited by its own instruction issue. The design is a plain
// tiled GEMM on the tensor cores through nvcuda::wmma fragments (bf16 in,
// fp32 accumulators), 64 x 64 output tiles, K-steps of 32 staged in shared
// memory, and the whole elementwise chain in the epilogue. It runs as TWO
// launches of that GEMM: the first writes the bf16 (M, F) activation (5 MB
// at the flagship, which stays in the 50 MB L2), the second reads it for the
// down projection. wgmma, TMA and a fused single pass are later work.
//
// Weights arrive in PyTorch's Linear layout (out_features, in_features), so
// both operands of every product are contiguous along the reduced axis.

#include <mma.h>

#include "common.cuh"

namespace mmt {
namespace {

using namespace nvcuda;

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kLds = kBK + 8;   // bf16 per staged row (padding against bank conflicts)
constexpr int kLdc = kBN + 4;   // floats per epilogue row
constexpr int kThreads = 128;   // 4 warps, a 2 x 2 grid of 32 x 32 warp tiles

enum Epilogue { kBias = 0, kGelu = 1, kGeluGated = 2 };

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// Stage a kRows x kBK tile of a row-major (rows, k_dim) bf16 matrix; rows
// past `rows` and columns past `k_dim` read as zero. k_dim % 8 == 0.
template <int kRows>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int row0, int rows, int k0, int k_dim) {
  for (int c = threadIdx.x; c < kRows * kBK / 8; c += kThreads) {
    const int r = c / (kBK / 8);
    const int col = (c % (kBK / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows && k0 + col < k_dim) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * k_dim + k0 + col);
    }
    *reinterpret_cast<uint4*>(dst + r * kLds + col) = val;
  }
}

// c (M, N) = epilogue(a (M, K) . w (N, K)^T [, a . wg^T]).
template <int kEpi>
__global__ void __launch_bounds__(kThreads) ffn_gemm_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ bias, const __nv_bfloat16* __restrict__ wg,
    const __nv_bfloat16* __restrict__ bg, __nv_bfloat16* __restrict__ c, int m, int n,
    int k_dim) {
  constexpr int kNB = kEpi == kGeluGated ? 2 : 1;
  constexpr int kMainBytes = (kBM + kNB * kBN) * kLds * 2;
  constexpr int kEpiBytes = kNB * kBM * kLdc * 4;
  constexpr int kSmem = kMainBytes > kEpiBytes ? kMainBytes : kEpiBytes;
  __shared__ __align__(128) unsigned char smem[kSmem];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_s = a_s + kBM * kLds;  // kNB tiles of kBN x kLds

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kNB][2][2];
#pragma unroll
  for (int g = 0; g < kNB; ++g)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[g][i][j], 0.f);

  for (int k0 = 0; k0 < k_dim; k0 += kBK) {
    stage_tile<kBM>(a_s, a, m0, m, k0, k_dim);
    stage_tile<kBN>(b_s, w, n0, n, k0, k_dim);
    if (kNB == 2) stage_tile<kBN>(b_s + kBN * kLds, wg, n0, n, k0, k_dim);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a_s + (wm * 32 + i * 16) * kLds + kk, kLds);
#pragma unroll
      for (int g = 0; g < kNB; ++g) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, b_s + g * kBN * kLds + (wn * 32 + j * 16) * kLds + kk, kLds);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[g][i][j], fa[i], fb, acc[g][i][j]);
        }
      }
    }
    __syncthreads();
  }

  float* c_s = reinterpret_cast<float*>(smem);  // kNB tiles of kBM x kLdc
#pragma unroll
  for (int g = 0; g < kNB; ++g)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(c_s + g * kBM * kLdc + (wm * 32 + i * 16) * kLdc + wn * 32 + j * 16,
                                acc[g][i][j], kLdc, wmma::mem_row_major);
  __syncthreads();

  for (int e = threadIdx.x; e < kBM * kBN; e += kThreads) {
    const int r = e / kBN;
    const int col = e % kBN;
    const int gr = m0 + r;
    const int gc = n0 + col;
    if (gr >= m || gc >= n) continue;
    float y = round_bf16(round_bf16(c_s[r * kLdc + col]) + __bfloat162float(bias[gc]));
    if (kEpi != kBias) {
      y = round_bf16(gelu_exact(y));
      if (kEpi == kGeluGated) {
        const float gate = round_bf16(round_bf16(c_s[kBM * kLdc + r * kLdc + col]) +
                                      __bfloat162float(bg[gc]));
        y = round_bf16(y * gate);
      }
    }
    c[static_cast<size_t>(gr) * n + gc] = __float2bfloat16_rn(y);
  }
}

}  // namespace
}  // namespace mmt

extern "C" {

// x (m, d); w1, wg (f, d); w2 (d, f); biases (f,) / (d,); hidden (m, f) is
// scratch for the activation; out (m, d). wg and bg are null when ungated.
// Returns the first non-zero cudaError_t of the two launches (0 on success).
int mmt_geglu_ffn(const void* x, const void* w1, const void* b1, const void* wg,
                  const void* bg, const void* w2, const void* b2, void* hidden, void* out,
                  int m, int d, int f, void* stream) {
  using namespace mmt;
  if (d % 8 != 0 || f % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const dim3 grid_up((f + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (wg != nullptr) {
    ffn_gemm_kernel<kGeluGated><<<grid_up, kThreads, 0, s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(w1), static_cast<const bf*>(b1),
        static_cast<const bf*>(wg), static_cast<const bf*>(bg), static_cast<bf*>(hidden), m, f,
        d);
  } else {
    ffn_gemm_kernel<kGelu><<<grid_up, kThreads, 0, s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(w1), static_cast<const bf*>(b1),
        nullptr, nullptr, static_cast<bf*>(hidden), m, f, d);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_down((d + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  ffn_gemm_kernel<kBias><<<grid_down, kThreads, 0, s>>>(
      static_cast<const bf*>(hidden), static_cast<const bf*>(w2), static_cast<const bf*>(b2),
      nullptr, nullptr, static_cast<bf*>(out), m, d, f);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
