// Flash attention for the long-sequence encoder, for Hopper (sm_90a):
// online-softmax self-attention with an additive (B, L) key bias (forward)
// and its gradient recomputed from the saved logsumexp (backward).
//
// Replaces multimodalanalytical_tpu/ops/flash_attention.py _fwd (Pallas
// _fwd_kernel) and _bwd (Pallas _bwd_kernel).
//
// Bound on the H100: operations. At the encoder's shapes (B 8, H 8, L 4096,
// head_dim 64) the forward is 4 B H L^2 Dh = 275 GFLOP per call against
// 64 MB of q/k/v/out, far above the card's ~295 FLOP per byte, so the bf16
// tensor cores (989 TFLOP/s) are the roof.
//
// bf16 operands (the training path) run on the tensor cores with wgmma
// (m64nNk16, bf16 operands, fp32 accumulators) and TMA. A block is one
// producer warpgroup, whose single thread keeps a 2-stage ring of 64- or
// 128-row tiles full with TMA loads and mbarriers, and two consumer
// warpgroups of 64 rows each: 128 query rows (forward, dQ) or 128 keys
// (dK/dV) per block. Tiles are 64-column boxes with the 128-byte swizzle
// that the wgmma descriptors read; a "full" barrier per stage counts the
// landed bytes, an "empty" one the consumer threads done with the stage, so
// the next tiles' loads overlap this tile's products. S = Q K^T (and
// dP = dO V^T, S^T = K Q^T, dP^T = V dO^T) read both operands from shared
// memory, K-major; P and dS go from the fp32 accumulators straight into the
// A registers of the next product (the accumulator layout is the A
// layout), never through shared memory, and the B operand of O += P V
// (dQ += dS K, dV += P^T dO, dK += dS^T Q) is read MN-major with wgmma's
// transpose bit. The forward takes 128 keys per stage at head_dim 64 (an
// m64n128 S product; 64 at 128, where O's accumulators take twice the
// registers) and masks keys past len in a 64-key tail. The backward keeps
// one block per key tile for dK and dV (a loop over query tiles) and one per
// query tile for dQ (a loop over key tiles): every gradient is written
// once, without atomics, so results are the same bits run to run and no
// fp32 dQ buffer exists. That split runs 7 products per tile pair where the
// bound counts 5 (about 40% more tensor work). The dK/dV consumers hold two
// head_dim-wide accumulators, so the producer warpgroup hands its registers
// to them (setmaxnreg 24 / 240).
//
// Numerics of the bf16 path: products of bf16 q and k are exact in fp32;
// the head_dim**-0.5 scale is applied to S in fp32 (at head_dim 64 it is
// 2^-3, so this equals the reference's (q * scale) . k exactly); the bias
// is added in fp32; the running max and the denominator are summed from
// the fp32 probabilities, so the logsumexp stays fp32-faithful. P (forward,
// dV) and dS (dQ, dK) are rounded to bf16 only as tensor-core operands;
// every sum stays in fp32 and outputs are rounded once. The running max
// starts at NEG_INF (-1e9) and every key tile is visited, fully masked ones
// included: a row whose real keys are all masked weighs its padded keys
// like the reference does.
//
// fp32 operands keep the first version's kernels (scalar fp32 FMAs, 64 x 64
// tiles staged as fp32, synchronous loads): TF32 tensor cores would change
// fp32 results at 1e-3, and no path on the card runs an fp32 model at
// L >= 2048.
//
// head_dim is 64 (every shipped model config: d_model 512 / 8, 768 / 12,
// 1024 / 16), 128, 192 or 256, the multiples of 64 up to 256 that the JAX
// gate routes here; each is its own instantiation. At 192 and 256 the
// shared-memory and register plans change: the forward keeps its 64-key
// stages (Q 64 KB + a 2-stage K/V ring of 128 KB at 256) and its producer
// hands registers to the consumers (O takes 128 fp32 registers a thread);
// the backward's ring has one stage at 256 (two 64 KB resident blocks + two
// 32 KB tiles), dQ's consumers take the producer's registers too, and dK
// and dV are computed by two launches, each holding one head_dim-wide
// accumulator. The fp32 backward stages three tiles instead of four there
// (Geom). len is a multiple of 64: a 128-row block whose last 64 rows lie
// past len leaves its second consumer warpgroup idle.

#include <cuda.h>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace mmt {
namespace {

constexpr int kTile = 64;          // rows of q and of k/v per tile
constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kLdp = kTile + 16;   // floats per row of a 64 x 64 probability tile
constexpr float kNegInf = -1e9f;   // the reference's NEG_INF (running-max start)

// What a dK/dV launch computes: both (head_dim up to 128), or, above, dV in
// one launch and dK in another. On the tensor cores two head_dim-wide
// accumulators would not fit in 240 registers; on the FMA path four staged
// fp32 tiles would not fit in shared memory.
enum BwdPass { kDkDv = 0, kDvOnly = 1, kDkOnly = 2 };
template <int HD>
__host__ __device__ constexpr bool split_dkdv() { return HD > 128; }

// ------------------------------------------------------------ fp32 path
// Scalar fp32 FMA kernels (the fp32 instantiation): one 256-thread block
// per (batch * head, 64-row tile), 64-row operand tiles staged as fp32, a
// 4 x (head_dim / 16) register tile per thread for every 64-row product.

// Geometry of one head width: staged rows are HD + 4 floats (16-byte
// aligned), and a thread's output tile is 4 rows x 4 columns in each of
// the HD / 64 column chunks (columns 64 c + 4 tx + e).
//
// Above head_dim 128 four staged tiles no longer fit (266 KB at 256), so the
// backward holds three: dK and dV take one launch each (a dV pass needs no
// V, a dK pass stages dO and then Q in one tile), and dQ stages a key
// tile's V and then its K in one tile.
template <int HD>
struct Geom {
  static constexpr int kLd = HD + 4;
  static constexpr int kChunks = HD / 64;
  static constexpr int kCols = 4 * kChunks;
  static constexpr int kTiles = split_dkdv<HD>() ? 3 : 4;   // staged tiles in the backward
  static constexpr size_t kFwdSmem = (3 * kTile * kLd + kTile * kLdp + kTile) * sizeof(float);
  static constexpr size_t kDkdvSmem =
      (kTiles * kTile * kLd + (split_dkdv<HD>() ? 1 : 2) * kTile * kLdp + 3 * kTile) *
      sizeof(float);
  static constexpr size_t kDqSmem = (kTiles * kTile * kLd + kTile * kLdp + kTile) * sizeof(float);
};

// Stage kTile rows of a row-major (rows, HD) matrix as fp32, times `mul`.
template <int HD, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, float mul) {
  constexpr int kLd = Geom<HD>::kLd;
  for (int i = threadIdx.x; i < kTile * HD / 8; i += kThreads) {
    const int r = i / (HD / 8);
    const int c = (i % (HD / 8)) * 8;
    float x[8];
    load8(src + static_cast<size_t>(r) * HD + c, x);
    float4* out = reinterpret_cast<float4*>(dst + r * kLd + c);
    out[0] = make_float4(x[0] * mul, x[1] * mul, x[2] * mul, x[3] * mul);
    out[1] = make_float4(x[4] * mul, x[5] * mul, x[6] * mul, x[7] * mul);
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d]   (a . b^T over head_dim)
template <int HD>
__device__ __forceinline__ void tile_dot(const float* a, const float* b, int ty, int tx,
                                         float acc[4][4]) {
  constexpr int kLd = Geom<HD>::kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kLd + d);
      bv[i] = *reinterpret_cast<const float4*>(b + (tx + 16 * i) * kLd + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// acc[i][4 ch + e] += sum_c p[ty + 16 i][c] * b[c][64 ch + 4 tx + e]
// (a 64 x 64 tile p, stride kLdp, times a staged 64 x HD tile b).
template <int HD>
__device__ __forceinline__ void tile_accumulate(const float* p, const float* b, int ty, int tx,
                                                float acc[4][Geom<HD>::kCols]) {
  constexpr int kLd = Geom<HD>::kLd;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(p + (ty + 16 * i) * kLdp + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int ch = 0; ch < Geom<HD>::kChunks; ++ch) {
        const float4 bv = *reinterpret_cast<const float4*>(b + (c + cc) * kLd + 64 * ch + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
          acc[i][4 * ch + 0] = fmaf(w, bv.x, acc[i][4 * ch + 0]);
          acc[i][4 * ch + 1] = fmaf(w, bv.y, acc[i][4 * ch + 1]);
          acc[i][4 * ch + 2] = fmaf(w, bv.z, acc[i][4 * ch + 2]);
          acc[i][4 * ch + 3] = fmaf(w, bv.w, acc[i][4 * ch + 3]);
        }
      }
    }
  }
}

// Reductions over the 16 lanes (tx = 0..15) that share a row.
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Write a thread's output tile (rows ty + 16 i, columns 64 ch + 4 tx + e)
// times `mul` to a row-major (len, HD) matrix, starting at row0.
template <int HD, typename T>
__device__ __forceinline__ void store_tile(T* dst, int row0, int ty, int tx,
                                           const float acc[4][Geom<HD>::kCols], float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* row = dst + static_cast<size_t>(row0 + ty + 16 * i) * HD + 4 * tx;
#pragma unroll
    for (int ch = 0; ch < Geom<HD>::kChunks; ++ch)
#pragma unroll
      for (int e = 0; e < 4; ++e) row[64 * ch + e] = from_f32<T>(acc[i][4 * ch + e] * mul);
  }
}

// Grid (len / 64, B * H). One block: 64 query rows against every key tile.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ lse, int heads,
    int len, float scale) {
  constexpr int kLd = Geom<HD>::kLd;
  constexpr int kCols = Geom<HD>::kCols;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [64][kLd] q * scale
  float* k_s = q_s + kTile * kLd;    // [64][kLd]
  float* v_s = k_s + kTile * kLd;    // [64][kLd]
  float* p_s = v_s + kTile * kLd;    // [64 rows][kLdp] probabilities
  float* b_s = p_s + kTile * kLdp;   // [64] key bias
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const size_t base = static_cast<size_t>(bh) * len * HD;
  const float* bias_row = bias + static_cast<size_t>(bh / heads) * len;

  stage_rows<HD>(q_s, q + base + static_cast<size_t>(q0) * HD, scale);
  float m[4], l[4], o[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) o[i][e] = 0.f;
  }

  for (int k0 = 0; k0 < len; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<HD>(k_s, k + base + static_cast<size_t>(k0) * HD, 1.f);
    stage_rows<HD>(v_s, v + base + static_cast<size_t>(k0) * HD, 1.f);
    if (threadIdx.x < kTile) b_s[threadIdx.x] = bias_row[k0 + threadIdx.x];
    __syncthreads();

    float s[4][4];
    tile_dot<HD>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += b_s[tx + 16 * j];
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * kLdp + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kCols; ++e) o[i][e] *= corr;
    }
    __syncthreads();
    tile_accumulate<HD>(p_s, v_s, ty, tx, o);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float safe = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) o[i][e] /= safe;
    if (tx == 0) lse[static_cast<size_t>(bh) * len + q0 + ty + 16 * i] = m[i] + logf(safe);
  }
  store_tile<HD>(out + base, q0, ty, tx, o, 1.f);
}

// delta[row] = sum_d dO[row][d] * O[row][d] in fp32, one warp per row.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) flash_delta_kernel(
    const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const size_t off = static_cast<size_t>(row) * HD;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) {
    acc = fmaf(to_f32(dout[off + d]), to_f32(out[off + d]), acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// Grid (len / 64, B * H). One block: the dK and dV of 64 keys (or one of
// them, kPass), summed in registers over every query tile. Computed
// transposed (keys as rows), so P^T and dS^T land in shared memory in the
// layout the sums read.
template <int HD, typename T, int kPass>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int heads, int len,
    float scale) {
  constexpr int kLd = Geom<HD>::kLd;
  constexpr int kCols = Geom<HD>::kCols;
  constexpr bool kDv = kPass != kDkOnly, kDk = kPass != kDvOnly;
  extern __shared__ __align__(16) float smem[];
  // kDkDv: K, V, Q, dO, P^T, dS^T. kDvOnly: K, Q, dO, P^T. kDkOnly: K, V,
  // one tile for dO and then Q, dS^T.
  float* k_s = smem;                                          // [64 keys][kLd]
  float* v_s = k_s + kTile * kLd;                             // (not kDvOnly)
  float* q_s = kDk ? v_s + kTile * kLd : v_s;                 // [64 queries][kLd] q * scale
  float* do_s = kPass == kDkOnly ? q_s : q_s + kTile * kLd;   // [64 queries][kLd]
  float* pt_s = do_s + kTile * kLd;                           // [64 keys][kLdp] P^T (kDv)
  float* dst_s = kDv ? pt_s + kTile * kLdp : pt_s;            // [64 keys][kLdp] dS^T (kDk)
  float* b_s = kDk ? dst_s + kTile * kLdp : pt_s + kTile * kLdp;   // [64] this block's keys
  float* lse_s = b_s + kTile;                                 // [64] of the current query tile
  float* delta_s = lse_s + kTile;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const size_t base = static_cast<size_t>(bh) * len * HD;
  const size_t row_base = static_cast<size_t>(bh) * len;

  stage_rows<HD>(k_s, k + base + static_cast<size_t>(k0) * HD, 1.f);
  if constexpr (kDk) stage_rows<HD>(v_s, v + base + static_cast<size_t>(k0) * HD, 1.f);
  if (threadIdx.x < kTile) b_s[threadIdx.x] = bias[static_cast<size_t>(bh / heads) * len + k0 + threadIdx.x];
  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < kCols; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int q0 = 0; q0 < len; q0 += kTile) {
    __syncthreads();
    if constexpr (kPass != kDkOnly) {
      stage_rows<HD>(q_s, q + base + static_cast<size_t>(q0) * HD, scale);
    }
    stage_rows<HD>(do_s, dout + base + static_cast<size_t>(q0) * HD, 1.f);
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lse[row_base + q0 + threadIdx.x];
      delta_s[threadIdx.x] = delta[row_base + q0 + threadIdx.x];
    }
    __syncthreads();

    float st[4][4], dpt[4][4];
    if constexpr (kPass == kDkOnly) {
      tile_dot<HD>(v_s, do_s, ty, tx, dpt);   // dP^T
      __syncthreads();                        // every thread is done with dO
      stage_rows<HD>(q_s, q + base + static_cast<size_t>(q0) * HD, scale);
      __syncthreads();
      tile_dot<HD>(k_s, q_s, ty, tx, st);     // S^T
    } else {
      tile_dot<HD>(k_s, q_s, ty, tx, st);     // S^T: keys ty + 16 i, queries tx + 16 j
      if constexpr (kDk) tile_dot<HD>(v_s, do_s, ty, tx, dpt);   // dP^T
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = tx + 16 * j;
        const float p = expf(st[i][j] + b_s[ty + 16 * i] - lse_s[qi]);
        if constexpr (kDv) pt_s[(ty + 16 * i) * kLdp + qi] = p;
        if constexpr (kDk) dst_s[(ty + 16 * i) * kLdp + qi] = p * (dpt[i][j] - delta_s[qi]);
      }
    __syncthreads();
    if constexpr (kDv) tile_accumulate<HD>(pt_s, do_s, ty, tx, dv_acc);    // dV += P^T dO
    if constexpr (kDk) tile_accumulate<HD>(dst_s, q_s, ty, tx, dk_acc);   // dK += dS^T (q * scale)
  }
  if constexpr (kDk) store_tile<HD>(dk + base, k0, ty, tx, dk_acc, 1.f);
  if constexpr (kDv) store_tile<HD>(dv + base, k0, ty, tx, dv_acc, 1.f);
}

// Grid (len / 64, B * H). One block: dQ of 64 query rows over every key tile.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int heads, int len, float scale) {
  constexpr int kLd = Geom<HD>::kLd;
  constexpr int kCols = Geom<HD>::kCols;
  constexpr bool kOneTile = split_dkdv<HD>();   // V, then K, in one tile
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // [64 queries][kLd] q * scale
  float* do_s = q_s + kTile * kLd;
  float* k_s = do_s + kTile * kLd;     // [64 keys][kLd]
  float* v_s = kOneTile ? k_s : k_s + kTile * kLd;
  float* ds_s = v_s + kTile * kLd;     // [64 queries][kLdp] dS
  float* b_s = ds_s + kTile * kLdp;    // [64] bias of the current key tile
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const size_t base = static_cast<size_t>(bh) * len * HD;
  const float* bias_row = bias + static_cast<size_t>(bh / heads) * len;

  stage_rows<HD>(q_s, q + base + static_cast<size_t>(q0) * HD, scale);
  stage_rows<HD>(do_s, dout + base + static_cast<size_t>(q0) * HD, 1.f);
  float row_lse[4], row_delta[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = static_cast<size_t>(bh) * len + q0 + ty + 16 * i;
    row_lse[i] = lse[row];
    row_delta[i] = delta[row];
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[i][e] = 0.f;
  }

  for (int k0 = 0; k0 < len; k0 += kTile) {
    __syncthreads();
    if constexpr (!kOneTile) stage_rows<HD>(k_s, k + base + static_cast<size_t>(k0) * HD, 1.f);
    stage_rows<HD>(v_s, v + base + static_cast<size_t>(k0) * HD, 1.f);
    if (threadIdx.x < kTile) b_s[threadIdx.x] = bias_row[k0 + threadIdx.x];
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<HD>(do_s, v_s, ty, tx, dp);
    if constexpr (kOneTile) {
      __syncthreads();                 // every thread is done with V
      stage_rows<HD>(k_s, k + base + static_cast<size_t>(k0) * HD, 1.f);
      __syncthreads();
    }
    tile_dot<HD>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] + b_s[tx + 16 * j] - row_lse[i]);
        ds_s[(ty + 16 * i) * kLdp + tx + 16 * j] = p * (dp[i][j] - row_delta[i]);
      }
    __syncthreads();
    tile_accumulate<HD>(ds_s, k_s, ty, tx, acc);       // dQ / scale += dS K
  }
  store_tile<HD>(dq + base, q0, ty, tx, acc, scale);
}

// ------------------------------------------------ bf16 path: wgmma, TMA
// Shared rows are 64 bf16 (128 bytes, one swizzle span), so a head_dim-128
// tile is two 64-column halves, [HD / 64][rows][64].
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;
constexpr int kBlockRows = 128;
constexpr int kStages = 2;
constexpr int kRowBytes = 128;     // 64 bf16: one swizzle span
constexpr int kBoxRows = 64;       // rows of one TMA box
constexpr float kLog2e = 1.4426950408889634f;

// The fp32 accumulators of a 16-column k-step (8-column chunks c0, c1) as
// the A fragment (registers) of the next product, rounded to bf16: the
// accumulator layout of a warp's 16 rows is the A-operand layout.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4], const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Write a warp's 16 x HD accumulators (8-column chunks of 4: rows g and
// g + 8, columns 2 t, 2 t + 1) times mul[row half], rounded to bf16, to
// rows row0.. of a row-major (len, HD) matrix.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, int row0, const float* acc,
                                           const float mul[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row0 + g + 8 * h) * HD + 8 * nd +
                                   2 * t) =
          pack_bf16(acc[4 * nd + 2 * h] * mul[h], acc[4 * nd + 2 * h + 1] * mul[h]);
    }
  }
}

// Forward layout: Q (128 rows), then per stage a K and a V tile.
template <int HD>
struct Layout {
  // keys per stage: 128 at head_dim 64 (an m64n128 S product), 64 at 128,
  // where the accumulators of O take twice the registers
  static constexpr int kKeys = HD == 64 ? 128 : 64;
  static constexpr int kHalves = HD / 64;
  static constexpr int kQBytes = kHalves * kBlockRows * kRowBytes;
  static constexpr int kTileBytes = kHalves * kKeys * kRowBytes;
  // tiles (1024-byte aligned), then 1 + 4 kStages barriers, plus the
  // slack to align the dynamic shared base to 1024 bytes
  static constexpr int kBarrierOffset = kQBytes + 2 * kStages * kTileBytes;
  static constexpr size_t kSmem = 1024 + kBarrierOffset + 8 * (1 + 4 * kStages);
};

// A K-major operand: 64 rows from row0 of a [HD / 64][rows][64] swizzled
// block, head_dim columns 16 kk..16 kk + 15.
__device__ __forceinline__ uint64_t k_major(uint32_t block, int rows, int row0, int kk) {
  return smem_desc(block + ((kk / 4) * rows + row0) * kRowBytes + (kk % 4) * 32, 16, 1024);
}
// A transposed (MN-major) B operand: rows 16 kk..16 kk + 15 of such a
// block, every head_dim column (the halves `rows` rows apart).
__device__ __forceinline__ uint64_t mn_major(uint32_t block, int rows, int kk) {
  return smem_desc(block + 16 * kk * kRowBytes, rows * kRowBytes, 1024);
}

// Producer: `rows` rows from `row` of a (rows, HD) tensor map into a
// [HD / 64][rows][64] block, in 64 x 64 boxes.
template <int HD>
__device__ __forceinline__ void load_block(uint32_t dst, const CUtensorMap* map, int row, int rows,
                                           uint32_t bar) {
  for (int h = 0; h < HD / 64; ++h)
    for (int r = 0; r < rows; r += kBoxRows)
      tma_load(dst + (h * rows + r) * kRowBytes, map, 64 * h, row + r, bar);
}

// d (64 x N) (+)= a . b^T, both K-major in shared memory.
template <int N>
__device__ __forceinline__ void ss_product(float* d, uint64_t a, uint64_t b, int accumulate) {
  if constexpr (N == 64) {
    wgmma::wgmma_ss64(d, a, b, accumulate);
  } else {
    wgmma::wgmma_ss128(d, a, b, accumulate);
  }
}

// d (64 x HD) += a (registers) . b, b rows 16 kk..16 kk + 15 of a [HD / 64][rows][64]
// block, read transposed (MN-major): an m64n128 product per pair of 64-column
// halves and an m64n64 one for an odd last half. A 16-row group of a warp keeps
// columns 8 nd.. at d[4 nd..], so the product of columns c.. adds into d + c / 2.
template <int HD>
__device__ __forceinline__ void rs_product(float* d, const uint32_t a[4], uint32_t block,
                                           int rows, int kk) {
#pragma unroll
  for (int c = 0; c + 128 <= HD; c += 128) {
    wgmma::wgmma_rs_t128(d + c / 2, a, mn_major(block + (c / 64) * rows * kRowBytes, rows, kk));
  }
  if constexpr (HD % 128 == 64) {
    wgmma::wgmma_rs_t64(d + (HD - 64) / 2, a,
                        mn_major(block + (HD / 64 - 1) * rows * kRowBytes, rows, kk));
  }
}

// Registers at head_dim 192 and 256: O's (or dQ's) fp32 accumulators take HD / 2
// per thread, more than the 168 that 384 threads get each; the producer
// warpgroup, which needs few, hands its share to the consumers.
template <int HD>
__device__ __forceinline__ void producer_registers() {
  if constexpr (HD >= 192) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
}
template <int HD>
__device__ __forceinline__ void consumer_registers() {
  if constexpr (HD >= 192) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
}

// Grid (ceil(len / 128), B * H), 384 threads: 128 query rows (64 per
// consumer warpgroup) against every key tile, online softmax in registers.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const float* __restrict__ bias,
    bf16* __restrict__ out, float* __restrict__ lse, int heads, int len, float scale) {
  using L = Layout<HD>;
  constexpr int kKeys = L::kKeys;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + L::kQBytes;                      // stage st at + st * kTileBytes
  const uint32_t v_s = k_s + kStages * L::kTileBytes;
  const uint32_t bars = base + L::kBarrierOffset;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto k_empty = [&](int st) { return bars + 8 * (1 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return bars + 8 * (1 + 3 * kStages + st); };

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockRows;
  const int tiles = (len + kKeys - 1) / kKeys;   // keys past len are masked out
  const int consumers = (len - q0 >= kBlockRows ? 2 : 1) * 128;
  const int row_base = bh * len;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), consumers);
      mbar_init(v_empty(st), consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg_index = threadIdx.x / 128;
  if (wg_index == 0) {
    // ---- producer: one thread keeps the ring full
    producer_registers<HD>();
    if (threadIdx.x != 0) return;
    mbar_expect_tx(q_full, L::kQBytes);
    load_block<HD>(q_s, &q_map, row_base + q0, kBlockRows, q_full);
    for (int j = 0; j < tiles; ++j) {
      const int st = j % kStages;
      const uint32_t parity = ((j / kStages) & 1) ^ 1;
      mbar_wait(k_empty(st), parity);
      mbar_expect_tx(k_full(st), L::kTileBytes);
      load_block<HD>(k_s + st * L::kTileBytes, &k_map, row_base + j * kKeys, kKeys, k_full(st));
      mbar_wait(v_empty(st), parity);
      mbar_expect_tx(v_full(st), L::kTileBytes);
      load_block<HD>(v_s + st * L::kTileBytes, &v_map, row_base + j * kKeys, kKeys, v_full(st));
    }
    return;
  }

  // ---- consumers: 64 query rows per warpgroup, 16 per warp
  consumer_registers<HD>();
  const int wg = wg_index - 1;
  if (q0 + 64 * wg >= len) return;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, t4 = lane & 3;
  const float* bias_row = bias + static_cast<size_t>(bh / heads) * len;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int j = 0; j < tiles; ++j) {
    const int st = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    float s[kKeys / 2];
    mbar_wait(k_full(st), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      ss_product<kKeys>(s, k_major(q_s, kBlockRows, 64 * wg, kk),
                        k_major(k_s + st * L::kTileBytes, kKeys, 0, kk), kk > 0);
    }
    wgmma_commit_and_wait();
    fence_regs<kKeys / 2>(s);
    mbar_arrive(k_empty(st));

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < kKeys / 8; ++nb) {
      const int key = j * kKeys + 8 * nb + 2 * t4;
      // keys at or past len (a 64-key tail of the last 128-key tile) weigh 0
      const float2 bb = key < len ? *reinterpret_cast<const float2*>(bias_row + key)
                                  : make_float2(-INFINITY, -INFINITY);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        s[4 * nb + 2 * hr] = s[4 * nb + 2 * hr] * scale + bb.x;
        s[4 * nb + 2 * hr + 1] = s[4 * nb + 2 * hr + 1] * scale + bb.y;
        mx[hr] = fmaxf(mx[hr], fmaxf(s[4 * nb + 2 * hr], s[4 * nb + 2 * hr + 1]));
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = quad_max(mx[hr]);
      const float corr = exp2f((m[hr] - mx[hr]) * kLog2e);
      m[hr] = mx[hr];
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < kKeys / 8; ++nb) {
        s[4 * nb + 2 * hr] = exp2f((s[4 * nb + 2 * hr] - mx[hr]) * kLog2e);
        s[4 * nb + 2 * hr + 1] = exp2f((s[4 * nb + 2 * hr + 1] - mx[hr]) * kLog2e);
        sum += s[4 * nb + 2 * hr] + s[4 * nb + 2 * hr + 1];
      }
      l[hr] = l[hr] * corr + sum;
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
        o[4 * nd + 2 * hr] *= corr;
        o[4 * nd + 2 * hr + 1] *= corr;
      }
    }
    uint32_t p[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) acc_to_a(p[kk], s + 8 * kk, s + 8 * kk + 4);

    mbar_wait(v_full(st), parity);
    fence_regs<HD / 2>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      rs_product<HD>(o, p[kk], v_s + st * L::kTileBytes, kKeys, kk);
    }
    wgmma_commit_and_wait();
    fence_regs<HD / 2>(o);
    mbar_arrive(v_empty(st));
  }

  const int row0 = q0 + 64 * wg + 16 * warp;
  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float total = quad_sum(l[hr]);
    const float safe = total > 0.f ? total : 1.f;
    inv[hr] = 1.f / safe;
    if (t4 == 0) lse[static_cast<size_t>(row_base) + row0 + (lane >> 2) + 8 * hr] = m[hr] + logf(safe);
  }
  store_rows<HD>(out + static_cast<size_t>(row_base) * HD, row0, o, inv, lane);
}

// Shared layout of the backward kernels: two 128-row blocks resident for
// the whole loop (dQ: Q and dO; dK/dV: K and V), then a ring of two 64-row
// tiles per stage (dQ: K and V; dK/dV: Q and dO), then 1 + 2 kStages
// barriers. Two stages up to head_dim 192 (192 KB there); one at 256, where
// two would take 256 KB of the 227 KB a block may have.
template <int HD>
struct BwdLayout {
  static constexpr int kRows = 64;   // rows of a ring tile
  static constexpr int kBlockBytes = HD / 64 * kBlockRows * kRowBytes;
  static constexpr int kTileBytes = HD / 64 * kRows * kRowBytes;
  static constexpr int kStages = 2 * kBlockBytes + 4 * kTileBytes + 2048 <= 232448 ? 2 : 1;
  static constexpr int kBarrierOffset = 2 * kBlockBytes + kStages * 2 * kTileBytes;
  static constexpr size_t kSmem = 1024 + kBarrierOffset + 8 * (1 + 2 * kStages);
};


// Grid (ceil(len / 128), B * H), 384 threads: dQ of 128 query rows (64 per
// consumer warpgroup) over every key tile of 64. S = Q K^T and dP = dO V^T
// with both operands in shared memory, dQ += dS K with dS from registers.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ bias, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int heads, int len, float scale) {
  using L = BwdLayout<HD>;
  constexpr int kKeys = L::kRows;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + L::kBlockBytes;
  auto k_s = [&](int st) { return base + 2 * L::kBlockBytes + 2 * st * L::kTileBytes; };
  auto v_s = [&](int st) { return k_s(st) + L::kTileBytes; };
  const uint32_t bars = base + L::kBarrierOffset;
  const uint32_t block_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kStages + st); };

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockRows;
  const int tiles = len / kKeys;
  const int row_base = bh * len;
  if (threadIdx.x == 0) {
    mbar_init(block_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), (len - q0 >= kBlockRows ? 2 : 1) * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg_index = threadIdx.x / 128;
  if (wg_index == 0) {
    producer_registers<HD>();
    if (threadIdx.x != 0) return;
    mbar_expect_tx(block_full, 2 * L::kBlockBytes);
    load_block<HD>(q_s, &q_map, row_base + q0, kBlockRows, block_full);
    load_block<HD>(do_s, &do_map, row_base + q0, kBlockRows, block_full);
    for (int j = 0; j < tiles; ++j) {
      const int st = j % kStages;
      mbar_wait(empty(st), ((j / kStages) & 1) ^ 1);
      mbar_expect_tx(full(st), 2 * L::kTileBytes);
      load_block<HD>(k_s(st), &k_map, row_base + j * kKeys, kKeys, full(st));
      load_block<HD>(v_s(st), &v_map, row_base + j * kKeys, kKeys, full(st));
    }
    return;
  }

  consumer_registers<HD>();
  const int wg = wg_index - 1;
  if (q0 + 64 * wg >= len) return;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, t4 = lane & 3;
  const int row0 = q0 + 64 * wg + 16 * warp;
  const float* bias_row = bias + static_cast<size_t>(bh / heads) * len;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    row_lse[hr] = lse[static_cast<size_t>(row_base) + row0 + (lane >> 2) + 8 * hr];
    row_delta[hr] = delta[static_cast<size_t>(row_base) + row0 + (lane >> 2) + 8 * hr];
  }
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  mbar_wait(block_full, 0);

  for (int j = 0; j < tiles; ++j) {
    const int st = j % kStages;
    float s[kKeys / 2], dp[kKeys / 2];
    mbar_wait(full(st), (j / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      ss_product<kKeys>(s, k_major(q_s, kBlockRows, 64 * wg, kk), k_major(k_s(st), kKeys, 0, kk),
                        kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      ss_product<kKeys>(dp, k_major(do_s, kBlockRows, 64 * wg, kk),
                        k_major(v_s(st), kKeys, 0, kk), kk > 0);
    }
    wgmma_commit_and_wait();
    fence_regs<kKeys / 2>(s);
    fence_regs<kKeys / 2>(dp);
#pragma unroll
    for (int nb = 0; nb < kKeys / 8; ++nb) {
      const float2 bb = *reinterpret_cast<const float2*>(bias_row + j * kKeys + 8 * nb + 2 * t4);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = 4 * nb + 2 * hr;
        const float p0 = exp2f((s[i] * scale + bb.x - row_lse[hr]) * kLog2e);
        const float p1 = exp2f((s[i + 1] * scale + bb.y - row_lse[hr]) * kLog2e);
        s[i] = p0 * (dp[i] - row_delta[hr]);                       // dS
        s[i + 1] = p1 * (dp[i + 1] - row_delta[hr]);
      }
    }
    uint32_t ds[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) acc_to_a(ds[kk], s + 8 * kk, s + 8 * kk + 4);
    fence_regs<HD / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) rs_product<HD>(acc, ds[kk], k_s(st), kKeys, kk);
    wgmma_commit_and_wait();
    fence_regs<HD / 2>(acc);
    mbar_arrive(empty(st));
  }

  const float mul[2] = {scale, scale};
  store_rows<HD>(dq + static_cast<size_t>(row_base) * HD, row0, acc, mul, lane);
}

// Grid (ceil(len / 128), B * H), 384 threads: dK and dV of 128 keys (64 per
// consumer warpgroup) over every query tile of 64, computed transposed
// (keys as rows): S^T = K Q^T and dP^T = V dO^T from shared memory, then
// dV += P^T dO and dK += dS^T Q with P^T and dS^T from registers. The
// producer warpgroup gives its registers to the consumers (setmaxnreg).
// kPass (BwdPass) leaves out what the other launch computes: dV needs no
// dP^T, dK no P^T dO.
template <int HD, int kPass>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ bias, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int heads,
    int len, float scale) {
  using L = BwdLayout<HD>;
  constexpr int kQueries = L::kRows;
  constexpr int kStages = L::kStages;
  constexpr bool kDv = kPass != kDkOnly, kDk = kPass != kDvOnly;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + L::kBlockBytes;
  auto q_s = [&](int st) { return base + 2 * L::kBlockBytes + 2 * st * L::kTileBytes; };
  auto do_s = [&](int st) { return q_s(st) + L::kTileBytes; };
  const uint32_t bars = base + L::kBarrierOffset;
  const uint32_t block_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kStages + st); };

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockRows;
  const int tiles = len / kQueries;
  const int row_base = bh * len;
  if (threadIdx.x == 0) {
    mbar_init(block_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), (len - k0 >= kBlockRows ? 2 : 1) * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg_index = threadIdx.x / 128;
  if (wg_index == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(block_full, 2 * L::kBlockBytes);
      load_block<HD>(k_s, &k_map, row_base + k0, kBlockRows, block_full);
      load_block<HD>(v_s, &v_map, row_base + k0, kBlockRows, block_full);
      for (int j = 0; j < tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(empty(st), ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * L::kTileBytes);
        load_block<HD>(q_s(st), &q_map, row_base + j * kQueries, kQueries, full(st));
        load_block<HD>(do_s(st), &do_map, row_base + j * kQueries, kQueries, full(st));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = wg_index - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, t4 = lane & 3;
    const int row0 = k0 + 64 * wg + 16 * warp;
    if (k0 + 64 * wg < len) {
      float key_bias[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        key_bias[hr] = bias[static_cast<size_t>(bh / heads) * len + row0 + (lane >> 2) + 8 * hr];
      }
      // the accumulator a pass leaves out is never touched, so it takes no registers
      float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) {
        if constexpr (kDk) dk_acc[i] = 0.f;
        if constexpr (kDv) dv_acc[i] = 0.f;
      }
      mbar_wait(block_full, 0);

      for (int j = 0; j < tiles; ++j) {
        const int st = j % kStages;
        float s[kQueries / 2], dp[kQueries / 2];
        mbar_wait(full(st), (j / kStages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          ss_product<kQueries>(s, k_major(k_s, kBlockRows, 64 * wg, kk),
                               k_major(q_s(st), kQueries, 0, kk), kk > 0);
        }
        if constexpr (kDk) {
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            ss_product<kQueries>(dp, k_major(v_s, kBlockRows, 64 * wg, kk),
                                 k_major(do_s(st), kQueries, 0, kk), kk > 0);
          }
        }
        wgmma_commit_and_wait();
        fence_regs<kQueries / 2>(s);
        if constexpr (kDk) fence_regs<kQueries / 2>(dp);
#pragma unroll
        for (int nb = 0; nb < kQueries / 8; ++nb) {
          const size_t col = static_cast<size_t>(row_base) + j * kQueries + 8 * nb + 2 * t4;
          const float2 lq = *reinterpret_cast<const float2*>(lse + col);
          const float2 dq = *reinterpret_cast<const float2*>(delta + col);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = 4 * nb + 2 * hr;
            const float p0 = exp2f((s[i] * scale + key_bias[hr] - lq.x) * kLog2e);
            const float p1 = exp2f((s[i + 1] * scale + key_bias[hr] - lq.y) * kLog2e);
            s[i] = p0;                                              // P^T
            s[i + 1] = p1;
            if constexpr (kDk) {
              dp[i] = p0 * (dp[i] - dq.x);                          // dS^T
              dp[i + 1] = p1 * (dp[i + 1] - dq.y);
            }
          }
        }
        uint32_t pt[kQueries / 16][4], dst[kQueries / 16][4];
#pragma unroll
        for (int kk = 0; kk < kQueries / 16; ++kk) {
          if constexpr (kDv) acc_to_a(pt[kk], s + 8 * kk, s + 8 * kk + 4);
          if constexpr (kDk) acc_to_a(dst[kk], dp + 8 * kk, dp + 8 * kk + 4);
        }
        if constexpr (kDv) fence_regs<HD / 2>(dv_acc);
        if constexpr (kDk) fence_regs<HD / 2>(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kQueries / 16; ++kk) {
          if constexpr (kDv) rs_product<HD>(dv_acc, pt[kk], do_s(st), kQueries, kk);  // dV += P^T dO
          if constexpr (kDk) rs_product<HD>(dk_acc, dst[kk], q_s(st), kQueries, kk);  // dK += dS^T Q
        }
        wgmma_commit_and_wait();
        if constexpr (kDv) fence_regs<HD / 2>(dv_acc);
        if constexpr (kDk) fence_regs<HD / 2>(dk_acc);
        mbar_arrive(empty(st));
      }

      const float one[2] = {1.f, 1.f}, mul[2] = {scale, scale};
      if constexpr (kDk) {
        store_rows<HD>(dk + static_cast<size_t>(row_base) * HD, row0, dk_acc, mul, lane);
      }
      if constexpr (kDv) {
        store_rows<HD>(dv + static_cast<size_t>(row_base) * HD, row0, dv_acc, one, lane);
      }
    }
  }
}

// A (rows, HD) bf16 tensor as 64 x 64 boxes, 128-byte swizzle.
template <int HD>
bool make_map(CUtensorMap* map, const void* ptr, int rows) {
  return make_map_2d(map, ptr, HD, rows);
}

}  // namespace wg

template <int HD, typename T>
int run_fwd(const void* q, const void* k, const void* v, const void* bias, void* out, void* lse,
            int bh, int heads, int len, float scale, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    CUtensorMap q_map, k_map, v_map;
    if (!wg::make_map<HD>(&q_map, q, bh * len) || !wg::make_map<HD>(&k_map, k, bh * len) ||
        !wg::make_map<HD>(&v_map, v, bh * len)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    constexpr size_t smem = wg::Layout<HD>::kSmem;
    auto kernel = wg::flash_fwd_wgmma_kernel<HD>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3((len + wg::kBlockRows - 1) / wg::kBlockRows, bh), wg::kThreads, smem, s>>>(
        q_map, k_map, v_map, static_cast<const float*>(bias), static_cast<T*>(out),
        static_cast<float*>(lse), heads, len, scale);
  } else {
    constexpr size_t smem = Geom<HD>::kFwdSmem;
    auto kernel = flash_fwd_kernel<HD, T>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(len / kTile, bh), kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<T*>(out), static_cast<float*>(lse), heads,
        len, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int HD, typename T>
int run_bwd(const void* q, const void* k, const void* v, const void* bias, const void* out,
            const void* lse, const void* dout, void* delta, void* dq, void* dk, void* dv, int bh,
            int heads, int len, float scale, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* b = static_cast<const float*>(bias);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  const int rows = bh * len;
  flash_delta_kernel<HD, T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(
      static_cast<const T*>(out), dot, delta_f, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    CUtensorMap q_map, k_map, v_map, do_map;
    if (!wg::make_map<HD>(&q_map, q, bh * len) || !wg::make_map<HD>(&k_map, k, bh * len) ||
        !wg::make_map<HD>(&v_map, v, bh * len) || !wg::make_map<HD>(&do_map, dout, bh * len)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    constexpr size_t smem = wg::BwdLayout<HD>::kSmem;
    const dim3 grid((len + wg::kBlockRows - 1) / wg::kBlockRows, bh);
    auto dkdv = [&](auto kernel) {
      cudaError_t e = allow_smem(kernel, smem);
      if (e != cudaSuccess) return e;
      kernel<<<grid, wg::kThreads, smem, s>>>(q_map, k_map, v_map, do_map, b, lse_f, delta_f,
                                              static_cast<T*>(dk), static_cast<T*>(dv), heads,
                                              len, scale);
      return cudaGetLastError();
    };
    if constexpr (split_dkdv<HD>()) {
      if ((err = dkdv(wg::flash_bwd_dkdv_wgmma_kernel<HD, kDvOnly>)) != cudaSuccess ||
          (err = dkdv(wg::flash_bwd_dkdv_wgmma_kernel<HD, kDkOnly>)) != cudaSuccess) {
        return static_cast<int>(err);
      }
    } else if ((err = dkdv(wg::flash_bwd_dkdv_wgmma_kernel<HD, kDkDv>)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    auto dq_kernel = wg::flash_bwd_dq_wgmma_kernel<HD>;
    if ((err = allow_smem(dq_kernel, smem)) != cudaSuccess) return static_cast<int>(err);
    dq_kernel<<<grid, wg::kThreads, smem, s>>>(q_map, k_map, v_map, do_map, b, lse_f, delta_f,
                                               static_cast<T*>(dq), heads, len, scale);
  } else {
    auto dkdv = [&](auto kernel) {
      cudaError_t e = allow_smem(kernel, Geom<HD>::kDkdvSmem);
      if (e != cudaSuccess) return e;
      kernel<<<dim3(len / kTile, bh), kThreads, Geom<HD>::kDkdvSmem, s>>>(
          qt, kt, vt, b, dot, lse_f, delta_f, static_cast<T*>(dk), static_cast<T*>(dv), heads,
          len, scale);
      return cudaGetLastError();
    };
    if constexpr (split_dkdv<HD>()) {
      if ((err = dkdv(flash_bwd_dkdv_kernel<HD, T, kDvOnly>)) != cudaSuccess ||
          (err = dkdv(flash_bwd_dkdv_kernel<HD, T, kDkOnly>)) != cudaSuccess) {
        return static_cast<int>(err);
      }
    } else if ((err = dkdv(flash_bwd_dkdv_kernel<HD, T, kDkDv>)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    auto dq_kernel = flash_bwd_dq_kernel<HD, T>;
    if ((err = allow_smem(dq_kernel, Geom<HD>::kDqSmem)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    dq_kernel<<<dim3(len / kTile, bh), kThreads, Geom<HD>::kDqSmem, s>>>(
        qt, kt, vt, b, dot, lse_f, delta_f, static_cast<T*>(dq), heads, len, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_fwd(int head_dim, const void* q, const void* k, const void* v, const void* bias,
                 void* out, void* lse, int bh, int heads, int len, float scale, cudaStream_t s) {
  switch (head_dim) {
    case 64: return run_fwd<64, T>(q, k, v, bias, out, lse, bh, heads, len, scale, s);
    case 128: return run_fwd<128, T>(q, k, v, bias, out, lse, bh, heads, len, scale, s);
    case 192: return run_fwd<192, T>(q, k, v, bias, out, lse, bh, heads, len, scale, s);
    default: return run_fwd<256, T>(q, k, v, bias, out, lse, bh, heads, len, scale, s);
  }
}

template <typename T>
int dispatch_bwd(int head_dim, const void* q, const void* k, const void* v, const void* bias,
                 const void* out, const void* lse, const void* dout, void* delta, void* dq,
                 void* dk, void* dv, int bh, int heads, int len, float scale, cudaStream_t s) {
  switch (head_dim) {
    case 64:
      return run_bwd<64, T>(q, k, v, bias, out, lse, dout, delta, dq, dk, dv, bh, heads, len,
                            scale, s);
    case 128:
      return run_bwd<128, T>(q, k, v, bias, out, lse, dout, delta, dq, dk, dv, bh, heads, len,
                             scale, s);
    case 192:
      return run_bwd<192, T>(q, k, v, bias, out, lse, dout, delta, dq, dk, dv, bh, heads, len,
                             scale, s);
    default:
      return run_bwd<256, T>(q, k, v, bias, out, lse, dout, delta, dq, dk, dv, bh, heads, len,
                             scale, s);
  }
}

bool supported(int len, int head_dim) {
  return len % kTile == 0 &&
         (head_dim == 64 || head_dim == 128 || head_dim == 192 || head_dim == 256);
}

}  // namespace
}  // namespace mmt

extern "C" {

// q, k, v, out: (batch * heads, len, head_dim) bf16 (is_bf16) or fp32,
// head_dim 64, 128, 192 or 256; bias: (batch, len) fp32; lse: (batch * heads, len)
// fp32; len % 64 == 0. bf16 runs on the tensor cores, fp32 on the FMA
// pipes. Returns the cudaError_t of the launch (0 on success).
int mmt_flash_attention_fwd(int is_bf16, const void* q, const void* k, const void* v,
                            const void* bias, void* out, void* lse, int batch, int heads, int len,
                            int head_dim, float scale, void* stream) {
  using namespace mmt;
  if (!supported(len, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  return is_bf16
             ? dispatch_fwd<__nv_bfloat16>(head_dim, q, k, v, bias, out, lse, bh, heads, len,
                                           scale, s)
             : dispatch_fwd<float>(head_dim, q, k, v, bias, out, lse, bh, heads, len, scale, s);
}

// As the forward, plus dout (the output's gradient, q's dtype), delta
// ((batch * heads, len) fp32 scratch) and dq, dk, dv (q's dtype). Three
// launches: delta, dk/dv, dq; four above head_dim 128 (dv and dk apart). Returns the first non-zero cudaError_t.
int mmt_flash_attention_bwd(int is_bf16, const void* q, const void* k, const void* v,
                            const void* bias, const void* out, const void* lse, const void* dout,
                            void* delta, void* dq, void* dk, void* dv, int batch, int heads,
                            int len, int head_dim, float scale, void* stream) {
  using namespace mmt;
  if (!supported(len, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  return is_bf16 ? dispatch_bwd<__nv_bfloat16>(head_dim, q, k, v, bias, out, lse, dout, delta,
                                               dq, dk, dv, bh, heads, len, scale, s)
                 : dispatch_bwd<float>(head_dim, q, k, v, bias, out, lse, dout, delta, dq, dk,
                                       dv, bh, heads, len, scale, s);
}

}  // extern "C"
