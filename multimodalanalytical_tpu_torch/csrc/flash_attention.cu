// Flash attention for the long-sequence encoder, for Hopper (sm_90a):
// online-softmax self-attention with an additive (B, L) key bias (forward)
// and its gradient recomputed from the saved logsumexp (backward).
//
// Replaces multimodalanalytical_tpu/ops/flash_attention.py _fwd (Pallas
// _fwd_kernel) and _bwd (Pallas _bwd_kernel).
//
// Numerics, as the Pallas kernels compute them: q, k and v are read in
// their storage type (bf16 or fp32) and converted to fp32; q is scaled by
// head_dim**-0.5 in fp32; every product, the running max, the denominator
// and the accumulators are fp32 scalar FMAs; the output and the gradients
// are rounded once. No product runs on the tensor cores, so nothing is
// rounded that the reference keeps in fp32 (in particular P for P.V).
// The running max starts at NEG_INF (-1e9) and every key tile is visited,
// fully masked ones included: a row whose real keys are all masked weighs
// its padded keys like the reference does. head_dim is 64 (every shipped
// model config: d_model 512 / 8, 768 / 12, 1024 / 16) or 128, the two
// multiples of 64 up to 128 that the JAX gate routes here; each is its own
// instantiation.
//
// Bound on the H100: operations. At the encoder's shapes (B 8, H 8, L 4096,
// head_dim 64) the forward is 4 B H L^2 Dh = 275 GFLOP per call against
// 64 MB of q/k/v/out, far above the card's ~295 FLOP per byte, so the
// tensor cores would be the roof. This first version is the simple one: it
// runs on the fp32 FMA pipes (67 TFLOP/s peak), one 256-thread block per
// (batch * head, 64-row tile), with the 64-row operand tiles staged in
// shared memory as fp32 and a 4 x (head_dim / 16) register tile per thread
// for every 64-row product; it reaches ~30 TFLOP/s there (H100 80GB HBM3,
// 700 W; PERF.md). The (L, L) logits never leave the block. The backward
// keeps no (L/256, L, Dh) partial buffers (the Pallas kernel's ~1 GiB each
// for dk and dv at B 8, L 4096): one block per key tile loops over all
// query tiles and holds its dK and dV sums in registers, and a second
// kernel per query tile recomputes the probabilities for dQ, so every
// gradient is written once, without atomics. Tensor cores, wgmma, TMA and
// a pipelined ring of tiles are later work.

#include "common.cuh"

namespace mmt {
namespace {

constexpr int kTile = 64;          // rows of q and of k/v per tile
constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kLdp = kTile + 16;   // floats per row of a 64 x 64 probability tile
constexpr float kNegInf = -1e9f;   // the reference's NEG_INF (running-max start)

// Geometry of one head width: staged rows are HD + 4 floats (16-byte
// aligned), and a thread's output tile is 4 rows x 4 columns in each of
// the HD / 64 column chunks (columns 64 c + 4 tx + e).
template <int HD>
struct Geom {
  static constexpr int kLd = HD + 4;
  static constexpr int kChunks = HD / 64;
  static constexpr int kCols = 4 * kChunks;
  static constexpr size_t kFwdSmem = (3 * kTile * kLd + kTile * kLdp + kTile) * sizeof(float);
  static constexpr size_t kDkdvSmem =
      (4 * kTile * kLd + 2 * kTile * kLdp + 3 * kTile) * sizeof(float);
  static constexpr size_t kDqSmem = (4 * kTile * kLd + kTile * kLdp + kTile) * sizeof(float);
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

// Grid (len / 64, B * H). One block: the dK and dV of 64 keys, summed in
// registers over every query tile. Computed transposed (keys as rows), so
// P^T and dS^T land in shared memory in the layout the sums read.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int heads, int len,
    float scale) {
  constexpr int kLd = Geom<HD>::kLd;
  constexpr int kCols = Geom<HD>::kCols;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                   // [64 keys][kLd]
  float* v_s = k_s + kTile * kLd;
  float* q_s = v_s + kTile * kLd;      // [64 queries][kLd] q * scale
  float* do_s = q_s + kTile * kLd;     // [64 queries][kLd]
  float* pt_s = do_s + kTile * kLd;    // [64 keys][kLdp] P^T
  float* dst_s = pt_s + kTile * kLdp;  // [64 keys][kLdp] dS^T
  float* b_s = dst_s + kTile * kLdp;   // [64] bias of this block's keys
  float* lse_s = b_s + kTile;          // [64] of the current query tile
  float* delta_s = lse_s + kTile;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const size_t base = static_cast<size_t>(bh) * len * HD;
  const size_t row_base = static_cast<size_t>(bh) * len;

  stage_rows<HD>(k_s, k + base + static_cast<size_t>(k0) * HD, 1.f);
  stage_rows<HD>(v_s, v + base + static_cast<size_t>(k0) * HD, 1.f);
  if (threadIdx.x < kTile) b_s[threadIdx.x] = bias[static_cast<size_t>(bh / heads) * len + k0 + threadIdx.x];
  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < kCols; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int q0 = 0; q0 < len; q0 += kTile) {
    __syncthreads();
    stage_rows<HD>(q_s, q + base + static_cast<size_t>(q0) * HD, scale);
    stage_rows<HD>(do_s, dout + base + static_cast<size_t>(q0) * HD, 1.f);
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lse[row_base + q0 + threadIdx.x];
      delta_s[threadIdx.x] = delta[row_base + q0 + threadIdx.x];
    }
    __syncthreads();

    float st[4][4], dpt[4][4];
    tile_dot<HD>(k_s, q_s, ty, tx, st);     // S^T: keys ty + 16 i, queries tx + 16 j
    tile_dot<HD>(v_s, do_s, ty, tx, dpt);   // dP^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = tx + 16 * j;
        const float p = expf(st[i][j] + b_s[ty + 16 * i] - lse_s[qi]);
        pt_s[(ty + 16 * i) * kLdp + qi] = p;
        dst_s[(ty + 16 * i) * kLdp + qi] = p * (dpt[i][j] - delta_s[qi]);
      }
    __syncthreads();
    tile_accumulate<HD>(pt_s, do_s, ty, tx, dv_acc);   // dV += P^T dO
    tile_accumulate<HD>(dst_s, q_s, ty, tx, dk_acc);   // dK += dS^T (q * scale)
  }
  store_tile<HD>(dk + base, k0, ty, tx, dk_acc, 1.f);
  store_tile<HD>(dv + base, k0, ty, tx, dv_acc, 1.f);
}

// Grid (len / 64, B * H). One block: dQ of 64 query rows over every key tile.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int heads, int len, float scale) {
  constexpr int kLd = Geom<HD>::kLd;
  constexpr int kCols = Geom<HD>::kCols;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // [64 queries][kLd] q * scale
  float* do_s = q_s + kTile * kLd;
  float* k_s = do_s + kTile * kLd;     // [64 keys][kLd]
  float* v_s = k_s + kTile * kLd;
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
    stage_rows<HD>(k_s, k + base + static_cast<size_t>(k0) * HD, 1.f);
    stage_rows<HD>(v_s, v + base + static_cast<size_t>(k0) * HD, 1.f);
    if (threadIdx.x < kTile) b_s[threadIdx.x] = bias_row[k0 + threadIdx.x];
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<HD>(q_s, k_s, ty, tx, s);
    tile_dot<HD>(do_s, v_s, ty, tx, dp);
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int HD, typename T>
int run_fwd(const void* q, const void* k, const void* v, const void* bias, void* out, void* lse,
            int bh, int heads, int len, float scale, cudaStream_t s) {
  constexpr size_t smem = Geom<HD>::kFwdSmem;
  auto kernel = flash_fwd_kernel<HD, T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(len / kTile, bh), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), static_cast<float*>(lse), heads, len,
      scale);
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

  auto dkdv = flash_bwd_dkdv_kernel<HD, T>;
  if ((err = allow_smem(dkdv, Geom<HD>::kDkdvSmem)) != cudaSuccess) return static_cast<int>(err);
  dkdv<<<dim3(len / kTile, bh), kThreads, Geom<HD>::kDkdvSmem, s>>>(
      qt, kt, vt, b, dot, lse_f, delta_f, static_cast<T*>(dk), static_cast<T*>(dv), heads, len,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  auto dq_kernel = flash_bwd_dq_kernel<HD, T>;
  if ((err = allow_smem(dq_kernel, Geom<HD>::kDqSmem)) != cudaSuccess) return static_cast<int>(err);
  dq_kernel<<<dim3(len / kTile, bh), kThreads, Geom<HD>::kDqSmem, s>>>(
      qt, kt, vt, b, dot, lse_f, delta_f, static_cast<T*>(dq), heads, len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_fwd(int head_dim, const void* q, const void* k, const void* v, const void* bias,
                 void* out, void* lse, int bh, int heads, int len, float scale, cudaStream_t s) {
  return head_dim == 64 ? run_fwd<64, T>(q, k, v, bias, out, lse, bh, heads, len, scale, s)
                        : run_fwd<128, T>(q, k, v, bias, out, lse, bh, heads, len, scale, s);
}

template <typename T>
int dispatch_bwd(int head_dim, const void* q, const void* k, const void* v, const void* bias,
                 const void* out, const void* lse, const void* dout, void* delta, void* dq,
                 void* dk, void* dv, int bh, int heads, int len, float scale, cudaStream_t s) {
  return head_dim == 64
             ? run_bwd<64, T>(q, k, v, bias, out, lse, dout, delta, dq, dk, dv, bh, heads, len,
                              scale, s)
             : run_bwd<128, T>(q, k, v, bias, out, lse, dout, delta, dq, dk, dv, bh, heads, len,
                               scale, s);
}

bool supported(int len, int head_dim) {
  return len % kTile == 0 && (head_dim == 64 || head_dim == 128);
}

}  // namespace
}  // namespace mmt

extern "C" {

// q, k, v, out: (batch * heads, len, head_dim) bf16 (is_bf16) or fp32,
// head_dim 64 or 128; bias: (batch, len) fp32; lse: (batch * heads, len)
// fp32; len % 64 == 0. Returns the cudaError_t of the launch (0 on success).
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
// launches: delta, dk/dv, dq. Returns the first non-zero cudaError_t.
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
