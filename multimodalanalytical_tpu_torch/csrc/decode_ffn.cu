// Decode-step feed-forward for Hopper (sm_90a): x W1^T + b1 -> exact-erf
// GELU -> (optional gate x (x Wg^T + bg)) -> W2^T + b2, in bf16 with fp32
// accumulation, rounding to bf16 after every product and every bias add as
// flax Dense(dtype=bfloat16) does.
//
// Replaces multimodalanalytical_tpu/ops/decode_ffn.py geglu_ffn (Pallas
// _ffn_kernel).
//
// Bound on the H100: at the decode shapes (M = B K = 128, 1280, 3840 rows,
// D 512, F 2048) the two products are 0.54 / 5.4 / 16 GFLOP against 4.2 MB
// of weights, so the bf16 tensor cores set the bound from M ~ 1280 up and
// the weight bytes below it. The first version was held back by neither
// roof but by latency: its down product gave (D / 64) x (M / 64) blocks
// (16 at M 128), each walking all of F in 64 synchronous steps. What
// bounds this one is the up GEMM: its epilogue (exact-erf GELU and three
// bf16 roundings on every element of the (M, F) activation) is ALU work of
// the order of its products, and its K is short (8 stages per tile), so
// its tiles spend a large share of their time outside the products.
//
// Design: two persistent GEMMs on wgmma (m64nNk16, bf16 operands from
// shared memory, fp32 accumulators in registers) with TMA loads, and a
// small reduction. A block is one or two consumer warpgroups (a 64 x N
// output tile each) and one producer warp whose single thread keeps a
// 4-stage ring of 64-deep operand tiles full (TMA, 128-byte swizzle, a
// "full" mbarrier per stage counting the landed bytes and an "empty" one
// counting the consumer threads done with it), running ahead across the
// block's tiles. Consumers issue a stage's products before they wait for
// the previous stage's (wgmma.wait_group 1), so copies and products
// overlap. Operands are K-major as they come: x (M, D) and W1 (F, D) for
// the up product, the activation (M, F) and W2 (D, F) for the down
// product. The plan (tile widths, groups, splits) is the wrapper's,
// ops/decode_ffn.py ffn_plan.
//   1. Up: 64 x 64 tiles. The epilogue runs the rounding chain on the
//      accumulators (the gated form keeps a second accumulator for Wg from
//      the same x tile) and stores the bf16 (M, F) activation: the value
//      the JAX kernel rounds to, 5 MB at M 1280, which stays in L2. With
//      two tiles per SM or more, a block's two warpgroups take turns at
//      the products (ping-pong), so one's epilogue overlaps the other's
//      products.
//   2. Down: 64 x 128 tiles (64 x 64 at small M), split-K over F so that
//      tiles x splits give every SM a block (9 splits at M 128, 2 at M
//      1280, 1 at M 3840). Split z takes 64-deep stages [z T / S,
//      (z + 1) T / S) of T. With one split the epilogue rounds, adds b2 and
//      rounds again; with more, each writes its fp32 partial tile into a
//      workspace and
//   3. a reduction adds the partials in split order 0..S-1, rounds, adds
//      b2 and rounds: no atomics, so reruns give the same bits.
//   Partial mode (tensor parallelism: a rank holds F / n of the columns of
//   W1 and the gate and the rows of W2): the down product's fp32 sum over
//   this rank's F, without b2 and without rounding, written as (M, D) fp32,
//   directly from the down GEMM with one split and by the reduction (the
//   partials added in split order, nothing more) with more. The caller sums
//   it over the ranks, then rounds, adds b2 and rounds, as step 3 does.
// Rows past M and columns past D or F (ragged shapes) are zero-filled by
// the TMA loads and masked in every store. Nothing here allocates,
// synchronises or reads device memory on the host, so a CUDA graph can
// capture the launches; the tensor maps are kernel parameters
// (__grid_constant__), encoded for each call.

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace mmt {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;                      // tile rows: one consumer warpgroup
constexpr int kBK = 64;                      // depth of a stage: one swizzle span
constexpr int kStages = 4;
constexpr int kConsumers = 128;              // threads of one consumer warpgroup
constexpr int kBoxBytes = 64 * kBK * 2;      // one 64 x 64 TMA box
constexpr int kTileA = kBoxBytes;            // the 64-row A tile
constexpr int kReduceThreads = 256;

enum Mode { kGelu = 0, kGeluGated = 1, kBias = 2, kPartial = 3 };

// Shared layout of a 64 x kBN tile (kBN 64 or 128: one m64nkBN product):
// per stage an A tile, then one B tile of kBN / 64 boxes (two B tiles when
// gated), 1024-byte aligned; then a full and an empty barrier per stage.
template <int kMode, int kBN>
struct Smem {
  static constexpr int kB = kMode == kGeluGated ? 2 : 1;
  static constexpr int kTileB = kBN * kBK * 2;
  static constexpr int kStageBytes = kTileA + kB * kTileB;
  static constexpr int kBarrierOffset = kStages * kStageBytes;
  static constexpr size_t kBytes = 1024 + kBarrierOffset + 8 * 2 * kStages;
};

// Both lanes rounded to bf16 and back (one packed conversion).
__device__ __forceinline__ float2 round2_bf16(float2 v) {
  return __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
}
__device__ __forceinline__ float2 operator+(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// A 64-row K-major operand in a 128-byte-swizzled tile: columns 16 kk..16
// kk + 15 of the stage (the descriptor walks 8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 32, 16, 1024);
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

// Work unit u of a GEMM: output tile (u % n_tiles, (u / n_tiles) % m_tiles)
// and split z = u / (n_tiles m_tiles), which takes the 64-deep stages
// [z T / S, (z + 1) T / S) of K (T = k_tiles, S = splits).
struct Unit {
  int n0, m0, z, kt0, tiles;
  __device__ __forceinline__ Unit(int u, int n_tiles, int m_tiles, int k_tiles, int splits,
                                  int tile_n) {
    n0 = (u % n_tiles) * tile_n;
    m0 = ((u / n_tiles) % m_tiles) * kBM;
    z = u / (n_tiles * m_tiles);
    kt0 = z * k_tiles / splits;
    tiles = (z + 1) * k_tiles / splits - kt0;
  }
};

// out = epilogue(a (m, K) . b (n, K)^T [, a . g^T]) for every work unit,
// persistent: block b takes units b, b + gridDim.x, ..., its k-th unit to
// consumer warpgroup k % kGroups. The producer loads the block's units in
// order through one ring, so the stages are consumed in that order too:
// with two groups, one group's products run while the other runs its
// epilogue (ping-pong), and with one, the next unit's first stages load
// during the epilogue.
template <int kMode, int kBN, int kGroups>
__global__ void __launch_bounds__(kGroups * kConsumers + 32) ffn_gemm_kernel(
    const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
    const __grid_constant__ CUtensorMap g_map, const bf16* __restrict__ bias,
    const bf16* __restrict__ gate_bias, void* __restrict__ out, int m, int n, int k_tiles,
    int splits) {
  using S = Smem<kMode, kBN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  auto a_s = [&](int st) { return base + st * S::kStageBytes; };
  auto b_s = [&](int st, int g) { return a_s(st) + kTileA + g * S::kTileB; };
  const uint32_t bars = base + S::kBarrierOffset;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };

  // With two groups, the unit whose products may start: unit k waits until
  // unit k - 1's stages have all landed. A group that waited on the full
  // barrier of a stage whose slot still held an earlier unit's stage could
  // not tell the two phases apart by parity; in turn, no group is ever
  // more than one phase ahead of a slot.
  __shared__ int turn;
  const int n_tiles = (n + kBN - 1) / kBN, m_tiles = (m + kBM - 1) / kBM;
  const int units = n_tiles * m_tiles * splits;
  if (threadIdx.x == 0) {
    turn = 0;
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kGroups * kConsumers) {
    // ---- producer: one thread keeps the ring full; c counts stages
    // across this block's units
    if (threadIdx.x != kGroups * kConsumers) return;
    int c = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w(u, n_tiles, m_tiles, k_tiles, splits, kBN);
      for (int i = 0; i < w.tiles; ++i, ++c) {
        const int st = c % kStages;
        mbar_wait(empty(st), ((c / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), S::kStageBytes);
        const int col = (w.kt0 + i) * kBK;
        tma_load(a_s(st), &a_map, col, w.m0, full(st));
#pragma unroll
        for (int g = 0; g < S::kB; ++g) {
          const CUtensorMap* map = g == 0 ? &b_map : &g_map;
#pragma unroll
          for (int box = 0; box < kBN / 64; ++box) {
            tma_load(b_s(st, g) + box * kBoxBytes, map, col, w.n0 + 64 * box, full(st));
          }
        }
      }
    }
    return;
  }

  // ---- consumers: a 64 x kBN tile per unit, 16 rows per warp; c counts
  // the block's stages, of every group's units
  constexpr int kAcc = kBN / 2;
  float acc[kAcc];
  float acc_g[S::kB == 2 ? kAcc : 1];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (S::kB == 2 ? kAcc : 1); ++i) acc_g[i] = 0.f;
  const int group = threadIdx.x / kConsumers;
  const int warp = threadIdx.x % kConsumers / 32, lane = threadIdx.x % 32;

  int c = 0;
  for (int k = 0, u = blockIdx.x; u < units; ++k, u += gridDim.x) {
    const Unit w(u, n_tiles, m_tiles, k_tiles, splits, kBN);
    if (k % kGroups != group) {      // another group's unit: skip its stages
      c += w.tiles;
      continue;
    }
    if constexpr (kGroups > 1) {
      while (*static_cast<volatile int*>(&turn) != k) __nanosleep(32);
    }
    for (int i = 0; i < w.tiles; ++i, ++c) {
      const int st = c % kStages;
      mbar_wait(full(st), (c / kStages) & 1);
      fence_regs<kAcc>(acc);
      if constexpr (S::kB == 2) fence_regs<kAcc>(acc_g);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t a = k_major(a_s(st), kk);
        ss_product<kBN>(acc, a, k_major(b_s(st, 0), kk), i > 0 || kk > 0);
        if constexpr (S::kB == 2) {
          ss_product<kBN>(acc_g, a, k_major(b_s(st, 1), kk), i > 0 || kk > 0);
        }
      }
      wgmma_commit();
      // The previous stage's products are done once at most this stage's
      // group is still running: hand its slot back to the producer.
      wgmma_wait<1>();
      fence_regs<kAcc>(acc);
      if constexpr (S::kB == 2) fence_regs<kAcc>(acc_g);
      if (i > 0) mbar_arrive(empty((c - 1) % kStages));
    }
    if constexpr (kGroups > 1) {
      // this group is past every full barrier of the unit: the next may start
      if (threadIdx.x % kConsumers == 0) *static_cast<volatile int*>(&turn) = k + 1;
    }
    wgmma_wait<0>();
    fence_regs<kAcc>(acc);
    if constexpr (S::kB == 2) fence_regs<kAcc>(acc_g);
    mbar_arrive(empty((c - 1) % kStages));
    const int m0 = w.m0, n0 = w.n0;

    // Accumulator layout (per warp, 16 rows): acc[4 j + 2 h + c] is row
    // lane / 4 + 8 h, column 8 j + 2 (lane % 4) + c.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 16 * warp + (lane >> 2) + 8 * h;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        if (col >= n) continue;   // n % 8 == 0, so col + 1 < n as well
        float y0 = acc[4 * j + 2 * h], y1 = acc[4 * j + 2 * h + 1];
        if constexpr (kMode == kPartial) {
          float* part =
              static_cast<float*>(out) + (static_cast<size_t>(w.z) * m + row) * n + col;
          *reinterpret_cast<float2*>(part) = make_float2(y0, y1);
        } else {
          const float2 b =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
          float2 y = round2_bf16(round2_bf16(make_float2(y0, y1)) + b);
          if constexpr (kMode != kBias) {
            y = round2_bf16(make_float2(gelu_exact(y.x), gelu_exact(y.y)));
          }
          if constexpr (kMode == kGeluGated) {
            const float2 bg =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gate_bias + col));
            const float2 gate = round2_bf16(
                round2_bf16(make_float2(acc_g[4 * j + 2 * h], acc_g[4 * j + 2 * h + 1])) + bg);
            y = make_float2(y.x * gate.x, y.y * gate.y);
          }
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) +
                                             static_cast<size_t>(row) * n + col) =
              __floats2bfloat162_rn(y.x, y.y);
        }
      }
    }
  }
}

// out (m, n) = round(round(sum_z part[z]) + bias) in bf16, or with kSum the
// fp32 sum_z part[z] itself, the splits z added in order 0..splits-1 in
// fp32; four columns per thread.
template <bool kSum>
__global__ void __launch_bounds__(kReduceThreads) ffn_split_reduce_kernel(
    const float* __restrict__ part, const bf16* __restrict__ bias, void* __restrict__ out, int m,
    int n, int splits) {
  const size_t total = static_cast<size_t>(m) * n;
  const size_t idx = (static_cast<size_t>(blockIdx.x) * kReduceThreads + threadIdx.x) * 4;
  if (idx >= total) return;
  float4 s = *reinterpret_cast<const float4*>(part + idx);
  for (int z = 1; z < splits; ++z) {
    const float4 p = *reinterpret_cast<const float4*>(part + z * total + idx);
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  if constexpr (kSum) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + idx) = s;
    return;
  }
  const int col = static_cast<int>(idx % n);   // n % 8 == 0: the four share a row
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(bias + col);
  const float2 lo = __bfloat1622float2(b2[0]), hi = __bfloat1622float2(b2[1]);
  __nv_bfloat162 y[2] = {
      __floats2bfloat162_rn(round_bf16(s.x) + lo.x, round_bf16(s.y) + lo.y),
      __floats2bfloat162_rn(round_bf16(s.z) + hi.x, round_bf16(s.w) + hi.y)};
  *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + idx) = *reinterpret_cast<const uint2*>(y);
}

template <int kMode, int kBN, int kGroups>
cudaError_t launch_tile(int splits, const CUtensorMap& a, const CUtensorMap& b,
                        const CUtensorMap& g, const void* bias, const void* gate_bias, void* out,
                        int m, int n, int k_tiles, int sms, cudaStream_t s) {
  constexpr size_t smem = Smem<kMode, kBN>::kBytes;
  constexpr int block = kGroups * kConsumers + 32;   // + the producer warp
  auto kernel = ffn_gemm_kernel<kMode, kBN, kGroups>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // One wave of persistent blocks: as many as fit on the card (the blocks
  // an SM holds are the kernel's own property), at most one per kGroups
  // units.
  static const int per_sm = [&] {
    int blocks = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, block, smem) ==
                   cudaSuccess && blocks > 0
               ? blocks
               : 1;
  }();
  const long long units = static_cast<long long>((n + kBN - 1) / kBN) * ((m + kBM - 1) / kBM) *
                          splits;
  const long long wanted = (units + kGroups - 1) / kGroups;
  const long long fit = static_cast<long long>(sms) * per_sm;
  kernel<<<static_cast<int>(wanted < fit ? wanted : fit), block, smem, s>>>(
      a, b, g, static_cast<const bf16*>(bias), static_cast<const bf16*>(gate_bias), out, m, n,
      k_tiles, splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mmt

extern "C" {

// x (m, d); w1, wg (f, d); w2 (d, f); biases (f,) / (d,), all bf16 and
// 16-byte aligned; hidden (m, f) bf16 scratch for the activation; out (m,
// d) bf16, or with `partial` the (m, d) fp32 down product without b2 (b2
// may then be null). wg and bg are null when ungated. The plan (ops/decode_ffn.py
// ffn_plan): up_groups (1, or 2 for ping-pong) consumer warpgroups per
// block of the up GEMM (64-wide tiles), down_tile_n (64 or 128) columns per
// tile of the down GEMM, and `splits` splits of F (1 <= splits <= ceil(f /
// 64)); with more than one, workspace holds (splits, m, d) fp32 partials.
// sms: the device's SMs. Two launches, three with splits > 1. Returns the
// first non-zero cudaError_t (0 on success).
int mmt_geglu_ffn(const void* x, const void* w1, const void* b1, const void* wg,
                  const void* bg, const void* w2, const void* b2, void* hidden, void* workspace,
                  void* out, int m, int d, int f, int up_groups, int down_tile_n, int splits,
                  int partial, int sms, void* stream) {
  using namespace mmt;
  const int d_tiles = (d + kBK - 1) / kBK, f_tiles = (f + kBK - 1) / kBK;
  if (m < 1 || d < 8 || f < 8 || d % 8 != 0 || f % 8 != 0 || splits < 1 || splits > f_tiles ||
      (splits > 1 && workspace == nullptr) || m > 65535 * kBM || up_groups < 1 ||
      up_groups > 2 || (down_tile_n != 64 && down_tile_n != 128) || sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool gated = wg != nullptr;
  CUtensorMap x_map, w1_map, wg_map, h_map, w2_map;
  if (!make_map_2d(&x_map, x, d, m) || !make_map_2d(&w1_map, w1, d, f) ||
      (gated && !make_map_2d(&wg_map, wg, d, f)) || !make_map_2d(&h_map, hidden, f, m) ||
      !make_map_2d(&w2_map, w2, f, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto up = gated ? (up_groups == 2 ? launch_tile<kGeluGated, 64, 2>
                                          : launch_tile<kGeluGated, 64, 1>)
                        : (up_groups == 2 ? launch_tile<kGelu, 64, 2> : launch_tile<kGelu, 64, 1>);
  cudaError_t err = up(1, x_map, w1_map, gated ? wg_map : w1_map, b1, bg, hidden, m, f, d_tiles,
                       sms, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto partial_down =
      down_tile_n == 64 ? launch_tile<kPartial, 64, 1> : launch_tile<kPartial, 128, 1>;
  if (splits == 1) {
    // one split: the down GEMM's epilogue writes the result (partial: its
    // fp32 tile, as split 0 of one)
    const auto down = down_tile_n == 64 ? launch_tile<kBias, 64, 1> : launch_tile<kBias, 128, 1>;
    return static_cast<int>((partial ? partial_down : down)(1, h_map, w2_map, w2_map, b2, nullptr,
                                                            out, m, d, f_tiles, sms, s));
  }
  err = partial_down(splits, h_map, w2_map, w2_map, nullptr, nullptr, workspace, m, d, f_tiles,
                     sms, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t quads = static_cast<size_t>(m) * d / 4;
  const unsigned blocks = static_cast<unsigned>((quads + kReduceThreads - 1) / kReduceThreads);
  const auto reduce = partial ? ffn_split_reduce_kernel<true> : ffn_split_reduce_kernel<false>;
  reduce<<<blocks, kReduceThreads, 0, s>>>(static_cast<const float*>(workspace),
                                           static_cast<const bf16*>(b2), out, m, d, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
