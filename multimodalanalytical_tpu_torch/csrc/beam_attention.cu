// Beam-decode attention kernels for Hopper (sm_90a): lazy-ancestry
// self-attention, with the in-place KV-cache append (update mode) or over a
// cache that already holds this step's rows (read-only mode), and beam
// cross-attention against the beam-invariant encoder K/V.
//
// Replaces multimodalanalytical_tpu/ops/beam_attention.py
// beam_select_attention_update (Pallas _kernel_upd / _kernel_upd_q8),
// beam_select_attention (Pallas _kernel / _kernel_q8; the same kernel
// instantiated with kUpdate = false) and beam_cross_attention (Pallas
// _cross_kernel). They replace this file's first kernels, which ran one
// warp per beam over its keys: two passes per beam (the second recomputed
// every logit and read the key rows again), a value loop that broadcast one
// key at a time, and every selected row read once per beam that selects it.
//
// Select attention is bound by bytes on the H100: a decode step reads the
// ancestor rows of every beam from the slot-flattened cache and does ~2
// flops per byte, far below the ~295 flop/byte where the tensor cores would
// become the limit. The least it can move is each *distinct* selected row
// once, and that is what block (b, h) reads: it builds a bitmask of the
// slots that some beam's ancestry names at each time, numbers those rows
// (prefix sums of the masks), and stages exactly them, head slice and int8
// scale, compacted, into shared memory with cp.async, a chunk of times per
// tile, through a 2-stage ring: one tile loads while the previous one
// computes. The K rows of all chunks stream first, then the V rows; the
// first V tile loads while the softmax runs. Every logit is computed once,
// from shared memory, one (beam, time) pair per thread (eight partial sums
// per dot), into a K x (pos + 1) fp32 buffer; the exact softmax per beam
// row follows (max, sum, normalise); each V tile first tabulates its (beam,
// time) weights (the probability times the value row's int8 scale, rounded
// to bf16) and row offsets, then threads owning 8 output channels of a beam
// (and a share of the times when there are fewer such groups than threads)
// accumulate in fp32. The prologue (queries, ancestry and this step's fresh
// rows) is one round of asynchronous copies. int8 rows become floats by a
// byte permute and a subtraction (common.cuh load8), not the quarter-rate
// conversion unit.
//
// In update mode the block also appends head h's slice of this step's K/V
// rows at flat rows pos * K + n, in place: no other block touches (b, h),
// so the append has no race. With an int8 cache it takes the fresh rows
// un-quantized (bf16, or fp32 in fp32 models) and quantizes them itself
// with quantize_kv_heads' arithmetic: fp32 absmax per (row, head),
// clamp_min 1e-8, IEEE division by 127, rint(x / scale) clamped to +-127
// (the build has no --use_fast_math, so '/' is the IEEE division). Those
// rows are read from shared memory, never from the cache being written.
//
// The step index `pos` is read from device memory at the kernel's start, as
// the Pallas kernel takes it by scalar prefetch, so that one captured CUDA
// graph of a decode step serves every step of a stage: the launcher sizes
// the shared-memory plan and the grid from the stage length L (the
// ancestry slice's time axis), never from pos, and the kernel bounds every
// per-time loop, mask and table by pos + 1 inside that plan. The tile of
// times is min(pos + 1, the plan's), as a plan sized for pos + 1 would
// take, so results at each pos are those of a launch planned for it. A pos
// outside [0, L) writes NaN to the block's output and nothing else.
//
// The kernel takes any stage length up to 65536 (time, slot) rows (its
// staged-row tables are 16-bit). The per-time tables (slot masks, prefix
// sums, K x L logits, row tables) grow with the stage: at the decode
// shapes (L 128) they sit in shared memory; when they would take the plan
// past 227 KB (K 30, Dh 64 beyond ~520 times) they move to a global
// workspace that the caller allocates (mmt_beam_select_workspace_bytes
// says how large; the wrapper takes a torch.empty, so a captured graph
// holds no allocation of its own), and the ancestry is read in place. What
// then stays in shared memory depends on K and head_dim only, and fits for
// every K x head_dim <= 8192 (ops/beam_attention.py beam_kernel_supports).
// The launcher raises the kernel's shared-memory limit at the first launch
// of a plan (cudaFuncSetAttribute, not a stream operation); a decode step
// is run eagerly once per stage before its graph is captured, which does
// that before capture.
//
// What is left: on the card the kernel is limited by its instruction
// stream, not by bytes (its time hardly changes when every beam shares one
// slot and the rows to read fall tenfold): per cached element the FMA path
// spends a load share, two instructions of conversion (int8) and one FMA,
// twice (logits, values). The dense per-time K x K products would fit
// mma.sync but waste K-fold work on slots a beam does not read. The
// register budget follows the plan: 3 blocks per SM where shared memory
// allows (K 10), else 2 (K 30).
//
// Cross attention is small (per block K x Ls x Dh) and bound by latency:
// block (b, h) stages q (K x Dh) and a chunk of the encoder's K/V rows with
// 16-byte cp.async copies, all in flight together; for bf16 it computes
// S = Q K^T and P V on the tensor cores (mma.sync m16n8k16, K padded to 16
// rows, keys to 16, head_dim to 16), S goes through shared memory for the
// exact fp32 softmax with the additive bias, and P is rounded to bf16
// before P V, as the plain version does. fp32 (fp32 models, tests) runs the
// same staged structure on the FMA pipes. Ls up to 256 keys (Ls 26 for the
// flagship) is one chunk: one load of q, K, V and the bias, the logits kept
// in shared memory, one pass. Longer encoders (an RLE source runs to 4090
// tokens) take the two-pass form in chunks of 256 keys (fewer when shared
// memory is short): first the running max and sum per beam, then S again,
// P and P V.
//
// The TPU kernel's block-diagonal head packing, 64-row aligned append
// window and lane-padded scale operands exist for the TPU's matrix unit and
// Mosaic's tiling; none of them carries over.

#include "common.cuh"

namespace mmt {
namespace {

constexpr int kSelectThreads = 256;
constexpr size_t kSmemPerSm = 233472;   // 228 KB of shared memory per SM
constexpr int kStages = 2;
constexpr int kStageBytes = 24 * 1024;
constexpr int kRowPad = 16;
constexpr int kCrossThreads = 256;
constexpr int kCrossMaxChunk = 256;
constexpr int kMaxHeadDim = 256;
constexpr size_t kMaxSmem = 232448;   // 227 KB of dynamic shared memory per block
constexpr size_t kDefaultSmem = 48 * 1024;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory plan of the select kernel for up to `steps` attended times
// (the stage length). The per-time tables (slot masks, prefix sums, the K x
// steps logits, the staged-row tables) grow with the stage; when they would
// take the plan past kMaxSmem they `spill` to a global workspace of
// `workspace` bytes per block (the ancestry is then read in place), and
// what stays in shared memory depends on K and head_dim only.
struct SelectLayout {
  int row_bytes;    // head slice of one cache row
  int row_stride;   // staged row pitch: row_bytes + kRowPad
  int times;        // times per tile
  int stage_bytes;  // one ring stage: up to times * K rows (+ their int8 scales)
  int words;        // 32-bit words of one time's slot mask
  int split;        // share of the times per value-pass thread group
  bool spill;       // the per-time tables are in the workspace
  // The first region holds the prologue's raw copies (bf16 queries, fresh
  // rows, int32 ancestry) and the slot masks, and then the ring.
  size_t off_anc_raw;
  size_t off_fresh, off_fresh_scale, off_q, off_acc, off_tile;
  // Offsets of the per-time tables: in shared memory, or in the workspace.
  size_t off_sel, off_logit, off_idx, off_src, off_prefix;
  size_t total, workspace;
};

__host__ __device__ inline SelectLayout select_layout(int beams, int head_dim, int steps,
                                                      int elt, int new_elt, bool quantized,
                                                      bool update, bool spill) {
  SelectLayout l;
  l.row_bytes = head_dim * elt;
  l.row_stride = l.row_bytes + kRowPad;
  // As many times per tile as give every thread at most one (beam, time)
  // pair, as far as kStageBytes of staged rows allow.
  const int per_time = beams * (l.row_stride + (quantized ? 4 : 0));
  l.times = imax(1, imin(imin(steps, kSelectThreads / beams), kStageBytes / per_time));
  const int rows = l.times * beams;
  l.stage_bytes = static_cast<int>(align16(static_cast<size_t>(rows) * l.row_stride +
                                           (quantized ? rows * 4 : 0)));
  l.words = (beams + 31) / 32;
  l.split = imax(1, kSelectThreads / (beams * (head_dim / 8)));
  l.spill = spill;
  size_t ws = 0;
  size_t raw = align16(static_cast<size_t>(beams) * head_dim * 2) +
               (update ? align16(2 * static_cast<size_t>(beams) * head_dim * new_elt) : 0);
  l.off_anc_raw = raw;
  size_t& sel = spill ? ws : raw;
  if (!spill) raw += align16(static_cast<size_t>(beams) * steps * 4);
  l.off_sel = sel;
  sel += align16(static_cast<size_t>(steps) * l.words * 4);
  const size_t ring = static_cast<size_t>(kStages) * l.stage_bytes;
  size_t off = align16(ring > raw ? ring : raw);
  l.off_fresh = off;
  off += update ? align16(2 * static_cast<size_t>(beams) * l.row_stride) : 0;
  l.off_fresh_scale = off;
  off += update && quantized ? align16(2 * static_cast<size_t>(beams) * 4) : 0;
  l.off_q = off;
  off += align16(static_cast<size_t>(beams) * head_dim * 4);
  l.off_acc = off;
  off += align16(static_cast<size_t>(l.split) * beams * head_dim * 4);
  l.off_tile = off;
  off += align16(static_cast<size_t>(l.times) * beams * 8);
  size_t& tab = spill ? ws : off;
  l.off_logit = tab;
  tab += align16(static_cast<size_t>(beams) * steps * 4);
  l.off_idx = tab;
  tab += align16(static_cast<size_t>(beams) * steps * 2);
  l.off_src = tab;
  tab += align16(static_cast<size_t>(beams) * steps * 2);
  l.off_prefix = tab;
  tab += align16((static_cast<size_t>(steps) + 1) * 4);
  l.total = off;
  l.workspace = ws;
  return l;
}

// Shared-memory plan of the cross kernel for one chunk of keys.
struct CrossLayout {
  int m_pad, dk, q_stride, k_stride, v_stride, s_stride, p_stride;
  size_t off_k, off_v, off_bias, off_s, off_p, off_o, off_stat, total;
};

__host__ __device__ inline CrossLayout cross_layout(int beams, int head_dim, int chunk, int elt) {
  CrossLayout l;
  l.m_pad = round_up(beams, 16);
  l.dk = round_up(head_dim, 16);
  l.q_stride = l.dk + 8;
  l.k_stride = l.dk + 8;
  l.v_stride = head_dim + 8;
  l.s_stride = chunk + 4;
  l.p_stride = chunk + 8;
  size_t off = align16(static_cast<size_t>(l.m_pad) * l.q_stride * elt);
  l.off_k = off;
  off += align16(static_cast<size_t>(chunk) * l.k_stride * elt);
  l.off_v = off;
  off += align16(static_cast<size_t>(chunk) * l.v_stride * elt);
  l.off_bias = off;
  off += align16(static_cast<size_t>(chunk) * 4);
  l.off_s = off;
  off += align16(static_cast<size_t>(l.m_pad) * l.s_stride * 4);
  l.off_p = off;
  off += align16(static_cast<size_t>(l.m_pad) * l.p_stride * elt);
  l.off_o = off;
  off += align16(static_cast<size_t>(l.m_pad) * head_dim * 4);
  l.off_stat = off;
  off += align16(static_cast<size_t>(l.m_pad) * 2 * 4);
  l.total = off;
  return l;
}

// ---------------------------------------------------------------- copies
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(kBytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// `bytes` (a multiple of 8) from global to shared memory in 16-byte copies,
// or 8-byte ones where `bytes` is not a multiple of 16 (int8 rows of a
// head_dim that is not a multiple of 16); `part` picks this thread's piece.
__device__ __forceinline__ void cp_async_piece(unsigned char* dst, const unsigned char* src,
                                               int wide, int part) {
  if (wide) {
    cp_async<16>(dst + 16 * part, src + 16 * part);
  } else {
    cp_async<8>(dst + 8 * part, src + 8 * part);
  }
}

// fp32 dot of a query (fp32, shared memory, 32-byte aligned) with a staged
// row: eight partial sums (one per element of each 8-element piece), so
// that the FMAs do not wait on one another, added pairwise at the end.
template <typename T>
__device__ __forceinline__ float staged_dot(const float* q, const T* row, int head_dim) {
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int d = 0; d < head_dim; d += 8) {
    float k[8];
    load8(row + d, k);
    const float4 a = *reinterpret_cast<const float4*>(q + d);
    const float4 b = *reinterpret_cast<const float4*>(q + d + 4);
    acc[0] = fmaf(a.x, k[0], acc[0]);
    acc[1] = fmaf(a.y, k[1], acc[1]);
    acc[2] = fmaf(a.z, k[2], acc[2]);
    acc[3] = fmaf(a.w, k[3], acc[3]);
    acc[4] = fmaf(b.x, k[4], acc[4]);
    acc[5] = fmaf(b.y, k[5], acc[5]);
    acc[6] = fmaf(b.z, k[6], acc[6]);
    acc[7] = fmaf(b.w, k[7], acc[7]);
  }
  return ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
}

// ------------------------------------------------------- select attention
// Grid (heads, batch), kSelectThreads threads. T: the cache type (int8 or
// bf16); TNew: the fresh rows' type (update mode; bf16, or fp32 for an int8
// cache in an fp32 model).
// kBlocks: the blocks per SM the registers are budgeted for (the launcher
// picks 3 where the shared-memory plan lets 3 blocks share an SM, else 2).
// `spill`: the per-time tables of every block are in `workspace`
// (select_layout's `workspace` bytes each). `pos_ptr`: the step index in
// device memory; `length`: the stage length the plan is sized for.
template <typename T, typename TNew, bool kUpdate, int kBlocks>
__global__ void __launch_bounds__(kSelectThreads, kBlocks) select_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const TNew* __restrict__ k_new,
    const TNew* __restrict__ v_new, T* cache, float* scales, const int* __restrict__ ancestry,
    __nv_bfloat16* __restrict__ out, unsigned char* workspace, int batch, int beams, int heads,
    int head_dim, int flat, int flat_pad, int anc_row_stride, const int* __restrict__ pos_ptr,
    int length, bool spill, float scale) {
  constexpr bool kQuantized = std::is_same<T, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int pos = *pos_ptr;
  const int steps = pos + 1;
  const int d_model = heads * head_dim;
  const size_t row0 = static_cast<size_t>(b) * beams;
  const size_t head_off = static_cast<size_t>(h) * head_dim;
  if (pos < 0 || pos >= length) {
    const __nv_bfloat16 nan = __float2bfloat16_rn(__int_as_float(0x7fc00000));
    for (int i = tid; i < beams * head_dim; i += nthreads) {
      out[(row0 + i / head_dim) * d_model + head_off + i % head_dim] = nan;
    }
    return;
  }
  const SelectLayout lay = select_layout(beams, head_dim, length, sizeof(T), sizeof(TNew),
                                         kQuantized, kUpdate, spill);
  const size_t plane = static_cast<size_t>(batch) * flat * d_model;  // K -> V plane, elements
  T* kv = cache + static_cast<size_t>(b) * flat * d_model + head_off;
  const size_t scale_plane = static_cast<size_t>(batch) * heads * flat_pad;
  float* sc = kQuantized ? scales + (static_cast<size_t>(b) * heads + h) * flat_pad : nullptr;
  const int words = lay.words;
  unsigned char* tables =
      lay.spill ? workspace + (static_cast<size_t>(b) * heads + h) * lay.workspace : smem;

  auto* q_raw = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* new_raw = reinterpret_cast<TNew*>(
      smem + align16(static_cast<size_t>(beams) * head_dim * 2));
  // Beam n's ancestry row: staged at (K, steps), or read in place.
  const int* anc = lay.spill ? ancestry + row0 * anc_row_stride
                             : reinterpret_cast<const int*>(smem + lay.off_anc_raw);
  const int anc_stride = lay.spill ? anc_row_stride : steps;
  uint32_t* sel_s = reinterpret_cast<uint32_t*>(tables + lay.off_sel);   // (steps, words)
  int* prefix = reinterpret_cast<int*>(tables + lay.off_prefix);          // (steps + 1)
  unsigned char* fresh = smem + lay.off_fresh;                          // (2, K) staged rows
  float* fresh_scale = reinterpret_cast<float*>(smem + lay.off_fresh_scale);  // (2, K)
  float* q_s = reinterpret_cast<float*>(smem + lay.off_q);              // (K, Dh)
  float* acc_s = reinterpret_cast<float*>(smem + lay.off_acc);          // (split, K, Dh)
  float* tile_w = reinterpret_cast<float*>(smem + lay.off_tile);         // (K, T) weights
  int* tile_off = reinterpret_cast<int*>(tile_w + lay.times * beams);    // (K, T) row offsets
  float* logit_s = reinterpret_cast<float*>(tables + lay.off_logit);    // (K, steps)
  uint16_t* idx_s = reinterpret_cast<uint16_t*>(tables + lay.off_idx);  // (K, steps)
  uint16_t* src_s = reinterpret_cast<uint16_t*>(tables + lay.off_src);  // staged row -> t*K+s

  // 1. Prologue: one round of asynchronous copies of the bf16 queries, the
  // fresh rows and (unless spilled) the ancestry rows.
  {
    const int q_pieces = head_dim / 8;  // 16 bytes of bf16 each
    for (int i = tid; i < beams * q_pieces; i += nthreads) {
      const int n = i / q_pieces;
      const int c = i - n * q_pieces;
      cp_async<16>(q_raw + n * head_dim + 8 * c, q + (row0 + n) * d_model + head_off + 8 * c);
    }
    if constexpr (kUpdate) {
      constexpr int kPer = 16 / sizeof(TNew);
      const int pieces = head_dim / kPer;
      for (int i = tid; i < 2 * beams * pieces; i += nthreads) {
        const int r = i / pieces;  // p * beams + n
        const int c = i - r * pieces;
        const int n = r < beams ? r : r - beams;
        const TNew* src = (r < beams ? k_new : v_new) + (row0 + n) * d_model + head_off + kPer * c;
        cp_async<16>(new_raw + r * head_dim + kPer * c, src);
      }
    }
    for (int i = tid; !lay.spill && i < beams * steps; i += nthreads) {
      const int n = i / steps;
      cp_async<4>(smem + lay.off_anc_raw + 4 * i,
                  ancestry + (row0 + n) * anc_row_stride + (i - n * steps));
    }
    cp_async_commit();
  }
  for (int i = tid; i < steps * words; i += nthreads) sel_s[i] = 0u;
  for (int i = tid; i < lay.split * beams * head_dim; i += nthreads) acc_s[i] = 0.f;
  cp_async_wait<0>();
  __syncthreads();

  // 2. Queries; the slot mask of every time (in update mode time pos is
  // each beam's own fresh row, never staged from the cache).
  for (int i = tid; i < beams * head_dim; i += nthreads) {
    q_s[i] = round_bf16(__bfloat162float(q_raw[i]) * scale);
  }
  for (int i = tid; i < beams * steps; i += nthreads) {
    const int n = i / steps;
    const int t = i - n * steps;
    if (kUpdate && t == pos) continue;
    const int s = anc[n * anc_stride + t];
    atomicOr(&sel_s[t * words + (s >> 5)], 1u << (s & 31));
  }
  if constexpr (kUpdate) {
    if constexpr (kQuantized) {
      // One thread per (plane, beam) row: fp32 absmax (each thread starts at
      // its own column, so the row reads spread over the banks), then the
      // scale, as quantize_kv_heads computes it.
      for (int r = tid; r < 2 * beams; r += nthreads) {
        const TNew* x = new_raw + r * head_dim;
        float amax = 0.f;
        for (int e = 0, d = r % head_dim; e < head_dim; ++e, d = d + 1 == head_dim ? 0 : d + 1) {
          amax = fmaxf(amax, fabsf(to_f32(x[d])));
        }
        const float s = fmaxf(amax, 1e-8f) / 127.0f;
        fresh_scale[r] = s;
        sc[(r < beams ? 0 : scale_plane) + pos * beams + (r < beams ? r : r - beams)] = s;
      }
      __syncthreads();
      for (int i = tid; i < 2 * beams * head_dim; i += nthreads) {
        const int r = i / head_dim;  // p * beams + n
        const int d = i - r * head_dim;
        const int n = r < beams ? r : r - beams;
        const float qv = fminf(fmaxf(rintf(to_f32(new_raw[i]) / fresh_scale[r]), -127.f), 127.f);
        const int8_t v = static_cast<int8_t>(qv);
        reinterpret_cast<int8_t*>(fresh + r * lay.row_stride)[d] = v;
        kv[(r < beams ? 0 : plane) + static_cast<size_t>(pos * beams + n) * d_model + d] = v;
      }
    } else {
      for (int i = tid; i < 2 * beams * head_dim; i += nthreads) {
        const int r = i / head_dim;
        const int d = i - r * head_dim;
        const int n = r < beams ? r : r - beams;
        const T v = new_raw[i];
        reinterpret_cast<T*>(fresh + r * lay.row_stride)[d] = v;
        kv[(r < beams ? 0 : plane) + static_cast<size_t>(pos * beams + n) * d_model + d] = v;
      }
    }
  }
  __syncthreads();

  // 3. Exclusive prefix sums of the selected slots per time (warp 0), then
  // every selected (time, slot) its place among the staged rows, and every
  // (beam, time) the staged row it reads.
  if (tid < 32) {
    int carry = 0;
    for (int t0 = 0; t0 < steps; t0 += 32) {
      const int t = t0 + lane;
      int count = 0;
      if (t < steps) {
        for (int w = 0; w < words; ++w) count += __popc(sel_s[t * words + w]);
      }
      int incl = count;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFullMask, incl, o);
        if (lane >= o) incl += v;
      }
      if (t < steps) prefix[t] = carry + incl - count;
      carry += __shfl_sync(kFullMask, incl, 31);
    }
    if (lane == 0) prefix[steps] = carry;
  }
  __syncthreads();
  auto rank = [&](int t, int s) -> int {
    int r = prefix[t];
    for (int w = 0; w < (s >> 5); ++w) r += __popc(sel_s[t * words + w]);
    return r + __popc(sel_s[t * words + (s >> 5)] & ((1u << (s & 31)) - 1u));
  };
  for (int i = tid; i < beams * steps; i += nthreads) {
    const int t = i / beams;
    const int s = i - t * beams;
    if ((sel_s[t * words + (s >> 5)] >> (s & 31)) & 1u) src_s[rank(t, s)] = static_cast<uint16_t>(i);
  }
  for (int i = tid; i < beams * steps; i += nthreads) {
    const int n = i / steps;
    const int t = i - n * steps;
    if (!(kUpdate && t == pos)) idx_s[i] = static_cast<uint16_t>(rank(t, anc[n * anc_stride + t]));
  }
  __syncthreads();   // the first region becomes the ring below

  // 4. The tiles: K rows of times [c * T, c * T + T) for c < C, then V rows;
  // tile c stages the selected rows prefix[c * T] .. prefix[c * T + T) - 1.
  const int per = imin(steps, lay.times);
  const int chunks = (steps + per - 1) / per;
  const int n_tiles = 2 * chunks;
  const int wide = lay.row_bytes % 16 == 0;
  const int pieces = lay.row_bytes / (wide ? 16 : 8);
  const int row_step = nthreads / pieces;  // rows staged per pass
  const int my_piece = tid % pieces;
  const int my_row = tid < row_step * pieces ? tid / pieces : -1;
  const int scale_off = per * beams * lay.row_stride;

  auto issue = [&](int j) {
    if (j < n_tiles) {
      const int p = j < chunks ? 0 : 1;
      const int c = j - p * chunks;
      const int first = prefix[c * per];
      const int rows = prefix[imin(steps, c * per + per)] - first;
      unsigned char* st = smem + static_cast<size_t>(j % kStages) * lay.stage_bytes;
      const T* src = kv + p * plane;
      for (int r = my_row; r >= 0 && r < rows; r += row_step) {
        cp_async_piece(st + r * lay.row_stride,
                       reinterpret_cast<const unsigned char*>(
                           src + static_cast<size_t>(src_s[first + r]) * d_model),
                       wide, my_piece);
      }
      if constexpr (kQuantized) {
        float* st_scale = reinterpret_cast<float*>(st + scale_off);
        for (int r = tid; r < rows; r += nthreads) {
          cp_async<4>(st_scale + r, sc + p * scale_plane + src_s[first + r]);
        }
      }
    }
    cp_async_commit();
  };

  for (int j = 0; j < kStages - 1; ++j) issue(j);
  const int groups = head_dim / 8;
  const int items = beams * groups;
  for (int j = 0; j < n_tiles; ++j) {
    issue(j + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int p = j < chunks ? 0 : 1;
    const int t0 = (j - p * chunks) * per;
    const int nt = imin(per, steps - t0);
    const int first = prefix[t0];
    const unsigned char* st = smem + static_cast<size_t>(j % kStages) * lay.stage_bytes;
    const float* st_scale = reinterpret_cast<const float*>(st + scale_off);
    const unsigned char* fresh_p = fresh + p * beams * lay.row_stride;
    const float* fresh_scale_p = fresh_scale + p * beams;
    if (p == 0) {
      for (int i = tid; i < beams * nt; i += nthreads) {
        const int n = i / nt;
        const int t = t0 + (i - n * nt);
        const bool own = kUpdate && t == pos;
        const int r = own ? 0 : idx_s[n * steps + t] - first;
        const T* row = reinterpret_cast<const T*>(own ? fresh_p + n * lay.row_stride
                                                      : st + r * lay.row_stride);
        const float dot = staged_dot(q_s + n * head_dim, row, head_dim);
        logit_s[n * steps + t] =
            kQuantized ? dot * (own ? fresh_scale_p[n] : st_scale[r]) : dot;
      }
    } else {
      // This tile's (beam, time) pairs: the probability times the value
      // row's int8 scale, rounded to bf16, and the staged row it weighs.
      for (int i = tid; i < beams * nt; i += nthreads) {
        const int n = i / nt;
        const int t = t0 + (i - n * nt);
        const bool own = kUpdate && t == pos;
        const int r = own ? 0 : idx_s[n * steps + t] - first;
        float wgt = logit_s[n * steps + t];
        if (kQuantized) wgt *= own ? fresh_scale_p[n] : st_scale[r];
        tile_w[i] = round_bf16(wgt);
        tile_off[i] = static_cast<int>((own ? fresh_p + n * lay.row_stride
                                            : st + r * lay.row_stride) - smem);
      }
      __syncthreads();
      for (int w = tid; w < items * lay.split; w += nthreads) {
        const int ts = w / items;
        const int it = w - ts * items;
        const int n = it / groups;
        const int g = it - n * groups;
        float* acc = acc_s + (static_cast<size_t>(ts) * beams + n) * head_dim + 8 * g;
        const float* wn = tile_w + n * nt;
        const int* offn = tile_off + n * nt;
        float a[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) a[e] = acc[e];
#pragma unroll 4
        for (int tl = ts; tl < nt; tl += lay.split) {
          float v[8];
          load8(reinterpret_cast<const T*>(smem + offn[tl]) + 8 * g, v);
          const float wgt = wn[tl];
#pragma unroll
          for (int e = 0; e < 8; ++e) a[e] = fmaf(wgt, v[e], a[e]);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = a[e];
      }
    }
    __syncthreads();
    if (j == chunks - 1) {
      // Exact softmax per beam, in place: the normalised probabilities.
      for (int n = tid >> 5; n < beams; n += nthreads >> 5) {
        float* l = logit_s + n * steps;
        float m = -INFINITY;
        for (int t = lane; t < steps; t += 32) m = fmaxf(m, l[t]);
        m = warp_max(m);
        float sum = 0.f;
        for (int t = lane; t < steps; t += 32) sum += expf(l[t] - m);
        sum = warp_sum(sum);
        for (int t = lane; t < steps; t += 32) l[t] = expf(l[t] - m) / sum;
      }
      __syncthreads();
    }
  }
  cp_async_wait<0>();

  for (int i = tid; i < beams * head_dim; i += nthreads) {
    const int n = i / head_dim;
    const int d = i - n * head_dim;
    float o = 0.f;
    for (int ts = 0; ts < lay.split; ++ts) o += acc_s[static_cast<size_t>(ts) * beams * head_dim + i];
    out[(row0 + n) * d_model + head_off + d] = __float2bfloat16_rn(o);
  }
}

// ------------------------------------------------------- cross attention
__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// S[m][j] = q_s[m] . k_s[j] + bias[j] for the chunk's nk keys (-inf past
// them), m over the padded beams.
template <typename T>
__device__ __forceinline__ void cross_logits(const CrossLayout& l, const T* q_s, const T* k_s,
                                             const float* bias_s, float* s_s, int beams,
                                             int head_dim, int nk, int nk_pad) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, gc = lane & 3;
    const int mt = l.m_pad / 16, ntl = nk_pad / 8;
    for (int tile = warp; tile < mt * ntl; tile += blockDim.x >> 5) {
      const int m0 = (tile / ntl) * 16, n0 = (tile % ntl) * 8;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kk = 0; kk < l.dk; kk += 16) {
        const T* qa = q_s + (m0 + gr) * l.q_stride + kk + 2 * gc;
        const T* kb = k_s + (n0 + gr) * l.k_stride + kk + 2 * gc;
        mma_bf16(c, ld_pair(qa), ld_pair(qa + 8 * l.q_stride), ld_pair(qa + 8),
                 ld_pair(qa + 8 * l.q_stride + 8), ld_pair(kb), ld_pair(kb + 8));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + gr + (e >= 2 ? 8 : 0);
        const int j = n0 + 2 * gc + (e & 1);
        s_s[m * l.s_stride + j] = j < nk ? c[e] + bias_s[j] : -INFINITY;
      }
    }
  } else {
    for (int i = tid; i < beams * nk_pad; i += blockDim.x) {
      const int m = i / nk_pad, j = i - m * nk_pad;
      float acc = 0.f;
      if (j < nk) {
        for (int d = 0; d < head_dim; ++d) {
          acc = fmaf(to_f32(q_s[m * l.q_stride + d]), to_f32(k_s[j * l.k_stride + d]), acc);
        }
      }
      s_s[m * l.s_stride + j] = j < nk ? acc + bias_s[j] : -INFINITY;
    }
  }
}

// o_s[m][d] += P[m] . V[:, d] over the chunk's keys.
template <typename T>
__device__ __forceinline__ void cross_values(const CrossLayout& l, const T* p_s, const T* v_s,
                                             float* o_s, int beams, int head_dim, int nk,
                                             int nk_pad) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, gc = lane & 3;
    const int mt = l.m_pad / 16, ntl = head_dim / 8;
    for (int tile = warp; tile < mt * ntl; tile += blockDim.x >> 5) {
      const int m0 = (tile / ntl) * 16, n0 = (tile % ntl) * 8;
      float c[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c[e] = o_s[(m0 + gr + (e >= 2 ? 8 : 0)) * head_dim + n0 + 2 * gc + (e & 1)];
      }
      for (int kk = 0; kk < nk_pad; kk += 16) {
        const T* pa = p_s + (m0 + gr) * l.p_stride + kk + 2 * gc;
        const T* vb = v_s + (kk + 2 * gc) * l.v_stride + n0 + gr;
        mma_bf16(c, ld_pair(pa), ld_pair(pa + 8 * l.p_stride), ld_pair(pa + 8),
                 ld_pair(pa + 8 * l.p_stride + 8), pack_pair(vb[0], vb[l.v_stride]),
                 pack_pair(vb[8 * l.v_stride], vb[9 * l.v_stride]));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o_s[(m0 + gr + (e >= 2 ? 8 : 0)) * head_dim + n0 + 2 * gc + (e & 1)] = c[e];
      }
    }
  } else {
    for (int i = tid; i < beams * head_dim; i += blockDim.x) {
      const int m = i / head_dim, d = i - m * head_dim;
      float acc = o_s[i];
      for (int j = 0; j < nk; ++j) {
        acc = fmaf(to_f32(p_s[m * l.p_stride + j]), to_f32(v_s[j * l.v_stride + d]), acc);
      }
      o_s[i] = acc;
    }
  }
}

// Grid (heads, batch), kCrossThreads threads; `chunk` keys per pass (a
// multiple of 16), one pass when ls <= chunk.
template <typename T>
__global__ void __launch_bounds__(kCrossThreads) cross_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out, int beams, int heads, int head_dim,
    int ls, int chunk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const CrossLayout l = cross_layout(beams, head_dim, chunk, sizeof(T));
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = reinterpret_cast<T*>(smem + l.off_k);
  T* v_s = reinterpret_cast<T*>(smem + l.off_v);
  float* bias_s = reinterpret_cast<float*>(smem + l.off_bias);
  float* s_s = reinterpret_cast<float*>(smem + l.off_s);
  T* p_s = reinterpret_cast<T*>(smem + l.off_p);
  float* o_s = reinterpret_cast<float*>(smem + l.off_o);
  float* m_s = reinterpret_cast<float*>(smem + l.off_stat);
  float* l_s = m_s + l.m_pad;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = nthreads >> 5;
  const int d_model = heads * head_dim;
  const size_t head_off = static_cast<size_t>(h) * head_dim;
  const size_t row0 = static_cast<size_t>(b) * beams;
  constexpr int kPer = 16 / sizeof(T);
  const int pieces = head_dim / kPer;
  const int n_chunks = (ls + chunk - 1) / chunk;
  const bool one_pass = n_chunks == 1;
  const T zero = from_f32<T>(0.f);

  // Stage the keys [c * chunk, ...) (and their values) and the bias, all
  // copies in flight together; rows past the chunk's keys and columns past
  // head_dim are zero (a warp per row, lanes over columns).
  auto stage = [&](int c, bool with_v) {
    const int j0 = c * chunk;
    const int nk = imin(chunk, ls - j0);
    const T* ksrc = k + (static_cast<size_t>(b) * ls + j0) * d_model + head_off;
    const T* vsrc = v + (static_cast<size_t>(b) * ls + j0) * d_model + head_off;
    for (int i = tid; i < nk * pieces; i += nthreads) {
      const int j = i / pieces, e = (i - j * pieces) * kPer;
      cp_async<16>(k_s + j * l.k_stride + e, ksrc + static_cast<size_t>(j) * d_model + e);
      if (with_v) cp_async<16>(v_s + j * l.v_stride + e, vsrc + static_cast<size_t>(j) * d_model + e);
    }
    for (int j = tid; j < nk; j += nthreads) cp_async<4>(bias_s + j, bias + static_cast<size_t>(b) * ls + j0 + j);
    cp_async_commit();
    const int nk_pad = round_up(nk, 16);
    for (int j = warp; j < nk_pad; j += nwarps) {
      for (int d = (j < nk ? head_dim : 0) + lane; d < l.dk; d += 32) k_s[j * l.k_stride + d] = zero;
      if (with_v && j >= nk) {
        for (int d = lane; d < head_dim; d += 32) v_s[j * l.v_stride + d] = zero;
      }
    }
    return nk;
  };

  // q rows (scaled and rounded below), their pad, the first chunk.
  for (int i = tid; i < beams * pieces; i += nthreads) {
    const int n = i / pieces, e = (i - n * pieces) * kPer;
    cp_async<16>(q_s + n * l.q_stride + e, q + (row0 + n) * d_model + head_off + e);
  }
  for (int m = warp; m < l.m_pad; m += nwarps) {
    for (int d = (m < beams ? head_dim : 0) + lane; d < l.dk; d += 32) q_s[m * l.q_stride + d] = zero;
    for (int d = lane; d < head_dim; d += 32) o_s[m * head_dim + d] = 0.f;
    if (lane == 0) {
      m_s[m] = -INFINITY;
      l_s[m] = 0.f;
    }
  }
  int nk = stage(0, one_pass);
  cp_async_wait<0>();
  __syncthreads();
  for (int m = warp; m < beams; m += nwarps) {
    for (int d = lane; d < head_dim; d += 32) {
      T* x = q_s + m * l.q_stride + d;
      *x = from_f32<T>(to_f32(*x) * scale);
    }
  }
  __syncthreads();

  // Pass 1: the running max and sum of every beam's row (with one chunk,
  // also its probabilities, rounded to T).
  for (int c = 0; c < n_chunks; ++c) {
    if (c > 0) {
      nk = stage(c, false);
      cp_async_wait<0>();
      __syncthreads();
    }
    const int nk_pad = round_up(nk, 16);
    cross_logits(l, q_s, k_s, bias_s, s_s, beams, head_dim, nk, nk_pad);
    __syncthreads();
    for (int m = warp; m < l.m_pad; m += nwarps) {
      const float* s = s_s + m * l.s_stride;
      T* pr = p_s + m * l.p_stride;
      if (m >= beams) {
        for (int j = lane; j < nk_pad; j += 32) pr[j] = zero;
        continue;
      }
      float mx = -INFINITY;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, s[j]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m_s[m], mx);
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) sum += expf(s[j] - m_new);
      sum = warp_sum(sum);
      if (one_pass) {
        for (int j = lane; j < nk_pad; j += 32) {
          pr[j] = from_f32<T>(j < nk ? expf(s[j] - m_new) / sum : 0.f);
        }
      } else if (lane == 0) {
        l_s[m] = (m_s[m] == -INFINITY ? 0.f : l_s[m] * expf(m_s[m] - m_new)) + sum;
        m_s[m] = m_new;
      }
    }
    __syncthreads();
  }
  // Pass 2 (several chunks): S again, P = exp(S - max) / sum rounded to T;
  // then O += P V.
  for (int c = 0; c < n_chunks; ++c) {
    const int nk_pad = round_up(nk, 16);
    if (!one_pass) {
      nk = stage(c, true);
      cp_async_wait<0>();
      __syncthreads();
      const int nk_pad2 = round_up(nk, 16);
      cross_logits(l, q_s, k_s, bias_s, s_s, beams, head_dim, nk, nk_pad2);
      __syncthreads();
      for (int m = warp; m < l.m_pad; m += nwarps) {
        const float* s = s_s + m * l.s_stride;
        for (int j = lane; j < nk_pad2; j += 32) {
          p_s[m * l.p_stride + j] = from_f32<T>(
              m < beams && j < nk ? expf(s[j] - m_s[m]) / l_s[m] : 0.f);
        }
      }
      __syncthreads();
      cross_values(l, p_s, v_s, o_s, beams, head_dim, nk, nk_pad2);
    } else {
      cross_values(l, p_s, v_s, o_s, beams, head_dim, nk, nk_pad);
    }
    __syncthreads();
  }
  for (int m = warp; m < beams; m += nwarps) {
    T* o = out + (row0 + m) * d_model + head_off;
    for (int d = lane; d < head_dim; d += 32) o[d] = from_f32<T>(o_s[m * head_dim + d]);
  }
}

// Raise a kernel's dynamic shared-memory limit once it needs more than the
// default 48 KB (once per size it grows to, not per launch).
template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t bytes, size_t* reserved) {
  if (bytes <= kDefaultSmem || bytes <= *reserved) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) *reserved = bytes;
  return err;
}

// The select kernel's plan for a stage of `length` times: in shared memory,
// or with the per-time tables spilled when they do not fit.
template <typename T, typename TNew, bool kUpdate>
SelectLayout select_plan(int beams, int head_dim, int length) {
  constexpr bool kQuantized = std::is_same<T, int8_t>::value;
  const SelectLayout lay = select_layout(beams, head_dim, length, sizeof(T), sizeof(TNew),
                                         kQuantized, kUpdate, false);
  if (lay.total <= kMaxSmem) return lay;
  return select_layout(beams, head_dim, length, sizeof(T), sizeof(TNew), kQuantized, kUpdate,
                       true);
}

bool select_shape_ok(int beams, int head_dim, int length) {
  // The staged-row tables are 16-bit: at most 65536 (time, slot) rows.
  return head_dim <= kMaxHeadDim && head_dim % 8 == 0 && beams >= 1 && beams <= 256 &&
         length >= 1 && static_cast<long long>(length) * beams <= 65536;
}

template <typename T, typename TNew, bool kUpdate>
int launch_select(const void* q, const void* k_new, const void* v_new, void* cache,
                  void* scales, const void* ancestry, void* out, void* workspace, int batch,
                  int beams, int heads, int head_dim, int flat, int flat_pad,
                  int anc_row_stride, const int* pos, int length, float scale, cudaStream_t s) {
  if (!select_shape_ok(beams, head_dim, length)) return static_cast<int>(cudaErrorInvalidValue);
  const SelectLayout lay = select_plan<T, TNew, kUpdate>(beams, head_dim, length);
  if (lay.total > kMaxSmem || (lay.spill && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool three = 3 * (lay.total + 1024) <= kSmemPerSm;   // 1 KB reserved per block
  auto kernel = three ? select_attention_kernel<T, TNew, kUpdate, 3>
                      : select_attention_kernel<T, TNew, kUpdate, 2>;
  static size_t reserved[2] = {0, 0};
  const cudaError_t err = reserve_smem(kernel, lay.total, &reserved[three]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(heads, batch), kSelectThreads, lay.total, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TNew*>(k_new),
      static_cast<const TNew*>(v_new), static_cast<T*>(cache), static_cast<float*>(scales),
      static_cast<const int*>(ancestry), static_cast<__nv_bfloat16*>(out),
      lay.spill ? static_cast<unsigned char*>(workspace) : nullptr, batch, beams, heads,
      head_dim, flat, flat_pad, anc_row_stride, pos, length, lay.spill, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cross(const void* q, const void* k, const void* v, const void* bias, void* out,
                 int batch, int beams, int heads, int head_dim, int ls, float scale,
                 cudaStream_t s) {
  if (head_dim > kMaxHeadDim || head_dim % 8 != 0 || ls < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int chunk = imin(round_up(ls, 16), kCrossMaxChunk);
  while (chunk > 16 && cross_layout(beams, head_dim, chunk, sizeof(T)).total > kMaxSmem) {
    chunk = round_up(chunk / 2, 16);
  }
  const size_t smem = cross_layout(beams, head_dim, chunk, sizeof(T)).total;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = cross_attention_kernel<T>;
  static size_t reserved = 0;
  const cudaError_t err = reserve_smem(kernel, smem, &reserved);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Half the threads where the beams fill one 16-row tile: the blocks of a
  // flagship-sized grid then fit on the card at once.
  const int threads = beams <= 16 ? kCrossThreads / 2 : kCrossThreads;
  kernel<<<dim3(heads, batch), threads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), beams, heads, head_dim, ls, chunk,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mmt

extern "C" {

const char* mmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of global workspace a select launch needs for a stage of `length`
// times (0 when its per-time tables fit in shared memory): kind as
// mmt_beam_select_attention_update's, or 3 / 4 for the read-only mode on a
// bf16 / int8 cache; -1 for a shape the kernel does not take.
long long mmt_beam_select_workspace_bytes(int kind, int batch, int beams, int heads,
                                          int head_dim, int length) {
  using namespace mmt;
  if (!select_shape_ok(beams, head_dim, length)) return -1;
  SelectLayout lay;
  switch (kind) {
    case 0: lay = select_plan<__nv_bfloat16, __nv_bfloat16, true>(beams, head_dim, length); break;
    case 1: lay = select_plan<int8_t, __nv_bfloat16, true>(beams, head_dim, length); break;
    case 2: lay = select_plan<int8_t, float, true>(beams, head_dim, length); break;
    case 3: lay = select_plan<__nv_bfloat16, __nv_bfloat16, false>(beams, head_dim, length); break;
    case 4: lay = select_plan<int8_t, __nv_bfloat16, false>(beams, head_dim, length); break;
    default: return -1;
  }
  if (lay.total > kMaxSmem) return -1;
  return lay.spill ? static_cast<long long>(lay.workspace) * batch * heads : 0;
}

// kind: 0 bf16 cache and bf16 fresh rows; 1 int8 cache, bf16 fresh rows;
// 2 int8 cache, fp32 fresh rows (quantized in the kernel). `pos` points to
// the step index (one int32 in device memory), `length` is the stage's
// time axis, `workspace` holds mmt_beam_select_workspace_bytes bytes (or
// is null when that is 0). Returns the cudaError_t of the launch (0 on
// success).
int mmt_beam_select_attention_update(int kind, const void* q, const void* k_new,
                                     const void* v_new, void* cache, void* scales,
                                     const void* ancestry, void* out, void* workspace,
                                     int batch, int beams, int heads, int head_dim, int flat,
                                     int flat_pad, int anc_row_stride, const int* pos,
                                     int length, float scale, void* stream) {
  using namespace mmt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return launch_select<__nv_bfloat16, __nv_bfloat16, true>(
          q, k_new, v_new, cache, nullptr, ancestry, out, workspace, batch, beams, heads,
          head_dim, flat, flat_pad, anc_row_stride, pos, length, scale, s);
    case 1:
      return launch_select<int8_t, __nv_bfloat16, true>(
          q, k_new, v_new, cache, scales, ancestry, out, workspace, batch, beams, heads,
          head_dim, flat, flat_pad, anc_row_stride, pos, length, scale, s);
    case 2:
      return launch_select<int8_t, float, true>(
          q, k_new, v_new, cache, scales, ancestry, out, workspace, batch, beams, heads,
          head_dim, flat, flat_pad, anc_row_stride, pos, length, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Read-only mode: q (batch * beams, D) bf16 rows, the cache already holds
// the time-pos rows; the other arguments as the update's. Returns the
// cudaError_t of the launch (0 on success).
int mmt_beam_select_attention(int quantized, const void* q, const void* cache,
                              const void* scales, const void* ancestry, void* out,
                              void* workspace, int batch, int beams, int heads, int head_dim,
                              int flat, int flat_pad, int anc_row_stride, const int* pos,
                              int length, float scale, void* stream) {
  using namespace mmt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantized) {
    return launch_select<int8_t, __nv_bfloat16, false>(
        q, nullptr, nullptr, const_cast<void*>(cache), const_cast<void*>(scales), ancestry, out,
        workspace, batch, beams, heads, head_dim, flat, flat_pad, anc_row_stride, pos, length,
        scale, s);
  }
  return launch_select<__nv_bfloat16, __nv_bfloat16, false>(
      q, nullptr, nullptr, const_cast<void*>(cache), nullptr, ancestry, out, workspace, batch,
      beams, heads, head_dim, flat, flat_pad, anc_row_stride, pos, length, scale, s);
}

// is_bf16: 1 for bf16 q/k/v/out, 0 for float32.
int mmt_beam_cross_attention(int is_bf16, const void* q, const void* k, const void* v,
                             const void* bias, void* out, int batch, int beams, int heads,
                             int head_dim, int ls, float scale, void* stream) {
  using namespace mmt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_cross<__nv_bfloat16>(q, k, v, bias, out, batch, beams, heads, head_dim, ls,
                                       scale, s);
  }
  return launch_cross<float>(q, k, v, bias, out, batch, beams, heads, head_dim, ls, scale, s);
}

}  // extern "C"
