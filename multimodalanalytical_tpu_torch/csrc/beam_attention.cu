// Beam-decode attention kernels for Hopper (sm_90a): lazy-ancestry
// self-attention, with the in-place KV-cache append (update mode) or over a
// cache that already holds this step's rows (read-only mode), and beam
// cross-attention against the beam-invariant encoder K/V.
//
// Replaces multimodalanalytical_tpu/ops/beam_attention.py
// beam_select_attention_update (Pallas _kernel_upd / _kernel_upd_q8),
// beam_select_attention (Pallas _kernel / _kernel_q8; the same kernel
// instantiated with kUpdate = false) and beam_cross_attention (Pallas
// _cross_kernel).
//
// Bound on the H100: bytes. A decode step reads, per layer, the ancestor
// rows of every beam from the slot-flattened cache (at most the written
// prefix, pos * K rows of d_model per batch row, int8 or bf16) and does
// ~2 flops per byte read, far below the ~295 flop/byte where the tensor
// cores would become the limit. The design therefore spends no effort on
// matrix units: one block per (batch row, head) reads each attended row
// once per beam into registers (one lane per key, one 16-byte load per 8
// elements), and a beam's rows repeat across beams only where the beams
// share ancestors, which L1 absorbs. The softmax runs in two passes over
// the keys (max and sum, then normalised probabilities) so that each
// probability is rounded to bf16 after normalisation, as the reference
// does, without holding the logits in shared memory.
//
// The TPU kernel's block-diagonal head packing, 64-row aligned append
// window and lane-padded scale operands exist for the TPU's matrix unit and
// Mosaic's tiling; none of them carries over.

#include "common.cuh"

namespace mmt {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHeadDim = 256;
constexpr int kAccPerLane = kMaxHeadDim / 32;

// Attention of one query over `n_keys` keys, for the calling warp. Lane j
// owns keys j, j + 32, ...; the value pass broadcasts each key's
// probability and row pointer to the whole warp, whose lanes own output
// channels lane, lane + 32, ... Returns the fp32 sums in `acc`.
template <typename Src>
__device__ __forceinline__ void attend(const Src& src, int n_keys, int lane,
                                       float acc[kAccPerLane]) {
  using T = typename Src::Value;
  float m = -INFINITY;
  float s = 0.f;
  for (int l0 = 0; l0 < n_keys; l0 += 32) {
    const int l = l0 + lane;
    const float logit = l < n_keys ? src.logit(l) : -INFINITY;
    const float m_new = fmaxf(m, warp_max(logit));
    const float e = l < n_keys ? expf(logit - m_new) : 0.f;
    s = s * expf(m - m_new) + warp_sum(e);
    m = m_new;
  }
#pragma unroll
  for (int i = 0; i < kAccPerLane; ++i) acc[i] = 0.f;
  for (int l0 = 0; l0 < n_keys; l0 += 32) {
    const int l = l0 + lane;
    float p = 0.f;
    const T* row = src.value_row(0);
    if (l < n_keys) {
      p = src.round_prob(expf(src.logit(l) - m) / s * src.value_scale(l));
      row = src.value_row(l);
    }
    const int count = min(32, n_keys - l0);
    for (int j = 0; j < count; ++j) {
      const float pj = __shfl_sync(kFullMask, p, j);
      const T* rj = reinterpret_cast<const T*>(__shfl_sync(
          kFullMask, reinterpret_cast<unsigned long long>(row), j));
#pragma unroll
      for (int i = 0; i < kAccPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < src.head_dim) acc[i] = fmaf(pj, to_f32(rj[d]), acc[i]);
      }
    }
  }
}

// Keys of beam n at step `pos`: time l reads the cache row of slot
// ancestry[l] (flat row l * K + slot), except that in update mode time pos
// reads this step's fresh row (its beam's own slot by construction). The
// read-only mode reads time pos through ancestry[pos] like every other.
template <typename T, bool kUpdate>
struct SelfSource {
  using Value = T;
  static constexpr bool kQuantized = std::is_same<T, int8_t>::value;
  const float* q;            // (head_dim) q * scale, rounded to bf16
  const T* k_cache;          // head slice of batch row b; flat row f at f * d_model
  const T* v_cache;
  const T* k_fresh;          // head slice of this beam's fresh rows
  const T* v_fresh;
  const float* k_scales;     // (flat_pad) dequant scales of (b, h); int8 only
  const float* v_scales;
  float k_fresh_scale;
  float v_fresh_scale;
  const int* anc;            // this beam's ancestry row
  int beams, pos, d_model, head_dim;

  __device__ __forceinline__ int slot(int l) const { return l * beams + anc[l]; }
  __device__ __forceinline__ float logit(int l) const {
    if (kUpdate && l == pos) {
      const float qk = row_dot(q, k_fresh, head_dim);
      return kQuantized ? qk * k_fresh_scale : qk;
    }
    const int f = slot(l);
    const float qk = row_dot(q, k_cache + static_cast<size_t>(f) * d_model, head_dim);
    return kQuantized ? qk * k_scales[f] : qk;
  }
  __device__ __forceinline__ const T* value_row(int l) const {
    return kUpdate && l == pos ? v_fresh : v_cache + static_cast<size_t>(slot(l)) * d_model;
  }
  __device__ __forceinline__ float value_scale(int l) const {
    if (!kQuantized) return 1.f;
    return kUpdate && l == pos ? v_fresh_scale : v_scales[slot(l)];
  }
  __device__ __forceinline__ float round_prob(float p) const { return round_bf16(p); }
};

template <typename T>
struct CrossSource {
  using Value = T;
  const float* q;        // (head_dim) q * scale, rounded to T
  const T* k;            // head slice of batch row b; key l at l * d_model
  const T* v;
  const float* bias;     // (Ls) additive padding bias of batch row b
  int d_model, head_dim;

  __device__ __forceinline__ float logit(int l) const {
    return row_dot(q, k + static_cast<size_t>(l) * d_model, head_dim) + bias[l];
  }
  __device__ __forceinline__ const T* value_row(int l) const {
    return v + static_cast<size_t>(l) * d_model;
  }
  __device__ __forceinline__ float value_scale(int) const { return 1.f; }
  __device__ __forceinline__ float round_prob(float p) const { return round_to<T>(p); }
};

// Grid (heads, batch). In update mode block (b, h) first appends head h's
// slice of the K fresh rows (and their scales) at flat rows pos * K + n, in
// place: no other block touches (b, h), so the append has no race. It then
// attends every beam over l <= pos, one warp per beam. The read-only mode
// takes no fresh operands and writes nothing but `out`.
template <typename T, bool kUpdate>
__global__ void __launch_bounds__(kThreads) select_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, const float* __restrict__ k_new_scale,
    const float* __restrict__ v_new_scale, T* cache, float* scales,
    const int* __restrict__ ancestry, __nv_bfloat16* __restrict__ out, int batch,
    int beams, int heads, int head_dim, int flat, int flat_pad, int anc_row_stride,
    int pos, float scale) {
  constexpr bool kQuantized = std::is_same<T, int8_t>::value;
  extern __shared__ float q_s[];  // (beams, head_dim)
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d_model = heads * head_dim;
  const size_t row0 = static_cast<size_t>(b) * beams;
  T* k_cache = cache + static_cast<size_t>(b) * flat * d_model + static_cast<size_t>(h) * head_dim;
  T* v_cache = k_cache + static_cast<size_t>(batch) * flat * d_model;

  for (int i = threadIdx.x; i < beams * head_dim; i += blockDim.x) {
    const int n = i / head_dim;
    const int d = i - n * head_dim;
    const size_t src = (row0 + n) * d_model + static_cast<size_t>(h) * head_dim + d;
    if (kUpdate) {
      const size_t dst = static_cast<size_t>(pos * beams + n) * d_model + d;
      k_cache[dst] = k_new[src];
      v_cache[dst] = v_new[src];
    }
    q_s[i] = round_bf16(__bfloat162float(q[src]) * scale);
  }
  float* k_scales = nullptr;
  float* v_scales = nullptr;
  if (kQuantized) {
    k_scales = scales + (static_cast<size_t>(b) * heads + h) * flat_pad;
    v_scales = k_scales + static_cast<size_t>(batch) * heads * flat_pad;
    for (int n = threadIdx.x; kUpdate && n < beams; n += blockDim.x) {
      k_scales[pos * beams + n] = k_new_scale[(row0 + n) * heads + h];
      v_scales[pos * beams + n] = v_new_scale[(row0 + n) * heads + h];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int n = threadIdx.x >> 5; n < beams; n += blockDim.x >> 5) {
    const size_t row = (row0 + n) * d_model + static_cast<size_t>(h) * head_dim;
    SelfSource<T, kUpdate> src;
    src.q = q_s + n * head_dim;
    src.k_cache = k_cache;
    src.v_cache = v_cache;
    src.k_fresh = kUpdate ? k_new + row : nullptr;
    src.v_fresh = kUpdate ? v_new + row : nullptr;
    src.k_scales = k_scales;
    src.v_scales = v_scales;
    src.k_fresh_scale = kQuantized && kUpdate ? k_new_scale[(row0 + n) * heads + h] : 1.f;
    src.v_fresh_scale = kQuantized && kUpdate ? v_new_scale[(row0 + n) * heads + h] : 1.f;
    src.anc = ancestry + (row0 + n) * anc_row_stride;
    src.beams = beams;
    src.pos = pos;
    src.d_model = d_model;
    src.head_dim = head_dim;
    float acc[kAccPerLane];
    attend(src, pos + 1, lane, acc);
#pragma unroll
    for (int i = 0; i < kAccPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < head_dim) out[row + d] = __float2bfloat16_rn(acc[i]);
    }
  }
}

// Grid (heads, batch). Block (b, h) serves all K beams of batch row b from
// the same Ls x head_dim K/V slice, which stays in L1 after the first beam.
template <typename T>
__global__ void __launch_bounds__(kThreads) cross_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out, int beams, int heads,
    int head_dim, int ls, float scale) {
  extern __shared__ float q_s[];  // (beams, head_dim)
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d_model = heads * head_dim;
  const size_t row0 = static_cast<size_t>(b) * beams;
  for (int i = threadIdx.x; i < beams * head_dim; i += blockDim.x) {
    const int n = i / head_dim;
    const int d = i - n * head_dim;
    q_s[i] = round_to<T>(to_f32(q[(row0 + n) * d_model + static_cast<size_t>(h) * head_dim + d]) * scale);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const size_t kv0 = static_cast<size_t>(b) * ls * d_model + static_cast<size_t>(h) * head_dim;
  for (int n = threadIdx.x >> 5; n < beams; n += blockDim.x >> 5) {
    CrossSource<T> src;
    src.q = q_s + n * head_dim;
    src.k = k + kv0;
    src.v = v + kv0;
    src.bias = bias + static_cast<size_t>(b) * ls;
    src.d_model = d_model;
    src.head_dim = head_dim;
    float acc[kAccPerLane];
    attend(src, ls, lane, acc);
    T* o = out + (row0 + n) * d_model + static_cast<size_t>(h) * head_dim;
#pragma unroll
    for (int i = 0; i < kAccPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < head_dim) o[d] = from_f32<T>(acc[i]);
    }
  }
}

}  // namespace
}  // namespace mmt

extern "C" {

const char* mmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns the cudaError_t of the launch (0 on success).
int mmt_beam_select_attention_update(int quantized, const void* q, const void* k_new,
                                     const void* v_new, const void* k_new_scale,
                                     const void* v_new_scale, void* cache, void* scales,
                                     const void* ancestry, void* out, int batch, int beams,
                                     int heads, int head_dim, int flat, int flat_pad,
                                     int anc_row_stride, int pos, float scale, void* stream) {
  using namespace mmt;
  if (head_dim > kMaxHeadDim || head_dim % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(heads, batch);
  const size_t smem = static_cast<size_t>(beams) * head_dim * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* anc = static_cast<const int*>(ancestry);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (quantized) {
    select_attention_kernel<int8_t, true><<<grid, kThreads, smem, s>>>(
        qb, static_cast<const int8_t*>(k_new), static_cast<const int8_t*>(v_new),
        static_cast<const float*>(k_new_scale), static_cast<const float*>(v_new_scale),
        static_cast<int8_t*>(cache), static_cast<float*>(scales), anc, o, batch, beams, heads,
        head_dim, flat, flat_pad, anc_row_stride, pos, scale);
  } else {
    select_attention_kernel<__nv_bfloat16, true><<<grid, kThreads, smem, s>>>(
        qb, static_cast<const __nv_bfloat16*>(k_new), static_cast<const __nv_bfloat16*>(v_new),
        nullptr, nullptr, static_cast<__nv_bfloat16*>(cache), nullptr, anc, o, batch, beams,
        heads, head_dim, flat, flat_pad, anc_row_stride, pos, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// Read-only mode: q (batch * beams, D) bf16 rows, the cache already holds
// the time-pos rows. Returns the cudaError_t of the launch (0 on success).
int mmt_beam_select_attention(int quantized, const void* q, const void* cache,
                              const void* scales, const void* ancestry, void* out, int batch,
                              int beams, int heads, int head_dim, int flat, int flat_pad,
                              int anc_row_stride, int pos, float scale, void* stream) {
  using namespace mmt;
  if (head_dim > kMaxHeadDim || head_dim % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(heads, batch);
  const size_t smem = static_cast<size_t>(beams) * head_dim * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* anc = static_cast<const int*>(ancestry);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (quantized) {
    select_attention_kernel<int8_t, false><<<grid, kThreads, smem, s>>>(
        qb, nullptr, nullptr, nullptr, nullptr,
        static_cast<int8_t*>(const_cast<void*>(cache)),
        static_cast<float*>(const_cast<void*>(scales)), anc, o, batch, beams, heads, head_dim,
        flat, flat_pad, anc_row_stride, pos, scale);
  } else {
    select_attention_kernel<__nv_bfloat16, false><<<grid, kThreads, smem, s>>>(
        qb, nullptr, nullptr, nullptr, nullptr,
        static_cast<__nv_bfloat16*>(const_cast<void*>(cache)), nullptr, anc, o, batch, beams,
        heads, head_dim, flat, flat_pad, anc_row_stride, pos, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// is_bf16: 1 for bf16 q/k/v/out, 0 for float32.
int mmt_beam_cross_attention(int is_bf16, const void* q, const void* k, const void* v,
                             const void* bias, void* out, int batch, int beams, int heads,
                             int head_dim, int ls, float scale, void* stream) {
  using namespace mmt;
  if (head_dim > kMaxHeadDim || head_dim % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(heads, batch);
  const size_t smem = static_cast<size_t>(beams) * head_dim * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bias_f = static_cast<const float*>(bias);
  if (is_bf16) {
    cross_attention_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), bias_f, static_cast<__nv_bfloat16*>(out), beams,
        heads, head_dim, ls, scale);
  } else {
    cross_attention_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias_f, static_cast<float*>(out), beams, heads,
        head_dim, ls, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
