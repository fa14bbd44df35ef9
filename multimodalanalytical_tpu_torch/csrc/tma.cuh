// TMA loads, mbarriers and wgmma descriptors shared by the Hopper (sm_90a)
// kernels that stage bf16 tiles through a ring of 128-byte-swizzled shared
// memory: the flash attention kernels, the decode FFN GEMMs and the stream
// form of the beam cross attention.
//
// A tile row is 64 bf16 (128 bytes, one swizzle span). A TMA box is 64 x 64
// of a row-major (rows, cols) bf16 tensor, so a box lands as 64 such rows
// in 8 KB, and its start must be 1024-byte aligned for the swizzle.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mmt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One 64 x 64 box of a 2-D bf16 tensor map (columns from col, rows from
// row) into shared memory; rows or columns past the tensor read as zero.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// One 64-column box of a 3-D bf16 tensor map (columns from col, rows from
// row, of matrix `depth`) into shared memory; rows past the matrix's read
// as zero. The box's rows are the map's (make_map_3d).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int col, int row,
                                            int depth, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(depth), "r"(bar)
      : "memory");
}

// Shared-matrix descriptor, 128-byte swizzle: start address, leading and
// stride byte offsets.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_commit_and_wait() {
  wgmma_commit();
  wgmma_wait<0>();
}
// Keep the compiler from moving accumulator reads and writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// A row-major (rows, cols) bf16 tensor as 64 x 64 boxes, 128-byte swizzle.
// cols * 2 bytes must be a multiple of 16 and ptr 16-byte aligned.
inline bool make_map_2d(CUtensorMap* map, const void* ptr, int cols, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(__nv_bfloat16)};
  cuuint32_t box[2] = {64, 64};
  cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `depth` row-major (rows, cols) bf16 matrices, one after another, as
// 64 x box_rows boxes, 128-byte swizzle: a box never reads past its
// matrix's last row. cols * 2 bytes must be a multiple of 16 and ptr
// 16-byte aligned.
inline bool make_map_3d(CUtensorMap* map, const void* ptr, int cols, int rows, int depth,
                        int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(depth)};
  cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * sizeof(__nv_bfloat16),
                           static_cast<cuuint64_t>(rows) * cols * sizeof(__nv_bfloat16)};
  cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace mmt
