// Constants and helpers shared by the flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu, flash_attention_f32.cu's
// backward).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;
constexpr size_t SMEM_BLOCK = 232448;  // bytes of shared memory one block may use

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// Key j is visible to query i under the (left, right) band (-1 = unlimited).
__device__ inline bool in_band(int i, int j, int left, int right) {
  return (left < 0 || i - j <= left) && (right < 0 || j - i <= right);
}

// A 2D tensor map over a row-major [rows x cols] tensor for tensor copies of
// boxes of box_rows rows of 128 bytes (64 16-bit or 32 fp32 elements) with
// the 128-byte swizzle, zeros past the tensor's edges (host code; the CUDA
// driver API's encoder, found through the runtime). A copy moves bits, so
// the default bf16 type serves fp16 too; fp32 names its own type.
inline bool tensor_map(CUtensorMap* map, const void* base, int cols, long long rows,
                       int box_rows,
                       CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const cuuint32_t elem = dtype == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return false;
    }
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {128 / elem, (cuuint32_t)box_rows}, step[2] = {1, 1};
  return encode(map, dtype, 2, const_cast<void*>(base), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace flash
