// Shared-memory staging used by the flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu).
#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 64;          // rows of a query or key tile
constexpr int DC = 64;            // depth chunk of Qs Ks^T
constexpr int NTHREADS = 128;     // 4 warps, 16 rows of a tile each
constexpr int LDQK = DC + 8;      // bf16 row stride of the Qs / Ks chunks
constexpr int LDS = TILE + 4;     // fp32 row stride of a score tile
constexpr int LDP = TILE + 8;     // bf16 row stride of a probability tile
constexpr float NEG_INF = -1e30f;

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// Copy rows row0..row0+63, columns col0..col0+width-1 of a row-major
// [nrows x ld_src] bf16 matrix into shared memory, zero outside
// [nrows x ncols]. width and ncols are multiples of 8: 16-byte vectors.
__device__ inline void load_tile(bf16* dst, int ld_dst, const bf16* __restrict__ src, int ld_src,
                                 int row0, int nrows, int col0, int ncols, int width) {
  const int vec_per_row = width / 8;
  for (int idx = threadIdx.x; idx < TILE * vec_per_row; idx += NTHREADS) {
    const int r = idx / vec_per_row;
    const int c = (idx % vec_per_row) * 8;
    const int gr = row0 + r, gc = col0 + c;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < nrows && gc < ncols)
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * ld_src + gc);
    *reinterpret_cast<uint4*>(dst + r * ld_dst + c) = val;
  }
}

// Key j is visible to query i under the (left, right) band (-1 = unlimited).
__device__ inline bool in_band(int i, int j, int left, int right) {
  return (left < 0 || i - j <= left) && (right < 0 || j - i <= right);
}

}  // namespace flash
