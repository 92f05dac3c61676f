// Tensor-core and async-copy helpers shared by the kernels of rnnt_joint.cu,
// flash_attention_fwd.cu, flash_attention_bwd.cu, flash_attention_f32.cu's
// backward and (the copies only) rnnt_lattice.cu: cp.async into shared
// memory, ldmatrix fragments and mma.sync m16n8k16 bf16 (or fp16) with fp32
// accumulation, and mma.sync m16n8k8 tf32 in 3xTF32 for fp32 operands.
//
// Fragment layouts (PTX ISA, mma.m16n8k16, lane l, g = l / 4, c = 2 * (l % 4)):
//   A [16 x 16]: a[0] = (row g, k c..c+1), a[1] = (row g+8, k c..c+1),
//                a[2] = (row g, k c+8..c+9), a[3] = (row g+8, k c+8..c+9)
//   B [16 x 8]:  b0 = (k c..c+1, col g), b1 = (k c+8..c+9, col g)
//   C [16 x 8]:  c[0..1] = (row g, cols c..c+1), c[2..3] = (row g+8, cols c..c+1)
// so two neighbouring C tiles of a row block, rounded to bf16 in pairs, are
// the A fragment of a 16-deep product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stddef.h>
#include <stdint.h>

namespace tc {

__device__ inline uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ inline void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(s)), "l"(g));
}
__device__ inline void cp_async4(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(s)), "l"(g));
}
// 4 bytes from g where `c`, else 4 zero bytes; g must be a valid address
// either way (no byte of it is read when c is false)
__device__ inline void cp_async4_zfill(void* s, const void* g, bool c) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(s)), "l"(g),
               "r"(c ? 4 : 0)
               : "memory");
}
__device__ inline void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ inline void ldsm4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ inline void ldsm4t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ inline void ldsm2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}
__device__ inline void ldsm2t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}
__device__ inline void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mbarriers and bulk copies (the Tensor Memory Accelerator's 1D form): a
// bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from global to shared memory reports its bytes to the mbarrier `bar`,
// whose phase completes once its arrivals and the bytes it expects are in.
__device__ inline void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ inline void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// order this thread's earlier generic-proxy shared-memory writes before
// later bulk copies into the same memory
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ inline void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// wait until the phase of parity `parity` of `bar` has completed
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
__device__ inline void bulk_g2s(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a 2D tensor copy (the Tensor Memory Accelerator): the box at (column c0,
// row r0) of the tensor map `tmap` (a __grid_constant__ kernel parameter)
// into shared memory at dst, its bytes reported to the mbarrier `bar`
__device__ inline void tma_load_2d(void* dst, const void* tmap, int c0, int r0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(tmap), "r"(c0), "r"(r0), "r"(smem_u32(bar))
      : "memory");
}

// Element (r, c) of a [rows x 64] bf16 box a tensor copy wrote with the
// 128-byte swizzle: the 16-byte chunk c / 8 of row r sits at chunk
// (c / 8) ^ (r % 8), so the 8 rows an ldmatrix reads at one column hit 8
// distinct bank groups. The box must start 1024-byte aligned.
__device__ inline const __nv_bfloat16* swz128(const __nv_bfloat16* box, int r, int c) {
  return box + r * 64 + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

// Fragment addresses for lane l (ldmatrix x4: lanes 8i..8i+7 give matrix i's
// rows; x2 reads lanes 0..15, so pass l & 15).
// A [16 x 16] from row-major [m][k] storage (no transpose)
__device__ inline const __nv_bfloat16* a_addr(const __nv_bfloat16* s, int ld, int m0, int k0,
                                              int l) {
  return s + (size_t)(m0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + k0 + (l >> 4) * 8;
}
// A [16 x 16] from [k][m] storage (.trans)
__device__ inline const __nv_bfloat16* at_addr(const __nv_bfloat16* s, int ld, int m0, int k0,
                                               int l) {
  return s + (size_t)(k0 + (l & 7) + (l >> 4) * 8) * ld + m0 + ((l >> 3) & 1) * 8;
}
// B of two n-tiles [16 x 8] from row-major [k][n] storage (.trans)
__device__ inline const __nv_bfloat16* bt_addr(const __nv_bfloat16* s, int ld, int k0, int n0,
                                               int l) {
  return s + (size_t)(k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 + (l >> 4) * 8;
}
// B of two n-tiles from [n][k] storage (no transpose)
__device__ inline const __nv_bfloat16* bn_addr(const __nv_bfloat16* s, int ld, int k0, int n0,
                                               int l) {
  return s + (size_t)(n0 + (l & 7) + (l >> 4) * 8) * ld + k0 + ((l >> 3) & 1) * 8;
}

// Two floats rounded to bf16, packed low-first (a fragment register).
__device__ inline uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The same product and rounding for a 16-bit element type chosen at compile
// time: bf16 (F16 false) or fp16 (F16 true). ldmatrix and the copies move
// 16-bit elements whatever they mean, so a kernel written for bf16 takes
// fp16 through these two alone.
__device__ inline void mma16816_f16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <bool F16>
__device__ inline void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  if constexpr (F16)
    mma16816_f16(c, a, b0, b1);
  else
    mma16816(c, a, b0, b1);
}
template <bool F16>
__device__ inline uint32_t pack(float lo, float hi) {
  if constexpr (F16) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack2(lo, hi);
  }
}

// 3xTF32 (for fp32 operands on the tensor cores): x = hi + lo with hi =
// tf32(x) and lo = tf32(x - hi) (the subtraction is exact), so hi + lo keeps
// 22 of x's 24 mantissa bits; a product a b is taken as a_lo b_hi + a_hi b_lo
// + a_hi b_hi, dropping a_lo b_lo (about 2^-22 of |a b|).
__device__ inline uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ inline void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
// mma.sync m16n8k8 tf32 with fp32 accumulation. Fragments (lane l, g = l / 4,
// t = l % 4): A [16 x 8]: a[0] = (row g, k t), a[1] = (g + 8, t), a[2] = (g,
// t + 4), a[3] = (g + 8, t + 4); B [8 x 8]: b0 = (k t, col g), b1 = (k t + 4,
// col g); C as for m16n8k16.
__device__ inline void mma1688(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d = a b (no accumulator read)
__device__ inline void mma1688_zero(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}
// d = a b in 3xTF32: the two small products first, then hi x hi
__device__ inline void mma1688_3x(float* d, const uint32_t* a_hi, const uint32_t* a_lo,
                                  uint32_t b0_hi, uint32_t b1_hi, uint32_t b0_lo,
                                  uint32_t b1_lo) {
  mma1688_zero(d, a_lo, b0_hi, b1_hi);
  mma1688(d, a_hi, b0_lo, b1_lo);
  mma1688(d, a_hi, b0_hi, b1_hi);
}

}  // namespace tc
