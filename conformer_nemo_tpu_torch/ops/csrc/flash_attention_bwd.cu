// Flash attention backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels `_make_dq_kernel` + `_make_dkv_kernel` (via
// `_flash_bwd_entry`) and their two-sided-band twins
// `_make_dq_streamed_kernel` + `_make_dkv_streamed_kernel` (via
// `_flash_bwd_streamed`) of conformer_nemo_tpu/ops/pallas/flash_attention.py.
// Given the forward's inputs, its per-row lse, dO and delta = rowsum(dO * O):
//
//     P_ij  = exp(qs_i . ks_j * scale - lse_i)      over visible (i, j)
//     dS_ij = P_ij * (dO_i . v_j - delta_i) * scale
//     dQ_i  = sum_j dS_ij ks_j,   dK_j = sum_i dS_ij qs_i,   dV_j = sum_i P_ij dO_i
//
// where (i, j) is visible iff i < lens and j < lens (a query row past the
// length gets dQ = 0 and adds nothing to dK/dV) and, with a band,
// i - j <= left and j - i <= right. The streamed TPU family only differs in
// how it moves the banded tiles through VMEM; here each kernel's tile loop
// is bounded by the band and the length, so one pair serves both.
//
// Bound on an H100: 2 * (visible pairs) * (3 * d1 + 2 * dv) FLOPs (S once
// recomputed, dQ and dK over d1; dP and dV over dv) at 989 TFLOP/s bf16
// dense, against reading qs, ks, v, dO, lse and delta once and writing dq,
// dk and dv once at 3.35 TB/s. At the Conformer's shapes (d1 = 576, dv =
// 64, T >= 1024) that is several hundred FLOPs per byte: the tensor cores
// bound it.
//
// Design (simple and right first; speed is later work):
//   * two kernels, no atomics, deterministic: a dQ kernel with one block of
//     4 warps per (bh, 64-query tile) looping over key tiles, and a dK/dV
//     kernel with one block per (bh, 64-key tile) looping over query tiles
//     (the band inverts: a key tile meets queries up to `right` before and
//     `left` after it, as in the TPU kernel's `_band_tile_bounds` call);
//   * both recompute S = Qs Ks^T with WMMA bf16 m16n16k16 and fp32
//     accumulation, staging 64-deep chunks of the d1-wide rows in shared
//     memory as the forward does; P and dS are formed in fp32 in registers
//     (warp w owns rows 16w..16w+15) and rounded to bf16 only as the A
//     operand of the next product;
//   * the d1-wide accumulator (dQ, or dK) stays in shared memory in fp32
//     for the whole loop (64 x 580 floats at d1 = 576) and is read back
//     through WMMA accumulator fragments, so nothing is reduced across
//     blocks; dV (64 x dv) likewise;
//   * the dK/dV kernel keeps its V tile in registers as WMMA A fragments.
// Shared memory at d1 = 576, dv = 64: 207 KB (dQ) and 216 KB (dK/dV), one
// block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "flash_tiles.cuh"

using namespace nvcuda;
using namespace flash;

namespace {

constexpr int MAX_DV_FRAGS = 8;  // dv <= 128

struct Layout {
  int d1p, dvp;  // d1 and dv rounded up to the WMMA width
  int ldv;       // bf16 row stride of the V / dO tiles
  int lda;       // fp32 row stride of the d1-wide accumulator
  int ldav;      // fp32 row stride of the dv-wide accumulator (dK/dV kernel)
  size_t q, k, v, dout, s, p, acc, accv, lse, delta, total;  // byte offsets
};

// dkv = false: the dQ kernel's layout; true: the dK/dV kernel's (its V tile
// is staged through the score buffer on its way to registers).
__host__ __device__ inline Layout make_layout(int d1, int dv, bool dkv) {
  Layout L;
  L.d1p = round16(d1);
  L.dvp = round16(dv);
  L.ldv = L.dvp + 8;
  L.lda = L.d1p + 4;
  L.ldav = L.dvp + 4;
  size_t off = 0;
  L.q = off; off = align128(off + sizeof(bf16) * TILE * LDQK);
  L.k = off; off = align128(off + sizeof(bf16) * TILE * LDQK);
  L.dout = off; off = align128(off + sizeof(bf16) * TILE * L.ldv);
  L.s = off; off = align128(off + sizeof(float) * TILE * LDS);
  L.p = off; off = align128(off + sizeof(bf16) * TILE * LDP);
  L.acc = off; off = align128(off + sizeof(float) * TILE * L.lda);
  L.v = L.accv = L.lse = L.delta = 0;
  if (dkv) {
    L.accv = off; off = align128(off + sizeof(float) * TILE * L.ldav);
    L.lse = off; off = align128(off + sizeof(float) * TILE);
    L.delta = off; off = align128(off + sizeof(float) * TILE);
  } else {
    L.v = off; off = align128(off + sizeof(bf16) * TILE * L.ldv);
  }
  L.total = off;
  return L;
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> RowA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> RowB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> ColB;

// acc[0..d1p) of rows 16w..16w+15 += A (16 x 64 bf16 at a_tile, stride LDP)
// @ B chunk (64 x 64 bf16 at b_chunk, stride LDQK), columns col0.. of acc.
__device__ inline void accumulate_chunk(float* acc, int lda, const bf16* a_tile,
                                        const bf16* b_chunk, int col0, int d1p, int warp) {
  const int nsteps = min(DC, d1p - col0) / 16;
  for (int n = 0; n < nsteps; ++n) {
    AccFrag o;
    float* o_tile = acc + (16 * warp) * lda + col0 + 16 * n;
    wmma::load_matrix_sync(o, o_tile, lda, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      RowA a;
      RowB b;
      wmma::load_matrix_sync(a, a_tile + (16 * warp) * LDP + kk * 16, LDP);
      wmma::load_matrix_sync(b, b_chunk + (kk * 16) * LDQK + 16 * n, LDQK);
      wmma::mma_sync(o, a, b, o);
    }
    wmma::store_matrix_sync(o_tile, o, lda, wmma::mem_row_major);
  }
}

// Write rows r of a fp32 [64 x ld] shared accumulator as bf16 rows of a
// [T x width] output, lane half `half` taking half of the columns.
__device__ inline void write_rows(bf16* out, const float* acc, int ld, int row, int r, int T,
                                  int width, int widthp, int half) {
  if (row >= T) return;
  const int hw = widthp / 2;
  const int c_end = min(width, (half + 1) * hw);
  bf16* dst = out + (size_t)row * width;
  for (int c = half * hw; c < c_end; ++c) dst[c] = __float2bfloat16(acc[r * ld + c]);
}

__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ ks,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ lens, bf16* __restrict__ dq,
                    int T, int d1, int dv, float scale, int left, int right) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(d1, dv, false);
  bf16* Qc = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Kc = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L.dout);
  float* S = reinterpret_cast<float*>(smem + L.s);
  bf16* P = reinterpret_cast<bf16*>(smem + L.p);
  float* A = reinterpret_cast<float*>(smem + L.acc);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int klim = min(max(lens[bh], 0), T);  // keys and queries < klim are valid
  const bf16* qs_bh = qs + (size_t)bh * T * d1;
  const bf16* ks_bh = ks + (size_t)bh * T * d1;
  const bf16* v_bh = v + (size_t)bh * T * dv;

  // key tiles that can hold a visible key (_band_tile_bounds, capped at the
  // length); none when every query row of the tile is past the length
  const int n_tiles = (T + TILE - 1) / TILE;
  int lo = 0, hi = n_tiles;
  if (left >= 0) lo = max(q0 - left, 0) / TILE;
  if (right >= 0) hi = min((q0 + TILE + right + TILE - 1) / TILE, n_tiles);
  hi = min(hi, (klim + TILE - 1) / TILE);
  if (q0 >= klim) hi = lo;

  // this lane's share of the row-wise work: row r, columns half*32 .. +31
  const int r = 16 * warp + (lane >> 1);
  const int half = lane & 1;
  const int qi = q0 + r;
  const bool q_ok = qi < klim;
  const float lse_r = qi < T ? lse[(size_t)bh * T + qi] : 0.f;
  const float delta_r = qi < T ? delta[(size_t)bh * T + qi] : 0.f;
  for (int idx = threadIdx.x; idx < TILE * L.lda; idx += NTHREADS) A[idx] = 0.f;
  load_tile(dOs, L.ldv, dout + (size_t)bh * T * dv, dv, q0, T, 0, dv, L.dvp);

  const int n_chunks = (d1 + DC - 1) / DC;
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * TILE;
    // S = Qs Ks^T for this warp's 16 query rows
    AccFrag acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();  // every warp is done with the previous chunk (and V tile)
      const int col0 = c * DC;
      load_tile(Qc, LDQK, qs_bh, d1, q0, T, col0, d1, DC);
      load_tile(Kc, LDQK, ks_bh, d1, k0, T, col0, d1, DC);
      if (c == 0) load_tile(Vs, L.ldv, v_bh, dv, k0, T, 0, dv, L.dvp);
      __syncthreads();
      const int ksteps = (min(DC, d1 - col0) + 15) / 16;
      for (int kk = 0; kk < ksteps; ++kk) {
        RowA a;
        wmma::load_matrix_sync(a, Qc + (16 * warp) * LDQK + kk * 16, LDQK);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ColB b;  // a Ks chunk stored [key][depth] is Ks^T in column-major order
          wmma::load_matrix_sync(b, Kc + (16 * j) * LDQK + kk * 16, LDQK);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(S + (16 * warp) * LDS + 16 * j, acc[j], LDS, wmma::mem_row_major);
    __syncwarp();

    // P in fp32 registers
    float p[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int kj = k0 + half * 32 + c;
      const bool ok = q_ok && kj < klim && in_band(qi, kj, left, right);
      p[c] = ok ? expf(S[r * LDS + half * 32 + c] * scale - lse_r) : 0.f;
    }
    __syncwarp();

    // dP = dO V^T into the score buffer
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      AccFrag t;
      wmma::fill_fragment(t, 0.f);
      for (int kk = 0; kk < L.dvp / 16; ++kk) {
        RowA a;
        ColB b;  // V stored [key][dv] is V^T in column-major order
        wmma::load_matrix_sync(a, dOs + (16 * warp) * L.ldv + kk * 16, L.ldv);
        wmma::load_matrix_sync(b, Vs + (16 * j) * L.ldv + kk * 16, L.ldv);
        wmma::mma_sync(t, a, b, t);
      }
      wmma::store_matrix_sync(S + (16 * warp) * LDS + 16 * j, t, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // dS = P (dP - delta) scale, rounded to bf16 as the next A operand
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float ds = p[c] * (S[r * LDS + half * 32 + c] - delta_r) * scale;
      P[r * LDP + half * 32 + c] = __float2bfloat16(ds);
    }
    __syncwarp();

    // dQ += dS Ks, chunk by chunk of the depth
    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();
      const int col0 = c * DC;
      load_tile(Kc, LDQK, ks_bh, d1, k0, T, col0, d1, DC);
      __syncthreads();
      accumulate_chunk(A, L.lda, P, Kc, col0, L.d1p, warp);
    }
  }

  __syncthreads();
  write_rows(dq + (size_t)bh * T * d1, A, L.lda, qi, r, T, d1, L.d1p, half);
}

__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ ks,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ lens, bf16* __restrict__ dk,
                     bf16* __restrict__ dvo, int T, int d1, int dv, float scale, int left,
                     int right) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(d1, dv, true);
  bf16* Qc = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Kc = reinterpret_cast<bf16*>(smem + L.k);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L.dout);
  float* S = reinterpret_cast<float*>(smem + L.s);
  bf16* P = reinterpret_cast<bf16*>(smem + L.p);
  float* A = reinterpret_cast<float*>(smem + L.acc);
  float* AV = reinterpret_cast<float*>(smem + L.accv);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int klim = min(max(lens[bh], 0), T);
  const bf16* qs_bh = qs + (size_t)bh * T * d1;
  const bf16* ks_bh = ks + (size_t)bh * T * d1;
  const bf16* do_bh = dout + (size_t)bh * T * dv;

  // query tiles in band of this key tile: the window inverts
  // (_band_tile_bounds(k0, k0 + 64, right, left, ...)), capped at the length
  const int n_tiles = (T + TILE - 1) / TILE;
  int lo = 0, hi = n_tiles;
  if (right >= 0) lo = max(k0 - right, 0) / TILE;
  if (left >= 0) hi = min((k0 + TILE + left + TILE - 1) / TILE, n_tiles);
  hi = min(hi, (klim + TILE - 1) / TILE);
  if (k0 >= klim) hi = lo;

  // this lane: key row r, query columns half*32 .. +31
  const int r = 16 * warp + (lane >> 1);
  const int half = lane & 1;
  const int kj = k0 + r;
  const bool k_ok = kj < klim;
  for (int idx = threadIdx.x; idx < TILE * L.lda; idx += NTHREADS) A[idx] = 0.f;
  for (int idx = threadIdx.x; idx < TILE * L.ldav; idx += NTHREADS) AV[idx] = 0.f;

  // this warp's 16 rows of the V tile, as A fragments for dP^T = V dO^T
  const int nvf = L.dvp / 16;
  bf16* Vst = reinterpret_cast<bf16*>(S);  // staged through the score buffer
  load_tile(Vst, L.ldv, v + (size_t)bh * T * dv, dv, k0, T, 0, dv, L.dvp);
  __syncthreads();
  RowA va[MAX_DV_FRAGS];
#pragma unroll
  for (int d = 0; d < MAX_DV_FRAGS; ++d)
    if (d < nvf) wmma::load_matrix_sync(va[d], Vst + (16 * warp) * L.ldv + 16 * d, L.ldv);

  const int n_chunks = (d1 + DC - 1) / DC;
  for (int qt = lo; qt < hi; ++qt) {
    const int q0 = qt * TILE;
    // S^T = Ks Qs^T for this warp's 16 key rows
    AccFrag acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();  // every warp is done with the previous chunk (dO, lse, delta)
      const int col0 = c * DC;
      load_tile(Kc, LDQK, ks_bh, d1, k0, T, col0, d1, DC);
      load_tile(Qc, LDQK, qs_bh, d1, q0, T, col0, d1, DC);
      if (c == 0) {
        load_tile(dOs, L.ldv, do_bh, dv, q0, T, 0, dv, L.dvp);
        if (threadIdx.x < TILE) {
          const int qq = q0 + threadIdx.x;
          lse_s[threadIdx.x] = qq < T ? lse[(size_t)bh * T + qq] : 0.f;
          delta_s[threadIdx.x] = qq < T ? delta[(size_t)bh * T + qq] : 0.f;
        }
      }
      __syncthreads();
      const int ksteps = (min(DC, d1 - col0) + 15) / 16;
      for (int kk = 0; kk < ksteps; ++kk) {
        RowA a;
        wmma::load_matrix_sync(a, Kc + (16 * warp) * LDQK + kk * 16, LDQK);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ColB b;  // a Qs chunk stored [query][depth] is Qs^T in column-major order
          wmma::load_matrix_sync(b, Qc + (16 * j) * LDQK + kk * 16, LDQK);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(S + (16 * warp) * LDS + 16 * j, acc[j], LDS, wmma::mem_row_major);
    __syncwarp();

    // P^T: fp32 in registers, bf16 in the probability buffer
    float p[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int q = half * 32 + c;
      const int qi = q0 + q;
      const bool ok = k_ok && qi < klim && in_band(qi, kj, left, right);
      p[c] = ok ? expf(S[r * LDS + q] * scale - lse_s[q]) : 0.f;
      P[r * LDP + q] = __float2bfloat16(p[c]);
    }
    __syncwarp();

    // dV += P^T dO
    for (int n = 0; n < nvf; ++n) {
      AccFrag o;
      float* o_tile = AV + (16 * warp) * L.ldav + 16 * n;
      wmma::load_matrix_sync(o, o_tile, L.ldav, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        RowA a;
        RowB b;
        wmma::load_matrix_sync(a, P + (16 * warp) * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(b, dOs + (kk * 16) * L.ldv + 16 * n, L.ldv);
        wmma::mma_sync(o, a, b, o);
      }
      wmma::store_matrix_sync(o_tile, o, L.ldav, wmma::mem_row_major);
    }

    // dP^T = V dO^T into the score buffer
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      AccFrag t;
      wmma::fill_fragment(t, 0.f);
#pragma unroll
      for (int d = 0; d < MAX_DV_FRAGS; ++d) {
        if (d < nvf) {
          ColB b;  // dO stored [query][dv] is dO^T in column-major order
          wmma::load_matrix_sync(b, dOs + (16 * j) * L.ldv + 16 * d, L.ldv);
          wmma::mma_sync(t, va[d], b, t);
        }
      }
      wmma::store_matrix_sync(S + (16 * warp) * LDS + 16 * j, t, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // dS^T = P^T (dP^T - delta) scale, over the probability buffer
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int q = half * 32 + c;
      const float ds = p[c] * (S[r * LDS + q] - delta_s[q]) * scale;
      P[r * LDP + q] = __float2bfloat16(ds);
    }
    __syncwarp();

    // dK += dS^T Qs, chunk by chunk of the depth
    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();
      const int col0 = c * DC;
      load_tile(Qc, LDQK, qs_bh, d1, q0, T, col0, d1, DC);
      __syncthreads();
      accumulate_chunk(A, L.lda, P, Qc, col0, L.d1p, warp);
    }
  }

  __syncthreads();
  write_rows(dk + (size_t)bh * T * d1, A, L.lda, kj, r, T, d1, L.d1p, half);
  write_rows(dvo + (size_t)bh * T * dv, AV, L.ldav, kj, r, T, dv, L.dvp, half);
}

}  // namespace

// Bytes of shared memory the larger of the two kernels needs at (d1, dv).
extern "C" int flash_attention_bwd_smem_bytes(int d1, int dv) {
  const size_t a = make_layout(d1, dv, false).total, b = make_layout(d1, dv, true).total;
  return (int)(a > b ? a : b);
}

// qs, ks: [bh, t, d1] bf16; v, dout: [bh, t, dv] bf16; lse, delta: [bh, t]
// fp32; lens: [bh] int32; dq: [bh, t, d1] bf16. All contiguous, 16-byte
// aligned. Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int flash_attention_bwd_dq_bf16(const void* qs, const void* ks, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           const void* lens, void* dq, int bh, int t, int d1,
                                           int dv, float scale, int left, int right,
                                           void* stream) {
  const Layout L = make_layout(d1, dv, false);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + TILE - 1) / TILE, bh);
  flash_bwd_dq_kernel<<<grid, NTHREADS, L.total, (cudaStream_t)stream>>>(
      (const bf16*)qs, (const bf16*)ks, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (const int*)lens, (bf16*)dq, t, d1, dv, scale, left, right);
  return (int)cudaGetLastError();
}

// As above; dk: [bh, t, d1] bf16, dvo: [bh, t, dv] bf16.
extern "C" int flash_attention_bwd_dkv_bf16(const void* qs, const void* ks, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            const void* lens, void* dk, void* dvo, int bh, int t,
                                            int d1, int dv, float scale, int left, int right,
                                            void* stream) {
  const Layout L = make_layout(d1, dv, true);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + TILE - 1) / TILE, bh);
  flash_bwd_dkv_kernel<<<grid, NTHREADS, L.total, (cudaStream_t)stream>>>(
      (const bf16*)qs, (const bf16*)ks, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (const int*)lens, (bf16*)dk, (bf16*)dvo, t, d1, dv, scale, left,
      right);
  return (int)cudaGetLastError();
}
