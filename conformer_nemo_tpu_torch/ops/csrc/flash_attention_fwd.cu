// Flash attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels `_make_kernel` (via `_flash_fwd_entry`) and
// `_make_fwd_streamed_kernel` (via `_flash_fwd_streamed`) of
// conformer_nemo_tpu/ops/pallas/flash_attention.py: both compute
//
//     o[i]   = sum_j softmax_j(qs[i] . ks[j] * scale | visible) v[j]
//     lse[i] = logsumexp_j(qs[i] . ks[j] * scale | visible)
//
// where key j is visible to query i iff j < lens[bh] (and j < T) and, with a
// band, i - j <= left and j - i <= right (-1 = unlimited). A row without a
// visible key gets o = 0 and lse = 0. The streamed TPU variant only differs
// in how it moves the banded K/V tiles through VMEM; here one kernel whose
// key-tile loop is bounded by the band serves both.
//
// Bound on an H100: 2 * (visible pairs) * (d1 + dv) FLOPs at 989 TFLOP/s
// (bf16 dense tensor cores) against reading once the rows of qs that see a
// key and the rows of ks and v that a query sees, and writing o and lse
// once, at 3.35 TB/s. At the Conformer's shapes (d1 = 576, dv = 64,
// T >= 1024) with full-length rows that is ~600 FLOPs per byte, so the
// tensor cores bound it; many short rows can bring it under the ridge.
//
// Design (simple and right first; speed is later work):
//   * one block of 4 warps per (bh, 64-query tile); grid (ceil(T/64), BH);
//   * a loop over 64-key tiles from the band's first tile to the last tile
//     that holds a visible key (`_band_tile_bounds`, capped at the length);
//   * S = Qs Ks^T over d1 in depth chunks of 64: a 64x64 bf16 chunk of Qs and
//     of Ks is staged in shared memory and multiplied with WMMA bf16 m16n16k16
//     on the tensor cores, fp32 accumulation; warp w owns query rows
//     16w..16w+15 of every tile, so softmax and the P V product need only
//     warp-level synchronisation;
//   * online softmax in fp32 with the TPU kernel's m_safe / l_safe guards;
//     the running output (64 x dv fp32) lives in shared memory, rescaled by
//     each row's alpha and then accumulated with P V on the tensor cores;
//   * no TPU lane padding: d1 and dv are taken as they are (multiples of 8,
//     dv <= 128), and the kernel zero-fills its own ragged edges.
// Shared memory at dv = 64: 70 KB, so three blocks fit on one SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "flash_tiles.cuh"

using namespace nvcuda;
using namespace flash;

namespace {

constexpr int BQ = TILE;  // query rows per block
constexpr int BK = TILE;  // keys per tile

struct Layout {
  int dvp;  // dv rounded up to the WMMA width
  int ldv;  // bf16 row stride of the V tile
  int ldo;  // fp32 row stride of the output accumulator
  size_t q, k, v, s, p, o, total;  // byte offsets into shared memory
};

__host__ __device__ inline Layout make_layout(int dv) {
  Layout L;
  L.dvp = round16(dv);
  L.ldv = L.dvp + 8;
  L.ldo = L.dvp + 4;
  size_t off = 0;
  L.q = off; off = align128(off + sizeof(bf16) * BQ * LDQK);
  L.k = off; off = align128(off + sizeof(bf16) * BK * LDQK);
  L.v = off; off = align128(off + sizeof(bf16) * BK * L.ldv);
  L.s = off; off = align128(off + sizeof(float) * BQ * LDS);
  L.p = off; off = align128(off + sizeof(bf16) * BQ * LDP);
  L.o = off; off = align128(off + sizeof(float) * BQ * L.ldo);
  L.total = off;
  return L;
}

__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ ks,
                 const bf16* __restrict__ v, const int* __restrict__ lens,
                 bf16* __restrict__ o, float* __restrict__ lse,
                 int T, int d1, int dv, float scale, int left, int right) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(dv);
  bf16* Qc = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Kc = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  float* S = reinterpret_cast<float*>(smem + L.s);
  bf16* P = reinterpret_cast<bf16*>(smem + L.p);
  float* O = reinterpret_cast<float*>(smem + L.o);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int klim = min(max(lens[bh], 0), T);  // keys < klim can be visible
  const bf16* qs_bh = qs + (size_t)bh * T * d1;
  const bf16* ks_bh = ks + (size_t)bh * T * d1;
  const bf16* v_bh = v + (size_t)bh * T * dv;

  // key tiles that can hold a visible key (the TPU kernel's _band_tile_bounds,
  // then capped at the key length)
  const int n_tiles = (T + BK - 1) / BK;
  int lo = 0, hi = n_tiles;
  if (left >= 0) lo = max(q0 - left, 0) / BK;
  if (right >= 0) hi = min((q0 + BQ + right + BK - 1) / BK, n_tiles);
  hi = min(hi, (klim + BK - 1) / BK);

  // this lane's share of the row-wise work: row r, columns half*32 .. +31
  const int r = 16 * warp + (lane >> 1);
  const int half = lane & 1;
  const int qi = q0 + r;
  const int hw = L.dvp / 2;
  float* o_row = O + r * L.ldo + half * hw;
  for (int c = 0; c < hw; ++c) o_row[c] = 0.f;
  float m_prev = NEG_INF, l_run = 0.f;

  const int n_chunks = (d1 + DC - 1) / DC;
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
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
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qc + (16 * warp) * LDQK + kk * 16, LDQK);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // Ks chunk stored [key][depth] is Ks^T in column-major order
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(b, Kc + (16 * j) * LDQK + kk * 16, LDQK);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(S + (16 * warp) * LDS + 16 * j, acc[j], LDS, wmma::mem_row_major);
    __syncwarp();

    // online softmax over this tile, fp32
    float sv[32];
    uint32_t vis = 0u;
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int kj = k0 + half * 32 + c;
      const bool ok = kj < klim && in_band(qi, kj, left, right);
      sv[c] = ok ? S[r * LDS + half * 32 + c] * scale : NEG_INF;
      vis |= (ok ? 1u : 0u) << c;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_prev, mx);
    const float m_safe = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = (vis >> c) & 1u ? expf(sv[c] - m_safe) : 0.f;
      sum += p;
      P[r * LDP + half * 32 + c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = m_prev <= NEG_INF * 0.5f ? 0.f : expf(m_prev - m_safe);
    l_run = l_run * alpha + sum;
    m_prev = m_new;
    for (int c = 0; c < hw; ++c) o_row[c] *= alpha;
    __syncwarp();

    // O[rows of this warp] += P V on the tensor cores
    for (int n = 0; n < L.dvp / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      float* o_tile = O + (16 * warp) * L.ldo + 16 * n;
      wmma::load_matrix_sync(oacc, o_tile, L.ldo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, P + (16 * warp) * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(b, Vs + (kk * 16) * L.ldv + 16 * n, L.ldv);
        wmma::mma_sync(oacc, a, b, oacc);
      }
      wmma::store_matrix_sync(o_tile, oacc, L.ldo, wmma::mem_row_major);
    }
    __syncwarp();
  }

  __syncwarp();
  if (qi < T) {
    const float l_safe = l_run == 0.f ? 1.f : l_run;
    bf16* out = o + ((size_t)bh * T + qi) * dv;
    const int c_end = min(dv, (half + 1) * hw);
    for (int c = half * hw; c < c_end; ++c)
      out[c] = __float2bfloat16(O[r * L.ldo + c] / l_safe);
    if (half == 0)
      lse[(size_t)bh * T + qi] = (m_prev <= NEG_INF * 0.5f ? 0.f : m_prev) + logf(l_safe);
  }
}

}  // namespace

// qs, ks: [bh, t, d1] bf16; v: [bh, t, dv] bf16; lens: [bh] int32;
// o: [bh, t, dv] bf16; lse: [bh, t] fp32; all contiguous, 16-byte aligned.
// Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd_bf16(const void* qs, const void* ks, const void* v,
                                        const void* lens, void* o, void* lse, int bh, int t,
                                        int d1, int dv, float scale, int left, int right,
                                        void* stream) {
  const Layout L = make_layout(dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + BQ - 1) / BQ, bh);
  flash_fwd_kernel<<<grid, NTHREADS, L.total, (cudaStream_t)stream>>>(
      (const bf16*)qs, (const bf16*)ks, (const bf16*)v, (const int*)lens, (bf16*)o,
      (float*)lse, t, d1, dv, scale, left, right);
  return (int)cudaGetLastError();
}
