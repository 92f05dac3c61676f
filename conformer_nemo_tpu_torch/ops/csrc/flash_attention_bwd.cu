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
// bound it. Two kernels, no atomics, so every output is the same bits on
// every call.
//
// dQ kernel (WMMA, simple first): one block of 4 warps per (bh, 64-query
// tile) looping over key tiles; S = Qs Ks^T by WMMA bf16 m16n16k16 over
// 64-deep chunks staged in shared memory, P and dS in fp32 registers (warp w
// owns rows 16w..16w+15) rounded to bf16 only as the next product's A
// operand; the 64 x d1 fp32 dQ accumulator stays in shared memory and is
// read back through WMMA accumulator fragments (207 KB at d1 = 576, dv = 64,
// one block per SM).
//
// dK/dV kernel (redesigned for Hopper): one block of 8 warps per (bh,
// 32-key tile) looping over the 64-query tiles in band (the band inverts:
// a key tile meets queries up to `right` before and `left` after it, as in
// the TPU kernel's `_band_tile_bounds` call). What the card asks of it:
//   * load once: the block's K and V tiles (32 x d1, 32 x dv bf16) are
//     loaded once and stay in shared memory;
//   * stream the rest: each query tile's Qs, dO, lse and delta arrive
//     through a 2-stage cp.async ring, the next tile's copies in flight
//     while this one's products run; each Qs tile serves both S^T = K Qs^T
//     and dK += dS^T Qs, so it is read from device memory once per block;
//   * tensor cores from registers: every product is mma.sync m16n8k16 bf16
//     (fp32 accumulate) from ldmatrix fragments; warp (rg, cg) forms S^T and
//     dP^T = V dO^T for keys 16rg.. x queries 16cg.. in fp32 registers (two
//     accumulator sets over alternate depth steps, for independent chains;
//     the depth loop unrolled by 4, which timed faster than no unrolling on
//     an H100), then P^T and dS^T in registers;
//   * dK and dV accumulate in fp32 registers across the whole query loop:
//     each warp owns all 32 key rows x its share of the columns (up to 9
//     n-tiles of 8 of dK, so d1 <= 576: 72 accumulators a thread; up to 2 of
//     dV), so dK's 576 columns split 8 ways and each Qs fragment feeds two
//     row blocks. The column split needs every warp's dS^T rows: P^T and
//     dS^T go through shared memory once per query tile as bf16 (9 KB),
//     which is also where they are rounded for the dV and dK products;
//   * two barriers per query tile; the outputs go out through shared
//     memory in 16-byte rows, each written once.
// Why 32 keys and 8 warps: dK's 32 x 576 fp32 block is 72 registers a
// thread over 256 threads, which leaves room for the S^T and dP^T tiles
// under 255; and the K tile beside a 2-stage Qs ring fits one SM (215 KB at
// d1 = 576, dv = 64). A 64-key tile needs a 75 KB K tile beside the same
// ring (234 KB, over the 227 KB a block may use) and 16 warps, which caps a
// thread at 128 registers. This is arithmetic, not a measured comparison.
// Next for this kernel: wgmma from shared memory with TMA loads (the
// register budget of dK's 576-wide accumulator is the hard part).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "flash_tiles.cuh"
#include "tensor_core.cuh"

using namespace nvcuda;
using namespace flash;
using namespace tc;

namespace {

// The dQ kernel's shared memory.
struct Layout {
  int d1p, dvp;  // d1 and dv rounded up to the WMMA width
  int ldv;       // bf16 row stride of the V / dO tiles
  int lda;       // fp32 row stride of the d1-wide accumulator
  size_t q, k, v, dout, s, p, acc, total;  // byte offsets
};

__host__ __device__ inline Layout make_layout(int d1, int dv) {
  Layout L;
  L.d1p = round16(d1);
  L.dvp = round16(dv);
  L.ldv = L.dvp + 8;
  L.lda = L.d1p + 4;
  size_t off = 0;
  L.q = off; off = align128(off + sizeof(bf16) * TILE * LDQK);
  L.k = off; off = align128(off + sizeof(bf16) * TILE * LDQK);
  L.dout = off; off = align128(off + sizeof(bf16) * TILE * L.ldv);
  L.s = off; off = align128(off + sizeof(float) * TILE * LDS);
  L.p = off; off = align128(off + sizeof(bf16) * TILE * LDP);
  L.acc = off; off = align128(off + sizeof(float) * TILE * L.lda);
  L.v = off; off = align128(off + sizeof(bf16) * TILE * L.ldv);
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
  const Layout L = make_layout(d1, dv);
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

// ---------------------------------------------------------------------------
// dK/dV kernel
// ---------------------------------------------------------------------------

constexpr int DKV_KEYS = 32;      // keys per block
constexpr int DKV_THREADS = 256;  // 8 warps
constexpr int DKV_WARPS = DKV_THREADS / 32;
constexpr int DKV_NT = 9;         // n-tiles of 8 dK columns a warp holds at most
constexpr int DKV_MAX_D1 = DKV_WARPS * DKV_NT * 8;  // 576
constexpr int DKV_STAGES = 2;     // the query tiles' cp.async ring

struct DkvLayout {
  int d1p, dvp;  // d1 and dv rounded up to 16 (zero columns past d1, dv)
  int ldk, ldv;  // bf16 row strides of the d1-wide and dv-wide tiles
  size_t k, v, q, dout, lse, delta, p, ds, total;  // byte offsets (stage 0)
  size_t q_stage, do_stage;                         // bytes per stage
};

__host__ __device__ inline DkvLayout dkv_layout(int d1, int dv) {
  DkvLayout L;
  L.d1p = round16(d1);
  L.dvp = round16(dv);
  L.ldk = L.d1p + 8;  // an odd number of 16-byte units: ldmatrix rows hit distinct banks
  L.ldv = L.dvp + 8;
  L.q_stage = align128(sizeof(bf16) * TILE * L.ldk);
  L.do_stage = align128(sizeof(bf16) * TILE * L.ldv);
  size_t off = 0;
  L.k = off; off = align128(off + sizeof(bf16) * DKV_KEYS * L.ldk);
  L.v = off; off = align128(off + sizeof(bf16) * DKV_KEYS * L.ldv);
  L.q = off; off += DKV_STAGES * L.q_stage;
  L.dout = off; off += DKV_STAGES * L.do_stage;
  L.lse = off; off = align128(off + sizeof(float) * DKV_STAGES * TILE);
  L.delta = off; off = align128(off + sizeof(float) * DKV_STAGES * TILE);
  L.p = off; off = align128(off + sizeof(bf16) * DKV_KEYS * LDP);
  L.ds = off; off = align128(off + sizeof(bf16) * DKV_KEYS * LDP);
  L.total = off;
  return L;
}

// rows row0.. of a row-major [nrows x width] bf16 matrix into shared rows of
// stride ld by cp.async, 16 bytes at a time; rows past nrows untouched
__device__ inline void stage_rows(bf16* dst, int ld, const bf16* __restrict__ src, int width,
                                  int row0, int rows, int nrows) {
  const int vec = width / 8;
  for (int i = threadIdx.x; i < rows * vec; i += DKV_THREADS) {
    const int r = i / vec, c = (i % vec) * 8;
    if (row0 + r < nrows) cp_async16(dst + r * ld + c, src + (size_t)(row0 + r) * width + c);
  }
}

// one 16-deep step of a [16 x 16] product: c0, c1 += A (16 x 16 at a) B^T
// (two n-tiles from [n][k] storage at b)
__device__ inline void mma_step_nk(float (&c0)[4], float (&c1)[4], const bf16* a, const bf16* b) {
  uint32_t af[4], bf[4];
  ldsm4(af, a);
  ldsm4(bf, b);
  mma16816(c0, af, bf[0], bf[1]);
  mma16816(c1, af, bf[2], bf[3]);
}

__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_bwd_dkv_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ ks,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ lens, bf16* __restrict__ dk,
                     bf16* __restrict__ dvo, int T, int d1, int dv, float scale, int left,
                     int right) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DkvLayout L = dkv_layout(d1, dv);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p);
  bf16* Ds = reinterpret_cast<bf16*>(smem + L.ds);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * DKV_KEYS;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int klim = min(max(lens[bh], 0), T);
  const bf16* qs_bh = qs + (size_t)bh * T * d1;
  const bf16* do_bh = dout + (size_t)bh * T * dv;
  const float* lse_bh = lse + (size_t)bh * T;
  const float* delta_bh = delta + (size_t)bh * T;

  // query tiles in band of keys k0..k0+31: the window inverts
  // (_band_tile_bounds(k0, k0 + 32, right, left, ...)), capped at the length
  const int n_tiles = (T + TILE - 1) / TILE;
  int lo = 0, hi = n_tiles;
  if (right >= 0) lo = max(k0 - right, 0) / TILE;
  if (left >= 0) hi = min((k0 + DKV_KEYS - 1 + left) / TILE + 1, n_tiles);
  hi = min(hi, (klim + TILE - 1) / TILE);
  if (k0 >= klim) hi = lo;

  // Zero all of it once: the pad columns past d1 and dv, and rows past T,
  // are never loaded and must read as 0 (0 x garbage may be NaN in a product)
  for (size_t i = threadIdx.x; i < L.total / 16; i += DKV_THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  auto load_queries = [&](int stage, int q0) {
    stage_rows(reinterpret_cast<bf16*>(smem + L.q + stage * L.q_stage), L.ldk, qs_bh, d1, q0,
               TILE, T);
    stage_rows(reinterpret_cast<bf16*>(smem + L.dout + stage * L.do_stage), L.ldv, do_bh, dv,
               q0, TILE, T);
    float* lse_s = reinterpret_cast<float*>(smem + L.lse) + stage * TILE;
    float* delta_s = reinterpret_cast<float*>(smem + L.delta) + stage * TILE;
    const int r = threadIdx.x & (TILE - 1);
    if (q0 + r < T) {
      if (threadIdx.x < TILE) cp_async4(lse_s + r, lse_bh + q0 + r);
      else if (threadIdx.x < 2 * TILE) cp_async4(delta_s + r, delta_bh + q0 + r);
    }
  };
  stage_rows(Ks, L.ldk, ks + (size_t)bh * T * d1, d1, k0, DKV_KEYS, T);
  stage_rows(Vs, L.ldv, v + (size_t)bh * T * dv, dv, k0, DKV_KEYS, T);
  if (lo < hi) load_queries(0, lo * TILE);
  cp_commit();

  // S^T / dP^T tile of this warp: keys 16 rg.., queries 16 cg..
  const int rg = warp & 1, cg = warp >> 1;
  const int g = l >> 2, c2 = 2 * (l & 3);  // accumulator row and column pair of this lane
  // dK columns of this warp: n-tiles nt0 .. nt0 + nk - 1 (all 32 key rows)
  const int n8k = L.d1p / 8;
  const int ntw = (n8k + DKV_WARPS - 1) / DKV_WARPS;
  const int nt0 = warp * ntw;
  const int nk = max(0, min(ntw, n8k - nt0));
  // dV columns of this warp: n-tiles warp and warp + 8
  const int n8v = L.dvp / 8;
  const int nkk = L.d1p / 16, nvk = L.dvp / 16;

  float dka[2][DKV_NT][4], dva[2][2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int j = 0; j < DKV_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[m][j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dva[m][j][e] = 0.f;
  }

  for (int qt = lo; qt < hi; ++qt) {
    const int st = (qt - lo) & 1;
    const int q0 = qt * TILE;
    cp_wait<0>();
    __syncthreads();  // this tile has landed; every warp is done with the other stage
    if (qt + 1 < hi) load_queries(st ^ 1, q0 + TILE);
    cp_commit();
    const bf16* Qt = reinterpret_cast<const bf16*>(smem + L.q + st * L.q_stage);
    const bf16* dOt = reinterpret_cast<const bf16*>(smem + L.dout + st * L.do_stage);
    const float* lse_s = reinterpret_cast<const float*>(smem + L.lse) + st * TILE;
    const float* delta_s = reinterpret_cast<const float*>(smem + L.delta) + st * TILE;

    // S^T = K Qs^T over the depth, alternate steps into two accumulator sets
    float s[4][4], dp[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
    int kk = 0;
#pragma unroll 4
    for (; kk + 1 < nkk; kk += 2) {
      mma_step_nk(s[0], s[1], a_addr(Ks, L.ldk, 16 * rg, 16 * kk, l),
                  bn_addr(Qt, L.ldk, 16 * kk, 16 * cg, l));
      mma_step_nk(s[2], s[3], a_addr(Ks, L.ldk, 16 * rg, 16 * kk + 16, l),
                  bn_addr(Qt, L.ldk, 16 * kk + 16, 16 * cg, l));
    }
    if (kk < nkk)
      mma_step_nk(s[0], s[1], a_addr(Ks, L.ldk, 16 * rg, 16 * kk, l),
                  bn_addr(Qt, L.ldk, 16 * kk, 16 * cg, l));
    // dP^T = V dO^T
#pragma unroll 4
    for (int kv = 0; kv < nvk; ++kv)
      mma_step_nk(dp[0], dp[1], a_addr(Vs, L.ldv, 16 * rg, 16 * kv, l),
                  bn_addr(dOt, L.ldv, 16 * kv, 16 * cg, l));

    // P^T and dS^T in fp32 registers, rounded to bf16 into shared memory
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // accumulator rows g and g + 8
        const int row = 16 * rg + g + 8 * h, kj = k0 + row;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 16 * cg + 8 * j + c2 + e, qi = q0 + col;
          const bool ok = kj < klim && qi < klim && in_band(qi, kj, left, right);
          const float sv = s[j][2 * h + e] + s[j + 2][2 * h + e];
          p[e] = ok ? expf(sv * scale - lse_s[col]) : 0.f;
          ds[e] = ok ? p[e] * (dp[j][2 * h + e] - delta_s[col]) * scale : 0.f;
        }
        const int o = row * LDP + 16 * cg + 8 * j + c2;
        *reinterpret_cast<uint32_t*>(Ps + o) = pack2(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(Ds + o) = pack2(ds[0], ds[1]);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Qs over the tile's 64 queries, all 32 keys
#pragma unroll
    for (int kq = 0; kq < TILE / 16; ++kq) {
      uint32_t pa[2][4], da[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        ldsm4(pa[m], a_addr(Ps, LDP, 16 * m, 16 * kq, l));
        ldsm4(da[m], a_addr(Ds, LDP, 16 * m, 16 * kq, l));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = warp + DKV_WARPS * j;
        if (nt < n8v) {
          uint32_t b[2];
          ldsm2t(b, bt_addr(dOt, L.ldv, 16 * kq, 8 * nt, l & 15));
          mma16816(dva[0][j], pa[0], b[0], b[1]);
          mma16816(dva[1][j], pa[1], b[0], b[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < DKV_NT; j += 2) {
        if (j + 1 < nk) {
          uint32_t b[4];
          ldsm4t(b, bt_addr(Qt, L.ldk, 16 * kq, 8 * (nt0 + j), l));
          mma16816(dka[0][j], da[0], b[0], b[1]);
          mma16816(dka[1][j], da[1], b[0], b[1]);
          mma16816(dka[0][j + 1], da[0], b[2], b[3]);
          mma16816(dka[1][j + 1], da[1], b[2], b[3]);
        } else if (j < nk) {
          uint32_t b[2];
          ldsm2t(b, bt_addr(Qt, L.ldk, 16 * kq, 8 * (nt0 + j), l & 15));
          mma16816(dka[0][j], da[0], b[0], b[1]);
          mma16816(dka[1][j], da[1], b[0], b[1]);
        }
      }
    }
  }

  // dK and dV as bf16 through the K and V tiles, then 16-byte rows out
  cp_wait<0>();
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * m + g + 8 * h;
#pragma unroll
      for (int j = 0; j < DKV_NT; ++j)
        if (j < nk)
          *reinterpret_cast<uint32_t*>(Ks + row * L.ldk + 8 * (nt0 + j) + c2) =
              pack2(dka[m][j][2 * h], dka[m][j][2 * h + 1]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = warp + DKV_WARPS * j;
        if (nt < n8v)
          *reinterpret_cast<uint32_t*>(Vs + row * L.ldv + 8 * nt + c2) =
              pack2(dva[m][j][2 * h], dva[m][j][2 * h + 1]);
      }
    }
  }
  __syncthreads();
  const int vk = d1 / 8, vv = dv / 8;
  for (int i = threadIdx.x; i < DKV_KEYS * vk; i += DKV_THREADS) {
    const int r = i / vk, c = (i % vk) * 8;
    if (k0 + r < T)
      *reinterpret_cast<uint4*>(dk + ((size_t)bh * T + k0 + r) * d1 + c) =
          *reinterpret_cast<const uint4*>(Ks + r * L.ldk + c);
  }
  for (int i = threadIdx.x; i < DKV_KEYS * vv; i += DKV_THREADS) {
    const int r = i / vv, c = (i % vv) * 8;
    if (k0 + r < T)
      *reinterpret_cast<uint4*>(dvo + ((size_t)bh * T + k0 + r) * dv + c) =
          *reinterpret_cast<const uint4*>(Vs + r * L.ldv + c);
  }
}

}  // namespace

// Bytes of shared memory the dQ kernel needs at (d1, dv).
extern "C" int flash_attention_bwd_dq_smem_bytes(int d1, int dv) {
  return (int)make_layout(d1, dv).total;
}

// Bytes of shared memory the dK/dV kernel needs at (d1, dv).
extern "C" int flash_attention_bwd_dkv_smem_bytes(int d1, int dv) {
  return (int)dkv_layout(d1, dv).total;
}

// The largest d1 the dK/dV kernel takes: its warps hold dK in registers.
extern "C" int flash_attention_bwd_dkv_max_d1() { return DKV_MAX_D1; }

// qs, ks: [bh, t, d1] bf16; v, dout: [bh, t, dv] bf16; lse, delta: [bh, t]
// fp32; lens: [bh] int32; dq: [bh, t, d1] bf16. All contiguous, 16-byte
// aligned. Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int flash_attention_bwd_dq_bf16(const void* qs, const void* ks, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           const void* lens, void* dq, int bh, int t, int d1,
                                           int dv, float scale, int left, int right,
                                           void* stream) {
  const Layout L = make_layout(d1, dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + TILE - 1) / TILE, bh);
  flash_bwd_dq_kernel<<<grid, NTHREADS, L.total, (cudaStream_t)stream>>>(
      (const bf16*)qs, (const bf16*)ks, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (const int*)lens, (bf16*)dq, t, d1, dv, scale, left, right);
  return (int)cudaGetLastError();
}

// As above; dk: [bh, t, d1] bf16, dvo: [bh, t, dv] bf16; d1 <= 576.
extern "C" int flash_attention_bwd_dkv_bf16(const void* qs, const void* ks, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            const void* lens, void* dk, void* dvo, int bh, int t,
                                            int d1, int dv, float scale, int left, int right,
                                            void* stream) {
  if (round16(d1) > DKV_MAX_D1) return (int)cudaErrorInvalidValue;
  const DkvLayout L = dkv_layout(d1, dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + DKV_KEYS - 1) / DKV_KEYS, bh);
  flash_bwd_dkv_kernel<<<grid, DKV_THREADS, L.total, (cudaStream_t)stream>>>(
      (const bf16*)qs, (const bf16*)ks, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (const int*)lens, (bf16*)dk, (bf16*)dvo, t, d1, dv, scale, left,
      right);
  return (int)cudaGetLastError();
}
