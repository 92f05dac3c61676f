// RNN-T flash joint (K4): the joint network fused with the loss's
// log-softmax prep, forward and backward, for NVIDIA Hopper (sm_90a), bf16,
// plain C interface.
//
// Replaces the TPU kernels `_make_fwd_kernel` (via `joint_flash_fwd`) and
// `_make_bwd_kernel` (via `joint_flash_bwd`) of
// conformer_nemo_tpu/ops/pallas/rnnt_joint_kernel.py. For each lattice cell
// (b, t, u), with the vocabulary split blank-last (`_split_blank`: label
// columns 0..V-2, blank column V-1 = VL):
//
//   h     = drop(act(e[b, t] + p[b, u]))                      [H], bf16
//   lab_c = bf16(bf16(h . W[:, c]) + bias[c])   (fp32 product, c < VL)
//   blank = bf16(bf16(h . W[:, VL]) + bias[VL]) (fp32 row dot)
//   lse   = logsumexp(lab, blank); blank_lp = blank - lse; label_lp = lab[tgt] - lse
//
// The backward recomputes the tile and forms, per cell,
//   dlab_c = clamp(softmax_c * total - gy 1[c = tgt]) * g[b],
//   dblank = clamp(softmax_blank * total - gb) * g[b],
//   dh = bf16(bf16(dlab) . W_lab^T + dblank * W[:, VL]), dropout, then
//   dx = dh * act'(x) in bf16, and reduces
//   de[b, t] = sum_u dx, dp[b, u] = sum_t dx, dW_lab = sum h^T bf16(dlab),
//   dW[:, VL] = sum h * dblank, db = sum dlab, sum dblank.
// Every rounding point is the TPU kernel's (`_joint_tile`, the backward's
// dlab cast and bf16 dx), so the kernels follow the plain version to bf16
// rounding. The [B, T, U+1, V] logits never reach device memory.
//
// Dropout: murmur3's fmix32 of (index ^ seed) over the padded
// [B, Tp, U+1, H] layout of the TPU kernels, Tp = ceil(T / bt) * bt with the
// config's bt; index arithmetic in uint32 with wrap-around
// (`_tile_keep`); keep iff (bits >> 24) >= drop_t, rescaled by
// 1 / (1 - drop_t / 256). The kernels tile rows their own way but compute
// the index from (b, t, u, h), so the mask is `hash_keep_mask_reference`'s
// bit for bit.
//
// Both kernels compute only the cells inside each sample's lattice (t <
// t_len, u <= u_len): the loss reads no other. The loader pads U to its
// token cap, so at the flagship batch that is about a fifth of the cells.
//
// Bound on an H100: products of 2 * cells * H * VL FLOPs each over the
// lattice's cells (forward: the logits; backward: the logits again, dh and
// dW) at 989 TFLOP/s bf16 dense; the bytes are e, p, W and the [B, T, U+1]
// streams, far smaller. So the tensor cores bound it.
//
// Design (simple and right first):
//   * forward: one block of 4 warps per 64 lattice cells of one sample
//     (t-major: cell j -> t = j / (u_len + 1), u = j % (u_len + 1)); the
//     grid covers all T * (U+1) cells, so block x also writes the sentinels
//     of the cells outside the lattice among full-index rows 64x..64x+63,
//     and blocks past the lattice's count stop there. h is formed in shared memory as bf16 (the hash
//     dropout in place); W's label block streams through shared memory in
//     64 x 64 pieces; WMMA bf16 m16n16k16 with fp32 accumulation gives the
//     logits 64 columns at a time, with an online max and sum over the
//     chunks (blank seeds them), as K2-fwd does over keys. The label
//     block's ragged width (VL = 295 at the flagship) is zero-padded inside
//     the kernel and its pad columns never enter the max, the sum or a store.
//   * backward, two kernels, no atomics (deterministic):
//     (bwd) one block per (b, 16 frames) over the sample's cells inside its
//          lattice (cells outside it have zero posteriors, so they add
//          nothing), 64 cells at a time: recompute h and the logits, dlab in
//          shared memory as bf16, dh = dlab W_lab^T by WMMA 64 hidden
//          columns at a time, dx; de is summed in shared memory; dp goes
//          into the block's own slice of a partial buffer [B, tiles, U+1, H],
//          dW_lab += h^T dlab by WMMA into the block's own [H, VL] slice
//          (read, add and written back per 64 cells: the slice does not fit
//          in shared memory), db and dW[:, VL] into per-block partials;
//     (reduce) sums the partials of dp, dW and db in a fixed order.
//   The TPU kernel carries dp, dW and db across its sequential grid; Hopper
//   blocks run in any order, hence the partials and the second pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 128;         // 4 warps, 16 rows of a 64-row tile each
constexpr int ROWS = 64;        // cells per tile
constexpr int NC = 64;          // label columns per chunk
constexpr int KC = 64;          // depth of a staged W piece
constexpr int LDW = NC + 8;     // bf16 stride of a W piece
constexpr int LDS = NC + 4;     // fp32 stride of a logits tile
constexpr int TB = 16;          // frames per backward tile
constexpr float NEG_INF = -1e30f;

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }
__host__ __device__ inline int round64(int x) { return (x + 63) / 64 * 64; }

__device__ inline float rb(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ inline uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// The joint's static parameters.
struct Joint {
  const bf16* e;       // [B, T, H]
  const bf16* p;       // [B, U1, H]
  const bf16* w;       // [H, V]
  const bf16* bias;    // [V]
  const int* targets;  // [B, U1 - 1]
  int B, T, U1, H, V, VL, Tp, act, drop_t;
  uint32_t seed;
  float inv_keep;
};

__device__ inline float act_fn(float x, int act) {
  if (act == 0) return x > 0.f ? x : 0.f;
  if (act == 1) return rb(1.f / (1.f + expf(-x)));
  return rb(tanhf(x));
}

// act'(x) from the pre-activation x and the un-dropped activation a, in bf16
// arithmetic (`_act_grad`)
__device__ inline float act_grad(float x, float a, int act) {
  if (act == 0) return x > 0.f ? 1.f : 0.f;
  if (act == 1) return rb(a * rb(1.f - a));
  return rb(1.f - rb(a * a));
}

__device__ inline bool keep_elem(const Joint& J, int b, int t, int u, int h) {
  const uint32_t idx = ((uint32_t)b * (uint32_t)J.Tp + (uint32_t)t) * ((uint32_t)J.U1 * (uint32_t)J.H)
                       + (uint32_t)u * (uint32_t)J.H + (uint32_t)h;
  return (int)(fmix32(idx ^ J.seed) >> 24) >= J.drop_t;
}

// x = bf16(e[b, t, h] + p[b, u, h])
__device__ inline float pre_act(const Joint& J, int b, int t, int u, int h) {
  return rb(__bfloat162float(J.e[((size_t)b * J.T + t) * J.H + h]) +
            __bfloat162float(J.p[((size_t)b * J.U1 + u) * J.H + h]));
}

// h = drop(act(x)) of the 64 rows whose (t, u) are in rt/ru (t < 0: empty
// row, zeros), into Hs [64][ldh] bf16. Caller synchronises.
__device__ void build_h(const Joint& J, int b, const int* rt, const int* ru, bf16* Hs, int ldh) {
  for (int idx = threadIdx.x; idx < ROWS * J.H; idx += NT) {
    const int r = idx / J.H, h = idx % J.H;
    const int t = rt[r], u = ru[r];
    float a = 0.f;
    if (t >= 0) {
      a = act_fn(pre_act(J, b, t, u, h), J.act);
      if (J.drop_t > 0) a = keep_elem(J, b, t, u, h) ? rb(a * J.inv_keep) : 0.f;
    }
    Hs[r * ldh + h] = __float2bfloat16(a);
  }
}

// blank logit of row r from Hs: the fp32 row dot with W[:, VL], rounded, +
// bias[VL] in bf16. Two lanes per row (half = lane & 1), combined by shuffle.
__device__ inline float blank_logit(const Joint& J, const bf16* Hs, int ldh, int r, int half) {
  const int hw = (J.H + 1) / 2;
  const int h1 = min(J.H, (half + 1) * hw);
  float s = 0.f;
  for (int h = half * hw; h < h1; ++h)
    s += __bfloat162float(Hs[r * ldh + h]) * __bfloat162float(J.w[(size_t)h * J.V + J.VL]);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return rb(rb(s) + __bfloat162float(J.bias[J.VL]));
}

// S[64][LDS] = Hs[64][H] @ W[:, c0 : c0 + 64] (label columns only, zero past
// VL), fp32, through WMMA with W staged in Wc [KC][LDW]. Warp w writes rows
// 16w..16w+15; the caller reads them after __syncwarp (its own rows) or
// __syncthreads.
__device__ void logits_chunk(const Joint& J, const bf16* Hs, int ldh, bf16* Wc, float* S, int c0) {
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int k0 = 0; k0 < J.H; k0 += KC) {
    __syncthreads();  // every warp is done with the previous piece
    for (int idx = threadIdx.x; idx < KC * NC; idx += NT) {
      const int kk = idx / NC, cc = idx % NC;
      const int k = k0 + kk, c = c0 + cc;
      Wc[kk * LDW + cc] = (k < J.H && c < J.VL) ? J.w[(size_t)k * J.V + c] : __float2bfloat16(0.f);
    }
    __syncthreads();
    const int ksteps = min(KC, J.H - k0) / 16;
    for (int kk = 0; kk < ksteps; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Hs + (16 * warp) * ldh + k0 + kk * 16, ldh);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, Wc + (kk * 16) * LDW + 16 * j, LDW);
        wmma::mma_sync(acc[j], a, bfr, acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(S + (16 * warp) * LDS + 16 * j, acc[j], LDS, wmma::mem_row_major);
  __syncwarp();
}

// label logit as the TPU kernel rounds it: bf16 product, + bias in bf16
__device__ inline float label_logit(const Joint& J, float acc, int c) {
  return rb(rb(acc) + __bfloat162float(J.bias[c]));
}

__device__ inline int target_of(const Joint& J, int b, int u) {
  return u < J.U1 - 1 ? J.targets[(size_t)b * (J.U1 - 1) + u] : 0;  // dummy column: 0
}

// The cells of frames t0..t0+frames of sample b inside its lattice (t <
// t_len, u <= u_len), t-major: cell j -> (t0 + j / n_u, j % n_u).
struct TileRows {
  int t0, n_t, n_u, n;
};

__device__ inline TileRows tile_rows(const Joint& J, const int* t_lens, const int* u_lens, int b,
                                     int t0, int frames) {
  TileRows R;
  R.t0 = t0;
  const int t_hi = min(min(t0 + frames, t_lens[b]), J.T);
  R.n_t = max(0, t_hi - t0);
  R.n_u = max(0, min(u_lens[b], J.U1 - 1) + 1);
  R.n = R.n_t * R.n_u;
  return R;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdLayout {
  int ldh;
  size_t hs, wc, s, rt, ru, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int H) {
  FwdLayout L;
  L.ldh = H + 8;
  size_t off = 0;
  L.hs = off; off = align128(off + sizeof(bf16) * ROWS * L.ldh);
  L.wc = off; off = align128(off + sizeof(bf16) * KC * LDW);
  L.s = off; off = align128(off + sizeof(float) * ROWS * LDS);
  L.rt = off; off = align128(off + sizeof(int) * ROWS);
  L.ru = off; off = align128(off + sizeof(int) * ROWS);
  L.total = off;
  return L;
}

__global__ void __launch_bounds__(NT)
joint_fwd_kernel(Joint J, const int* __restrict__ t_lens, const int* __restrict__ u_lens,
                 float* __restrict__ blank_lp, float* __restrict__ label_lp,
                 float* __restrict__ lse_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout(J.H);
  bf16* Hs = reinterpret_cast<bf16*>(smem + L.hs);
  bf16* Wc = reinterpret_cast<bf16*>(smem + L.wc);
  float* S = reinterpret_cast<float*>(smem + L.s);
  int* rt = reinterpret_cast<int*>(smem + L.rt);
  int* ru = reinterpret_cast<int*>(smem + L.ru);

  const int b = blockIdx.y;
  const int cells = J.T * J.U1;
  const int row0 = blockIdx.x * ROWS;
  // block x also fills the cells [row0, row0 + 64) of the full t-major
  // index that lie outside the lattice, so every output is written once
  const TileRows R = tile_rows(J, t_lens, u_lens, b, 0, J.T);
  for (int r = threadIdx.x; r < ROWS; r += NT) {
    const int i = row0 + r;
    if (i < cells && (i / J.U1 >= R.n_t || i % J.U1 >= R.n_u)) {
      const size_t o = (size_t)b * cells + i;
      blank_lp[o] = label_lp[o] = NEG_INF;
      lse_out[o] = -NEG_INF;
    }
  }
  if (row0 >= R.n) return;  // the whole block: no lattice cell left
  for (int r = threadIdx.x; r < ROWS; r += NT) {
    const int j = row0 + r;
    rt[r] = j < R.n ? j / R.n_u : -1;
    ru[r] = j < R.n ? j % R.n_u : 0;
  }
  __syncthreads();
  build_h(J, b, rt, ru, Hs, L.ldh);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = 16 * warp + (lane >> 1);
  const int half = lane & 1;
  const bool live = rt[r] >= 0;
  const int tgt = target_of(J, b, ru[r]);
  const float blank = blank_logit(J, Hs, L.ldh, r, half);
  float m_run = blank, l_run = 1.f;  // the blank term seeds the running sum
  float label = 0.f;
  for (int c0 = 0; c0 < J.VL; c0 += NC) {
    logits_chunk(J, Hs, L.ldh, Wc, S, c0);
    float v[32];
    float mx = NEG_INF;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int c = c0 + half * 32 + k;
      v[k] = c < J.VL ? label_logit(J, S[r * LDS + half * 32 + k], c) : NEG_INF;
      mx = fmaxf(mx, v[k]);
      if (c == tgt) label = v[k];
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (c0 + half * 32 + k < J.VL) sum += expf(v[k] - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * expf(m_run - m_new) + sum;
    m_run = m_new;
  }
  // the target column lies in one lane of the pair; the other holds 0
  label += __shfl_xor_sync(0xffffffffu, label, 1);
  if (live && half == 0) {
    const size_t o = ((size_t)b * J.T + rt[r]) * J.U1 + ru[r];
    const float lse = m_run + logf(l_run);
    blank_lp[o] = blank - lse;
    label_lp[o] = label - lse;
    lse_out[o] = lse;
  }
}

// ---------------------------------------------------------------------------
// backward: shared pieces
// ---------------------------------------------------------------------------

// Per-row cotangent inputs of a 64-row chunk.
struct RowMeta {
  int* rt;
  int* ru;
  int* tgt;
  float* lse;
  float* total;
  float* gb;
  float* gy;
  float* dblank;
};

__device__ void load_meta(const Joint& J, const TileRows& R, int b, int j0, const float* lse,
                          const float* total, const float* gb, const float* gy, RowMeta& M) {
  for (int r = threadIdx.x; r < ROWS; r += NT) {
    const int j = j0 + r;
    if (j < R.n) {
      const int t = R.t0 + j / R.n_u, u = j % R.n_u;
      const size_t o = ((size_t)b * J.T + t) * J.U1 + u;
      M.rt[r] = t;
      M.ru[r] = u;
      M.tgt[r] = target_of(J, b, u);
      M.lse[r] = lse[o];
      M.total[r] = total[o];
      M.gb[r] = gb[o];
      M.gy[r] = gy[o];
    } else {
      M.rt[r] = -1;
      M.ru[r] = 0;
      M.tgt[r] = -1;
      M.lse[r] = 0.f;
      M.total[r] = M.gb[r] = M.gy[r] = 0.f;
    }
  }
}

__device__ inline float clamp_g(float x, float clamp, float g) {
  if (clamp > 0.f) x = fminf(fmaxf(x, -clamp), clamp);
  return x * g;
}

// dlab of the 64 x 64 chunk in S (logit accumulators in, dlab fp32 out), for
// the rows of this warp; rows that are empty give 0.
__device__ void dlab_chunk(const Joint& J, float* S, const RowMeta& M, int c0, float clamp,
                           float g) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = 16 * warp + (lane >> 1);
  const int half = lane & 1;
  const bool live = M.rt[r] >= 0;
  for (int k = 0; k < 32; ++k) {
    const int cc = half * 32 + k, c = c0 + cc;
    float d = 0.f;
    if (live && c < J.VL) {
      const float lab = label_logit(J, S[r * LDS + cc], c);
      d = expf(lab - M.lse[r]) * M.total[r] - (c == M.tgt[r] ? M.gy[r] : 0.f);
      d = clamp_g(d, clamp, g);
    }
    S[r * LDS + cc] = d;
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// backward (dx): de, dp partials, db and dW[:, VL] partials
// ---------------------------------------------------------------------------

struct DxLayout {
  int ldh, ldl, vlp;
  size_t hs, wc, s, dl, dx, de, dbl, dwb, meta, total;
};

__host__ __device__ inline DxLayout dx_layout(int H, int VL) {
  DxLayout L;
  L.ldh = H + 8;
  L.vlp = round64(VL);
  L.ldl = L.vlp + 8;
  size_t off = 0;
  L.hs = off; off = align128(off + sizeof(bf16) * ROWS * L.ldh);
  L.wc = off; off = align128(off + sizeof(bf16) * KC * LDW);
  L.s = off; off = align128(off + sizeof(float) * ROWS * LDS);
  L.dl = off; off = align128(off + sizeof(bf16) * ROWS * L.ldl);
  L.dx = off; off = align128(off + sizeof(bf16) * ROWS * LDW);
  L.de = off; off = align128(off + sizeof(float) * TB * H);
  L.dbl = off; off = align128(off + sizeof(float) * L.vlp);
  L.dwb = off; off = align128(off + sizeof(float) * H);
  L.meta = off; off = align128(off + sizeof(float) * ROWS * 8);
  L.total = off;
  return L;
}

__device__ inline RowMeta meta_at(unsigned char* p) {
  RowMeta M;
  M.rt = reinterpret_cast<int*>(p);
  M.ru = M.rt + ROWS;
  M.tgt = M.ru + ROWS;
  M.lse = reinterpret_cast<float*>(M.tgt + ROWS);
  M.total = M.lse + ROWS;
  M.gb = M.total + ROWS;
  M.gy = M.gb + ROWS;
  M.dblank = M.gy + ROWS;
  return M;
}

__global__ void __launch_bounds__(NT)
joint_bwd_dx_kernel(Joint J, const int* __restrict__ t_lens, const int* __restrict__ u_lens,
                    const float* __restrict__ lse, const float* __restrict__ total,
                    const float* __restrict__ gb, const float* __restrict__ gy,
                    const float* __restrict__ g, float clamp, bf16* __restrict__ de,
                    float* __restrict__ dp_part, float* __restrict__ dw_part,
                    float* __restrict__ dbl_part, float* __restrict__ dwb_part,
                    float* __restrict__ dbb_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DxLayout L = dx_layout(J.H, J.VL);
  bf16* Hs = reinterpret_cast<bf16*>(smem + L.hs);
  bf16* Wc = reinterpret_cast<bf16*>(smem + L.wc);
  float* S = reinterpret_cast<float*>(smem + L.s);
  bf16* Dl = reinterpret_cast<bf16*>(smem + L.dl);
  bf16* DX = reinterpret_cast<bf16*>(smem + L.dx);
  float* de_acc = reinterpret_cast<float*>(smem + L.de);
  float* dbl_acc = reinterpret_cast<float*>(smem + L.dbl);
  float* dwb_acc = reinterpret_cast<float*>(smem + L.dwb);
  RowMeta M = meta_at(smem + L.meta);

  const int tile = blockIdx.x, b = blockIdx.y, n_tiles = gridDim.x;
  const int blk = b * n_tiles + tile;
  const TileRows R = tile_rows(J, t_lens, u_lens, b, tile * TB, TB);
  const float gg = g[b];
  float* dp_slice = dp_part + (size_t)blk * J.U1 * J.H;
  float* dw_slice = dw_part + (size_t)blk * J.H * L.vlp;  // [H][vlp]
  for (int i = threadIdx.x; i < J.U1 * J.H; i += NT) dp_slice[i] = 0.f;
  for (int i = threadIdx.x; i < TB * J.H; i += NT) de_acc[i] = 0.f;
  for (int i = threadIdx.x; i < L.vlp; i += NT) dbl_acc[i] = 0.f;
  for (int i = threadIdx.x; i < J.H; i += NT) dwb_acc[i] = 0.f;
  float dbb = 0.f;  // thread 0's running sum
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = 16 * warp + (lane >> 1);
  const int half = lane & 1;

  for (int j0 = 0; j0 < R.n; j0 += ROWS) {
    __syncthreads();  // the previous chunk is done with every buffer
    load_meta(J, R, b, j0, lse, total, gb, gy, M);
    __syncthreads();
    build_h(J, b, M.rt, M.ru, Hs, L.ldh);
    __syncthreads();
    {
      const float blank = blank_logit(J, Hs, L.ldh, r, half);
      float d = 0.f;
      if (M.rt[r] >= 0)
        d = clamp_g(expf(blank - M.lse[r]) * M.total[r] - M.gb[r], clamp, gg);
      if (half == 0) M.dblank[r] = d;
    }
    // dlab, chunk by chunk, into Dl (bf16) and the db partial (fp32)
    for (int c0 = 0; c0 < L.vlp; c0 += NC) {
      logits_chunk(J, Hs, L.ldh, Wc, S, c0);
      dlab_chunk(J, S, M, c0, clamp, gg);
      __syncthreads();
      for (int idx = threadIdx.x; idx < ROWS * NC; idx += NT) {
        const int rr = idx / NC, cc = idx % NC;
        Dl[rr * L.ldl + c0 + cc] = __float2bfloat16(S[rr * LDS + cc]);
      }
      if (threadIdx.x < NC) {
        float s = 0.f;
        for (int rr = 0; rr < ROWS; ++rr) s += S[rr * LDS + threadIdx.x];
        dbl_acc[c0 + threadIdx.x] += s;
      }
    }
    __syncthreads();
    // dW[:, VL] and db[VL] partials
    for (int h = threadIdx.x; h < J.H; h += NT) {
      float s = 0.f;
      for (int rr = 0; rr < ROWS; ++rr) s += __bfloat162float(Hs[rr * L.ldh + h]) * M.dblank[rr];
      dwb_acc[h] += s;
    }
    if (threadIdx.x == 0)
      for (int rr = 0; rr < ROWS; ++rr) dbb += M.dblank[rr];
    // dW_lab slice += Hs^T Dl: each warp reads, adds to and writes back its
    // own 16 x 16 tiles (the same tiles every chunk); the first chunk starts
    // from zero
    for (int tile_i = warp; tile_i < (J.H / 16) * (L.vlp / 16); tile_i += NT / 32) {
      const int i = tile_i / (L.vlp / 16), j = tile_i % (L.vlp / 16);
      float* out = dw_slice + (size_t)(16 * i) * L.vlp + 16 * j;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      if (j0 == 0) wmma::fill_fragment(acc, 0.f);
      else wmma::load_matrix_sync(acc, out, L.vlp, wmma::mem_row_major);
#pragma unroll
      for (int k = 0; k < ROWS / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(a, Hs + (16 * k) * L.ldh + 16 * i, L.ldh);
        wmma::load_matrix_sync(bfr, Dl + (16 * k) * L.ldl + 16 * j, L.ldl);
        wmma::mma_sync(acc, a, bfr, acc);
      }
      wmma::store_matrix_sync(out, acc, L.vlp, wmma::mem_row_major);
    }

    // dh = Dl @ W_lab^T, 64 hidden columns at a time, then dx
    for (int h0 = 0; h0 < J.H; h0 += NC) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
      for (int c0 = 0; c0 < L.vlp; c0 += KC) {
        __syncthreads();
        // piece [c][h] = W[h0 + h, c0 + c]: W_lab^T, zero past VL and H
        for (int idx = threadIdx.x; idx < KC * NC; idx += NT) {
          const int kk = idx / NC, hh = idx % NC;
          const int c = c0 + kk, h = h0 + hh;
          Wc[kk * LDW + hh] = (c < J.VL && h < J.H) ? J.w[(size_t)h * J.V + c]
                                                     : __float2bfloat16(0.f);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, Dl + (16 * warp) * L.ldl + c0 + kk * 16, L.ldl);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
            wmma::load_matrix_sync(bfr, Wc + (kk * 16) * LDW + 16 * j, LDW);
            wmma::mma_sync(acc[j], a, bfr, acc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(S + (16 * warp) * LDS + 16 * j, acc[j], LDS,
                                wmma::mem_row_major);
      __syncthreads();
      for (int idx = threadIdx.x; idx < ROWS * NC; idx += NT) {
        const int rr = idx / NC, hh = idx % NC, h = h0 + hh;
        const int t = M.rt[rr], u = M.ru[rr];
        float dx = 0.f;
        if (t >= 0 && h < J.H) {
          float dh = rb(S[rr * LDS + hh] +
                        M.dblank[rr] * __bfloat162float(J.w[(size_t)h * J.V + J.VL]));
          if (J.drop_t > 0) dh = keep_elem(J, b, t, u, h) ? rb(dh * J.inv_keep) : 0.f;
          const float x = pre_act(J, b, t, u, h);
          dx = rb(dh * act_grad(x, act_fn(x, J.act), J.act));
        }
        DX[rr * LDW + hh] = __float2bfloat16(dx);
      }
      __syncthreads();
      // de (shared memory) and dp (this block's slice): one thread per
      // column, rows in order
      const int hh = threadIdx.x % NC, h = h0 + hh;
      if (h < J.H) {
        if (threadIdx.x < NC) {
          for (int rr = 0; rr < ROWS; ++rr)
            if (M.rt[rr] >= 0)
              de_acc[(M.rt[rr] - R.t0) * J.H + h] += __bfloat162float(DX[rr * LDW + hh]);
        } else {
          for (int rr = 0; rr < ROWS; ++rr)
            if (M.rt[rr] >= 0)
              dp_slice[(size_t)M.ru[rr] * J.H + h] += __bfloat162float(DX[rr * LDW + hh]);
        }
      }
    }
  }
  __syncthreads();
  if (R.n == 0)  // no cell in the lattice: the slice is zero
    for (size_t i = threadIdx.x; i < (size_t)J.H * L.vlp; i += NT) dw_slice[i] = 0.f;
  for (int i = threadIdx.x; i < TB * J.H; i += NT) {
    const int t = R.t0 + i / J.H;
    if (t < J.T) de[((size_t)b * J.T + t) * J.H + i % J.H] = __float2bfloat16(de_acc[i]);
  }
  for (int i = threadIdx.x; i < J.VL; i += NT) dbl_part[(size_t)blk * J.VL + i] = dbl_acc[i];
  for (int i = threadIdx.x; i < J.H; i += NT) dwb_part[(size_t)blk * J.H + i] = dwb_acc[i];
  if (threadIdx.x == 0) dbb_part[blk] = dbb;
}

// ---------------------------------------------------------------------------
// backward (reduce): dW [H, V], db [V], dp [B, U1, H], fp32
// ---------------------------------------------------------------------------

__global__ void joint_bwd_reduce_kernel(int B, int U1, int H, int V, int n_tiles,
                                        const float* __restrict__ dw_part,
                                        const float* __restrict__ dp_part,
                                        const float* __restrict__ dbl_part,
                                        const float* __restrict__ dwb_part,
                                        const float* __restrict__ dbb_part,
                                        float* __restrict__ dw, float* __restrict__ db,
                                        float* __restrict__ dp) {
  const int VL = V - 1, vlp = round64(VL);
  const long long n_dw = (long long)H * V, n_db = V, n_dp = (long long)B * U1 * H;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int n_blk = B * n_tiles;
  if (i < n_dw) {
    const int h = (int)(i / V), c = (int)(i % V);
    float s = 0.f;
    if (c < VL) {
      for (int k = 0; k < n_blk; ++k) s += dw_part[((size_t)k * H + h) * vlp + c];
    } else {
      for (int k = 0; k < n_blk; ++k) s += dwb_part[(size_t)k * H + h];
    }
    dw[i] = s;
  } else if (i < n_dw + n_db) {
    const int c = (int)(i - n_dw);
    float s = 0.f;
    if (c < VL) {
      for (int k = 0; k < n_blk; ++k) s += dbl_part[(size_t)k * VL + c];
    } else {
      for (int k = 0; k < n_blk; ++k) s += dbb_part[k];
    }
    db[c] = s;
  } else if (i < n_dw + n_db + n_dp) {
    const long long j = i - n_dw - n_db;
    const int b = (int)(j / ((long long)U1 * H));
    const long long uh = j % ((long long)U1 * H);
    float s = 0.f;
    for (int tile = 0; tile < n_tiles; ++tile)
      s += dp_part[((size_t)b * n_tiles + tile) * U1 * H + uh];
    dp[j] = s;
  }
}

Joint make_joint(const void* e, const void* p, const void* w, const void* bias,
                 const void* targets, int B, int T, int U1, int H, int V, int Tp, int act,
                 int drop_t, int seed) {
  Joint J;
  J.e = (const bf16*)e;
  J.p = (const bf16*)p;
  J.w = (const bf16*)w;
  J.bias = (const bf16*)bias;
  J.targets = (const int*)targets;
  J.B = B; J.T = T; J.U1 = U1; J.H = H; J.V = V; J.VL = V - 1; J.Tp = Tp;
  J.act = act;
  J.drop_t = drop_t;
  J.seed = (uint32_t)seed;
  J.inv_keep = drop_t > 0 ? (float)(1.0 / (1.0 - drop_t / 256.0)) : 1.f;
  return J;
}

}  // namespace

// Bytes of shared memory the forward (which = 0) or backward (1) kernel needs.
extern "C" long long rnnt_joint_smem_bytes(int H, int V, int which) {
  return (long long)(which == 0 ? fwd_layout(H).total : dx_layout(H, V - 1).total);
}

// Frames per backward tile.
extern "C" int rnnt_joint_frames_per_tile() { return TB; }

// e: [b, t, h], p: [b, u1, h], w: [h, v], bias: [v] bf16; targets: [b, u1-1],
// t_lens, u_lens: [b] int32; blank_lp, label_lp, lse: [b, t, u1] fp32 (-1e30,
// -1e30 and 1e30 outside each lattice). All contiguous; h a multiple of 16. tp: the dropout layout's padded t; act 0 relu, 1 sigmoid,
// 2 tanh; drop_t 0 disables dropout. Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int rnnt_joint_fwd_bf16(const void* e, const void* p, const void* w, const void* bias,
                                   const void* targets, const void* t_lens, const void* u_lens,
                                   void* blank_lp, void* label_lp, void* lse, int b, int t, int u1,
                                   int h, int v, int tp, int act, int drop_t, int seed,
                                   void* stream) {
  const Joint J = make_joint(e, p, w, bias, targets, b, t, u1, h, v, tp, act, drop_t, seed);
  const size_t smem = fwd_layout(h).total;
  cudaError_t err = cudaFuncSetAttribute(joint_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((size_t)t * u1 + ROWS - 1) / ROWS, b);
  joint_fwd_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      J, (const int*)t_lens, (const int*)u_lens, (float*)blank_lp, (float*)label_lp, (float*)lse);
  return (int)cudaGetLastError();
}

// The backward kernel: as the forward's inputs plus t_lens, u_lens [b]
// int32; lse, total, gb, gy [b, t, u1] fp32 (posteriors zero outside the
// lattice); g [b] fp32. Writes de [b, t, h] bf16 and the partials dp_part
// [b * n_tiles, u1, h], dw_part [b * n_tiles, h, round64(v-1)], dbl_part
// [b * n_tiles, v-1], dwb_part [b * n_tiles, h], dbb_part [b * n_tiles] fp32,
// n_tiles = ceil(t / 16).
extern "C" int rnnt_joint_bwd_dx_bf16(const void* e, const void* p, const void* w,
                                      const void* bias, const void* targets, const void* t_lens,
                                      const void* u_lens, const void* lse, const void* total,
                                      const void* gb, const void* gy, const void* g, void* de,
                                      void* dp_part, void* dw_part, void* dbl_part,
                                      void* dwb_part, void* dbb_part, int b, int t, int u1, int h,
                                      int v, int tp,
                                      int act, int drop_t, int seed, float clamp, void* stream) {
  const Joint J = make_joint(e, p, w, bias, targets, b, t, u1, h, v, tp, act, drop_t, seed);
  const size_t smem = dx_layout(h, v - 1).total;
  cudaError_t err = cudaFuncSetAttribute(joint_bwd_dx_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + TB - 1) / TB, b);
  joint_bwd_dx_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      J, (const int*)t_lens, (const int*)u_lens, (const float*)lse, (const float*)total,
      (const float*)gb, (const float*)gy, (const float*)g, clamp, (bf16*)de, (float*)dp_part,
      (float*)dw_part, (float*)dbl_part, (float*)dwb_part, (float*)dbb_part);
  return (int)cudaGetLastError();
}

// The reduce kernel: dw [h, v], db [v], dp [b, u1, h] fp32 from the partials.
extern "C" int rnnt_joint_bwd_reduce_f32(const void* dw_part, const void* dp_part,
                                         const void* dbl_part, const void* dwb_part,
                                         const void* dbb_part, void* dw, void* db, void* dp,
                                         int b, int t, int u1, int h, int v, void* stream) {
  const long long n = (long long)h * v + v + (long long)b * u1 * h;
  const int threads = 256;
  joint_bwd_reduce_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                            (cudaStream_t)stream>>>(
      b, u1, h, v, (t + TB - 1) / TB, (const float*)dw_part, (const float*)dp_part,
      (const float*)dbl_part, (const float*)dwb_part, (const float*)dbb_part, (float*)dw,
      (float*)db, (float*)dp);
  return (int)cudaGetLastError();
}
