// RNN-T flash joint (K4) in fp32 for NVIDIA Hopper (sm_90a): the forward,
// the backward's cells kernel and its dW product on the CUDA cores (fp32
// fused multiply-add), plain C interface. The same semantics, lattice
// numbering, windows, scratch layout and fixed-order sums as rnnt_joint.cu
// (whose header states them), with fp32 everywhere the 16-bit kernels round
// to their dtype: the rounding points of the TPU kernel are identities here.
//
// Replaces the TPU kernels `_make_fwd_kernel` and `_make_bwd_kernel` of
// conformer_nemo_tpu/ops/pallas/rnnt_joint_kernel.py (via `joint_flash_fwd`
// :326 -> pallas_call :344 and `joint_flash_bwd` :372 -> pallas_call :393)
// where the compute dtype is fp32.
//
// Why not the tensor cores: one TF32 pass rounds each operand to 10 bits of
// mantissa, about 1e-3 off the fp32 product (measured on K2), and the plain
// version is held to 2e-5 of its largest entry. Bound on an H100: the same
// three products per lattice cell as the 16-bit kernels (2 * cells * H * VL
// FLOPs each) at 67 TFLOP/s of fp32 FMA.
//
// Design (every kernel: 256 threads, eight warps; a warp holds 8 rows of
// its tile and its lanes 4 columns each, so that the rows' operand is one
// broadcast per step and the columns' one 512-byte read):
//   * forward: one block per tile of 64 lattice cells (the grid covers
//     B * T * U+1 cells, so the lattice's count stays on the card; a block
//     past it only writes its share of the sentinels). The logits in chunks
//     of 128 columns (the blank, column VL of W, joins them), each over
//     16-unit slices of H: the slice's h is built in shared memory from e
//     and p (hash dropout included) while W's slice arrives by cp.async
//     into the other half of a two-stage ring. h is rebuilt per chunk rather
//     than kept: a [64 x H] fp32 tile would not fit beside the ring past H
//     800, and the hash costs about a fifth of a chunk's multiply-adds. The
//     online max and sum run per row across the warp's lanes.
//   * cells: per 64 cells of a window and per pass of 128 label columns, the
//     logits as the forward's (in pass 0 the slice loop also writes h and
//     act' to the window's scratch and forms the blank's dot), dlab into
//     shared memory (column-major, the next product's operand) and the
//     window's scratch, the db partials in a fixed order; then dh = dlab
//     W_lab^T by hidden chunks of 128 with W_lab^T (a [VLp, H] copy the
//     wrapper makes) streaming through the ring; the last pass adds dblank
//     w_blank, applies the dropout scale and act' (read back from the dx
//     scratch), and writes dx in act''s place; dh waits in fp32 scratch
//     between passes, added in pass order. Shared memory does not grow with
//     H: every H the wrappers take runs.
//   * sums: dW_lab = h^T dlab as the split-K product of rnnt_joint.cu over
//     the same KSPLIT splits, each block 64 hidden rows x 128 columns;
//     dW[:, VL] one thread a hidden row, cells in order; de, dp and db as
//     every dtype's (rnnt_joint_common.cuh).
//   * reduce: rnnt_joint_common.cuh's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rnnt_joint_common.cuh"
#include "tensor_core.cuh"

using namespace rj;
using namespace tc;

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 64;  // lattice cells per tile (= BROWS)
constexpr int CH = 128;   // columns per forward chunk and per backward pass
constexpr int KS = 16;    // depth of a slice
constexpr int TR = 8;     // rows per thread (a warp's rows)
constexpr int TCW = 4;    // columns per thread
constexpr int HCB = 64;   // hidden rows per dW block
static_assert(ROWS == BROWS && ROWS == 8 * TR && CH == 32 * TCW && THREADS == 256, "tiling");

// rows [r0, r0 + nr) x columns [c0, c0 + ncol) of an fp32 [.., ld_g] array
// into smem [nr][ld_s] by 16-byte cp.async (ncol, c0 and ld_g multiples of
// 4); entries past row rmax or column cmax are zero.
__device__ inline void stage(float* s, int ld_s, const float* g, int ld_g, int r0, int nr,
                             int rmax, int c0, int ncol, int cmax) {
  const int vec = ncol / 4;
  for (int i = threadIdx.x; i < nr * vec; i += THREADS) {
    const int r = i / vec, c = (i % vec) * 4;
    float* dst = s + (size_t)r * ld_s + c;
    if (r0 + r < rmax && c0 + c < cmax) cp_async16(dst, g + (size_t)(r0 + r) * ld_g + c0 + c);
    else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// acc[i][j] += A[k][8 rg + i] * B[k][4 cg + j] over the k < n of one slice
// (A [..][ROWS], B [..][CH] in shared memory)
__device__ inline void fma_slice(float (&acc)[TR][TCW], const float* A, const float* B, int n,
                                 int rg, int cg) {
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + k * ROWS + TR * rg);
    const float4 a1 = *reinterpret_cast<const float4*>(A + k * ROWS + TR * rg + 4);
    const float4 b = *reinterpret_cast<const float4*>(B + k * CH + TCW * cg);
    const float a[TR] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bb[TCW] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TCW; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

struct TileMeta {
  int b[ROWS], t[ROWS], u[ROWS], tgt[ROWS];
  float lse[ROWS], total[ROWS], gb[ROWS], gy[ROWS], g[ROWS], dblank[ROWS];
  float lab[ROWS], blank[ROWS];
};

// The hidden slice [k0, k0 + KS) of the tile's rows into Hs [KS][ROWS]
// (zero rows past the lattice); with `scratch`, the slice's h and act' also
// into the window's h and dx rows of the tile's live rows.
__device__ inline void build_slice(const Joint<F32>& J, const TileMeta& M, float* Hs, int k0,
                                   float* h_row0, float* g_row0, int rows) {
  const int r = threadIdx.x % ROWS, q = threadIdx.x / ROWS;  // units k0 + 4q .. k0 + 4q + 3
  const int k = k0 + 4 * q;
  float h[4] = {0.f, 0.f, 0.f, 0.f}, g[4] = {0.f, 0.f, 0.f, 0.f};
  if (M.b[r] >= 0) {
    const float4 e = __ldg(reinterpret_cast<const float4*>(
        J.e + ((size_t)M.b[r] * J.T + M.t[r]) * J.H + k));
    const float4 p = __ldg(reinterpret_cast<const float4*>(
        J.p + ((size_t)M.b[r] * J.U1 + M.u[r]) * J.H + k));
    const float x[4] = {e.x + p.x, e.y + p.y, e.z + p.z, e.w + p.w};
    const uint32_t row = hash_row(J, M.b[r], M.t[r], M.u[r]);
#pragma unroll
    for (int i = 0; i < 4; ++i) hidden_unit(J, x[i], row, k + i, h[i], g[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) Hs[(4 * q + i) * ROWS + r] = h[i];
  if (h_row0 != nullptr && r < rows) {
    *reinterpret_cast<float4*>(h_row0 + (size_t)r * J.H + k) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(g_row0 + (size_t)r * J.H + k) = make_float4(g[0], g[1], g[2], g[3]);
  }
}

__device__ inline void tile_cells(const Joint<F32>& J, TileMeta& M, long long tile0, int rows) {
  if (threadIdx.x < ROWS) {
    const int r = threadIdx.x;
    int b = -1, t = 0, u = 0;
    if (r < rows) cell_btu(J, tile0 + r, b, t, u);
    M.b[r] = b;
    M.t[r] = t;
    M.u[r] = u;
    M.tgt[r] = b >= 0 ? target_of(J, b, u) : -1;
    M.lab[r] = M.blank[r] = 0.f;
  }
}

// The logits of the tile's rows at columns [c0, c0 + CH) of w ([H, ldw],
// zero-padded past cmax): acc over every hidden slice, h built per slice;
// with h_scr / g_scr (the backward's first pass) h and act' also into the
// window's scratch, and each row's dot with w_blank into blank_acc.
__device__ inline void logits_chunk(const Joint<F32>& J, const TileMeta& M, float* Hs, float* Ws,
                                    const float* w, int ldw, int c0, int cmax,
                                    float (&acc)[TR][TCW], float* h_scr, float* g_scr, int rows,
                                    const float* w_blank, float& blank_acc) {
  const int rg = threadIdx.x / 32, cg = threadIdx.x % 32;
  const int n_sl = J.H / KS;
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TCW; ++j) acc[i][j] = 0.f;
  stage(Ws, CH, w, ldw, 0, KS, J.H, c0, CH, cmax);
  cp_commit();
  build_slice(J, M, Hs, 0, h_scr, g_scr, rows);
  for (int s = 0; s < n_sl; ++s) {
    cp_wait<0>();
    __syncthreads();  // slice s is in; every thread is done with slice s - 1
    const int cur = s & 1, nxt = cur ^ 1;
    if (s + 1 < n_sl) {
      stage(Ws + nxt * KS * CH, CH, w, ldw, (s + 1) * KS, KS, J.H, c0, CH, cmax);
      cp_commit();
    }
    const float* A = Hs + cur * KS * ROWS;
    fma_slice(acc, A, Ws + cur * KS * CH, KS, rg, cg);
    if (w_blank != nullptr && threadIdx.x < ROWS)
      for (int k = 0; k < KS; ++k) blank_acc = fmaf(A[k * ROWS + threadIdx.x], w_blank[s * KS + k], blank_acc);
    if (s + 1 < n_sl)
      build_slice(J, M, Hs + nxt * KS * ROWS, (s + 1) * KS, h_scr, g_scr, rows);
  }
  __syncthreads();  // every thread is done with the ring
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
joint_fwd_f32_kernel(Joint<F32> J, const float* __restrict__ w, int vt,
                     float* __restrict__ blank_lp, float* __restrict__ label_lp,
                     float* __restrict__ lse_out) {
  __shared__ __align__(16) float Hs[2 * KS * ROWS];
  __shared__ __align__(16) float Ws[2 * KS * CH];
  __shared__ TileMeta M;
  const long long n_full = (long long)J.B * J.T * J.U1;
  const long long tile0 = (long long)blockIdx.x * ROWS;
  // the sentinels of this block's share of the full [B, T, U1] index
  if (threadIdx.x < ROWS && tile0 + threadIdx.x < n_full) {
    const long long i = tile0 + threadIdx.x;
    const int u = (int)(i % J.U1);
    const long long bt = i / J.U1;
    const Lat la = lat_of(J, (int)(bt / J.T));
    if ((int)(bt % J.T) >= la.n_t || u >= la.n_u) {
      blank_lp[i] = label_lp[i] = NEG_INF;
      lse_out[i] = -NEG_INF;
    }
  }
  const long long n_all = J.off[J.B];
  if (tile0 >= n_all) return;
  const int rows = (int)min((long long)ROWS, n_all - tile0);
  tile_cells(J, M, tile0, rows);
  __syncthreads();

  const int rg = threadIdx.x / 32, cg = threadIdx.x % 32;
  float m_run[TR], l_run[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
  }
  float unused = 0.f;
  for (int c0 = 0; c0 < J.V; c0 += CH) {
    float acc[TR][TCW];
    logits_chunk(J, M, Hs, Ws, w, vt, c0, vt, acc, nullptr, nullptr, rows, nullptr, unused);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = TR * rg + i;
      float x[TCW], mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TCW; ++j) {
        const int c = c0 + TCW * cg + j;
        x[j] = NEG_INF;
        if (c < J.V) {
          x[j] = acc[i][j] + J.bias[c];
          if (c == M.tgt[r]) M.lab[r] = x[j];
          if (c == J.VL) M.blank[r] = x[j];
        }
        mx = fmaxf(mx, x[j]);
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[i], mx);
      float s = l_run[i] * expf(m_run[i] - m_new);
#pragma unroll
      for (int j = 0; j < TCW; ++j)
        if (c0 + TCW * cg + j < J.V) s += expf(x[j] - m_new);
      l_run[i] = s;
      m_run[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], o);
  __syncthreads();  // the label and blank logits are in
  if (cg < TR) {
    float m = 0.f, l = 0.f;
#pragma unroll
    for (int i = 0; i < TR; ++i)
      if (i == cg) {
        m = m_run[i];
        l = l_run[i];
      }
    const int r = TR * rg + cg;
    if (M.b[r] >= 0) {
      const float lse = m + logf(l);
      const size_t o = ((size_t)M.b[r] * J.T + M.t[r]) * J.U1 + M.u[r];
      blank_lp[o] = M.blank[r] - lse;
      label_lp[o] = M.lab[r] - lse;
      lse_out[o] = lse;
    }
  }
}

// ---------------------------------------------------------------------------
// backward (cells)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
joint_bwd_cells_f32_kernel(Joint<F32> J, const float* __restrict__ w_pad,
                           const float* __restrict__ wt, const float* __restrict__ w_blank,
                           int VLp, const float* __restrict__ lse,
                           const float* __restrict__ total, const float* __restrict__ gb,
                           const float* __restrict__ gy, const float* __restrict__ g, float clamp,
                           long long c0, int win, float* __restrict__ dlab_out,
                           float* __restrict__ dblank_out, float* __restrict__ dx_out,
                           float* __restrict__ h_out, float* __restrict__ dbl_part,
                           float* __restrict__ dh_part) {
  extern __shared__ float4 smem_f4[];  // past the 48 KB of static shared memory
  float* Hs = reinterpret_cast<float*>(smem_f4);  // [2][KS][ROWS]
  float* Ws = Hs + 2 * KS * ROWS;                 // [2][KS][CH]
  float* DlT = Ws + 2 * KS * CH;                  // dlab of the pass, [column][row]
  float* dbw = DlT + CH * ROWS;                   // [8][CH]
  TileMeta& M = *reinterpret_cast<TileMeta*>(dbw + 8 * CH);
  const long long n_all = J.off[J.B];
  const long long tile0 = c0 + (long long)blockIdx.x * ROWS;
  if (tile0 >= n_all || (long long)blockIdx.x * ROWS >= win) return;
  const int rows = (int)min((long long)ROWS, n_all - tile0);
  const size_t row0 = (size_t)(tile0 - c0);
  const int rg = threadIdx.x / 32, cg = threadIdx.x % 32;
  const int H = J.H, VL = J.VL;
  tile_cells(J, M, tile0, rows);
  if (threadIdx.x < ROWS) {
    const int r = threadIdx.x, b = M.b[r];
    if (b >= 0) {
      const size_t o = ((size_t)b * J.T + M.t[r]) * J.U1 + M.u[r];
      M.lse[r] = lse[o];
      M.total[r] = total[o];
      M.gb[r] = gb[o];
      M.gy[r] = gy[o];
      M.g[r] = g[b];
    } else {
      M.lse[r] = M.total[r] = M.gb[r] = M.gy[r] = M.g[r] = 0.f;
    }
  }
  __syncthreads();

  const int n_pass = (VLp + CH - 1) / CH;
  float* dbl_row = dbl_part + (row0 / ROWS) * (size_t)(VL + 1);
  for (int pass = 0; pass < n_pass; ++pass) {
    const int p0 = pass * CH, PW = min(CH, VLp - p0);
    const bool last = pass == n_pass - 1;
    float acc[TR][TCW], blank_acc = 0.f;
    logits_chunk(J, M, Hs, Ws, w_pad, VLp, p0, p0 + PW, acc,
                 pass == 0 ? h_out + row0 * H : nullptr, dx_out + row0 * H, rows,
                 pass == 0 ? w_blank : nullptr, blank_acc);
    if (pass == 0 && threadIdx.x < ROWS) {
      const int r = threadIdx.x;
      float d = 0.f;
      if (M.b[r] >= 0) {
        const float blank = blank_acc + J.bias[VL];
        d = clamp_g(expf(blank - M.lse[r]) * M.total[r] - M.gb[r], clamp, M.g[r]);
        dblank_out[row0 + r] = d;
      }
      M.dblank[r] = d;
    }
    // dlab = clamp(softmax * total - gy 1[tgt]) * g: DlT, the scratch, db
    float colsum[TCW] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = TR * rg + i;
      float d[TCW];
#pragma unroll
      for (int j = 0; j < TCW; ++j) {
        const int c = p0 + TCW * cg + j;
        float x = 0.f;
        if (M.b[r] >= 0 && c < VL) {
          x = expf(acc[i][j] + J.bias[c] - M.lse[r]) * M.total[r] -
              (c == M.tgt[r] ? M.gy[r] : 0.f);
          x = clamp_g(x, clamp, M.g[r]);
        }
        d[j] = x;
        colsum[j] += x;
        DlT[(TCW * cg + j) * ROWS + r] = x;
      }
      if (r < rows && TCW * cg < PW)
        *reinterpret_cast<float4*>(dlab_out + (row0 + r) * VLp + p0 + TCW * cg) =
            make_float4(d[0], d[1], d[2], d[3]);
    }
#pragma unroll
    for (int j = 0; j < TCW; ++j) dbw[rg * CH + TCW * cg + j] = colsum[j];
    __syncthreads();
    for (int c = threadIdx.x; c < min(PW, VL - p0); c += THREADS) {
      float s = 0.f;
      for (int k = 0; k < 8; ++k) s += dbw[k * CH + c];
      dbl_row[p0 + c] = s;
    }
    if (pass == 0 && threadIdx.x == 0) {
      float s = 0.f;
      for (int r = 0; r < ROWS; ++r) s += M.dblank[r];
      dbl_row[VL] = s;
    }

    // dh += dlab W_lab[:, p0 : p0 + PW]^T by chunks of 128 hidden units; the
    // last pass adds dblank w_blank, the dropout scale and act' (dx in its place)
    for (int hc = 0; hc < H; hc += CH) {
      float acc2[TR][TCW];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TCW; ++j) acc2[i][j] = 0.f;
      const int n_sl = PW / KS;
      stage(Ws, CH, wt, H, p0, KS, VLp, hc, CH, H);
      cp_commit();
      for (int s = 0; s < n_sl; ++s) {
        cp_wait<0>();
        __syncthreads();
        if (s + 1 < n_sl) {
          stage(Ws + ((s + 1) & 1) * KS * CH, CH, wt, H, p0 + (s + 1) * KS, KS, VLp, hc, CH, H);
          cp_commit();
        }
        fma_slice(acc2, DlT + s * KS * ROWS, Ws + (s & 1) * KS * CH, KS, rg, cg);
      }
      const int h = hc + TCW * cg;
      if (h < H) {
        const float4 wb = *reinterpret_cast<const float4*>(w_blank + h);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int r = TR * rg + i;
          if (r >= rows) continue;
          float4 sum = make_float4(acc2[i][0], acc2[i][1], acc2[i][2], acc2[i][3]);
          if (n_pass > 1) {
            // the earlier passes' share (this thread wrote it), added in pass order
            float4* part = reinterpret_cast<float4*>(dh_part + (row0 + r) * H + h);
            if (pass > 0) {
              const float4 prev = *part;
              sum = make_float4(prev.x + sum.x, prev.y + sum.y, prev.z + sum.z, prev.w + sum.w);
            }
            if (!last) {
              *part = sum;
              continue;
            }
          }
          float4* gx = reinterpret_cast<float4*>(dx_out + (row0 + r) * H + h);
          const float4 ga = *gx;
          const float db = M.dblank[r], k = J.drop_t > 0 ? J.inv_keep : 1.f;
          *gx = make_float4((sum.x + db * wb.x) * k * ga.x, (sum.y + db * wb.y) * k * ga.y,
                            (sum.z + db * wb.z) * k * ga.z, (sum.w + db * wb.w) * k * ga.w);
        }
      }
      __syncthreads();  // every thread is done with the ring before the next chunk
    }
  }
}

// ---------------------------------------------------------------------------
// backward (sums)
// ---------------------------------------------------------------------------

// dW_lab[hx0 : hx0 + 64, p0 : p0 + 128] over the window's cells [cs, ce)
// (split s), added to dw_part[s]; with p0 = 0 also dW[:, VL] = sum h dblank
// (one thread a hidden row, cells in order) into dwb_part[s].
__device__ void sums_dw_f32(const Joint<F32>& J, int VLp, int cs, int ce, int s, int hx0, int p0,
                            const float* dlab, const float* dblank, const float* hwin,
                            float* dw_part, float* dwb_part) {
  __shared__ __align__(16) float Hc[2 * KS * HCB];
  __shared__ __align__(16) float Dc[2 * KS * CH];
  __shared__ float dbs[2 * KS];
  const int rg = threadIdx.x / 32, cg = threadIdx.x % 32;
  const int H = J.H, n_ch = (ce - cs + KS - 1) / KS;
  auto load = [&](int ch, int st) {
    const int r0 = cs + ch * KS;
    stage(Hc + st * KS * HCB, HCB, hwin, H, r0, KS, ce, hx0, HCB, H);
    stage(Dc + st * KS * CH, CH, dlab, VLp, r0, KS, ce, p0, CH, VLp);
    if (threadIdx.x < KS) dbs[st * KS + threadIdx.x] = r0 + threadIdx.x < ce ? dblank[r0 + threadIdx.x] : 0.f;
  };
  float acc[TR][TCW];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TCW; ++j) acc[i][j] = 0.f;
  float dwb = 0.f;
  load(0, 0);
  cp_commit();
  for (int ch = 0; ch < n_ch; ++ch) {
    cp_wait<0>();
    __syncthreads();
    if (ch + 1 < n_ch) {
      load(ch + 1, (ch + 1) & 1);
      cp_commit();
    }
    const float* A = Hc + (ch & 1) * KS * HCB;
    fma_slice(acc, A, Dc + (ch & 1) * KS * CH, KS, rg, cg);
    if (p0 == 0 && threadIdx.x < HCB)
      for (int k = 0; k < KS; ++k) dwb = fmaf(A[k * HCB + threadIdx.x], dbs[(ch & 1) * KS + k], dwb);
  }
  const int c = p0 + TCW * cg;
  if (c < VLp) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int h = hx0 + TR * rg + i;
      if (h >= H) continue;
      float4* out = reinterpret_cast<float4*>(dw_part + ((size_t)s * H + h) * VLp + c);
      float4 v = *out;
      v.x += acc[i][0];
      v.y += acc[i][1];
      v.z += acc[i][2];
      v.w += acc[i][3];
      *out = v;
    }
  }
  if (p0 == 0 && threadIdx.x < HCB && hx0 + threadIdx.x < H)
    dwb_part[(size_t)s * H + hx0 + threadIdx.x] += dwb;
}

__global__ void __launch_bounds__(THREADS)
joint_bwd_sums_f32_kernel(Joint<F32> J, int VLp, long long c0, int win,
                          const float* __restrict__ dlab, const float* __restrict__ dblank,
                          const float* __restrict__ dx, const float* __restrict__ hwin,
                          const float* __restrict__ dbl_part, float* __restrict__ de_acc,
                          float* __restrict__ dp, float* __restrict__ dw_part,
                          float* __restrict__ dwb_part, float* __restrict__ db_acc) {
  const long long n_all = J.off[J.B];
  if (c0 >= n_all) return;
  const int n_w = (int)min((long long)win, n_all - c0);
  const int n_ht = (J.H + HCB - 1) / HCB, n_cp = (VLp + CH - 1) / CH;
  const int n_dw = KSPLIT * n_ht * n_cp;
  const int bid = blockIdx.x;
  if (bid < n_dw) {
    const int s = bid / (n_ht * n_cp), ht = bid / n_cp % n_ht, cp = bid % n_cp;
    const int per = (((n_w + BROWS - 1) / BROWS + KSPLIT - 1) / KSPLIT) * BROWS;
    const int cs = s * per, ce = min(cs + per, n_w);
    if (cs < ce)
      sums_dw_f32(J, VLp, cs, ce, s, ht * HCB, cp * CH, dlab, dblank, hwin, dw_part, dwb_part);
    return;
  }
  sums_rows(J, bid - n_dw, c0, n_w, dx, dbl_part, de_acc, dp, db_acc);
}

}  // namespace

// The kernels' shared memory is static and does not depend on H or V.
extern "C" long long rnnt_joint_smem_bytes(int H, int V, int which) {
  (void)H;
  (void)V;
  if (which == 0) return (long long)sizeof(float) * 2 * KS * (ROWS + CH) + sizeof(TileMeta);
  if (which == 1)
    return (long long)sizeof(float) * (2 * KS * (ROWS + CH) + CH * ROWS + 8 * CH) +
           sizeof(TileMeta);
  return (long long)sizeof(float) * (2 * KS * (HCB + CH) + 2 * KS);
}

// The forward's tile height (any H).
extern "C" int rnnt_joint_fwd_rows(int H) { return H > 0 ? ROWS : 0; }

extern "C" int rnnt_joint_bwd_tile_cells() { return BROWS; }
extern "C" int rnnt_joint_bwd_ksplit() { return KSPLIT; }
extern "C" int rnnt_joint_bwd_pass_cols() { return CH; }

// As rnnt_joint.cu's rnnt_joint_fwd_bf16, in fp32: w [h, vt] with vt a
// multiple of 4 (16-byte rows). The grid is one block per 64 of the b * t * u1
// cells; `grid` is ignored.
extern "C" int rnnt_joint_fwd_f32(const void* e, const void* p, const void* w, const void* bias,
                                  const void* targets, const void* t_lens, const void* u_lens,
                                  const void* cell_off, void* blank_lp, void* label_lp,
                                  void* lse, int b, int t, int u1, int h, int hh, int v, int vt,
                                  int tp, int act, int drop_t, int seed, int hash_base, int grid,
                                  void* stream) {
  (void)grid;
  const Joint<F32> J = make_joint<F32>(e, p, bias, targets, t_lens, u_lens, cell_off, b, t, u1,
                                       h, hh, v, tp, act, drop_t, seed, hash_base);
  if (!widths_ok(h, hh, v) || vt < v || vt % 4) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)b * t * u1 + ROWS - 1) / ROWS;
  joint_fwd_f32_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      J, (const float*)w, vt, (float*)blank_lp, (float*)label_lp, (float*)lse);
  return (int)cudaGetLastError();
}

// As rnnt_joint.cu's rnnt_joint_bwd_cells_bf16, in fp32, with wt [vlp, h] the
// transpose of w_pad; dh_part holds dh between the passes over a label block
// wider than 128 columns (may be null up to 128).
extern "C" int rnnt_joint_bwd_cells_f32(
    const void* e, const void* p, const void* w_pad, const void* wt, const void* w_blank,
    const void* bias, const void* targets, const void* t_lens, const void* u_lens,
    const void* cell_off, const void* lse, const void* total, const void* gb, const void* gy,
    const void* g, void* dlab, void* dblank, void* dx, void* h_win, void* dbl_part, void* dh_part,
    int b, int t, int u1, int h, int hh, int v, int vlp, int tp, int act, int drop_t, int seed,
    int hash_base, int win, long long c0, float clamp, void* stream) {
  const Joint<F32> J = make_joint<F32>(e, p, bias, targets, t_lens, u_lens, cell_off, b, t, u1,
                                       h, hh, v, tp, act, drop_t, seed, hash_base);
  if (!widths_ok(h, hh, v) || win % ROWS || vlp % 32) return (int)cudaErrorInvalidValue;
  const int smem = (int)rnnt_joint_smem_bytes(h, v, 1);
  cudaError_t err = cudaFuncSetAttribute(joint_bwd_cells_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  joint_bwd_cells_f32_kernel<<<win / ROWS, THREADS, smem, (cudaStream_t)stream>>>(
      J, (const float*)w_pad, (const float*)wt, (const float*)w_blank, vlp, (const float*)lse,
      (const float*)total, (const float*)gb, (const float*)gy, (const float*)g, clamp, c0, win,
      (float*)dlab, (float*)dblank, (float*)dx, (float*)h_win, (float*)dbl_part, (float*)dh_part);
  return (int)cudaGetLastError();
}

// As rnnt_joint.cu's rnnt_joint_bwd_sums_bf16, on the fp32 scratch.
extern "C" int rnnt_joint_bwd_sums_f32(const void* t_lens, const void* u_lens,
                                       const void* cell_off, const void* dlab,
                                       const void* dblank, const void* dx, const void* h_win,
                                       const void* dbl_part, void* de_acc, void* dp,
                                       void* dw_part, void* dwb_part, void* db_acc, int b, int t,
                                       int u1, int h, int v, int vlp, int win, long long c0,
                                       void* stream) {
  const Joint<F32> J = make_joint<F32>(nullptr, nullptr, nullptr, nullptr, t_lens, u_lens,
                                       cell_off, b, t, u1, h, h, v, t, 0, 0, 0, 0);
  const int blocks = (h + HCB - 1) / HCB * KSPLIT * ((vlp + CH - 1) / CH) + b * t + b * u1 + 1;
  joint_bwd_sums_f32_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      J, vlp, c0, win, (const float*)dlab, (const float*)dblank, (const float*)dx,
      (const float*)h_win, (const float*)dbl_part, (float*)de_acc, (float*)dp, (float*)dw_part,
      (float*)dwb_part, (float*)db_acc);
  return (int)cudaGetLastError();
}

// As rnnt_joint.cu's rnnt_joint_bwd_reduce_bf16, writing de in fp32.
extern "C" int rnnt_joint_bwd_reduce_f32(const void* dw_part, const void* dwb_part,
                                         const void* db_acc, const void* de_acc, void* dw,
                                         void* db, void* de, int b, int t, int h, int v, int vlp,
                                         void* stream) {
  return launch_reduce<F32>(dw_part, dwb_part, db_acc, de_acc, dw, db, de, b, t, h, v, vlp,
                            (cudaStream_t)stream);
}
