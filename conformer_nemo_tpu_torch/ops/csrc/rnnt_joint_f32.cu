// RNN-T flash joint (K4) in fp32 for NVIDIA Hopper (sm_90a): the forward,
// the backward's cells kernel and its dW product, plain C interface. The
// same semantics, lattice numbering, windows, scratch layout and fixed-order
// sums as rnnt_joint.cu (whose header states them), with fp32 everywhere the
// 16-bit kernels round to their dtype: the rounding points of the TPU kernel
// are identities here.
//
// Replaces the TPU kernels `_make_fwd_kernel` and `_make_bwd_kernel` of
// conformer_nemo_tpu/ops/pallas/rnnt_joint_kernel.py (via `joint_flash_fwd`
// :326 -> pallas_call :344 and `joint_flash_bwd` :372 -> pallas_call :393)
// where the compute dtype is fp32.
//
// On the CUDA cores (fp32 fused multiply-add). One TF32 pass rounds each
// operand to 10 bits of mantissa, about 1e-3 off the fp32 product, and the
// plain version is held to 2e-5 of its largest entry; dh in 3xTF32
// mma.sync held that limit but made the cells kernel 14% slower than these
// pieces (PERF.md). Bound on an H100: the same three products per lattice
// cell as the 16-bit kernels (2 * cells * H * VL FLOPs each) at 67 TFLOP/s
// of fp32 FMA; the bytes each input and output moves once are far under it.
//
// One chain. Both kernels form each logit as one fmaf chain over the hidden
// units in order from 0.0f, then add the bias (`sweep`, the same device
// code in both): the cells kernel's softmax is normalised by the forward's
// lse, and its blank logit (a chain of its own over w_blank, the same
// operations on the same values) is the forward's column VL bit for bit.
//
// Design (one block an SM, persistent over the lattice's tiles):
//   * a warp owns 8 cells of the tile and builds their h itself, 16 hidden
//     units a slice (a lane: one cell, 4 units: e + p, the activation and
//     the hash dropout) into a double-buffered [16 x 8] slice of its own, so
//     no block barrier stands in the sweep over H; the next slice's e and p
//     are loaded a slice ahead; h is built once a sweep of columns;
//   * W's 16-row slices, up to 320 columns wide, arrive as bulk copies
//     (cp.async.bulk, one row a lane of the issuing warp) in a ring of 4
//     stages waited on mbarriers; each warp hands a stage back through an
//     mbarrier when it is done with it, and the warps take turns refilling,
//     the stage of slice i - 2 at slice i (flash_attention_f32.cu's scheme).
//     The ring runs on across a block's tiles;
//   * the products in 8 x 10 pieces: a lane's 8 cells (a broadcast of two
//     16-byte loads) times its 10 columns (`col_of`: two 16-byte loads and
//     one 8-byte), 80 fmaf chains, 0.225 shared floats an FMA; a sweep
//     covers up to 320 columns, padded to 64 (V 296: 320 columns, one
//     sweep). Narrower sweeps are instances of the same template;
//   * forward: 12 warps, 96-cell tiles (168 registers a thread; more warps
//     hide the loads' and the waits' latency that 8 leave bare); every
//     column of V in sweeps of 320 (the blank, column VL of W, joins them),
//     the online max and sum per cell across the warp's lanes; past 320
//     columns h is built again per sweep (V 584: twice; V 1025: four
//     times). Blocks past the lattice's tiles only write their share of the
//     sentinels of the full [B, T, U1] index (grid-stride);
//   * cells: 8 warps, 64-cell tiles (the scratch's db partials are per 64
//     cells); per tile, passes of 320 label columns (one pass up to VLp
//     320): the logits as the forward's (pass 0 also writes h and act' to
//     the window's scratch and runs the blank's chain), dlab into a
//     [320 x 8] shared tile of the warp, the window's dlab scratch and the
//     db partials (the block's only barriers, two a pass, sum the 8 warps'
//     column sums in order); then dh = dlab W_lab^T on the same pieces (the
//     warp's dlab tile the cells' operand), hidden units in sweeps of 320
//     with W_lab^T (a [VLp, H] copy the wrapper makes) streaming through the
//     ring; the last pass adds dblank w_blank, the dropout scale and act'
//     (read back from the dx scratch) and writes dx in act''s place. Past
//     one pass dh waits in an fp32 [win, H] scratch between passes, added in
//     pass order. Shared memory does not grow with H or V: every H the
//     wrappers take runs;
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

constexpr int WARPS = 8;      // the cells kernel's warps (and the sums')
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 64;      // lattice cells per tile of the cells kernel (= BROWS)
constexpr int WR = 8;         // cells a warp
constexpr int FWARPS = 12;    // the forward's warps: a third more to hide latency
constexpr int FTHREADS = 32 * FWARPS;
constexpr int FROWS = FWARPS * WR;  // lattice cells per tile of the forward
constexpr int KS = 16;        // depth of a slice (hidden units; label columns in dh)
constexpr int CW = 320;       // the widest sweep: 10 columns a lane
constexpr int STAGES = 4;     // the ring's slices
constexpr int LAG = 2;        // at slice i, the stage of slice i - LAG is refilled
constexpr int TR = 8;         // sums: rows per thread
constexpr int TCW = 4;        // sums: columns per thread
constexpr int CH = 128;       // sums: columns per block
constexpr int HCB = 64;       // sums: hidden rows per dW block
static_assert(ROWS == BROWS && ROWS == WARPS * WR && CH == 32 * TCW, "tiling");

constexpr size_t RING_BYTES = sizeof(float) * STAGES * KS * CW;
constexpr size_t HW_BYTES = sizeof(float) * WARPS * 2 * KS * WR;  // the warps' h slices
constexpr size_t DLT_BYTES = sizeof(float) * WARPS * CW * WR;     // the warps' dlab tiles
constexpr size_t DBW_BYTES = sizeof(float) * WARPS * CW;          // the warps' column sums

// A tile's cells and what the kernels read of them; warp w's rows are
// 8 w .. 8 w + 7, which only warp w writes.
template <int R>
struct TileMetaT {
  int b[R], t[R], u[R], tgt[R];
  float lse[R], total[R], gb[R], gy[R], g[R], dblank[R];
  float lab[R], blank[R];
};
using TileMeta = TileMetaT<ROWS>;
using FwdMeta = TileMetaT<FROWS>;

constexpr size_t BARS_BYTES = 2 * STAGES * sizeof(uint64_t);
constexpr size_t FHW_BYTES = sizeof(float) * FWARPS * 2 * KS * WR;  // the forward's h slices
constexpr size_t FWD_SMEM = RING_BYTES + FHW_BYTES + sizeof(FwdMeta) + BARS_BYTES;
constexpr size_t CELLS_SMEM =
    RING_BYTES + HW_BYTES + DLT_BYTES + DBW_BYTES + sizeof(TileMeta) + BARS_BYTES;

// ---------------------------------------------------------------------------
// the ring: KS-row slices of a row-major fp32 matrix, up to CW columns
// ---------------------------------------------------------------------------

struct Slice {
  const float* src;  // the slice's first row, at its first column
  int ld;            // the matrix's row stride (floats)
  int ncol;          // columns copied (a multiple of 4, <= CW)
};

// The forward's slices, tile after tile: per sweep of CW columns of w
// [H, vt], its H / KS slices.
struct FwdPlan {
  const float* w;
  int vt, nsl, per_tile;
  __device__ Slice at(int g) const {
    const int li = g % per_tile, c0 = li / nsl * CW, s = li % nsl;
    return {w + (size_t)s * KS * vt + c0, vt, min(CW, vt - c0)};
  }
};

// The cells kernel's slices, tile after tile: per pass of CW label columns,
// the logits' H / KS slices of w_pad [H, VLp], then for each sweep of CW
// hidden units the pass's PW / KS slices of wt = W_lab^T [VLp, H].
struct CellsPlan {
  const float* w_pad;
  const float* wt;
  int H, VLp, nsl, nh, per_tile;
  __device__ Slice at(int g) const {
    int li = g % per_tile;
    for (int p0 = 0;; p0 += CW) {
      const int pw = min(CW, VLp - p0), nd = pw / KS;
      if (li < nsl) return {w_pad + (size_t)li * KS * VLp + p0, VLp, pw};
      li -= nsl;
      if (li < nh * nd) {
        const int h0 = li / nd * CW, s = li % nd;
        return {wt + (size_t)(p0 + s * KS) * H + h0, H, min(CW, H - h0)};
      }
      li -= nh * nd;
    }
  }
};

template <class Plan>
struct Ring {
  float* stage;     // STAGES x [KS][CW]
  uint64_t* full;   // the slice has landed
  uint64_t* empty;  // every warp is done with the stage
  Plan plan;
  int n;            // the block's slices
  int warp, lane;
  int nw;           // the block's warps

  // slice g into its stage, by the whole issuing warp: lane 0 expects the
  // bytes, lanes 0 .. KS - 1 copy a row each
  __device__ void issue(int g) {
    const Slice sl = plan.at(g);
    uint64_t* bar = &full[g % STAGES];
    if (lane == 0) mbar_arrive_expect(bar, (uint32_t)(KS * sl.ncol * sizeof(float)));
    __syncwarp();
    if (lane < KS)
      bulk_g2s(stage + (size_t)(g % STAGES) * KS * CW + lane * CW, sl.src + (size_t)lane * sl.ld,
               (uint32_t)(sl.ncol * sizeof(float)), bar);
  }
  __device__ void init() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], nw);
      }
      mbar_fence_init();
    }
    __syncthreads();
    if (warp == 0)
      for (int g = 0; g < min(STAGES, n); ++g) issue(g);
  }
  // slice i's stage once it has landed; first, warp i % nw refills the
  // stage of slice i - LAG with slice i - LAG + STAGES once every warp is
  // done with it
  __device__ const float* take(int i) {
    const int j = i - LAG;
    if (j >= 0 && j + STAGES < n && warp == i % nw) {
      if (lane == 0) mbar_wait(&empty[j % STAGES], (j / STAGES) & 1);
      __syncwarp();
      issue(j + STAGES);
    }
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    return stage + (size_t)(i % STAGES) * KS * CW;
  }
  __device__ void release(int i) {  // this warp is done with slice i's stage
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % STAGES]);
  }
};

// ---------------------------------------------------------------------------
// the product: 8 x (2 M2) pieces
// ---------------------------------------------------------------------------

// The columns of a sweep of 64 M2 that a lane holds: acc's entry j is
// column col_of<M2>(j, lane), 4 at 128 q + 4 lane for each q < M2 / 2 (one
// 16-byte load a step), then for M2 odd 2 at 128 (M2 / 2) + 2 lane.
template <int M2>
__device__ inline int col_of(int j, int lane) {
  constexpr int N4 = 4 * (M2 / 2);
  return j < N4 ? 128 * (j >> 2) + 4 * lane + (j & 3) : 128 * (M2 / 2) + 2 * lane + (j - N4);
}

// acc[r][j] += sum over the slice's KS steps, in order, of A[k][r] *
// B[k][col_of<M2>(j, lane)]: A a warp's [KS][8] slice (h, or dlab^T), B a
// stage [KS][CW]. One fmaf chain per entry.
template <int M2, int UNROLL>
__device__ inline void fma_wide(float (&acc)[WR][2 * M2], const float* A, const float* B,
                                int lane) {
  constexpr int Q = M2 / 2;
#pragma unroll UNROLL
  for (int k = 0; k < KS; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + k * WR);
    const float4 a1 = *reinterpret_cast<const float4*>(A + k * WR + 4);
    const float a[WR] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float b[2 * M2];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(B + k * CW + 128 * q + 4 * lane);
      b[4 * q] = v.x;
      b[4 * q + 1] = v.y;
      b[4 * q + 2] = v.z;
      b[4 * q + 3] = v.w;
    }
    if (M2 & 1) {
      const float2 v = *reinterpret_cast<const float2*>(B + k * CW + 128 * Q + 2 * lane);
      b[4 * Q] = v.x;
      b[4 * Q + 1] = v.y;
    }
#pragma unroll
    for (int r = 0; r < WR; ++r)
#pragma unroll
      for (int j = 0; j < 2 * M2; ++j) acc[r][j] = fmaf(a[r], b[j], acc[r][j]);
  }
}

// One lane's share of its warp's h slices: cell r = lane / 4 of the warp,
// units 4 (lane % 4) .. + 3 of each slice.
struct Builder {
  const float* e;  // the cell's e and p rows (null past the lattice)
  const float* p;
  uint32_t hrow;   // its dropout hash row
  float* h_scr;    // its h and act' rows in the window's scratch (null: none)
  float* g_scr;
  float4 ev, pv;   // the next slice's e and p
};

template <class Meta>
__device__ inline Builder builder(const Joint<F32>& J, const Meta& M, int row, float* h_scr,
                                  float* g_scr) {
  Builder B;
  B.e = B.p = nullptr;
  B.h_scr = B.g_scr = nullptr;
  B.hrow = 0;
  const int b = M.b[row];
  if (b >= 0) {
    B.e = J.e + ((size_t)b * J.T + M.t[row]) * J.H;
    B.p = J.p + ((size_t)b * J.U1 + M.u[row]) * J.H;
    B.hrow = hash_row(J, b, M.t[row], M.u[row]);
    B.h_scr = h_scr;
    B.g_scr = g_scr;
  }
  return B;
}

__device__ inline void prefetch(Builder& B, int k) {
  if (B.e != nullptr) {
    B.ev = __ldg(reinterpret_cast<const float4*>(B.e + k));
    B.pv = __ldg(reinterpret_cast<const float4*>(B.p + k));
  }
}

// units k .. k + 3 of the lane's cell into the warp's slice Hs [KS][8]
// (and, with scratch, h and act' into the window's rows)
__device__ inline void build(const Joint<F32>& J, const Builder& B, float* Hs, int k, int lane,
                             bool scratch) {
  float h[4] = {0.f, 0.f, 0.f, 0.f}, g[4] = {0.f, 0.f, 0.f, 0.f};
  if (B.e != nullptr) {
    const float x[4] = {B.ev.x + B.pv.x, B.ev.y + B.pv.y, B.ev.z + B.pv.z, B.ev.w + B.pv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) hidden_unit(J, x[i], B.hrow, k + i, h[i], g[i]);
  }
  const int r = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) Hs[(4 * q + i) * WR + r] = h[i];
  if (scratch && B.h_scr != nullptr) {
    *reinterpret_cast<float4*>(B.h_scr + k) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(B.g_scr + k) = make_float4(g[0], g[1], g[2], g[3]);
  }
}

// The logits' sweep over H for the warp's 8 cells at one sweep of columns
// (the ring's next H / KS slices): acc from 0.0f, h built a slice at a
// time into the warp's double buffer Hw; with w_blank (the cells kernel's
// pass 0) lane 4 r also runs cell r's blank chain into bacc.
template <int M2, int UNROLL, class Plan>
__device__ inline void sweep(const Joint<F32>& J, Ring<Plan>& R, int& i,
                             float (&acc)[WR][2 * M2], Builder& B, float* Hw, int lane,
                             bool scratch, const float* w_blank, float& bacc) {
#pragma unroll
  for (int r = 0; r < WR; ++r)
#pragma unroll
    for (int j = 0; j < 2 * M2; ++j) acc[r][j] = 0.f;
  const int nsl = J.H / KS, q = lane & 3;
  prefetch(B, 4 * q);
  for (int s = 0; s < nsl; ++s, ++i) {
    float* Hs = Hw + (s & 1) * KS * WR;
    build(J, B, Hs, s * KS + 4 * q, lane, scratch);
    if (s + 1 < nsl) prefetch(B, (s + 1) * KS + 4 * q);
    __syncwarp();  // the slice's h is in
    fma_wide<M2, UNROLL>(acc, Hs, R.take(i), lane);
    R.release(i);
    if (w_blank != nullptr && q == 0) {
      const float* a = Hs + (lane >> 2);
#pragma unroll
      for (int k4 = 0; k4 < KS; k4 += 4) {
        const float4 wb = __ldg(reinterpret_cast<const float4*>(w_blank + s * KS + k4));
        bacc = fmaf(a[(k4 + 0) * WR], wb.x, bacc);
        bacc = fmaf(a[(k4 + 1) * WR], wb.y, bacc);
        bacc = fmaf(a[(k4 + 2) * WR], wb.z, bacc);
        bacc = fmaf(a[(k4 + 3) * WR], wb.w, bacc);
      }
    }
  }
}

// (b, t, u) and the target of cell 8 w + lane (lanes 0..7 of warp w), or
// b = -1 past the `rows` live cells of the tile at lattice cell tile0
template <class Meta>
__device__ inline void warp_cells(const Joint<F32>& J, Meta& M, long long tile0, int rows,
                                  int warp, int lane) {
  if (lane < WR) {
    const int r = WR * warp + lane;
    int b = -1, t = 0, u = 0;
    if (r < rows) cell_btu(J, tile0 + r, b, t, u);
    M.b[r] = b;
    M.t[r] = t;
    M.u[r] = u;
    M.tgt[r] = b >= 0 ? target_of(J, b, u) : -1;
    M.lab[r] = M.blank[r] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// One sweep of the forward: the logits of columns [c0, c0 + 64 M2) for the
// warp's cells, folded into the rows' online max and sum (uniform m_run
// across the lanes, l_run the lane's share), the target's and the blank's
// logits into M.
template <int M2>
__device__ inline void fwd_sweep(const Joint<F32>& J, Ring<FwdPlan>& R, int& i, FwdMeta& M,
                                 Builder& B, float* Hw, int warp, int lane, int c0,
                                 float (&m_run)[WR], float (&l_run)[WR]) {
  float acc[WR][2 * M2], unused = 0.f;
  sweep<M2, KS>(J, R, i, acc, B, Hw, lane, false, nullptr, unused);
  float bias[2 * M2];
#pragma unroll
  for (int j = 0; j < 2 * M2; ++j) {
    const int c = c0 + col_of<M2>(j, lane);
    bias[j] = c < J.V ? __ldg(J.bias + c) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < WR; ++r) {
    const int row = WR * warp + r;
    float x[2 * M2], mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 2 * M2; ++j) {
      const int c = c0 + col_of<M2>(j, lane);
      x[j] = NEG_INF;
      if (c < J.V) {
        x[j] = acc[r][j] + bias[j];
        if (c == M.tgt[row]) M.lab[row] = x[j];
        if (c == J.VL) M.blank[row] = x[j];
      }
      mx = fmaxf(mx, x[j]);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m_run[r], mx);
    float s = l_run[r] * expf(m_run[r] - m_new);
#pragma unroll
    for (int j = 0; j < 2 * M2; ++j)
      if (c0 + col_of<M2>(j, lane) < J.V) s += expf(x[j] - m_new);
    l_run[r] = s;
    m_run[r] = m_new;
  }
}

__global__ void __launch_bounds__(FTHREADS, 1)
joint_fwd_f32_kernel(Joint<F32> J, const float* __restrict__ w, int vt,
                     float* __restrict__ blank_lp, float* __restrict__ label_lp,
                     float* __restrict__ lse_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* Hw_all = reinterpret_cast<float*>(smem + RING_BYTES);
  FwdMeta& M = *reinterpret_cast<FwdMeta*>(smem + RING_BYTES + FHW_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + RING_BYTES + FHW_BYTES + sizeof(FwdMeta));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the sentinels of the full [B, T, U1] index, grid-stride
  const long long n_full = (long long)J.B * J.T * J.U1;
  for (long long c = (long long)blockIdx.x * FTHREADS + threadIdx.x; c < n_full;
       c += (long long)gridDim.x * FTHREADS) {
    const int u = (int)(c % J.U1);
    const long long bt = c / J.U1;
    const Lat la = lat_of(J, (int)(bt / J.T));
    if ((int)(bt % J.T) >= la.n_t || u >= la.n_u) {
      blank_lp[c] = label_lp[c] = NEG_INF;
      lse_out[c] = -NEG_INF;
    }
  }
  const long long n_all = J.off[J.B];
  const int tiles = (int)((n_all + FROWS - 1) / FROWS);
  if ((int)blockIdx.x >= tiles) return;
  const int nt = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int nsl = J.H / KS, nsw = (J.V + CW - 1) / CW;
  Ring<FwdPlan> R{ring, bars, bars + STAGES, FwdPlan{w, vt, nsl, nsw * nsl},
                  nt * nsw * nsl, warp, lane, FWARPS};
  R.init();
  float* Hw = Hw_all + warp * 2 * KS * WR;
  int i = 0;  // slices taken
  for (int k = 0; k < nt; ++k) {
    const long long tile0 = (long long)(blockIdx.x + k * gridDim.x) * FROWS;
    const int rows = (int)min((long long)FROWS, n_all - tile0);
    warp_cells(J, M, tile0, rows, warp, lane);
    __syncwarp();
    Builder B = builder(J, M, WR * warp + (lane >> 2), nullptr, nullptr);
    float m_run[WR], l_run[WR];
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      m_run[r] = NEG_INF;
      l_run[r] = 0.f;
    }
    for (int c0 = 0; c0 < J.V; c0 += CW) {
      switch ((min(CW, vt - c0) + 63) / 64) {
        case 1: fwd_sweep<1>(J, R, i, M, B, Hw, warp, lane, c0, m_run, l_run); break;
        case 2: fwd_sweep<2>(J, R, i, M, B, Hw, warp, lane, c0, m_run, l_run); break;
        case 3: fwd_sweep<3>(J, R, i, M, B, Hw, warp, lane, c0, m_run, l_run); break;
        case 4: fwd_sweep<4>(J, R, i, M, B, Hw, warp, lane, c0, m_run, l_run); break;
        default: fwd_sweep<5>(J, R, i, M, B, Hw, warp, lane, c0, m_run, l_run); break;
      }
    }
#pragma unroll
    for (int r = 0; r < WR; ++r)
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], o);
    __syncwarp();  // the label and blank logits are in
    if (lane < WR) {
      float m = 0.f, l = 0.f;
#pragma unroll
      for (int r = 0; r < WR; ++r)
        if (r == lane) {
          m = m_run[r];
          l = l_run[r];
        }
      const int row = WR * warp + lane;
      if (M.b[row] >= 0) {
        const float lse = m + logf(l);
        const size_t o = ((size_t)M.b[row] * J.T + M.t[row]) * J.U1 + M.u[row];
        blank_lp[o] = M.blank[row] - lse;
        label_lp[o] = M.lab[row] - lse;
        lse_out[o] = lse;
      }
    }
    __syncwarp();  // every lane is done with the tile's cells before the next
  }
}

// ---------------------------------------------------------------------------
// backward (cells)
// ---------------------------------------------------------------------------

struct CellsArgs {
  const float* w_blank;  // [H]
  const float* lse;      // [B, T, U1]
  const float* total;
  const float* gb;
  const float* gy;
  const float* g;        // [B]
  float clamp;
  long long c0;          // the window's first lattice cell
  int win, VLp;
  float* dlab_out;       // the window's scratch: dlab [win, VLp], dblank [win],
  float* dblank_out;     // dx (act' until the last pass) and h [win, H],
  float* dx_out;         // db partials [win / 64, V]
  float* h_out;
  float* dbl_part;
  float* dh_part;        // fp32 dh between passes [win, H] (null for one pass)
};

// The logits of the pass's label columns [p0, p0 + pw) for the warp's cells
// (pass 0: with the scratch's h and act' and the blank's chain, whose
// dblank goes to M and the scratch), then dlab = clamp(softmax * total -
// gy 1[tgt]) * g into the warp's DlT [pw][8], the window's dlab scratch and
// the warp's column sums dbw.
template <int M2>
__device__ inline void cells_logits(const Joint<F32>& J, const CellsArgs& A, Ring<CellsPlan>& R,
                                    int& i, TileMeta& M, Builder& B, float* Hw, float* DlT,
                                    float* dbw, int warp, int lane, int p0, int pw, int rows,
                                    size_t row0) {
  const bool first = p0 == 0;
  float acc[WR][2 * M2], bacc = 0.f;
  sweep<M2, 4>(J, R, i, acc, B, Hw, lane, first, first ? A.w_blank : nullptr, bacc);
  if (first && (lane & 3) == 0) {
    const int row = WR * warp + (lane >> 2);
    float d = 0.f;
    if (M.b[row] >= 0) {
      const float blank = bacc + J.bias[J.VL];
      d = clamp_g(expf(blank - M.lse[row]) * M.total[row] - M.gb[row], A.clamp, M.g[row]);
      A.dblank_out[row0 + row] = d;
    }
    M.dblank[row] = d;
  }
  float bias[2 * M2];
#pragma unroll
  for (int j = 0; j < 2 * M2; ++j) {
    const int c = p0 + col_of<M2>(j, lane);
    bias[j] = c < J.VL ? __ldg(J.bias + c) : 0.f;
  }
  // acc becomes dlab
#pragma unroll
  for (int j = 0; j < 2 * M2; ++j) {
    const int c = p0 + col_of<M2>(j, lane);
    float colsum = 0.f;
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      const int row = WR * warp + r;
      float x = 0.f;
      if (M.b[row] >= 0 && c < J.VL) {
        x = expf(acc[r][j] + bias[j] - M.lse[row]) * M.total[row] -
            (c == M.tgt[row] ? M.gy[row] : 0.f);
        x = clamp_g(x, A.clamp, M.g[row]);
      }
      acc[r][j] = x;
      colsum += x;
    }
    float* d = DlT + col_of<M2>(j, lane) * WR;
    *reinterpret_cast<float4*>(d) = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    *reinterpret_cast<float4*>(d + 4) = make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
    dbw[warp * CW + col_of<M2>(j, lane)] = colsum;
  }
  constexpr int Q = M2 / 2;
#pragma unroll
  for (int r = 0; r < WR; ++r) {
    const int row = WR * warp + r;
    if (row >= rows) continue;
    float* out = A.dlab_out + (row0 + row) * A.VLp + p0;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int cl = 128 * q + 4 * lane;
      if (cl < pw)
        *reinterpret_cast<float4*>(out + cl) =
            make_float4(acc[r][4 * q], acc[r][4 * q + 1], acc[r][4 * q + 2], acc[r][4 * q + 3]);
    }
    if ((M2 & 1) && 128 * Q + 2 * lane < pw)
      *reinterpret_cast<float2*>(out + 128 * Q + 2 * lane) =
          make_float2(acc[r][4 * Q], acc[r][4 * Q + 1]);
  }
}

// dh[:, h0 : h0 + 64 M2] += dlab W_lab[h0 .., p0 : p0 + pw]^T for the
// warp's cells on the logits' pieces (the ring's next pw / KS slices of
// W_lab^T, the warp's DlT the rows' operand); past one pass the earlier
// passes' share waits in dh_part (added in pass order); the last pass adds
// dblank w_blank, the dropout scale and act' (read back from the dx
// scratch) and writes dx in act''s place.
template <int M2>
__device__ inline void cells_dh(const Joint<F32>& J, const CellsArgs& A, Ring<CellsPlan>& R,
                                int& i, const TileMeta& M, const float* DlT, int warp, int lane,
                                int h0, int pw, bool first, bool last, int rows, size_t row0) {
  float acc[WR][2 * M2];
#pragma unroll
  for (int r = 0; r < WR; ++r)
#pragma unroll
    for (int j = 0; j < 2 * M2; ++j) acc[r][j] = 0.f;
  for (int s = 0; s < pw / KS; ++s, ++i) {
    fma_wide<M2, 4>(acc, DlT + s * KS * WR, R.take(i), lane);
    R.release(i);
  }
  const int H = J.H;
  const float keep = J.drop_t > 0 ? J.inv_keep : 1.f;
  // acc's entries in groups of 4 hidden units (the last of 2 for M2 odd),
  // each group inside H or past it (H and the groups' starts multiples of 4)
#pragma unroll
  for (int j0 = 0; j0 < 2 * M2; j0 += 4) {
    const int n = min(4, 2 * M2 - j0), h = h0 + col_of<M2>(j0, lane);
    if (h >= H) continue;
    float wb[4];
#pragma unroll
    for (int e = 0; e < n; ++e) wb[e] = __ldg(A.w_blank + h + e);
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      const int row = WR * warp + r;
      if (row >= rows) continue;
      float sum[4];
#pragma unroll
      for (int e = 0; e < n; ++e) sum[e] = acc[r][j0 + e];
      if (A.dh_part != nullptr) {
        float* part = A.dh_part + (row0 + row) * H + h;
        if (!first)
#pragma unroll
          for (int e = 0; e < n; ++e) sum[e] = part[e] + sum[e];
        if (!last) {
#pragma unroll
          for (int e = 0; e < n; ++e) part[e] = sum[e];
          continue;
        }
      }
      float* gx = A.dx_out + (row0 + row) * H + h;
      const float db = M.dblank[row];
#pragma unroll
      for (int e = 0; e < n; ++e) gx[e] = (sum[e] + db * wb[e]) * keep * gx[e];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
joint_bwd_cells_f32_kernel(Joint<F32> J, const float* __restrict__ w_pad,
                           const float* __restrict__ wt, CellsArgs A) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* Hw_all = reinterpret_cast<float*>(smem + RING_BYTES);
  float* DlT_all = reinterpret_cast<float*>(smem + RING_BYTES + HW_BYTES);
  float* dbw = reinterpret_cast<float*>(smem + RING_BYTES + HW_BYTES + DLT_BYTES);
  TileMeta& M =
      *reinterpret_cast<TileMeta*>(smem + RING_BYTES + HW_BYTES + DLT_BYTES + DBW_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + RING_BYTES + HW_BYTES + DLT_BYTES +
                                               DBW_BYTES + sizeof(TileMeta));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long n_all = J.off[J.B];
  if (A.c0 >= n_all) return;
  const int tiles = (int)min((long long)(A.win / ROWS), (n_all - A.c0 + ROWS - 1) / ROWS);
  if ((int)blockIdx.x >= tiles) return;
  const int nt = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int H = J.H, nsl = H / KS, nh = (H + CW - 1) / CW, VLp = A.VLp;
  const int per_tile = (VLp + CW - 1) / CW * nsl + nh * VLp / KS;
  Ring<CellsPlan> R{ring, bars, bars + STAGES, CellsPlan{w_pad, wt, H, VLp, nsl, nh, per_tile},
                    nt * per_tile, warp, lane, WARPS};
  R.init();
  float* Hw = Hw_all + warp * 2 * KS * WR;
  float* DlT = DlT_all + warp * CW * WR;
  int i = 0;  // slices taken
  for (int k = 0; k < nt; ++k) {
    const int tile = (int)blockIdx.x + k * (int)gridDim.x;
    const long long tile0 = A.c0 + (long long)tile * ROWS;
    const int rows = (int)min((long long)ROWS, n_all - tile0);
    const size_t row0 = (size_t)tile * ROWS;  // the tile's first row in the window
    warp_cells(J, M, tile0, rows, warp, lane);
    if (lane < WR) {
      const int row = WR * warp + lane, b = M.b[row];
      if (b >= 0) {
        const size_t o = ((size_t)b * J.T + M.t[row]) * J.U1 + M.u[row];
        M.lse[row] = A.lse[o];
        M.total[row] = A.total[o];
        M.gb[row] = A.gb[o];
        M.gy[row] = A.gy[o];
        M.g[row] = A.g[b];
      } else {
        M.lse[row] = M.total[row] = M.gb[row] = M.gy[row] = M.g[row] = 0.f;
      }
    }
    __syncwarp();
    const int brow = WR * warp + (lane >> 2);
    Builder B = builder(J, M, brow, A.h_out + (row0 + brow) * H, A.dx_out + (row0 + brow) * H);
    float* dbl_row = A.dbl_part + (size_t)tile * (J.VL + 1);
    for (int p0 = 0; p0 < VLp; p0 += CW) {
      const int pw = min(CW, VLp - p0);
      switch ((pw + 63) / 64) {
        case 1: cells_logits<1>(J, A, R, i, M, B, Hw, DlT, dbw, warp, lane, p0, pw, rows, row0); break;
        case 2: cells_logits<2>(J, A, R, i, M, B, Hw, DlT, dbw, warp, lane, p0, pw, rows, row0); break;
        case 3: cells_logits<3>(J, A, R, i, M, B, Hw, DlT, dbw, warp, lane, p0, pw, rows, row0); break;
        case 4: cells_logits<4>(J, A, R, i, M, B, Hw, DlT, dbw, warp, lane, p0, pw, rows, row0); break;
        default: cells_logits<5>(J, A, R, i, M, B, Hw, DlT, dbw, warp, lane, p0, pw, rows, row0); break;
      }
      __syncthreads();  // every warp's column sums (and dblank) are in
      for (int c = threadIdx.x; c < min(pw, J.VL - p0); c += THREADS) {
        float s = 0.f;
        for (int w = 0; w < WARPS; ++w) s += dbw[w * CW + c];
        dbl_row[p0 + c] = s;
      }
      if (p0 == 0 && threadIdx.x == 0) {
        float s = 0.f;
        for (int r = 0; r < ROWS; ++r) s += M.dblank[r];
        dbl_row[J.VL] = s;
      }
      __syncthreads();  // dbw is read before any warp writes the next pass's
      const bool first = p0 == 0, last = p0 + CW >= VLp;
      for (int h0 = 0; h0 < H; h0 += CW) {
        switch ((min(CW, H - h0) + 63) / 64) {
          case 1: cells_dh<1>(J, A, R, i, M, DlT, warp, lane, h0, pw, first, last, rows, row0); break;
          case 2: cells_dh<2>(J, A, R, i, M, DlT, warp, lane, h0, pw, first, last, rows, row0); break;
          case 3: cells_dh<3>(J, A, R, i, M, DlT, warp, lane, h0, pw, first, last, rows, row0); break;
          case 4: cells_dh<4>(J, A, R, i, M, DlT, warp, lane, h0, pw, first, last, rows, row0); break;
          default: cells_dh<5>(J, A, R, i, M, DlT, warp, lane, h0, pw, first, last, rows, row0); break;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward (sums)
// ---------------------------------------------------------------------------

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
// (A [..][HCB], B [..][CH] in shared memory)
__device__ inline void fma_slice(float (&acc)[TR][TCW], const float* A, const float* B, int n,
                                 int rg, int cg) {
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + k * HCB + TR * rg);
    const float4 a1 = *reinterpret_cast<const float4*>(A + k * HCB + TR * rg + 4);
    const float4 b = *reinterpret_cast<const float4*>(B + k * CH + TCW * cg);
    const float a[TR] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bb[TCW] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TCW; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

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

// Dynamic shared memory of the forward (0) and the cells kernel (1), static
// of the sums kernel (2): none depends on H or V.
extern "C" long long rnnt_joint_smem_bytes(int H, int V, int which) {
  (void)H;
  (void)V;
  if (which == 0) return (long long)FWD_SMEM;
  if (which == 1) return (long long)CELLS_SMEM;
  return (long long)sizeof(float) * (2 * KS * (HCB + CH) + 2 * KS);
}

// The forward's tile height (any H).
extern "C" int rnnt_joint_fwd_rows(int H) { return H > 0 ? FROWS : 0; }

extern "C" int rnnt_joint_bwd_tile_cells() { return BROWS; }
extern "C" int rnnt_joint_bwd_ksplit() { return KSPLIT; }
extern "C" int rnnt_joint_bwd_pass_cols() { return CW; }

// As rnnt_joint.cu's rnnt_joint_fwd_bf16, in fp32: w [h, vt] with vt a
// multiple of 4 (16-byte rows), 16-byte aligned. A persistent grid of
// `grid` blocks (one an SM) walks the lattice's 64-cell tiles.
extern "C" int rnnt_joint_fwd_f32(const void* e, const void* p, const void* w, const void* bias,
                                  const void* targets, const void* t_lens, const void* u_lens,
                                  const void* cell_off, void* blank_lp, void* label_lp,
                                  void* lse, int b, int t, int u1, int h, int hh, int v, int vt,
                                  int tp, int act, int drop_t, int seed, int hash_base, int grid,
                                  void* stream) {
  const Joint<F32> J = make_joint<F32>(e, p, bias, targets, t_lens, u_lens, cell_off, b, t, u1,
                                       h, hh, v, tp, act, drop_t, seed, hash_base);
  if (!widths_ok(h, hh, v) || vt < v || vt % 4 || grid < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(joint_fwd_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)b * t * u1 + FROWS - 1) / FROWS;
  joint_fwd_f32_kernel<<<(unsigned)min((long long)grid, tiles), FTHREADS, FWD_SMEM,
                         (cudaStream_t)stream>>>(J, (const float*)w, vt, (float*)blank_lp,
                                                 (float*)label_lp, (float*)lse);
  return (int)cudaGetLastError();
}

// As rnnt_joint.cu's rnnt_joint_bwd_cells_bf16, in fp32, with wt [vlp, h] the
// transpose of w_pad; dh_part holds dh between the passes over a label block
// wider than 320 columns (null up to 320). A persistent grid, one block an
// SM, walks the window's tiles.
extern "C" int rnnt_joint_bwd_cells_f32(
    const void* e, const void* p, const void* w_pad, const void* wt, const void* w_blank,
    const void* bias, const void* targets, const void* t_lens, const void* u_lens,
    const void* cell_off, const void* lse, const void* total, const void* gb, const void* gy,
    const void* g, void* dlab, void* dblank, void* dx, void* h_win, void* dbl_part, void* dh_part,
    int b, int t, int u1, int h, int hh, int v, int vlp, int tp, int act, int drop_t, int seed,
    int hash_base, int win, long long c0, float clamp, void* stream) {
  const Joint<F32> J = make_joint<F32>(e, p, bias, targets, t_lens, u_lens, cell_off, b, t, u1,
                                       h, hh, v, tp, act, drop_t, seed, hash_base);
  if (!widths_ok(h, hh, v) || win % ROWS || win < ROWS || vlp % 32 || vlp < v - 1 ||
      (vlp > CW && dh_part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(joint_bwd_cells_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)CELLS_SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const CellsArgs A{(const float*)w_blank, (const float*)lse, (const float*)total,
                    (const float*)gb, (const float*)gy, (const float*)g, clamp, c0, win, vlp,
                    (float*)dlab, (float*)dblank, (float*)dx, (float*)h_win, (float*)dbl_part,
                    vlp > CW ? (float*)dh_part : nullptr};
  joint_bwd_cells_f32_kernel<<<min(win / ROWS, n_sm), THREADS, CELLS_SMEM,
                               (cudaStream_t)stream>>>(J, (const float*)w_pad, (const float*)wt, A);
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
