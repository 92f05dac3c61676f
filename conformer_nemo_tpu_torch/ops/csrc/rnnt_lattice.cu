// RNN-T lattice recursions (K3): the forward variable alpha and the
// backward variable beta over the [T, U+1] lattice of each sample, for
// NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels `_alpha_kernel` (via `alphas_skewed_pallas`) and
// `_beta_kernel` (via `betas_skewed_pallas`) of
// conformer_nemo_tpu/ops/pallas/rnnt_kernel.py, with the masking of their
// callers `_compute_alphas` / `_compute_betas` in
// conformer_nemo_tpu/ops/rnnt_loss.py. With valid(t, u) = t < t_len and
// u <= u_len, bl = blank_lp and lb = label_lp set to -1e30 outside the
// valid cells:
//
//   alpha[0, 0] = 0
//   alpha[t, u] = lse(alpha[t-1, u] + bl[t-1, u], alpha[t, u-1] + lb[t, u-1])
//   beta[t, u]  = max(lse(bl[t, u] + beta[t+1, u], lb[t, u] + beta[t, u+1]),
//                     term[t, u]),   term = blank_lp at (t_len-1, u_len)
//
// and both outputs are -1e30 outside the valid cells. lse(a, b) is the TPU
// kernel's `_lse`: -1e30 when max(a, b) <= -5e29, else
// m + log(exp(a - m) + exp(b - m)). -1e30 stands for -inf throughout.
//
// The TPU kernels sweep a skewed [W, T] copy of the lattice held whole in
// VMEM (rnnt_loss.py `_skew`, capped at `_PALLAS_LATTICE_MAX_CELLS`): a
// lane-axis layout trick and a VMEM limit, neither of which carries over.
// These kernels take the unskewed [B, T, U+1] layout as it is and have no
// size cap.
//
// Bound on an H100: a cell costs a handful of fp32 operations and the bytes
// are bl, lb read once and alpha (or beta) written once, ~12 bytes a cell,
// so the bytes bound is microseconds. What holds the kernels is the chain of
// t_len + u_len dependent anti-diagonals d = t + u: each needs the one before
// it, so a sample's time is its diagonals times the latency of one step.
//
// Design: one block per sample; the sweep is sized to the sample's own width
// W = u_len + 1, read on the device (the host reads no length), and the
// kernel picks the sample's path from it.
//  * Warp path (W <= WARP_WIDTH = 64, and a block of two warps or more): a
//    chain warp holds the cells u = 2l, 2l+1 of the current diagonal in lane
//    l's registers; a step is one shuffle with the neighbouring lane
//    (`__shfl_up_sync` for alpha, which needs u - 1; `__shfl_down_sync` for
//    beta, which needs u + 1) and one lse per cell, with no block barrier. A
//    second warp copies the rows ahead into shared-memory rings, coalesced,
//    so no global load is on the chain (see `sweep_warp`).
//  * Block path (wider samples): the sweep warps (as many as W needs, at
//    most the block's) each own 64 consecutive cells as above; the last
//    lane of a warp hands its cell to the next warp through a two-slot
//    exchange in shared memory, and one named barrier of the sweep warps
//    closes each diagonal. Each thread copies its own cells' inputs RING
//    diagonals ahead into a shared-memory ring (`cp.async`, waited per
//    thread), so no global load is on the chain. Past the block's width
//    (512 threads: 1024 cells) the lattice is swept in strips of u, in order
//    (alpha left to right, beta right to left); a strip reads its
//    neighbour's boundary column back from the output, which the strip
//    before it completed.
//  * Every cell is written once: the sweep writes the valid cells; the
//    warps the sweep leaves idle (or the sweep warps, after it) write -1e30
//    to the rest, row by row (rows t < t_len from column W on, the rows
//    past t_len whole), with no division per element.
//  * lse: e = exp(min - m) by the SFU's approximate ex2 and log(1 + e) by a
//    polynomial, branch-free (see `lse`); both paths take the same
//    operations per cell in the same order, so they give the same bits. No
//    atomics: the same bits on every call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int CELLS = 2;                  // cells per thread on both paths
constexpr int WARP_WIDTH = 32 * CELLS;    // widest lattice the warp path takes
constexpr int RING = 8;                   // block path: diagonals prefetched
constexpr int SLOTS = 2 * CELLS + 1;      // block path: a thread's inputs of one diagonal
constexpr int RING_DIAGS = 128;           // warp path: diagonals its rings hold
constexpr int CHUNK = 16;                 // warp path: steps between its two warps' barriers
constexpr int WARP_RINGS_BYTES = 2 * RING_DIAGS * WARP_WIDTH * (int)sizeof(float);
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;

enum Path { PATH_EMPTY = 0, PATH_WARP = 1, PATH_BLOCK = 2 };

// lse(a, b) = m + log(1 + e), e = exp(min - m) in [0, 1]: e by the SFU's
// ex2.approx (relative error ~2^-22), log(1 + e) by a degree-9 polynomial in
// e (a Chebyshev fit of log1p on [0, 1], ~1e-7 absolute in fp32 and
// unbiased; lg2.approx's error is biased, and summed over a long lattice it
// broke the 1e-5 limit on an H100; precise logf/expf lengthen the dependent
// step several times). No branch: both arms are finite for inputs >= -2e30.
__device__ __forceinline__ float lse(float a, float b) {
  const float m = fmaxf(a, b);
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"((fminf(a, b) - m) * 1.44269504088896341f));
  float q = 0.005253457929939032f;
  q = fmaf(q, e, -0.02958850748836994f);
  q = fmaf(q, e, 0.07836166769266129f);
  q = fmaf(q, e, -0.13674770295619965f);
  q = fmaf(q, e, 0.19111430644989014f);
  q = fmaf(q, e, -0.24844369292259216f);
  q = fmaf(q, e, 0.33319270610809326f);
  q = fmaf(q, e, -0.49999502301216125f);
  q = fmaf(q, e, 1.f);
  const float r = fmaf(q, e, m);
  return m <= NEG_INF * 0.5f ? NEG_INF : r;
}

// The new values of a thread's K cells on diagonal d from their values `s`
// on the diagonal before it (s[k] is the cell at the same u), the inputs
// x, y of the step, and `nb`, the neighbouring thread's cell: alpha adds the
// blank arc from (t-1, u) and the label arc from (t, u-1); beta the blank arc
// to (t+1, u) and the label arc to (t, u+1).
template <bool BETA, int K>
__device__ __forceinline__ void chain_cells(float (&v)[K], const float (&s)[K], const float (&x)[K],
                                            const float (&y)[K], float nb) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (BETA) v[k] = lse(x[k] + s[k], y[k] + (k + 1 < K ? s[k + 1] : nb));
    else v[k] = lse(s[k] + x[k], (k > 0 ? s[k - 1] : nb) + y[k]);
  }
}

__device__ __forceinline__ void sync_sweep(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// col + row * row_bytes as one 32 x 32 -> 64-bit multiply-add
template <class F>
__device__ __forceinline__ F* at_row(F* col, unsigned row, unsigned row_bytes) {
  unsigned long long p;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(p) : "r"(row), "r"(row_bytes), "l"(col));
  return reinterpret_cast<F*>(p);
}

// *p = v where c: one predicated store
__device__ __forceinline__ void st_if(float* p, float v, bool c) {
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q st.global.f32 [%1], %0;\n}"
               :: "f"(v), "l"(p), "r"((int)c) : "memory");
}

// One sample's lattice: bl, lb and out point at its [T, U1] block;
// tl = min(t_len, T) rows and ul = min(u_len, U1 - 1) (tl = 0 when empty).
struct Lattice {
  const float* bl;
  const float* lb;
  float* out;
  int U1, tl, ul;
  bool term;  // beta's terminal cell (t_len - 1, u_len) lies in the block
};

// The block path: the sweep of the columns [u_lo, u_hi) by `threads` threads
// (a multiple of 32), thread `idx` holding the cells u_lo + idx * K + k; the
// warps exchange their end cells through `xch`, a barrier a diagonal, and
// the strip may have neighbours whose boundary column it reads from `out`.
template <bool BETA, int K>
__device__ void sweep_strip(const Lattice& L, int u_lo, int u_hi, int idx, int threads,
                            float* xch, float* ring) {
  const int lane = idx & 31, w = idx >> 5, nw = threads >> 5;
  const int u0 = u_lo + idx * K, dir = BETA ? -1 : 1;
  const unsigned tl = L.tl, row = 4u * L.U1;
  // the strip's cells lie on n diagonals, alpha's from u_lo up, beta's from
  // d_hi down; a cell's row is t = d - u
  const int d_hi = L.tl - 1 + u_hi - 1, n = d_hi - u_lo + 1;
  // each cell's column: alpha reads bl one row up and lb one column left
  bool has[K], has_y[K];
  const float *xc[K], *yc[K];
  float* oc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int u = u0 + k;
    has[k] = u < u_hi;
    has_y[k] = has[k] && (BETA || u >= 1);
    xc[k] = L.bl + u;
    yc[k] = L.lb + u - (BETA ? 0 : 1);
    oc[k] = L.out + u;
  }
  // the thread whose end cell takes the neighbouring strip's column
  const bool edge = BETA ? idx == threads - 1 && u_hi <= L.ul : idx == 0 && u_lo > 0;
  const float* edge_col = L.out + (BETA ? u_hi : u_lo - 1);

  float s[K];  // the thread's cells on the previous step's diagonal
#pragma unroll
  for (int k = 0; k < K; ++k) s[k] = NEG_INF;
  // the first diagonal of alpha's first strip holds only the origin, and
  // of beta's first strip only the terminal cell: set them and start after
  int i_first = 0;
  if (BETA ? u_hi == L.ul + 1 : u_lo == 0) {
    i_first = 1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (u0 + k == (BETA ? L.ul : 0)) {
        const unsigned t = BETA ? tl - 1 : 0;
        s[k] = BETA ? (L.term ? xc[k][(size_t)t * L.U1] : NEG_INF) : 0.f;
        oc[k][(size_t)t * L.U1] = s[k];
      }
    }
    if (BETA ? lane == 0 : lane == 31) xch[w] = BETA ? s[0] : s[K - 1];
    sync_sweep(threads);
  }

  // the inputs of the diagonal on which cell 0 lies in row t0, copied into
  // ring slot p: x, y the blank and label log-probs the recursion adds at
  // each cell, c the neighbouring strip's cell (0 where there is none: an
  // input off the lattice meets a -1e30 or a masked cell)
  const int stride = blockDim.x;
  float* mine = ring + threadIdx.x;  // slot p, input j: mine[(p * SLOTS + j) * stride]
  auto fetch = [&](int t0, int p) {
    float* slot = mine + p * SLOTS * stride;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = t0 - k, tx = BETA ? t : t - 1;
      const bool okx = has[k] && (unsigned)tx < tl, oky = has_y[k] && (unsigned)t < tl;
      tc::cp_async4_zfill(slot + k * stride, okx ? at_row(xc[k], tx, row) : L.bl, okx);
      tc::cp_async4_zfill(slot + (K + k) * stride, oky ? at_row(yc[k], t, row) : L.bl, oky);
    }
    if (edge) {  // alpha[t, u_lo - 1] for the cell (t, u_lo); beta[t, u_hi] for (t, u_hi - 1)
      const int t = t0 - (BETA ? K - 1 : 0);
      const bool ok = (unsigned)t < tl;
      tc::cp_async4_zfill(slot + 2 * K * stride, ok ? at_row(edge_col, t, row) : L.out, ok);
    }
    tc::cp_commit();
  };

  auto step = [&](int i, int t0, int p) {
    // this thread's copies for step i have landed (at most RING - 1 later
    // groups are in flight); the fence keeps the slot's reads after the wait
    tc::cp_wait<RING - 1>();
    asm volatile("" ::: "memory");
    const float* slot = mine + p * SLOTS * stride;
    float x[K], y[K];
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = slot[k * stride], y[k] = slot[(K + k) * stride];
    // the neighbouring thread's cell on the previous diagonal
    float nb;
    if (BETA) {
      nb = __shfl_down_sync(FULL, s[0], 1);
      if (lane == 31) nb = w + 1 < nw && i > 0 ? xch[((i - 1) & 1) * MAX_WARPS + w + 1] : NEG_INF;
    } else {
      nb = __shfl_up_sync(FULL, s[K - 1], 1);
      if (lane == 0) nb = w > 0 && i > 0 ? xch[((i - 1) & 1) * MAX_WARPS + w - 1] : NEG_INF;
    }
    if (edge) nb = slot[2 * K * stride];
    float v[K];
    chain_cells<BETA, K>(v, s, x, y, nb);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = t0 - k;
      const bool on = has[k] && (unsigned)t < tl;
      s[k] = on ? v[k] : NEG_INF;
      st_if(at_row(oc[k], t, row), s[k], on);
    }
    if (BETA ? lane == 0 : lane == 31) xch[(i & 1) * MAX_WARPS + w] = BETA ? s[0] : s[K - 1];
    sync_sweep(threads);
  };

  // a ring of the next RING steps' inputs: a step reads its slot, then
  // refills it with the step RING ahead. The steps run in whole turns of
  // the ring; those past the strip's last diagonal find no cell (no copy,
  // no store), and the unrolled turn has no exit test.
  int t_step = (BETA ? d_hi - i_first : u_lo + i_first) - u0;  // cell 0's row, step computed
  int t_fetch = t_step;                                           // and step fetched
#pragma unroll
  for (int p = 0; p < RING; ++p, t_fetch += dir) fetch(t_fetch, p);
  for (int i0 = i_first; i0 < n; i0 += RING) {
#pragma unroll
    for (int p = 0; p < RING; ++p, t_step += dir, t_fetch += dir) {
      step(i0 + p, t_step, p);
      fetch(t_fetch, p);
    }
  }
  tc::cp_wait<0>();  // no copy outlives the strip
}

// The warp path (width W = ul + 1 <= WARP_WIDTH), two warps. Warp 0 runs the
// chain: lane l holds the cells u = 2l, 2l+1 of the current diagonal and
// writes them to the output itself. Warp 1 copies the lattice's rows into
// the bl and lb rings ahead of the chain, coalesced (cp.async, 4 bytes a
// lane). The rings are diagonal-major (cell (t, u) at ring row
// (t + u) % RING_DIAGS, column u), so the chain reads its two cells of a
// diagonal as one 8-byte access and a row's copy spreads over the banks.
// Warp 1 copies the rows in the sweep's order (alpha t = 0 up, beta
// t = tl - 1 down) in groups of CHUNK, three groups ahead, and the two warps
// meet at a named barrier every CHUNK steps: before chunk c, rows
// k < CHUNK * (c + 2) of that order have landed (the chunk needs
// k <= CHUNK * (c + 1)), and a row is at most 4 * CHUNK - 1 <= RING_DIAGS - W
// rows ahead, so it overwrites no diagonal the chain still reads. Alpha runs
// in push form: a cell keeps a + bl (its arc to (t+1, u)) and hands a + lb
// (its arc to (t, u+1)) up; the sums are those of the pull form.
// What set this shape (clock probes and variants in turns on an H100): the
// chain warp alone runs close to the latency of its dependent step; warp 1's
// copies beside it slow it far less than one warp loading its own inputs (a
// diagonal's cells lie in different rows: scattered) or staging its output
// through shared memory for warp 1 to write out in rows, since all of these
// share the SM's load/store and shared-memory pipe with the chain's shuffle
// and shared loads. The chain's own scattered stores cost little.
__device__ __forceinline__ void sync_pair() { asm volatile("bar.sync 2, 64;" ::: "memory"); }

__device__ __forceinline__ int ring_at(int d, int u) {
  return (d & (RING_DIAGS - 1)) * WARP_WIDTH + u;
}

template <bool BETA>
__device__ void sweep_warp(const Lattice& L, float* rings, int warp, int lane) {
  float* bl_ring = rings;
  float* lb_ring = rings + RING_DIAGS * WARP_WIDTH;
  const int width = L.ul + 1, tl = L.tl;
  // step i is the diagonal i (alpha) or d_hi - i (beta); step 0, which holds
  // only the origin or the terminal cell, is set apart
  const int d_hi = tl - 1 + width - 1, chunks = (d_hi + CHUNK - 1) / CHUNK;

  if (warp == 1) {
    auto row_of = [&](int k) { return BETA ? tl - 1 - k : k; };
    auto copy_group = [&](int g) {
      for (int k = g * CHUNK; k < min((g + 1) * CHUNK, tl); ++k) {
        const int t = row_of(k);
        for (int u = lane; u < width; u += 32) {
          const size_t src = (size_t)t * L.U1 + u;
          tc::cp_async4(bl_ring + ring_at(t + u, u), L.bl + src);
          tc::cp_async4(lb_ring + ring_at(t + u, u), L.lb + src);
        }
      }
      tc::cp_commit();
    };
    copy_group(0);
    copy_group(1);
    copy_group(2);
    tc::cp_wait<1>();
    sync_pair();
    for (int c = 0; c < chunks; ++c) {
      copy_group(c + 3);
      tc::cp_wait<1>();
      sync_pair();
    }
    tc::cp_wait<0>();
    return;
  }

  const int u0 = 2 * lane;
  const bool has0 = u0 < width, has1 = u0 + 1 < width;
  float c0, c1, e0 = NEG_INF, e1 = NEG_INF;  // alpha: c = a + bl, e = a + lb; beta: c = b
  sync_pair();
  if (BETA) {
    c0 = c1 = NEG_INF;
    if (lane == L.ul >> 1) {  // the terminal cell (tl - 1, ul), on diagonal d_hi
      const float v = L.term ? bl_ring[ring_at(d_hi, L.ul)] : NEG_INF;
      L.out[(size_t)(tl - 1) * L.U1 + L.ul] = v;
      (L.ul & 1 ? c1 : c0) = v;
    }
  } else {  // the origin (0, 0): cells off the lattice hold -1e30 + a finite input
    const float a0 = lane == 0 ? 0.f : NEG_INF;
    if (lane == 0) L.out[0] = 0.f;
    const float2 xb = *reinterpret_cast<const float2*>(bl_ring + ring_at(0, u0));
    const float2 xl = *reinterpret_cast<const float2*>(lb_ring + ring_at(0, u0));
    c0 = a0 + xb.x, c1 = NEG_INF + xb.y, e0 = a0 + xl.x, e1 = NEG_INF + xl.y;
  }
  for (int c = 0; c < chunks; ++c) {
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int i = 1 + c * CHUNK + j, d = BETA ? d_hi - i : i;
      const bool on0 = has0 && (unsigned)(d - u0) < (unsigned)tl;
      const bool on1 = has1 && (unsigned)(d - u0 - 1) < (unsigned)tl;
      const float2 xb = *reinterpret_cast<const float2*>(bl_ring + ring_at(d, u0));
      const float2 xl = *reinterpret_cast<const float2*>(lb_ring + ring_at(d, u0));
      float v0, v1;
      if (BETA) {
        float nb = __shfl_down_sync(FULL, c0, 1);
        if (lane == 31) nb = NEG_INF;
        v0 = lse(xb.x + c0, xl.x + c1);
        v1 = lse(xb.y + c1, xl.y + nb);
      } else {
        float nb = __shfl_up_sync(FULL, e1, 1);
        if (lane == 0) nb = NEG_INF;
        v0 = lse(c0, nb);
        v1 = lse(c1, e0);
      }
      v0 = on0 ? v0 : NEG_INF;
      v1 = on1 ? v1 : NEG_INF;
      st_if(L.out + (size_t)(d - u0) * L.U1 + u0, v0, on0);
      st_if(L.out + (size_t)(d - u0 - 1) * L.U1 + u0 + 1, v1, on1);
      if (BETA) {
        c0 = v0, c1 = v1;
      } else {
        c0 = v0 + xb.x, c1 = v1 + xb.y, e0 = v0 + xl.x, e1 = v1 + xl.y;
      }
    }
    sync_pair();
  }
}

// -1e30 in the cells outside the sample's lattice, one row per warp at a
// time: rows t < tl from column ul + 1 on, the rows past tl whole.
__device__ void fill_outside(const Lattice& L, int T, int warp, int warps, int lane) {
  for (int t = warp; t < T; t += warps) {
    float* row = L.out + (size_t)t * L.U1;
    for (int u = (t < L.tl ? L.ul + 1 : 0) + lane; u < L.U1; u += 32) row[u] = NEG_INF;
  }
}

template <bool BETA>
__global__ void __launch_bounds__(MAX_THREADS)
    rnnt_lattice_kernel(const float* __restrict__ blank_lp, const float* __restrict__ label_lp,
                        const int* __restrict__ t_lens, const int* __restrict__ u_lens,
                        float* __restrict__ out, int* __restrict__ plan, int T, int U1) {
  __shared__ float xch[2 * MAX_WARPS];  // the sweep warps' end cells, two diagonals
  // warp path: its three rings; block path: [RING][SLOTS][blockDim.x], each thread's inputs ahead
  extern __shared__ float4 smem_[];
  float* smem = reinterpret_cast<float*>(smem_);
  const int b = blockIdx.x;
  const size_t base = (size_t)b * T * U1;
  const int t_len = t_lens[b], u_len = u_lens[b];
  Lattice L{blank_lp + base, label_lp + base, out + base, U1, min(max(t_len, 0), T),
            min(u_len, U1 - 1), t_len <= T && u_len <= U1 - 1};
  if (L.tl == 0 || L.ul < 0) L.tl = 0, L.ul = -1;  // no valid cell
  const int width = L.ul + 1;
  const int warps = blockDim.x >> 5;
  // the warp path takes two warps: a block of one sends every sample to the block path
  const int path = width == 0 ? PATH_EMPTY
                   : width <= WARP_WIDTH && warps >= 2 ? PATH_WARP : PATH_BLOCK;
  // the block path's sweep warps, and its strips of u, each as wide as they hold
  const int sweep_warps = path == PATH_WARP    ? 2
                          : path == PATH_BLOCK ? min(warps, (width + WARP_WIDTH - 1) / WARP_WIDTH)
                                               : 0;
  const int strip = path == PATH_BLOCK ? sweep_warps * WARP_WIDTH : width;
  const int strips = width == 0 ? 0 : (width + strip - 1) / strip;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (plan != nullptr && tid == 0) {  // the path, and the dependent diagonals it sweeps
    plan[2 * b] = path;
    plan[2 * b + 1] = strips * (L.tl - 1) + width;
  }

  if (path == PATH_WARP) {
    // every entry of the input rings the chain reads is then finite
    for (int i = tid; i < 2 * RING_DIAGS * WARP_WIDTH / 4; i += blockDim.x)
      reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    if (warp < 2) sweep_warp<BETA>(L, smem, warp, lane);
  } else if (path == PATH_BLOCK && warp < sweep_warps) {
    for (int j = 0; j < strips; ++j) {
      const int s = BETA ? strips - 1 - j : j;
      sweep_strip<BETA, CELLS>(L, s * strip, min(width, (s + 1) * strip), tid, sweep_warps * 32,
                               xch, smem);
    }
  }
  if (sweep_warps < warps) {
    if (warp >= sweep_warps) fill_outside(L, T, warp - sweep_warps, warps - sweep_warps, lane);
  } else {
    fill_outside(L, T, warp, warps, lane);
  }
}

// The warp path's chain alone: `steps` dependent steps (the exchange with
// the neighbouring lane, one lse per cell, the select that masks a cell) on
// values held in registers, no loads or stores; out[0] = SM clock cycles and
// out[1] = global-timer nanoseconds around them, out[2] keeps the result live.
template <bool BETA>
__global__ void chain_probe_kernel(float x0, float y0, int steps, long long* out) {
  const int lane = threadIdx.x;
  float s[CELLS], x[CELLS], y[CELLS];
#pragma unroll
  for (int k = 0; k < CELLS; ++k) s[k] = -(float)(lane * CELLS + k), x[k] = x0, y[k] = y0;
  const bool on = lane < 31;
  __syncwarp();
  long long ns0, ns1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
  const long long c0 = clock64();
  for (int i = 0; i < steps; ++i) {
    float nb = BETA ? __shfl_down_sync(FULL, s[0], 1) : __shfl_up_sync(FULL, s[CELLS - 1], 1);
    float v[CELLS];
    chain_cells<BETA, CELLS>(v, s, x, y, nb);
#pragma unroll
    for (int k = 0; k < CELLS; ++k) s[k] = on ? v[k] : NEG_INF;
  }
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
  if (lane == 0) {
    out[0] = c1 - c0;
    out[1] = ns1 - ns0;
    out[2] = (long long)s[0];
  }
}

int launch(bool beta, const void* blank_lp, const void* label_lp, const void* t_lens,
           const void* u_lens, void* out, void* plan, int b, int t, int u1, int threads,
           void* stream) {
  if (threads % 32 != 0 || threads < 32 || threads > MAX_THREADS || t < 1 || u1 < 1)
    return (int)cudaErrorInvalidValue;
  auto kernel = beta ? rnnt_lattice_kernel<true> : rnnt_lattice_kernel<false>;
  const int smem = max(WARP_RINGS_BYTES, (int)sizeof(float) * RING * SLOTS * threads);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<b, threads, smem, (cudaStream_t)stream>>>(
      (const float*)blank_lp, (const float*)label_lp, (const int*)t_lens, (const int*)u_lens,
      (float*)out, (int*)plan, t, u1);
  return (int)cudaGetLastError();
}

}  // namespace

// blank_lp, label_lp: [b, t, u1] fp32 (the raw log-probs: the kernels apply
// the lattice mask themselves); t_lens, u_lens: [b] int32; alpha: [b, t, u1]
// fp32, every entry written; plan: null, or [b, 2] int32 that receives each
// sample's path (0 no valid cell, 1 warp, 2 block) and the dependent
// diagonals its sweep takes (each strip's t_len + width - 1, strips in
// turn). All contiguous. `threads` (a multiple of 32, at most 512) is the
// block; samples of width u_len + 1 <= 64 take the warp path when it holds
// two warps. Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int rnnt_alpha_f32(const void* blank_lp, const void* label_lp, const void* t_lens,
                              const void* u_lens, void* alpha, void* plan, int b, int t, int u1,
                              int threads, void* stream) {
  return launch(false, blank_lp, label_lp, t_lens, u_lens, alpha, plan, b, t, u1, threads,
                stream);
}

// As above; beta: [b, t, u1] fp32, beta[b, 0, 0] is the log-likelihood.
extern "C" int rnnt_beta_f32(const void* blank_lp, const void* label_lp, const void* t_lens,
                             const void* u_lens, void* beta, void* plan, int b, int t, int u1,
                             int threads, void* stream) {
  return launch(true, blank_lp, label_lp, t_lens, u_lens, beta, plan, b, t, u1, threads,
                stream);
}

// One warp of the chain probe on `stream`; out: 3 int64 on the device.
extern "C" int rnnt_lattice_chain_probe(int beta, float x, float y, int steps, void* out,
                                        void* stream) {
  auto kernel = beta ? chain_probe_kernel<true> : chain_probe_kernel<false>;
  kernel<<<1, 32, 0, (cudaStream_t)stream>>>(x, y, steps, (long long*)out);
  return (int)cudaGetLastError();
}
