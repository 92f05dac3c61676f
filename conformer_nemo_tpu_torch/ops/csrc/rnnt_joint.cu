// RNN-T flash joint (K4): the joint network fused with the loss's
// log-softmax prep, forward and backward, for NVIDIA Hopper (sm_90a), in
// bf16 and fp16 (one template; fp32 is rnnt_joint_f32.cu), plain C interface.
//
// Replaces the TPU kernels `_make_fwd_kernel` (:166, via `joint_flash_fwd`
// :326 -> pallas_call :344) and `_make_bwd_kernel` (:191, via
// `joint_flash_bwd` :372 -> pallas_call :393) of
// conformer_nemo_tpu/ops/pallas/rnnt_joint_kernel.py. For each lattice cell
// (b, t, u), with the vocabulary split blank-last (`_split_blank`: label
// columns 0..V-2, blank column V-1 = VL):
//
//   h     = drop(act(e[b, t] + p[b, u]))      [H], the compute dtype dt
//   lab_c = dt(dt(h . W[:, c]) + bias[c])   (fp32 product, c < VL)
//   blank = dt(dt(h . W[:, VL]) + bias[VL]) (fp32 dot; the forward's
//           product takes it as column VL)
//   lse   = logsumexp(lab, blank); blank_lp = blank - lse; label_lp = lab[tgt] - lse
//
// The backward recomputes the tile and forms, per cell,
//   dlab_c = clamp(softmax_c * total - gy 1[c = tgt]) * g[b],
//   dblank = clamp(softmax_blank * total - gb) * g[b],
//   dh = dt(dt(dlab) . W_lab^T + dblank * W[:, VL]), dropout, then
//   dx = dh * act'(x) in dt, and reduces
//   de[b, t] = sum_u dx, dp[b, u] = sum_t dx, dW_lab = sum h^T dt(dlab),
//   dW[:, VL] = sum h * dblank, db = sum dlab, sum dblank.
// Every rounding point is the TPU kernel's (`_joint_tile`, the backward's
// dlab cast and dx in dt), so the kernels follow the plain version to the
// dtype's rounding. The [B, T, U+1, V] logits never reach device memory.
// fp16 differs from bf16 only in the product's operand type (mma.sync's f16
// variant), the conversions and the tensor map's element type.
//
// Dropout: murmur3's fmix32 of (index ^ seed) over the padded
// [B, Tp, U+1, H] layout of the TPU kernels, Tp = ceil(T / bt) * bt with the
// config's bt; index arithmetic in uint32 with wrap-around
// (`_tile_keep`); keep iff (bits >> 24) >= drop_t, rescaled by
// 1 / (1 - drop_t / 256). The kernels tile rows their own way but compute
// the index from (b, t, u, h), so the mask is `hash_keep_mask_reference`'s
// bit for bit. `hash_base` is added to every index: a data-parallel rank
// passes its first row's offset in the global batch's layout, so that its
// rows draw the mask of the same rows in one process's run of that batch.
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
// Design:
//   * forward: a persistent grid (a block per SM) walks the lattice's cells
//     in tiles of 128 (64 where H is too wide for 128 rows: `fwd_rows`),
//     numbered as the backward numbers them (sample-major, then t-major,
//     from the per-sample offsets, so the cell count stays on the card);
//     block x takes tiles x, x + gridDim.x, ... and also writes the
//     sentinels of the full [B, T, U+1] index outside the lattice, in a
//     grid-stride loop. Four (two) row groups of 32 cells x four column
//     groups make 16 (8) consumer warps; one more warp, the producer,
//     streams W as 64 x 64 tensor copies (128-byte swizzle, zeros past W's
//     edges) into a ring of three 2-box slots with full/empty mbarriers:
//     128 columns x 64 hidden rows a piece, every piece of every tile in one
//     sequence, so the next tile's first pieces land while its h is built.
//     h is built once per cell into shared memory from 16-byte loads of e
//     and p (`hidden8`, the hash dropout in registers). The logits come
//     from mma.sync m16n8k16 (ldmatrix fragments of h and of the swizzled
//     boxes) into fp32 registers, a 128-column chunk at a time: each warp
//     holds 32 rows x 32 columns (16 of each box), rounds them as the TPU
//     kernel does, picks the target and the blank (column VL of W: the
//     blank joins the product) off its fragments, and runs the online max
//     by quad shuffles and its lanes' sums; the four column groups' (max,
//     sum) meet once per tile through shared memory. No fp32 logits tile
//     exists anywhere. Range: H (padded to a multiple of 16 by the wrapper)
//     up to what `fwd_rows`'s layouts fit in a block's shared memory
//     (128-row tiles to H 672, 64-row tiles to H 1376), any V >= 2.
//     What decided the shape (variants in turns on an H100): with two
//     column groups (8 consumer warps) building h, the dropout hash per
//     element, took close to half of the kernel's time, and more loads in
//     flight did not shorten it: it is bound by instruction issue, so four
//     column groups (16 warps) build it faster, and the products gain the
//     warps too.
//   * backward: three kernels, no atomics, so every output is bitwise the
//     same from call to call. What the card asks of it: the tensor cores
//     fed from registers and ldmatrix, W arriving in 16-byte vectors ahead
//     of use, and as many warps as one block per SM allows (h and the W
//     ring fill most of its 227 KB at H 1376); dW's [H, VL] sum cannot stay in one
//     block, and reading, adding to and writing back a per-block fp32 slice
//     of it per 64 cells moves gigabytes, so dW is a product of its own over
//     dt dlab kept in scratch; cross-block sums need fixed orders and
//     scratch that does not grow with B * T * (U+1) * H. The lattice's
//     cells are numbered sample-major, t-major, and processed in windows
//     of at most a fixed cell count (the wrapper sizes a window so that
//     its scratch stays under a fixed byte budget; the windows cover
//     B * T * (U+1) cells, so the lattice's own count never leaves the card,
//     and a window past it exits at once); per window:
//     (cells) 16 warps per 64 cells (4 row blocks x 4 column groups, for
//          latency hiding at one block per SM): h built once per element
//          into shared memory from 16-byte loads of e and p, and act' (0
//          where dropped) beside it into the window's dx scratch, which
//          holds it until dx takes its place (a second 64 x H tile in
//          shared memory would stop the kernel at H 640);
//          the logits [64 x VLp] by mma.sync m16n8k16 (ldmatrix fragments,
//          accumulators in registers) with W_pad's k-slices arriving through
//          a 3-stage cp.async ring (2 stages where 3 do not fit beside h:
//          past H 1008 at 320 label columns); dlab in registers, its fp32 column sums
//          (db) reduced by shuffles in a fixed order, its bf16 copy into
//          shared memory and the window's dlab scratch; dh = dlab W_lab^T
//          by mma.sync from the same zero-padded W_pad (row-major [H, VLp]:
//          ldmatrix without transpose gives W_lab^T's fragments, so both
//          products read 16-byte vectors) through a 2-stage ring of 64
//          hidden rows; dx = dt(dh * act') into the window's dx scratch.
//          The cells kernel also writes h (as built) to the window's scratch.
//          A label block wider than 320 columns (the accumulators a warp
//          holds) takes passes of 320: each pass reloads h from the scratch,
//          forms its columns' logits and dlab, and adds its share of dh to
//          an fp32 scratch row that the last pass rounds, in pass order.
//     (sums) dW_lab = h^T dt(dlab) as a split-K product over the window's
//          cells with a fixed number of splits (KSPLIT), each block owning
//          64 hidden rows x up to 320 columns in registers, h and dlab arriving
//          through a 2-stage cp.async ring; dW[:, VL] = sum h * dblank in
//          fp32 beside it; de (over u) and dp (over t) summed from the dx
//          scratch, one thread per pair of outputs in a fixed order; db from
//          the per-tile partials. Each adds to fp32 accumulators, the
//          windows in order.
//     (reduce) sums the K splits into dW, writes db and de in e's dtype.
//   The TPU kernel carries dp, dW and db across its sequential grid; Hopper
//   blocks run in any order, hence the accumulators and the fixed orders.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"
#include "rnnt_joint_common.cuh"
#include "tensor_core.cuh"

using namespace rj;
using namespace tc;

namespace {

// ---------------------------------------------------------------------------
// shared helpers, and the backward's tiling constants (the mma.sync,
// ldmatrix, cp.async, mbarrier and tensor-copy helpers are in tensor_core.cuh;
// the dtype's rounding, the hash and the lattice in rnnt_joint_common.cuh).
// Elements travel as 16-bit words in bf16 containers whatever K says they are.
// ---------------------------------------------------------------------------

constexpr int CELL_THREADS = 512;  // cells kernel: 16 warps, 4 row blocks x 4 column groups
constexpr int NTQ = 10;            // n-tiles of 8 columns per cells-kernel warp
constexpr int PASS_COLS = 4 * 8 * NTQ;  // label columns per pass over the block: 320
constexpr int NTW = PASS_COLS / 16;  // n-tiles per sums-kernel warp
constexpr int KSL = 32;          // depth of a W slice in the logits ring
constexpr int HCH = 64;          // hidden columns per dh chunk (and per dW block)

// Columns of the padded label block (VLp, a multiple of 32) that one pass
// holds; a wider block takes ceil(VLp / 320) passes.
__host__ __device__ inline int pass_cols(int VLp) { return VLp < PASS_COLS ? VLp : PASS_COLS; }

// Eight hidden units h0..h0+7 of cell (b, t, u): x = dt(e + p), h =
// drop(act(x)) and g = act'(x), zero where dropped (so dx = dh * g).
template <int K>
__device__ inline void hidden8(const Joint<K>& J, int b, int t, int u, int h0, uint4& hv,
                               uint4& gv) {
  const uint4 ev = __ldg(reinterpret_cast<const uint4*>(J.e + ((size_t)b * J.T + t) * J.H + h0));
  const uint4 pv = __ldg(reinterpret_cast<const uint4*>(J.p + ((size_t)b * J.U1 + u) * J.H + h0));
  const bf16* e8 = reinterpret_cast<const bf16*>(&ev);
  const bf16* p8 = reinterpret_cast<const bf16*>(&pv);
  uint32_t hw[4], gw[4];
  const uint32_t row = hash_row(J, b, t, u);
#pragma unroll
  for (int k = 0; k < 8; k += 2) {
    float hh[2], gg[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      hidden_unit(J, rnd<K>(cvt<K>(e8[k + i]) + cvt<K>(p8[k + i])), row, h0 + k + i, hh[i], gg[i]);
    hw[k / 2] = pack<K == F16>(hh[0], hh[1]);
    gw[k / 2] = pack<K == F16>(gg[0], gg[1]);
  }
  hv = make_uint4(hw[0], hw[1], hw[2], hw[3]);
  gv = make_uint4(gw[0], gw[1], gw[2], gw[3]);
}

// rows [r0, r0 + nr) x [0, ncol) of a 16-bit [.., ld_g] array into smem [..][ld_s]
// by cp.async (16-byte vectors; ncol a multiple of 8); rows past `rmax` zero.
__device__ inline void stage_rows(bf16* s, int ld_s, const bf16* g, int ld_g, int r0, int nr,
                                  int rmax, int ncol) {
  const int vec = ncol / 8;
  for (int i = threadIdx.x; i < nr * vec; i += blockDim.x) {
    const int r = i / vec, c = (i % vec) * 8;
    bf16* dst = s + (size_t)r * ld_s + c;
    if (r0 + r < rmax) cp_async16(dst, g + (size_t)(r0 + r) * ld_g + c);
    else *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// ---------------------------------------------------------------------------
// forward: the logits of each tile of lattice cells, their log-sum-exp, the
// blank and target log-probabilities
// ---------------------------------------------------------------------------

constexpr int FBOX = 64;     // columns and hidden rows of a W tensor-copy box (128 bytes a row)
constexpr int FBOXES = 2;    // boxes a ring slot holds: a chunk of 128 columns
constexpr int FCG = 4;       // column groups: warp cg takes columns FCW cg.. of each box
constexpr int FCW = FBOX / FCG;  // columns a warp takes of each box
constexpr int FNT = FCW / 8;     // its n-tiles of 8 columns in each box
constexpr int FSLOT = 3;     // ring slots
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t FBOX_BYTES = sizeof(bf16) * FBOX * FBOX;

// a barrier of the first n threads of the block (the consumer warps)
__device__ inline void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

struct FwdLayout {
  int ldh;  // row stride of the h tile, in elements
  // byte offsets from the block's 1024-aligned base, and the dynamic shared
  // memory a launch asks for (1024 bytes of it to align)
  size_t ring, bar, hs, meta, total;
};

// rows: the cells of a tile (128 or 64)
__host__ __device__ inline FwdLayout fwd_layout(int rows, int H) {
  FwdLayout L;
  L.ldh = H + 8;  // an odd number of 16-byte units: ldmatrix rows hit distinct banks
  L.ring = 0;     // swizzled boxes: 1024-byte aligned
  L.bar = FSLOT * FBOXES * FBOX_BYTES;
  L.hs = L.bar + align128(sizeof(uint64_t) * 2 * FSLOT);
  L.meta = L.hs + align128(sizeof(bf16) * rows * (size_t)L.ldh);
  // per row b, t, u, target (int), label and blank logits, and (m, l) of
  // each column group (float)
  L.total = L.meta + align128((sizeof(int) * 4 + sizeof(float) * (2 + 2 * FCG)) * rows) + 1024;
  return L;
}

// The tile height a launch at (padded) H takes: 128 cells where the layout
// fits in a block's shared memory, else 64; 0 where neither fits.
__host__ __device__ inline int fwd_rows(int H) {
  if (fwd_layout(128, H).total <= flash::SMEM_BLOCK) return 128;
  return fwd_layout(64, H).total <= flash::SMEM_BLOCK ? 64 : 0;
}

// RG row groups of 32 cells (a tile of 32 RG cells) x FCG column groups:
// FCG RG consumer warps, then one producer warp. A persistent grid: block x
// takes the lattice's tiles x, x + gridDim.x, ...
template <int RG, int K>
__global__ void __launch_bounds__(32 * FCG * RG + 32, 1)
joint_fwd_kernel(const __grid_constant__ CUtensorMap tw, Joint<K> J, float* __restrict__ blank_lp,
                 float* __restrict__ label_lp, float* __restrict__ lse_out) {
  constexpr int ROWS = 32 * RG, NCW = FCG * RG, NCT = 32 * NCW;
  constexpr bool F = K == F16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const FwdLayout L = fwd_layout(ROWS, J.H);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);  // a slot's boxes have landed
  uint64_t* empty = full + FSLOT;                              // every consumer warp is done
  bf16* Hs = reinterpret_cast<bf16*>(smem + L.hs);
  int* m_b = reinterpret_cast<int*>(smem + L.meta);
  int* m_t = m_b + ROWS;
  int* m_u = m_t + ROWS;
  int* m_tgt = m_u + ROWS;
  float* m_lab = reinterpret_cast<float*>(m_tgt + ROWS);
  float* m_blank = m_lab + ROWS;
  float* red_m = m_blank + ROWS;  // [FCG][ROWS]
  float* red_l = red_m + FCG * ROWS;

  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const long long n_all = J.off[J.B];  // the lattice's cells
  const int n_boxes = (J.V + FBOX - 1) / FBOX;  // label columns and blank, zeros past V
  const int n_chunks = (n_boxes + FBOXES - 1) / FBOXES;
  const int nk = (J.H + FBOX - 1) / FBOX;  // hidden slices of a chunk
  const int per_tile = n_chunks * nk;      // ring pieces a tile takes

  if (threadIdx.x == 0) {
    for (int s = 0; s < FSLOT; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == NCW) {
    // the producer: W's boxes for every piece of every tile of this block, a
    // slot as soon as every consumer warp has released it
    if (l == 0) {
      int i = 0;
      for (long long tile = blockIdx.x; tile * ROWS < n_all; tile += gridDim.x)
        for (int q = 0; q < per_tile; ++q, ++i) {
          const int s = i % FSLOT;
          if (i >= FSLOT) mbar_wait(&empty[s], (i / FSLOT - 1) & 1);
          const int ch = q / nk, ks = q - ch * nk;
          const int nb = min(FBOXES, n_boxes - FBOXES * ch);
          mbar_arrive_expect(&full[s], nb * FBOX_BYTES);
          for (int j = 0; j < nb; ++j)
            tma_load_2d(smem + L.ring + (s * FBOXES + j) * FBOX_BYTES, &tw,
                        (FBOXES * ch + j) * FBOX, ks * FBOX, &full[s]);
        }
    }
    return;
  }

  // the sentinels of every cell outside its sample's lattice (grid-stride
  // over the full [B, T, U1] index), while the first boxes are in flight
  const long long n_full = (long long)J.B * J.T * J.U1;
  for (long long i = (long long)blockIdx.x * NCT + threadIdx.x; i < n_full;
       i += (long long)gridDim.x * NCT) {
    const int u = (int)(i % J.U1);
    const long long bt = i / J.U1;
    const Lat la = lat_of(J, (int)(bt / J.T));
    if ((int)(bt % J.T) >= la.n_t || u >= la.n_u) {
      blank_lp[i] = label_lp[i] = NEG_INF;
      lse_out[i] = -NEG_INF;
    }
  }

  // consumer warp (rg, cg): cells 32 rg..32 rg + 31 of the tile, columns
  // FCW cg..FCW cg + FCW - 1 of each 64-column box; lane l holds rows g, g + 8
  // of each 16-row half (q = 2 mt + half) and columns c2, c2 + 1 of each n-tile
  const int rg = warp % RG, cg = warp / RG;
  const int g = l >> 2, c2 = 2 * (l & 3);
  const int H = J.H, ldh = L.ldh, hv8 = H / 8;
  int row[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) row[q] = 32 * rg + 16 * (q >> 1) + g + 8 * (q & 1);
  int i = 0;  // pieces taken so far, as the producer counts them
  for (long long tile = blockIdx.x; tile * ROWS < n_all; tile += gridDim.x) {
    consumers_sync(NCT);  // the previous tile's rows are out
    if (threadIdx.x < ROWS) {
      const int r = threadIdx.x;
      const long long c = tile * ROWS + r;
      int b = -1, t = 0, u = 0;
      if (c < n_all) cell_btu(J, c, b, t, u);
      m_b[r] = b;
      m_t[r] = t;
      m_u[r] = u;
      m_tgt[r] = b >= 0 ? target_of(J, b, u) : -1;
      m_lab[r] = m_blank[r] = 0.f;
    }
    consumers_sync(NCT);
    // h = drop(act(e + p)) once per element, from 16-byte loads (zero rows
    // past the lattice)
    for (int k = threadIdx.x; k < ROWS * hv8; k += NCT) {
      const int r = k / hv8, h0 = (k - r * hv8) * 8;
      uint4 hv = make_uint4(0, 0, 0, 0), gv;
      if (m_b[r] >= 0) hidden8(J, m_b[r], m_t[r], m_u[r], h0, hv, gv);
      *reinterpret_cast<uint4*>(Hs + (size_t)r * ldh + h0) = hv;
    }
    consumers_sync(NCT);

    int tgt[4];
    float m_run[4], l_run[4];  // running max (over the warp's columns) and this lane's sum
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      tgt[q] = m_tgt[row[q]];
      m_run[q] = NEG_INF;
      l_run[q] = 0.f;
    }
    float acc[FBOXES][2][FNT][4];  // [box][m-tile][n-tile][fragment]
    for (int q = 0; q < per_tile; ++q, ++i) {
      const int ch = q / nk, ks = q - ch * nk;
      const int nb = min(FBOXES, n_boxes - FBOXES * ch);
      if (ks == 0) {
#pragma unroll
        for (int j = 0; j < FBOXES; ++j)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int n = 0; n < FNT; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[j][mt][n][e] = 0.f;
      }
      const int s = i % FSLOT;
      mbar_wait(&full[s], (i / FSLOT) & 1);
      const bf16* P = reinterpret_cast<const bf16*>(smem + L.ring + s * FBOXES * FBOX_BYTES);
      const int k0 = ks * FBOX, ksteps = min(FBOX, H - k0) / 16;
#pragma unroll
      for (int kk = 0; kk < FBOX / 16; ++kk) {
        if (kk < ksteps) {
          uint32_t a[2][4];
          ldsm4(a[0], a_addr(Hs, ldh, 32 * rg, k0 + 16 * kk, l));
          ldsm4(a[1], a_addr(Hs, ldh, 32 * rg + 16, k0 + 16 * kk, l));
#pragma unroll
          for (int j = 0; j < FBOXES; ++j) {
            if (j < nb) {
#pragma unroll
              for (int n = 0; n < FNT / 2; ++n) {
                uint32_t bb[4];  // hidden rows 16 kk.., columns FCW cg + 16 n.. as two n-tiles
                ldsm4t(bb, swz128(P + j * FBOX * FBOX, 16 * kk + (l & 7) + ((l >> 3) & 1) * 8,
                                  FCW * cg + 16 * n + (l >> 4) * 8));
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                  mma<F>(acc[j][mt][2 * n], a[mt], bb[0], bb[1]);
                  mma<F>(acc[j][mt][2 * n + 1], a[mt], bb[2], bb[3]);
                }
              }
            }
          }
        }
      }
      __syncwarp();
      if (l == 0) mbar_arrive(&empty[s]);  // this warp is done with the slot
      if (ks < nk - 1) continue;

      // the chunk's logits, rounded as the TPU kernel rounds them; the
      // target and blank columns picked off; the online max and sum
      const int cbase = ch * FBOXES * FBOX + FCW * cg + c2;
      float bv[FBOXES][FNT][2];  // this lane's columns' bias
#pragma unroll
      for (int j = 0; j < FBOXES; ++j)
#pragma unroll
        for (int n = 0; n < FNT; ++n)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int c = cbase + j * FBOX + 8 * n + k;
            bv[j][n][k] = j < nb && c < J.V ? cvt<K>(J.bias[c]) : 0.f;
          }
      float mx[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < FBOXES; ++j)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int n = 0; n < FNT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = cbase + j * FBOX + 8 * n + (e & 1), qr = 2 * mt + (e >> 1);
              float x = NEG_INF;
              if (j < nb && c < J.V) {
                x = rnd<K>(rnd<K>(acc[j][mt][n][e]) + bv[j][n][e & 1]);
                if (c == tgt[qr]) m_lab[row[qr]] = x;
                if (c == J.VL) m_blank[row[qr]] = x;
              }
              acc[j][mt][n][e] = x;
              mx[qr] = fmaxf(mx[qr], x);
            }
      float m2[4];  // the new running max in the exp2 domain
#pragma unroll
      for (int qr = 0; qr < 4; ++qr) {
        mx[qr] = fmaxf(mx[qr], __shfl_xor_sync(0xffffffffu, mx[qr], 1));
        mx[qr] = fmaxf(mx[qr], __shfl_xor_sync(0xffffffffu, mx[qr], 2));
        const float m_new = fmaxf(m_run[qr], mx[qr]);
        // both maxima scaled by one rounded product each (no fused
        // multiply-add): a column group that has seen only pad columns keeps
        // m = -1e30, and its rescale must be exp2(0) = 1 on its sum of 0
        m2[qr] = __fmul_rn(m_new, LOG2E);
        l_run[qr] *= exp2f(__fmul_rn(m_run[qr], LOG2E) - m2[qr]);
        m_run[qr] = m_new;
      }
#pragma unroll
      for (int j = 0; j < FBOXES; ++j)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int n = 0; n < FNT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = cbase + j * FBOX + 8 * n + (e & 1), qr = 2 * mt + (e >> 1);
              // columns past V are no logits: they enter no sum (a column
              // group may hold none but pad columns so far)
              if (j < nb && c < J.V) l_run[qr] += exp2f(fmaf(acc[j][mt][n][e], LOG2E, -m2[qr]));
            }
    }

    // each row's (m, l) from every column group, then lse and the outputs
#pragma unroll
    for (int qr = 0; qr < 4; ++qr) {
      l_run[qr] += __shfl_xor_sync(0xffffffffu, l_run[qr], 1);
      l_run[qr] += __shfl_xor_sync(0xffffffffu, l_run[qr], 2);
      if ((l & 3) == 0) {
        red_m[cg * ROWS + row[qr]] = m_run[qr];
        red_l[cg * ROWS + row[qr]] = l_run[qr];
      }
    }
    consumers_sync(NCT);
    if (threadIdx.x < ROWS && m_b[threadIdx.x] >= 0) {
      const int r = threadIdx.x;
      float m = NEG_INF, sum = 0.f;
#pragma unroll
      for (int k = 0; k < FCG; ++k) m = fmaxf(m, red_m[k * ROWS + r]);
#pragma unroll
      for (int k = 0; k < FCG; ++k) sum += red_l[k * ROWS + r] * expf(red_m[k * ROWS + r] - m);
      const float lse = m + logf(sum);
      const size_t o = ((size_t)m_b[r] * J.T + m_t[r]) * J.U1 + m_u[r];
      blank_lp[o] = m_blank[r] - lse;
      label_lp[o] = m_lab[r] - lse;
      lse_out[o] = lse;
    }
  }
}

template <int RG, int K>
int launch_fwd(const Joint<K>& J, const void* w, int vt, int grid, float* blank_lp,
               float* label_lp, float* lse, cudaStream_t stream) {
  CUtensorMap tw;
  if (!flash::tensor_map(&tw, w, vt, J.H, FBOX,
                         K == F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16))
    return (int)cudaErrorNotSupported;
  const size_t smem = fwd_layout(32 * RG, J.H).total;
  cudaError_t err = cudaFuncSetAttribute(joint_fwd_kernel<RG, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  joint_fwd_kernel<RG, K><<<grid, 32 * FCG * RG + 32, smem, stream>>>(tw, J, blank_lp, label_lp,
                                                                       lse);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward (cells): per 64 lattice cells of a window, dlab, dblank and dx
// ---------------------------------------------------------------------------

struct CellLayout {
  int ldh, ldl, stages;
  size_t hs, ring, dl, dbw, meta, total;
};

// the layout with `stages` slices in the logits ring
__host__ __device__ inline CellLayout cell_layout_n(int H, int VLp, int stages) {
  CellLayout L;
  const int PW = pass_cols(VLp);
  L.ldh = H + 8;
  L.ldl = PW + 8;
  L.stages = stages;
  size_t off = 0;
  // Hs: h; after the logits the region holds the dh ring (2 x [64][ldl])
  const size_t hs_elems = BROWS * (size_t)(L.ldh > 2 * L.ldl ? L.ldh : 2 * L.ldl);
  L.hs = off; off = align128(off + sizeof(bf16) * hs_elems);
  // the logits ring (stages x [32][ldl]); after the logits, Dl and the db partial
  L.ring = off;
  L.dl = off;
  L.dbw = align128(L.dl + sizeof(bf16) * BROWS * (size_t)L.ldl);
  const size_t ring_end = L.ring + sizeof(bf16) * stages * KSL * (size_t)L.ldl;
  const size_t dl_end = L.dbw + sizeof(float) * 4 * (size_t)PW;
  off = align128(ring_end > dl_end ? ring_end : dl_end);
  L.meta = off; off = align128(off + sizeof(float) * BROWS * 10);
  L.total = off;
  return L;
}

// three ring stages where they fit in a block's shared memory, else two
__host__ __device__ inline CellLayout cell_layout(int H, int VLp) {
  const CellLayout L = cell_layout_n(H, VLp, 3);
  return L.total <= flash::SMEM_BLOCK ? L : cell_layout_n(H, VLp, 2);
}

struct CellMeta {
  int *b, *t, *u, *tgt;
  float *lse, *total, *gb, *gy, *g, *dblank;
};
__device__ inline CellMeta cell_meta_at(unsigned char* p) {
  CellMeta M;
  M.b = reinterpret_cast<int*>(p);
  M.t = M.b + BROWS;
  M.u = M.t + BROWS;
  M.tgt = M.u + BROWS;
  M.lse = reinterpret_cast<float*>(M.tgt + BROWS);
  M.total = M.lse + BROWS;
  M.gb = M.total + BROWS;
  M.gy = M.gb + BROWS;
  M.g = M.gy + BROWS;
  M.dblank = M.g + BROWS;
  return M;
}

template <int K>
__global__ void __launch_bounds__(CELL_THREADS)
joint_bwd_cells_kernel(Joint<K> J, const bf16* __restrict__ w_pad, const bf16* __restrict__ w_blank,
                       int VLp, const float* __restrict__ lse, const float* __restrict__ total,
                       const float* __restrict__ gb, const float* __restrict__ gy,
                       const float* __restrict__ g, float clamp, long long c0, int win,
                       bf16* __restrict__ dlab_out, float* __restrict__ dblank_out,
                       bf16* __restrict__ dx_out, bf16* __restrict__ h_out,
                       float* __restrict__ dbl_part, float* __restrict__ dh_part) {
  constexpr bool F = K == F16;
  extern __shared__ __align__(128) unsigned char smem[];
  const CellLayout L = cell_layout(J.H, VLp);
  bf16* Hs = reinterpret_cast<bf16*>(smem + L.hs);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  bf16* Dl = reinterpret_cast<bf16*>(smem + L.dl);
  float* dbw = reinterpret_cast<float*>(smem + L.dbw);
  CellMeta M = cell_meta_at(smem + L.meta);

  const long long n_all = J.off[J.B];
  const long long tile0 = c0 + (long long)blockIdx.x * BROWS;  // first global cell
  if (tile0 >= n_all || (long long)blockIdx.x * BROWS >= win) return;
  const int rows = (int)min((long long)BROWS, n_all - tile0);
  const size_t row0 = (size_t)(tile0 - c0);  // the tile's first row in the window's scratch
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int mblk = warp & 3, nq = warp >> 2;  // row block, column group
  const int H = J.H, VL = J.VL, ldh = L.ldh, ldl = L.ldl, ns = L.stages;
  const int hv8 = H / 8;

  if (threadIdx.x < BROWS) {
    const int r = threadIdx.x;
    int b = -1, t = 0, u = 0;
    if (r < rows) cell_btu(J, tile0 + r, b, t, u);
    M.b[r] = b;
    M.t[r] = t;
    M.u[r] = u;
    if (b >= 0) {
      const size_t o = ((size_t)b * J.T + t) * J.U1 + u;
      M.tgt[r] = target_of(J, b, u);
      M.lse[r] = lse[o];
      M.total[r] = total[o];
      M.gb[r] = gb[o];
      M.gy[r] = gy[o];
      M.g[r] = g[b];
    } else {
      M.tgt[r] = -1;
      M.lse[r] = M.total[r] = M.gb[r] = M.gy[r] = M.g[r] = 0.f;
    }
  }

  // The label block in passes of at most 320 columns (one pass up to
  // VLp 320): each pass forms its columns' logits and dlab and adds their
  // share of dh; dh stays in fp32 (dh_part, this block's rows) until the
  // last pass rounds it.
  const int n_pass = (VLp + PASS_COLS - 1) / PASS_COLS;
  const int n_sl = (H + KSL - 1) / KSL;
  for (int pass = 0; pass < n_pass; ++pass) {
    const int p0 = pass * PASS_COLS, PW = min(PASS_COLS, VLp - p0);
    const bool last = pass == n_pass - 1;
    if (pass > 0) {  // h again, from this tile's rows of the window's scratch
      stage_rows(Hs, ldh, h_out + row0 * H, H, 0, BROWS, rows, H);
      cp_commit();
    }
    // the first W slices of the logits ring (ns - 1 of them), in flight
    // while h is built
    auto load_slice = [&](int s) {
      const int k0 = s * KSL;
      stage_rows(ring + (size_t)(s % ns) * KSL * ldl, ldl, w_pad + p0, VLp, k0,
                 min(KSL, H - k0), H, PW);
    };
    load_slice(0);
    cp_commit();
    if (ns == 3) {
      if (n_sl > 1) load_slice(1);
      cp_commit();
    }
    __syncthreads();

    if (pass == 0) {
      // h into shared memory, and act' (0 where dropped) into the dx
      // scratch, once per element
      for (int i = threadIdx.x; i < BROWS * hv8; i += CELL_THREADS) {
        const int r = i / hv8, h0 = (i % hv8) * 8;
        uint4 hv = make_uint4(0, 0, 0, 0), gv = make_uint4(0, 0, 0, 0);
        if (M.b[r] >= 0) hidden8(J, M.b[r], M.t[r], M.u[r], h0, hv, gv);
        *reinterpret_cast<uint4*>(Hs + (size_t)r * ldh + h0) = hv;
        if (r < rows) *reinterpret_cast<uint4*>(dx_out + (row0 + r) * H + h0) = gv;
      }
      __syncthreads();
      // h into the window's scratch for the dW product (16-byte vectors)
      for (int i = threadIdx.x; i < rows * hv8; i += CELL_THREADS) {
        const int r = i / hv8, h0 = (i % hv8) * 8;
        *reinterpret_cast<uint4*>(h_out + (row0 + r) * H + h0) =
            *reinterpret_cast<const uint4*>(Hs + (size_t)r * ldh + h0);
      }

      // blank logit: eight lanes per row, the fp32 row dot rounded, + bias[VL]
      const int r = threadIdx.x / 8, q = threadIdx.x % 8;
      float s = 0.f;
      for (int h = 2 * q; h < H; h += 16) {
        const float2 x = cvt2<K>(Hs + (size_t)r * ldh + h);
        const float2 wb = cvt2<K>(w_blank + h);
        s += x.x * wb.x + x.y * wb.y;
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if (q == 0) {
        float d = 0.f;
        if (M.b[r] >= 0) {
          const float blank = rnd<K>(rnd<K>(s) + cvt<K>(J.bias[VL]));
          d = clamp_g(expf(blank - M.lse[r]) * M.total[r] - M.gb[r], clamp, M.g[r]);
          dblank_out[row0 + r] = d;
        }
        M.dblank[r] = d;
      }
    }

    // the pass's logits [64 x PW] = Hs @ W_pad[:, p0 : p0 + PW], accumulators
    // in registers
    const int nt = PW / 32;  // n-tiles per column group
    const int cb = nq * (PW / 4);
    float acc[NTQ][4];
#pragma unroll
    for (int j = 0; j < NTQ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int s = 0; s < n_sl; ++s) {
      if (ns == 3) cp_wait<1>();
      else cp_wait<0>();
      __syncthreads();
      if (s + ns - 1 < n_sl) load_slice(s + ns - 1);
      cp_commit();
      const bf16* Ws = ring + (size_t)(s % ns) * KSL * ldl;
      const int ks = min(KSL, H - s * KSL) / 16;
      for (int kk = 0; kk < ks; ++kk) {
        uint32_t a[4];
        ldsm4(a, a_addr(Hs, ldh, 16 * mblk, s * KSL + 16 * kk, l));
#pragma unroll
        for (int j = 0; j < NTQ; j += 2) {
          if (j + 1 < NTQ && j + 1 < nt) {
            uint32_t bb[4];
            ldsm4t(bb, bt_addr(Ws, ldl, 16 * kk, cb + 8 * j, l));
            mma<F>(acc[j], a, bb[0], bb[1]);
            mma<F>(acc[j + 1], a, bb[2], bb[3]);
          } else if (j < nt) {
            uint32_t bb[2];
            ldsm2t(bb, bt_addr(Ws, ldl, 16 * kk, cb + 8 * j, l & 15));
            mma<F>(acc[j], a, bb[0], bb[1]);
          }
        }
      }
    }
    cp_wait<0>();
    __syncthreads();  // every warp is done with the ring: Dl and dbw take its place

    // dlab = clamp(softmax * total - gy 1[tgt]) * g in fp32: db sums it, Dl
    // holds it in the dtype (zero in the pad columns and empty rows)
    {
      const int g0 = l >> 2, r_lo = 16 * mblk + g0, r_hi = r_lo + 8;
      const bool live_lo = M.b[r_lo] >= 0, live_hi = M.b[r_hi] >= 0;
#pragma unroll
      for (int j = 0; j < NTQ; ++j) {
        if (j >= nt) continue;
        const int lc = cb + 8 * j + (l & 3) * 2;  // the pass's column
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? r_lo : r_hi;
          const bool live = e < 2 ? live_lo : live_hi;
          const int c = p0 + lc + (e & 1);
          float x = 0.f;
          if (live && c < VL) {
            const float lab = rnd<K>(rnd<K>(acc[j][e]) + cvt<K>(J.bias[c]));
            x = expf(lab - M.lse[r]) * M.total[r] - (c == M.tgt[r] ? M.gy[r] : 0.f);
            x = clamp_g(x, clamp, M.g[r]);
          }
          d[e] = x;
        }
        *reinterpret_cast<uint32_t*>(Dl + (size_t)r_lo * ldl + lc) = pack<F>(d[0], d[1]);
        *reinterpret_cast<uint32_t*>(Dl + (size_t)r_hi * ldl + lc) = pack<F>(d[2], d[3]);
        // column sums over this warp's 16 rows, in a fixed order
        float s0 = d[0] + d[2], s1 = d[1] + d[3];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        }
        if (g0 == 0) {
          dbw[mblk * PW + lc] = s0;
          dbw[mblk * PW + lc + 1] = s1;
        }
      }
    }
    __syncthreads();
    float* dbl_row = dbl_part + (row0 / BROWS) * (size_t)(VL + 1);
    for (int c = threadIdx.x; c < min(PW, VL - p0); c += CELL_THREADS)
      dbl_row[p0 + c] = ((dbw[c] + dbw[PW + c]) + dbw[2 * PW + c]) + dbw[3 * PW + c];
    if (pass == 0 && threadIdx.x == 0) {
      float s = 0.f;
      for (int r = 0; r < BROWS; ++r) s += M.dblank[r];
      dbl_row[VL] = s;
    }
    // the dlab rows into the window's scratch (16-byte vectors)
    {
      const int vec = PW / 8;
      for (int i = threadIdx.x; i < rows * vec; i += CELL_THREADS) {
        const int r = i / vec, c = (i % vec) * 8;
        *reinterpret_cast<uint4*>(dlab_out + (row0 + r) * VLp + p0 + c) =
            *reinterpret_cast<const uint4*>(Dl + (size_t)r * ldl + c);
      }
    }

    // dh += Dl @ W_pad[:, p0 : p0 + PW]^T, 64 hidden columns at a time, with
    // W_pad's rows for the next chunk in flight (ring in the Hs region);
    // after the last pass, + dblank w_blank, dropout and dx = dt(dh * act')
    bf16* dring = Hs;
    const size_t dstage = (size_t)HCH * ldl;
    const int n_hc = (H + HCH - 1) / HCH;
    auto load_hc = [&](int hc) {
      stage_rows(dring + (size_t)(hc & 1) * dstage, ldl, w_pad + p0, VLp, hc * HCH, HCH, H, PW);
    };
    load_hc(0);
    cp_commit();
    for (int hc = 0; hc < n_hc; ++hc) {
      if (hc + 1 < n_hc) load_hc(hc + 1);
      cp_commit();
      cp_wait<1>();
      __syncthreads();
      const bf16* Wd = dring + (size_t)(hc & 1) * dstage;
      const int g0 = l >> 2;
      // the last pass: act' of this thread's dx entries from the scratch,
      // loaded ahead of the product that hides their latency
      uint32_t gpre[2][2] = {{0u, 0u}, {0u, 0u}};
      if (last) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int h = hc * HCH + 16 * nq + 8 * j + (l & 3) * 2;
            const int r = 16 * mblk + g0 + 8 * half;
            if (h < H && r < rows)
              gpre[j][half] = *reinterpret_cast<const uint32_t*>(dx_out + (row0 + r) * H + h);
          }
      }
      float acc2[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) acc2[j][0] = acc2[j][1] = acc2[j][2] = acc2[j][3] = 0.f;
      for (int kk = 0; kk < PW / 16; ++kk) {
        uint32_t a[4], bb[4];
        ldsm4(a, a_addr(Dl, ldl, 16 * mblk, 16 * kk, l));
        ldsm4(bb, bn_addr(Wd, ldl, 16 * kk, 16 * nq, l));
        mma<F>(acc2[0], a, bb[0], bb[1]);
        mma<F>(acc2[1], a, bb[2], bb[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int h = hc * HCH + 16 * nq + 8 * j + (l & 3) * 2;
        if (h >= H) continue;
        const float2 wb = cvt2<K>(w_blank + h);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * mblk + g0 + 8 * half;
          if (r >= rows) continue;
          float2 sum = make_float2(acc2[j][2 * half], acc2[j][2 * half + 1]);
          if (n_pass > 1) {
            // the earlier passes' share (this thread wrote it), added in pass order
            float2* part = reinterpret_cast<float2*>(dh_part + (row0 + r) * H + h);
            if (pass > 0) {
              const float2 prev = *part;
              sum = make_float2(prev.x + sum.x, prev.y + sum.y);
            }
            if (!last) {
              *part = sum;
              continue;
            }
          }
          // act' (where the h build left it in the scratch); dx takes its place
          const float2 ga = cvt2<K>(reinterpret_cast<const bf16*>(&gpre[j][half]));
          float dx[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float dh = rnd<K>((i ? sum.y : sum.x) + M.dblank[r] * (i ? wb.y : wb.x));
            if (J.drop_t > 0) dh = rnd<K>(dh * J.inv_keep);
            dx[i] = rnd<K>(dh * (i ? ga.y : ga.x));
          }
          *reinterpret_cast<uint32_t*>(dx_out + (row0 + r) * H + h) = pack<F>(dx[0], dx[1]);
        }
      }
      __syncthreads();  // every warp is done with this stage before it is reloaded
    }
  }
}

// ---------------------------------------------------------------------------
// backward (sums): over one window's scratch, dW by a split-K product of the
// window's h and dlab, and the fixed-order sums of de, dp and db
// ---------------------------------------------------------------------------

struct SumLayout {
  int ldc, ldd;
  size_t hc, dc, dbs, dwq, total;
};

__host__ __device__ inline SumLayout sum_layout(int VLp) {
  SumLayout L;
  L.ldc = HCH + 8;
  L.ldd = pass_cols(VLp) + 8;
  size_t off = 0;
  L.hc = off; off = align128(off + sizeof(bf16) * 2 * BROWS * (size_t)L.ldc);
  L.dc = off; off = align128(off + sizeof(bf16) * 2 * BROWS * (size_t)L.ldd);
  L.dbs = off; off = align128(off + sizeof(float) * 2 * BROWS);
  L.dwq = off; off = align128(off + sizeof(float) * 4 * HCH);
  L.total = off;
  return L;
}

// dW_lab[hx0 : hx0 + 64, p0 : p0 + 320] over the window's cells [cs, ce)
// (split s), added to dw_part[s]; with the first columns (p0 = 0) also
// dW[:, VL] = sum h * dblank in fp32 into dwb_part[s]. h and dlab arrive
// from the window's scratch through a 2-stage cp.async ring.
template <int K>
__device__ void sums_dw(const Joint<K>& J, int VLp, int cs, int ce, int s, int hx0, int p0,
                        const bf16* dlab, const float* dblank, const bf16* hwin, float* dw_part,
                        float* dwb_part, unsigned char* smem) {
  constexpr bool F = K == F16;
  const SumLayout L = sum_layout(VLp);
  bf16* Hc = reinterpret_cast<bf16*>(smem + L.hc);
  bf16* Dc = reinterpret_cast<bf16*>(smem + L.dc);
  float* dbs = reinterpret_cast<float*>(smem + L.dbs);
  float* dwq = reinterpret_cast<float*>(smem + L.dwq);
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int mblk = warp & 3, nh = warp >> 2;
  const int PW = min(PASS_COLS, VLp - p0);
  const int nt = PW / 16, cb = nh * (PW / 2), ldd = L.ldd, ldc = L.ldc;
  const int H = J.H, ncol = min(HCH, H - hx0);
  const int n_ch = (ce - cs + BROWS - 1) / BROWS;
  const size_t hstage = (size_t)BROWS * ldc, dstage = (size_t)BROWS * ldd;
  auto load = [&](int ch) {
    const int r0 = cs + ch * BROWS, st = ch & 1;
    stage_rows(Dc + st * dstage, ldd, dlab + p0, VLp, r0, BROWS, ce, PW);
    stage_rows(Hc + st * hstage, ldc, hwin + hx0, H, r0, BROWS, ce, ncol);
    for (int r = threadIdx.x; r < BROWS; r += SUM_THREADS)
      dbs[st * BROWS + r] = r0 + r < ce ? dblank[r0 + r] : 0.f;
  };
  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int m = threadIdx.x % HCH, q = threadIdx.x / HCH;  // dW[:, VL]: column m, rows 16q..
  float dwb = 0.f;
  load(0);
  cp_commit();
  for (int ch = 0; ch < n_ch; ++ch) {
    if (ch + 1 < n_ch) load(ch + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* Hs = Hc + (ch & 1) * hstage;
    const bf16* D = Dc + (ch & 1) * dstage;
    const float* db = dbs + (ch & 1) * BROWS;
    if (p0 == 0)
      for (int r = 16 * q; r < 16 * q + 16; ++r)
        dwb += cvt<K>(Hs[(size_t)r * ldc + m]) * db[r];
#pragma unroll
    for (int kk = 0; kk < BROWS / 16; ++kk) {
      uint32_t a[4];
      ldsm4t(a, at_addr(Hs, ldc, 16 * mblk, 16 * kk, l));
#pragma unroll
      for (int j = 0; j < NTW; j += 2) {
        if (j + 1 < NTW && j + 1 < nt) {
          uint32_t bb[4];
          ldsm4t(bb, bt_addr(D, ldd, 16 * kk, cb + 8 * j, l));
          mma<F>(acc[j], a, bb[0], bb[1]);
          mma<F>(acc[j + 1], a, bb[2], bb[3]);
        } else if (j < nt) {
          uint32_t bb[2];
          ldsm2t(bb, bt_addr(D, ldd, 16 * kk, cb + 8 * j, l & 15));
          mma<F>(acc[j], a, bb[0], bb[1]);
        }
      }
    }
    __syncthreads();  // this stage is free for chunk ch + 2
  }
  const int g0 = l >> 2;
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    if (j >= nt) continue;
    const int c = cb + 8 * j + (l & 3) * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int h = hx0 + 16 * mblk + g0 + 8 * half;
      if (h >= H) continue;
      float2* out = reinterpret_cast<float2*>(dw_part + ((size_t)s * H + h) * VLp + p0 + c);
      float2 v = *out;
      v.x += acc[j][2 * half];
      v.y += acc[j][2 * half + 1];
      *out = v;
    }
  }
  if (p0 > 0) return;
  dwq[q * HCH + m] = dwb;
  __syncthreads();
  if (threadIdx.x < ncol)
    dwb_part[(size_t)s * H + hx0 + threadIdx.x] +=
        ((dwq[threadIdx.x] + dwq[HCH + threadIdx.x]) + dwq[2 * HCH + threadIdx.x]) +
        dwq[3 * HCH + threadIdx.x];
}

template <int K>
__global__ void __launch_bounds__(SUM_THREADS)
joint_bwd_sums_kernel(Joint<K> J, int VLp, long long c0, int win,
                      const bf16* __restrict__ dlab, const float* __restrict__ dblank,
                      const bf16* __restrict__ dx, const bf16* __restrict__ hwin,
                      const float* __restrict__ dbl_part, float* __restrict__ de_acc,
                      float* __restrict__ dp, float* __restrict__ dw_part,
                      float* __restrict__ dwb_part, float* __restrict__ db_acc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long n_all = J.off[J.B];
  if (c0 >= n_all) return;
  const int n_w = (int)min((long long)win, n_all - c0);
  const int n_ht = (J.H + HCH - 1) / HCH, n_cp = (VLp + PASS_COLS - 1) / PASS_COLS;
  const int n_dw = KSPLIT * n_ht * n_cp;
  const int bid = blockIdx.x;
  if (bid < n_dw) {  // dW: split s of the window's 64-cell tiles, hidden block ht, columns cp
    const int s = bid / (n_ht * n_cp), ht = bid / n_cp % n_ht, cp = bid % n_cp;
    const int per = (((n_w + BROWS - 1) / BROWS + KSPLIT - 1) / KSPLIT) * BROWS;
    const int cs = s * per, ce = min(cs + per, n_w);
    if (cs < ce)
      sums_dw(J, VLp, cs, ce, s, ht * HCH, cp * PASS_COLS, dlab, dblank, hwin, dw_part,
              dwb_part, smem);
    return;
  }
  sums_rows(J, bid - n_dw, c0, n_w, dx, dbl_part, de_acc, dp, db_acc);
}

// ---------------------------------------------------------------------------
// entry points for one compute dtype
// ---------------------------------------------------------------------------

template <int K>
int fwd_entry(const void* e, const void* p, const void* w, const void* bias, const void* targets,
              const void* t_lens, const void* u_lens, const void* cell_off, void* blank_lp,
              void* label_lp, void* lse, int b, int t, int u1, int h, int hh, int v, int vt,
              int tp, int act, int drop_t, int seed, int hash_base, int grid, void* stream) {
  const Joint<K> J = make_joint<K>(e, p, bias, targets, t_lens, u_lens, cell_off, b, t, u1, h,
                                   hh, v, tp, act, drop_t, seed, hash_base);
  const int rows = fwd_rows(h);
  if (rows == 0 || !widths_ok(h, hh, v) || vt < v || vt % 8 || grid < 1)
    return (int)cudaErrorInvalidValue;
  return rows == 128 ? launch_fwd<4, K>(J, w, vt, grid, (float*)blank_lp, (float*)label_lp,
                                        (float*)lse, (cudaStream_t)stream)
                     : launch_fwd<2, K>(J, w, vt, grid, (float*)blank_lp, (float*)label_lp,
                                        (float*)lse, (cudaStream_t)stream);
}

template <int K>
int cells_entry(const void* e, const void* p, const void* w_pad, const void* w_blank,
                const void* bias, const void* targets, const void* t_lens, const void* u_lens,
                const void* cell_off, const void* lse, const void* total, const void* gb,
                const void* gy, const void* g, void* dlab, void* dblank, void* dx, void* h_win,
                void* dbl_part, void* dh_part, int b, int t, int u1, int h, int hh, int v,
                int vlp, int tp, int act, int drop_t, int seed, int hash_base, int win,
                long long c0, float clamp, void* stream) {
  const Joint<K> J = make_joint<K>(e, p, bias, targets, t_lens, u_lens, cell_off, b, t, u1, h,
                                   hh, v, tp, act, drop_t, seed, hash_base);
  const size_t smem = cell_layout(h, vlp).total;
  if (!widths_ok(h, hh, v) || smem > flash::SMEM_BLOCK || win % BROWS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(joint_bwd_cells_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  joint_bwd_cells_kernel<K><<<win / BROWS, CELL_THREADS, smem, (cudaStream_t)stream>>>(
      J, (const bf16*)w_pad, (const bf16*)w_blank, vlp, (const float*)lse, (const float*)total,
      (const float*)gb, (const float*)gy, (const float*)g, clamp, c0, win, (bf16*)dlab,
      (float*)dblank, (bf16*)dx, (bf16*)h_win, (float*)dbl_part, (float*)dh_part);
  return (int)cudaGetLastError();
}

template <int K>
int sums_entry(const void* t_lens, const void* u_lens, const void* cell_off, const void* dlab,
               const void* dblank, const void* dx, const void* h_win, const void* dbl_part,
               void* de_acc, void* dp, void* dw_part, void* dwb_part, void* db_acc, int b, int t,
               int u1, int h, int v, int vlp, int win, long long c0, void* stream) {
  const Joint<K> J = make_joint<K>(nullptr, nullptr, nullptr, nullptr, t_lens, u_lens, cell_off,
                                   b, t, u1, h, h, v, t, 0, 0, 0, 0);
  const size_t smem = sum_layout(vlp).total;
  cudaError_t err = cudaFuncSetAttribute(joint_bwd_sums_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks =
      (h + HCH - 1) / HCH * KSPLIT * ((vlp + PASS_COLS - 1) / PASS_COLS) + b * t + b * u1 + 1;
  joint_bwd_sums_kernel<K><<<blocks, SUM_THREADS, smem, (cudaStream_t)stream>>>(
      J, vlp, c0, win, (const bf16*)dlab, (const float*)dblank, (const bf16*)dx,
      (const bf16*)h_win, (const float*)dbl_part, (float*)de_acc, (float*)dp, (float*)dw_part,
      (float*)dwb_part, (float*)db_acc);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of shared memory the forward (which = 0), the backward's cells (1)
// or sums (2) kernel needs at the padded width H and V (the forward: the
// layout of the tile height it takes, or its 64-row layout where none fits).
extern "C" long long rnnt_joint_smem_bytes(int H, int V, int which) {
  const int vlp = (V - 1 + 31) / 32 * 32;
  if (which == 0) return (long long)fwd_layout(fwd_rows(H) ? fwd_rows(H) : 64, H).total;
  return (long long)(which == 1 ? cell_layout(H, vlp).total : sum_layout(vlp).total);
}

// The forward's tile height at the padded width H: 128 or 64 lattice cells,
// 0 where neither layout fits in a block's shared memory.
extern "C" int rnnt_joint_fwd_rows(int H) { return fwd_rows(H); }

// The backward's layout constants, which size the buffers the caller
// allocates: the cells per tile, the K splits of the dW product and the
// label columns per pass.
extern "C" int rnnt_joint_bwd_tile_cells() { return BROWS; }
extern "C" int rnnt_joint_bwd_ksplit() { return KSPLIT; }
extern "C" int rnnt_joint_bwd_pass_cols() { return PASS_COLS; }

// The entry points, one per compute dtype (_bf16, _f16): e, p, w, bias and
// the window's dlab, dx and h are of that dtype, everything else as stated.
//
// The forward. e: [b, t, h], p: [b, u1, h]; w: [h, vt] whose first v columns
// are W [h, v] (blank last), zeros past them, vt >= v a multiple of 8 (16-byte
// rows); bias: [v]; targets: [b, u1-1], t_lens, u_lens: [b] int32; cell_off:
// [b + 1] int64, each sample's first lattice cell (sample-major, t-major;
// cell_off[b]: the lattice's cells); blank_lp, label_lp, lse: [b, t, u1] fp32
// (-1e30, -1e30 and 1e30 outside each lattice). All contiguous and 16-byte
// aligned; h a multiple of 16 that `fwd_rows` takes, whose last h - hh columns
// of e, p and w's rows are zero padding (hh the caller's width, hh > h - 16).
// tp: the dropout layout's padded t; act 0 relu, 1 sigmoid, 2 tanh; drop_t 0
// disables dropout; hash_base: added to every dropout index (a row offset
// times tp * u1 * hh, mod 2^32); grid >= 1: the blocks of the persistent grid
// (any count covers every cell; the wrapper takes one per SM, at most one per
// tile of the b * t * u1 cells). Launches on `stream`; returns the
// cudaError_t of the launch.
#define FWD_ENTRY(SUFFIX, KIND)                                                                   \
  extern "C" int rnnt_joint_fwd_##SUFFIX(                                                        \
      const void* e, const void* p, const void* w, const void* bias, const void* targets,        \
      const void* t_lens, const void* u_lens, const void* cell_off, void* blank_lp,              \
      void* label_lp, void* lse, int b, int t, int u1, int h, int hh, int v, int vt, int tp,     \
      int act, int drop_t, int seed, int hash_base, int grid, void* stream) {                    \
    return fwd_entry<KIND>(e, p, w, bias, targets, t_lens, u_lens, cell_off, blank_lp, label_lp, \
                           lse, b, t, u1, h, hh, v, vt, tp, act, drop_t, seed, hash_base, grid,  \
                           stream);                                                              \
  }

// The backward's cells kernel over the window of global cells [c0, c0 + win)
// (win a multiple of 64): as the forward's inputs, with w_pad [h, vlp] the
// label block zero-padded to vlp (a multiple of 32) and w_blank [h]; lse,
// total, gb, gy [b, t, u1] fp32 (read inside the lattice only); g [b] fp32.
// Writes the window's dlab [win, vlp], dblank [win] fp32, dx and h [win, h]
// and per-tile db partials [win / 64, v] fp32. dh_part [win, h] fp32 holds dh
// between the passes over a label block wider than 320 columns (unused, and
// may be null, up to 320).
#define CELLS_ENTRY(SUFFIX, KIND)                                                                 \
  extern "C" int rnnt_joint_bwd_cells_##SUFFIX(                                                  \
      const void* e, const void* p, const void* w_pad, const void* w_blank, const void* bias,    \
      const void* targets, const void* t_lens, const void* u_lens, const void* cell_off,         \
      const void* lse, const void* total, const void* gb, const void* gy, const void* g,         \
      void* dlab, void* dblank, void* dx, void* h_win, void* dbl_part, void* dh_part, int b,     \
      int t, int u1, int h, int hh, int v, int vlp, int tp, int act, int drop_t, int seed,       \
      int hash_base, int win, long long c0, float clamp, void* stream) {                         \
    return cells_entry<KIND>(e, p, w_pad, w_blank, bias, targets, t_lens, u_lens, cell_off, lse, \
                             total, gb, gy, g, dlab, dblank, dx, h_win, dbl_part, dh_part, b, t, \
                             u1, h, hh, v, vlp, tp, act, drop_t, seed, hash_base, win, c0,       \
                             clamp, stream);                                                     \
  }

// The backward's sums kernel over the same window, from the cells kernel's
// dlab, dblank, dx, h [win, h] and db partials: adds its dW_lab to
// dw_part [KSPLIT, h, vlp], its dW[:, v-1] to dwb_part [KSPLIT, h], its de to
// de_acc [b, t, h], its dp to dp [b, u1, h] and its db to db_acc [v], all
// fp32 (zeroed by the caller before the first window).
#define SUMS_ENTRY(SUFFIX, KIND)                                                                  \
  extern "C" int rnnt_joint_bwd_sums_##SUFFIX(                                                   \
      const void* t_lens, const void* u_lens, const void* cell_off, const void* dlab,            \
      const void* dblank, const void* dx, const void* h_win, const void* dbl_part, void* de_acc, \
      void* dp, void* dw_part, void* dwb_part, void* db_acc, int b, int t, int u1, int h, int v, \
      int vlp, int win, long long c0, void* stream) {                                            \
    return sums_entry<KIND>(t_lens, u_lens, cell_off, dlab, dblank, dx, h_win, dbl_part, de_acc, \
                            dp, dw_part, dwb_part, db_acc, b, t, u1, h, v, vlp, win, c0, stream);\
  }

// The reduce kernel: dw [h, v], db [v] fp32 and de [b, t, h] in the dtype
// from the sums' accumulators.
#define REDUCE_ENTRY(SUFFIX, KIND)                                                                \
  extern "C" int rnnt_joint_bwd_reduce_##SUFFIX(                                                 \
      const void* dw_part, const void* dwb_part, const void* db_acc, const void* de_acc,         \
      void* dw, void* db, void* de, int b, int t, int h, int v, int vlp, void* stream) {         \
    return launch_reduce<KIND>(dw_part, dwb_part, db_acc, de_acc, dw, db, de, b, t, h, v, vlp,   \
                               (cudaStream_t)stream);                                            \
  }

FWD_ENTRY(bf16, BF16)
FWD_ENTRY(f16, F16)
CELLS_ENTRY(bf16, BF16)
CELLS_ENTRY(f16, F16)
SUMS_ENTRY(bf16, BF16)
SUMS_ENTRY(f16, F16)
REDUCE_ENTRY(bf16, BF16)
REDUCE_ENTRY(f16, F16)
