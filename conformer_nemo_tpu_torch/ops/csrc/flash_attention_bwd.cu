// Flash attention backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels `_make_dq_kernel` + `_make_dkv_kernel` (via
// `_flash_bwd_entry`) and their two-sided-band twins
// `_make_dq_streamed_kernel` + `_make_dkv_streamed_kernel` (via
// `_flash_bwd_streamed`) of conformer_nemo_tpu/ops/pallas/flash_attention.py.
// Given the forward's inputs, its per-row lse, dO and delta = rowsum(dO * O):
//
//     P_ij  = exp(min(qs_i . ks_j * scale - lse_i, 0))   over visible (i, j)
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
// recomputed, dQ and dK over d1; dP and dV over dv) at 989 TFLOP/s bf16 or
// fp16 dense, against reading qs, ks, v, dO, lse and delta once and writing
// dq, dk and dv once at 3.35 TB/s. At the Conformer's shapes (d1 = 576, dv
// = 64, T >= 1024) that is several hundred FLOPs per byte: the tensor cores
// bound it. Two kernels, no atomics, so every output is the same bits on
// every call. Both take bf16 or fp16 operands (a template argument: the
// same mma.sync m16n8k16 with fp32 accumulation; tensor_core.cuh's `mma`
// and `pack`); fp32 has kernels of its own (flash_attention_f32.cu).
//
// Depth. Both kernels take every (d1, dv) the forward takes (d1 <= 1216,
// dv <= 128): each keeps a tile of its own rows at the full depth in shared
// memory beside a ring of the other side's tiles, and where a two-stage
// ring does not fit it halves the streamed tile, then drops to one stage
// (`dq_plan`, `dkv_plan`; `flash_attention_bwd_dq_max_d1` and
// `flash_attention_bwd_dkv_max_d1` report the largest d1 that fits). The
// gradient over d1 goes in passes of 576 columns over blockIdx.z, each pass
// recomputing S and P, so registers set no limit. At XLarge's d1 1152 (dv
// 128) that is two passes a kernel with one-stage rings of 32-row tiles.
// 1024 of those 1152 dK columns are the constant cos/sin table's, whose
// gradient autograd discards: a later kernel can skip them.
//
// dQ kernel (redesigned for Hopper; the dK/dV kernel below, transposed):
// one block per (bh, 32-query tile, pass of 576 dQ columns) looping over
// the key tiles in band, with 8 consumer warps and one producer warp. What
// the card asks of it:
//   * load once: the producer brings the block's Qs and dO rows (32 x d1,
//     32 x dv) by bulk copies, one a row, into rows padded for ldmatrix,
//     where they stay; lse and delta are read once into registers;
//   * stream the rest: each key tile's Ks and V arrive in a ring (two
//     stages, one past the shared memory's reach) as 64-column tensor-copy
//     boxes (the Tensor Memory Accelerator, 128-byte swizzle, zeros past the
//     tensor's edges: a handful of copy requests a tile, where a copy a row
//     or 16 bytes a thread held the forward to its copy rate), each stage
//     with a "full" and an "empty" mbarrier; each Ks tile serves both S =
//     Qs Ks^T and dQ += dS Ks;
//   * tensor cores from registers: warp (rg, cg) forms S and dP = dO V^T for
//     queries 16rg.. x keys 16cg.. by mma.sync m16n8k16 from ldmatrix
//     fragments in fp32 registers (S in one chain in the forward's depth
//     order, so its bits are the forward's), then P and dS in registers; dS
//     is exchanged once a key tile through shared memory as a 16-bit value
//     (4.5 KB, two buffers, so one barrier of the consumer warps a tile),
//     where it is rounded for the dQ product anyway;
//   * dQ accumulates in fp32 registers across the whole key loop: each warp
//     owns all 32 query rows x its share of the pass's columns (9 n-tiles
//     of 8 at d1 = 576: 72 accumulators a thread), fed by ldmatrix.trans of
//     the swizzled Ks boxes;
//   * no atomics (the same bits on every call); dQ goes out through shared
//     memory in 16-byte rows, rows past the length exactly 0.
// Shared memory at d1 = 576, dv = 64: 211 KB with 64-key tiles and two
// stages, one block an SM; past d1 576 the tiles take 32 keys (each warp
// 16 x 8 of S), past 1024 (dv 128) one stage.
//
// dK/dV kernel (redesigned for Hopper): one block of 8 warps per (bh,
// 32-key tile, pass of 576 dK columns) looping over the query tiles in
// band (the band inverts: a key tile meets queries up to `right` before and
// `left` after it, as in the TPU kernel's `_band_tile_bounds` call). What
// the card asks of it:
//   * load once: the block's K and V tiles (32 x d1, 32 x dv) are loaded
//     once and stay in shared memory;
//   * stream the rest: each query tile's Qs, dO, lse and delta arrive
//     through a cp.async ring, the next tile's copies in flight while this
//     one's products run (two stages; one past the shared memory's reach,
//     where the copies wait for the products); each Qs tile serves both S^T
//     = K Qs^T and dK += dS^T Qs;
//   * tensor cores from registers: every product is mma.sync m16n8k16
//     (fp32 accumulate) from ldmatrix fragments; warp (rg, cg) forms S^T and
//     dP^T = V dO^T for keys 16rg.. x a quarter of the tile's queries in
//     fp32 registers (S^T in one chain in the forward's depth order, so its
//     bits are the forward's; the depth loop unrolled by 4), then P^T and
//     dS^T in registers;
//   * dK and dV accumulate in fp32 registers across the whole query loop:
//     each warp owns all 32 key rows x its share of the pass's dK columns
//     (up to 9 n-tiles of 8: 72 accumulators a thread) and up to 2 n-tiles
//     of dV; dV is made in the first pass alone. The column split needs
//     every warp's dS^T rows: P^T and dS^T go through shared memory once per
//     query tile (9 KB at 64 queries), which is also where they are rounded
//     for the dV and dK products;
//   * two barriers per query tile (three with one stage); the outputs go out
//     through shared memory in 16-byte rows, each written once.
// Why 32 keys and 8 warps: dK's 32 x 576 fp32 block is 72 registers a
// thread over 256 threads, which leaves room for the S^T and dP^T tiles
// under 255; and the K tile beside a 2-stage ring of 64-query tiles fits
// one SM at d1 = 576, dv = 64 (215 KB). Past that the query tiles take 32
// rows (each warp 16 x 8 of S^T), then one stage. This is arithmetic, not a
// measured comparison. Next for this kernel: wgmma from shared memory with
// TMA loads, and no pass over the cos/sin columns.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"
#include "tensor_core.cuh"

using namespace flash;
using namespace tc;

namespace {

// P of a visible pair from its S accumulator: x = fl(S * scale), rounded as
// the forward rounds it (never fused into the subtraction), then
// exp(min(x - lse, 0)). Both kernels sum S's products in the forward's
// chain (one accumulator, depth steps in order), so x is the forward's x
// bit for bit and x - lse <= 0 (lse = fl(m + log l) >= m >= x). That
// matters where the scores run to millions: there a unit in the last place
// of x is worth a factor e or more in P, and sums in another order put P
// far from the forward's softmax, or past fp32's range. The cap at 0 is a
// guard that never bites when the sums agree.
__device__ inline float p_of(float sv, float scale, float lse) {
  return expf(fminf(__fmul_rn(sv, scale) - lse, 0.f));
}

// ---------------------------------------------------------------------------
// dQ kernel
// ---------------------------------------------------------------------------

constexpr int DQ_ROWS = 32;      // queries per block
constexpr int DQ_WARPS = 8;      // consumer warps, and one producer warp
constexpr int DQ_THREADS = DQ_WARPS * 32 + 32;
constexpr int DQ_NT = 9;         // n-tiles of 8 dQ columns a warp holds in a pass
constexpr int DQ_PASS_N8 = DQ_WARPS * DQ_NT;  // 72 n-tiles: 576 dQ columns a pass

struct DqLayout {
  int d1p, dvp;   // d1 and dv rounded up to 16 (zero columns past d1, dv)
  int ldq, ldv;   // bf16 row strides of the resident Qs and dO rows
  int ldd;        // bf16 row stride of a dS tile
  int kboxes, vboxes;  // 64-column tensor-copy boxes of a Ks and a V tile
  // byte offsets from the block's 1024-aligned base, and the dynamic shared
  // memory a launch asks for (1024 bytes of it to align)
  size_t ring, stage, bar, q, dout, ds, total;
};

// bk keys a tile, a ring of `stages` key tiles (2, or 1 where two do not fit)
__host__ __device__ inline DqLayout dq_layout(int bk, int stages, int d1, int dv) {
  DqLayout L;
  L.d1p = round16(d1);
  L.dvp = round16(dv);
  L.ldq = L.d1p + 8;  // an odd number of 16-byte units: ldmatrix rows hit distinct banks
  L.ldv = L.dvp + 8;
  L.ldd = bk + 8;
  L.kboxes = (d1 + 63) / 64;
  L.vboxes = (dv + 63) / 64;
  L.stage = sizeof(bf16) * bk * 64 * (L.kboxes + L.vboxes);
  L.ring = 0;  // swizzled boxes: 1024-byte aligned
  L.bar = stages * L.stage;  // 2 stages + 1 mbarriers
  L.q = L.bar + align128(sizeof(uint64_t) * (2 * stages + 1));
  L.dout = L.q + align128(sizeof(bf16) * DQ_ROWS * L.ldq);
  L.ds = L.dout + align128(sizeof(bf16) * DQ_ROWS * L.ldv);
  L.total = L.ds + 2 * align128(sizeof(bf16) * DQ_ROWS * L.ldd) + 1024;
  return L;
}

// The (key-tile width, ring stages) a launch at (d1, dv) takes, the first
// that fits of (64, 2), (32, 2), (32, 1); false where none fits
inline bool dq_plan(int d1, int dv, int* bk, int* stages) {
  const int plans[3][2] = {{64, 2}, {32, 2}, {32, 1}};
  for (const auto& p : plans)
    if (dq_layout(p[0], p[1], d1, dv).total <= SMEM_BLOCK) {
      *bk = p[0];
      *stages = p[1];
      return true;
    }
  return false;
}

// a barrier of the consumer warps (threads 0 .. DQ_WARPS * 32 - 1)
__device__ inline void dq_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(DQ_WARPS * 32) : "memory");
}

// BK keys a tile, a ring of STAGES tiles, F16: fp16 operands (else bf16).
// Warp (rg, cg) forms S and dP for queries 16 rg.. x keys BK / 4 * cg..
// (NS = BK / 32 n-tiles of 8); dQ's columns of the pass split over the 8
// consumer warps, all 32 rows each.
template <int BK, int STAGES, bool F16>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const bf16* __restrict__ qs, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ lens, bf16* __restrict__ dq,
                    int T, int d1, int dv, float scale, int left, int right) {
  constexpr int NS = BK / 32;
  constexpr size_t BOX = sizeof(bf16) * BK * 64;  // bytes of a 64-column box
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const DqLayout L = dq_layout(BK, STAGES, d1, dv);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);  // a key tile has landed
  uint64_t* empty = full + STAGES;                             // every warp is done with it
  uint64_t* qbar = empty + STAGES;                             // Qs and dO rows have landed
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L.dout);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * DQ_ROWS;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int klim = min(max(lens[bh], 0), T);  // keys and queries < klim are valid

  // key tiles in band of queries q0..q0+31 (_band_tile_bounds), capped at the
  // length; none when every query row of the tile is past the length
  const int n_tiles = (T + BK - 1) / BK;
  int lo = 0, hi = n_tiles;
  if (left >= 0) lo = max(q0 - left, 0) / BK;
  if (right >= 0) hi = min((q0 + DQ_ROWS - 1 + right) / BK + 1, n_tiles);
  hi = min(hi, (klim + BK - 1) / BK);
  if (q0 >= klim) hi = lo;

  // zero the resident rows once: pad columns and rows past T are never
  // loaded and must read as finite (0 x garbage may be NaN in a product);
  // the tensor copies fill a box's columns past d1 or dv with zeros
  for (size_t i = L.q / 16 + threadIdx.x; i < L.ds / 16; i += DQ_THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();  // the zeros land before the bulk copies into the same rows
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], DQ_WARPS);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == DQ_WARPS) {
    // the producer warp: the block's Qs and dO rows once (a bulk copy a row,
    // lanes over rows), then each key tile's Ks and V into its stage as
    // 64-column tensor-copy boxes once every consumer warp is done with it
    const int q_rows = min(DQ_ROWS, T - q0);
    if (l == 0) mbar_arrive_expect(qbar, q_rows * (d1 + dv) * 2);
    __syncwarp();
    if (l < q_rows) {
      const size_t row = (size_t)bh * T + q0 + l;
      bulk_g2s(Qs + l * L.ldq, qs + row * d1, d1 * 2, qbar);
      bulk_g2s(dOs + l * L.ldv, dout + row * dv, dv * 2, qbar);
    }
    if (l == 0) {
      for (int kt = lo; kt < hi; ++kt) {
        const int i = kt - lo, s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        unsigned char* dst = smem + L.ring + s * L.stage;
        const int row0 = bh * T + kt * BK;
        mbar_arrive_expect(&full[s], (L.kboxes + L.vboxes) * BOX);
        for (int j = 0; j < L.kboxes; ++j) tma_load_2d(dst + j * BOX, &tk, 64 * j, row0, &full[s]);
        for (int j = 0; j < L.vboxes; ++j)
          tma_load_2d(dst + (L.kboxes + j) * BOX, &tv, 64 * j, row0, &full[s]);
      }
    }
    return;
  }

  // the consumer warps. S / dP tile of this warp: queries 16 rg.., keys
  // BK / 4 * cg..
  const int rg = warp & 1, cg = warp >> 1;
  const int g = l >> 2, c2 = 2 * (l & 3);  // accumulator row and column pair of this lane
  // dQ columns of this warp in this pass: n-tiles nt0 .. nt0 + nk - 1
  const int n8k = L.d1p / 8;
  const int pn0 = blockIdx.z * DQ_PASS_N8, pn = min(DQ_PASS_N8, n8k - pn0);
  const int ntw = (pn + DQ_WARPS - 1) / DQ_WARPS;
  const int nt0 = pn0 + warp * ntw;
  const int nk = max(0, min(ntw, pn0 + pn - nt0));
  const int nkk = L.d1p / 16, nvk = L.dvp / 16;
  float lse_r[2], delta_r[2];  // rows g and g + 8 of the warp
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + 16 * rg + g + 8 * h;
    lse_r[h] = qi < T ? lse[(size_t)bh * T + qi] : 0.f;
    delta_r[h] = qi < T ? delta[(size_t)bh * T + qi] : 0.f;
  }

  float dqa[2][DQ_NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < DQ_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[m][j][e] = 0.f;
  mbar_wait(qbar, 0);

  for (int kt = lo; kt < hi; ++kt) {
    const int i = kt - lo, st = i % STAGES;
    const int k0 = kt * BK;
    mbar_wait(&full[st], (i / STAGES) & 1);
    const bf16* Kt = reinterpret_cast<const bf16*>(smem + L.ring + st * L.stage);
    const bf16* Vt = Kt + L.kboxes * BK * 64;
    bf16* Ds = reinterpret_cast<bf16*>(smem + L.ds + (i & 1) * align128(sizeof(bf16) * DQ_ROWS * L.ldd));

    // S = Qs Kt^T over the depth in one chain, in the forward's order (so S is
    // the forward's bit for bit: see p_of), and dP = dO Vt^T; Kt and Vt are
    // swizzled boxes
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    // B fragments of keys BK / 4 * cg.. at depth 16 kk.. of [BK x 64] boxes
    auto b_frag = [&](uint32_t* b, const bf16* boxes, int kk) {
      const bf16* box = boxes + (kk >> 2) * BK * 64;
      const int kc = 16 * (kk & 3) + ((l >> 3) & 1) * 8;
      if constexpr (NS == 2)
        ldsm4(b, swz128(box, 16 * cg + (l & 7) + (l >> 4) * 8, kc));
      else
        ldsm2(b, swz128(box, 8 * cg + (l & 7), kc));
    };
    auto s_step = [&](float (&acc)[NS][4], int kk) {
      uint32_t a[4], b[4];
      ldsm4(a, a_addr(Qs, L.ldq, 16 * rg, 16 * kk, l));
      b_frag(b, Kt, kk);
      mma<F16>(acc[0], a, b[0], b[1]);
      if constexpr (NS == 2) mma<F16>(acc[1], a, b[2], b[3]);
    };
#pragma unroll 2
    for (int kk = 0; kk < nkk; ++kk) s_step(s, kk);
#pragma unroll
    for (int kv = 0; kv < nvk; ++kv) {
      uint32_t a[4], b[4];
      ldsm4(a, a_addr(dOs, L.ldv, 16 * rg, 16 * kv, l));
      b_frag(b, Vt, kv);
      mma<F16>(dp[0], a, b[0], b[1]);
      if constexpr (NS == 2) mma<F16>(dp[1], a, b[2], b[3]);
    }

    // P and dS in fp32 registers; dS rounded to bf16 into this tile's dS buffer
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // accumulator rows g and g + 8
        const int row = 16 * rg + g + 8 * h, qi = q0 + row;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = BK / 4 * cg + 8 * j + c2 + e, kj = k0 + col;
          const bool ok = qi < klim && kj < klim && in_band(qi, kj, left, right);
          const float p = ok ? p_of(s[j][2 * h + e], scale, lse_r[h]) : 0.f;
          ds[e] = ok ? p * (dp[j][2 * h + e] - delta_r[h]) * scale : 0.f;
        }
        *reinterpret_cast<uint32_t*>(Ds + row * L.ldd + BK / 4 * cg + 8 * j + c2) =
            pack<F16>(ds[0], ds[1]);
      }
    }
    // every warp's dS rows are in; the other buffer is the next tile's, and a
    // warp writes it only after this barrier, once done with this one
    dq_consumers_sync();

    // dQ += dS Kt over the tile's BK keys, all 32 query rows
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq) {
      uint32_t da[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) ldsm4(da[m], a_addr(Ds, L.ldd, 16 * m, 16 * kq, l));
      // keys 16 kq.. of this lane's row, depth columns of n-tile nt0 + j (+1)
      const int kr = 16 * kq + (l & 7) + ((l >> 3) & 1) * 8;
#pragma unroll
      for (int j = 0; j < DQ_NT; j += 2) {
        if (j + 1 < nk) {
          uint32_t b[4];
          const int col = 8 * (nt0 + j) + (l >> 4) * 8;
          ldsm4t(b, swz128(Kt + (col >> 6) * BK * 64, kr, col & 63));
          mma<F16>(dqa[0][j], da[0], b[0], b[1]);
          mma<F16>(dqa[1][j], da[1], b[0], b[1]);
          mma<F16>(dqa[0][j + 1], da[0], b[2], b[3]);
          mma<F16>(dqa[1][j + 1], da[1], b[2], b[3]);
        } else if (j < nk) {
          uint32_t b[2];
          const int col = 8 * (nt0 + j);
          ldsm2t(b, swz128(Kt + (col >> 6) * BK * 64, kr, col & 63));
          mma<F16>(dqa[0][j], da[0], b[0], b[1]);
          mma<F16>(dqa[1][j], da[1], b[0], b[1]);
        }
      }
    }
    __syncwarp();
    if (l == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
  }

  // dQ as bf16 through the Qs rows once every consumer warp is done with
  // them, then 16-byte rows out (this pass's columns)
  dq_consumers_sync();
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * m + g + 8 * h;
#pragma unroll
      for (int j = 0; j < DQ_NT; ++j)
        if (j < nk)
          *reinterpret_cast<uint32_t*>(Qs + row * L.ldq + 8 * (nt0 + j) + c2) =
              pack<F16>(dqa[m][j][2 * h], dqa[m][j][2 * h + 1]);
    }
  dq_consumers_sync();
  const int c_lo = 8 * pn0, vec = (min(d1, 8 * (pn0 + pn)) - c_lo) / 8;
  for (int i = threadIdx.x; i < DQ_ROWS * vec; i += DQ_WARPS * 32) {
    const int r = i / vec, c = c_lo + (i % vec) * 8;
    if (q0 + r < T)
      *reinterpret_cast<uint4*>(dq + ((size_t)bh * T + q0 + r) * d1 + c) =
          *reinterpret_cast<const uint4*>(Qs + r * L.ldq + c);
  }
}

// ---------------------------------------------------------------------------
// dK/dV kernel
// ---------------------------------------------------------------------------

constexpr int DKV_KEYS = 32;      // keys per block
constexpr int DKV_THREADS = 256;  // 8 warps
constexpr int DKV_WARPS = DKV_THREADS / 32;
constexpr int DKV_NT = 9;         // n-tiles of 8 dK columns a warp holds in a pass
constexpr int DKV_PASS_N8 = DKV_WARPS * DKV_NT;  // 72 n-tiles: 576 dK columns a pass

struct DkvLayout {
  int d1p, dvp;  // d1 and dv rounded up to 16 (zero columns past d1, dv)
  int ldk, ldv;  // bf16 row strides of the d1-wide and dv-wide tiles
  int ldp;       // bf16 row stride of the P^T / dS^T tiles
  size_t k, v, q, dout, lse, delta, p, ds, total;  // byte offsets (stage 0)
  size_t q_stage, do_stage;                         // bytes per stage
};

// qt queries a tile, a ring of `stages` query tiles
__host__ __device__ inline DkvLayout dkv_layout(int qt, int stages, int d1, int dv) {
  DkvLayout L;
  L.d1p = round16(d1);
  L.dvp = round16(dv);
  L.ldk = L.d1p + 8;  // an odd number of 16-byte units: ldmatrix rows hit distinct banks
  L.ldv = L.dvp + 8;
  L.ldp = qt + 8;
  L.q_stage = align128(sizeof(bf16) * qt * L.ldk);
  L.do_stage = align128(sizeof(bf16) * qt * L.ldv);
  size_t off = 0;
  L.k = off; off = align128(off + sizeof(bf16) * DKV_KEYS * L.ldk);
  L.v = off; off = align128(off + sizeof(bf16) * DKV_KEYS * L.ldv);
  L.q = off; off += stages * L.q_stage;
  L.dout = off; off += stages * L.do_stage;
  L.lse = off; off = align128(off + sizeof(float) * stages * qt);
  L.delta = off; off = align128(off + sizeof(float) * stages * qt);
  L.p = off; off = align128(off + sizeof(bf16) * DKV_KEYS * L.ldp);
  L.ds = off; off = align128(off + sizeof(bf16) * DKV_KEYS * L.ldp);
  L.total = off;
  return L;
}

// The (query-tile height, ring stages) a launch at (d1, dv) takes, the first
// that fits of (64, 2), (32, 2), (32, 1); false where none fits
inline bool dkv_plan(int d1, int dv, int* qt, int* stages) {
  const int plans[3][2] = {{64, 2}, {32, 2}, {32, 1}};
  for (const auto& p : plans)
    if (dkv_layout(p[0], p[1], d1, dv).total <= SMEM_BLOCK) {
      *qt = p[0];
      *stages = p[1];
      return true;
    }
  return false;
}

// rows row0.. of a row-major [nrows x width] matrix of 16-bit elements into
// shared rows of stride ld by cp.async, 16 bytes at a time; rows past nrows
// untouched
__device__ inline void stage_rows(bf16* dst, int ld, const bf16* __restrict__ src, int width,
                                  int row0, int rows, int nrows) {
  const int vec = width / 8;
  for (int i = threadIdx.x; i < rows * vec; i += DKV_THREADS) {
    const int r = i / vec, c = (i % vec) * 8;
    if (row0 + r < nrows) cp_async16(dst + r * ld + c, src + (size_t)(row0 + r) * width + c);
  }
}

// one 16-deep step of a [16 x 8 NS] product: c[j] += A (16 x 16 at a) B^T
// (NS n-tiles from [n][k] storage at b, whose lane address `b` is bn_addr's)
template <int NS, bool F16>
__device__ inline void mma_step_nk(float (&c)[NS][4], const bf16* a, const bf16* b) {
  uint32_t af[4], bf[4];
  ldsm4(af, a);
  if constexpr (NS == 2) {
    ldsm4(bf, b);
    mma<F16>(c[0], af, bf[0], bf[1]);
    mma<F16>(c[1], af, bf[2], bf[3]);
  } else {
    ldsm2(bf, b);
    mma<F16>(c[0], af, bf[0], bf[1]);
  }
}

// QT queries a tile (64 or 32), a ring of STAGES tiles, F16: fp16 operands.
// Warp (rg, cg) forms S^T and dP^T for keys 16 rg.. x queries QT / 4 * cg..
// (NS = QT / 32 n-tiles of 8); dK's columns of this block's pass
// (blockIdx.z: columns 576 z..) split over the 8 warps, all 32 key rows
// each; dV (pass 0 only) as n-tiles warp and warp + 8.
template <int QT, int STAGES, bool F16>
__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_bwd_dkv_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ ks,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ lens, bf16* __restrict__ dk,
                     bf16* __restrict__ dvo, int T, int d1, int dv, float scale, int left,
                     int right) {
  constexpr int NS = QT / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const DkvLayout L = dkv_layout(QT, STAGES, d1, dv);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p);
  bf16* Ds = reinterpret_cast<bf16*>(smem + L.ds);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * DKV_KEYS;
  const bool with_dv = blockIdx.z == 0;  // dV once, in the first pass of dK columns
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int klim = min(max(lens[bh], 0), T);
  const bf16* qs_bh = qs + (size_t)bh * T * d1;
  const bf16* do_bh = dout + (size_t)bh * T * dv;
  const float* lse_bh = lse + (size_t)bh * T;
  const float* delta_bh = delta + (size_t)bh * T;

  // query tiles in band of keys k0..k0+31: the window inverts
  // (_band_tile_bounds(k0, k0 + 32, right, left, ...)), capped at the length
  const int n_tiles = (T + QT - 1) / QT;
  int lo = 0, hi = n_tiles;
  if (right >= 0) lo = max(k0 - right, 0) / QT;
  if (left >= 0) hi = min((k0 + DKV_KEYS - 1 + left) / QT + 1, n_tiles);
  hi = min(hi, (klim + QT - 1) / QT);
  if (k0 >= klim) hi = lo;

  // Zero all of it once: the pad columns past d1 and dv, and rows past T,
  // are never loaded and must read as 0 (0 x garbage may be NaN in a product)
  for (size_t i = threadIdx.x; i < L.total / 16; i += DKV_THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  auto load_queries = [&](int stage, int q0) {
    stage_rows(reinterpret_cast<bf16*>(smem + L.q + stage * L.q_stage), L.ldk, qs_bh, d1, q0,
               QT, T);
    stage_rows(reinterpret_cast<bf16*>(smem + L.dout + stage * L.do_stage), L.ldv, do_bh, dv,
               q0, QT, T);
    float* lse_s = reinterpret_cast<float*>(smem + L.lse) + stage * QT;
    float* delta_s = reinterpret_cast<float*>(smem + L.delta) + stage * QT;
    const int r = threadIdx.x & (QT - 1);
    if (q0 + r < T) {
      if (threadIdx.x < QT) cp_async4(lse_s + r, lse_bh + q0 + r);
      else if (threadIdx.x < 2 * QT) cp_async4(delta_s + r, delta_bh + q0 + r);
    }
  };
  stage_rows(Ks, L.ldk, ks + (size_t)bh * T * d1, d1, k0, DKV_KEYS, T);
  stage_rows(Vs, L.ldv, v + (size_t)bh * T * dv, dv, k0, DKV_KEYS, T);
  if (lo < hi) load_queries(0, lo * QT);
  cp_commit();

  // S^T / dP^T tile of this warp: keys 16 rg.., queries QT / 4 * cg..
  const int rg = warp & 1, cg = warp >> 1;
  const int q_w = QT / 4 * cg;
  const int g = l >> 2, c2 = 2 * (l & 3);  // accumulator row and column pair of this lane
  // dK columns of this warp in this pass: n-tiles nt0 .. nt0 + nk - 1
  const int n8k = L.d1p / 8;
  const int pn0 = blockIdx.z * DKV_PASS_N8, pn = min(DKV_PASS_N8, n8k - pn0);
  const int ntw = (pn + DKV_WARPS - 1) / DKV_WARPS;
  const int nt0 = pn0 + warp * ntw;
  const int nk = max(0, min(ntw, pn0 + pn - nt0));
  // dV columns of this warp: n-tiles warp and warp + 8
  const int n8v = with_dv ? L.dvp / 8 : 0;
  const int nkk = L.d1p / 16, nvk = L.dvp / 16;
  // B fragments of this warp's queries from [query][depth] rows
  const int lb = NS == 2 ? l : (l & 15);

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
    const int st = STAGES == 1 ? 0 : (qt - lo) & 1;
    const int q0 = qt * QT;
    cp_wait<0>();
    __syncthreads();  // this tile has landed; every warp is done with the other stage
    if constexpr (STAGES == 2) {
      if (qt + 1 < hi) load_queries(st ^ 1, q0 + QT);
      cp_commit();
    }
    const bf16* Qt = reinterpret_cast<const bf16*>(smem + L.q + st * L.q_stage);
    const bf16* dOt = reinterpret_cast<const bf16*>(smem + L.dout + st * L.do_stage);
    const float* lse_s = reinterpret_cast<const float*>(smem + L.lse) + st * QT;
    const float* delta_s = reinterpret_cast<const float*>(smem + L.delta) + st * QT;

    // S^T = K Qs^T over the depth in one chain, in the forward's order: the
    // same products into the same chain, so S is the forward's bit for bit
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < nkk; ++kk)
      mma_step_nk<NS, F16>(s, a_addr(Ks, L.ldk, 16 * rg, 16 * kk, l),
                           bn_addr(Qt, L.ldk, 16 * kk, q_w, lb));
    // dP^T = V dO^T
#pragma unroll 4
    for (int kv = 0; kv < nvk; ++kv)
      mma_step_nk<NS, F16>(dp, a_addr(Vs, L.ldv, 16 * rg, 16 * kv, l),
                           bn_addr(dOt, L.ldv, 16 * kv, q_w, lb));

    // P^T and dS^T in fp32 registers, rounded into shared memory
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // accumulator rows g and g + 8
        const int row = 16 * rg + g + 8 * h, kj = k0 + row;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = q_w + 8 * j + c2 + e, qi = q0 + col;
          const bool ok = kj < klim && qi < klim && in_band(qi, kj, left, right);
          p[e] = ok ? p_of(s[j][2 * h + e], scale, lse_s[col]) : 0.f;
          ds[e] = ok ? p[e] * (dp[j][2 * h + e] - delta_s[col]) * scale : 0.f;
        }
        const int o = row * L.ldp + q_w + 8 * j + c2;
        *reinterpret_cast<uint32_t*>(Ps + o) = pack<F16>(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(Ds + o) = pack<F16>(ds[0], ds[1]);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Qs over the tile's QT queries, all 32 keys
#pragma unroll
    for (int kq = 0; kq < QT / 16; ++kq) {
      uint32_t pa[2][4], da[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (with_dv) ldsm4(pa[m], a_addr(Ps, L.ldp, 16 * m, 16 * kq, l));
        ldsm4(da[m], a_addr(Ds, L.ldp, 16 * m, 16 * kq, l));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = warp + DKV_WARPS * j;
        if (nt < n8v) {
          uint32_t b[2];
          ldsm2t(b, bt_addr(dOt, L.ldv, 16 * kq, 8 * nt, l & 15));
          mma<F16>(dva[0][j], pa[0], b[0], b[1]);
          mma<F16>(dva[1][j], pa[1], b[0], b[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < DKV_NT; j += 2) {
        if (j + 1 < nk) {
          uint32_t b[4];
          ldsm4t(b, bt_addr(Qt, L.ldk, 16 * kq, 8 * (nt0 + j), l));
          mma<F16>(dka[0][j], da[0], b[0], b[1]);
          mma<F16>(dka[1][j], da[1], b[0], b[1]);
          mma<F16>(dka[0][j + 1], da[0], b[2], b[3]);
          mma<F16>(dka[1][j + 1], da[1], b[2], b[3]);
        } else if (j < nk) {
          uint32_t b[2];
          ldsm2t(b, bt_addr(Qt, L.ldk, 16 * kq, 8 * (nt0 + j), l & 15));
          mma<F16>(dka[0][j], da[0], b[0], b[1]);
          mma<F16>(dka[1][j], da[1], b[0], b[1]);
        }
      }
    }
    if constexpr (STAGES == 1) {
      __syncthreads();  // every warp is done with the one stage before it is refilled
      if (qt + 1 < hi) load_queries(0, q0 + QT);
      cp_commit();
    }
  }

  // dK (this pass's columns) and dV as 16-bit values through the K and V
  // tiles, then 16-byte rows out
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
              pack<F16>(dka[m][j][2 * h], dka[m][j][2 * h + 1]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = warp + DKV_WARPS * j;
        if (nt < n8v)
          *reinterpret_cast<uint32_t*>(Vs + row * L.ldv + 8 * nt + c2) =
              pack<F16>(dva[m][j][2 * h], dva[m][j][2 * h + 1]);
      }
    }
  }
  __syncthreads();
  const int c_lo = 8 * pn0, vk = (min(d1, 8 * (pn0 + pn)) - c_lo) / 8, vv = dv / 8;
  for (int i = threadIdx.x; i < DKV_KEYS * vk; i += DKV_THREADS) {
    const int r = i / vk, c = c_lo + (i % vk) * 8;
    if (k0 + r < T)
      *reinterpret_cast<uint4*>(dk + ((size_t)bh * T + k0 + r) * d1 + c) =
          *reinterpret_cast<const uint4*>(Ks + r * L.ldk + c);
  }
  if (with_dv)
    for (int i = threadIdx.x; i < DKV_KEYS * vv; i += DKV_THREADS) {
      const int r = i / vv, c = (i % vv) * 8;
      if (k0 + r < T)
        *reinterpret_cast<uint4*>(dvo + ((size_t)bh * T + k0 + r) * dv + c) =
            *reinterpret_cast<const uint4*>(Vs + r * L.ldv + c);
    }
}

// passes of 576 columns over d1
inline int passes(int d1, int pass_n8) { return (round16(d1) / 8 + pass_n8 - 1) / pass_n8; }

template <bool F16>
int launch_dq(const void* qs, const void* ks, const void* v, const void* dout, const void* lse,
              const void* delta, const void* lens, void* dq, int bh, int t, int d1, int dv,
              float scale, int left, int right, void* stream) {
  int bk, stages;
  if (!dq_plan(d1, dv, &bk, &stages) || d1 % 8 || dv % 8 || dv > 128)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tk, tv;  // the copies move 16-bit elements: one map serves bf16 and fp16
  if (!tensor_map(&tk, ks, d1, (long long)bh * t, bk) ||
      !tensor_map(&tv, v, dv, (long long)bh * t, bk))
    return (int)cudaErrorNotSupported;
  const size_t smem = dq_layout(bk, stages, d1, dv).total;
  auto kernel = bk == 64 ? flash_bwd_dq_kernel<64, 2, F16>
                         : stages == 2 ? flash_bwd_dq_kernel<32, 2, F16>
                                       : flash_bwd_dq_kernel<32, 1, F16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + DQ_ROWS - 1) / DQ_ROWS, bh, passes(d1, DQ_PASS_N8));
  kernel<<<grid, DQ_THREADS, smem, (cudaStream_t)stream>>>(
      tk, tv, (const bf16*)qs, (const bf16*)dout, (const float*)lse, (const float*)delta,
      (const int*)lens, (bf16*)dq, t, d1, dv, scale, left, right);
  return (int)cudaGetLastError();
}

template <bool F16>
int launch_dkv(const void* qs, const void* ks, const void* v, const void* dout,
               const void* lse, const void* delta, const void* lens, void* dk, void* dvo, int bh,
               int t, int d1, int dv, float scale, int left, int right, void* stream) {
  int qt, stages;
  if (!dkv_plan(d1, dv, &qt, &stages) || d1 % 8 || dv % 8 || dv > 128)
    return (int)cudaErrorInvalidValue;
  const size_t smem = dkv_layout(qt, stages, d1, dv).total;
  auto kernel = qt == 64 ? flash_bwd_dkv_kernel<64, 2, F16>
                         : stages == 2 ? flash_bwd_dkv_kernel<32, 2, F16>
                                       : flash_bwd_dkv_kernel<32, 1, F16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + DKV_KEYS - 1) / DKV_KEYS, bh, passes(d1, DKV_PASS_N8));
  kernel<<<grid, DKV_THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)qs, (const bf16*)ks, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (const int*)lens, (bf16*)dk, (bf16*)dvo, t, d1, dv, scale, left,
      right);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest d1 (a multiple of 8) the dQ kernel takes at dv: its 32 query
// rows of qs stay in shared memory beside a ring of key tiles (64 keys and
// two stages, else 32 keys, else 32 keys and one stage); dQ's columns go in
// passes of 576, so registers set no limit.
extern "C" int flash_attention_bwd_dq_max_d1(int dv) {
  int d1 = 0, bk, stages;
  while (dq_plan(d1 + 8, dv, &bk, &stages)) d1 += 8;
  return d1;
}

// The largest d1 (a multiple of 8) the dK/dV kernel takes at dv: its 32
// keys of ks stay in shared memory beside a ring of query tiles (64 queries
// and two stages, else 32 queries, else 32 queries and one stage); dK's
// columns go in passes of 576, so registers set no limit.
extern "C" int flash_attention_bwd_dkv_max_d1(int dv) {
  int d1 = 0, qt, stages;
  while (dkv_plan(d1 + 8, dv, &qt, &stages)) d1 += 8;
  return d1;
}

// qs, ks: [bh, t, d1] bf16; v, dout: [bh, t, dv] bf16; lse, delta: [bh, t]
// fp32; lens: [bh] int32; dq: [bh, t, d1] bf16. All contiguous, 16-byte
// aligned; d1 and dv multiples of 8, dv <= 128. Launches on `stream`;
// returns the cudaError_t of the launch.
extern "C" int flash_attention_bwd_dq_bf16(const void* qs, const void* ks, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           const void* lens, void* dq, int bh, int t, int d1,
                                           int dv, float scale, int left, int right,
                                           void* stream) {
  return launch_dq<false>(qs, ks, v, dout, lse, delta, lens, dq, bh, t, d1, dv, scale, left,
                          right, stream);
}

// As above with fp16 qs, ks, v, dout and dq.
extern "C" int flash_attention_bwd_dq_f16(const void* qs, const void* ks, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          const void* lens, void* dq, int bh, int t, int d1,
                                          int dv, float scale, int left, int right,
                                          void* stream) {
  return launch_dq<true>(qs, ks, v, dout, lse, delta, lens, dq, bh, t, d1, dv, scale, left,
                         right, stream);
}

// As above; dk: [bh, t, d1] bf16, dvo: [bh, t, dv] bf16.
extern "C" int flash_attention_bwd_dkv_bf16(const void* qs, const void* ks, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            const void* lens, void* dk, void* dvo, int bh, int t,
                                            int d1, int dv, float scale, int left, int right,
                                            void* stream) {
  return launch_dkv<false>(qs, ks, v, dout, lse, delta, lens, dk, dvo, bh, t, d1, dv, scale,
                           left, right, stream);
}

// As above with fp16 qs, ks, v, dout, dk and dvo.
extern "C" int flash_attention_bwd_dkv_f16(const void* qs, const void* ks, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           const void* lens, void* dk, void* dvo, int bh, int t,
                                           int d1, int dv, float scale, int left, int right,
                                           void* stream) {
  return launch_dkv<true>(qs, ks, v, dout, lse, delta, lens, dk, dvo, bh, t, d1, dv, scale,
                          left, right, stream);
}
