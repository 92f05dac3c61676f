// Flash attention in fp32 for NVIDIA Hopper (sm_90a), plain C interface:
// the forward, the dQ kernel and the dK/dV kernel.
//
// Replaces the same TPU kernels as flash_attention_fwd.cu and
// flash_attention_bwd.cu (conformer_nemo_tpu/ops/pallas/flash_attention.py:
// `_make_kernel` via `_flash_fwd_entry`, `_make_dq_kernel` and
// `_make_dkv_kernel` via `_flash_bwd_entry`, and their streamed twins) for
// fp32 qs, ks, v and dO, the dtype the JAX package runs them in when a model
// computes in fp32. The functions are those of the 16-bit kernels:
//
//     o = softmax(qs ks^T * scale + mask) v,  lse = logsumexp of the row
//     P = exp(min(S * scale - lse, 0)),  dS = P (dO v^T - delta) * scale
//     dQ = dS ks,  dK = dS^T qs,  dV = P^T dO
//
// with the same masking (keys and queries past lens, the (left, right)
// band), the same empty-row rule (o = 0, lse = 0) and the same outputs (o,
// dq, dk, dv in fp32; lse in fp32). No atomics: every output is the same
// bits on every call.
//
// S in one chain. Every kernel here forms each score S_ij as one fmaf chain
// over the depth in order from 0.0f (`chain_box`: 8 x 8 pieces in the
// forward, 4 x 4 in the backward), then x = fl(S * scale): the backward's x
// is the forward's bit for bit, so x - lse <= 0 and P <= 1 hold at scores in the
// millions, where a unit in the last place of x is worth a factor e in P
// (see p_of). That is why S stays on the CUDA cores: a tensor-core product
// sums in the hardware's order, and the forward would have to change with
// it. TF32 alone keeps 10 bits of mantissa and reads about 1e-3 off an fp32
// reference, where a model that asks for fp32 is held to fp32's rounding.
//
// The forward (redesigned for Hopper): one block of 8 warps per (bh, 128
// query rows), looping over the 128-key tiles in band and under the length.
// What bounds it on an H100: 2 * pairs * (d1 + dv) FLOPs on the fp32 FMA
// pipe (67 TFLOP/s); S is d1 / (d1 + dv) of it (90% at d1 576, dv 64). The
// pieces, and what each does about its bound:
//   * S on the CUDA cores: a thread owns an 8 x 8 piece of the 128 x 128
//     score tile (query rows 8g.., keys kc + 16c) and reads both operands as
//     16-byte shared loads of 4 depth steps (`chain_box<8, 8>`, the backward's
//     chain at another piece shape). Shared memory gives a block 32 floats a
//     clock against 128 FMAs; the 8 x 8 piece reads 0.25 floats an FMA, so
//     its loads and its FMAs take the same clocks (a 4 x 4 piece reads 0.5,
//     an 8 x 4 piece 0.375: bound by the loads at 67% of the FMA rate);
//   * streaming: a ring of 5 stages of tensor copies ([128 x 32] fp32 boxes
//     with the 128-byte swizzle, zeros past the edges, so any d1 runs and a
//     depth that is not a multiple of 32 reads zeros). A stage carries one
//     32-column box of the block's 128 query rows and one of the tile's 128
//     keys, or 64 columns of the tile's v rows. The query rows are read again
//     for every key tile: at 128 query rows they would take 288 KB at d1 576,
//     and a resident 64-row tile (144 KB) leaves room for 128-key stages
//     only with 8 x 4 pieces. 128 x 128 tiles read each fp32 element of qs
//     and ks from L2 once per 128 uses, as many bytes an FMA as a resident
//     64-row tile does. Each warp hands a stage back through an mbarrier when
//     it is done with it; the warps take turns refilling, the stage of chunk
//     i - 2 at chunk i, so no block barrier stands between two chunks and
//     the copies run up to 3 chunks ahead;
//   * the online softmax on the thread's S registers (row max and sum by
//     shuffles over the 16 lanes of a row group), then P through a shared
//     [128 x 128] tile (two block barriers a key tile) into O += P V on the
//     FMA pipe, O in registers (8 rows x 4 columns a thread per 64 columns
//     of dv: 32 or 64 registers), P and v read as 16-byte loads;
//   * shared memory: 5 stages of 32 KB and the 64 KB P tile, 225 KB; one
//     block an SM; 254 registers a thread, no spills. No atomics: o and lse
//     are the same bits on every call.
// Timed on an H100 with parts removed: S and the softmax run at 53-59% of
// the FMA rate (the pieces' loads take as many of shared memory's clocks as
// their FMAs take of the FMA pipe's; 2-step loads, which leave ptxas room to
// load ahead, were 10% slower); P V takes 10% of the kernel at d1 576, dv 64
// and 20% at d1 224, dv 48; without S the rest (the copies, the softmax,
// P V) takes a quarter of the kernel's time at d1 576.
//
// The backward (redesigned for Hopper): one template over the dQ kernel
// (own side the queries, other side the keys) and the dK/dV kernel (own side
// the keys, other side the queries; the band inverts), one block of 12 warps
// per (bh, 32 own rows, pass of 576 gradient columns), looping over the
// other side's 64-row tiles in band. What bounds it on an H100: S and dP,
// 2 * pairs * (d1 + dv) FLOPs on the fp32 FMA pipe (67 TFLOP/s), and the
// gradient products, 2 * pairs * d1 (dQ) or 2 * pairs * (d1 + dv) (dK, dV),
// on the tensor cores in 3xTF32 (495 / 3 = 165 TFLOP/s effective at most:
// mma.sync does not reach the card's TF32 peak); the bytes each input and
// output moves once are far under either. The pieces, and what each does
// about its bound:
//   * S and dP on the CUDA cores, 4 "S" warps: a thread owns a 4 x 4 piece of
//     the 32 x 64 score tile (own rows 4i.., other rows j + 16c) and reads both
//     operands as 16-byte shared loads of 4 depth steps (`chain_box`). Shared
//     memory delivers a block 32 floats a clock against 128 FMAs, so the
//     loads bound it: 0.5 floats an FMA here (a 2 x 4 piece reads 0.75). The
//     S warps then form P and dS, split them into tf32
//     hi and lo, and write them to a shared [32 x 64] tile of (hi, hi, lo, lo)
//     pairs, double-buffered, so they run a tile ahead of the G warps;
//   * the gradients on the tensor cores, 8 "G" warps: dQ (dK, and dV in pass
//     0) stays in fp32 mma fragments across the whole loop, each warp all 32
//     own rows x up to 9 n-tiles of 8 columns (72 registers a thread), dV 2
//     n-tiles more. One pass over the gradient columns up to d1 576 (Small's
//     224, Large's 576; XLarge's 1152 in two, d_model 640's 720 in two), so S
//     and dP are formed once per (own tile, other tile, pass). Each product
//     is 3xTF32 (mma.sync m16n8k8): dS (P) hi and lo come from their tile
//     with one 16-byte load a fragment row; the other side's rows are split
//     in registers as their fragments are read, so the streamed tiles stay
//     fp32. The mma's k index runs over other rows 2t and 2t + 1 (t = lane %
//     4) on both sides, so both operands' reads are free of bank conflicts. A
//     k-step's three products are summed apart and added to the fragment with
//     an fp32 add: accumulated on the tensor cores, which round toward zero,
//     the gradients drift from the plain fp32 version as T grows, near the
//     2e-5 limit at the flagship's T 1843;
//   * streaming: each warp group has a ring of tensor copies (the Tensor
//     Memory Accelerator; [rows x 32] fp32 boxes with the 128-byte swizzle,
//     so the 8 rows a load instruction reads hit 8 distinct bank groups): the
//     S ring carries per other tile its d1 columns in [64 x 32] boxes (beside
//     the own rows' boxes where they stream) and its dv columns with the own
//     dO (v) rows; the gradient ring the tile's rows again in 8-row chunks of
//     the pass's columns (one mma k-step each; the dK/dV kernel's pass 0 adds
//     the dO rows for dV). The other side is read twice, from L2, so that
//     shared memory holds no 64 x d1 tile. Each ring is refilled by its
//     group's warps in turn, after the barrier at which every warp of the
//     group is done with the stage (a dedicated producer warp would make 13
//     warps, which the register file allots as 16: 128 registers a thread);
//     a gradient chunk's boxes are issued by one warp's lanes at once. The
//     own d1 rows stay resident where that leaves room for 4 gradient
//     stages, else they stream; nothing sets a limit on d1;
//   * shared memory (`plan`, reported by flash_attention_bwd_f32_plan): at d1
//     576, dv 64 both kernels stream their own rows: dQ 4 S stages of 12 KB,
//     7 gradient stages of 18 KB and two 18 KB dS tiles, 211 KB; dK/dV the
//     same S ring, 5 gradient stages of 20 KB and two dS and two P tiles,
//     221 KB; the own rows stay resident up to d1 544 (dQ) and 384 (dK/dV)
//     at dv 64 (Small's 224 in both; there, on an H100, resident rows make
//     dK/dV 2% faster than streamed ones and dQ no slower, timed in turns
//     with `chip_smoke.py --flash-bench`). One block an SM;
//   * no atomics: every output is the same bits on every call. The outputs go
//     straight from the fragments to device memory as 8-byte stores.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "flash_tiles.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int MAXDV = 128;
constexpr float NEG_INF = -1e30f;
constexpr int BOXW = 32;  // columns of a box: 128 bytes of fp32

__device__ inline bool in_band(int i, int j, int left, int right) {
  return (left < 0 || i - j <= left) && (right < 0 || j - i <= right);
}

// Element (r, c) of a box of 32-float rows written with the 128-byte
// swizzle: the 16-byte unit c / 4 of row r sits at unit (c / 4) ^ (r % 8).
// The box starts 1024-byte aligned.
__device__ inline int swz(int r, int c) { return r * BOXW + ((((c >> 2) ^ r) & 7) << 2) + (c & 3); }

// acc[r][c] += sum over the box's 32 columns, in order, of A[ra + r][.] *
// B[rb + 16c][.]: one fmaf chain per element, the chain every kernel here
// forms S in (fmaf's two factors commute exactly, so the dK/dV kernel's
// K-times-Qs chain is the forward's Qs-times-K one). A and B are boxes of
// 32-float rows, both swizzled; (ra % 8) + R <= 8, and rb % 8 is the lane's
// column within its quarter warp, so the 8 lanes of a quarter warp read one
// A row, or 8 B rows at distinct units. Shared memory gives a block 32
// floats a clock against 128 FMAs: an R x C piece reads (R + C) / (R * C)
// floats an FMA, 0.5 at the backward's 4 x 4 and 0.25 at the forward's 8 x 8.
template <int R, int C>
__device__ inline void chain_box(float (&acc)[R][C], const float* A, const float* B, int ra,
                                 int rb) {
  const float* a = A + ra * BOXW;
  const float* b = B + rb * BOXW;
  const int xa = ra & 7, xb = rb & 7;
#pragma unroll
  for (int u = 0; u < BOXW / 4; ++u) {
    float4 x[R], y[C];
#pragma unroll
    for (int r = 0; r < R; ++r)
      x[r] = *reinterpret_cast<const float4*>(a + r * BOXW + ((u ^ (xa + r)) << 2));
#pragma unroll
    for (int c = 0; c < C; ++c)
      y[c] = *reinterpret_cast<const float4*>(b + c * 16 * BOXW + ((u ^ xb) << 2));
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = fmaf(x[r].x, y[c].x, acc[r][c]);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = fmaf(x[r].y, y[c].y, acc[r][c]);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = fmaf(x[r].z, y[c].z, acc[r][c]);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = fmaf(x[r].w, y[c].w, acc[r][c]);
  }
}

// ---------------------------------------------------------------------------
// The forward
// ---------------------------------------------------------------------------

namespace fwd {

using namespace tc;

constexpr int TILE = 128;    // query rows of a block, keys of a tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PR = 8, PC = 8;  // a thread's score piece: query rows 8g.., keys kc + 16c
constexpr int STAGES = 5;
constexpr int LAG = 2;       // at chunk i, the stage of chunk i - LAG is refilled
constexpr int LDP = TILE;    // floats a P row
constexpr size_t BOX = sizeof(float) * TILE * BOXW;  // a [128 x 32] box
constexpr size_t STAGE = 2 * BOX;    // a box of queries and one of keys, or 64 columns of v
constexpr size_t RING = STAGES * STAGE;
constexpr size_t P_TILE = sizeof(float) * TILE * LDP;
// dynamic shared memory a launch asks for: the ring, the P tile, the
// mbarriers, and 1024 bytes to align the ring
constexpr size_t SMEM = RING + P_TILE + 2 * STAGES * sizeof(uint64_t) + 1024;

struct Maps {  // qs and ks ([rows x d1]) and v ([rows x dv]) as [128 x 32] boxes
  CUtensorMap q, k, v;
};

// a reduction over the 16 lanes of a row group (lanes 16h .. 16h + 15)
__device__ inline float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ inline float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the key tiles [lo, hi) that query tile `q0` meets under a band (left,
// right) and the length klim (the TPU kernel's _band_tile_bounds, then
// capped)
__device__ inline void band_tiles(int q0, int T, int klim, int left, int right, int* lo,
                                  int* hi) {
  const int n_tiles = (T + TILE - 1) / TILE;
  *lo = left >= 0 ? max(q0 - left, 0) / TILE : 0;
  *hi = right >= 0 ? min((q0 + TILE - 1 + right) / TILE + 1, n_tiles) : n_tiles;
  *hi = min(*hi, (klim + TILE - 1) / TILE);
}

// NU: 64-column chunks of v (1 for dv <= 64, else 2). Each key tile takes
// nc1 = ceil(d1 / 32) chunks of the ring for S, then NU for P V.
template <int NU>
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const __grid_constant__ Maps maps, const int* __restrict__ lens, float* __restrict__ o,
           float* __restrict__ lse, int T, int d1, int dv, float scale, int left, int right) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* ps = reinterpret_cast<float*>(smem + RING);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RING + P_TILE);  // a chunk has landed
  uint64_t* empty = full + STAGES;                  // every warp is done with the stage

  const int bh = blockIdx.y, q0 = blockIdx.x * TILE, row0 = bh * T;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int g = 2 * warp + (l >> 4);  // row group: query rows q0 + 8g .. q0 + 8g + 7
  const int kc = l & 15;              // S: keys kc + 16c of a tile; P V: columns 4kc.. of 64
  const int klim = min(max(lens[bh], 0), T);
  int lo, hi;
  band_tiles(q0, T, klim, left, right, &lo, &hi);
  const int nc1 = (d1 + BOXW - 1) / BOXW;
  const int per = nc1 + NU;                 // chunks a key tile
  const int n = max(hi - lo, 0) * per;      // chunks of the block

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // chunk i: key tile lo + i / per; its depth box c = i % per, or past nc1
  // the 64-column chunk c - nc1 of its v rows (one box or two)
  auto issue = [&](int i) {
    const int st = i % STAGES, k0 = (lo + i / per) * TILE, c = i % per;
    unsigned char* dst = smem + st * STAGE;
    if (c < nc1) {
      mbar_arrive_expect(&full[st], 2 * BOX);
      tma_load_2d(dst, &maps.q, BOXW * c, row0 + q0, &full[st]);
      tma_load_2d(dst + BOX, &maps.k, BOXW * c, row0 + k0, &full[st]);
    } else {
      const int u = c - nc1, nb = min(2, (dv - 64 * u + BOXW - 1) / BOXW);
      mbar_arrive_expect(&full[st], nb * BOX);
      for (int b = 0; b < nb; ++b)
        tma_load_2d(dst + b * BOX, &maps.v, 64 * u + BOXW * b, row0 + k0, &full[st]);
    }
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(STAGES, n); ++i) issue(i);
  // chunk i's stage once it has landed; first, warp i % 8 refills the stage
  // of chunk i - LAG with chunk i - LAG + STAGES once every warp is done
  // with it
  auto take = [&](int i) {
    const int j = i - LAG;
    if (j >= 0 && j + STAGES < n && warp == i % WARPS && l == 0) {
      mbar_wait(&empty[j % STAGES], (j / STAGES) & 1);
      issue(j + STAGES);
    }
    __syncwarp();
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    return reinterpret_cast<const float*>(smem + (i % STAGES) * STAGE);
  };
  auto release = [&](int i) {  // this warp is done with chunk i's stage
    __syncwarp();
    if (l == 0) mbar_arrive(&empty[i % STAGES]);
  };

  float m_run[PR], l_run[PR], oacc[NU][PR][4];
#pragma unroll
  for (int r = 0; r < PR; ++r) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[u][r][e] = 0.f;
  }
  int i = 0;  // chunks taken
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * TILE;
    float s[PR][PC];
#pragma unroll
    for (int r = 0; r < PR; ++r)
#pragma unroll
      for (int c = 0; c < PC; ++c) s[r][c] = 0.f;
    for (int c = 0; c < nc1; ++c, ++i) {
      const float* stf = take(i);
      chain_box(s, stf, stf + BOX / sizeof(float), 8 * g, kc);
      release(i);
    }
#pragma unroll
    for (int r = 0; r < PR; ++r) {
      const int qi = q0 + 8 * g + r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const int kj = k0 + kc + 16 * c;
        // rounded here, never fused into the exponent's subtraction: the
        // backward recomputes exactly this value
        s[r][c] = kj < klim && in_band(qi, kj, left, right) ? __fmul_rn(s[r][c], scale)
                                                             : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m_run[r], mx);
      const float m_safe = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
      const float alpha = m_run[r] <= NEG_INF * 0.5f ? 0.f : expf(m_run[r] - m_safe);
      m_run[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        s[r][c] = expf(s[r][c] - m_safe);  // a masked score is -1e30: exactly 0
        sum += s[r][c];
      }
      l_run[r] = l_run[r] * alpha + sum;  // this thread's share of the row
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[u][r][e] *= alpha;
    }
    __syncthreads();  // every warp is done with the previous tile's P
#pragma unroll
    for (int r = 0; r < PR; ++r)
#pragma unroll
      for (int c = 0; c < PC; ++c) ps[(8 * g + r) * LDP + kc + 16 * c] = s[r][c];
    __syncthreads();
    // O[rows 8g.., columns 64u + 4kc..] += P V over the tile's keys in order;
    // the lane's 4 columns are one 16-byte unit of v's box kc / 8
    const float* prow = ps + 8 * g * LDP;
#pragma unroll
    for (int u = 0; u < NU; ++u, ++i) {
      const float* vbox = take(i) + (kc >> 3) * (BOX / sizeof(float));
      const int cu = kc & 7;
#pragma unroll 2
      for (int k = 0; k < TILE; k += 4) {
        float4 p[PR];
#pragma unroll
        for (int r = 0; r < PR; ++r) p[r] = *reinterpret_cast<const float4*>(prow + r * LDP + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int kr = k + kk;
          const float4 vv =
              *reinterpret_cast<const float4*>(vbox + kr * BOXW + ((cu ^ (kr & 7)) << 2));
#pragma unroll
          for (int r = 0; r < PR; ++r) {
            const float pk = kk == 0 ? p[r].x : kk == 1 ? p[r].y : kk == 2 ? p[r].z : p[r].w;
            oacc[u][r][0] = fmaf(pk, vv.x, oacc[u][r][0]);
            oacc[u][r][1] = fmaf(pk, vv.y, oacc[u][r][1]);
            oacc[u][r][2] = fmaf(pk, vv.z, oacc[u][r][2]);
            oacc[u][r][3] = fmaf(pk, vv.w, oacc[u][r][3]);
          }
        }
      }
      release(i);
    }
  }
#pragma unroll
  for (int r = 0; r < PR; ++r) {
    const int qi = q0 + 8 * g + r;
    const float lsum = row_sum(l_run[r]);
    const float l_safe = lsum == 0.f ? 1.f : lsum;
    if (qi >= T) continue;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int col = 64 * u + 4 * kc;
      if (col < dv)
        *reinterpret_cast<float4*>(o + ((size_t)row0 + qi) * dv + col) =
            make_float4(oacc[u][r][0] / l_safe, oacc[u][r][1] / l_safe, oacc[u][r][2] / l_safe,
                        oacc[u][r][3] / l_safe);
    }
    if (kc == 0)
      lse[(size_t)row0 + qi] = (m_run[r] <= NEG_INF * 0.5f ? 0.f : m_run[r]) + logf(l_safe);
  }
}

template <int NU>
int launch(const void* qs, const void* ks, const void* v, const void* lens, void* o, void* lse,
           int bh, int t, int d1, int dv, float scale, int left, int right, void* stream) {
  const long long rows = (long long)bh * t;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  Maps m;
  if (!flash::tensor_map(&m.q, qs, d1, rows, TILE, f32) ||
      !flash::tensor_map(&m.k, ks, d1, rows, TILE, f32) ||
      !flash::tensor_map(&m.v, v, dv, rows, TILE, f32))
    return (int)cudaErrorNotSupported;
  const cudaError_t err =
      cudaFuncSetAttribute(fwd_kernel<NU>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<NU><<<dim3((t + TILE - 1) / TILE, bh), THREADS, SMEM, (cudaStream_t)stream>>>(
      m, (const int*)lens, (float*)o, (float*)lse, t, d1, dv, scale, left, right);
  return (int)cudaGetLastError();
}

}  // namespace fwd

// P of a visible pair from its S accumulator, as the 16-bit kernels form it:
// x = fl(S * scale), rounded as the forward rounds it (never fused into the
// subtraction), then exp(min(x - lse, 0)); with S the forward's chain, x is
// the forward's x bit for bit and x - lse <= 0
__device__ inline float p_of(float sv, float scale, float lse) {
  return expf(fminf(__fmul_rn(sv, scale) - lse, 0.f));
}

// ---------------------------------------------------------------------------
// The backward: one template over the dQ kernel (KV false) and the dK/dV
// kernel (KV true)
// ---------------------------------------------------------------------------

namespace bwd {

using namespace tc;

constexpr int OWN = 32;      // rows of the block's own side (queries for dQ, keys for dK/dV)
constexpr int OTH = 64;      // rows of a tile of the other side
constexpr int S_WARPS = 4;   // warps that form S, dP, P and dS on the FMA pipe
constexpr int G_WARPS = 8;   // warps that hold the gradients and run the tensor-core products
constexpr int THREADS = (S_WARPS + G_WARPS) * 32;
constexpr int NT = 9;        // n-tiles of 8 gradient columns a G warp holds in a pass
constexpr int PASS = G_WARPS * NT * 8;  // 576 gradient columns a pass
constexpr int KSTEP = 8;     // other rows of a gradient chunk: one mma k-step
constexpr int NG = OTH / KSTEP;         // gradient chunks of an other tile
constexpr int LDD = 2 * OTH + 16;       // floats a dS / P row: 32 (hi, hi, lo, lo) pairs, padded
constexpr int S_STAGES = 4;
constexpr int MAX_G_STAGES = 8;
constexpr int MIN_RESIDENT_G_STAGES = 4;
constexpr size_t OWN_BOX = sizeof(float) * OWN * BOXW;    // a [32 x 32] box
constexpr size_t OTH_BOX = sizeof(float) * OTH * BOXW;    // a [64 x 32] box
constexpr size_t ROW_BOX = sizeof(float) * KSTEP * BOXW;  // an [8 x 32] box
constexpr size_t S_STAGE = OWN_BOX + OTH_BOX;             // an S or dP chunk: a box of each side
constexpr size_t TILE = sizeof(float) * OWN * LDD;        // a dS or P tile
constexpr size_t BARS = 256;                              // the mbarriers

struct Layout {
  int nc1, nc2;   // boxes of 32 columns over d1 and over dv
  int gb1;        // boxes of a gradient chunk over a pass's columns (the first pass's)
  int g_stages;
  bool resident;  // the block's own d1 rows stay in shared memory
  // byte offsets from the block's 1024-aligned base (the resident rows at
  // 0), and the dynamic shared memory a launch asks for (1024 of it to align)
  size_t s_ring, g_ring, g_stage, ds, p, bar, total;
};

__host__ __device__ inline Layout layout(bool kv, bool resident, int g_stages, int d1, int dv) {
  Layout L;
  L.nc1 = (d1 + BOXW - 1) / BOXW;
  L.nc2 = (dv + BOXW - 1) / BOXW;
  L.gb1 = ((d1 < PASS ? d1 : PASS) + BOXW - 1) / BOXW;
  L.g_stages = g_stages;
  L.resident = resident;
  L.g_stage = ROW_BOX * (L.gb1 + (kv ? L.nc2 : 0));
  L.s_ring = resident ? OWN_BOX * L.nc1 : 0;
  L.g_ring = L.s_ring + S_STAGES * S_STAGE;
  L.ds = L.g_ring + g_stages * L.g_stage;  // two dS tiles, then (dK/dV) two P tiles
  L.p = L.ds + 2 * TILE;
  L.bar = L.p + (kv ? 2 * TILE : 0);
  L.total = L.bar + BARS + 1024;
  return L;
}

// The layout a launch at (d1, dv) takes: the own d1 rows resident where that
// leaves room for MIN_RESIDENT_G_STAGES gradient stages, else streamed; as
// many gradient stages as fit, up to MAX_G_STAGES. Streamed, two always fit:
// a gradient stage is at most 22 KB (576 columns and dv 128 in 8-row boxes).
inline Layout plan(bool kv, int d1, int dv) {
  for (int s = MAX_G_STAGES; s >= MIN_RESIDENT_G_STAGES; --s) {
    const Layout L = layout(kv, true, s, d1, dv);
    if (L.total <= flash::SMEM_BLOCK) return L;
  }
  for (int s = MAX_G_STAGES; s > 2; --s) {
    const Layout L = layout(kv, false, s, d1, dv);
    if (L.total <= flash::SMEM_BLOCK) return L;
  }
  return layout(kv, false, 2, d1, dv);
}

// Tensor maps of a launch: the own side's and the other side's d1 rows (qs
// and ks) as [32 x 32] and [64 x 32] boxes, their dv rows (dO and v) the same,
// and the other side's d1 and dv rows as [8 x 32] boxes for the gradient
// chunks (g2: dO, the dK/dV kernel's dV).
struct Maps {
  CUtensorMap own_s, oth_s, own_p, oth_p, g1, g2;
};

// The A fragments (hi and lo) of own rows 16m.. at k-step ks from a dS or P
// tile: other rows 8ks + 2t and 8ks + 2t + 1 are the fragment's k = t and t
// + 4 (t = lane % 4), one (hi, hi, lo, lo) pair of a row
__device__ inline void a_frags(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* tile, int m,
                               int ks, int g, int t) {
  const float4 x = *reinterpret_cast<const float4*>(tile + (16 * m + g) * LDD + 4 * (4 * ks + t));
  const float4 y =
      *reinterpret_cast<const float4*>(tile + (16 * m + g + 8) * LDD + 4 * (4 * ks + t));
  hi[0] = __float_as_uint(x.x); hi[1] = __float_as_uint(y.x);
  hi[2] = __float_as_uint(x.y); hi[3] = __float_as_uint(y.y);
  lo[0] = __float_as_uint(x.z); lo[1] = __float_as_uint(y.z);
  lo[2] = __float_as_uint(x.w); lo[3] = __float_as_uint(y.w);
}

// Where this lane's B fragment of n-tile `nt` (columns 8nt.. of [8 x 32]
// boxes stacked by column) sits in a gradient chunk: the float offset of its
// row 2t element, column 8nt + g; row 2t + 1's is one row on, at unit
// (c / 4) ^ (2t + 1), row 2t's unit XOR 1 (b_next)
__device__ inline int b_at(int nt, int g, int t) {
  const int col = 8 * nt + g;
  return (col >> 5) * KSTEP * BOXW + swz(2 * t, col & 31);
}
__device__ inline int b_next(int at) { return (at + BOXW) ^ 4; }

// The B fragment (hi, lo split) at offset `at` (b_at) of a gradient chunk
__device__ inline void b_frag(uint32_t (&b)[4], const float* chunk, int at) {
  split_tf32(chunk[at], b[0], b[2]);
  split_tf32(chunk[b_next(at)], b[1], b[3]);
}

// acc += a b over one k-step in 3xTF32, the k-step's three products summed
// apart first: the tensor cores round each accumulation toward zero, which
// over a whole loop of k-steps into acc drifts by ~1e-5; a k-step's own sum
// is small and its error random in sign, and acc takes it with an fp32 add
__device__ inline void mma_step(float (&acc)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                const uint32_t (&b)[4]) {
  float t[4];
  mma1688_3x(t, ah, al, b[0], b[1], b[2], b[3]);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// a barrier of one warp group: id 1 the S warps, id 2 the G warps
__device__ inline void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// RES: the own d1 rows resident (else streamed beside the other side's
// boxes). grad: dq (KV false) or dk (KV true) [bh, T, d1]; dvo: dv [bh, T,
// dv] (KV). Two warp groups work on the other tiles at once, a tile or two
// apart: the S warps form tile j's S and dP (FMA chains) and write its P and
// dS into shared buffer j % 2; the G warps take them from there with the
// tile's rows streamed again, into the gradients (tensor cores). Each group
// has its own ring of tensor copies, refilled by its warps in turn.
template <bool KV, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
bwd_kernel(const __grid_constant__ Maps maps, const float* __restrict__ lse,
           const float* __restrict__ delta, const int* __restrict__ lens,
           float* __restrict__ grad, float* __restrict__ dvo, int T, int d1, int dv,
           float scale, int left, int right, int g_stages) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Layout L = layout(KV, RES, g_stages, d1, dv);
  uint64_t* s_full = reinterpret_cast<uint64_t*>(smem + L.bar);  // an S / dP chunk has landed
  uint64_t* g_full = s_full + S_STAGES;                           // a gradient chunk has landed
  uint64_t* ds_full = g_full + MAX_G_STAGES;   // a tile's dS (and P) are in buffer b
  uint64_t* ds_empty = ds_full + 2;            // the G warps are done with buffer b
  uint64_t* obar = ds_empty + 2;               // the resident rows have landed

  const int bh = blockIdx.y, own0 = blockIdx.x * OWN;
  const int pc0 = blockIdx.z * PASS;                // this pass's first gradient column
  const int pw = min(PASS, d1 - pc0);               // and its width
  const bool with_dv = KV && blockIdx.z == 0;       // dV once, in the first pass
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int klim = min(max(lens[bh], 0), T);        // keys and queries < klim are valid

  // other tiles in band of own rows own0..own0+31 (_band_tile_bounds; for
  // the dK/dV kernel the window inverts), capped at the length; none when
  // every own row is past the length
  const int before = KV ? right : left, after = KV ? left : right;
  const int n_tiles = (T + OTH - 1) / OTH;
  int lo = 0, hi = n_tiles;
  if (before >= 0) lo = max(own0 - before, 0) / OTH;
  if (after >= 0) hi = min((own0 + OWN - 1 + after) / OTH + 1, n_tiles);
  hi = min(hi, (klim + OTH - 1) / OTH);
  if (own0 >= klim) hi = lo;

  const int gb1 = (pw + BOXW - 1) / BOXW;  // this pass's boxes in a gradient chunk
  const int ns = L.nc1 + L.nc2;            // S and dP chunks of a tile
  const int own_row = bh * T + own0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S_STAGES; ++s) mbar_init(&s_full[s], 1);
    for (int s = 0; s < g_stages; ++s) mbar_init(&g_full[s], 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(&ds_full[b], S_WARPS * 32);
      mbar_init(&ds_empty[b], G_WARPS * 32);
    }
    mbar_init(obar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  // chunks of each ring (none where no tile is in band: the gradients are 0)
  const int n_s = max(hi - lo, 0) * ns, n_g = max(hi - lo, 0) * NG;

  if (warp < S_WARPS) {
    // ------------------------------------------------------------------ S warps
    // S chunk i: tile lo + i / ns; depth box c = i % ns over d1, then over dv
    auto s_issue = [&](int i) {
      const int st = i % S_STAGES, ot = lo + i / ns, c = i % ns;
      const bool d1_part = c < L.nc1;
      const bool with_own = !RES || !d1_part;
      mbar_arrive_expect(&s_full[st], OTH_BOX + (with_own ? OWN_BOX : 0));
      unsigned char* dst = smem + L.s_ring + st * S_STAGE;
      const int col = BOXW * (d1_part ? c : c - L.nc1);
      tma_load_2d(dst, d1_part ? &maps.oth_s : &maps.oth_p, col, bh * T + ot * OTH, &s_full[st]);
      if (with_own)
        tma_load_2d(dst + OTH_BOX, d1_part ? &maps.own_s : &maps.own_p, col, own_row,
                    &s_full[st]);
    };
    if (threadIdx.x == 0) {
      if (RES && n_s > 0) {
        mbar_arrive_expect(obar, OWN_BOX * L.nc1);
        for (int c = 0; c < L.nc1; ++c)
          tma_load_2d(smem + c * OWN_BOX, &maps.own_s, BOXW * c, own_row, obar);
      }
      for (int i = 0; i < min(S_STAGES, n_s); ++i) s_issue(i);
    }
    if (RES && n_s > 0) mbar_wait(obar, 0);
    // Score piece of this thread: own rows ra .. ra + 3, other rows rb + 16c
    // (c < 4) of the 32 x 64 tile
    const int ra = 16 * (warp & 1) + 4 * (l >> 3), rb = 8 * (warp >> 1) + (l & 7);
    const float* lse_bh = lse + (size_t)bh * T;
    const float* delta_bh = delta + (size_t)bh * T;
    float lse_o[4], delta_o[4];  // dQ: the own rows' (queries')
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = own0 + ra + r;
      lse_o[r] = !KV && qi < T ? lse_bh[qi] : 0.f;
      delta_o[r] = !KV && qi < T ? delta_bh[qi] : 0.f;
    }
    int i = 0;  // S chunks taken
    for (int it = lo; it < hi; ++it) {
      const int o0 = it * OTH;
      float lse_c[4], delta_c[4];  // dK/dV: the queries of this thread's score columns
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = o0 + rb + 16 * c;
        lse_c[c] = KV && qi < T ? lse_bh[qi] : 0.f;
        delta_c[c] = KV && qi < T ? delta_bh[qi] : 0.f;
      }
      // S over d1 in the forward's chain (S^T for the dK/dV kernel), then dP
      float s[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
      for (int c = 0; c < ns; ++c, ++i) {
        // chunk i, once it has landed and every S warp is done with chunk
        // i - 1, whose stage S warp i % 4 refills with chunk i - 1 + stages
        const int st = i % S_STAGES;
        mbar_wait(&s_full[st], (i / S_STAGES) & 1);
        group_sync(1, S_WARPS * 32);
        if (i > 0 && i - 1 + S_STAGES < n_s && threadIdx.x == 32 * (i % S_WARPS)) {
          fence_proxy_async();
          s_issue(i - 1 + S_STAGES);
        }
        const float* stf = reinterpret_cast<const float*>(smem + L.s_ring + st * S_STAGE);
        if (c < L.nc1)
          chain_box(s, RES ? reinterpret_cast<const float*>(smem) + c * (OWN_BOX / 4)
                           : stf + OTH_BOX / 4,
                    stf, ra, rb);
        else
          chain_box(dp, stf + OTH_BOX / 4, stf, ra, rb);
      }
      // the tile's P and dS, split for the tensor cores, into buffer j % 2
      // once the G warps are done with the tile two before (j: the tile's
      // place from lo)
      const int j = it - lo, b = j & 1;
      if (j >= 2) mbar_wait(&ds_empty[b], ((j >> 1) - 1) & 1);
      float* ds_t = reinterpret_cast<float*>(smem + L.ds + b * TILE);
      float* p_t = reinterpret_cast<float*>(smem + L.p + b * TILE);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int oi = own0 + ra + r, oj = o0 + rb + 16 * c;
          const int qi = KV ? oj : oi, kj = KV ? oi : oj;
          const bool ok = qi < klim && kj < klim && in_band(qi, kj, left, right);
          const float lq = KV ? lse_c[c] : lse_o[r], dq = KV ? delta_c[c] : delta_o[r];
          const float p = ok ? p_of(s[r][c], scale, lq) : 0.f;
          const float d = ok ? p * (dp[r][c] - dq) * scale : 0.f;
          const int kk = rb + 16 * c, at = (ra + r) * LDD + 4 * (kk >> 1) + (kk & 1);
          uint32_t h, lw;
          split_tf32(d, h, lw);
          ds_t[at] = __uint_as_float(h);
          ds_t[at + 2] = __uint_as_float(lw);
          if (KV) {
            split_tf32(p, h, lw);
            p_t[at] = __uint_as_float(h);
            p_t[at + 2] = __uint_as_float(lw);
          }
        }
      }
      mbar_arrive(&ds_full[b]);
    }
    return;
  }

  // -------------------------------------------------------------------- G warps
  const int gw = warp - S_WARPS;
  // gradient chunk i: tile lo + i / 8, its rows 8 (i % 8).. over the pass's
  // columns (and over dv for dV), issued by a whole warp, lane b copying box
  // b, so that no lane issues many copies while the other G warps wait for
  // the refill at the next chunk
  const int n_box = gb1 + (with_dv ? L.nc2 : 0);
  auto g_issue = [&](int i) {
    const int st = i % g_stages, ot = lo + i / NG, k = i % NG;
    if (l == 0) mbar_arrive_expect(&g_full[st], ROW_BOX * n_box);
    __syncwarp();
    unsigned char* dst = smem + L.g_ring + st * L.g_stage;
    const int row = bh * T + ot * OTH + KSTEP * k;
    for (int b = l; b < n_box; b += 32) {
      fence_proxy_async();  // the G warps' reads of the stage before the copy's writes
      if (b < gb1)
        tma_load_2d(dst + b * ROW_BOX, &maps.g1, pc0 + BOXW * b, row, &g_full[st]);
      else
        tma_load_2d(dst + b * ROW_BOX, &maps.g2, BOXW * (b - gb1), row, &g_full[st]);
    }
  };
  if (gw == 0)
    for (int i = 0; i < min(g_stages, n_g); ++i) g_issue(i);
  const int g = l >> 2, t4 = l & 3;  // the lane's fragment row and column
  // this warp's gradient n-tiles of the pass, nt0 .. nt0 + nk - 1; dV's
  // n-tiles gw and gw + 8
  const int pn = pw / 8, ntw = (pn + G_WARPS - 1) / G_WARPS;
  const int nt0 = gw * ntw, nk = max(0, min(ntw, pn - nt0));
  const int nv = with_dv ? dv / 8 : 0;
  int b_off[NT], bv_off[2];  // the lane's B fragments in a gradient chunk
#pragma unroll
  for (int jj = 0; jj < NT; ++jj) b_off[jj] = b_at(nt0 + jj, g, t4);
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) bv_off[jj] = gb1 * KSTEP * BOXW + b_at(gw + G_WARPS * jj, g, t4);
  float acc[2][NT][4], accv[2][2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accv[m][j][e] = 0.f;
  }
  int i = 0;  // gradient chunks taken
  for (int it = lo; it < hi; ++it) {
    const int j = it - lo, b = j & 1;
    mbar_wait(&ds_full[b], (j >> 1) & 1);
    const float* ds_t = reinterpret_cast<const float*>(smem + L.ds + b * TILE);
    const float* p_t = reinterpret_cast<const float*>(smem + L.p + b * TILE);
    for (int k = 0; k < NG; ++k, ++i) {
      // chunk i, once it has landed and every G warp is done with chunk i -
      // 1, whose stage G warp i % 8 refills with chunk i - 1 + stages
      const int st = i % g_stages;
      mbar_wait(&g_full[st], (i / g_stages) & 1);
      group_sync(2, G_WARPS * 32);
      if (i > 0 && i - 1 + g_stages < n_g && gw == i % G_WARPS) g_issue(i - 1 + g_stages);
      const float* stf = reinterpret_cast<const float*>(smem + L.g_ring + st * L.g_stage);
      // grad += dS X1 (X1 = ks for dQ, qs for dK) over the pass's columns,
      // dV += P^T dO
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) a_frags(ah[m], al[m], ds_t, m, k, g, t4);
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) {
        if (jj < nk) {
          uint32_t bf[4];
          b_frag(bf, stf, b_off[jj]);
#pragma unroll
          for (int m = 0; m < 2; ++m) mma_step(acc[m][jj], ah[m], al[m], bf);
        }
      }
      if (KV && with_dv) {
#pragma unroll
        for (int m = 0; m < 2; ++m) a_frags(ah[m], al[m], p_t, m, k, g, t4);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          if (gw + G_WARPS * jj < nv) {
            uint32_t bf[4];
            b_frag(bf, stf, bv_off[jj]);
#pragma unroll
            for (int m = 0; m < 2; ++m) mma_step(accv[m][jj], ah[m], al[m], bf);
          }
        }
      }
    }
    mbar_arrive(&ds_empty[b]);  // this thread is done with the tile's dS and P
  }

  // the fragments straight out as 8-byte stores: rows past T are not
  // written, rows past the length are 0
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int oi = own0 + 16 * m + g + 8 * h;
      if (oi >= T) continue;
      float* out = grad + ((size_t)bh * T + oi) * d1 + pc0 + 2 * t4;
#pragma unroll
      for (int jj = 0; jj < NT; ++jj)
        if (jj < nk)
          *reinterpret_cast<float2*>(out + 8 * (nt0 + jj)) =
              make_float2(acc[m][jj][2 * h], acc[m][jj][2 * h + 1]);
      if (KV)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          if (gw + G_WARPS * jj < nv)
            *reinterpret_cast<float2*>(dvo + ((size_t)bh * T + oi) * dv + 8 * (gw + G_WARPS * jj) +
                                       2 * t4) = make_float2(accv[m][jj][2 * h],
                                                             accv[m][jj][2 * h + 1]);
    }
  }
}

template <bool KV>
int launch(const void* qs, const void* ks, const void* v, const void* dout, const void* lse,
           const void* delta, const void* lens, void* grad, void* dvo, int bh, int t, int d1,
           int dv, float scale, int left, int right, void* stream) {
  if (dv > MAXDV || dv <= 0 || d1 <= 0 || d1 % 8 || dv % 8 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  const Layout L = plan(KV, d1, dv);
  const long long rows = (long long)bh * t;
  const void *own = KV ? ks : qs, *oth = KV ? qs : ks;
  const void *own2 = KV ? v : dout, *oth2 = KV ? dout : v;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  Maps m;
  if (!flash::tensor_map(&m.own_s, own, d1, rows, OWN, f32) ||
      !flash::tensor_map(&m.oth_s, oth, d1, rows, OTH, f32) ||
      !flash::tensor_map(&m.own_p, own2, dv, rows, OWN, f32) ||
      !flash::tensor_map(&m.oth_p, oth2, dv, rows, OTH, f32) ||
      !flash::tensor_map(&m.g1, oth, d1, rows, KSTEP, f32) ||
      !flash::tensor_map(&m.g2, oth2, dv, rows, KSTEP, f32))
    return (int)cudaErrorNotSupported;
  auto kernel = L.resident ? bwd_kernel<KV, true> : bwd_kernel<KV, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + OWN - 1) / OWN, bh, (d1 + PASS - 1) / PASS);
  kernel<<<grid, THREADS, L.total, (cudaStream_t)stream>>>(
      m, (const float*)lse, (const float*)delta, (const int*)lens, (float*)grad, (float*)dvo, t,
      d1, dv, scale, left, right, L.g_stages);
  return (int)cudaGetLastError();
}

}  // namespace bwd

}  // namespace

// qs, ks: [bh, t, d1] fp32; v: [bh, t, dv] fp32; lens: [bh] int32; o: [bh,
// t, dv] fp32; lse: [bh, t] fp32; all contiguous and 16-byte aligned, d1
// and dv multiples of 4 (the tensor copies' row stride), dv <= 128; any d1.
// Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd_f32(const void* qs, const void* ks, const void* v,
                                       const void* lens, void* o, void* lse, int bh, int t,
                                       int d1, int dv, float scale, int left, int right,
                                       void* stream) {
  if (dv > MAXDV || dv <= 0 || d1 <= 0 || d1 % 4 || dv % 4 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  return dv > 64 ? fwd::launch<2>(qs, ks, v, lens, o, lse, bh, t, d1, dv, scale, left, right,
                                  stream)
                 : fwd::launch<1>(qs, ks, v, lens, o, lse, bh, t, d1, dv, scale, left, right,
                                  stream);
}

// The backward's plan at (d1, dv) for the dQ kernel (kv 0) or the dK/dV
// kernel (kv 1): returns the dynamic shared memory a block asks for, and
// sets *resident (1 where the block's own rows stay in shared memory),
// *stages (the ring's) and *passes (of 576 gradient columns).
extern "C" int flash_attention_bwd_f32_plan(int d1, int dv, int kv, int* resident, int* stages,
                                            int* passes) {
  const bwd::Layout L = bwd::plan(kv != 0, d1, dv);
  *resident = L.resident;
  *stages = L.g_stages;
  *passes = (d1 + bwd::PASS - 1) / bwd::PASS;
  return (int)L.total;
}

// As flash_attention_bwd_dq_bf16 (flash_attention_bwd.cu) in fp32: qs, ks,
// v, dout and dq fp32; d1 and dv multiples of 8, dv <= 128, every tensor
// 16-byte aligned. Any d1.
extern "C" int flash_attention_bwd_dq_f32(const void* qs, const void* ks, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          const void* lens, void* dq, int bh, int t, int d1,
                                          int dv, float scale, int left, int right,
                                          void* stream) {
  return bwd::launch<false>(qs, ks, v, dout, lse, delta, lens, dq, nullptr, bh, t, d1, dv,
                            scale, left, right, stream);
}

// As flash_attention_bwd_dkv_bf16 in fp32: dk and dvo fp32.
extern "C" int flash_attention_bwd_dkv_f32(const void* qs, const void* ks, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           const void* lens, void* dk, void* dvo, int bh, int t,
                                           int d1, int dv, float scale, int left, int right,
                                           void* stream) {
  return bwd::launch<true>(qs, ks, v, dout, lse, delta, lens, dk, dvo, bh, t, d1, dv, scale,
                           left, right, stream);
}
