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
// Design for Hopper (mma.sync from ldmatrix, tensor copies into a ring, registers):
//   * one block per (bh, BQ-query tile), BQ 128 or 64 (`pick_rows`): BQ / 16
//     consumer warps, warp w owning query rows 16w..16w+15 of the tile (so
//     the softmax needs no exchange between warps), and one producer warp;
//   * the producer loads the block's Qs rows (BQ x d1 bf16) once, by bulk
//     copies (one a row, into rows padded for ldmatrix), where they stay;
//     then it streams Ks in (64-key tile x 192-deep) pieces and V in one
//     piece per key tile through a 3-slot ring by tensor copies of 64 x 64
//     boxes (the Tensor Memory Accelerator, 128-byte swizzle, zeros past
//     the tensor's edges), each slot with a "full" mbarrier (the copies'
//     bytes) and an "empty" one (every consumer warp is done with it): no
//     block-wide barrier in the loop;
//   * S = Qs Ks^T is mma.sync m16n8k16 bf16 from ldmatrix fragments into
//     fp32 registers (16 x 64 a warp, 32 a thread); the online softmax runs
//     on those accumulator fragments, with row max by quad shuffles, the TPU
//     kernel's m_safe / l_safe guards and its empty-row rule; masking is per
//     element (length, then band);
//   * the row max m and lse = m + log(l) are kept in the scores' own units
//     (S * scale, the value the backward recomputes), and each exponent is
//     exp2((x - m) * log2 e) of the difference: at scores past fp32's
//     integer range (|x| > 2^24) a detour through x * log2 e and back
//     rounds by many units, which the backward's exp(x - lse) would
//     amplify past fp32's range;
//   * P goes from the C fragments, rounded to bf16 in pairs, straight into
//     the A fragments of P V (tensor_core.cuh's pairing): no shared-memory
//     round trip; the row sums l are taken from the fp32 P before rounding;
//   * O accumulates in fp32 registers (16 x dv a warp: 32 a thread at dv 64)
//     and goes out once through shared memory in 16-byte rows;
//   * the key-tile loop runs from the band's first tile to the last tile
//     that holds a visible key (`_band_tile_bounds`, capped at the length).
// What decided the copies (probes on an H100, variants in turns inside one
// call): the time followed the number of copy requests a key tile takes,
// not the bytes in flight: with 64-deep pieces by cp.async (one
// __syncthreads a piece) or by one bulk copy a row, the copies alone (no S
// products) took about as long as the whole kernel; a 64 x 64 tensor copy
// moves a whole box in one request. The 128-row tile loads each piece once
// for 8 warps, and at d1 576 a 64-row block takes a whole SM too, so
// `pick_rows` takes 128 rows where they fit in shared memory (d1 <= 592)
// and give at least one block per SM, and 64 rows otherwise. Past the
// 64-row layout's shared memory (d1 1216) the kernel refuses:
// `flash_attention_fwd_smem_bytes`.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"
#include "tensor_core.cuh"

using namespace flash;
using namespace tc;

namespace {

constexpr int BK = 64;      // keys per tile
constexpr int BOX = 64;     // columns of a tensor-copy box (128 bytes: the swizzle span)
constexpr int FDC = 192;    // depth of a Ks piece: three boxes
constexpr int NSLOT = 3;    // ring slots
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t BOX_BYTES = sizeof(bf16) * BK * BOX;

// a barrier of the first n threads of the block (the consumer warps)
__device__ inline void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

struct FwdLayout {
  int d1p, dvp;  // d1 and dv rounded up to 16 (zero columns past d1, dv)
  int ldq;       // bf16 row stride of the Qs tile
  // byte offsets from the block's 1024-aligned base, the slot size, and the
  // dynamic shared memory a launch asks for (1024 bytes of it to align)
  size_t ring, slot, bar, q, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int rows, int d1, int dv) {
  FwdLayout L;
  L.d1p = round16(d1);
  L.dvp = round16(dv);
  L.ldq = L.d1p + 8;  // an odd number of 16-byte units: ldmatrix rows hit distinct banks
  const int v_boxes = (dv + BOX - 1) / BOX;
  L.slot = BOX_BYTES * (FDC / BOX > v_boxes ? FDC / BOX : v_boxes);
  L.ring = 0;  // swizzled boxes: 1024-byte aligned
  L.bar = NSLOT * L.slot;  // 2 NSLOT + 1 mbarriers
  L.q = L.bar + align128(sizeof(uint64_t) * (2 * NSLOT + 1));
  L.total = L.q + align128(sizeof(bf16) * rows * L.ldq) + 1024;
  return L;
}

// BQ query rows (BQ / 16 consumer warps) and one producer warp; NV n-tiles
// of 8 output columns a consumer warp holds (8 for dv <= 64, 16 for <= 128);
// F16: fp16 operands, else bf16
template <int BQ, int NV, bool F16>
__global__ void __launch_bounds__(BQ * 2 + 32, BQ == 64 ? 2 : 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const bf16* __restrict__ qs, const int* __restrict__ lens,
                 bf16* __restrict__ o, float* __restrict__ lse,
                 int T, int d1, int dv, float scale, int left, int right) {
  constexpr int NW = BQ / 16;  // consumer warps
  constexpr int NT = NW * 32 + 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const FwdLayout L = fwd_layout(BQ, d1, dv);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);  // a piece has landed
  uint64_t* empty = full + NSLOT;                              // every warp is done with it
  uint64_t* qbar = empty + NSLOT;                              // the Qs rows have landed
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int klim = min(max(lens[bh], 0), T);  // keys < klim can be visible

  // key tiles that can hold a visible key (the TPU kernel's _band_tile_bounds,
  // then capped at the key length)
  const int n_tiles = (T + BK - 1) / BK;
  int lo = 0, hi = n_tiles;
  if (left >= 0) lo = max(q0 - left, 0) / BK;
  if (right >= 0) hi = min((q0 + BQ - 1 + right) / BK + 1, n_tiles);
  hi = min(hi, (klim + BK - 1) / BK);
  const int nc = (L.d1p + FDC - 1) / FDC;  // Ks pieces a key tile
  const int per_tile = nc + 1;             // and its V piece
  const int n_pieces = hi > lo ? (hi - lo) * per_tile : 0;

  // zero Qs once: pad columns and rows past T are never loaded and must read
  // as finite (0 x garbage may be NaN in a product); the tensor copies fill
  // a box's columns past d1 or dv and rows past the tensor with zeros
  for (size_t i = threadIdx.x; i < sizeof(bf16) * BQ * L.ldq / 16; i += NT)
    reinterpret_cast<uint4*>(smem + L.q)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();  // the zeros land before the bulk copies into the same rows
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSLOT; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NW);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == NW) {
    // the producer warp: the block's Qs rows once (a bulk copy a row, lanes
    // over rows), then each piece into its ring slot as soon as every
    // consumer warp has released the slot: a Ks piece as up to three
    // 64 x 64 tensor-copy boxes, a V piece as one or two
    const int q_rows = min(BQ, T - q0);
    if (l == 0) mbar_arrive_expect(qbar, q_rows * d1 * 2);
    __syncwarp();
    for (int r = l; r < q_rows; r += 32)
      bulk_g2s(Qs + r * L.ldq, qs + ((size_t)bh * T + q0 + r) * d1, d1 * 2, qbar);
    if (l == 0) {
      for (int i = 0; i < n_pieces; ++i) {
        const int s = i % NSLOT;
        if (i >= NSLOT) mbar_wait(&empty[s], (i / NSLOT - 1) & 1);
        unsigned char* dst = smem + L.ring + s * L.slot;
        const int row0 = bh * T + (lo + i / per_tile) * BK, c = i % per_tile;
        const bool is_k = c < nc;
        const int c0 = is_k ? c * FDC : 0;
        const int boxes = ((is_k ? min(FDC, d1 - c0) : dv) + BOX - 1) / BOX;
        mbar_arrive_expect(&full[s], boxes * BOX_BYTES);
        for (int j = 0; j < boxes; ++j)
          tma_load_2d(dst + j * BOX_BYTES, is_k ? &tk : &tv, c0 + j * BOX, row0, &full[s]);
      }
    }
    return;
  }

  // the consumer warps: warp w owns query rows 16w..16w+15 of the tile
  const int g = l >> 2, c2 = 2 * (l & 3);
  float s[8][4], oacc[NV][4];
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};  // rows g, g + 8
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  const int nvt = L.dvp / 16;  // 16-column pairs of output n-tiles
  mbar_wait(qbar, 0);

  for (int i = 0; i < n_pieces; ++i) {
    const int slot = i % NSLOT;
    mbar_wait(&full[slot], (i / NSLOT) & 1);
    const bf16* P = reinterpret_cast<const bf16*>(smem + L.ring + slot * L.slot);
    const int c = i % per_tile;
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
    if (c < nc) {
      // S += Qs[:, c0 ..] Ks_piece^T for this warp's 16 rows x 64 keys
      const int c0 = c * FDC, ksteps = min(FDC, L.d1p - c0) / 16;
#pragma unroll 2
      for (int kk = 0; kk < ksteps; ++kk) {
        uint32_t a[4];
        ldsm4(a, a_addr(Qs, L.ldq, 16 * warp, c0 + 16 * kk, l));
#pragma unroll
        const bf16* box = P + (kk >> 2) * BK * BOX;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t b[4];  // keys 16n.. as two n-tiles, depth 16 (kk % 4)..
          ldsm4(b, swz128(box, 16 * n + (l & 7) + (l >> 4) * 8, 16 * (kk & 3) + ((l >> 3) & 1) * 8));
          mma<F16>(s[2 * n], a, b[0], b[1]);
          mma<F16>(s[2 * n + 1], a, b[2], b[3]);
        }
      }
    } else {
      // the V piece: online softmax of this key tile, then O += P V
      const int k0 = (lo + i / per_tile) * BK;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int qi = q0 + 16 * warp + g + 8 * h, kj = k0 + 8 * j + c2 + (e & 1);
          const bool ok = kj < klim && in_band(qi, kj, left, right);
          // rounded here, never fused into the exponent's subtraction: the
          // backward recomputes exactly this value
          s[j][e] = ok ? __fmul_rn(s[j][e], scale) : NEG_INF;
          mx[h] = fmaxf(mx[h], s[j][e]);
        }
      float alpha[2], m_safe[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h]);
        m_safe[h] = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
        alpha[h] = m_run[h] <= NEG_INF * 0.5f ? 0.f : exp2f((m_run[h] - m_safe[h]) * LOG2E);
        m_run[h] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked score is -1e30: exp2 of it is exactly 0
          s[j][e] = exp2f((s[j][e] - m_safe[e >> 1]) * LOG2E);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + sum[h];  // this lane's share
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[j][e] *= alpha[e >> 1];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack<F16>(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack<F16>(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack<F16>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack<F16>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < NV / 2; ++n) {
          if (n < nvt) {
            uint32_t b[4];  // keys 16kk.., output columns 16n.. as two n-tiles
            ldsm4t(b, swz128(P + (n >> 2) * BK * BOX, 16 * kk + (l & 7) + ((l >> 3) & 1) * 8,
                             16 * (n & 3) + (l >> 4) * 8));
            mma<F16>(oacc[2 * n], a, b[0], b[1]);
            mma<F16>(oacc[2 * n + 1], a, b[2], b[3]);
          }
        }
      }
    }
    __syncwarp();
    if (l == 0) mbar_arrive(&empty[slot]);  // this warp is done with the slot
  }

  // l over the quad, then o = O / l_safe and lse, rows g and g + 8; o goes
  // out through the ring once every consumer warp is done with it
  consumers_sync(NW * 32);
  bf16* Os = reinterpret_cast<bf16*>(smem + L.ring);  // BQ x (dvp + 8) bf16 fits in the ring
  const int ldo = L.dvp + 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lsum = l_run[h];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const float l_safe = lsum == 0.f ? 1.f : lsum;
    const float inv = 1.f / l_safe;
    const int row = 16 * warp + g + 8 * h;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (j < 2 * nvt)
        *reinterpret_cast<uint32_t*>(Os + row * ldo + 8 * j + c2) =
            pack<F16>(oacc[j][2 * h] * inv, oacc[j][2 * h + 1] * inv);
    if ((l & 3) == 0 && q0 + row < T)
      lse[(size_t)bh * T + q0 + row] =
          (m_run[h] <= NEG_INF * 0.5f ? 0.f : m_run[h]) + logf(l_safe);
  }
  consumers_sync(NW * 32);
  const int vec = dv / 8;
  for (int i = threadIdx.x; i < BQ * vec; i += NW * 32) {
    const int r = i / vec, c = (i % vec) * 8;
    if (q0 + r < T)
      *reinterpret_cast<uint4*>(o + ((size_t)bh * T + q0 + r) * dv + c) =
          *reinterpret_cast<const uint4*>(Os + r * ldo + c);
  }
}

// the query-tile height a launch takes (0 = none fits): 128 rows where they
// fit in a block's shared memory and give at least one block per SM, else 64
int pick_rows(int bh, int t, int d1, int dv) {
  const long blocks128 = (long)bh * ((t + 127) / 128);
  if (fwd_layout(128, d1, dv).total <= SMEM_BLOCK && blocks128 >= 132) return 128;
  return fwd_layout(64, d1, dv).total <= SMEM_BLOCK ? 64 : 0;
}

template <int BQ, int NV, bool F16>
int launch(const void* qs, const void* ks, const void* v, const void* lens, void* o, void* lse,
           int bh, int t, int d1, int dv, float scale, int left, int right, void* stream) {
  CUtensorMap tk, tv;
  if (!tensor_map(&tk, ks, d1, (long long)bh * t, BK) ||
      !tensor_map(&tv, v, dv, (long long)bh * t, BK))
    return (int)cudaErrorNotSupported;
  const FwdLayout L = fwd_layout(BQ, d1, dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<BQ, NV, F16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + BQ - 1) / BQ, bh);
  flash_fwd_kernel<BQ, NV, F16><<<grid, BQ * 2 + 32, L.total, (cudaStream_t)stream>>>(
      tk, tv, (const bf16*)qs, (const int*)lens, (bf16*)o, (float*)lse, t, d1, dv, scale, left,
      right);
  return (int)cudaGetLastError();
}

// The launch of either 16-bit type with the query-tile height given: 64 or
// 128 rows (0 = the launch's own choice).
template <bool F16>
int fwd_rows(const void* qs, const void* ks, const void* v, const void* lens, void* o, void* lse,
             int bh, int t, int d1, int dv, float scale, int left, int right, int rows,
             void* stream) {
  if (rows == 0) rows = pick_rows(bh, t, d1, dv);
  if ((rows != 64 && rows != 128) || fwd_layout(rows, d1, dv).total > SMEM_BLOCK ||
      dv > 128 || d1 % 8 || dv % 8)
    return (int)cudaErrorInvalidValue;
  if (rows == 128)
    return dv <= 64 ? launch<128, 8, F16>(qs, ks, v, lens, o, lse, bh, t, d1, dv, scale, left,
                                          right, stream)
                    : launch<128, 16, F16>(qs, ks, v, lens, o, lse, bh, t, d1, dv, scale, left,
                                           right, stream);
  return dv <= 64 ? launch<64, 8, F16>(qs, ks, v, lens, o, lse, bh, t, d1, dv, scale, left,
                                       right, stream)
                  : launch<64, 16, F16>(qs, ks, v, lens, o, lse, bh, t, d1, dv, scale, left,
                                        right, stream);
}

}  // namespace

// Bytes of shared memory the forward needs at (d1, dv): its 64-row layout,
// the smaller of the two, which any launch can take; past a block's shared
// memory the kernel refuses.
extern "C" int flash_attention_fwd_smem_bytes(int d1, int dv) {
  return (int)fwd_layout(64, d1, dv).total;
}

// The query-tile height a launch at (bh, t, d1, dv) takes: 128 or 64 rows,
// 0 where neither fits.
extern "C" int flash_attention_fwd_rows(int bh, int t, int d1, int dv) {
  return pick_rows(bh, t, d1, dv);
}

// qs, ks: [bh, t, d1] bf16; v: [bh, t, dv] bf16; lens: [bh] int32;
// o: [bh, t, dv] bf16; lse: [bh, t] fp32; all contiguous, 16-byte aligned;
// d1 and dv multiples of 8, dv <= 128; rows: the query-tile height, 64 or
// 128 (0 = the launch's own choice). Launches on `stream` and returns the
// cudaError_t of the launch.
extern "C" int flash_attention_fwd_rows_bf16(const void* qs, const void* ks, const void* v,
                                             const void* lens, void* o, void* lse, int bh,
                                             int t, int d1, int dv, float scale, int left,
                                             int right, int rows, void* stream) {
  return fwd_rows<false>(qs, ks, v, lens, o, lse, bh, t, d1, dv, scale, left, right, rows,
                         stream);
}

// As flash_attention_fwd_rows_bf16 with fp16 qs, ks, v and o.
extern "C" int flash_attention_fwd_rows_f16(const void* qs, const void* ks, const void* v,
                                            const void* lens, void* o, void* lse, int bh,
                                            int t, int d1, int dv, float scale, int left,
                                            int right, int rows, void* stream) {
  return fwd_rows<true>(qs, ks, v, lens, o, lse, bh, t, d1, dv, scale, left, right, rows,
                        stream);
}
