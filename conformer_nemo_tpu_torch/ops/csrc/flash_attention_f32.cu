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
// dq, dk, dv in fp32; lse in fp32).
//
// Why not the tensor cores: TF32 keeps 10 bits of mantissa and reads about
// 1e-3 off an fp32 reference, where a model that asks for fp32 is held to
// fp32's own rounding. So every product here is fp32 FMA on the CUDA cores.
// Bound on an H100: 2 * pairs * (d1 + dv) FLOPs forward and 2 * pairs *
// (3 * d1 + 2 * dv) backward at 67 TFLOP/s fp32 (against the bytes at 3.35
// TB/s: far under the ridge, so the arithmetic bounds them).
//
// Design (simple and right first):
//   * 256 threads a block as a 16 x 16 grid; thread (ty, tx) owns rows
//     4ty..4ty+3 and columns tx, tx+16, tx+32, tx+48 of a 64 x 64 score tile;
//   * S (and dP) accumulate in one fmaf chain per element over the depth in
//     order (`tile_dot`), from 32-deep chunks of both sides staged in shared
//     memory transposed; the three kernels run the same chain, so the
//     backward's S is the forward's bit for bit (as in the 16-bit kernels:
//     see p_of there);
//   * the forward: one block per (64-query tile, bh) over the key tiles in
//     band, the online softmax on the thread's S registers (row max and sum
//     by shuffles over the 16 lanes of a row), P through shared memory into
//     O += P V with O in registers (dv <= 128: 32 a thread);
//   * dQ: one block per (64-query tile, bh, pass of dQ columns) over the key
//     tiles; dK/dV: one block per (64-key tile, bh, pass of dK columns) over
//     the query tiles, dV in the first pass. A pass holds up to 256 columns
//     in registers (64 a thread), so there is no limit on d1; each pass
//     recomputes S and dP;
//   * no atomics: every output is the same bits on every call.
// Shared memory: 81 KB forward, 113 KB dQ, 145 KB dK/dV, whatever d1.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TT = 64;                 // rows of a tile (queries or keys)
constexpr int NTH = 256;               // threads a block: 16 x 16
constexpr int DC = 32;                 // depth of a staged chunk
constexpr int LDC = TT + 1;            // float row stride of a chunk and of a P / dS tile
constexpr int MAXW = 256;              // columns of a pass
constexpr int NJ = MAXW / 16;          // accumulator columns a thread row holds in a pass
constexpr int MAXDV = 128;
constexpr int NJV = MAXDV / 16;        // output columns a thread row holds of o and dv
constexpr float NEG_INF = -1e30f;

__device__ inline bool in_band(int i, int j, int left, int right) {
  return (left < 0 || i - j <= left) && (right < 0 || j - i <= right);
}

// acc[r][c] += sum_d A[a0 + 4ty + r][d] * B[b0 + tx + 16c][d] over d = 0 ..
// depth - 1 in order, one fmaf chain per element. A and B are row-major with
// `depth` columns; rows at or past alim / blim read as 0. As, Bs: [DC][LDC]
// chunks in shared memory. Every thread of the block calls it.
__device__ void tile_dot(float (&acc)[4][4], const float* __restrict__ A, int a0, int alim,
                         const float* __restrict__ B, int b0, int blim, int depth, float* As,
                         float* Bs) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int d0 = 0; d0 < depth; d0 += DC) {
    const int dn = min(DC, depth - d0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < TT * DC; i += NTH) {
      const int r = i / DC, d = i % DC;
      float a = 0.f, b = 0.f;
      if (d < dn) {
        if (a0 + r < alim) a = A[(size_t)(a0 + r) * depth + d0 + d];
        if (b0 + r < blim) b = B[(size_t)(b0 + r) * depth + d0 + d];
      }
      As[d * LDC + r] = a;
      Bs[d * LDC + r] = b;
    }
    __syncthreads();
    for (int d = 0; d < dn; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[d * LDC + 4 * ty + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Bs[d * LDC + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
}

// a reduction over the 16 lanes of a row (lanes 16h .. 16h + 15 of a warp)
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

// rows row0 .. row0 + 63 of a row-major [nrows x width] matrix, columns c0 ..
// c0 + w - 1, into a [64][ld] shared tile; zeros past nrows and width
__device__ inline void load_tile(float* dst, int ld, const float* __restrict__ src, int width,
                                 int row0, int nrows, int c0, int w) {
  for (int i = threadIdx.x; i < TT * w; i += NTH) {
    const int r = i / w, c = i % w;
    dst[r * ld + c] = row0 + r < nrows && c0 + c < width
                          ? src[(size_t)(row0 + r) * width + c0 + c] : 0.f;
  }
}

// the tiles [lo, hi) of 64 along the other side that tile `i0` meets under a
// band (before, after) and the length klim (the TPU kernel's
// _band_tile_bounds, then capped)
__device__ inline void band_tiles(int i0, int T, int klim, int before, int after, int* lo,
                                  int* hi) {
  const int n_tiles = (T + TT - 1) / TT;
  *lo = before >= 0 ? max(i0 - before, 0) / TT : 0;
  *hi = after >= 0 ? min((i0 + TT - 1 + after) / TT + 1, n_tiles) : n_tiles;
  *hi = min(*hi, (klim + TT - 1) / TT);
}

struct Smem {  // float offsets into the dynamic shared memory
  static constexpr int a = 0, b = DC * LDC, p = 2 * DC * LDC, d = p + TT * LDC, x = d + TT * LDC;
};

__global__ void __launch_bounds__(NTH, 1)
fwd_kernel(const float* __restrict__ qs, const float* __restrict__ ks,
           const float* __restrict__ v, const int* __restrict__ lens, float* __restrict__ o,
           float* __restrict__ lse, int T, int d1, int dv, float scale, int left, int right) {
  extern __shared__ float sm[];
  float *As = sm + Smem::a, *Bs = sm + Smem::b, *Ps = sm + Smem::p, *Vs = sm + Smem::x;
  const int bh = blockIdx.y, q0 = blockIdx.x * TT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int klim = min(max(lens[bh], 0), T);
  const float* q_bh = qs + (size_t)bh * T * d1;
  const float* k_bh = ks + (size_t)bh * T * d1;
  const float* v_bh = v + (size_t)bh * T * dv;
  int lo, hi;
  band_tiles(q0, T, klim, left, right, &lo, &hi);

  float m_run[4], l_run[4], oacc[4][NJV];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NJV; ++j) oacc[r][j] = 0.f;
  }
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * TT;
    float s[4][4] = {};
    tile_dot(s, q_bh, q0, T, k_bh, k0, T, d1, As, Bs);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + 4 * ty + r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
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
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_safe);  // a masked score is -1e30: exactly 0
        sum += s[r][c];
      }
      l_run[r] = l_run[r] * alpha + sum;  // this thread's share of the row
#pragma unroll
      for (int j = 0; j < NJV; ++j) oacc[r][j] *= alpha;
    }
    __syncthreads();  // every thread is done with the previous tile's P and V
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) Ps[(4 * ty + r) * LDC + tx + 16 * c] = s[r][c];
    load_tile(Vs, MAXDV, v_bh, dv, k0, T, 0, dv);
    __syncthreads();
    for (int k = 0; k < TT; ++k) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = Ps[(4 * ty + r) * LDC + k];
#pragma unroll
      for (int j = 0; j < NJV; ++j) {
        if (tx + 16 * j < dv) {
          const float vv = Vs[k * MAXDV + tx + 16 * j];
#pragma unroll
          for (int r = 0; r < 4; ++r) oacc[r][j] = fmaf(p[r], vv, oacc[r][j]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + 4 * ty + r;
    const float lsum = row_sum(l_run[r]);
    const float l_safe = lsum == 0.f ? 1.f : lsum;
    if (qi >= T) continue;
#pragma unroll
    for (int j = 0; j < NJV; ++j)
      if (tx + 16 * j < dv) o[((size_t)bh * T + qi) * dv + tx + 16 * j] = oacc[r][j] / l_safe;
    if (tx == 0)
      lse[(size_t)bh * T + qi] = (m_run[r] <= NEG_INF * 0.5f ? 0.f : m_run[r]) + logf(l_safe);
  }
}

// P of a visible pair from its S accumulator, as the 16-bit kernels form it
__device__ inline float p_of(float sv, float scale, float lse) {
  return expf(fminf(__fmul_rn(sv, scale) - lse, 0.f));
}

// one block per (64-query tile, bh, pass of `pw` dQ columns from pw * z)
__global__ void __launch_bounds__(NTH, 1)
dq_kernel(const float* __restrict__ qs, const float* __restrict__ ks,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const int* __restrict__ lens, float* __restrict__ dq, int T, int d1, int dv,
          float scale, int left, int right, int pw) {
  extern __shared__ float sm[];
  float *As = sm + Smem::a, *Bs = sm + Smem::b, *Ds = sm + Smem::d, *Kp = sm + Smem::x;
  const int bh = blockIdx.y, q0 = blockIdx.x * TT, c0 = blockIdx.z * pw;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int klim = min(max(lens[bh], 0), T);
  const float* k_bh = ks + (size_t)bh * T * d1;
  const float* v_bh = v + (size_t)bh * T * dv;
  int lo, hi;
  band_tiles(q0, T, klim, left, right, &lo, &hi);
  if (q0 >= klim) hi = lo;  // every query row of the tile is past the length
  float lse_r[4], delta_r[4], acc[4][NJ];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + 4 * ty + r;
    lse_r[r] = qi < T ? lse[(size_t)bh * T + qi] : 0.f;
    delta_r[r] = qi < T ? delta[(size_t)bh * T + qi] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
  }
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * TT;
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot(s, qs + (size_t)bh * T * d1, q0, T, k_bh, k0, T, d1, As, Bs);
    tile_dot(dp, dout + (size_t)bh * T * dv, q0, T, v_bh, k0, T, dv, As, Bs);
    __syncthreads();  // every thread is done with the previous tile's dS and Ks columns
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + 4 * ty + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        const bool ok = qi < klim && kj < klim && in_band(qi, kj, left, right);
        const float p = ok ? p_of(s[r][c], scale, lse_r[r]) : 0.f;
        Ds[(4 * ty + r) * LDC + tx + 16 * c] = ok ? p * (dp[r][c] - delta_r[r]) * scale : 0.f;
      }
    }
    load_tile(Kp, MAXW, k_bh, d1, k0, T, c0, pw);
    __syncthreads();
    for (int k = 0; k < TT; ++k) {
      float ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ds[r] = Ds[(4 * ty + r) * LDC + k];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (tx + 16 * j < pw) {
          const float kv = Kp[k * MAXW + tx + 16 * j];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(ds[r], kv, acc[r][j]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + 4 * ty + r;
    if (qi >= T) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = c0 + tx + 16 * j;
      if (tx + 16 * j < pw && c < d1) dq[((size_t)bh * T + qi) * d1 + c] = acc[r][j];
    }
  }
}

// one block per (64-key tile, bh, pass of `pw` dK columns from pw * z); dV
// in pass 0
__global__ void __launch_bounds__(NTH, 1)
dkv_kernel(const float* __restrict__ qs, const float* __restrict__ ks,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int* __restrict__ lens, float* __restrict__ dk, float* __restrict__ dvo, int T,
           int d1, int dv, float scale, int left, int right, int pw) {
  extern __shared__ float sm[];
  float *As = sm + Smem::a, *Bs = sm + Smem::b, *Ps = sm + Smem::p, *Ds = sm + Smem::d;
  float *Qp = sm + Smem::x, *dOs = Qp + TT * MAXW;
  const int bh = blockIdx.y, k0 = blockIdx.x * TT, c0 = blockIdx.z * pw;
  const bool with_dv = blockIdx.z == 0;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int klim = min(max(lens[bh], 0), T);
  const float* q_bh = qs + (size_t)bh * T * d1;
  const float* do_bh = dout + (size_t)bh * T * dv;
  // the window inverts: a key tile meets queries up to `right` before it and
  // `left` after it
  int lo, hi;
  band_tiles(k0, T, klim, right, left, &lo, &hi);
  if (k0 >= klim) hi = lo;
  float acc[4][NJ], dva[4][NJV];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
#pragma unroll
    for (int j = 0; j < NJV; ++j) dva[r][j] = 0.f;
  }
  for (int qt = lo; qt < hi; ++qt) {
    const int q0 = qt * TT;
    // S^T = K Qs^T and dP^T = V dO^T: the forward's chains, operands swapped
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot(s, ks + (size_t)bh * T * d1, k0, T, q_bh, q0, T, d1, As, Bs);
    tile_dot(dp, v + (size_t)bh * T * dv, k0, T, do_bh, q0, T, dv, As, Bs);
    __syncthreads();  // every thread is done with the previous tile's P, dS, Qs and dO
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qi = q0 + tx + 16 * c;
      const float lse_q = qi < T ? lse[(size_t)bh * T + qi] : 0.f;
      const float delta_q = qi < T ? delta[(size_t)bh * T + qi] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kj = k0 + 4 * ty + r;
        const bool ok = kj < klim && qi < klim && in_band(qi, kj, left, right);
        const float p = ok ? p_of(s[r][c], scale, lse_q) : 0.f;
        Ps[(4 * ty + r) * LDC + tx + 16 * c] = p;
        Ds[(4 * ty + r) * LDC + tx + 16 * c] = ok ? p * (dp[r][c] - delta_q) * scale : 0.f;
      }
    }
    load_tile(Qp, MAXW, q_bh, d1, q0, T, c0, pw);
    if (with_dv) load_tile(dOs, MAXDV, do_bh, dv, q0, T, 0, dv);
    __syncthreads();
    for (int q = 0; q < TT; ++q) {
      float ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ds[r] = Ds[(4 * ty + r) * LDC + q];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (tx + 16 * j < pw) {
          const float qv = Qp[q * MAXW + tx + 16 * j];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(ds[r], qv, acc[r][j]);
        }
      }
      if (with_dv) {
        float p[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) p[r] = Ps[(4 * ty + r) * LDC + q];
#pragma unroll
        for (int j = 0; j < NJV; ++j) {
          if (tx + 16 * j < dv) {
            const float ov = dOs[q * MAXDV + tx + 16 * j];
#pragma unroll
            for (int r = 0; r < 4; ++r) dva[r][j] = fmaf(p[r], ov, dva[r][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k0 + 4 * ty + r;
    if (kj >= T) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = c0 + tx + 16 * j;
      if (tx + 16 * j < pw && c < d1) dk[((size_t)bh * T + kj) * d1 + c] = acc[r][j];
    }
    if (with_dv)
#pragma unroll
      for (int j = 0; j < NJV; ++j)
        if (tx + 16 * j < dv) dvo[((size_t)bh * T + kj) * dv + tx + 16 * j] = dva[r][j];
  }
}

constexpr size_t FWD_SMEM = sizeof(float) * (Smem::x + TT * MAXDV);
constexpr size_t DQ_SMEM = sizeof(float) * (Smem::x + TT * MAXW);
constexpr size_t DKV_SMEM = sizeof(float) * (Smem::x + TT * MAXW + TT * MAXDV);

// the columns of a pass: the fewest passes of at most MAXW columns, evened
// out and rounded up to 16
int pass_width(int d1, int* n_passes) {
  *n_passes = (d1 + MAXW - 1) / MAXW;
  return ((d1 + *n_passes - 1) / *n_passes + 15) / 16 * 16;
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

// qs, ks: [bh, t, d1] fp32; v: [bh, t, dv] fp32; lens: [bh] int32; o: [bh,
// t, dv] fp32; lse: [bh, t] fp32; all contiguous; dv <= 128. Launches on
// `stream` and returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd_f32(const void* qs, const void* ks, const void* v,
                                       const void* lens, void* o, void* lse, int bh, int t,
                                       int d1, int dv, float scale, int left, int right,
                                       void* stream) {
  if (dv > MAXDV || dv <= 0 || d1 <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  int err = prepare(fwd_kernel, FWD_SMEM);
  if (err != 0) return err;
  fwd_kernel<<<dim3((t + TT - 1) / TT, bh), NTH, FWD_SMEM, (cudaStream_t)stream>>>(
      (const float*)qs, (const float*)ks, (const float*)v, (const int*)lens, (float*)o,
      (float*)lse, t, d1, dv, scale, left, right);
  return (int)cudaGetLastError();
}

// As flash_attention_bwd_dq_bf16 (flash_attention_bwd.cu) in fp32: qs, ks,
// v, dout and dq fp32.
extern "C" int flash_attention_bwd_dq_f32(const void* qs, const void* ks, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          const void* lens, void* dq, int bh, int t, int d1,
                                          int dv, float scale, int left, int right,
                                          void* stream) {
  if (dv > MAXDV || dv <= 0 || d1 <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  int n_passes;
  const int pw = pass_width(d1, &n_passes);
  int err = prepare(dq_kernel, DQ_SMEM);
  if (err != 0) return err;
  dq_kernel<<<dim3((t + TT - 1) / TT, bh, n_passes), NTH, DQ_SMEM, (cudaStream_t)stream>>>(
      (const float*)qs, (const float*)ks, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (const int*)lens, (float*)dq, t, d1, dv, scale,
      left, right, pw);
  return (int)cudaGetLastError();
}

// As flash_attention_bwd_dkv_bf16 in fp32: dk and dvo fp32.
extern "C" int flash_attention_bwd_dkv_f32(const void* qs, const void* ks, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           const void* lens, void* dk, void* dvo, int bh, int t,
                                           int d1, int dv, float scale, int left, int right,
                                           void* stream) {
  if (dv > MAXDV || dv <= 0 || d1 <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  int n_passes;
  const int pw = pass_width(d1, &n_passes);
  int err = prepare(dkv_kernel, DKV_SMEM);
  if (err != 0) return err;
  dkv_kernel<<<dim3((t + TT - 1) / TT, bh, n_passes), NTH, DKV_SMEM, (cudaStream_t)stream>>>(
      (const float*)qs, (const float*)ks, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (const int*)lens, (float*)dk, (float*)dvo, t, d1,
      dv, scale, left, right, pw);
  return (int)cudaGetLastError();
}
