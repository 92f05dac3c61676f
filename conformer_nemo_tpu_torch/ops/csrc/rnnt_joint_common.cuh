// What the flash joint's (K4) kernels share across compute dtypes:
// rnnt_joint.cu (bf16 and fp16, the tensor cores) and rnnt_joint_f32.cu
// (fp32, FMA on the CUDA cores). The joint's parameters, the dtype's
// rounding, the activation and its derivative, the dropout hash, the
// lattice's cell numbering, and the two backward kernels that only sum:
// de, dp and db from a window's scratch (the sums kernel beside its dW
// product, which each source writes for its own units) and the reduce.
//
// Widths: the wrappers pad H with zero columns to a multiple of 16 (Hp, the
// kernels' row stride) and pass the caller's H (Hh) apart. The dropout hash
// indexes the [B, Tp, U+1, Hh] layout, and the hidden units past Hh are 0 in
// h and in act' whatever the activation (sigmoid(0) is 0.5), so that they
// reach no logit, no dW row the caller keeps and no dx.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace rj {

typedef __nv_bfloat16 bf16;

// The compute dtype: bf16 and fp16 are stored as 16-bit words (bf16 the
// container type; fp16 bits travel in it), fp32 as float.
enum Kind { BF16 = 0, F16 = 1, F32 = 2 };
template <int K>
struct Store {
  typedef bf16 type;
};
template <>
struct Store<F32> {
  typedef float type;
};
template <int K>
using elem_t = typename Store<K>::type;

template <int K>
__device__ inline float cvt(elem_t<K> x) {
  if constexpr (K == F32)
    return x;
  else if constexpr (K == F16)
    return __half2float(__ushort_as_half(__bfloat16_as_ushort(x)));
  else
    return __bfloat162float(x);
}
template <int K>
__device__ inline elem_t<K> to_elem(float x) {
  if constexpr (K == F32)
    return x;
  else if constexpr (K == F16)
    return __ushort_as_bfloat16(__half_as_ushort(__float2half_rn(x)));
  else
    return __float2bfloat16(x);
}
// x rounded to the compute dtype (the identity in fp32)
template <int K>
__device__ inline float rnd(float x) {
  return cvt<K>(to_elem<K>(x));
}
// two consecutive elements
template <int K>
__device__ inline float2 cvt2(const elem_t<K>* p) {
  if constexpr (K == F32)
    return *reinterpret_cast<const float2*>(p);
  else if constexpr (K == F16)
    return __half22float2(*reinterpret_cast<const __half2*>(p));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

constexpr float NEG_INF = -1e30f;

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__device__ inline uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// The joint's static parameters.
template <int K>
struct Joint {
  const elem_t<K>* e;     // [B, T, H]
  const elem_t<K>* p;     // [B, U1, H]
  const elem_t<K>* bias;  // [V]
  const int* targets;     // [B, U1 - 1]
  // H: the row stride (a multiple of 16); Hh: the caller's width, which the
  // dropout hash indexes (units Hh..H-1 are zero padding)
  int B, T, U1, H, Hh, V, VL, Tp, act, drop_t;
  uint32_t seed, hash_base;
  float inv_keep;
  // the lattice: t_lens, u_lens [B] and each sample's first cell in the
  // global order, off [B + 1] (off[B]: the lattice's cells)
  const int* t_lens;
  const int* u_lens;
  const long long* off;
};

template <int K>
Joint<K> make_joint(const void* e, const void* p, const void* bias, const void* targets,
                    const void* t_lens, const void* u_lens, const void* off, int B, int T, int U1,
                    int H, int Hh, int V, int Tp, int act, int drop_t, int seed, int hash_base) {
  Joint<K> J;
  J.e = (const elem_t<K>*)e;
  J.p = (const elem_t<K>*)p;
  J.bias = (const elem_t<K>*)bias;
  J.targets = (const int*)targets;
  J.B = B; J.T = T; J.U1 = U1; J.H = H; J.Hh = Hh; J.V = V; J.VL = V - 1; J.Tp = Tp;
  J.act = act;
  J.drop_t = drop_t;
  J.seed = (uint32_t)seed;
  J.hash_base = (uint32_t)hash_base;
  J.inv_keep = drop_t > 0 ? (float)(1.0 / (1.0 - drop_t / 256.0)) : 1.f;
  J.t_lens = (const int*)t_lens;
  J.u_lens = (const int*)u_lens;
  J.off = (const long long*)off;
  return J;
}

// Host-side checks every entry point makes: the padded width a multiple of
// 16 that holds the caller's, V >= 2.
inline bool widths_ok(int H, int Hh, int V) { return H % 16 == 0 && Hh > 0 && Hh <= H && H - Hh < 16 && V >= 2; }

template <int K>
__device__ inline float act_fn(float x, int act) {
  if (act == 0) return x > 0.f ? x : 0.f;
  if (act == 1) return rnd<K>(1.f / (1.f + expf(-x)));
  return rnd<K>(tanhf(x));
}

// act'(x) from the pre-activation x and the un-dropped activation a, in the
// compute dtype's arithmetic (`_act_grad`)
template <int K>
__device__ inline float act_grad(float x, float a, int act) {
  if (act == 0) return x > 0.f ? 1.f : 0.f;
  if (act == 1) return rnd<K>(a * rnd<K>(1.f - a));
  return rnd<K>(1.f - rnd<K>(a * a));
}

// The dropout index of cell (b, t, u)'s first hidden unit in the
// [B, Tp, U1, Hh] layout (uint32, wrapping), with the hash base added.
template <int K>
__device__ inline uint32_t hash_row(const Joint<K>& J, int b, int t, int u) {
  return J.hash_base +
         ((uint32_t)b * (uint32_t)J.Tp + (uint32_t)t) * ((uint32_t)J.U1 * (uint32_t)J.Hh) +
         (uint32_t)u * (uint32_t)J.Hh;
}

// Hidden unit k of a cell from its pre-activation x (rounded to the dtype)
// and its hash row: h = drop(act(x)) and g = act'(x), 0 where dropped and
// past the caller's width.
template <int K>
__device__ inline void hidden_unit(const Joint<K>& J, float x, uint32_t row, int k, float& h,
                                   float& g) {
  const float a = act_fn<K>(x, J.act);
  h = a;
  g = act_grad<K>(x, a, J.act);
  if (k >= J.Hh) {
    h = g = 0.f;
  } else if (J.drop_t > 0) {
    const bool keep = (int)(fmix32((row + (uint32_t)k) ^ J.seed) >> 24) >= J.drop_t;
    h = keep ? rnd<K>(a * J.inv_keep) : 0.f;
    g = keep ? g : 0.f;
  }
}

template <int K>
__device__ inline int target_of(const Joint<K>& J, int b, int u) {
  return u < J.U1 - 1 ? J.targets[(size_t)b * (J.U1 - 1) + u] : 0;  // dummy column: 0
}

__device__ inline float clamp_g(float x, float clamp, float g) {
  if (clamp > 0.f) x = fminf(fmaxf(x, -clamp), clamp);
  return x * g;
}

// Sample b's lattice: n_t frames, n_u labels + 1. Its cells are numbered
// from J.off[b] (sample-major, then t-major: cell j -> t = j / n_u, u = j % n_u).
struct Lat {
  int n_t, n_u;
};
template <int K>
__device__ inline Lat lat_of(const Joint<K>& J, int b) {
  Lat L;
  L.n_t = max(0, min(J.t_lens[b], J.T));
  L.n_u = max(0, min(J.u_lens[b], J.U1 - 1) + 1);
  return L;
}

// (b, t, u) of global cell c < J.off[J.B]: a binary search over the offsets.
template <int K>
__device__ inline void cell_btu(const Joint<K>& J, long long c, int& b, int& t, int& u) {
  int lo = 0, hi = J.B - 1;  // the last sample whose first cell is <= c
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (J.off[mid] <= c) lo = mid;
    else hi = mid - 1;
  }
  b = lo;
  const int n_u = lat_of(J, b).n_u;
  const int j = (int)(c - J.off[b]);
  t = j / n_u;
  u = j % n_u;
}

// ---------------------------------------------------------------------------
// backward (sums): the parts that only add. One block per (b, t) for de,
// per (b, u) for dp, and one for db; the dW product's blocks come first and
// are each source's own.
// ---------------------------------------------------------------------------

constexpr int BROWS = 64;   // lattice cells per backward tile (the db partials' tiles)
constexpr int KSPLIT = 24;  // fixed number of K splits of the dW product
constexpr int SUM_THREADS = 256;

// sum over k < n, in order, of the element pairs src[k * stride] -> out (+=),
// the loads issued four at a time ahead of the adds
template <int K>
__device__ inline void sum_pairs(const elem_t<K>* src, size_t stride, int n, float* out) {
  float sx = 0.f, sy = 0.f;
  int k = 0;
  for (; k + 4 <= n; k += 4) {
    float2 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = cvt2<K>(src + (size_t)(k + i) * stride);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sx += v[i].x;
      sy += v[i].y;
    }
  }
  for (; k < n; ++k) {
    const float2 v = cvt2<K>(src + (size_t)k * stride);
    sx += v.x;
    sy += v.y;
  }
  out[0] += sx;
  out[1] += sy;
}

// Block `bid` (counted past the dW blocks) of the sums kernel over the
// window [c0, c0 + win): de[b, t] += sum over u of dx (u in order), dp[b, u]
// += sum over t (t in order), or db += the window's per-tile partials (tiles
// in order; db[VL]: dblank).
template <int K>
__device__ void sums_rows(const Joint<K>& J, int bid, long long c0, int n_w,
                          const elem_t<K>* __restrict__ dx, const float* __restrict__ dbl_part,
                          float* __restrict__ de_acc, float* __restrict__ dp,
                          float* __restrict__ db_acc) {
  const int H = J.H;
  if (bid < J.B * J.T) {
    const int b = bid / J.T, t = bid % J.T;
    const Lat L = lat_of(J, b);
    if (t >= L.n_t) return;
    const long long row = J.off[b] + (long long)t * L.n_u;
    const long long lo = max(row, c0), hi = min(row + L.n_u, c0 + n_w);
    if (lo >= hi) return;
    for (int h = 2 * threadIdx.x; h < H; h += 2 * SUM_THREADS)
      sum_pairs<K>(dx + (size_t)(lo - c0) * H + h, H, (int)(hi - lo),
                   de_acc + ((size_t)b * J.T + t) * H + h);
    return;
  }
  bid -= J.B * J.T;
  if (bid < J.B * J.U1) {
    const int b = bid / J.U1, u = bid % J.U1;
    const Lat L = lat_of(J, b);
    if (u >= L.n_u) return;
    const long long base = J.off[b] + u;  // cell (b, 0, u)
    const long long a = c0 - base, z = c0 + n_w - 1 - base;
    const int t_lo = a <= 0 ? 0 : (int)((a + L.n_u - 1) / L.n_u);
    const int t_hi = z < 0 ? 0 : (int)min((long long)L.n_t, z / L.n_u + 1);
    if (t_lo >= t_hi) return;
    for (int h = 2 * threadIdx.x; h < H; h += 2 * SUM_THREADS)
      sum_pairs<K>(dx + (size_t)(base + (long long)t_lo * L.n_u - c0) * H + h,
                   (size_t)L.n_u * H, t_hi - t_lo, dp + ((size_t)b * J.U1 + u) * H + h);
    return;
  }
  const int n_tiles = (n_w + BROWS - 1) / BROWS;
  for (int c = threadIdx.x; c <= J.VL; c += SUM_THREADS) {
    float s = 0.f;
    for (int k = 0; k < n_tiles; ++k) s += dbl_part[(size_t)k * (J.VL + 1) + c];
    db_acc[c] += s;
  }
}

// ---------------------------------------------------------------------------
// backward (reduce): dW [H, V] from the K splits, db [V], de in e's dtype
// ---------------------------------------------------------------------------

template <int K>
__global__ void joint_bwd_reduce_kernel(int B, int T, int H, int V, int VLp,
                                        const float* __restrict__ dw_part,
                                        const float* __restrict__ dwb_part,
                                        const float* __restrict__ db_acc,
                                        const float* __restrict__ de_acc,
                                        float* __restrict__ dw, float* __restrict__ db,
                                        elem_t<K>* __restrict__ de) {
  const int VL = V - 1;
  const long long n_dw = (long long)H * V, n_de = (long long)B * T * H;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_dw) {
    const int h = (int)(i / V), c = (int)(i % V);
    float s = 0.f;
    if (c < VL) {
      for (int k = 0; k < KSPLIT; ++k) s += dw_part[((size_t)k * H + h) * VLp + c];
    } else {
      for (int k = 0; k < KSPLIT; ++k) s += dwb_part[(size_t)k * H + h];
    }
    dw[i] = s;
  } else if (i < n_dw + V) {
    db[i - n_dw] = db_acc[i - n_dw];
  } else if (i < n_dw + V + n_de) {
    const long long j = i - n_dw - V;
    de[j] = to_elem<K>(de_acc[j]);
  }
}

template <int K>
int launch_reduce(const void* dw_part, const void* dwb_part, const void* db_acc,
                  const void* de_acc, void* dw, void* db, void* de, int b, int t, int h, int v,
                  int vlp, cudaStream_t stream) {
  const long long n = (long long)h * v + v + (long long)b * t * h;
  const int threads = 256;
  joint_bwd_reduce_kernel<K><<<(unsigned)((n + threads - 1) / threads), threads, 0, stream>>>(
      b, t, h, v, vlp, (const float*)dw_part, (const float*)dwb_part, (const float*)db_acc,
      (const float*)de_acc, (float*)dw, (float*)db, (elem_t<K>*)de);
  return (int)cudaGetLastError();
}

}  // namespace rj
