// CTC loss forward (alpha recursion) and backward (beta recursion fused
// with the gradient) for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels `_fwd_kernel` (via `_run_fwd`) and `_bwd_kernel`
// (via `_run_bwd`) of conformer_nemo_tpu/ops/pallas/ctc_kernel.py, together
// with the XLA glue around them (`_prep`'s one-hot emit gather, the nll from
// the terminal states in `_ctc_fwd`, `_ctc_bwd`'s one-hot scatter back to
// the V+1 classes). Over the extended label sequence ext = (blank, y1,
// blank, ..., yU, blank) of S = 2U+1 states, with emit(t, s) =
// log_probs[b, t, ext[s]] inside the lattice (s < 2 * target_length + 1)
// and -1e30 outside:
//
//   alpha_0  = (emit(0, 0), emit(0, 1) if U_b > 0, -1e30, ...)
//   alpha_t  = lse(alpha_{t-1}[s], alpha_{t-1}[s-1], alpha_{t-1}[s-2] if skip[s])
//              + emit(t, s)   while t < input_length, else alpha_{t-1}
//   ll       = logaddexp(alpha_{T-1}[S_b-1], alpha_{T-1}[S_b-2] if U_b > 0)
//   beta_t   = terminal indicator at t = len-1 and past the length, else
//              lse(beta_{t+1}[s] + e[s], beta_{t+1}[s+1] + e[s+1],
//                  beta_{t+1}[s+2] + e[s+2] if skip[s+2]), e = emit(t+1, .)
//   grad[b, t, v] = -g[b] * sum_{s in lattice, ext[s] = v}
//                   exp(clip(alpha_t[s] + beta_t[s] - ll, -60, 0)), 0 past the length
//
// skip[s]: ext[s] is a label and differs from ext[s-2]. -1e30 stands for
// -inf throughout (an infeasible alignment gives the same finite nll as the
// TPU kernels).
//
// Bound on an H100: a recursion of T dependent steps per sample, each a
// handful of flops per lattice state; the bytes are the gathered log-prob
// entries and the alphas [B, T, S] written (forward), the alphas and the
// entries read and the gradient [B, T, V+1] written (backward), at
// 3.35 TB/s. At B = 8 the card holds 8 blocks, so the T serial steps (one
// block barrier and a dependent global read each) set the time, not the
// bytes.
//
// Design: one block per sample; threads stride over the states; alpha (and
// beta) ping-pong in shared memory with one __syncthreads per time step.
// log_probs[b, t, ext[s]] is read directly (no one-hot product, no emits
// tensor). The backward sums the posteriors of a time step into a
// shared-memory row of V+1 floats with shared atomics (blank recurs U+1
// times and labels can repeat), then writes that row of the gradient.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ inline float lse2(float a, float b) {
  const float m = fmaxf(a, b);
  if (m <= NEG_INF * 0.5f) return NEG_INF;
  return m + logf(expf(a - m) + expf(b - m));
}

struct Lattice {
  int S, s_len, tl;
  int* ext;           // [S] class of each state
  unsigned char* fl;  // [S] bit 0: in the lattice; bit 1: skip allowed
};

// Fill ext and the flags of sample b; caller synchronises afterwards.
__device__ inline void build_lattice(Lattice& lat, const int* __restrict__ targets,
                                     const int* __restrict__ target_lengths, int b, int U,
                                     int blank) {
  lat.S = 2 * U + 1;
  lat.tl = min(max(target_lengths[b], 0), U);
  lat.s_len = 2 * lat.tl + 1;
  const int* tg = targets + (size_t)b * U;
  for (int s = threadIdx.x; s < lat.S; s += NTHREADS) {
    const int e = (s & 1) ? tg[s >> 1] : blank;
    const int e2 = s >= 2 ? ((s & 1) ? tg[(s >> 1) - 1] : blank) : -1;
    const bool in = s < lat.s_len;
    lat.ext[s] = e;
    lat.fl[s] = (in ? 1 : 0) | ((in && e != blank && e != e2) ? 2 : 0);
  }
}

__device__ inline float emit(const float* __restrict__ lp_t, const Lattice& lat, int s) {
  return (lat.fl[s] & 1) ? lp_t[lat.ext[s]] : NEG_INF;
}

__global__ void __launch_bounds__(NTHREADS)
ctc_alpha_kernel(const float* __restrict__ log_probs, const int* __restrict__ targets,
                 const int* __restrict__ input_lengths, const int* __restrict__ target_lengths,
                 float* __restrict__ alphas, float* __restrict__ nll, int T, int U, int V1,
                 int blank) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 2 * U + 1;
  float* buf[2] = {reinterpret_cast<float*>(smem), reinterpret_cast<float*>(smem) + S};
  Lattice lat;
  lat.ext = reinterpret_cast<int*>(smem + sizeof(float) * 2 * S);
  lat.fl = smem + sizeof(float) * 2 * S + sizeof(int) * S;
  const int b = blockIdx.x;
  build_lattice(lat, targets, target_lengths, b, U, blank);
  __syncthreads();

  const int len = input_lengths[b];
  const float* lp_b = log_probs + (size_t)b * T * V1;
  float* al_b = alphas + (size_t)b * T * S;
  for (int s = threadIdx.x; s < S; s += NTHREADS) {
    float a = NEG_INF;
    if (s == 0 || (s == 1 && lat.tl > 0)) a = emit(lp_b, lat, s);
    buf[0][s] = a;
    al_b[s] = a;
  }
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const float* prev = buf[(t - 1) & 1];
    float* cur = buf[t & 1];
    const bool active = t < len;  // samples freeze past their length
    const float* lp_t = lp_b + (size_t)t * V1;
    for (int s = threadIdx.x; s < S; s += NTHREADS) {
      float a = prev[s];
      if (active) {
        const float adv = s >= 1 ? prev[s - 1] : NEG_INF;
        const float skp = (s >= 2 && (lat.fl[s] & 2)) ? prev[s - 2] : NEG_INF;
        a = lse2(lse2(a, adv), skp) + emit(lp_t, lat, s);
      }
      cur[s] = a;
      al_b[(size_t)t * S + s] = a;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float* fin = buf[(T - 1) & 1];
    const float last = fin[lat.s_len - 1];
    const float last2 = lat.tl > 0 ? fin[lat.s_len - 2] : NEG_INF;
    const float m = fmaxf(last, last2);  // logaddexp
    nll[b] = -(m + log1pf(expf(-fabsf(last - last2))));
  }
}

__global__ void __launch_bounds__(NTHREADS)
ctc_beta_grad_kernel(const float* __restrict__ log_probs, const int* __restrict__ targets,
                     const int* __restrict__ input_lengths,
                     const int* __restrict__ target_lengths, const float* __restrict__ alphas,
                     const float* __restrict__ nll, const float* __restrict__ g,
                     float* __restrict__ grad, int T, int U, int V1, int blank) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 2 * U + 1;
  float* beta[2] = {reinterpret_cast<float*>(smem), reinterpret_cast<float*>(smem) + S};
  float* grow[2] = {beta[1] + S, beta[1] + S + V1};
  Lattice lat;
  lat.ext = reinterpret_cast<int*>(grow[1] + V1);
  lat.fl = reinterpret_cast<unsigned char*>(lat.ext + S);
  const int b = blockIdx.x;
  build_lattice(lat, targets, target_lengths, b, U, blank);
  for (int s = threadIdx.x; s < S; s += NTHREADS) beta[0][s] = beta[1][s] = NEG_INF;
  for (int v = threadIdx.x; v < V1; v += NTHREADS) grow[0][v] = grow[1][v] = 0.f;
  __syncthreads();

  const int len = input_lengths[b];
  const float ll = -nll[b];
  const float gb = g[b];
  const float* lp_b = log_probs + (size_t)b * T * V1;
  const float* al_b = alphas + (size_t)b * T * S;
  float* gr_b = grad + (size_t)b * T * V1;
  for (int t = T - 1; t >= 0; --t) {
    const float* next = beta[(t + 1) & 1];
    float* cur = beta[t & 1];
    float* G = grow[t & 1];
    const bool beyond = t >= len;  // no gradient; beta is the terminal indicator
    const bool terminal = beyond || t == len - 1;
    const float* lp_n = lp_b + (size_t)min(t + 1, T - 1) * V1;
    for (int s = threadIdx.x; s < S; s += NTHREADS) {
      float bt;
      if (terminal) {
        const bool term = s == lat.s_len - 1 || (s == lat.s_len - 2 && lat.tl > 0);
        bt = term ? 0.f : NEG_INF;
      } else {
        const float stay = next[s] + emit(lp_n, lat, s);
        const float adv = s + 1 < S ? next[s + 1] + emit(lp_n, lat, s + 1) : NEG_INF;
        const float skp = (s + 2 < S && (lat.fl[s + 2] & 2))
                              ? next[s + 2] + emit(lp_n, lat, s + 2) : NEG_INF;
        bt = lse2(lse2(stay, adv), skp);
      }
      cur[s] = bt;
      if (!beyond && (lat.fl[s] & 1)) {
        const float x = fminf(fmaxf(al_b[(size_t)t * S + s] + bt - ll, -60.f), 0.f);
        atomicAdd(&G[lat.ext[s]], -expf(x) * gb);
      }
    }
    __syncthreads();
    // the row is complete; write it and clear it for time step t - 2
    float* out = gr_b + (size_t)t * V1;
    for (int v = threadIdx.x; v < V1; v += NTHREADS) {
      out[v] = G[v];
      G[v] = 0.f;
    }
  }
}

size_t alpha_smem(int U) { return sizeof(float) * 2 * (2 * U + 1) + (sizeof(int) + 1) * (2 * U + 1); }

size_t beta_smem(int U, int V1) {
  return sizeof(float) * (2 * (2 * U + 1) + 2 * V1) + (sizeof(int) + 1) * (2 * U + 1);
}

}  // namespace

// Bytes of shared memory the forward (which = 0) or backward (which = 1)
// kernel needs at (U, V1).
extern "C" long long ctc_smem_bytes(int U, int V1, int which) {
  return (long long)(which ? beta_smem(U, V1) : alpha_smem(U));
}

// log_probs: [b, t, v1] fp32; targets: [b, u] int32 (u >= 0); input_lengths,
// target_lengths: [b] int32; alphas: [b, t, 2u+1] fp32; nll: [b] fp32. All
// contiguous; t >= 1. Launches on `stream`; returns the cudaError_t.
extern "C" int ctc_alpha_f32(const void* log_probs, const void* targets, const void* input_lengths,
                             const void* target_lengths, void* alphas, void* nll, int b, int t,
                             int u, int v1, int blank, void* stream) {
  const size_t smem = alpha_smem(u);
  cudaError_t err = cudaFuncSetAttribute(ctc_alpha_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ctc_alpha_kernel<<<b, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const float*)log_probs, (const int*)targets, (const int*)input_lengths,
      (const int*)target_lengths, (float*)alphas, (float*)nll, t, u, v1, blank);
  return (int)cudaGetLastError();
}

// As above, plus nll [b] from the forward and the upstream g [b] fp32;
// grad: [b, t, v1] fp32 (every entry written).
extern "C" int ctc_beta_grad_f32(const void* log_probs, const void* targets,
                                 const void* input_lengths, const void* target_lengths,
                                 const void* alphas, const void* nll, const void* g, void* grad,
                                 int b, int t, int u, int v1, int blank, void* stream) {
  const size_t smem = beta_smem(u, v1);
  cudaError_t err = cudaFuncSetAttribute(ctc_beta_grad_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ctc_beta_grad_kernel<<<b, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const float*)log_probs, (const int*)targets, (const int*)input_lengths,
      (const int*)target_lengths, (const float*)alphas, (const float*)nll, (const float*)g,
      (float*)grad, t, u, v1, blank);
  return (int)cudaGetLastError();
}
