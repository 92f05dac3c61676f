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
// VMEM (rnnt_loss.py `_skew`, capped at `_PALLAS_LATTICE_MAX_CELLS`). Both
// are TPU devices, a lane-axis layout trick and a VMEM limit; neither
// carries over. These kernels take the unskewed [B, T, U+1] layout as it is
// and have no size cap.
//
// Bound on an H100: a cell costs a handful of fp32 operations and the bytes
// are bl, lb read once and alpha (or beta) written once, ~12 bytes a cell,
// so the bytes bound is microseconds. What holds the kernel is the chain of
// T + U dependent anti-diagonals: each needs the one before it.
//
// Design (the wavefront of the reference's numba `gpu_rnnt_kernel.py`): one
// block per sample, threads over u (a thread loops when U+1 exceeds the
// block), one __syncthreads per anti-diagonal d = t + u, the previous
// diagonal held in shared memory indexed by u. The sweep stops at the
// sample's last valid diagonal (t_len - 1 + u_len); cells past it, and every
// invalid cell, are written as -1e30 without a recursion step. fp32 with
// full-precision expf/logf (no fast-math), so the kernel follows the plain
// version to ~1e-6.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_THREADS = 1024;

__device__ inline float lse(float a, float b) {
  const float m = fmaxf(a, b);
  if (m <= NEG_INF * 0.5f) return NEG_INF;
  return m + logf(expf(a - m) + expf(b - m));
}

__device__ inline bool valid(int t, int u, int t_len, int u_len) {
  return t < t_len && u <= u_len;
}

__global__ void rnnt_alpha_kernel(const float* __restrict__ blank_lp,
                                  const float* __restrict__ label_lp,
                                  const int* __restrict__ t_lens, const int* __restrict__ u_lens,
                                  float* __restrict__ alpha, int T, int U1) {
  extern __shared__ float diag[];  // [2][U1]: diagonals d-1 and d, indexed by u
  const int b = blockIdx.x;
  const int t_len = t_lens[b], u_len = u_lens[b];
  const size_t base = (size_t)b * T * U1;
  const float* bl = blank_lp + base;
  const float* lb = label_lp + base;
  float* al = alpha + base;
  const int d_last = min(t_len - 1, T - 1) + min(u_len, U1 - 1);  // last valid diagonal

  for (int d = 0; d <= d_last; ++d) {
    const float* prev = diag + ((d + 1) & 1) * U1;
    float* cur = diag + (d & 1) * U1;
    for (int u = threadIdx.x; u < U1; u += blockDim.x) {
      const int t = d - u;
      float a = NEG_INF;
      if (t >= 0 && t < T && valid(t, u, t_len, u_len)) {
        if (d == 0) {
          a = 0.f;
        } else {
          // parents (t-1, u) and (t, u-1) both lie on diagonal d-1; a valid
          // cell's parents are valid whenever they exist
          const float from_left = t >= 1 ? prev[u] + bl[(size_t)(t - 1) * U1 + u] : NEG_INF;
          const float from_below = u >= 1 ? prev[u - 1] + lb[(size_t)t * U1 + u - 1] : NEG_INF;
          a = lse(from_left, from_below);
        }
      }
      cur[u] = a;
      if (t >= 0 && t < T) al[(size_t)t * U1 + u] = a;
    }
    __syncthreads();
  }
  // the cells past the last valid diagonal
  for (int i = threadIdx.x; i < T * U1; i += blockDim.x) {
    const int t = i / U1, u = i % U1;
    if (t + u > d_last) al[i] = NEG_INF;
  }
}

__global__ void rnnt_beta_kernel(const float* __restrict__ blank_lp,
                                 const float* __restrict__ label_lp,
                                 const int* __restrict__ t_lens, const int* __restrict__ u_lens,
                                 float* __restrict__ beta, int T, int U1) {
  extern __shared__ float diag[];  // [2][U1]: diagonals d+1 and d, indexed by u
  const int b = blockIdx.x;
  const int t_len = t_lens[b], u_len = u_lens[b];
  const size_t base = (size_t)b * T * U1;
  const float* bl = blank_lp + base;
  const float* lb = label_lp + base;
  float* be = beta + base;
  const int d_last = min(t_len - 1, T - 1) + min(u_len, U1 - 1);
  const int t_term = t_len - 1, u_term = u_len;

  // every cell past the last valid diagonal is invalid: -1e30, and so is
  // the diagonal after it, which seeds the sweep
  for (int i = threadIdx.x; i < T * U1; i += blockDim.x) {
    const int t = i / U1, u = i % U1;
    if (t + u > d_last) be[i] = NEG_INF;
  }
  for (int u = threadIdx.x; u < U1; u += blockDim.x) diag[((d_last + 1) & 1) * U1 + u] = NEG_INF;
  __syncthreads();

  for (int d = d_last; d >= 0; --d) {
    const float* next = diag + ((d + 1) & 1) * U1;
    float* cur = diag + (d & 1) * U1;
    for (int u = threadIdx.x; u < U1; u += blockDim.x) {
      const int t = d - u;
      float v = NEG_INF;
      if (t >= 0 && t < T && valid(t, u, t_len, u_len)) {
        // children (t+1, u) and (t, u+1) lie on diagonal d+1
        const float blank_child = t + 1 < T ? next[u] : NEG_INF;
        const float label_child = u + 1 < U1 ? next[u + 1] : NEG_INF;
        v = lse(bl[(size_t)t * U1 + u] + blank_child, lb[(size_t)t * U1 + u] + label_child);
        if (t == t_term && u == u_term) v = fmaxf(v, bl[(size_t)t * U1 + u]);
      }
      cur[u] = v;
      if (t >= 0 && t < T) be[(size_t)t * U1 + u] = v;
    }
    __syncthreads();
  }
}

int threads_for(int U1) {
  const int n = (U1 + 31) / 32 * 32;
  return n < 32 ? 32 : (n > MAX_THREADS ? MAX_THREADS : n);
}

}  // namespace

// blank_lp, label_lp: [b, t, u1] fp32 (the raw log-probs: the kernels apply
// the lattice mask themselves); t_lens, u_lens: [b] int32; alpha: [b, t, u1]
// fp32, every entry written. All contiguous. Launches on `stream`; returns
// the cudaError_t of the launch.
extern "C" int rnnt_alpha_f32(const void* blank_lp, const void* label_lp, const void* t_lens,
                              const void* u_lens, void* alpha, int b, int t, int u1,
                              void* stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)u1;
  cudaError_t err = cudaFuncSetAttribute(rnnt_alpha_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rnnt_alpha_kernel<<<b, threads_for(u1), smem, (cudaStream_t)stream>>>(
      (const float*)blank_lp, (const float*)label_lp, (const int*)t_lens, (const int*)u_lens,
      (float*)alpha, t, u1);
  return (int)cudaGetLastError();
}

// As above; beta: [b, t, u1] fp32, beta[b, 0, 0] is the log-likelihood.
extern "C" int rnnt_beta_f32(const void* blank_lp, const void* label_lp, const void* t_lens,
                             const void* u_lens, void* beta, int b, int t, int u1, void* stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)u1;
  cudaError_t err = cudaFuncSetAttribute(rnnt_beta_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rnnt_beta_kernel<<<b, threads_for(u1), smem, (cudaStream_t)stream>>>(
      (const float*)blank_lp, (const float*)label_lp, (const int*)t_lens, (const int*)u_lens,
      (float*)beta, t, u1);
  return (int)cudaGetLastError();
}
