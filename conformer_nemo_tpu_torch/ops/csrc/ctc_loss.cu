// CTC loss forward (alpha recursion) and backward (beta recursion, then a
// parallel gradient) for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels `_fwd_kernel` (ctc_kernel.py:56, via `_run_fwd`
// :128 -> pallas_call :131) and `_bwd_kernel` (:80, via `_run_bwd` :147 ->
// pallas_call :150, and `_ctc_bwd` :233) of
// conformer_nemo_tpu/ops/pallas/ctc_kernel.py, together with the XLA glue
// around them (`_prep`'s one-hot emit gather, the nll from the terminal
// states in `_ctc_fwd`, `_ctc_bwd`'s one-hot scatter back to the V+1
// classes). Over the extended label sequence ext = (blank, y1, blank, ...,
// yU, blank) of S = 2U+1 states, with emit(t, s) = log_probs[b, t, ext[s]]
// inside the lattice (s < 2 * target_length + 1) and -1e30 outside:
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
// Bound on an H100: the bytes, at 3.35 TB/s: the gathered log-prob entries
// and the alphas [B, T, S] written (forward); the entries, alphas and betas
// read and the gradient [B, T, V+1] written (backward). What holds the
// recursions is their T dependent steps per sample (one block barrier each)
// on only B blocks: a step's time is its chain's latency plus the
// instructions that the block's warps issue for it on one SM.
//
// Design. Both recursions are one block per sample with one thread per
// state up to 1024 threads (past that the forward gives each label state a
// thread and each two blank states one while that fits, then 2, 4 or 8
// states a thread; the backward up to 8), blank's and the labels' states in
// separate warps, each state's class, flags and next emits in registers
// (the emits loaded ahead, so the log-prob gather is off the chain), and the
// previous step's row in shared memory behind one barrier per step.
//   * forward (alpha): each state's step is the plain version's nested
//     log-sum-exp, lse(lse(stay, advance), skip), one exponential and one
//     log a level, the outer level only where the state may skip; so it
//     rounds where the plain version (and the JAX package's `_lse`,
//     ctc_kernel.py:41, used at :70) rounds. A flat three-term form, which
//     torch's CTC kernel uses, drifts from it by a random walk of ulps of
//     |alpha| and fails the gradient's limit at T 1843 (the kernel's note).
//     -1e30 arithmetic keeps an infeasible row's >= 1e29 sentinel. Rows are
//     written to alphas in coalesced stores from shared memory, one step
//     behind, and rows past the input length after the recursion. nll
//     comes from the two terminal states.
//   * backward: summing each step's posteriors into a row of V+1 classes on
//     the serial path would put U+1 atomic adds on blank's one address every
//     step, and make the last bits depend on their order. So it is two
//     kernels, as the CUDA CTC backward that torch.nn.CTCLoss calls is: the
//     beta recursion alone (no atomics, no gradient work), writing betas
//     [B, T, S]; then a collect over all B * T rows in parallel, which sums
//     each class's posteriors in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float NEG_INF = -1e30f;

// log(e^a + e^b) with -1e30 as -inf, without the exp and log when one side
// is -1e30: then exp(min - m) is 0 and log(1 + 0) = 0, so the result is m
__device__ inline float lse2_skip(float a, float b) {
  const float m = fmaxf(a, b);
  if (m <= NEG_INF * 0.5f) return NEG_INF;
  if (fminf(a, b) <= NEG_INF * 0.5f) return m;
  return m + logf(expf(a - m) + expf(b - m));
}

// lse2_skip in one exponential: the larger side's exp(0) is 1 exactly, so
// m + log(1 + exp(min - m)) is m + log(exp(a - m) + exp(b - m)) bit for bit
__device__ inline float lse2_one_exp(float a, float b) {
  const float m = fmaxf(a, b), lo = fminf(a, b);
  if (m <= NEG_INF * 0.5f) return NEG_INF;
  if (lo <= NEG_INF * 0.5f) return m;
  return m + logf(1.f + expf(lo - m));
}

// The state of thread slot i in both recursions: the U + 1 blank (even)
// states first, then the labels, so a warp's lanes share a parity and
// blank's lanes, which never skip, take the two-term way together.
__device__ inline int state_of(int i, int U) { return i <= U ? 2 * i : 2 * (i - U - 1) + 1; }

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
  for (int s = threadIdx.x; s < lat.S; s += blockDim.x) {
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

// The alpha recursion (K1-fwd). One block per sample; alpha ping-pongs in
// shared memory behind two -1e30 pads, one barrier per step. Each thread
// keeps its states' class, skip flag and emits of the next D steps in
// registers (a ring of D registers a state, the time loop unrolled by D, so
// each emit is loaded D steps before its use and no global load sits on the
// chain). A step's chain per state is three shared loads, the log-sum-exp,
// the emit add and one shared store. The log-sum-exp is the plain version's
// nested lse(lse(stay, advance), skip) (the JAX package's `_lse` nesting,
// ctc_kernel.py:41, used at :70), each level with one exponential
// (`lse2_one_exp`), and a state that cannot skip drops the outer level,
// whose -1e30 side leaves its value unchanged: so the kernel gives the
// plain version's bits. A step is held by its longest chain of log-sum-exps
// in one thread, stretched by the other warps' issue on the SM, so the
// states are dealt out to keep that chain at two: one state a thread up to
// 1024 states; past that (PAIR) a thread for each label state and one for
// each two blank states (2b and 2(b + nb), neighbouring lanes two states
// apart), while that fits a block, with four more warps (from `copy0`)
// that only copy each finished row out; then K = 2, 4 or 8 states a thread
// (`state_of`, blank and label states in separate warps), every thread
// taking a share of the copy.
// What else was timed on an H100, in one process, at the main shape: a flat
// three-term form (one max, three exponentials, one log, as torch's CTC
// kernel forms it) rounds once where the nested form rounds twice at the
// alphas' magnitude (|alpha| ~ 1e4 at T 1843, an ulp of 1e-3); over the T
// steps the two drift apart as a random walk, which moved the gradient by
// 0.018 in chip_smoke.py at B 8, T 1843, U 592, past its 1e-2 limit. D = 4
// beat 2 and 8. Slower were a cluster of two blocks splitting a sample's
// states (a cluster barrier a step), skipping the states past the sample's
// lattice, and issuing the row copy and the prefetch ahead of the chain;
// branch-free log-sum-exps came within a few percent. Each step copies the previous row to alphas in
// coalesced stores, off the chain (the copy warps beat sharing the copy
// among the recursion's threads). Frames past the input length repeat the
// last computed row: those rows are written after the recursion, without
// barriers. Past K states per thread (S > 8192 at 1024 threads) the WIDE
// variant's further states read their class and emit on the chain, so any
// lattice that fits shared memory runs.
template <int K, bool WIDE, bool PAIR>
__global__ void __launch_bounds__(1024)
ctc_alpha_kernel(const float* __restrict__ log_probs, const int* __restrict__ targets,
                 const int* __restrict__ input_lengths, const int* __restrict__ target_lengths,
                 float* __restrict__ alphas, float* __restrict__ nll, int T, int U, int V1,
                 int blank, int copy0) {
  constexpr int D = K <= 2 ? 4 : 2;  // emit prefetch distance, in steps
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 2 * U + 1;
  float* const buf0 = reinterpret_cast<float*>(smem);  // step t's row at buf0 + (t & 1) * (S + 2)
  const int b = blockIdx.x, nth = blockDim.x;
  const int tl = min(max(target_lengths[b], 0), U), s_len = 2 * tl + 1;
  const int t_end = max(min(input_lengths[b], T), 1);  // rows computed: 0 .. t_end - 1
  const int* tg = targets + (size_t)b * U;
  const float* lp_b = log_probs + (size_t)b * T * V1;
  float* al_b = alphas + (size_t)b * T * S;

  // class of state s and whether it may skip from s - 2 (a label, in the
  // lattice, other than the label before it)
  auto lattice_at = [&](int s, int& e, bool& skip) {
    e = (s & 1) ? tg[s >> 1] : blank;
    skip = (s & 1) && s >= 3 && s < s_len && e != blank && e != tg[(s >> 1) - 1];
  };
  auto alpha_at = [&](const float* prev, int s, bool skip) {
    const float r = lse2_one_exp(prev[s + 2], prev[s + 1]);
    return skip ? lse2_one_exp(r, prev[s]) : r;
  };
  int st[K], ext[K];
  bool skp[K];
  float em[D][K];  // em[j]: the emits of steps t = 1 + j (mod D)
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if constexpr (PAIR) {  // a label state alone, or two blank states
      const int tid = threadIdx.x, nb = (U + 2) / 2, bi = tid - U + k * nb;
      st[k] = tid < U ? (k == 0 ? 2 * tid + 1 : -1) : (bi - k * nb < nb && 2 * bi < S ? 2 * bi : -1);
    } else {
      const int i = threadIdx.x + k * nth;
      st[k] = i < S ? state_of(i, U) : -1;
    }
    ext[k] = blank;
    skp[k] = false;
#pragma unroll
    for (int j = 0; j < D; ++j) em[j][k] = NEG_INF;
    if (st[k] >= 0) {
      const int s = st[k];
      lattice_at(s, ext[k], skp[k]);
      float a0 = NEG_INF;
      if (s == 0 || (s == 1 && tl > 0)) a0 = lp_b[ext[k]];
      buf0[s + 2] = a0;
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (s < s_len && 1 + j < t_end) em[j][k] = lp_b[(size_t)(1 + j) * V1 + ext[k]];
    }
  }
  if constexpr (WIDE) {
    for (int i = threadIdx.x + K * nth; i < S; i += nth) {
      const int s = state_of(i, U);
      buf0[s + 2] = (s == 0 || (s == 1 && tl > 0)) ? lp_b[(s & 1) ? tg[0] : blank] : NEG_INF;
    }
  }
  if (threadIdx.x < 2) buf0[threadIdx.x] = buf0[S + 2 + threadIdx.x] = NEG_INF;
  __syncthreads();

  for (int t0 = 1; t0 < t_end; t0 += D) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int t = t0 + j;
      if (t >= t_end) break;  // the same for every thread of the block
      const float* prev = buf0 + ((t - 1) & 1) * (S + 2);
      float* cur = buf0 + (t & 1) * (S + 2);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (st[k] >= 0) cur[st[k] + 2] = alpha_at(prev, st[k], skp[k]) + em[j][k];
      if constexpr (WIDE) {
        for (int i = threadIdx.x + K * nth; i < S; i += nth) {
          const int s = state_of(i, U);
          int e;
          bool skip;
          lattice_at(s, e, skip);
          cur[s + 2] = alpha_at(prev, s, skip) + (s < s_len ? lp_b[(size_t)t * V1 + e] : NEG_INF);
        }
      }
      if ((int)threadIdx.x >= copy0)
        for (int s = threadIdx.x - copy0; s < S; s += nth - copy0)
          al_b[(size_t)(t - 1) * S + s] = prev[s + 2];
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (st[k] >= 0 && st[k] < s_len && t + D < t_end)
          em[j][k] = lp_b[(size_t)(t + D) * V1 + ext[k]];
      __syncthreads();
    }
  }

  // the last computed row, and the frozen rows past the length
  const float* fin = buf0 + ((t_end - 1) & 1) * (S + 2);
  for (int t = t_end - 1; t < T; ++t)
    for (int s = threadIdx.x; s < S; s += nth) al_b[(size_t)t * S + s] = fin[s + 2];
  if (threadIdx.x == 0) {
    const float last = fin[s_len + 1];
    const float last2 = tl > 0 ? fin[s_len] : NEG_INF;
    const float m = fmaxf(last, last2);  // logaddexp
    nll[b] = -(m + log1pf(expf(-fabsf(last - last2))));
  }
}

// The beta recursion (K1-bwd): beta_{t+1} + emit(t+1) ping-pongs in shared
// memory, one barrier per step; each thread keeps its states' emit(t, s) in
// registers, loaded a step ahead, so no global load sits on the chain. Its
// prologue also links each label position to the next one with the same
// label (chain[b, 0, i], -1 at the end) and marks the first occurrences
// (chain[b, 1, i]), for the collect's fixed-order sums. Past 8 states per
// thread (S > 8192 at 1024 threads) the WIDE variant's further states read
// their emit on the chain, so any lattice that fits shared memory runs.
constexpr int BETA_REG_K = 8;  // states per thread whose emits wait in registers

// beta_t[s] from beta_{t+1} + emit(t+1) (nx), or the terminal indicator
__device__ inline float beta_at(const float* nx, const Lattice& lat, int s, int S, bool terminal) {
  if (terminal) {
    const bool term = s == lat.s_len - 1 || (s == lat.s_len - 2 && lat.tl > 0);
    return term ? 0.f : NEG_INF;
  }
  const float skp = (lat.fl[min(s + 2, S - 1)] & 2) && s + 2 < S ? nx[s + 2] : NEG_INF;
  return lse2_skip(lse2_skip(nx[s], nx[s + 1]), skp);
}

template <bool WIDE>
__global__ void __launch_bounds__(1024)
ctc_beta_kernel(const float* __restrict__ log_probs, const int* __restrict__ targets,
                const int* __restrict__ input_lengths, const int* __restrict__ target_lengths,
                float* __restrict__ betas, int* __restrict__ chain, int T, int U, int V1,
                int blank) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 2 * U + 1;
  float* be[2] = {reinterpret_cast<float*>(smem), reinterpret_cast<float*>(smem) + S + 2};
  Lattice lat;
  lat.ext = reinterpret_cast<int*>(be[1] + S + 2);
  lat.fl = reinterpret_cast<unsigned char*>(lat.ext + S);
  const int b = blockIdx.x, nth = blockDim.x;
  build_lattice(lat, targets, target_lengths, b, U, blank);
  for (int s = threadIdx.x; s < S + 2; s += nth) be[0][s] = be[1][s] = NEG_INF;
  __syncthreads();
  int* nxt = chain + (size_t)b * 2 * U;
  int* first = nxt + U;
  for (int i = threadIdx.x; i < U; i += nth) {
    int n = -1, f = i < lat.tl ? 1 : 0;
    if (i < lat.tl) {
      const int y = lat.ext[2 * i + 1];
      for (int j = i + 1; j < lat.tl; ++j)
        if (lat.ext[2 * j + 1] == y) { n = j; break; }
      for (int j = 0; j < i && f; ++j)
        if (lat.ext[2 * j + 1] == y) f = 0;
    }
    nxt[i] = n;
    first[i] = f;
  }

  const int len = input_lengths[b];
  const float* lp_b = log_probs + (size_t)b * T * V1;
  float* bt_b = betas + (size_t)b * T * S;
  float em[BETA_REG_K];
#pragma unroll
  for (int k = 0; k < BETA_REG_K; ++k) {
    const int i = threadIdx.x + k * nth;
    em[k] = i < S ? emit(lp_b + (size_t)(T - 1) * V1, lat, state_of(i, U)) : NEG_INF;
  }
  for (int t = T - 1; t >= 0; --t) {
    const float* nx = be[(t + 1) & 1];
    float* cur = be[t & 1];
    const bool terminal = t >= len - 1;  // the last frame, and past the length
    const float* lp_p = lp_b + (size_t)max(t - 1, 0) * V1;
#pragma unroll
    for (int k = 0; k < BETA_REG_K; ++k) {
      const int i = threadIdx.x + k * nth;
      if (i < S) {
        const int s = state_of(i, U);
        const float bt = beta_at(nx, lat, s, S, terminal);
        bt_b[(size_t)t * S + s] = bt;
        cur[s] = bt + em[k];
        em[k] = emit(lp_p, lat, s);  // for step t - 1, off the chain
      }
    }
    if constexpr (WIDE) {
      for (int i = threadIdx.x + BETA_REG_K * nth; i < S; i += nth) {
        const int s = state_of(i, U);
        const float bt = beta_at(nx, lat, s, S, terminal);
        bt_b[(size_t)t * S + s] = bt;
        cur[s] = bt + emit(lp_b + (size_t)t * V1, lat, s);
      }
    }
    __syncthreads();
  }
}

// The gradient ("collect", K1-bwd-grad): one block per (b, t) row, bound by
// the bytes of alpha and beta read once and the row written once. Blank's
// states are summed by a fixed-order block reduction, each label's states
// by its first occurrence walking the chain in order, into a shared row
// that is then written whole: no atomics, the same bits every call.
constexpr int COLLECT_THREADS = 256;

__global__ void __launch_bounds__(COLLECT_THREADS)
ctc_collect_kernel(const int* __restrict__ targets, const int* __restrict__ input_lengths,
                   const int* __restrict__ target_lengths, const float* __restrict__ alphas,
                   const float* __restrict__ betas, const int* __restrict__ chain,
                   const float* __restrict__ nll, const float* __restrict__ g,
                   float* __restrict__ grad, int T, int U, int V1, int blank) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 2 * U + 1;
  float* post = reinterpret_cast<float*>(smem);
  float* row = post + S;
  float* warp_sum = row + V1;
  const int b = blockIdx.x / T, t = blockIdx.x % T;
  float* out = grad + ((size_t)b * T + t) * V1;
  if (t >= input_lengths[b]) {
    for (int v = threadIdx.x; v < V1; v += COLLECT_THREADS) out[v] = 0.f;
    return;
  }
  const int tl = min(max(target_lengths[b], 0), U), s_len = 2 * tl + 1;
  const float ll = -nll[b], gb = g[b];
  const size_t o = ((size_t)b * T + t) * S;
  for (int s = threadIdx.x; s < s_len; s += COLLECT_THREADS)
    post[s] = expf(fminf(fmaxf(alphas[o + s] + betas[o + s] - ll, -60.f), 0.f));
  for (int v = threadIdx.x; v < V1; v += COLLECT_THREADS) row[v] = 0.f;
  __syncthreads();
  // blank: thread i sums states 2i, 2i + 2 * 256, ... in order, then a
  // fixed tree over the lanes and the warps in order
  float s_blank = 0.f;
  for (int s = 2 * threadIdx.x; s < s_len; s += 2 * COLLECT_THREADS) s_blank += post[s];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s_blank += __shfl_down_sync(0xffffffffu, s_blank, off);
  if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = s_blank;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < COLLECT_THREADS / 32; ++w) s += warp_sum[w];
    row[blank] = -s * gb;
  }
  __syncthreads();
  const int* nxt = chain + (size_t)b * 2 * U;
  const int* first = nxt + U;
  const int* tg = targets + (size_t)b * U;
  for (int i = threadIdx.x; i < tl; i += COLLECT_THREADS) {
    if (!first[i]) continue;
    float s = 0.f;
    for (int j = i; j >= 0; j = nxt[j]) s += post[2 * j + 1];
    const int y = tg[i];
    row[y] = (y == blank ? row[y] : 0.f) - s * gb;
  }
  __syncthreads();
  for (int v = threadIdx.x; v < V1; v += COLLECT_THREADS) out[v] = row[v];
}

size_t alpha_smem(int U) { return sizeof(float) * 2 * (2 * U + 3); }

size_t beta_smem(int U) {
  return sizeof(float) * 2 * (2 * U + 3) + (sizeof(int) + 1) * (2 * U + 1);
}

size_t collect_smem(int U, int V1) {
  return sizeof(float) * ((2 * U + 1) + V1 + COLLECT_THREADS / 32);
}

// Threads of the beta kernel: one per state up to 1024 (the step's chain of
// two log-sum-exps is the latency to hide), a multiple of 32.
int beta_threads(int U) {
  const int want = (2 * U + 1 + 31) / 32 * 32;
  return want < 64 ? 64 : (want > 1024 ? 1024 : want);
}

}  // namespace

// Bytes of shared memory the forward (which = 0), the beta (1) or the
// collect (2) kernel needs at (U, V1).
extern "C" long long ctc_smem_bytes(int U, int V1, int which) {
  if (which == 1) return (long long)beta_smem(U);
  return (long long)(which ? collect_smem(U, V1) : alpha_smem(U));
}

// log_probs: [b, t, v1] fp32; targets: [b, u] int32 (u >= 0); input_lengths,
// target_lengths: [b] int32; alphas: [b, t, 2u+1] fp32; nll: [b] fp32. All
// contiguous; t >= 1. Launches on `stream`; returns the cudaError_t.
extern "C" int ctc_alpha_f32(const void* log_probs, const void* targets, const void* input_lengths,
                             const void* target_lengths, void* alphas, void* nll, int b, int t,
                             int u, int v1, int blank, void* stream) {
  const size_t smem = alpha_smem(u);
  // one state per thread up to 1024 threads, then 2, 4 or 8 a thread, and
  // the WIDE variant past 8192 states
  const int S = 2 * u + 1;
  int k = 1;
  while (k < 8 && S > 1024 * k) k *= 2;
  int threads = std::min(1024, std::max(32, ((S + k - 1) / k + 31) / 32 * 32));
  // past 1024 states, a thread for each label state and one for each two
  // blank states, while that fits a block: no thread then runs more than two
  // log-sum-exps a step
  const bool pair = k == 2 && u + (u + 2) / 2 <= 1024;
  if (pair) threads = (u + (u + 2) / 2 + 31) / 32 * 32;
  // threads from copy0 on copy each row out; with room, four warps of
  // their own, so the recursion's threads keep to the chain
  const int copy0 = pair && threads + 128 <= 1024 ? threads : 0;
  if (copy0) threads += 128;
  auto kernel = k == 1   ? ctc_alpha_kernel<1, false, false>
                : pair   ? ctc_alpha_kernel<2, false, true>
                : k == 2 ? ctc_alpha_kernel<2, false, false>
                : k == 4 ? ctc_alpha_kernel<4, false, false>
                : S > 8 * threads ? ctc_alpha_kernel<8, true, false>
                                  : ctc_alpha_kernel<8, false, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<b, threads, smem, (cudaStream_t)stream>>>(
      (const float*)log_probs, (const int*)targets, (const int*)input_lengths,
      (const int*)target_lengths, (float*)alphas, (float*)nll, t, u, v1, blank, copy0);
  return (int)cudaGetLastError();
}

// The beta kernel: as above, writing betas [b, t, 2u+1] fp32 and the label
// chains [b, 2, u] int32.
extern "C" int ctc_beta_f32(const void* log_probs, const void* targets, const void* input_lengths,
                            const void* target_lengths, void* betas, void* chain, int b, int t,
                            int u, int v1, int blank, void* stream) {
  const size_t smem = beta_smem(u);
  const int threads = beta_threads(u);
  auto kernel = 2 * u + 1 > BETA_REG_K * threads ? ctc_beta_kernel<true> : ctc_beta_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<b, threads, smem, (cudaStream_t)stream>>>(
      (const float*)log_probs, (const int*)targets, (const int*)input_lengths,
      (const int*)target_lengths, (float*)betas, (int*)chain, t, u, v1, blank);
  return (int)cudaGetLastError();
}

// The collect kernel: alphas, betas [b, t, 2u+1], the chains, nll and the
// upstream g [b] fp32 -> grad [b, t, v1] fp32 (every entry written).
extern "C" int ctc_collect_f32(const void* targets, const void* input_lengths,
                               const void* target_lengths, const void* alphas, const void* betas,
                               const void* chain, const void* nll, const void* g, void* grad,
                               int b, int t, int u, int v1, int blank, void* stream) {
  const size_t smem = collect_smem(u, v1);
  cudaError_t err = cudaFuncSetAttribute(ctc_collect_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ctc_collect_kernel<<<(unsigned)((size_t)b * t), COLLECT_THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)targets, (const int*)input_lengths, (const int*)target_lengths,
      (const float*)alphas, (const float*)betas, (const int*)chain, (const float*)nll,
      (const float*)g, (float*)grad, t, u, v1, blank);
  return (int)cudaGetLastError();
}
