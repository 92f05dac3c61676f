"""CTC loss: a plain PyTorch recursion, and the hand-written CUDA kernels.

Semantics of conformer_nemo_tpu/ops/ctc_loss.py (torch.nn.CTCLoss as the
reference wraps it): blank id = V (the last class), per-sample negative
log-likelihood, reductions 'mean_batch' (mean of the per-sample losses),
'mean' (each divided by its target length), 'sum' and 'none', and
`zero_infinity`. fp32 throughout; bf16 log-probs are upcast. -1e30 stands
for -inf everywhere, so an infeasible alignment (target longer than the
input allows) gives nll = 1e30, as in the JAX package, and `zero_infinity`
zeroes it. Target lengths are clamped to [0, U].

Two implementations:

* `ctc_forward_neg_log_likelihood`: the alpha recursion as a Python loop of
  batched torch ops over [B, S], differentiated by autograd (the JAX
  package's `lax.scan` version). `impl="plain"`.
* `CTCLossKernel`: the TPU kernels of conformer_nemo_tpu/ops/pallas/ctc_kernel.py
  (`_fwd_kernel` / `_bwd_kernel` with the glue of `_ctc_fwd` / `_ctc_bwd`)
  as a `torch.autograd.Function` whose forward is K1-fwd (`ctc_alphas`:
  all alphas [B, T, S] and the nll) and whose backward (`ctc_grad`) is
  K1-bwd (`ctc_betas`: the beta recursion) and K1-bwd-grad (`ctc_collect`:
  d nll / d log_probs over all B * T rows in parallel).
  `impl="kernel"`. For CUDA tensors they launch ops/csrc/ctc_loss.cu and
  raise on anything the kernels do not take; for CPU tensors they run
  their plain versions (`ctc_alphas_reference`, `ctc_betas_reference`,
  `ctc_collect_reference`; `ctc_grad_reference` composes the last two).

The kernels and what bounds them are described in ops/csrc/ctc_loss.cu.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from conformer_nemo_tpu_torch.ops.build import SMEM_LIMIT, launch_count, load
from conformer_nemo_tpu_torch.utils.typecheck import typecheck

_NEG_INF = -1e30

# launches per kernel, keyed by (B, T, U, V+1)
alpha_launches = launch_count("K1-fwd")
grad_launches = launch_count("K1-bwd")  # the beta kernel
collect_launches = launch_count("K1-bwd-grad")


def lse2(a, b):
    """log(e^a + e^b) with -1e30 as -inf; the double `where` keeps both
    branches (and their gradients) finite where the lattice is empty."""
    m = torch.maximum(a, b)
    bad = m <= _NEG_INF * 0.5
    m_safe = torch.where(bad, 0.0, m)
    ea = torch.exp(torch.where(bad, 0.0, a - m_safe))
    eb = torch.exp(torch.where(bad, 0.0, b - m_safe))
    return torch.where(bad, _NEG_INF, m_safe + torch.log(ea + eb))


def _lattice(targets, target_lengths, blank_id: int, s_max: int):
    """-> ext [B, S] int64, in_lattice [B, S], can_skip [B, S] (without the
    lattice mask), target lengths clamped to [0, U]."""
    b, u = targets.shape
    tl = target_lengths.to(torch.int64).clamp(0, u)
    ext = torch.full((b, s_max), blank_id, dtype=torch.int64, device=targets.device)
    ext[:, 1::2] = targets.to(torch.int64)
    s_idx = torch.arange(s_max, device=targets.device)[None, :]
    in_lattice = s_idx < 2 * tl[:, None] + 1
    ext_m2 = F.pad(ext, (2, 0), value=-1)[:, :s_max]
    can_skip = (ext != blank_id) & (ext != ext_m2)
    return ext, in_lattice, can_skip, tl


def _final_ll(alpha, tl):
    """log p from the frozen last alphas: the two terminal states."""
    s_len = 2 * tl + 1
    last = torch.gather(alpha, 1, (s_len - 1)[:, None])[:, 0]
    last2 = torch.gather(alpha, 1, (s_len - 2).clamp(min=0)[:, None])[:, 0]
    last2 = torch.where(tl > 0, last2, _NEG_INF)
    return last, last2


def ctc_forward_neg_log_likelihood(log_probs, targets, input_lengths, target_lengths,
                                   blank_id: int):
    """Per-sample -log p(targets | log_probs) [B] from log_probs [B, T, V+1],
    targets [B, U] (padded arbitrarily) and lengths [B]; differentiable by
    autograd."""
    lp = log_probs.to(torch.float32)
    b, t_max, _ = lp.shape
    s_max = 2 * targets.shape[1] + 1
    ext, in_lattice, can_skip, tl = _lattice(targets, target_lengths, blank_id, s_max)
    emits = torch.gather(lp, 2, ext[:, None, :].expand(b, t_max, s_max))  # [B, T, S]
    s_idx = torch.arange(s_max, device=lp.device)[None, :]
    first = (s_idx == 0) | ((s_idx == 1) & (tl[:, None] > 0))
    alpha = torch.where(first & in_lattice, emits[:, 0], _NEG_INF)
    lens = input_lengths.to(lp.device)
    for t in range(1, t_max):
        a_m1 = F.pad(alpha, (1, 0), value=_NEG_INF)[:, :s_max]
        a_m2 = F.pad(alpha, (2, 0), value=_NEG_INF)[:, :s_max]
        new = lse2(lse2(alpha, a_m1), torch.where(can_skip, a_m2, _NEG_INF)) + emits[:, t]
        new = torch.where(in_lattice, new, _NEG_INF)
        alpha = torch.where((t < lens)[:, None], new, alpha)  # frozen past the length
    last, last2 = _final_ll(alpha, tl)
    return -lse2(last, last2)


def _emits(lp, ext, in_lattice):
    """emits [B, T, S] = log_probs[b, t, ext[s]] in the lattice, -1e30 outside
    (the TPU kernels' `_prep`)."""
    b, t_max, _ = lp.shape
    e = torch.gather(lp, 2, ext[:, None, :].expand(b, t_max, ext.shape[1]))
    return torch.where(in_lattice[:, None, :], e, _NEG_INF)


def ctc_alphas_reference(log_probs, targets, input_lengths, target_lengths, blank_id: int):
    """Plain PyTorch version of K1-fwd: (alphas [B, T, S] fp32, nll [B])."""
    lp = log_probs.to(torch.float32)
    b, t_max, _ = lp.shape
    s_max = 2 * targets.shape[1] + 1
    ext, in_lattice, can_skip, tl = _lattice(targets, target_lengths, blank_id, s_max)
    skip = can_skip & in_lattice
    emits = _emits(lp, ext, in_lattice)
    s_idx = torch.arange(s_max, device=lp.device)[None, :]
    first = (s_idx == 0) | ((s_idx == 1) & (tl[:, None] > 0))
    alpha = torch.where(first, emits[:, 0], _NEG_INF)
    alphas = [alpha]
    lens = input_lengths.to(lp.device)
    for t in range(1, t_max):
        a_m1 = F.pad(alpha, (1, 0), value=_NEG_INF)[:, :s_max]
        a_m2 = torch.where(skip, F.pad(alpha, (2, 0), value=_NEG_INF)[:, :s_max], _NEG_INF)
        new = lse2(lse2(alpha, a_m1), a_m2) + emits[:, t]
        alpha = torch.where((t < lens)[:, None], new, alpha)
        alphas.append(alpha)
    last, last2 = _final_ll(alpha, tl)
    return torch.stack(alphas, dim=1), -torch.logaddexp(last, last2)


def label_chains(targets, target_lengths):
    """[B, 2, U] int32: for each label position i < target_length, the next
    position with the same label (-1 at the end of its chain), and whether i
    is its label's first occurrence (K1-bwd's prologue builds the same)."""
    b, u = targets.shape
    tl = target_lengths.to(torch.int64).clamp(0, u)
    pos = torch.arange(u, device=targets.device)
    valid = pos[None, :] < tl[:, None]  # [B, U]
    same = (targets[:, :, None] == targets[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    later = same & (pos[None, None, :] > pos[None, :, None])
    earlier = same & (pos[None, None, :] < pos[None, :, None])
    nxt = torch.where(later, pos[None, None, :], u).amin(2)
    nxt = torch.where(later.any(2), nxt, -1)
    return torch.stack([nxt, (valid & ~earlier.any(2)).to(torch.int64)], 1).to(torch.int32)


def ctc_betas_reference(log_probs, targets, input_lengths, target_lengths, blank_id: int):
    """Plain PyTorch version of K1-bwd: (betas [B, T, S] fp32, the label
    chains [B, 2, U] of `label_chains`)."""
    lp = log_probs.to(torch.float32)
    b, t_max, _ = lp.shape
    s_max = 2 * targets.shape[1] + 1
    ext, in_lattice, can_skip, tl = _lattice(targets, target_lengths, blank_id, s_max)
    skip = can_skip & in_lattice
    emits = _emits(lp, ext, in_lattice)
    s_idx = torch.arange(s_max, device=lp.device)[None, :]
    s_len = 2 * tl[:, None] + 1
    final = torch.where((s_idx == s_len - 1) | ((s_idx == s_len - 2) & (tl[:, None] > 0)),
                        0.0, _NEG_INF)
    lens = input_lengths.to(lp.device)[:, None]
    skip2 = F.pad(skip, (0, 2), value=False)[:, 2:]
    beta = torch.full((b, s_max), _NEG_INF, device=lp.device)
    betas = [None] * t_max
    for t in range(t_max - 1, -1, -1):
        be = beta + emits[:, min(t + 1, t_max - 1)]
        adv = F.pad(be, (0, 1), value=_NEG_INF)[:, 1:]
        skp = torch.where(skip2, F.pad(be, (0, 2), value=_NEG_INF)[:, 2:], _NEG_INF)
        beta = torch.where((t == lens - 1) | (t >= lens), final, lse2(lse2(be, adv), skp))
        betas[t] = beta
    return torch.stack(betas, dim=1), label_chains(targets, target_lengths)


def ctc_collect_reference(log_probs, targets, input_lengths, target_lengths, alphas, betas,
                          chains, nll, g, blank_id: int):
    """Plain PyTorch version of K1-bwd-grad: grad [B, T, V+1] fp32 =
    -g[b] * the posteriors exp(clip(alpha + beta - ll, -60, 0)) of the
    lattice's states summed per class, zero past the input length (the
    chains are the kernel's means to a fixed order; the sums here need
    none)."""
    b, t_max, v1 = log_probs.shape
    s_max = alphas.shape[2]
    ext, in_lattice, _, _ = _lattice(targets, target_lengths, blank_id, s_max)
    ll = -nll.to(torch.float32)[:, None, None]
    post = torch.exp(torch.clamp(alphas + betas - ll, -60.0, 0.0))
    past = torch.arange(t_max, device=alphas.device)[None, :, None] >= \
        input_lengths.to(alphas.device)[:, None, None]
    dem = torch.where(past | ~in_lattice[:, None, :], 0.0, -post)
    grad = torch.zeros((b, t_max, v1), device=alphas.device)
    grad.scatter_add_(2, ext[:, None, :].expand(b, t_max, s_max), dem)
    return grad * g.to(torch.float32)[:, None, None]


def ctc_grad_reference(log_probs, targets, input_lengths, target_lengths, alphas, nll, g,
                       blank_id: int):
    """Plain PyTorch version of the whole backward: g[b] * d nll_b / d
    log_probs [B, T, V+1] fp32 from K1-fwd's alphas and nll (K1-bwd's
    betas, then K1-bwd-grad)."""
    betas, chains = ctc_betas_reference(log_probs, targets, input_lengths, target_lengths,
                                        blank_id)
    return ctc_collect_reference(log_probs, targets, input_lengths, target_lengths, alphas,
                                 betas, chains, nll, g, blank_id)


def _c_fn(name: str, n_ptr: int):
    fn = getattr(load("ctc_loss.cu"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(lp, targets, input_lengths, target_lengths, blank_id: int,
                kernels: tuple) -> None:
    """What the CUDA kernels take: fp32 log_probs [B, T>=1, V+1], int32
    targets [B, U] with ids in [0, V+1), int32 lengths, all contiguous on one
    card, and shared memory for the lattice."""
    b, t_max, v1 = lp.shape
    if lp.dtype != torch.float32 or any(
            x.dtype != torch.int32 for x in (targets, input_lengths, target_lengths)):
        raise TypeError("the CUDA kernels take fp32 log_probs and int32 targets and lengths")
    if not all(x.is_cuda and x.device == lp.device and x.is_contiguous()
               for x in (lp, targets, input_lengths, target_lengths)):
        raise ValueError("the CUDA kernels take contiguous tensors on one card")
    if t_max < 1 or not 0 <= blank_id < v1:
        raise ValueError(f"the CUDA kernels take T >= 1 and a blank id in [0, {v1}); "
                         f"got T={t_max}, blank={blank_id}")
    if targets.numel() and (int(targets.min()) < 0 or int(targets.max()) >= v1):
        raise ValueError(f"target ids must lie in [0, {v1})")
    lib = load("ctc_loss.cu")
    lib.ctc_smem_bytes.restype = ctypes.c_longlong
    u = targets.shape[1]
    for which, what in zip(kernels, ("the forward", "the beta kernel", "the collect kernel")):
        smem = lib.ctc_smem_bytes(u, v1, which)
        if smem > SMEM_LIMIT:
            raise ValueError(f"{what} keeps the lattice in shared memory: U={u}, V+1={v1} "
                             f"needs {smem} bytes of a block's {SMEM_LIMIT}")


def _check(log_probs, targets, input_lengths, target_lengths):
    b = log_probs.shape[0]
    if log_probs.dim() != 3 or targets.dim() != 2 or targets.shape[0] != b:
        raise ValueError(f"shapes: log_probs {tuple(log_probs.shape)}, targets "
                         f"{tuple(targets.shape)}; want [B,T,V+1], [B,U]")
    if input_lengths.shape != (b,) or target_lengths.shape != (b,):
        raise ValueError(f"lengths must be [B] = [{b}]")
    if log_probs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {log_probs.device}")


def ctc_alphas(log_probs, targets, input_lengths, target_lengths, blank_id: int):
    """K1-fwd: (alphas [B, T, 2U+1] fp32, nll [B] fp32)."""
    _check(log_probs, targets, input_lengths, target_lengths)
    if log_probs.device.type == "cpu":
        return ctc_alphas_reference(log_probs, targets, input_lengths, target_lengths, blank_id)
    _check_cuda(log_probs, targets, input_lengths, target_lengths, blank_id, (0,))
    b, t_max, v1 = log_probs.shape
    u = targets.shape[1]
    alphas = torch.empty((b, t_max, 2 * u + 1), dtype=torch.float32, device=log_probs.device)
    nll = torch.empty((b,), dtype=torch.float32, device=log_probs.device)
    if b == 0:
        return alphas, nll
    with torch.cuda.device(log_probs.device):
        err = _c_fn("ctc_alpha_f32", 6)(
            log_probs.data_ptr(), targets.data_ptr(), input_lengths.data_ptr(),
            target_lengths.data_ptr(), alphas.data_ptr(), nll.data_ptr(), b, t_max, u, v1,
            blank_id, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ctc_alphas kernel launch failed: CUDA error {err}")
    alpha_launches.add((b, t_max, u, v1))
    return alphas, nll


def ctc_grad(log_probs, targets, input_lengths, target_lengths, alphas, nll, g, blank_id: int):
    """The CTC backward: g[b] * d nll_b / d log_probs, [B, T, V+1] fp32. On
    CUDA: K1-bwd (`ctc_betas`), then K1-bwd-grad (`ctc_collect`)."""
    _check(log_probs, targets, input_lengths, target_lengths)
    b, t_max, v1 = log_probs.shape
    if alphas.shape != (b, t_max, 2 * targets.shape[1] + 1) or nll.shape != (b,) or \
            g.shape != (b,):
        raise ValueError("alphas must be [B, T, 2U+1] and nll, g [B]")
    if log_probs.device.type == "cpu":
        return ctc_grad_reference(log_probs, targets, input_lengths, target_lengths, alphas,
                                  nll, g, blank_id)
    _check_cuda(log_probs, targets, input_lengths, target_lengths, blank_id, (1, 2))
    _check_grad_inputs(log_probs, alphas, nll, g)
    args = (log_probs, targets, input_lengths, target_lengths)
    betas, chains = _launch_betas(*args, blank_id)
    return _launch_collect(*args, alphas, betas, chains, nll, g, blank_id)


def ctc_betas(log_probs, targets, input_lengths, target_lengths, blank_id: int):
    """K1-bwd: (betas [B, T, 2U+1] fp32, label chains [B, 2, U] int32)."""
    _check(log_probs, targets, input_lengths, target_lengths)
    if log_probs.device.type == "cpu":
        return ctc_betas_reference(log_probs, targets, input_lengths, target_lengths, blank_id)
    _check_cuda(log_probs, targets, input_lengths, target_lengths, blank_id, (1,))
    return _launch_betas(log_probs, targets, input_lengths, target_lengths, blank_id)


def ctc_collect(log_probs, targets, input_lengths, target_lengths, alphas, betas, chains, nll, g,
                blank_id: int):
    """K1-bwd-grad: the gradient [B, T, V+1] fp32 from alphas, betas, the
    chains, nll and g (log_probs gives the shape and device only)."""
    _check(log_probs, targets, input_lengths, target_lengths)
    if log_probs.device.type == "cpu":
        return ctc_collect_reference(log_probs, targets, input_lengths, target_lengths, alphas,
                                     betas, chains, nll, g, blank_id)
    _check_cuda(log_probs, targets, input_lengths, target_lengths, blank_id, (2,))
    _check_grad_inputs(log_probs, alphas, nll, g, betas)
    if chains.dtype != torch.int32 or chains.shape != (log_probs.shape[0], 2, targets.shape[1]):
        raise TypeError("the CUDA kernel takes int32 chains [B, 2, U]")
    return _launch_collect(log_probs, targets, input_lengths, target_lengths, alphas, betas,
                           chains, nll, g, blank_id)


def _check_grad_inputs(lp, *tensors) -> None:
    if not all(x.dtype == torch.float32 and x.is_contiguous() and x.device == lp.device
               for x in tensors):
        raise TypeError("the CUDA kernels take contiguous fp32 alphas, betas, nll and g on the "
                        "card")


def _launch_betas(log_probs, targets, input_lengths, target_lengths, blank_id: int):
    b, t_max, v1 = log_probs.shape
    u = targets.shape[1]
    betas = torch.empty((b, t_max, 2 * u + 1), dtype=torch.float32, device=log_probs.device)
    chains = torch.empty((b, 2, u), dtype=torch.int32, device=log_probs.device)
    if b == 0:
        return betas, chains
    with torch.cuda.device(log_probs.device):
        err = _c_fn("ctc_beta_f32", 6)(
            log_probs.data_ptr(), targets.data_ptr(), input_lengths.data_ptr(),
            target_lengths.data_ptr(), betas.data_ptr(), chains.data_ptr(), b, t_max, u, v1,
            blank_id, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ctc_betas kernel launch failed: CUDA error {err}")
    grad_launches.add((b, t_max, u, v1))
    return betas, chains


def _launch_collect(log_probs, targets, input_lengths, target_lengths, alphas, betas, chains, nll,
                    g, blank_id: int):
    b, t_max, v1 = log_probs.shape
    u = targets.shape[1]
    grad = torch.empty_like(log_probs)
    if b == 0:
        return grad
    with torch.cuda.device(log_probs.device):
        err = _c_fn("ctc_collect_f32", 9)(
            targets.data_ptr(), input_lengths.data_ptr(), target_lengths.data_ptr(),
            alphas.data_ptr(), betas.data_ptr(), chains.data_ptr(), nll.data_ptr(), g.data_ptr(),
            grad.data_ptr(), b, t_max, u, v1, blank_id, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ctc_collect kernel launch failed: CUDA error {err}")
    collect_launches.add((b, t_max, u, v1))
    return grad


class CTCLossKernel(torch.autograd.Function):
    """nll [B] through K1-fwd, its gradient through K1-bwd."""

    @staticmethod
    def forward(ctx, log_probs, targets, input_lengths, target_lengths, blank_id: int):
        lp = log_probs.to(torch.float32).contiguous()
        tg, il, tl = (x.to(torch.int32).contiguous()
                      for x in (targets, input_lengths, target_lengths))
        alphas, nll = ctc_alphas(lp, tg, il, tl, blank_id)
        ctx.save_for_backward(lp, tg, il, tl, alphas, nll)
        ctx.blank_id = blank_id
        ctx.in_dtype = log_probs.dtype
        return nll

    @staticmethod
    def backward(ctx, g):
        lp, tg, il, tl, alphas, nll = ctx.saved_tensors
        grad = ctc_grad(lp, tg, il, tl, alphas, nll, g.to(torch.float32).contiguous(),
                        ctx.blank_id)
        return grad.to(ctx.in_dtype), None, None, None, None


@typecheck(log_probs=("B", "T", "V"), targets=("B", "U"), input_lengths=("B",),
           target_lengths=("B",))
def ctc_loss(log_probs, targets, input_lengths, target_lengths, *, blank_id: int,
             reduction: str = "mean_batch", zero_infinity: bool = False,
             impl: str = "plain"):
    """CTC loss with the reference's reductions; impl "plain" (autograd
    through the recursion) or "kernel" (`CTCLossKernel`)."""
    if impl == "kernel":
        nll = CTCLossKernel.apply(log_probs, targets, input_lengths, target_lengths, blank_id)
    elif impl == "plain":
        nll = ctc_forward_neg_log_likelihood(log_probs, targets, input_lengths, target_lengths,
                                             blank_id)
    else:
        raise ValueError(f"impl must be 'plain' or 'kernel', got {impl!r}")
    if zero_infinity:
        nll = torch.where(nll >= -_NEG_INF * 0.5, 0.0, nll)
    if reduction == "mean_batch":
        return nll.mean()
    if reduction == "mean":
        return (nll / target_lengths.to(nll.dtype).clamp(min=1.0)).mean()
    if reduction == "sum":
        return nll.sum()
    if reduction == "none":
        return nll
    raise ValueError(f"unknown reduction {reduction!r}")
