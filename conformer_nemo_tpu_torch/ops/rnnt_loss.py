"""RNN-T (transducer) loss from the joint's logits (port of
conformer_nemo_tpu/ops/rnnt_loss.py).

Per-sample negative log-likelihood over the [T, U+1] lattice with the blank
and label log-probs of `_prep`, the forward variable alpha (K3-alpha) for
the nll, and a closed-form gradient with respect to the logits from the
backward variable beta (K3-beta) and the occupancy posteriors:

    gb(t, u) = exp(clip(alpha + blank_lp + beta[t+1, u] - ll, -1e30, 0))
    gy(t, u) = exp(clip(alpha + label_lp + beta[t, u+1] - ll, -1e30, 0))
    d nll / d logits = softmax(logits) * total - gb 1[blank] - gy 1[label]

zero outside each sample's lattice, clamped to [-clamp, clamp] when clamp
> 0, times the upstream gradient. FastEmit (lambda > 0) scales the nll by
1 + lambda and, as the JAX package does on this path, gy and the blank
term of `total` (`gb_scale`). All lattice math is fp32.

`impl` picks the lattice: "kernel" (`rnnt_alphas` / `rnnt_betas` of
ops/rnnt_lattice.py: the CUDA kernels for CUDA tensors, their plain
versions for CPU tensors; the JAX package's "pallas"), "plain" (the plain
versions; its "scan"), or "auto" (the kernel on CUDA, plain on the CPU).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from conformer_nemo_tpu_torch.ops.rnnt_lattice import (
    NEG_INF,
    rnnt_alphas,
    rnnt_alphas_reference,
    rnnt_betas,
    rnnt_betas_reference,
    terminal_cells,
    valid_cells,
)
from conformer_nemo_tpu_torch.utils.typecheck import typecheck


def lattice_fns(impl: str, device: torch.device):
    """(alphas, betas) functions for impl kernel | plain | auto."""
    if impl == "auto":
        impl = "kernel" if device.type == "cuda" else "plain"
    if impl == "kernel":
        return rnnt_alphas, rnnt_betas
    if impl == "plain":
        return rnnt_alphas_reference, rnnt_betas_reference
    raise ValueError(f"impl must be 'auto', 'kernel' or 'plain', got {impl!r}")


def padded_targets(targets: torch.Tensor) -> torch.Tensor:
    """[B, U] -> [B, U+1] int64 with a dummy 0 in the last column: the label
    column of cell (t, u) is targets[u]."""
    return F.pad(targets.long(), (0, 1))


def prep(logits: torch.Tensor, targets: torch.Tensor, blank_id: int):
    """(blank_lp, label_lp, lse), each [B, T, U+1] fp32, from logits
    [B, T, U+1, V]: the log-softmax denominator, the blank column and the
    target column (a gather; the TPU's one-hot matmul picks the same
    value). label_lp's last column (u = U, no label to emit) is -1e30."""
    x = logits.float()
    m = x.amax(dim=-1).detach()
    lse = m + torch.log(torch.exp(x - m[..., None]).sum(dim=-1))
    blank_lp = x[..., blank_id] - lse
    b, t_max, u1, _ = logits.shape
    tgt = padded_targets(targets)[:, None, :, None].expand(b, t_max, u1, 1)
    label_lp = torch.gather(logits, 3, tgt)[..., 0].float() - lse
    u_row = torch.arange(u1, device=logits.device)[None, None, :]
    label_lp = torch.where(u_row >= u1 - 1, NEG_INF, label_lp)
    return blank_lp, label_lp, lse


def log_likelihood(alpha, blank_lp, t_lens, u_lens) -> torch.Tensor:
    """alpha + blank at each sample's terminal cell (t_len - 1, u_len)."""
    bi = torch.arange(alpha.shape[0], device=alpha.device)
    t_last, u_last = t_lens.long() - 1, u_lens.long()
    return alpha[bi, t_last, u_last] + blank_lp[bi, t_last, u_last]


def posteriors(alpha, beta, blank_lp, label_lp, t_lens, u_lens):
    """(gb, gy) [B, T, U+1]: the occupancy of leaving each cell by blank and
    by label, with ll = beta[:, 0, 0] (unscaled, not yet masked)."""
    ll = beta[:, 0, 0][:, None, None]
    beta_tp1 = F.pad(beta, (0, 0, 0, 1), value=NEG_INF)[:, 1:]
    # the terminal blank leaves the lattice with beta = 0
    beta_tp1 = torch.where(terminal_cells(beta.shape, t_lens, u_lens), 0.0, beta_tp1)
    beta_up1 = F.pad(beta, (0, 1), value=NEG_INF)[:, :, 1:]
    occ = lambda x: torch.exp(torch.clamp(x, NEG_INF, 0.0))
    return occ(alpha + blank_lp + beta_tp1 - ll), occ(alpha + label_lp + beta_up1 - ll)


class RNNTLossFromLogits(torch.autograd.Function):
    """nll [B] from logits [B, T, U+1, V]: forward `prep` + alpha + the nll
    (`_rnnt_fwd`), backward beta + the posterior gradient (`_rnnt_bwd`)."""

    @staticmethod
    def forward(ctx, logits, targets, t_lens, u_lens, blank_id: int, fastemit_lambda: float,
                clamp: float, impl: str):
        alphas, betas = lattice_fns(impl, logits.device)
        tl, ul = t_lens.to(torch.int32).contiguous(), u_lens.to(torch.int32).contiguous()
        blank_lp, label_lp, lse = prep(logits, targets, blank_id)
        blank_lp, label_lp = blank_lp.contiguous(), label_lp.contiguous()
        alpha = alphas(blank_lp, label_lp, tl, ul)
        ll = log_likelihood(alpha, blank_lp, tl, ul)
        nll = -(1.0 + fastemit_lambda) * ll if fastemit_lambda > 0 else -ll
        ctx.save_for_backward(logits, targets, tl, ul, blank_lp, label_lp, lse, alpha)
        ctx.args = (blank_id, fastemit_lambda, clamp, betas)
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, targets, tl, ul, blank_lp, label_lp, lse, alpha = ctx.saved_tensors
        blank_id, fastemit_lambda, clamp, betas = ctx.args
        beta = betas(blank_lp, label_lp, tl, ul)
        gb, gy = posteriors(alpha, beta, blank_lp, label_lp, tl, ul)
        gb_scale = 1.0 + fastemit_lambda if fastemit_lambda > 0 else 1.0
        if fastemit_lambda > 0:
            gy = gy * (1.0 + fastemit_lambda)
        total = gb * gb_scale + gy
        grad = torch.exp(logits.float() - lse[..., None]) * total[..., None]
        grad[..., blank_id] -= gb * gb_scale
        b, t_max, u1, v = logits.shape
        tgt = padded_targets(targets)[:, None, :, None].expand(b, t_max, u1, 1)
        grad = grad - torch.zeros_like(grad).scatter_(3, tgt, gy[..., None])
        grad = torch.where(valid_cells(blank_lp.shape, tl, ul)[..., None], grad, 0.0)
        if clamp > 0:
            grad = torch.clamp(grad, -clamp, clamp)
        grad = grad * g.float()[:, None, None, None]
        return grad.to(logits.dtype), None, None, None, None, None, None, None


def rnnt_loss_from_logits(logits, targets, t_lens, u_lens, blank_id: int,
                          fastemit_lambda: float = 0.0, clamp: float = -1.0,
                          impl: str = "auto") -> torch.Tensor:
    """Per-sample RNN-T nll [B] (see `RNNTLossFromLogits`)."""
    return RNNTLossFromLogits.apply(logits, targets, t_lens, u_lens, int(blank_id),
                                    float(fastemit_lambda), float(clamp), impl)


@typecheck(logits=("B", "T", "U1", "V"), targets=("B", "U"), t_lens=("B",), u_lens=("B",))
def rnnt_loss(logits, targets, t_lens, u_lens, *, blank_id: int, reduction: str = "mean_batch",
              fastemit_lambda: float = 0.0, clamp: float = -1.0, impl: str = "auto"):
    """RNN-T loss with the reference's reductions: mean_batch (mean of the
    per-sample nll), sum, mean (each divided by its target length, at least
    1) or none (the per-sample nll)."""
    nll = rnnt_loss_from_logits(logits, targets, t_lens, u_lens, blank_id, fastemit_lambda,
                                clamp, impl)
    if reduction == "mean_batch":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return (nll / u_lens.to(nll.dtype).clamp(min=1.0)).mean()
    if reduction == "none":
        return nll
    raise ValueError(f"unknown reduction {reduction!r}")
