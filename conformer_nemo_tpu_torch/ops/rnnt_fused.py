"""RNN-T loss from the projected joint inputs (port of
conformer_nemo_tpu/ops/rnnt_fused.py): the flash joint (K4) and the lattice
(K3) behind one `torch.autograd.Function`, so the [B, T, U+1, V] logits
never exist.

Forward: K4-fwd -> (blank_lp, label_lp, lse) [B, T, U+1], computed inside
each sample's lattice only; label_lp's dummy last column set to -1e30;
K3-alpha; the nll. Backward: K3-beta; the occupancy posteriors gb, gy and
total = gb + gy; K4-bwd, which reads them inside each sample's lattice
only (JAX zeroes them outside instead) -> (de, dp, dW, dbias). FastEmit (lambda > 0)
scales the nll by 1 + lambda and, as the JAX package does on this path,
both gb and gy before `total`. Residuals are the projected inputs and the
[B, T, U+1] streams.

The joint dropout runs inside K4 with the hash mask (forward and backward
regenerate it from the seed), so no [B, T, U+1, H] mask exists either.
"""

from __future__ import annotations

import torch

from conformer_nemo_tpu_torch.ops.rnnt_joint import check_smem, joint_flash_bwd, joint_flash_fwd
from conformer_nemo_tpu_torch.ops.rnnt_lattice import NEG_INF
from conformer_nemo_tpu_torch.ops.rnnt_loss import lattice_fns, log_likelihood, posteriors


class RNNTLossFused(torch.autograd.Function):
    """nll [B] from e [B,T,H], p [B,U+1,H], w [H,V], bias [V] (compute dtype)."""

    @staticmethod
    def forward(ctx, e, p, w, bias, targets, t_lens, u_lens, seed, blank_id: int,
                fastemit_lambda: float, clamp: float, lattice_impl: str, activation: str,
                drop_t: int, bt: int):
        if e.is_cuda and any(ctx.needs_input_grad[:4]):
            # the backward's range, checked before the forward's work rather
            # than after it (the kernels' one range rule)
            check_smem(e.shape[2], w.shape[1], (1, 2), e.dtype)
        alphas, betas = lattice_fns(lattice_impl, e.device)
        tg = targets.to(torch.int32).contiguous()
        tl, ul = t_lens.to(torch.int32).contiguous(), u_lens.to(torch.int32).contiguous()
        e, p, w, bias = (x.contiguous() for x in (e, p, w, bias))
        kw = dict(blank_id=blank_id, activation=activation, drop_t=drop_t, bt=bt)
        blank_lp, label_lp, lse = joint_flash_fwd(e, p, w, bias, tg, seed, t_lens=tl, u_lens=ul,
                                                  **kw)
        u1 = p.shape[1]
        label_lp[:, :, u1 - 1] = NEG_INF  # no label to emit at u = U
        alpha = alphas(blank_lp, label_lp, tl, ul)
        ll = log_likelihood(alpha, blank_lp, tl, ul)
        nll = -(1.0 + fastemit_lambda) * ll if fastemit_lambda > 0 else -ll
        ctx.save_for_backward(e, p, w, bias, tg, tl, ul, seed, blank_lp, label_lp, lse, alpha)
        ctx.args = (kw, fastemit_lambda, clamp, betas)
        return nll

    @staticmethod
    def backward(ctx, g):
        e, p, w, bias, tg, tl, ul, seed, blank_lp, label_lp, lse, alpha = ctx.saved_tensors
        kw, fastemit_lambda, clamp, betas = ctx.args
        beta = betas(blank_lp, label_lp, tl, ul)
        gb, gy = posteriors(alpha, beta, blank_lp, label_lp, tl, ul)
        if fastemit_lambda > 0:
            gy = gy * (1.0 + fastemit_lambda)
            gb = gb * (1.0 + fastemit_lambda)
        # K4-bwd reads the posteriors inside each lattice only
        de, dp, dw, db = joint_flash_bwd(
            e, p, w, bias, tg, lse, (gb + gy).contiguous(), gb.contiguous(), gy.contiguous(),
            g.float().contiguous(), seed, clamp=float(clamp), t_lens=tl, u_lens=ul, **kw)
        return (de.to(e.dtype), dp.to(p.dtype), dw.to(w.dtype), db.to(bias.dtype),
                None, None, None, None, None, None, None, None, None, None, None)


def rnnt_loss_fused(e, p, w, bias, targets, t_lens, u_lens, seed, blank_id: int,
                    fastemit_lambda: float = 0.0, clamp: float = -1.0,
                    lattice_impl: str = "auto", activation: str = "relu", drop_t: int = 0,
                    bt: int = 32) -> torch.Tensor:
    """Per-sample RNN-T nll [B] from the projected joint inputs; seed [1]
    int32 drives the in-kernel dropout (ignored when drop_t == 0)."""
    return RNNTLossFused.apply(e, p, w, bias, targets, t_lens, u_lens, seed, int(blank_id),
                               float(fastemit_lambda), float(clamp), lattice_impl, activation,
                               int(drop_t), int(bt))
