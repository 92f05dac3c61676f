"""Port CTC loss vs the JAX package: the plain recursion against
`ctc_forward_neg_log_likelihood` (the `lax.scan` version, differentiated by
autograd on both sides), and the kernel path (K1-fwd/bwd, whose plain
versions run on CPU tensors) against `ctc_loss_pallas` in interpret mode.

Tolerances: fp32 both sides. nll relative 1e-6 (summation order of a few
dozen log-sum-exp steps). Gradients absolute 5e-6: each is exp(alpha +
beta - ll) over log-values of order 10-50, whose fp32 rounding (~ulp(50)
= 4e-6) differs between the two orders of summation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.ops.ctc_loss import ctc_forward_neg_log_likelihood as jax_nll
from conformer_nemo_tpu.ops.ctc_loss import ctc_loss as jax_ctc_loss
from conformer_nemo_tpu.ops.pallas.ctc_kernel import ctc_loss_pallas
from conformer_nemo_tpu_torch.ops import ctc_loss as port

torch.set_num_threads(2)

NLL_RTOL = 1e-6
GRAD_ATOL = 5e-6


def _case(seed=0, b=6, t=20, v1=7, u=5):
    """Rows: full, repeats and a short input, U = 0, an infeasible alignment
    (5 labels with repeats in 4 frames), a 1-frame zero row with U = 0."""
    rng = np.random.RandomState(seed)
    lp = rng.randn(b, t, v1).astype(np.float32) * 2
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    tg = rng.randint(0, v1 - 1, (b, u)).astype(np.int32)
    tg[1, :3] = 2  # repeats need a blank between them
    tg[3, :] = [1, 1, 2, 2, 3]
    il = np.array([20, 11, 20, 4, 20, 1][:b], np.int32)
    tl = np.array([5, 4, 0, 5, 3, 0][:b], np.int32)
    return lp, tg, il, tl, v1 - 1


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _port_nll_grad(fn, lp, tg, il, tl, blank, g):
    x = torch.from_numpy(lp).requires_grad_()
    nll = fn(x, *_t(tg, il, tl), blank)
    (nll * torch.from_numpy(g)).sum().backward()
    return nll.detach().numpy(), x.grad.numpy()


def _jax_nll_grad(fn, lp, tg, il, tl, blank, g):
    f = lambda x: fn(x, *(jnp.asarray(a) for a in (tg, il, tl)), blank)
    nll, vjp = jax.vjp(f, jnp.asarray(lp))
    return np.asarray(nll), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("path", ["plain_vs_scan", "kernel_vs_pallas"])
def test_ctc_nll_and_grad_match_jax(path):
    lp, tg, il, tl, blank = _case()
    g = np.random.RandomState(1).rand(len(il)).astype(np.float32)
    if path == "plain_vs_scan":
        got = _port_nll_grad(port.ctc_forward_neg_log_likelihood, lp, tg, il, tl, blank, g)
        want = _jax_nll_grad(jax_nll, lp, tg, il, tl, blank, g)
    else:
        got = _port_nll_grad(port.CTCLossKernel.apply, lp, tg, il, tl, blank, g)
        want = _jax_nll_grad(lambda *a: ctc_loss_pallas(*a, True), lp, tg, il, tl, blank, g)
    feasible = np.array([True, True, True, False, True, True])
    np.testing.assert_allclose(got[0][feasible], want[0][feasible], rtol=NLL_RTOL)
    assert got[0][3] >= 1e29 and want[0][3] >= 1e29  # the -1e30 sentinel, finite
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=GRAD_ATOL)
    assert np.all(got[1][1, 11:] == 0.0)  # nothing past the input length


def test_ctc_kernel_plain_versions_match_the_pallas_kernels_directly():
    """K1-fwd's alphas and K1-bwd's gradient against `_ctc_fwd` / `_ctc_bwd`."""
    from conformer_nemo_tpu.ops.pallas import ctc_kernel as ck

    lp, tg, il, tl, blank = _case(seed=2)
    g = np.ones(len(il), np.float32)
    nll_j, res = ck._ctc_fwd(*(jnp.asarray(a) for a in (lp, tg, il, tl)), blank, True)
    grad_j = ck._ctc_bwd(blank, True, res, jnp.asarray(g))[0]
    alphas, nll = port.ctc_alphas(*_t(lp, tg, il, tl), blank)
    grad = port.ctc_grad(*_t(lp, tg, il, tl), alphas, nll, torch.from_numpy(g), blank)
    lattice = np.arange(alphas.shape[2])[None, None, :] < (2 * tl + 1)[:, None, None]
    np.testing.assert_allclose(np.where(lattice, alphas.numpy(), 0),
                               np.where(lattice, np.asarray(res[4]), 0), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(nll.numpy()[tl <= il], np.asarray(nll_j)[tl <= il], rtol=NLL_RTOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), rtol=0, atol=GRAD_ATOL)


def test_ctc_bf16_input_upcasts_like_jax():
    lp, tg, il, tl, blank = _case(seed=3)
    lp_bf16 = torch.from_numpy(lp).to(torch.bfloat16)
    x = lp_bf16.clone().requires_grad_()
    nll = port.CTCLossKernel.apply(x, *_t(tg, il, tl), blank)
    nll[tl <= il].sum().backward()
    want = jax_nll(jnp.asarray(lp_bf16.float().numpy()).astype(jnp.bfloat16),
                   *(jnp.asarray(a) for a in (tg, il, tl)), blank)
    assert x.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(nll.detach().numpy()[tl <= il], np.asarray(want)[tl <= il],
                               rtol=NLL_RTOL)


@pytest.mark.parametrize("reduction", ["mean_batch", "mean", "sum", "none"])
@pytest.mark.parametrize("zero_infinity", [False, True])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_ctc_loss_reductions_match_jax(reduction, zero_infinity, impl):
    lp, tg, il, tl, blank = _case(seed=4)
    got = port.ctc_loss(*_t(lp, tg, il, tl), blank_id=blank, reduction=reduction,
                        zero_infinity=zero_infinity, impl=impl).numpy()
    want = np.asarray(jax_ctc_loss(*(jnp.asarray(a) for a in (lp, tg, il, tl)), blank_id=blank,
                                   reduction=reduction, zero_infinity=zero_infinity))
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)


def test_ctc_wrappers_check_and_count():
    lp, tg, il, tl, blank = _case()
    before = (port.alpha_launches.total, port.grad_launches.total)
    port.ctc_alphas(*_t(lp, tg, il, tl), blank)
    assert (port.alpha_launches.total, port.grad_launches.total) == before  # plain, no launch
    with pytest.raises(ValueError):
        port.ctc_alphas(*_t(lp, tg[:3], il, tl), blank)
    with pytest.raises(ValueError):
        port.ctc_loss(*_t(lp, tg, il, tl), blank_id=blank, impl="scan")


@pytest.mark.parametrize("seed", [2, 5])
def test_ctc_backward_pieces(seed):
    """K1-bwd's betas and K1-bwd-grad's collect, the plain pieces of the
    backward: alpha + beta gives the same log-likelihood at every frame
    inside a feasible row (forward-backward), the label chains link each
    label position to its next equal label, and the pieces' gradient matches
    the Pallas kernels' `_ctc_bwd`. Rows: repeats, U = 0, an infeasible one,
    a 1-frame one."""
    from conformer_nemo_tpu.ops.pallas import ctc_kernel as ck

    lp, tg, il, tl, blank = _case(seed=seed)
    g = np.random.RandomState(seed).rand(len(il)).astype(np.float32)
    alphas, nll = port.ctc_alphas(*_t(lp, tg, il, tl), blank)
    betas, chains = port.ctc_betas(*_t(lp, tg, il, tl), blank)
    grad = port.ctc_collect(*_t(lp, tg, il, tl), alphas, betas, chains, nll, torch.from_numpy(g),
                            blank)
    for b in range(len(il)):
        s_len = 2 * tl[b] + 1
        if tl[b] > il[b]:  # infeasible
            continue
        per_t = torch.logsumexp((alphas[b] + betas[b])[: il[b], :s_len], dim=1).numpy()
        np.testing.assert_allclose(per_t, -nll[b].item(), rtol=1e-5)
        for i in range(tg.shape[1]):
            same = [j for j in range(tl[b]) if tg[b, j] == tg[b, i]]
            nxt = [j for j in same if j > i]
            want = (nxt[0] if nxt else -1, int(i == same[0])) if i < tl[b] else (-1, 0)
            assert tuple(chains[b, :, i].tolist()) == want, (b, i)
    _, res = ck._ctc_fwd(*(jnp.asarray(a) for a in (lp, tg, il, tl)), blank, True)
    want = ck._ctc_bwd(blank, True, res, jnp.asarray(g))[0]
    np.testing.assert_allclose(grad.numpy(), np.asarray(want), rtol=0, atol=GRAD_ATOL)
