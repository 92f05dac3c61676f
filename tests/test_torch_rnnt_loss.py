"""The port's RNN-T loss from logits against the JAX package's
`rnnt_loss_from_logits` / `rnnt_loss`.

Same logits (seeded numpy), ragged lengths with a u_len = 0 row; value and
gradient with respect to the logits under a non-uniform upstream gradient,
FastEmit 0 and 0.1, clamp -1 and 2, every reduction, and both lattice
implementations. Tolerance: relative 1e-5 on the loss, 1e-5 absolute and
relative on the gradient (fp32 on both sides; softmax and the lattice in
the same order of operations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.ops import rnnt_loss as jax_rl
from conformer_nemo_tpu_torch.ops import rnnt_loss as port

TOL = 1e-5


def _case(seed=0, b=3, t=8, u=4, v=9):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, t, u + 1, v) * 2.0).astype(np.float32)
    targets = rng.randint(0, v - 1, (b, u)).astype(np.int32)
    t_lens = np.array([t, t - 2, 3], np.int32)
    u_lens = np.array([u, 2, 0], np.int32)
    return logits, targets, t_lens, u_lens, v - 1


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("fastemit,clamp", [(0.0, -1.0), (0.1, -1.0), (0.0, 2.0), (0.1, 2.0)])
def test_loss_and_grad_match_jax(impl, fastemit, clamp):
    logits, targets, tl, ul, blank = _case()
    cot = np.array([1.0, 0.5, 2.0], np.float32)

    def jax_loss(lg):
        return jnp.sum(jnp.asarray(cot) * jax_rl.rnnt_loss_from_logits(
            lg, jnp.asarray(targets), jnp.asarray(tl), jnp.asarray(ul), blank, fastemit, clamp,
            "scan"))

    want, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    nll = port.rnnt_loss_from_logits(lg, torch.from_numpy(targets), torch.from_numpy(tl),
                                     torch.from_numpy(ul), blank, fastemit, clamp, impl)
    got = (torch.from_numpy(cot) * nll).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_g), rtol=TOL, atol=TOL)
    if clamp > 0:
        assert lg.grad.abs().max().item() <= clamp * cot.max() + 1e-6


@pytest.mark.parametrize("reduction", ["mean_batch", "sum", "mean", "none"])
def test_reductions_match_jax(reduction):
    logits, targets, tl, ul, blank = _case(seed=1)
    want = jax_rl.rnnt_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(tl),
                            jnp.asarray(ul), blank_id=blank, reduction=reduction)
    got = port.rnnt_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                         torch.from_numpy(tl), torch.from_numpy(ul), blank_id=blank,
                         reduction=reduction)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL)


def test_prep_matches_jax():
    logits, targets, _, _, blank = _case(seed=2)
    want = jax_rl._prep(jnp.asarray(logits), jnp.asarray(targets), blank)
    got = port.prep(torch.from_numpy(logits), torch.from_numpy(targets), blank)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)


def test_loss_refuses_unknown_options():
    logits, targets, tl, ul, blank = _case()
    args = [torch.from_numpy(x) for x in (logits, targets, tl, ul)]
    with pytest.raises(ValueError, match="reduction"):
        port.rnnt_loss(*args, blank_id=blank, reduction="avg")
    with pytest.raises(ValueError, match="impl"):
        port.rnnt_loss(*args, blank_id=blank, impl="pallas")
