"""The port's RNN-T lattice (K3) against the JAX package.

`rnnt_alphas` / `rnnt_betas` on CPU tensors run their plain versions; they
are held against `_compute_alphas` / `_compute_betas` of
conformer_nemo_tpu/ops/rnnt_loss.py with both the "scan" path and the
"pallas" path (the Pallas kernels in interpret mode on the CPU), on the
same log-probs from a seeded numpy generator: ragged lengths, a u_len = 0
row and a t_len = 1 row. Tolerance: rtol and atol 1e-5 (fp32 on both
sides; the recursions take the same operations in the same order, and the
two libraries' exp/log differ in the last bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.ops import rnnt_loss as jax_rl
from conformer_nemo_tpu_torch.ops import rnnt_lattice as port

TOL = 1e-5


def _case(seed, b=4, t=9, u=5, v=7):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t, u + 1, v).astype(np.float32) * 2.0
    targets = rng.randint(0, v - 1, (b, u)).astype(np.int32)
    t_lens = np.array([t, t - 3, 1, t - 1][:b], np.int32)
    u_lens = np.array([u, u - 2, 0, 0][:b], np.int32)  # a t_len = 1 and a u_len = 0 row
    blank_lp, label_lp, _ = jax_rl._prep(jnp.asarray(logits), jnp.asarray(targets), v - 1)
    return np.array(blank_lp), np.array(label_lp), t_lens, u_lens


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("seed", [0, 1])
def test_lattice_matches_jax(impl, seed):
    bl, lb, tl, ul = _case(seed)
    want_a = jax_rl._compute_alphas(*(jnp.asarray(x) for x in (bl, lb, tl, ul)), impl)
    want_b = jax_rl._compute_betas(*(jnp.asarray(x) for x in (bl, lb, tl, ul)), impl)
    args = [torch.from_numpy(x) for x in (bl, lb, tl, ul)]
    got_a = port.rnnt_alphas(*args)
    got_b = port.rnnt_betas(*args)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=TOL, atol=TOL)
    # alpha at the terminal cell + its blank and beta[0, 0] are the same log-likelihood
    bi = np.arange(len(tl))
    ll_a = got_a.numpy()[bi, tl - 1, ul] + bl[bi, tl - 1, ul]
    np.testing.assert_allclose(ll_a, got_b.numpy()[:, 0, 0], rtol=TOL, atol=TOL)


def test_lattice_outside_cells_and_wide_rows():
    """Outside each sample's lattice both outputs hold the -1e30 sentinel;
    U+1 wider than T (the wavefront is then longer than T) still agrees."""
    rng = np.random.RandomState(3)
    b, t, u1 = 2, 3, 12
    bl = np.log(rng.uniform(0.1, 0.9, (b, t, u1))).astype(np.float32)
    lb = np.log(rng.uniform(0.1, 0.9, (b, t, u1))).astype(np.float32)
    tl, ul = np.array([3, 2], np.int32), np.array([11, 4], np.int32)
    got = port.rnnt_alphas(*(torch.from_numpy(x) for x in (bl, lb, tl, ul))).numpy()
    want = np.asarray(jax_rl._compute_alphas(*(jnp.asarray(x) for x in (bl, lb, tl, ul)),
                                             "scan"))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (got[1, 2:] == -1e30).all() and (got[1, :, 5:] == -1e30).all()


def test_lattice_wrappers_check_inputs():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="shapes"):
        port.rnnt_alphas(x, torch.zeros(2, 3, 5), torch.ones(2, dtype=torch.int32),
                         torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[B\]"):
        port.rnnt_betas(x, x, torch.ones(3, dtype=torch.int32), torch.ones(2, dtype=torch.int32))
