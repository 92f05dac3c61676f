"""Port flash-attention backward (K2-bwd) vs the JAX Pallas kernels (interpret mode).

On CPU tensors `flash_attention_bwd` runs its plain PyTorch version. It is
held against the JAX package's `_flash_bwd_entry` (the full-T dQ and dK/dV
kernels) and `_flash_bwd_streamed` (the two-sided-band family, forced with
`_VMEM_CAP_BYTES = 0`), called directly with interpret=True on the same
inputs, and end to end against `jax.vjp` through `flash_attention`. The CUDA
kernels are held against the plain version in test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.ops.pallas import flash_attention as fa
from conformer_nemo_tpu_torch.ops import flash_attention as port

torch.set_num_threads(2)

# fp32 on both sides; they differ in summation order only (tiles vs one
# dense product), worth a few ulp of the order-1 gradients
ATOL = 2e-5


def _inputs(seed, bh, t, d1, dv, lens):
    rng = np.random.RandomState(seed)
    qs, ks = rng.randn(bh, t, d1).astype(np.float32), rng.randn(bh, t, d1).astype(np.float32)
    v, do = rng.randn(bh, t, dv).astype(np.float32), rng.randn(bh, t, dv).astype(np.float32)
    return qs, ks, v, do, np.asarray(lens, np.int32)


def _fwd_residuals(qs, ks, v, do, lens, scale, left, right):
    """(lse [BH, T], delta [BH, T]) from the port's forward."""
    o, lse = port.flash_attention_fwd(*(torch.from_numpy(a) for a in (qs, ks, v, lens)),
                                      scale, left, right)
    delta = (torch.from_numpy(do) * o).sum(-1)
    return lse.numpy(), delta.numpy()


def _port_bwd(qs, ks, v, do, lse, delta, lens, scale, left, right):
    out = port.flash_attention_bwd(*(torch.from_numpy(a) for a in (qs, ks, v, do, lse, delta,
                                                                     lens)), scale, left, right)
    return [x.numpy() for x in out]


CASES = {
    # name: (t, d1, dv, lens, band); every case has a nonzero dO on query
    # rows past the length, and rows with lens 0 and 1
    "unbanded": (128, 80, 16, [128, 100, 1, 0], (-1, -1)),
    "one_sided_left": (128, 80, 16, [128, 90, 1, 0], (24, -1)),
    "one_sided_right": (128, 48, 16, [128, 90, 1, 0], (-1, 16)),
    "two_sided": (192, 80, 16, [192, 150, 1, 0], (48, 16)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_bwd_matches_jax_full_t_kernels(name):
    t, d1, dv, lens, (left, right) = CASES[name]
    qs, ks, v, do, lens = _inputs(0, len(lens), t, d1, dv, lens)
    scale = 0.25
    lse, delta = _fwd_residuals(qs, ks, v, do, lens, scale, left, right)
    want = fa._flash_bwd_entry(*(jnp.asarray(a) for a in (qs, ks, v, do)),
                               jnp.asarray(lse)[..., None], jnp.asarray(delta)[..., None],
                               jnp.asarray(lens), 64, 64, scale, True, left=left, right=right)
    got = _port_bwd(qs, ks, v, do, lse, delta, lens, scale, left, right)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=ATOL)
    assert np.all(got[0][1, lens[1]:] == 0.0)  # query rows past the length
    assert all(np.all(x[3] == 0.0) for x in got)  # lens = 0: nothing at all


@pytest.mark.parametrize("band", [(48, 16), (0, 40)])
def test_flash_bwd_matches_jax_streamed_kernels(band, monkeypatch):
    left, right = band
    monkeypatch.setattr(fa, "_VMEM_CAP_BYTES", 0)  # the streamed family
    t, d1, dv = 256, 48, 16
    assert fa._is_streamed(left, right, t, d1, dv)
    qs, ks, v, do, lens = _inputs(1, 3, t, d1, dv, [256, 170, 0])
    lse, delta = _fwd_residuals(qs, ks, v, do, lens, 0.2, left, right)
    want = fa._flash_bwd_streamed(*(jnp.asarray(a) for a in (qs, ks, v, do)),
                                  jnp.asarray(lse)[..., None], jnp.asarray(delta)[..., None],
                                  jnp.asarray(lens), 64, 64, 0.2, True, left, right)
    got = _port_bwd(qs, ks, v, do, lse, delta, lens, 0.2, left, right)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=ATOL)


@pytest.mark.parametrize("band", [(-1, -1), (24, -1), (32, 16)])
def test_flash_attention_function_matches_jax_vjp(band):
    """The autograd.Function end to end (forward, delta, backward) against
    jax.vjp through `flash_attention` with the same cotangent."""
    import jax

    qs, ks, v, do, lens = _inputs(2, 3, 128, 48, 16, [128, 70, 1])
    f = lambda a, b, c: fa.flash_attention(a, b, c, jnp.asarray(lens), 64, 64, 0.25, True,
                                           *band)
    o_j, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (qs, ks, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (qs, ks, v))
    o = port.flash_attention(tq, tk, tv, torch.from_numpy(lens), 0.25, *band)
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j), rtol=0, atol=ATOL)
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_flash_bwd_plain_version_caps_p_at_one():
    """An lse below a visible score by more than exp's fp32 range (what a
    forward and a backward that sum the same products in different orders
    can leave at scores past 2^24) gives P = 1, not inf: the backward stays
    finite, and a row with one visible key keeps dV = dO there."""
    qs, ks, v, do, lens = (torch.from_numpy(a) for a in _inputs(5, 2, 16, 8, 4, [16, 1]))
    o, lse = port.flash_attention_fwd(qs, ks, v, lens, 0.5)
    delta = (do * o).sum(-1)
    low = lse - 200.0
    assert not torch.isfinite(torch.exp(qs[1, 0] @ ks[1, 0] * 0.5 - low[1, 0]))
    got = port.flash_attention_bwd(qs, ks, v, do, low, delta, lens, 0.5)
    assert all(bool(torch.isfinite(x).all()) for x in got)
    want = port.flash_attention_bwd(qs, ks, v, do, lse, delta, lens, 0.5)
    assert torch.equal(got[2][1], want[2][1]) and torch.equal(got[2][1, 0], do[1, 0])


def test_flash_attention_gradcheck_fp64():
    """torch.autograd.gradcheck of the plain path in fp64. Query rows past
    the length are padding whose gradient the backward drops, so the output
    is masked there, as the model masks it."""
    rng = np.random.RandomState(3)
    bh, t, d1, dv = 2, 9, 8, 8
    lens = torch.tensor([9, 5], dtype=torch.int32)
    valid = (torch.arange(t)[None, :] < lens[:, None])[..., None]
    args = [torch.from_numpy(rng.randn(bh, t, d)).requires_grad_() for d in (d1, d1, dv)]
    for band in ((-1, -1), (2, 1)):
        fn = lambda q, k, v: port.flash_attention(q, k, v, lens, 0.5, *band) * valid
        assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-6)


def test_flash_bwd_wrapper_checks_and_counts():
    qs, ks, v, do, lens = (torch.from_numpy(a) for a in _inputs(4, 2, 16, 8, 8, [16, 3]))
    lse, delta = torch.zeros(2, 16), torch.zeros(2, 16)
    before = (port.dq_launches.total, port.dkv_launches.total)
    port.flash_attention_bwd(qs, ks, v, do, lse, delta, lens, 1.0)
    assert (port.dq_launches.total, port.dkv_launches.total) == before  # plain, not a launch
    with pytest.raises(ValueError):
        port.flash_attention_bwd(qs, ks, v, do[:, :8], lse, delta, lens, 1.0)
    with pytest.raises(ValueError):
        port.flash_attention_bwd(qs, ks, v, do, lse[:, :8], delta, lens, 1.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_bwd_kernel_wrappers_match_jax_on_cpu(name):
    """The dQ and the dK/dV wrappers alone, on CPU tensors: their plain
    versions' pieces, against the JAX package's dQ and dK/dV kernels."""
    t, d1, dv, lens, (left, right) = CASES[name]
    qs, ks, v, do, lens = _inputs(4, len(lens), t, d1, dv, lens)
    lse, delta = _fwd_residuals(qs, ks, v, do, lens, 0.25, left, right)
    want = fa._flash_bwd_entry(*(jnp.asarray(a) for a in (qs, ks, v, do)),
                               jnp.asarray(lse)[..., None], jnp.asarray(delta)[..., None],
                               jnp.asarray(lens), 64, 64, 0.25, True, left=left, right=right)
    args = [torch.from_numpy(a) for a in (qs, ks, v, do, lse, delta, lens)]
    before = (port.dq_launches.total, port.dkv_launches.total)
    dq = port.flash_attention_bwd_dq(*args, 0.25, left, right)
    dk, dv_ = port.flash_attention_bwd_dkv(*args, 0.25, left, right)
    assert (port.dq_launches.total, port.dkv_launches.total) == before  # plain, not a launch
    for g, w in zip((dq, dk, dv_), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


class _Limits:
    """Stand-in for the flash libraries' limit queries (the layouts are the
    card's; this holds the wrappers' use of them)."""

    def __init__(self, dq_max_d1, dkv_max_d1, fwd_smem=1000):
        self.flash_attention_bwd_dq_max_d1 = lambda dv: dq_max_d1
        self.flash_attention_bwd_dkv_max_d1 = lambda dv: dkv_max_d1
        self.flash_attention_fwd_smem_bytes = lambda d1, dv: fwd_smem


@pytest.mark.parametrize("d1,dq_max_d1,dkv_max_d1,refused", [
    (576, 1000, 1000, None),
    (1152, 1600, 1616, None),  # XLarge's depth at dv 128, the libraries' limits there
    (576, 568, 1000, "dQ kernel keeps its query rows"),
    (584, 1000, 576, "dK/dV kernel keeps its key rows"),
])
def test_flash_bwd_limits_are_per_kernel(monkeypatch, d1, dq_max_d1, dkv_max_d1, refused):
    """Each backward kernel is held to its own limits, and the whole
    backward checks both before either launches."""
    monkeypatch.setattr(port, "load", lambda source: _Limits(dq_max_d1, dkv_max_d1))
    bf = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)
    dv = 128 if d1 == 1152 else 64
    args = (bf(2, 64, d1), bf(2, 64, d1), bf(2, 64, dv), bf(2, 64, dv), torch.zeros(2, 64),
            torch.zeros(2, 64), torch.tensor([64, 3], dtype=torch.int32))
    if refused is None:
        port._check_bwd_cuda(*args, ("dq", "dkv"))
        return
    with pytest.raises(ValueError, match=refused):
        port._check_bwd_cuda(*args, ("dq", "dkv"))
    which = "dq" if "dQ" in refused else "dkv"
    port._check_bwd_cuda(*args, ({"dq": "dkv", "dkv": "dq"}[which],))  # the other one passes


@pytest.mark.parametrize("fwd_smem,refused", [(232448, False), (232449, True)])
def test_flash_fwd_refuses_past_its_shared_memory(monkeypatch, fwd_smem, refused):
    """The forward checks the library's `flash_attention_fwd_smem_bytes`
    against a block's shared memory before it launches."""
    monkeypatch.setattr(port, "load", lambda source: _Limits(1000, 1000, fwd_smem=fwd_smem))
    bf = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)
    args = (bf(2, 64, 1160), bf(2, 64, 1160), bf(2, 64, 128), torch.tensor([64, 3],
                                                                          dtype=torch.int32))
    if not refused:
        port._check_fwd_cuda(*args)
        return
    with pytest.raises(ValueError, match="flash_attention_fwd_smem_bytes"):
        port._check_fwd_cuda(*args)
