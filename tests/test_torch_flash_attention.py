"""Port flash attention forward vs the JAX Pallas kernel (interpret mode).

On CPU tensors `flash_attention_fwd` runs its plain PyTorch version; it is
held against the JAX package's `_flash_vjp_fwd` (the forward half of the
custom VJP, which returns o and the per-row lse) run with interpret=True,
for both TPU kernel families: the full-T kernel and, forced through
`_VMEM_CAP_BYTES = 0`, the streamed two-sided-band kernel. The CUDA kernel
itself is held against the plain version in test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

from conformer_nemo_tpu.ops.pallas import flash_attention as fa
from conformer_nemo_tpu_torch.ops import flash_attention as port

torch.set_num_threads(2)

# fp32 on both sides; the two differ only in summation order (online
# softmax over tiles vs one dense softmax), worth a few ulp of the unit-scale
# outputs
ATOL = 2e-5


def _inputs(seed, bh, t, d1, dv, lens):
    rng = np.random.RandomState(seed)
    qs = rng.randn(bh, t, d1).astype(np.float32)
    ks = rng.randn(bh, t, d1).astype(np.float32)
    v = rng.randn(bh, t, dv).astype(np.float32)
    return qs, ks, v, np.asarray(lens, np.int32)


def _jax_fwd(qs, ks, v, lens, scale, left, right, bq=64, bk=64):
    import jax.numpy as jnp

    o, res = fa._flash_vjp_fwd(jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(v),
                               jnp.asarray(lens), bq, bk, scale, True, left, right)
    return np.asarray(o), np.asarray(res[-1])[..., 0]


def _port_fwd(qs, ks, v, lens, scale, left, right):
    o, lse = port.flash_attention_fwd(torch.from_numpy(qs), torch.from_numpy(ks),
                                      torch.from_numpy(v), torch.from_numpy(lens),
                                      scale, left, right)
    return o.numpy(), lse.numpy()


CASES = {
    # name: (t, d1, dv, lens, band)
    "unbanded": (128, 80, 16, [128, 100, 37], (-1, -1)),
    "one_sided_left": (128, 80, 16, [128, 90, 5], (24, -1)),
    "one_sided_right": (128, 48, 16, [128, 90, 5], (-1, 16)),
    "two_sided": (192, 80, 16, [192, 150, 40], (48, 16)),
    "empty_row": (64, 32, 16, [64, 0, 1], (-1, -1)),
    "ragged_t": (100, 80, 24, [100, 63, 64], (-1, -1)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_fwd_matches_jax_full_t_kernel(name, monkeypatch):
    t, d1, dv, lens, (left, right) = CASES[name]
    monkeypatch.setattr(fa, "_VMEM_CAP_BYTES", 10**15)  # the full-T kernel family
    qs, ks, v, lens = _inputs(0, len(lens), t, d1, dv, lens)
    scale = 1.0 / np.sqrt(16.0)
    o_j, lse_j = _jax_fwd(qs, ks, v, lens, scale, left, right)
    o_p, lse_p = _port_fwd(qs, ks, v, lens, scale, left, right)
    np.testing.assert_allclose(o_p, o_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse_p, lse_j, rtol=0, atol=ATOL)
    if name == "empty_row":  # no visible key: o = 0 and lse = 0 exactly
        assert np.all(o_p[1] == 0.0) and np.all(lse_p[1] == 0.0)


@pytest.mark.parametrize("band", [(48, 16), (0, 40), (96, 32)])
def test_flash_fwd_matches_jax_streamed_kernel(band, monkeypatch):
    left, right = band
    monkeypatch.setattr(fa, "_VMEM_CAP_BYTES", 0)  # force the streamed family
    t, d1, dv = 256, 48, 16
    assert fa._is_streamed(left, right, t, d1, dv)
    qs, ks, v, lens = _inputs(1, 3, t, d1, dv, [256, 170, 0])
    o_j, lse_j = _jax_fwd(qs, ks, v, lens, 0.2, left, right)
    o_p, lse_p = _port_fwd(qs, ks, v, lens, 0.2, left, right)
    np.testing.assert_allclose(o_p, o_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse_p, lse_j, rtol=0, atol=ATOL)


def test_flash_fwd_wrapper_checks_and_counts():
    qs, ks, v, lens = (torch.from_numpy(a) for a in _inputs(2, 2, 16, 8, 8, [16, 3]))
    before = port.fwd_launches.total
    port.flash_attention_fwd(qs, ks, v, lens, 1.0)
    assert port.fwd_launches.total == before  # the plain version is not a kernel launch
    with pytest.raises(ValueError):
        port.flash_attention_fwd(qs, ks[:, :8], v, lens, 1.0)
    with pytest.raises(ValueError):
        port.flash_attention_fwd(qs, ks, v, lens[:1], 1.0)
