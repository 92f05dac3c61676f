"""K2 (flash attention) at every head width and dtype the JAX package runs,
against its Pallas kernels in interpret mode.

On CPU tensors the port's wrappers run the plain versions; these hold them
against the JAX package's `_flash_fwd_entry` / `_flash_bwd_entry` at
Conformer-CTC Small's heads (d1 = 44 + 176 = 220, dv = 44: not multiples of
8), at XLarge's (d1 = 128 + 1024 = 1152, dv = 128) and at the flagship's
(576, 64) in fp16 and fp32. The CUDA kernels take widths in multiples of 8:
the wrappers pad with zero columns and slice back (`pad_fwd`, `pad_bwd`),
held here bit for bit on the CPU with the plain version standing in for
the launch (the encoder at these widths: test_torch_flash_widths_encoder.py).

Tolerances: fp32 2e-5 absolute (the flash tests' ATOL: summation order,
tiles against one dense product); fp16 2e-3 of the largest magnitude
(outputs rounded to fp16's 11 bits on both sides, from fp32 sums in
different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.ops.pallas import flash_attention as jfa
from conformer_nemo_tpu_torch.ops import flash_attention as port

torch.set_num_threads(2)

ATOL = 2e-5
F16_REL = 2e-3

# name: (d1, dv, dtype)
WIDTHS = {
    "small_220_44_fp32": (220, 44, np.float32),
    "xlarge_1152_128_fp32": (1152, 128, np.float32),
    "flagship_576_64_fp32": (576, 64, np.float32),
    "flagship_576_64_fp16": (576, 64, np.float16),
}
T = 64
LENS = np.array([64, 37], np.int32)


def _inputs(seed, d1, dv, dtype):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(2, T, d).astype(dtype) for d in (d1, d1, dv, dv))


def _assert_close(got, want, dtype, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == np.float16:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= F16_REL, (what, err)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_flash_fwd_matches_jax_at_width(name):
    d1, dv, dtype = WIDTHS[name]
    qs, ks, v, _ = _inputs(0, d1, dv, dtype)
    scale = 1.0 / np.sqrt(dv)
    o_j, lse_j = jfa._flash_fwd_entry(*(jnp.asarray(a) for a in (qs, ks, v, LENS)), 64, 64,
                                      scale, True, with_lse=True)
    o, lse = port.flash_attention_fwd(*(torch.from_numpy(a) for a in (qs, ks, v, LENS)), scale)
    assert o.dtype == torch.from_numpy(qs).dtype and lse.dtype == torch.float32
    _assert_close(o.float().numpy(), o_j, dtype, "o")
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[..., 0], rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_flash_bwd_matches_jax_at_width(name):
    d1, dv, dtype = WIDTHS[name]
    qs, ks, v, do = _inputs(1, d1, dv, dtype)
    scale = 1.0 / np.sqrt(dv)
    t_in = [torch.from_numpy(a) for a in (qs, ks, v, do, LENS)]
    o, lse = port.flash_attention_fwd(t_in[0], t_in[1], t_in[2], t_in[4], scale)
    delta = (t_in[3].float() * o.float()).sum(-1)
    got = port.flash_attention_bwd(*t_in[:4], lse, delta, t_in[4], scale)
    want = jfa._flash_bwd_entry(*(jnp.asarray(a) for a in (qs, ks, v, do)),
                                jnp.asarray(lse.numpy())[..., None],
                                jnp.asarray(delta.numpy())[..., None], jnp.asarray(LENS), 64, 64,
                                scale, True)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == t_in[0].dtype
        _assert_close(g.float().numpy(), w, dtype, what)
    assert np.all(got[0][1, LENS[1]:].float().numpy() == 0.0)  # query rows past the length


def _dyadic(rng, *shape):
    """Quarters in [-1, 1]: every score is an exact sum in fp32 whatever its
    order or its zero terms, so padding can change no bit of it."""
    return torch.from_numpy((rng.randint(-4, 5, shape) / 4.0).astype(np.float32))


@pytest.mark.parametrize("d1,dv,band", [(220, 44, (-1, -1)), (1150, 126, (-1, -1)),
                                        (220, 44, (12, 4)), (576, 64, (-1, -1))])
def test_pad_and_slice_equals_the_unpadded_plain_version_bit_for_bit(d1, dv, band):
    """The CUDA route's padding, with the plain version in the launch's
    place: o, lse, dq, dk and dv equal the unpadded plain version's bits,
    and the launch saw multiples of 8 and was keyed at the caller's widths."""
    rng = np.random.RandomState(2)
    qs, ks, v, do = _dyadic(rng, 2, 48, d1), _dyadic(rng, 2, 48, d1), \
        _dyadic(rng, 2, 48, dv), _dyadic(rng, 2, 48, dv)
    lens = torch.tensor([48, 29], dtype=torch.int32)
    seen = []

    def fwd(qs_, ks_, v_, lens_, scale, left, right, key):
        seen.append((qs_.shape[-1], v_.shape[-1], key))
        return port.flash_attention_fwd_reference(qs_, ks_, v_, lens_, scale, left, right)

    def bwd(*args, key):
        seen.append((args[0].shape[-1], args[2].shape[-1], key))
        return port.flash_attention_bwd_reference(*args)

    o, lse = port.pad_fwd(fwd, qs, ks, v, lens, 0.125, *band)
    o_ref, lse_ref = port.flash_attention_fwd_reference(qs, ks, v, lens, 0.125, *band)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    delta = (do * o).sum(-1)
    args = (qs, ks, v, do, lse, delta, lens, 0.125, *band)
    grads = port.pad_bwd(bwd, "qkv", *args)
    for g, w in zip(grads, port.flash_attention_bwd_reference(*args)):
        assert g.shape == w.shape and torch.equal(g, w)
    dkv = port.pad_bwd(lambda *a, key: port.flash_attention_bwd_reference(*a)[1:], "kv", *args)
    assert all(torch.equal(g, w) for g, w in zip(dkv, grads[1:]))
    key = (2, 48, d1, dv, *band)
    assert seen == [(port.padded(d1), port.padded(dv), key)] * 2
    assert port.padded(d1) % 8 == 0 and port.padded(dv) % 8 == 0
