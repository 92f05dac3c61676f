"""The port's flash joint (K4) against the JAX package's Pallas kernels.

On CPU tensors `joint_flash_fwd` / `joint_flash_bwd` run their plain
versions; the JAX side runs `joint_flash_fwd` / `joint_flash_bwd` with
`interpret=True`. Same seeded numpy inputs; relu, tanh and sigmoid; bt 4
and 16 with T not a multiple of bt; dropout on and off; FastEmit-scaled
posteriors and clamp 2. Tolerances: fp32 1e-5 (relative and absolute; the
same products and reductions in another order); bf16 within rounding (both
round the logits, dlogits, dh and dx to bf16 at the same points, so a
value can differ by one bf16 ulp where a sum lands on a rounding boundary:
outputs are held to 2e-2 of their largest magnitude). The dropout mask is
compared bit for bit, and the hash by itself on indices past 2^32. The
port's functions take each sample's lattice lengths: with full lengths
every cell is compared; with ragged ones the cells inside the lattice
match JAX, the forward writes its sentinels outside, and the backward
ignores whatever the posteriors hold there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.ops.pallas import rnnt_joint_kernel as jk
from conformer_nemo_tpu_torch.ops import rnnt_joint as port

F32_TOL = 1e-5
BF16_REL = 2e-2


def _inputs(seed=0, b=2, t=7, u=3, h=16, v=13):
    rng = np.random.RandomState(seed)
    return dict(
        e=(rng.randn(b, t, h) * 0.5).astype(np.float32),
        p=(rng.randn(b, u + 1, h) * 0.5).astype(np.float32),
        w=(rng.randn(h, v) * 0.3).astype(np.float32),
        bias=(rng.randn(v) * 0.1).astype(np.float32),
        targets=rng.randint(0, v - 1, (b, u)).astype(np.int32),
        lse=rng.randn(b, t, u + 1).astype(np.float32) + 3.0,
        total=rng.uniform(0, 1.1, (b, t, u + 1)).astype(np.float32),
        gb=rng.uniform(0, 0.6, (b, t, u + 1)).astype(np.float32),
        gy=rng.uniform(0, 0.6, (b, t, u + 1)).astype(np.float32),
        g=np.array([1.0, 0.5], np.float32)[:b],
    )


DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _both(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _run(d, dtype, activation, bt, drop_t, clamp=-1.0, seed=12345, lens=None):
    """-> JAX forward and backward, port forward and backward. `lens` (t_lens,
    u_lens) for the port, default full; JAX gets the posteriors zeroed
    outside them, the port gets them as they are."""
    v = d["w"].shape[1]
    b, t, u1 = d["lse"].shape
    if lens is None:
        lens = ([t] * b, [u1 - 1] * b)
    tl, ul = (torch.tensor(x, dtype=torch.int32) for x in lens)
    inside = port.valid_cells((b, t, u1), tl, ul).numpy()
    jx, tx = {}, {}
    for k in ("e", "p", "w", "bias"):
        jx[k], tx[k] = _both(d[k], dtype)
    for k in ("lse", "total", "gb", "gy", "g"):
        jx[k], tx[k] = jnp.asarray(d[k]), torch.from_numpy(d[k])
    for k in ("total", "gb", "gy"):
        jx[k] = jnp.asarray(np.where(inside, d[k], 0.0))
    jx["targets"], tx["targets"] = jnp.asarray(d["targets"]), torch.from_numpy(d["targets"])
    jseed, tseed = jnp.asarray([seed], jnp.int32), torch.tensor([seed], dtype=torch.int32)
    kw = dict(blank_id=v - 1, activation=activation, drop_t=drop_t, bt=bt)
    want_f = jk.joint_flash_fwd(jx["e"], jx["p"], jx["w"], jx["bias"], jx["targets"], jseed,
                                interpret=True, **kw)
    got_f = port.joint_flash_fwd(tx["e"], tx["p"], tx["w"], tx["bias"], tx["targets"], tseed,
                                 t_lens=tl, u_lens=ul, **kw)
    args = [x[k] for x in (jx,) for k in ("e", "p", "w", "bias", "targets", "lse", "total",
                                          "gb", "gy", "g")]
    want_b = jk.joint_flash_bwd(*args, jseed, clamp=clamp, interpret=True, **kw)
    got_b = port.joint_flash_bwd(*[tx[k] for k in ("e", "p", "w", "bias", "targets", "lse",
                                                   "total", "gb", "gy", "g")], tseed,
                                 clamp=clamp, t_lens=tl, u_lens=ul, **kw)
    return want_f, got_f, want_b, got_b


def _np(x):
    return np.asarray(jax.device_get(x)).astype(np.float32) if not torch.is_tensor(x) else \
        x.float().numpy()


@pytest.mark.parametrize("activation", ["relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("bt,drop_t", [(4, 0), (16, 0), (4, 64)])
def test_joint_fp32_matches_jax(activation, bt, drop_t):
    d = _inputs(seed=bt + drop_t)
    want_f, got_f, want_b, got_b = _run(d, "float32", activation, bt, drop_t, clamp=2.0)
    for name, a, b in zip(("blank_lp", "label_lp", "lse"), got_f, want_f):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), _np(b), rtol=F32_TOL, atol=F32_TOL, err_msg=name)
    for name, a, b in zip(("de", "dp", "dw", "db"), got_b, want_b):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(_np(a), _np(b), rtol=F32_TOL, atol=F32_TOL, err_msg=name)


@pytest.mark.parametrize("activation,drop_t", [("relu", 0), ("tanh", 26)])
def test_joint_bf16_matches_jax_within_rounding(activation, drop_t):
    d = _inputs(seed=5, t=9, u=4, h=32)
    want_f, got_f, want_b, got_b = _run(d, "bfloat16", activation, 4, drop_t)
    for name, a, b in zip(("blank_lp", "label_lp", "lse", "de", "dp", "dw", "db"),
                          (*got_f, *got_b), (*want_f, *want_b)):
        a, b = _np(a), _np(b)
        assert np.abs(a - b).max() <= BF16_REL * np.abs(b).max(), name
    assert got_b[0].dtype == torch.bfloat16 and got_b[1].dtype == torch.float32


@pytest.mark.parametrize("drop_t", [0, 64])
def test_joint_ragged_lattice_matches_jax_inside(drop_t):
    """Ragged lengths, a u_len = 0 row and a t_len = 1 row: inside the
    lattice the forward matches JAX, outside it holds -1e30 (lse 1e30); the
    backward matches JAX's on posteriors zeroed outside, though the port's
    are not."""
    d = _inputs(seed=7, b=3, t=9, u=4)
    d["g"] = np.array([1.0, 0.5, 2.0], np.float32)
    lens = ([9, 5, 1], [4, 0, 2])
    want_f, got_f, want_b, got_b = _run(d, "float32", "relu", 4, drop_t, clamp=2.0, lens=lens)
    inside = port.valid_cells(d["lse"].shape, *(torch.tensor(x) for x in lens)).numpy()
    for name, a, b, fill in zip(("blank_lp", "label_lp", "lse"), got_f, want_f,
                                (-1e30, -1e30, 1e30)):
        a, b = _np(a), _np(b)
        np.testing.assert_allclose(a[inside], b[inside], rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=name)
        assert (a[~inside] == np.float32(fill)).all(), name
    for name, a, b in zip(("de", "dp", "dw", "db"), got_b, want_b):
        np.testing.assert_allclose(_np(a), _np(b), rtol=F32_TOL, atol=F32_TOL, err_msg=name)


def test_hash_keep_mask_bit_for_bit():
    for shape, seed, drop_t in (((2, 8, 5, 16), 12345, 26), ((1, 4, 3, 64), -7, 64),
                                ((3, 16, 2, 32), 2 ** 31 - 1, 128)):
        want = np.asarray(jk.hash_keep_mask_reference(shape, jnp.asarray([seed], jnp.int32),
                                                      drop_t))
        got = port.hash_keep_mask_reference(shape, torch.tensor([seed], dtype=torch.int32),
                                            drop_t).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0.3 < got.mean() < 0.95


def test_hash_bits_wrap_past_two_to_the_32():
    """Global indices past 2^32 wrap as uint32 in the kernels' index
    arithmetic: the hash of index n + 2^32 is the hash of n."""
    idx = np.array([0, 1, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 5, 3 * 2 ** 32 + 77], np.int64)
    got = port.hash_bits(torch.from_numpy(idx), 991).numpy()
    want = np.asarray(jk._hash_bits(jnp.asarray(idx % 2 ** 32, jnp.uint32),
                                    jnp.uint32(991))).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    assert got[3] == got[0] and got[4] == port.hash_bits(torch.tensor([5]), 991).item()


def test_joint_refuses_blank_not_last():
    d = _inputs()
    tx = {k: torch.from_numpy(x) for k, x in d.items()}
    with pytest.raises(ValueError, match="blank-last"):
        port.joint_flash_fwd(tx["e"], tx["p"], tx["w"], tx["bias"], tx["targets"],
                             torch.zeros(1, dtype=torch.int32), t_lens=torch.tensor([7, 7]),
                             u_lens=torch.tensor([3, 3]), blank_id=0)


@pytest.mark.parametrize("activation,drop_t,clamp,window,v", [
    ("relu", 0, -1.0, 64, 13), ("tanh", 26, 2.0, 64, 13), ("sigmoid", 64, -1.0, None, 13),
    ("relu", 26, -1.0, 64, 401)])
def test_joint_bwd_pieces_compose_and_match_jax(activation, drop_t, clamp, window, v):
    """The backward's plain pieces (cells, sums, reduce) over windows of the
    lattice's cells: with 64-cell windows the 155 cells take three windows
    (and four past the lattice hold none), and dW is summed across them in
    order. They compose to `joint_flash_bwd_reference` and match JAX's
    backward on a ragged lattice with a u_len = 0 row. V - 1 = 400 pads to
    416 label columns, which the kernels take in two passes."""
    d = _inputs(seed=11, b=3, t=20, u=6, v=v)
    d["g"] = np.array([1.0, 0.5, 2.0], np.float32)
    lens = ([20, 11, 1], [6, 0, 3])
    _, _, want_b, got_b = _run(d, "float32", activation, 4, drop_t, clamp=clamp, lens=lens)
    tx = {k: torch.from_numpy(x) for k, x in d.items()}
    tl, ul = (torch.tensor(x, dtype=torch.int32) for x in lens)
    args = [tx[k] for k in ("e", "p", "w", "bias", "targets", "lse", "total", "gb", "gy", "g")]
    kw = dict(t_lens=tl, u_lens=ul, blank_id=d["w"].shape[1] - 1, activation=activation,
              drop_t=drop_t, bt=4, clamp=clamp)
    seed = torch.tensor([12345], dtype=torch.int32)
    pieces = port.joint_flash_bwd_windowed(*args, seed, window=window, **kw)
    assert port.bwd_windows(3 * 20 * 7, 16, v, window)[1] == (7 if window else 1)
    for name, a, b, r in zip(("de", "dp", "dw", "db"), pieces, want_b, got_b):
        np.testing.assert_allclose(_np(a), _np(r), rtol=F32_TOL, atol=F32_TOL, err_msg=name)
        np.testing.assert_allclose(_np(a), _np(b), rtol=F32_TOL, atol=F32_TOL, err_msg=name)
