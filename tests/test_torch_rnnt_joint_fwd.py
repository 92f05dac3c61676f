"""Host-side arithmetic of the CUDA flash-joint forward (K4-fwd), against the
JAX package's `_split_blank` and `joint_flash_fwd` on the same numpy inputs.

The kernel itself runs only on the card (tests/test_torch_kernels_gpu.py);
what surrounds it is checked here:
  * `fwd_weight`: the W the kernel's tensor copies read is W itself, the
    blank in column V - 1 as the JAX kernel splits it off, zeros past V, in
    rows of 16 bytes (exact: a copy);
  * the persistent grid (`fwd_grid`) and the walk its blocks take over the
    lattice's tiles (`lattice_offsets` order) and over the full index for the
    sentinels: every cell is written once, and putting JAX's values where
    the walk puts the kernel's gives the port's forward (fp32, 1e-5: the JAX
    kernel runs interpreted, another summation order);
  * the range check refuses an H the forward's tiles cannot take, naming
    the forward.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.ops.pallas import rnnt_joint_kernel as jk
from conformer_nemo_tpu_torch.ops import rnnt_joint as port
from conformer_nemo_tpu_torch.ops.build import SMEM_LIMIT

F32_TOL = 1e-5
FCG = 4  # the kernel's column groups: a block has FCG * rows / 32 consumer warps


@pytest.mark.parametrize("v", [13, 16, 41, 296, 401, 1025])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwd_weight_is_w_blank_last_in_16_byte_rows(v, dtype):
    rng = np.random.RandomState(v)
    w = rng.randn(16, v).astype(np.float32)
    bias = rng.randn(v).astype(np.float32)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    w_lab, wb_row, _, _ = (np.asarray(x, np.float32) for x in jk._split_blank(
        jnp.asarray(w, jd), jnp.asarray(bias, jd), v - 1))
    tw = torch.from_numpy(w).to(td)
    wf = port.fwd_weight(tw)
    assert wf.shape == (16, -(-v // 8) * 8) and wf.is_contiguous() and wf.dtype == td
    assert wf.data_ptr() % 16 == 0
    assert (wf is tw) == (v % 8 == 0)  # no copy where the rows already are 16-byte
    got = wf.float().numpy()
    np.testing.assert_array_equal(got[:, : v - 1], w_lab)  # the label block
    np.testing.assert_array_equal(got[:, v - 1], wb_row[0])  # column VL: the blank
    assert (got[:, v:] == 0).all()


def test_fwd_weight_copies_views_the_tensor_copies_cannot_read():
    w = torch.randn(17, 48)[1:, 8:]  # rows not contiguous
    wf = port.fwd_weight(w)
    assert wf is not w and wf.is_contiguous() and wf.data_ptr() % 16 == 0
    assert torch.equal(wf, w)
    flat = torch.randn(16 * 48 + 1)[1:].reshape(16, 48)  # contiguous, 4 bytes off
    wf = port.fwd_weight(flat)
    assert flat.data_ptr() % 16 and wf is not flat and wf.data_ptr() % 16 == 0
    assert torch.equal(wf, flat)


@pytest.mark.parametrize("cells,rows,n_sm,want", [(807024, 128, 132, 132), (644, 128, 132, 6),
                                                  (644, 64, 3, 3), (1, 128, 132, 1)])
def test_fwd_grid(cells, rows, n_sm, want):
    assert port.fwd_grid(cells, rows, n_sm) == want


def _inputs(b, t, u, h, v, seed=0):
    rng = np.random.RandomState(seed)
    return dict(e=(rng.randn(b, t, h) * 0.5).astype(np.float32),
                p=(rng.randn(b, u + 1, h) * 0.5).astype(np.float32),
                w=(rng.randn(h, v) * 0.3).astype(np.float32),
                bias=(rng.randn(v) * 0.1).astype(np.float32),
                targets=rng.randint(0, v - 1, (b, u)).astype(np.int32))


@pytest.mark.parametrize("rows,n_sm", [(128, 132), (128, 1), (64, 3), (64, 2)])
def test_fwd_walk_writes_every_cell_once_as_jax(rows, n_sm):
    """The kernel's walk, block by block: lattice tiles x, x + grid, ...
    (each row's (b, t, u) found from the offsets by the kernel's binary
    search), then the sentinel stripes of FCG * rows threads; JAX's values
    put where the walk puts the kernel's."""
    b, t, u, h, v, drop_t, bt = 4, 23, 6, 16, 41, 64, 4
    u1 = u + 1
    d = _inputs(b, t, u, h, v)
    t_lens, u_lens = [23, 17, 1, 12], [6, 0, 3, 5]
    tl, ul = (torch.tensor(x, dtype=torch.int32) for x in (t_lens, u_lens))
    kw = dict(blank_id=v - 1, activation="relu", drop_t=drop_t, bt=bt)
    seed = 321
    want = [np.asarray(x) for x in jk.joint_flash_fwd(
        *(jnp.asarray(d[k]) for k in ("e", "p", "w", "bias", "targets")),
        jnp.asarray([seed], jnp.int32), interpret=True, **kw)]
    got = port.joint_flash_fwd(*(torch.from_numpy(d[k]) for k in ("e", "p", "w", "bias",
                                                                   "targets")),
                               torch.tensor([seed], dtype=torch.int32), t_lens=tl, u_lens=ul,
                               **kw)

    off = port.lattice_offsets(tl, ul, t, u1).tolist()
    n_all = off[b]
    lat = [x.tolist() for x in port.lattice_cells(tl, ul, t, u1)]
    assert n_all == len(lat[0]) == sum(x * (y + 1) for x, y in zip(t_lens, u_lens))
    n_u = [y + 1 for y in u_lens]
    grid = port.fwd_grid(b * t * u1, rows, n_sm)
    nct = FCG * rows  # consumer threads of a block
    written = np.zeros((b, t, u1), np.int64)
    out = np.full((3, b, t, u1), np.nan, np.float32)
    for x in range(grid):
        tile = x
        while tile * rows < n_all:
            for c in range(tile * rows, min((tile + 1) * rows, n_all)):
                lo, hi = 0, b - 1  # the last sample whose first cell is <= c
                while lo < hi:
                    mid = (lo + hi + 1) // 2
                    lo, hi = (mid, hi) if off[mid] <= c else (lo, mid - 1)
                j = c - off[lo]
                cell = (lo, j // n_u[lo], j % n_u[lo])
                assert cell == (lat[0][c], lat[1][c], lat[2][c])
                written[cell] += 1
                out[(slice(None), *cell)] = [w[cell] for w in want]
            tile += grid
        for i in range(x * nct, b * t * u1, grid * nct):  # one stripe per thread
            for k in range(i, min(i + nct, b * t * u1)):
                bb, tt, uu = k // (t * u1), k // u1 % t, k % u1
                if tt >= t_lens[bb] or uu >= n_u[bb]:
                    written[bb, tt, uu] += 1
                    out[:, bb, tt, uu] = [-1e30, -1e30, 1e30]
    assert (written == 1).all()
    inside = port.valid_cells((b, t, u1), tl, ul).numpy()
    for k in range(3):
        np.testing.assert_allclose(out[k][inside], got[k].numpy()[inside], rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_array_equal(out[k][~inside], got[k].numpy()[~inside])


def test_forward_range_check_names_the_forward(monkeypatch):
    """check_smem((0,)) asks the library for the forward's shared memory at
    H and raises past a block's; a stand-in library reports the kernel's
    limits (128-cell tiles to H 672, 64-cell tiles to H 1376)."""
    def smem(h, v, which):
        assert which == 0
        return SMEM_LIMIT - 1 if h <= 1376 else SMEM_LIMIT + 640

    monkeypatch.setattr(port, "_lib", lambda: types.SimpleNamespace(
        rnnt_joint_smem_bytes=smem,
        rnnt_joint_fwd_rows=lambda h: 128 if h <= 672 else 64 if h <= 1376 else 0))
    port.check_smem(1376, 1025, (0,))
    assert port.fwd_rows(672) == 128 and port.fwd_rows(688) == 64 and port.fwd_rows(1392) == 0
    with pytest.raises(ValueError, match="kernel 0 needs .* at H=1392"):
        port.check_smem(1392, 1025, (0,))
