"""The RNN-T lattice (K3) at the transducer step's full shape, and the host
side of its CUDA kernels.

The kernels run only on the card (tests/test_torch_kernels_gpu.py); here:
  * the plain versions, which the wrappers run on CPU tensors and the card
    checks hold the kernels against, against the JAX package's
    `_compute_alphas` / `_compute_betas` (scan path) at the transducer step's
    shape (B 16, T 391, U+1 129) with ragged lengths from a numpy seed, as
    max|port - jax| / max(|jax|, 1) <= 1e-5 (fp32 on both sides, the same
    recursion; the two libraries' exp/log differ in the last bits);
  * the same at the lengths that bound the kernels' paths (widths about the
    warp path's 64 columns, u_len = 0 and t_len = 1 rows beside full-width
    ones, U+1 1100, B 200), the cases the card test holds the kernels to;
  * the strips compose: the recursion run strip by strip, as the block path
    sweeps a lattice wider than its warps hold, each strip reading its
    neighbour's boundary column from the finished part, gives the plain
    version's bits;
  * the block `lattice_threads` picks, and the launch's refusals, checked
    before any CUDA call: U+1 is bounded by the 32-bit row stride (< 2^30),
    no longer by a shared-memory rule (8 (U+1) <= SMEM_LIMIT).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.ops import rnnt_loss as jax_rl
from conformer_nemo_tpu_torch.ops import rnnt_lattice as port
from conformer_nemo_tpu_torch.ops.build import SMEM_LIMIT
from conformer_nemo_tpu_torch.ops.ctc_loss import lse2

TOL = 1e-5


def _rel_err(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def _lattice(seed, b, t, u1, t_lens, u_lens):
    rng = np.random.RandomState(seed)
    bl = np.log(rng.uniform(0.05, 0.95, (b, t, u1))).astype(np.float32)
    lb = np.log(rng.uniform(0.05, 0.95, (b, t, u1))).astype(np.float32)
    lb[:, :, -1] = -1e30  # no label past the last one
    return bl, lb, np.asarray(t_lens, np.int32), np.asarray(u_lens, np.int32)


def _step_lengths(seed, b=16, t=391):
    """Loader-like: frames from 60% of T to T (one row at T), ~20-50 labels,
    with a u_len = 0 and a t_len = 1 row."""
    rng = np.random.RandomState(seed)
    t_lens = rng.randint(int(0.6 * t), t + 1, b)
    u_lens = rng.randint(20, 51, b)
    t_lens[0], t_lens[1], u_lens[2] = t, 1, 0
    return t_lens, u_lens


def _plain_matches_jax_scan(which, bl, lb, tl, ul):
    jax_fn = jax_rl._compute_alphas if which == "alpha" else jax_rl._compute_betas
    port_fn = port.rnnt_alphas if which == "alpha" else port.rnnt_betas
    want = np.asarray(jax_fn(*(jnp.asarray(x) for x in (bl, lb, tl, ul)), "scan"))
    got = port_fn(*(torch.from_numpy(x) for x in (bl, lb, tl, ul))).numpy()
    assert _rel_err(got, want) <= TOL
    outside = ~port.valid_cells(bl.shape, torch.from_numpy(tl), torch.from_numpy(ul)).numpy()
    assert (got[outside] == -1e30).all()


@pytest.mark.parametrize("which", ["alpha", "beta"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_lattice_matches_jax_scan_at_the_transducer_step(which, seed):
    t_lens, u_lens = _step_lengths(seed)
    bl, lb, tl, ul = _lattice(seed, 16, 391, 129, t_lens, u_lens)
    _plain_matches_jax_scan(which, bl, lb, tl, ul)


@pytest.mark.parametrize("u1,threads", [(1, 128), (12, 128), (129, 128), (256, 128),
                                        (257, 160), (1024, 512), (1100, 512), (40000, 512)])
def test_lattice_threads(u1, threads):
    """A thread per two columns in whole warps, at least four warps (the
    idle ones write the -1e30 cells), at most 512."""
    assert port.lattice_threads(u1) == threads


def _ragged(b, t, u_lo, u_hi, seed):
    """Loader-like lengths: frames from 60% of T to T (one row at T), labels
    drawn from [u_lo, u_hi]."""
    rng = np.random.RandomState(seed)
    t_lens = rng.randint(int(0.6 * t), t + 1, b)
    t_lens[0] = t
    return t_lens.tolist(), rng.randint(u_lo, u_hi + 1, b).tolist()


# (T, U+1, t_lens, u_lens), as tests/test_torch_kernels_gpu.py's LATTICE_CASES
EDGE_CASES = {
    "small": (60, 12, [60, 41, 1, 7], [11, 5, 0, 0]),
    "u1_1100": (37, 1100, [37, 20], [1099, 600]),
    "warp_block_boundary": (80, 129, [80, 80, 61, 1, 80], [63, 64, 62, 65, 0]),
    "b200": (60, 70, *_ragged(200, 60, 0, 69, 1)),
    "full_width_rows": (50, 97, [50, 50, 1, 50, 33], [96, 96, 96, 0, 96]),
}


@pytest.mark.parametrize("which", ["alpha", "beta"])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_plain_lattice_matches_jax_scan_at_edge_lengths(which, case):
    t, u1, t_lens, u_lens = EDGE_CASES[case]
    bl, lb, tl, ul = _lattice(3, len(t_lens), t, u1, t_lens, u_lens)
    _plain_matches_jax_scan(which, bl, lb, tl, ul)


def _alphas_by_strips(bl, lb, t_len, u_len, strip):
    """Alpha of one sample, strip after strip as the block path sweeps it
    (strips of `strip` columns): within a strip a diagonal at a time, the
    cell left of the strip's first column read from the finished part."""
    t_max, u1 = bl.shape
    width = u_len + 1
    strips = [(lo, min(width, lo + strip)) for lo in range(0, width, strip)]
    neg = torch.tensor(-1e30)
    alpha = torch.full((t_max, u1), -1e30)
    for lo, hi in strips:
        for d in range(lo, t_len - 1 + hi):
            u = torch.arange(max(lo, d - t_len + 1), min(hi, d + 1))
            t = d - u
            if d == 0:
                alpha[0, 0] = 0.0
                continue
            left = torch.where(t >= 1, alpha[(t - 1).clamp(min=0), u] + bl[(t - 1).clamp(min=0), u],
                               neg)
            below = torch.where(u >= 1, alpha[t, (u - 1).clamp(min=0)] + lb[t, (u - 1).clamp(min=0)],
                                neg)
            alpha[t, u] = lse2(left, below)
    return alpha


@pytest.mark.parametrize("strip,u_len,t_len", [(64, 199, 20), (128, 150, 13), (64, 64, 1)])
def test_strips_compose_to_the_plain_recursion(strip, u_len, t_len):
    """Strips of 64 columns are what a block of one warp sweeps, 128 of two."""
    bl, lb, tl, ul = _lattice(7, 1, 20, 200, [t_len], [u_len])
    bl_t, lb_t = torch.from_numpy(bl[0]), torch.from_numpy(lb[0])
    got = _alphas_by_strips(bl_t, lb_t, t_len, u_len, strip)
    want = port.rnnt_alphas_reference(*(torch.from_numpy(x) for x in (bl, lb, tl, ul)))[0]
    assert torch.equal(got, want)


def _args(b=2, t=5, u1=7, dtype=torch.float32, len_dtype=torch.int32):
    x = torch.zeros(b, t, u1, dtype=dtype)
    return x, x.clone(), torch.ones(b, dtype=len_dtype), torch.ones(b, dtype=len_dtype)


def test_launch_refusals_before_any_cuda_call():
    counter = port.alpha_launches
    before = counter.total
    with pytest.raises(TypeError, match="fp32"):
        port._launch("rnnt_alpha_f32", counter, *_args(dtype=torch.float64))
    with pytest.raises(TypeError, match="int32"):
        port._launch("rnnt_alpha_f32", counter, *_args(len_dtype=torch.int64))
    bl, lb, tl, ul = _args(t=6)
    with pytest.raises(ValueError, match="contiguous"):
        port._launch("rnnt_alpha_f32", counter, bl[:, ::2], lb[:, ::2], tl, ul)
    with pytest.raises(ValueError, match=r"T >= 1 and 1 <= U\+1 < 2\^30"):
        port._launch("rnnt_alpha_f32", counter, *_args(t=0))
    meta = torch.empty(1, 1, 2 ** 30, device="meta")  # shape only: nothing allocated
    lens = torch.ones(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match=r"1 <= U\+1 < 2\^30"):
        port._launch("rnnt_alpha_f32", counter, meta, meta, lens, lens)
    for threads in (16, 48, 544, 1024):
        with pytest.raises(ValueError, match="whole warps, 32 to 512"):
            port._launch("rnnt_alpha_f32", counter, *_args(), threads=threads)
    for plan in (torch.zeros(2, dtype=torch.int32), torch.zeros(3, 2, dtype=torch.int32),
                 torch.zeros(2, 2, dtype=torch.int64), torch.zeros(2, 2, dtype=torch.int32).t()):
        with pytest.raises(ValueError, match=r"plan must be a contiguous int32 \[2, 2\]"):
            port._launch("rnnt_alpha_f32", counter, *_args(), plan=plan)
    assert counter.total == before


@pytest.mark.parametrize("u1", [129, SMEM_LIMIT // 8, SMEM_LIMIT // 8 + 1, 40000, 2 ** 30 - 1])
def test_launch_takes_any_width(u1):
    """The kernels keep no diagonal in shared memory: a U+1 past the old
    rule (8 (U+1) <= SMEM_LIMIT) is taken, with the widest block."""
    bl = torch.empty(1, 1, u1, device="meta")  # shape only: nothing allocated
    lens = torch.ones(1, dtype=torch.int32, device="meta")
    assert port._check_launch(bl, bl, lens, lens, None, None) == port.lattice_threads(u1)
    assert port._check_launch(bl, bl, lens, lens, 64, None) == 64
