"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU (the kernels have no CPU mode) and skips without one.
This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q
"""

import numpy as np
import pytest
import torch

from conformer_nemo_tpu_torch.ops import ctc_loss as ctc
from conformer_nemo_tpu_torch.ops import flash_attention as port

# K2-bwd vs its plain version on the same bf16 inputs, as
# max|kernel - plain| / max|plain| per output: the kernel rounds P and dS to
# bf16 before the dV, dQ and dK products, and both round the outputs to bf16
BWD_REL_TOL = 2e-2
# K1 vs its plain version in fp32: nll relative (summation order of the T-step
# recursion); gradient absolute (posteriors lie in [0, 1], and alpha + beta -
# ll cancels at |ll| ~ T * log V, leaving about ulp(|ll|) of absolute error)
NLL_REL_TOL = 1e-5
GRAD_ABS_TOL = 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _flash_inputs(dev, bh, t, d1, dv, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    qs, ks = (torch.randn(bh, t, d1, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    v, do = (torch.randn(bh, t, dv, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    return qs, ks, v, do


@pytest.mark.gpu
@pytest.mark.parametrize("t,d1,dv,band", [(3001, 576, 64, (-1, -1)), (200, 80, 16, (-1, -1)),
                                          (1251, 576, 64, (128, 32)), (1843, 576, 64, (-1, -1)),
                                          (333, 1152, 128, (-1, -1)), (300, 40, 24, (16, -1))])
def test_flash_fwd_cuda_kernel_matches_plain(cuda_device, t, d1, dv, band):
    """Both query-tile heights (64 and 128 rows) against the plain version,
    T not a multiple of either; d1 1152 / dv 128 at the top of the range
    (64-row tiles only: 128 rows do not fit there); o and lse the same bits
    on a second call."""
    qs, ks, v, _ = _flash_inputs(cuda_device, 4, t, d1, dv)
    lens = torch.tensor([t, t // 2, 1, 0], dtype=torch.int32, device=cuda_device)
    # the model's 1/sqrt(d_head): peaked rows, so o is of order 1 and the o limit bites
    scale = 1.0 / np.sqrt(64)
    o_ref, lse_ref = port.flash_attention_fwd_reference(qs, ks, v, lens, scale, *band)
    rows = (0, 64) if d1 > 576 else (0, 64, 128)
    for r in rows:
        o, lse = port._launch_fwd(qs, ks, v, lens, scale, *band, rows=r)
        again = port._launch_fwd(qs, ks, v, lens, scale, *band, rows=r)
        torch.cuda.synchronize()
        # bf16 output rounding plus a different summation order
        assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2, r
        assert (lse - lse_ref).abs().max().item() <= 2e-3, r
        assert torch.equal(o, again[0]) and torch.equal(lse, again[1]), r
        assert o[3].abs().max().item() == 0.0 and lse[3].abs().max().item() == 0.0  # lens 0
    assert torch.equal(port.flash_attention_fwd(qs, ks, v, lens, scale, *band)[0],
                       port._launch_fwd(qs, ks, v, lens, scale, *band)[0])


@pytest.mark.gpu
def test_flash_fwd_operator_launches_the_kernel(cuda_device):
    """The operator conformer_nemo_tpu_torch::flash_attention_fwd on CUDA
    tensors launches K2-fwd (counted under its shape and band), matches the
    plain version and gives the ctypes launch's bits; a program that
    torch.export traced through it launches the kernel too."""
    from conformer_nemo_tpu_torch.utils.export import export_fn

    qs, ks, v, _ = _flash_inputs(cuda_device, 4, 700, 576, 64)
    lens = torch.tensor([700, 513, 1, 0], dtype=torch.int32, device=cuda_device)
    key = (4, 700, 576, 64, 128, 32)
    before = port.fwd_launches.by_shape.get(key, 0)
    o, lse = torch.ops.conformer_nemo_tpu_torch.flash_attention_fwd(qs, ks, v, lens, 0.125,
                                                                     128, 32)
    assert port.fwd_launches.by_shape[key] == before + 1
    o_ref, lse_ref = port.flash_attention_fwd_reference(qs, ks, v, lens, 0.125, 128, 32)
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 2e-3
    direct = port._launch_fwd(qs, ks, v, lens, 0.125, 128, 32)
    assert torch.equal(o, direct[0]) and torch.equal(lse, direct[1])
    program = export_fn(lambda q, k, vv, n: port.flash_attention_fwd(q, k, vv, n, 0.125, 128,
                                                                      32)[0], (qs, ks, v, lens))
    before = port.fwd_launches.by_shape[key]
    assert torch.equal(program.module()(qs, ks, v, lens), o)
    torch.cuda.synchronize()
    assert port.fwd_launches.by_shape[key] == before + 1


@pytest.mark.gpu
def test_flash_fwd_refuses_past_its_shared_memory(cuda_device):
    """The 64-row tile with its key ring fits up to d1 1216: past it the
    wrapper raises before a launch."""
    qs, ks, v, _ = _flash_inputs(cuda_device, 1, 64, 1224, 128)
    lens = torch.tensor([64], dtype=torch.int32, device=cuda_device)
    before = port.fwd_launches.total
    with pytest.raises(ValueError, match="flash_attention_fwd_smem_bytes"):
        port.flash_attention_fwd(qs, ks, v, lens, 0.125)
    assert port.fwd_launches.total == before


@pytest.mark.gpu
@pytest.mark.parametrize("t,d1,dv,band", [(1875, 576, 64, (-1, -1)), (200, 80, 16, (-1, -1)),
                                          (700, 576, 64, (128, 32)), (300, 40, 24, (16, -1)),
                                          (333, 200, 40, (-1, -1))])
def test_flash_bwd_cuda_kernels_match_plain(cuda_device, t, d1, dv, band):
    """d1 80, 40 and 200 split unevenly over the dK/dV kernel's 8 warps'
    column groups (10, 6 and 26 n-tiles of 8 columns); dv 24 and 40 are not
    multiples of 16."""
    qs, ks, v, do = _flash_inputs(cuda_device, 4, t, d1, dv, seed=1)
    lens = torch.tensor([t, t // 2 + 3, 1, 0], dtype=torch.int32, device=cuda_device)
    scale = 1.0 / np.sqrt(64)
    o, lse = port.flash_attention_fwd_reference(qs, ks, v, lens, scale, *band)
    delta = (do.float() * o.float()).sum(-1)
    got = port.flash_attention_bwd(qs, ks, v, do, lse, delta, lens, scale, *band)
    want = port.flash_attention_bwd_reference(qs, ks, v, do, lse, delta, lens, scale, *band)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        rel = ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30))
        assert rel.item() <= BWD_REL_TOL, (name, rel.item())
    # query rows past the length (and the lens = 0 row) get exactly zero
    assert got[0][2, 1:].abs().max().item() == 0.0 and got[0][3].abs().max().item() == 0.0
    # no atomics: each kernel gives the same bits on a second call
    again = port.flash_attention_bwd_dkv(qs, ks, v, do, lse, delta, lens, scale, *band)
    assert torch.equal(again[0], got[1]) and torch.equal(again[1], got[2])
    assert torch.equal(port.flash_attention_bwd_dq(qs, ks, v, do, lse, delta, lens, scale,
                                                   *band), got[0])


@pytest.mark.gpu
def test_flash_kernels_stay_finite_at_scores_past_fp32_integer_range(cuda_device):
    """Scores of 1e9 and more, exact in fp32 from any order of summation:
    qs integers times 2^24 in its first half of columns (0 past them), ks
    integers with keys 2i and 2i + 1 equal there, so each softmax row splits
    over its top pair. The forward's lse equals the plain one bit for bit,
    and dQ, dK and dV are finite and agree with the plain backward (an lse
    kept in the exp2 domain drifted by hundreds there, and exp(x - lse) went
    past fp32's range)."""
    g = torch.Generator(device="cpu").manual_seed(7)
    bh, t, d1, dv, half = 4, 1843, 576, 64, 288
    qs = torch.zeros(bh, t, d1)
    qs[..., :half] = torch.randint(-8, 9, (bh, t, half), generator=g).float() * 2.0 ** 24
    ks = torch.randint(-8, 9, (bh, t, d1), generator=g).float()
    ks[:, 1::2, :half] = ks[:, 0::2, :half][:, : t // 2]
    v, do = (torch.randn(bh, t, dv, generator=g) for _ in range(2))
    qs, ks, v, do = (x.to(cuda_device, torch.bfloat16) for x in (qs, ks, v, do))
    lens = torch.tensor([t, 1700, 901, 2], dtype=torch.int32, device=cuda_device)
    o, lse = port.flash_attention_fwd(qs, ks, v, lens, 0.125)
    o_ref, lse_ref = port.flash_attention_fwd_reference(qs, ks, v, lens, 0.125)
    assert lse_ref.abs().max().item() > 1e9
    assert torch.equal(lse, lse_ref)
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    delta = (do.float() * o.float()).sum(-1)
    got = port.flash_attention_bwd(qs, ks, v, do, lse, delta, lens, 0.125)
    want = port.flash_attention_bwd_reference(qs, ks, v, do, lse, delta, lens, 0.125)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(a).all()), name
        rel = ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30))
        assert rel.item() <= BWD_REL_TOL, (name, rel.item())


@pytest.mark.gpu
@pytest.mark.parametrize("t,d1,dv", [(200, 584, 64), (301, 1152, 128), (157, 1216, 128)])
def test_flash_bwd_dkv_takes_every_depth_the_forward_takes(cuda_device, t, d1, dv):
    """dK's columns go in passes of 576 (d1 584: 576 + 8), with 32-query
    tiles and then a one-stage ring where the depth needs the shared memory
    (d1 1152 and 1216 at dv 128, the forward's top): against the plain
    version, the same bits on a second call."""
    qs, ks, v, do = _flash_inputs(cuda_device, 2, t, d1, dv, seed=2)
    lens = torch.tensor([t, 77], dtype=torch.int32, device=cuda_device)
    scale = 1.0 / np.sqrt(64)
    o, lse = port.flash_attention_fwd_reference(qs, ks, v, lens, scale)
    delta = (do.float() * o.float()).sum(-1)
    args = (qs, ks, v, do, lse, delta, lens, scale)
    got = port.flash_attention_bwd(*args)
    want = port.flash_attention_bwd_reference(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        rel = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert rel.item() <= BWD_REL_TOL, (name, rel.item())
    again = port.flash_attention_bwd_dkv(*args)
    assert torch.equal(again[0], got[1]) and torch.equal(again[1], got[2])
    lib = port.load("flash_attention_bwd.cu")
    assert lib.flash_attention_bwd_dkv_max_d1(dv) >= 1216
    assert lib.flash_attention_bwd_dq_max_d1(dv) >= 1216


@pytest.mark.gpu
@pytest.mark.parametrize("t,d1,dv", [(301, 656, 64), (200, None, 64), (157, None, 128)])
def test_flash_bwd_dq_kernel_past_576_columns(cuda_device, t, d1, dv):
    """d1 656: two passes of dQ columns (576 + 80) on 32-key tiles; d1 None:
    the widest the wrappers take at dv (the forward's 1216, under the dQ
    kernel's own limit), past which they refuse."""
    widest = port.load("flash_attention_bwd.cu").flash_attention_bwd_dq_max_d1(dv)
    assert widest >= 1216
    d1 = d1 or 1216
    qs, ks, v, do = _flash_inputs(cuda_device, 3, t, d1, dv, seed=3)
    lens = torch.tensor([t, t - 45, 0], dtype=torch.int32, device=cuda_device)
    scale = 1.0 / np.sqrt(64)
    o, lse = port.flash_attention_fwd_reference(qs, ks, v, lens, scale)
    delta = (do.float() * o.float()).sum(-1)
    args = (qs, ks, v, do, lse, delta, lens, scale)
    dq = port.flash_attention_bwd_dq(*args)
    want = port.flash_attention_bwd_reference(*args)[0]
    torch.cuda.synchronize()
    rel = (dq.float() - want.float()).abs().max() / want.float().abs().max()
    assert rel.item() <= BWD_REL_TOL
    assert dq[1, t - 45:].abs().max().item() == 0.0 and dq[2].abs().max().item() == 0.0
    assert torch.equal(dq, port.flash_attention_bwd_dq(*args))
    with pytest.raises(ValueError, match="flash_attention_fwd_smem_bytes"):
        port.flash_attention_bwd_dq(*(torch.zeros(1, 8, 1224, dtype=torch.bfloat16,
                                                  device=cuda_device) for _ in range(2)),
                                    v[:1, :8], do[:1, :8], lse[:1, :8], delta[:1, :8],
                                    lens[:1].clamp(max=8), scale)


# K2 against its plain version by dtype: (o absolute, lse absolute, the
# backward's relative error); fp16 rounds o, P and dS to 11 bits, the fp32
# kernels sum in another order only
K2_TOLS = {torch.bfloat16: (2e-2, 2e-3, BWD_REL_TOL), torch.float16: (4e-3, 2e-3, 4e-3),
           torch.float32: (2e-5, 2e-5, 2e-5)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("t,d1,dv,band", [(1501, 220, 44, (-1, -1)), (333, 1152, 128, (-1, -1)),
                                          (700, 576, 64, (128, 32)), (200, 44, 20, (16, -1)),
                                          (333, 1152, 128, (48, 16)), (301, 720, 80, (40, 8))])
def test_flash_kernels_at_every_width_and_dtype(cuda_device, dtype, t, d1, dv, band):
    """Small's heads (d1 220, dv 44: padded to 224 and 48 and sliced back),
    XLarge's (1152, 128), bands (also over the backward's 32-row tiles and
    one-stage rings at d1 1152, and its 32-row two-stage tiles at d1 720),
    and widths below a 16-column tile, in each dtype the kernels take:
    forward and backward against the plain version, outputs in the input
    dtype, launches counted under the dtype's kernel names at the caller's
    widths, the same bits twice."""
    g = torch.Generator(device="cpu").manual_seed(5)
    qs, ks = (torch.randn(4, t, d1, generator=g).to(cuda_device, dtype) for _ in range(2))
    v, do = (torch.randn(4, t, dv, generator=g).to(cuda_device, dtype) for _ in range(2))
    lens = torch.tensor([t, t // 2 + 3, 1, 0], dtype=torch.int32, device=cuda_device)
    scale = 1.0 / np.sqrt(64)
    o_tol, lse_tol, rel_tol = K2_TOLS[dtype]
    key = (4, t, d1, dv, *band)
    counts = [port.counter(k, dtype) for k in ("fwd", "dq", "dkv")]
    before = [c.by_shape.get(key, 0) for c in counts]
    o, lse = port.flash_attention_fwd(qs, ks, v, lens, scale, *band)
    o_ref, lse_ref = port.flash_attention_fwd_reference(qs, ks, v, lens, scale, *band)
    delta = (do.float() * o.float()).sum(-1)
    got = port.flash_attention_bwd(qs, ks, v, do, lse, delta, lens, scale, *band)
    want = port.flash_attention_bwd_reference(qs, ks, v, do, lse, delta, lens, scale, *band)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == v.shape and lse.dtype == torch.float32
    assert (o.float() - o_ref.float()).abs().max().item() <= o_tol
    assert (lse - lse_ref).abs().max().item() <= lse_tol
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        rel = (a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30)
        assert rel.item() <= rel_tol, (name, rel.item())
    assert [c.by_shape.get(key, 0) for c in counts] == [n + 1 for n in before]
    assert torch.equal(port.flash_attention_fwd(qs, ks, v, lens, scale, *band)[0], o)
    assert all(torch.equal(a, b) for a, b in zip(
        port.flash_attention_bwd(qs, ks, v, do, lse, delta, lens, scale, *band), got))


def _f32_plan(d1: int, dv: int, kv: int) -> dict:
    """The fp32 backward's plan as its library reports it."""
    import ctypes

    res, stages, passes = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem = port.load("flash_attention_f32.cu").flash_attention_bwd_f32_plan(
        d1, dv, kv, ctypes.byref(res), ctypes.byref(stages), ctypes.byref(passes))
    return {"smem": smem, "resident": res.value, "stages": stages.value, "passes": passes.value}


@pytest.mark.gpu
@pytest.mark.parametrize("t,d1,dv,band", [(157, 1224, 128, (-1, -1)), (301, 720, 64, (-1, -1)),
                                          (200, 1736, 48, (40, 8)), (97, 584, 128, (-1, 3))])
def test_flash_f32_backward_takes_any_depth(cuda_device, t, d1, dv, band):
    """The fp32 backward past the 16-bit forward's depth (d1 1224: three
    passes of 576 gradient columns; 1736: four, banded) and about the pass
    and residency boundaries (d1 720: two passes, the dK/dV kernel's own rows
    streamed; 584 at dv 128: 576 + 8): dQ, dK and dV against the plain fp32
    version within 2e-5 of the largest entry, rows past the length 0, the
    same bits on a second call; the plan the library reports."""
    g = torch.Generator(device="cpu").manual_seed(11)
    qs, ks = (torch.randn(3, t, d1, generator=g).to(cuda_device) for _ in range(2))
    v, do = (torch.randn(3, t, dv, generator=g).to(cuda_device) for _ in range(2))
    lens = torch.tensor([t, t // 2 + 5, 0], dtype=torch.int32, device=cuda_device)
    scale = 1.0 / np.sqrt(64)
    o, lse = port.flash_attention_fwd(qs, ks, v, lens, scale, *band)
    delta = (do * o).sum(-1)
    args = (qs, ks, v, do, lse, delta, lens, scale, *band)
    got = port.flash_attention_bwd(*args)
    want = port.flash_attention_bwd_reference(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        rel = (a - b).abs().max() / b.abs().max()
        assert rel.item() <= K2_TOLS[torch.float32][2], (name, rel.item())
        assert a[1, t // 2 + 5:].abs().max().item() == 0.0 and a[2].abs().max().item() == 0.0
    assert all(torch.equal(a, b) for a, b in zip(port.flash_attention_bwd(*args), got))
    passes = -(-d1 // 576)
    assert [_f32_plan(d1, dv, kv)["passes"] for kv in (0, 1)] == [passes, passes]


def _chain_scores(qs, ks, depth):
    """fl(S) of the fp32 kernels' chain: for each (query, key) one fmaf over
    depth 0 .. depth - 1 in order from 0.0f, taken in fp64 (the product of two
    fp32 numbers is exact there) and rounded to fp32 at every step. Where fp64
    rounds the sum first, the result can be a unit off fmaf's: that fails the
    check below, it cannot pass it."""
    acc = torch.zeros(qs.shape[0], qs.shape[1], ks.shape[1], dtype=torch.float64,
                      device=qs.device)
    q64, k64 = qs.double(), ks.double()
    for d in range(depth):
        acc = (q64[:, :, None, d] * k64[:, None, :, d] + acc).float().double()
    return acc.float()


def _ulp(x):
    """The gap from |x| to the next fp32 number up."""
    a = x.float().abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


@pytest.mark.gpu
def test_flash_f32_forward_keeps_the_chain(cuda_device):
    """The fp32 forward's S is the fmaf chain taken on the host
    (`_chain_scores`), read out of o. Scores near 1e7 as in the backward's
    chain test (qs and ks random times 2048 in their first 288 columns, qs 0
    past them), where a unit in the last place of x = fl(S * scale) is worth
    6% or more of P. Keys 2i + 1 copy keys 2i there, but for column 0, which
    is 2^-8 larger: the pair's exact scores differ by a few units of x, and
    their fp32 chains by whatever the rounding along the chain makes of that,
    so a row whose largest scores are such a pair splits its P between them
    by the chain's order. v's 64 columns are one-hot probes of keys 0..63, so
    o[i, r] is P of query i at key r. o is held within 1e-5 of exp(x - lse)
    with x the host chain's and lse taken from it in fp64: the kernel's o is
    P over its own row sum, and its lse, rounded to fp32, is a whole unit
    coarse at these scores. The kernel's lse is held to the fp64 one within
    half a unit in the last place, and to at least the row's largest x."""
    g = torch.Generator(device="cpu").manual_seed(13)
    bh, t, d1, half, probes = 2, 600, 576, 288, 64
    qs = torch.zeros(bh, t, d1)
    qs[..., :half] = torch.randn(bh, t, half, generator=g) * 2048.0
    ks = torch.randn(bh, t, d1, generator=g)
    ks[..., :half] *= 2048.0
    ks[:, 1::2, :half] = ks[:, 0::2, :half]
    ks[:, 1::2, 0] += 2.0 ** -8
    v = torch.zeros(bh, t, probes)
    v[:, :probes, :] = torch.eye(probes)
    qs, ks, v = (x.to(cuda_device) for x in (qs, ks, v))
    lens = torch.tensor([t, 451], dtype=torch.int32, device=cuda_device)
    scale = 0.125
    o, lse = port.flash_attention_fwd(qs, ks, v, lens, scale)
    x = (_chain_scores(qs, ks, half) * scale).float()
    key_ok = torch.arange(t, device=cuda_device)[None, None, :] < lens[:, None, None]
    x64 = torch.where(key_ok, x.double(), float("-inf"))
    m = x64.amax(-1)
    lse64 = m + torch.log(torch.exp(x64 - m[..., None]).sum(-1))
    want = torch.exp(x64[..., :probes] - lse64[..., None])
    torch.cuda.synchronize()
    lse_err = ((lse.double() - lse64).abs() / _ulp(lse64).double()).max().item()
    under = (lse.double() < m).sum().item()
    err = (o.double() - want).abs().max().item()
    # rows with a probed pair that splits P, where a unit of x moves it by 6% or more
    split = ((want > 0.01) & (want < 0.99) & (_ulp(x[..., :probes]) >= 2.0 ** -4)).any(-1)
    print(f"o: max abs err {err!r}; lse: {lse_err!r} units off fp64, under the row's "
          f"largest x on {under} rows; {split.sum().item()} rows split a probed pair")
    assert lse64.abs().max().item() > 1e6 and split.sum().item() >= 40
    assert under == 0 and lse_err <= 0.5 + 1e-3
    assert err <= 1e-5


@pytest.mark.gpu
def test_flash_f32_backward_keeps_the_forward_chain(cuda_device):
    """Scores near 1e7 that no fp32 sum gives exactly (qs and ks random times
    2048 in their first half of columns, keys 2i and 2i + 1 equal there, so
    each softmax row splits over tied pairs): a unit in the last place of a
    score is worth up to a factor e in P, so the fp32 backward agrees with
    fp64 as well as the plain fp32 version does only where its S is its
    forward's bit for bit. Each gradient's error against the plain version in
    fp64 is at most 4 times the plain fp32 version's. Then P itself, read out
    of both kernels on the same scores: with dO one-hot at four query rows
    (column r at row i_r), v's first four columns 1 and delta 0, dV[j, r] is
    P[i_r, j] and dQ[i_r, 288 + m] is scale times the sum of P[i_r, j] over
    keys j = m mod 288, where ks' second half (which meets qs' zeros, so S
    does not change) is that indicator. Both are held within 1e-5 of
    exp(min(fl(S * scale) - lse, 0)) with S the forward's chain taken on the
    host and lse the forward kernel's: a score one unit off moves its P by 6%
    or more."""
    g = torch.Generator(device="cpu").manual_seed(13)
    bh, t, d1, dv, half = 2, 600, 576, 64, 288
    qs = torch.zeros(bh, t, d1)
    qs[..., :half] = torch.randn(bh, t, half, generator=g) * 2048.0
    ks = torch.randn(bh, t, d1, generator=g)
    ks[..., :half] *= 2048.0
    ks[:, 1::2, :half] = ks[:, 0::2, :half]
    v, do = (torch.randn(bh, t, dv, generator=g) for _ in range(2))
    qs, ks, v, do = (x.to(cuda_device) for x in (qs, ks, v, do))
    lens = torch.tensor([t, 451], dtype=torch.int32, device=cuda_device)
    scale = 0.125
    o, lse = port.flash_attention_fwd(qs, ks, v, lens, scale)
    got = port.flash_attention_bwd(qs, ks, v, do, lse, (do * o).sum(-1), lens, scale)
    o32, lse32 = port.flash_attention_fwd_reference(qs, ks, v, lens, scale)
    plain = port.flash_attention_bwd_reference(qs, ks, v, do, lse32, (do * o32).sum(-1), lens,
                                               scale)
    q64, k64, v64, do64 = (x.double() for x in (qs, ks, v, do))
    o64, lse64 = port.flash_attention_fwd_reference(q64, k64, v64, lens, scale)
    exact = port.flash_attention_bwd_reference(q64, k64, v64, do64, lse64, (do64 * o64).sum(-1),
                                               lens, scale)
    torch.cuda.synchronize()
    assert lse64.abs().max().item() > 1e6
    for name, a, p, x in zip(("dq", "dk", "dv"), got, plain, exact):
        assert bool(torch.isfinite(a).all()), name
        err = ((a.double() - x).abs().max() / x.abs().max()).item()
        err_plain = ((p.double() - x).abs().max() / x.abs().max()).item()
        print(f"{name}: rel err vs fp64 {err!r}, plain fp32 {err_plain!r}")
        assert err <= max(K2_TOLS[torch.float32][2], 4.0 * err_plain), (name, err, err_plain)

    rows = torch.tensor([[5, 122, 347, 599], [0, 201, 333, 450]], device=cuda_device)
    ks_p = ks.clone()
    ks_p[..., half:] = (torch.arange(t, device=cuda_device)[:, None] % half
                        == torch.arange(half, device=cuda_device)).float()
    v_p = v.clone()
    v_p[..., :4] = 1.0
    do_p = torch.zeros_like(do)
    for r in range(4):
        do_p[torch.arange(bh), rows[:, r], r] = 1.0
    _, lse_p = port.flash_attention_fwd(qs, ks_p, v_p, lens, scale)
    dq, _, dvv = port.flash_attention_bwd(qs, ks_p, v_p, do_p, lse_p, torch.zeros_like(lse_p),
                                          lens, scale)
    q_rows = qs[torch.arange(bh)[:, None], rows]
    x = (_chain_scores(q_rows, ks_p, half) * scale).float()
    lse_rows = lse_p[torch.arange(bh)[:, None], rows]
    key_ok = torch.arange(t, device=cuda_device)[None, :] < lens[:, None]
    want = torch.where(key_ok[:, None], torch.exp((x - lse_rows[..., None]).clamp(max=0.0)), 0.0)
    assert want.amax(-1).min().item() > 0.1  # every probed row has P where a unit moves it
    got_p = dvv[..., :4].transpose(1, 2)
    err_dv = (got_p - want).abs().max().item()
    want_dq = torch.zeros(bh, 4, half, device=cuda_device).index_add_(
        2, torch.arange(t, device=cuda_device) % half, want)
    got_dq = dq[torch.arange(bh)[:, None], rows][..., half:] / scale
    err_dq = (got_dq - want_dq).abs().max().item()
    print(f"P from dV: max abs err {err_dv!r}; from dQ: {err_dq!r}")
    assert err_dv <= 1e-5 and err_dq <= 1e-5, (err_dv, err_dq)


@pytest.mark.gpu
def test_cuda_fit_trains_past_the_old_backward_depth(cuda_device, tmp_path):
    """d_model 640 (d1 = 80 + 640 = 720, past the 576 dK columns the dK/dV
    kernel once held) with flash attention on: `fit` takes a step through
    K2's backward; a depth past the forward's shared memory (d_model 1152,
    16 heads: d1 1224) is refused at construction."""
    import json
    import os

    from conformer_nemo_tpu_torch.api import ConformerCTC
    from conformer_nemo_tpu_torch.data.audio_io import write_wav

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    wav = str(tmp_path / "a.wav")
    write_wav(wav, (0.1 * np.random.RandomState(0).randn(32000)).astype(np.float32))
    manifest = tmp_path / "m.json"
    manifest.write_text(json.dumps({"audio_filepath": wav, "duration": 2.0, "text": "a"}) + "\n")
    config = os.path.join(root, "configs", "conformer_ctc_bpe_longform.yaml")
    overrides = {"model.tokenizer.model_file": os.path.join(root, "tests", "fixtures",
                                                            "sp_bpe_bytefallback.model"),
                 "model.encoder.n_layers": 2, "model.encoder.d_model": 640,
                 "model.encoder.use_flash_attention": True, "model.train_ds.batch_size": 1}
    model = ConformerCTC.from_config_file(config, overrides=overrides)
    before = (port.dq_launches.total, port.dkv_launches.total)
    out = model.fit(str(manifest), max_steps=1)
    assert out["steps"] == 1
    assert (port.dq_launches.total, port.dkv_launches.total) == (before[0] + 2, before[1] + 2)
    with pytest.raises(ValueError, match="flash_attention_fwd_smem_bytes"):
        ConformerCTC.from_config_file(config, overrides={
            **overrides, "model.encoder.d_model": 1152, "model.encoder.n_heads": 16})


@pytest.mark.gpu
@pytest.mark.parametrize("u,t", [(30, 300), (592, 900), (800, 1200), (1500, 2000), (3000, 3900)])
def test_ctc_alpha_cuda_kernel_matches_plain(cuda_device, u, t):
    """K1-fwd at one state a thread (S 61), a label state or two blank states
    a thread (S 1185), and 2, 4 and 8 states a thread (S 1601, 3001, 6001),
    with a row frozen past its length, a short target and an infeasible
    row: alphas and nll against the plain recursion, the sentinels kept."""
    rng = np.random.RandomState(u)
    b, v1 = 3, 40
    lp = torch.log_softmax(torch.from_numpy(rng.randn(b, t, v1).astype(np.float32) * 3), -1)
    targets = torch.from_numpy(rng.randint(0, v1 - 1, (b, u)).astype(np.int32))
    targets[0, 1::4] = targets[0, 0::4]  # repeats: states that may not skip
    il = torch.tensor([t, t - 37, u // 2], dtype=torch.int32)
    tl = torch.tensor([u, u // 3, u], dtype=torch.int32)  # row 2 infeasible
    args = [x.to(cuda_device) for x in (lp, targets, il, tl)]
    alphas, nll = ctc.ctc_alphas(*args, v1 - 1)
    a_ref, nll_ref = ctc.ctc_alphas_reference(*args, v1 - 1)
    torch.cuda.synchronize()
    assert nll[2].item() >= 1e29 and (nll[:2] < 1e29).all()
    assert _rel_err(nll[:2], nll_ref[:2]) <= NLL_REL_TOL
    live = a_ref > -1e29
    assert torch.equal(alphas > -1e29, live)  # the same reachable states
    assert _rel_err(alphas[live], a_ref[live]) <= NLL_REL_TOL
    assert torch.equal(alphas[1, t - 37:], alphas[1, t - 38:t - 37].expand(37, -1))  # frozen


@pytest.mark.gpu
def test_ctc_cuda_kernels_match_plain(cuda_device):
    rng = np.random.RandomState(0)
    b, t, v1, u = 5, 300, 40, 30
    lp = torch.log_softmax(torch.from_numpy(rng.randn(b, t, v1).astype(np.float32) * 3), -1)
    targets = torch.from_numpy(rng.randint(0, v1 - 1, (b, u)).astype(np.int32))
    targets[1, 4:8] = 7  # repeats
    targets[0, ::3] = 5  # a label recurring along the row
    il = torch.tensor([300, 250, 17, 300, 1], dtype=torch.int32)
    tl = torch.tensor([30, 20, 25, 0, 0], dtype=torch.int32)  # row 2 infeasible, U = 0 rows
    g = torch.from_numpy(rng.rand(b).astype(np.float32))
    args = [x.to(cuda_device) for x in (lp, targets, il, tl)]
    gd = g.to(cuda_device)
    alphas, nll = ctc.ctc_alphas(*args, v1 - 1)
    a_ref, nll_ref = ctc.ctc_alphas_reference(*args, v1 - 1)
    grad = ctc.ctc_grad(*args, alphas, nll, gd, v1 - 1)
    grad_ref = ctc.ctc_grad_reference(*args, a_ref, nll_ref, gd, v1 - 1)
    # K1-bwd and K1-bwd-grad, each against its plain version on the same inputs
    betas, chains = ctc.ctc_betas(*args, v1 - 1)
    b_ref, c_ref = ctc.ctc_betas_reference(*args, v1 - 1)
    coll = ctc.ctc_collect(*args, alphas, betas, chains, nll, gd, v1 - 1)
    coll_ref = ctc.ctc_collect_reference(*args, alphas, betas, chains, nll, gd, v1 - 1)
    torch.cuda.synchronize()
    assert torch.isfinite(nll).all() and nll[2].item() >= 1e29  # infeasible: the -1e30 sentinel
    assert ((nll - nll_ref).abs() / nll_ref.abs().clamp(min=1.0)).max().item() <= NLL_REL_TOL
    assert (grad - grad_ref).abs().max().item() <= GRAD_ABS_TOL
    assert grad[1, 250:].abs().max().item() == 0.0  # no gradient past the length
    assert torch.equal(chains, c_ref)
    assert _rel_err(betas, b_ref) <= NLL_REL_TOL
    # the same posteriors, summed in another order
    assert (coll - coll_ref).abs().max().item() <= 1e-5
    # no atomics: the same bits on a second call
    assert torch.equal(grad, ctc.ctc_grad(*args, alphas, nll, gd, v1 - 1))


@pytest.mark.gpu
def test_ctc_cuda_backward_past_8192_states(cuda_device):
    """U = 4200 (8401 states, more than 8 per thread of the beta kernel's
    1024): the states past 8192 read their emit on the chain."""
    rng = np.random.RandomState(1)
    b, t, v1, u = 2, 4400, 40, 4200
    lp = torch.log_softmax(torch.from_numpy(rng.randn(b, t, v1).astype(np.float32) * 3), -1)
    targets = torch.from_numpy(rng.randint(0, v1 - 1, (b, u)).astype(np.int32))
    il = torch.tensor([4400, 4300], dtype=torch.int32)
    tl = torch.tensor([4200, 3000], dtype=torch.int32)
    g = torch.tensor([1.0, 0.5], device=cuda_device)
    args = [x.to(cuda_device) for x in (lp, targets, il, tl)]
    alphas, nll = ctc.ctc_alphas(*args, v1 - 1)
    betas, chains = ctc.ctc_betas(*args, v1 - 1)
    b_ref, c_ref = ctc.ctc_betas_reference(*args, v1 - 1)
    grad = ctc.ctc_grad(*args, alphas, nll, g, v1 - 1)
    grad_ref = ctc.ctc_grad_reference(*args, alphas, nll, g, v1 - 1)
    torch.cuda.synchronize()
    assert torch.isfinite(nll).all() and (nll < 1e29).all()
    assert torch.equal(chains, c_ref)
    assert _rel_err(betas, b_ref) <= NLL_REL_TOL
    assert (grad - grad_ref).abs().max().item() <= GRAD_ABS_TOL
    assert torch.equal(grad, ctc.ctc_grad(*args, alphas, nll, g, v1 - 1))


# K3 vs its plain version in fp32: the same recursion in the same order
LATTICE_REL_TOL = 1e-5
# K4 vs its plain version in bf16: max|kernel - plain| <= 2e-2 * max|plain| per output
JOINT_REL_TOL = 2e-2


def _lattice_inputs(dev, b, t, u1, seed=0):
    g = torch.Generator().manual_seed(seed)
    bl = torch.log(torch.rand(b, t, u1, generator=g) * 0.9 + 0.05)
    lb = torch.log(torch.rand(b, t, u1, generator=g) * 0.9 + 0.05)
    lb[:, :, -1] = -1e30
    return bl.to(dev), lb.to(dev)


def _rel_err(a, b):
    return ((a - b).abs() / b.abs().clamp(min=1.0)).max().item()


def _ragged(b, t, u_lo, u_hi, seed):
    """Loader-like lengths: frames from 60% of T to T (one row at T), labels
    drawn from [u_lo, u_hi]."""
    rng = np.random.RandomState(seed)
    t_lens = rng.randint(int(0.6 * t), t + 1, b)
    t_lens[0] = t
    return t_lens.tolist(), rng.randint(u_lo, u_hi + 1, b).tolist()


# (T, U+1, t_lens, u_lens): the transducer step's shape (B 16, T 391, U+1
# 129, ~20-50 labels); widths 63-66 about the warp path's 64; B 200, more
# blocks than SMs; rows at the full width U+1 beside a u_len = 0 and a
# t_len = 1 row; U+1 1100 (the block path in two strips)
LATTICE_CASES = {
    "small": (60, 12, [60, 41, 1, 7], [11, 5, 0, 0]),
    "u1_1100": (37, 1100, [37, 20], [1099, 600]),
    "transducer_step": (391, 129, *_ragged(16, 391, 20, 50, 0)),
    "warp_block_boundary": (80, 129, [80, 80, 61, 1, 80], [63, 64, 62, 65, 0]),
    "b200": (60, 70, *_ragged(200, 60, 0, 69, 1)),
    "full_width_rows": (50, 97, [50, 50, 1, 50, 33], [96, 96, 96, 0, 96]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(LATTICE_CASES))
def test_rnnt_lattice_cuda_kernels_match_plain(cuda_device, case):
    """Each kernel against its plain version, the same bits on a second
    call; each sample's path and dependent diagonals as the kernel reports
    them: the warp path up to 64 columns, the block path past it, one strip
    up to the 1024 columns of 16 sweep warps (two at U+1 1100); then every
    sample forced onto the block path by a block of one warp (strips of 64
    columns), which must give the same bits: both paths take the same
    operations per cell in the same order."""
    from conformer_nemo_tpu_torch.ops import rnnt_lattice as lat

    t, u1, t_lens, u_lens = LATTICE_CASES[case]
    bl, lb = _lattice_inputs(cuda_device, len(t_lens), t, u1)
    tl = torch.tensor(t_lens, dtype=torch.int32, device=cuda_device)
    ul = torch.tensor(u_lens, dtype=torch.int32, device=cuda_device)
    outside = ~lat.valid_cells(bl.shape, tl, ul)
    rows = [min(a, t) for a in t_lens]
    widths = [min(c, u1 - 1) + 1 for c in u_lens]

    def plan_of(width, rows, strip):
        if width == 0 or rows == 0:
            return ["empty", 0]
        path = "warp" if width <= 64 and strip > 64 else "block"
        return [path, -(-width // strip) * (rows - 1) + width]

    for name, counter, fn, plain in (
            ("rnnt_alpha_f32", lat.alpha_launches, lat.rnnt_alphas, lat.rnnt_alphas_reference),
            ("rnnt_beta_f32", lat.beta_launches, lat.rnnt_betas, lat.rnnt_betas_reference)):
        got, again, want = fn(bl, lb, tl, ul), fn(bl, lb, tl, ul), plain(bl, lb, tl, ul)
        assert _rel_err(got, want) <= LATTICE_REL_TOL, name
        assert (got[outside] == -1e30).all(), name
        assert torch.equal(got, again), name
        for threads, strip in ((None, 1024), (32, 64)):
            plan = torch.full((len(t_lens), 2), -1, dtype=torch.int32, device=cuda_device)
            out = lat._launch(name, counter, bl, lb, tl, ul, threads=threads, plan=plan)
            torch.cuda.synchronize()
            assert torch.equal(out, got), (name, threads)
            assert [[lat.PATHS[p], n] for p, n in plan.tolist()] == \
                [plan_of(w, r, strip) for w, r in zip(widths, rows)], (name, threads)


def _joint_inputs(dev, b, t, u, h, v, seed=0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    bf = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(dev, dtype)
    e, p = bf(b, t, h, scale=0.5), bf(b, u + 1, h, scale=0.5)
    w, bias = bf(h, v, scale=h ** -0.5), bf(v, scale=0.1)
    targets = torch.randint(0, v - 1, (b, u), generator=g).to(dev, torch.int32)
    return e, p, w, bias, targets, g


@pytest.mark.gpu
@pytest.mark.parametrize("activation,drop_t,clamp,v", [("relu", 0, -1.0, 41), ("tanh", 26, 2.0, 41),
                                                      ("relu", 26, -1.0, 401),
                                                      ("relu", 26, -1.0, 1025)])
def test_rnnt_joint_cuda_kernels_match_plain(cuda_device, activation, drop_t, clamp, v):
    """V = 41: VL = 40 ragged; V = 401: VL = 400 pads to 416 label columns,
    which the backward kernels take in two passes; V = 1025 (the flagship
    1024 pieces and the blank): four passes, and a forward whose W rows
    need padding to 16 bytes."""
    from conformer_nemo_tpu_torch.ops import rnnt_joint as jt

    b, t, u, h = 3, 37, 8, 64  # T not a multiple of 16
    e, p, w, bias, targets, g = _joint_inputs(cuda_device, b, t, u, h, v)
    seed = torch.tensor([12345], dtype=torch.int32)
    t_lens = torch.tensor([37, 20, 1], dtype=torch.int32, device=cuda_device)
    u_lens = torch.tensor([8, 3, 0], dtype=torch.int32, device=cuda_device)
    kw = dict(t_lens=t_lens, u_lens=u_lens, blank_id=v - 1, activation=activation,
              drop_t=drop_t, bt=16)
    fwd = jt.joint_flash_fwd(e, p, w, bias, targets, seed, **kw)
    fwd_ref = jt.joint_flash_fwd_reference(e, p, w, bias, targets, seed, **kw)
    inside = (torch.arange(t, device=cuda_device)[None, :, None] < t_lens[:, None, None]) & (
        torch.arange(u + 1, device=cuda_device)[None, None, :] <= u_lens[:, None, None])
    # posteriors non-zero outside the lattice too: both versions ignore them there
    post = [torch.rand(b, t, u + 1, generator=g).to(cuda_device) * s for s in (1.1, 0.6, 0.6)]
    gg = torch.tensor([1.0, 0.5, 2.0], device=cuda_device)
    args = (e, p, w, bias, targets, fwd_ref[2].contiguous(), *post, gg, seed)
    bwd = jt.joint_flash_bwd(*args, clamp=clamp, **kw)
    bwd_ref = jt.joint_flash_bwd_reference(*args, clamp=clamp, **kw)
    # windows of 64 cells: the lattice's 414 cells in seven windows, summed in order
    small = jt.joint_flash_bwd_windowed(*args, clamp=clamp, window=64, **kw)
    # each backward kernel against its plain version on the same inputs
    w_pad, w_blank = jt.pad_label_block(w, v - 1)
    pkw = dict(t_lens=t_lens, u_lens=u_lens, activation=activation, drop_t=drop_t, bt=16)
    n = int((t_lens * (u_lens + 1)).sum())  # the lattice's cells
    win, _ = jt.bwd_windows(b * t * (u + 1), h, v)
    cells = jt.joint_flash_bwd_cells(e, p, w_pad, w_blank, *args[3:], c0=0, win=win,
                                     clamp=clamp, **pkw)
    cells_ref = jt.joint_flash_bwd_cells_reference(e, p, w_pad, w_blank, *args[3:], c0=0,
                                                   win=win, clamp=clamp, **pkw)
    skw = dict(t_lens=t_lens, u_lens=u_lens, c0=0, win=win)
    acc = jt.joint_flash_bwd_sums(cells, jt.bwd_accumulators(b, t, u + 1, h, v, cuda_device),
                                  **skw)
    acc_ref = jt.joint_flash_bwd_sums_reference(
        cells, jt.bwd_accumulators(b, t, u + 1, h, v, cuda_device), **skw)
    torch.cuda.synchronize()
    for name, a, r, rows in zip(("dlab", "dblank", "dx", "h", "db_tiles"), cells, cells_ref,
                                (n, n, n, n, -(-n // 64))):  # the rows the kernel writes
        a, r = a[:rows].float(), r[:rows].float()
        assert (a - r).abs().max().item() <= JOINT_REL_TOL * r.abs().max().item(), name
    for a, r in zip(acc, acc_ref):  # fp32 sums of the same bf16 values, another order
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
    for a, r in zip(jt.joint_flash_bwd_reduce(acc, e.dtype),
                    jt.joint_flash_bwd_reduce_reference(acc, e.dtype)):
        torch.testing.assert_close(a.float(), r.float(), rtol=1e-5, atol=1e-5)
    for a, r in zip(small, bwd):
        torch.testing.assert_close(a.float(), r.float(), rtol=1e-4, atol=1e-4)
    # no atomics: the same bits on a second call
    assert all(torch.equal(a, r) for a, r in zip(bwd, jt.joint_flash_bwd(*args, clamp=clamp, **kw)))
    assert all(torch.equal(a, r) for a, r in zip(fwd, jt.joint_flash_fwd(e, p, w, bias, targets,
                                                                         seed, **kw)))
    torch.cuda.synchronize()
    for name, a, r in zip(("blank_lp", "label_lp", "lse"), fwd, fwd_ref):
        assert torch.equal(a[~inside], r[~inside]), name  # the sentinels
        a, r = a[inside], r[inside]
        assert torch.isfinite(a).all(), name
        assert (a - r).abs().max().item() <= JOINT_REL_TOL * r.abs().max().item(), name
    for name, a, r in zip(("de", "dp", "dw", "db"), bwd, bwd_ref):
        a, r = a.float(), r.float()
        assert torch.isfinite(a).all(), name
        assert (a - r).abs().max().item() <= JOINT_REL_TOL * r.abs().max().item(), name


def _fwd_edges(jt):
    """The widest H (multiples of 16) of the forward's 128- and 64-cell tiles."""
    rows = {h: jt.fwd_rows(h) for h in range(16, 2048, 16)}
    return tuple(max(h for h, r in rows.items() if r == n) for n in (128, 64))


@pytest.mark.gpu
@pytest.mark.parametrize("edge,v", [(0, 296), (1, 41)])
def test_rnnt_joint_cuda_fwd_at_the_edge_of_its_tiles(cuda_device, edge, v):
    """The forward at the widest H of each tile height against the plain
    version, with the persistent grid at one block, three blocks and one
    per SM (one block walks every tile): the same bits every time. Just past
    the 64-cell tile's H, check_smem refuses and the wrapper raises before a
    launch."""
    from conformer_nemo_tpu_torch.ops import rnnt_joint as jt

    edges = _fwd_edges(jt)
    assert edges == (672, 1376)  # the range rnnt_joint.cu's design note states
    h, b, t, u = edges[edge], 3, 29, 9
    assert jt.fwd_rows(h) == (128, 64)[edge]
    e, p, w, bias, targets, _ = _joint_inputs(cuda_device, b, t, u, h, v)
    seed = torch.tensor([4242], dtype=torch.int32)
    t_lens = torch.tensor([29, 11, 1], dtype=torch.int32, device=cuda_device)
    u_lens = torch.tensor([9, 4, 0], dtype=torch.int32, device=cuda_device)
    kw = dict(t_lens=t_lens, u_lens=u_lens, blank_id=v - 1, drop_t=26, bt=16)
    ref = jt.joint_flash_fwd_reference(e, p, w, bias, targets, seed, **kw)
    inside = (torch.arange(t, device=cuda_device)[None, :, None] < t_lens[:, None, None]) & (
        torch.arange(u + 1, device=cuda_device)[None, None, :] <= u_lens[:, None, None])
    runs = []
    for grid in (1, 3, None):
        outs = [torch.empty((b, t, u + 1), dtype=torch.float32, device=cuda_device)
                for _ in range(3)]
        jt._launch_fwd(e, p, jt.fwd_weight(w), bias, targets, seed, t_lens, u_lens, outs, v, 0,
                       26, 16, grid=grid)
        runs.append(outs)
    torch.cuda.synchronize()
    for outs in runs:
        assert all(torch.equal(a, r) for a, r in zip(outs, runs[0]))
    for name, a, r in zip(("blank_lp", "label_lp", "lse"), runs[0], ref):
        assert torch.equal(a[~inside], r[~inside]), name
        a, r = a[inside], r[inside]
        assert (a - r).abs().max().item() <= JOINT_REL_TOL * r.abs().max().item(), name
    past = edges[1] + 16
    assert jt.fwd_rows(past) == 0
    with pytest.raises(ValueError, match="shared memory"):
        jt.check_smem(past, v, (0,))
    e2, p2, w2, bias2, targets2, _ = _joint_inputs(cuda_device, 1, 4, 2, past, v)
    before = jt.fwd_launches.total
    with pytest.raises(ValueError, match="shared memory"):
        jt.joint_flash_fwd(e2, p2, w2, bias2, targets2, seed, t_lens=t_lens[:1].clamp(max=4),
                           u_lens=u_lens[:1].clamp(max=2), blank_id=v - 1)
    assert jt.fwd_launches.total == before


@pytest.mark.gpu
def test_rnnt_joint_cuda_smem_limits(cuda_device):
    """The backward's kernels take every H the forward takes: check_smem
    passes at every H with fwd_rows(H) > 0 (to 1376, any H padded to 16) at
    the shipped vocabularies, and refuses H 1392 in the 16-bit dtypes; the
    fp32 kernels take any H."""
    from conformer_nemo_tpu_torch.ops import rnnt_joint as jt

    takes = [h for h in range(1, 1400) if jt.fwd_rows(h) > 0]
    assert takes == list(range(1, 1377))
    for v in (296, 584, 1025):
        for h in takes:
            jt.check_smem(h, v, (1, 2))
            jt.check_smem(h, v, (0, 1, 2), torch.float16)
        with pytest.raises(ValueError, match="shared memory"):
            jt.check_smem(1392, v)
        jt.check_smem(2048, v, (0, 1, 2), torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,h,v,drop_t,activation", [
    (torch.float16, 64, 41, 26, "tanh"), (torch.float16, 640, 296, 26, "relu"),
    (torch.float32, 64, 41, 26, "tanh"), (torch.float32, 640, 401, 26, "sigmoid"),
    (torch.bfloat16, 1024, 296, 26, "relu"), (torch.bfloat16, 1376, 296, 0, "relu"),
    (torch.bfloat16, 600, 296, 26, "sigmoid"), (torch.bfloat16, 100, 41, 26, "relu")])
def test_rnnt_joint_cuda_kernels_in_every_dtype_and_width(cuda_device, dtype, h, v, drop_t,
                                                          activation):
    """K4's forward and whole backward in fp16 (4e-3 of max) and fp32
    (2e-5, TF32 off) against the plain version in that dtype, and bf16 (2e-2)
    at H 1024 and 1376 (past the old backward's 640) and at H 600 and 100
    (padded to 608 and 112, the hash at the true H): the same bits on a
    second call, counted under the dtype's kernel names."""
    from conformer_nemo_tpu_torch.ops import rnnt_joint as jt

    tol = {torch.bfloat16: 2e-2, torch.float16: 4e-3, torch.float32: 2e-5}[dtype]
    torch.backends.cuda.matmul.allow_tf32 = False
    b, t, u = 3, 37, 8
    e, p, w, bias, targets, g = _joint_inputs(cuda_device, b, t, u, h, v, dtype=dtype)
    seed = jt.joint_seed(555, 7, t, u + 1, h, 16)
    t_lens = torch.tensor([37, 20, 1], dtype=torch.int32, device=cuda_device)
    u_lens = torch.tensor([8, 3, 0], dtype=torch.int32, device=cuda_device)
    kw = dict(t_lens=t_lens, u_lens=u_lens, blank_id=v - 1, activation=activation,
              drop_t=drop_t, bt=16)
    counts = [jt.counter(k, dtype) for k in ("fwd", "cells", "sums", "reduce")]
    before = [c.total for c in counts]
    fwd = jt.joint_flash_fwd(e, p, w, bias, targets, seed, **kw)
    fwd_ref = jt.joint_flash_fwd_reference(e, p, w, bias, targets, seed, **kw)
    inside = (torch.arange(t, device=cuda_device)[None, :, None] < t_lens[:, None, None]) & (
        torch.arange(u + 1, device=cuda_device)[None, None, :] <= u_lens[:, None, None])
    post = [torch.rand(b, t, u + 1, generator=g).to(cuda_device) * s for s in (1.1, 0.6, 0.6)]
    args = (e, p, w, bias, targets, fwd_ref[2].contiguous(), *post,
            torch.tensor([1.0, 0.5, 2.0], device=cuda_device), seed)
    bwd = jt.joint_flash_bwd(*args, clamp=2.0, **kw)
    bwd_ref = jt.joint_flash_bwd_reference(*args, clamp=2.0, **kw)
    again = jt.joint_flash_bwd(*args, clamp=2.0, **kw)
    torch.cuda.synchronize()
    assert [c.total - n for c, n in zip(counts, before)] == [1, 2, 2, 2]
    assert all(torch.equal(a, r) for a, r in zip(bwd, again))
    for name, a, r in zip(("blank_lp", "label_lp", "lse"), fwd, fwd_ref):
        assert torch.equal(a[~inside], r[~inside]), name
        a, r = a[inside], r[inside]
        assert (a - r).abs().max().item() <= tol * r.abs().max().item(), name
    for name, a, r in zip(("de", "dp", "dw", "db"), bwd, bwd_ref):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        a, r = a.float(), r.float()
        assert torch.isfinite(a).all(), name
        assert (a - r).abs().max().item() <= tol * r.abs().max().item(), name


@pytest.mark.gpu
def test_rnnt_joint_cuda_dropout_mask_is_the_hash_mask(cuda_device):
    """Probe: W_lab the identity, p = 0, e a positive constant: each cell's
    label logit is its h at the target column, c * inv_keep if kept and 0 if
    dropped, so the kernel's keep bit there can be read off label_lp + lse
    and is held against hash_keep_mask_reference bit for bit."""
    from conformer_nemo_tpu_torch.ops import rnnt_joint as jt

    b, t, u, h, bt, drop_t = 2, 35, 15, 64, 16, 64
    dev = cuda_device
    gen = torch.Generator().manual_seed(3)
    targets = torch.randint(0, h, (b, u), generator=gen).to(dev, torch.int32)
    e = torch.full((b, t, h), 0.5, dtype=torch.bfloat16, device=dev)
    p = torch.zeros((b, u + 1, h), dtype=torch.bfloat16, device=dev)
    w = torch.cat([torch.eye(h), torch.zeros(h, 1)], dim=1).to(dev, torch.bfloat16)
    bias = torch.zeros(h + 1, dtype=torch.bfloat16, device=dev)
    seed = torch.tensor([-987654321], dtype=torch.int32)
    full = lambda n: torch.full((b,), n, dtype=torch.int32, device=dev)
    _, label_lp, lse = jt.joint_flash_fwd(e, p, w, bias, targets, seed, t_lens=full(t),
                                          u_lens=full(u), blank_id=h, drop_t=drop_t, bt=bt)
    kept = (label_lp + lse) > 0.25
    mask = jt.hash_keep_mask_reference((b, jt.padded_t(t, bt), u + 1, h), seed, drop_t,
                                       device=dev)[:, :t]
    tgt = torch.nn.functional.pad(targets.long(), (0, 1))[:, None, :, None].expand(b, t, u + 1, 1)
    want = torch.gather(mask, 3, tgt)[..., 0]
    assert torch.equal(kept, want)
    assert 0.6 < want.float().mean().item() < 0.9


@pytest.mark.gpu
def test_rnnt_joint_cuda_mask_and_gradients_at_a_row_offset(cuda_device):
    """A data-parallel rank's rows: with `joint_seed`'s hash base (here past
    2^32, so it wraps) the forward's mask is hash_keep_mask_reference's at
    that base, bit for bit, and the backward regenerates it: K4's gradients
    follow the plain version's at the same base (2e-2 of max|plain|, as the
    card's other K4 checks) and differ from the base-0 run's."""
    from conformer_nemo_tpu_torch.ops import rnnt_joint as jt

    b, t, u, h, v, bt, drop_t = 2, 35, 15, 64, 9, 16, 64
    dev = cuda_device
    gen = torch.Generator().manual_seed(5)
    e = (0.5 * torch.randn(b, t, h, generator=gen)).to(dev, torch.bfloat16)
    p = (0.5 * torch.randn(b, u + 1, h, generator=gen)).to(dev, torch.bfloat16)
    w = (torch.randn(h, v, generator=gen) / 8).to(dev, torch.bfloat16)
    bias = torch.zeros(v, dtype=torch.bfloat16, device=dev)
    targets = torch.randint(0, v - 1, (b, u), generator=gen).to(dev, torch.int32)
    row = 1_000_003
    seed = jt.joint_seed(77, row, t, u + 1, h, bt)
    assert (row * jt.padded_t(t, bt) * (u + 1) * h) >> 32 and int(seed[1])  # the base wraps
    full = lambda n: torch.full((b,), n, dtype=torch.int32, device=dev)
    kw = dict(t_lens=full(t), u_lens=full(u), blank_id=v - 1, drop_t=drop_t, bt=bt)
    outs = jt.joint_flash_fwd(e, p, w, bias, targets, seed, **kw)
    refs = jt.joint_flash_fwd_reference(e, p, w, bias, targets, seed, **kw)
    for o, r in zip(outs, refs):
        assert (o - r).abs().max() <= 2e-2 * r.abs().max()
    g_in = [torch.rand(b, t, u + 1, generator=gen).to(dev) for _ in range(3)]
    args = (e, p, w, bias, targets, outs[2], *g_in, torch.ones(b, device=dev))
    grads = jt.joint_flash_bwd(*args, seed, **kw)
    want = jt.joint_flash_bwd_reference(*args, seed, **kw)
    base0 = jt.joint_flash_bwd(*args, torch.tensor([77], dtype=torch.int32), **kw)
    for g, r in zip(grads, want):
        g, r = g.float(), r.float()
        assert (g - r).abs().max() <= 2e-2 * r.abs().max()
    assert not torch.equal(grads[0], base0[0])


@pytest.mark.gpu
@pytest.mark.parametrize("mode,factor", [("vggnet", 4), ("resnet", 4), ("subencoder", 8),
                                         ("stacking", 4), ("none", 1)])
def test_subsampling_modes_on_the_card_match_the_cpu(cuda_device, mode, factor):
    """A tiny fp32 encoder of each front end in training mode (its 2-D
    BatchNorms' batch statistics) on the card and on the CPU: outputs
    within 1e-4 absolute (cuDNN's and the CPU's convolution algorithms sum
    in other orders), lengths and the running statistics equal within it."""
    from conformer_nemo_tpu_torch.models.conformer import ConformerEncoder, ConformerEncoderConfig

    cfg = ConformerEncoderConfig(feat_in=20, n_layers=1, d_model=32, n_heads=2,
                                 conv_kernel_size=7, subsampling=mode, subsampling_factor=factor,
                                 subsampling_conv_channels=8, dropout=0.0, dropout_att=0.0,
                                 dtype=torch.float32, use_flash_attention=False)
    torch.manual_seed(0)
    cpu = ConformerEncoder(cfg).train()
    card = ConformerEncoder(cfg).train()
    card.load_state_dict(cpu.state_dict())
    card.to(cuda_device)
    g = torch.Generator().manual_seed(1)
    feats = torch.randn(3, 20, 77, generator=g)
    lens = torch.tensor([77, 59, 9], dtype=torch.int32)
    with torch.no_grad():
        y, yl = cpu(feats, lens)
        z, zl = card(feats.to(cuda_device), lens.to(cuda_device))
    assert torch.equal(yl, zl.cpu())
    torch.testing.assert_close(z.cpu(), y, rtol=0, atol=1e-4)
    want = cpu.state_dict()
    for k, v in card.state_dict().items():
        torch.testing.assert_close(v.cpu(), want[k], rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True], ids=["projected", "quantised"])
def test_ssl_objective_on_the_card_matches_the_cpu(cuda_device, quantized):
    """A tiny fp32 SSL model (dense attention) on the card and on the CPU
    with the same weights, masks and Gumbel draws: the contrastive loss
    within 1e-4 relative and every gradient within 1e-3 of its tensor's
    largest entry (fp32 on both; the card's reductions sum in other orders);
    the two biases whose gradient is zero in exact arithmetic (the attention
    key bias under softmax's shift invariance, the depthwise-conv bias that
    training BatchNorm subtracts) hold rounding only, within 1e-5."""
    from conformer_nemo_tpu_torch.api_ssl import SpeechSSLModel, mask_inputs
    from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig
    from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig
    from conformer_nemo_tpu_torch.ops.contrastive_loss import ContrastiveLossConfig

    enc = ConformerEncoderConfig(feat_in=16, n_layers=1, d_model=32, n_heads=2,
                                 conv_kernel_size=7, dropout=0.0, dropout_att=0.0,
                                 dtype=torch.float32, use_flash_attention=False)
    loss = ContrastiveLossConfig(in_dim=16, proj_dim=8, num_negatives=5,
                                 quantized_targets=quantized, codebook_size=12)
    models = {d: SpeechSSLModel(encoder=enc, mel=MelFeatureConfig(features=16), loss=loss,
                                patch_size=4, mask_patches=3, device=d)
              for d in ("cpu", cuda_device)}
    models[cuda_device].model.load_state_dict(models["cpu"].model.state_dict())
    g = torch.Generator().manual_seed(2)
    spec = torch.randn(3, 16, 96, generator=g)
    lens = torch.tensor([96, 80, 50])
    masked, spec_masks = mask_inputs(spec, lens, 4, 3, mask_generator=g)
    noise = models["cpu"].model.loss.draw_noise(3, 96, g, "cpu")
    out = []
    for d, m in models.items():
        move = lambda x: x.to(d)
        value = m.loss(move(spec), move(lens), move(masked), move(spec_masks), step=5,
                       noise={k: move(v) for k, v in noise.items()})
        names, params = zip(*m.model.named_parameters())
        grads = torch.autograd.grad(value, params, allow_unused=True)
        out.append((float(value.detach()), [None if x is None else x.cpu() for x in grads]))
    (lc, gc), (lg, gg) = out
    assert lg == pytest.approx(lc, rel=1e-4)
    for name, a, b in zip(names, gg, gc):
        if b is None:
            continue
        err = float((a - b).abs().max())
        if name.endswith(("self_attn.linear_k.bias", "conv.depthwise_conv.bias")):
            assert err <= 1e-5, name
        else:
            assert err <= 1e-3 * float(b.abs().max()), name


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["classification", "speaker"])
def test_label_models_on_the_card_match_the_cpu(cuda_device, kind):
    """MatchboxNet and a narrow ECAPA, fp32, on the card (cuDNN, TF32 off)
    and on the CPU with the same weights: logits and embeddings within 1e-4
    absolute in inference, and a training forward's BatchNorm statistics
    within it too (convolution algorithms sum in other orders)."""
    from conformer_nemo_tpu_torch.api_label import ClassificationModel, SpeakerLabelModel

    def make(d):
        if kind == "classification":
            return ClassificationModel(["a", "b", "c"], device=d)
        return SpeakerLabelModel(["a", "b", "c"], filters=(64, 64, 64, 64, 192), device=d)

    cpu, card = make("cpu"), make(cuda_device)
    card.model.load_state_dict(cpu.model.state_dict())
    g = torch.Generator().manual_seed(3)
    audio = (0.1 * torch.randn(4, 16000, generator=g)).numpy()
    lens = np.array([16000, 12000, 16000, 9000], np.int32)
    outputs = lambda x: x if isinstance(x, tuple) else (x,)  # the speaker's (logits, emb)
    for a, b in zip(outputs(card._infer(audio, lens)), outputs(cpu._infer(audio, lens))):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)
    feats, flens = cpu._features(audio, lens)
    cpu.model.train()
    card.model.train()
    with torch.no_grad():
        cpu.model(feats, flens, torch.Generator().manual_seed(0))
        card.model(feats.to(cuda_device), flens.to(cuda_device),
                   torch.Generator(device=cuda_device).manual_seed(0))
    ref = cpu.model.state_dict()
    for k, v in card.model.state_dict().items():
        torch.testing.assert_close(v.cpu(), ref[k], rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_diarizer_embeddings_on_the_card_match_the_cpu(cuda_device, tmp_path):
    """The diarizer's window embeddings (one batch of every window through a
    narrow ECAPA, fp32, cuDNN's TF32 off) on the card and on the CPU with
    the same weights within 1e-5, and the same turns."""
    from conformer_nemo_tpu_torch.api_label import SpeakerLabelModel
    from conformer_nemo_tpu_torch.data.audio_io import write_wav
    from conformer_nemo_tpu_torch.decode.diarization import ClusteringDiarizer

    sr = 16000
    t = np.arange(3 * sr) / sr
    rs = np.random.RandomState(0)
    session = np.concatenate([0.3 * np.sin(2 * np.pi * f0 * t) + 0.01 * rs.randn(len(t))
                              for f0 in (140, 520, 140)]).astype(np.float32)
    path = str(tmp_path / "session.wav")
    write_wav(path, session, sr)
    cpu = SpeakerLabelModel(["a", "b"], filters=(64, 64, 64, 64, 192), device="cpu")
    card = SpeakerLabelModel(["a", "b"], filters=(64, 64, 64, 64, 192), device=cuda_device)
    card.model.load_state_dict(cpu.model.state_dict())
    segs_c, emb_c = ClusteringDiarizer(card).window_embeddings(path)
    segs_h, emb_h = ClusteringDiarizer(cpu).window_embeddings(path)
    assert segs_c == segs_h and emb_c.shape == (len(segs_h), 192)
    assert np.abs(emb_c - emb_h).max() <= 1e-5
    assert ClusteringDiarizer(card).diarize(path, 2) == ClusteringDiarizer(cpu).diarize(path, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_rnn_encoder_on_the_card_matches_the_cpu(cuda_device, dtype, rel):
    """RNNEncoder (4 bidirectional layers, d_model 256, striding x4) and an
    LSTM head on the card and on the CPU with the same weights: outputs
    within `rel` of their largest magnitude (fp32: summation orders; bf16:
    the gates' products round to bf16, one ulp is 4e-3), lengths equal."""
    from conformer_nemo_tpu_torch.models.rnn_encoder import (
        LSTMDecoder,
        LSTMDecoderConfig,
        RNNEncoder,
        RNNEncoderConfig,
    )

    cfg = RNNEncoderConfig(d_model=256, dtype=dtype)
    head_cfg = LSTMDecoderConfig(feat_in=256, dtype=dtype)
    enc_h, head_h = RNNEncoder.create(cfg, device="cpu"), LSTMDecoder.create(head_cfg, device="cpu")
    enc_c = RNNEncoder.create(cfg, device=cuda_device)
    head_c = LSTMDecoder.create(head_cfg, device=cuda_device)
    enc_c.load_state_dict(enc_h.state_dict())
    head_c.load_state_dict(head_h.state_dict())
    g = torch.Generator().manual_seed(1)
    feats = torch.randn(2, 80, 400, generator=g)
    lens = torch.tensor([400, 311], dtype=torch.int32)
    with torch.no_grad():
        out_h, lens_h = enc_h(feats, lens)
        out_c, lens_c = enc_c(feats.to(cuda_device), lens.to(cuda_device))
        lp_h, lp_c = head_h(out_h), head_c(out_c)
    assert torch.equal(lens_c.cpu(), lens_h) and out_c.shape == out_h.shape == (2, 256, 100)
    for a, b in ((out_c, out_h), (lp_c, lp_h)):
        assert float((a.cpu() - b).abs().max()) <= rel * float(b.abs().max())
