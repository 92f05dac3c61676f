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
                                          (1251, 576, 64, (128, 32))])
def test_flash_fwd_cuda_kernel_matches_plain(cuda_device, t, d1, dv, band):
    qs, ks, v, _ = _flash_inputs(cuda_device, 4, t, d1, dv)
    lens = torch.tensor([t, t // 2, 1, 0], dtype=torch.int32, device=cuda_device)
    # the model's 1/sqrt(d_head): peaked rows, so o is of order 1 and the o limit bites
    scale = 1.0 / np.sqrt(64)
    o, lse = port.flash_attention_fwd(qs, ks, v, lens, scale, *band)
    o_ref, lse_ref = port.flash_attention_fwd_reference(qs, ks, v, lens, scale, *band)
    torch.cuda.synchronize()
    # bf16 output rounding plus a different summation order
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 2e-3


@pytest.mark.gpu
@pytest.mark.parametrize("t,d1,dv,band", [(1875, 576, 64, (-1, -1)), (200, 80, 16, (-1, -1)),
                                          (700, 576, 64, (128, 32)), (300, 40, 24, (16, -1))])
def test_flash_bwd_cuda_kernels_match_plain(cuda_device, t, d1, dv, band):
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


@pytest.mark.gpu
def test_ctc_cuda_kernels_match_plain(cuda_device):
    rng = np.random.RandomState(0)
    b, t, v1, u = 5, 300, 40, 30
    lp = torch.log_softmax(torch.from_numpy(rng.randn(b, t, v1).astype(np.float32) * 3), -1)
    targets = torch.from_numpy(rng.randint(0, v1 - 1, (b, u)).astype(np.int32))
    targets[1, 4:8] = 7  # repeats
    il = torch.tensor([300, 250, 17, 300, 1], dtype=torch.int32)
    tl = torch.tensor([30, 20, 25, 0, 0], dtype=torch.int32)  # row 2 infeasible, U = 0 rows
    g = torch.from_numpy(rng.rand(b).astype(np.float32))
    args = [x.to(cuda_device) for x in (lp, targets, il, tl)]
    alphas, nll = ctc.ctc_alphas(*args, v1 - 1)
    a_ref, nll_ref = ctc.ctc_alphas_reference(*args, v1 - 1)
    grad = ctc.ctc_grad(*args, alphas, nll, g.to(cuda_device), v1 - 1)
    grad_ref = ctc.ctc_grad_reference(*args, a_ref, nll_ref, g.to(cuda_device), v1 - 1)
    torch.cuda.synchronize()
    assert torch.isfinite(nll).all() and nll[2].item() >= 1e29  # infeasible: the -1e30 sentinel
    assert ((nll - nll_ref).abs() / nll_ref.abs().clamp(min=1.0)).max().item() <= NLL_REL_TOL
    assert (grad - grad_ref).abs().max().item() <= GRAD_ABS_TOL
    assert grad[1, 250:].abs().max().item() == 0.0  # no gradient past the length
