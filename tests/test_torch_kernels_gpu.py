"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU (the kernels have no CPU mode) and skips without one.
This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q
"""

import numpy as np
import pytest
import torch

from conformer_nemo_tpu_torch.ops import flash_attention as port


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("t,d1,dv,band", [(3001, 576, 64, (-1, -1)), (200, 80, 16, (-1, -1)),
                                          (1251, 576, 64, (128, 32))])
def test_flash_fwd_cuda_kernel_matches_plain(cuda_device, t, d1, dv, band):
    g = torch.Generator(device="cpu").manual_seed(0)
    bh = 4
    qs = torch.randn(bh, t, d1, generator=g).to(cuda_device, torch.bfloat16)
    ks = torch.randn(bh, t, d1, generator=g).to(cuda_device, torch.bfloat16)
    v = torch.randn(bh, t, dv, generator=g).to(cuda_device, torch.bfloat16)
    lens = torch.tensor([t, t // 2, 1, 0], dtype=torch.int32, device=cuda_device)
    # the model's 1/sqrt(d_head): peaked rows, so o is of order 1 and the o limit bites
    scale = 1.0 / np.sqrt(64)
    o, lse = port.flash_attention_fwd(qs, ks, v, lens, scale, *band)
    o_ref, lse_ref = port.flash_attention_fwd_reference(qs, ks, v, lens, scale, *band)
    torch.cuda.synchronize()
    # bf16 output rounding plus a different summation order
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 2e-3
