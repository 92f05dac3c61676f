"""`device_prefetch` on the card: the CUDA path (pinned ring, side-stream
copies, the consumer's stream waiting on each copy's event).

Needs an NVIDIA GPU and skips without one. This file imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_prefetch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from conformer_nemo_tpu_torch.data.dataset import Batch
from conformer_nemo_tpu_torch.data.prefetch import device_prefetch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the prefetch's CUDA path has no CPU mode")
    return torch.device("cuda")


def _batches(n, seed=0):
    """Batches of three bucket shapes and all three wire dtypes."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        t = (16000, 48000, 32000)[i % 3]
        dtype = (np.float32, np.int16, np.int8)[i % 3]
        audio = (rng.randn(4, t) * 100).astype(dtype)
        out.append(Batch(audio, rng.randint(1, t, 4).astype(np.int32),
                         rng.randint(0, 500, (4, 24)).astype(np.int32),
                         rng.randint(0, 24, 4).astype(np.int32), [f"t{i}"] * 4))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetch_keeps_order_and_contents_on_the_card(cuda_device, depth):
    want = _batches(12)
    got = []
    for b in device_prefetch(iter(want), cuda_device, depth=depth):
        # consume on the default stream, as a train step does
        got.append({k: getattr(b, k).clone() for k in ("audio", "audio_lens", "tokens",
                                                        "token_lens")} | {"texts": b.texts})
        torch.cuda._sleep(1_000_000)  # a slow step, so copies run ahead of use
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in ("audio", "audio_lens", "tokens", "token_lens"):
            assert a[k].device.type == "cuda"
            np.testing.assert_array_equal(a[k].cpu().numpy(), getattr(b, k))
        assert a["texts"] == b.texts


@pytest.mark.gpu
def test_prefetch_stops_early_and_surfaces_errors(cuda_device):
    gen = device_prefetch(iter(_batches(20)), cuda_device)
    first = next(gen)
    gen.close()
    assert first.audio.shape == (4, 16000)

    def failing():
        yield from _batches(2)
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(device_prefetch(failing(), cuda_device))
