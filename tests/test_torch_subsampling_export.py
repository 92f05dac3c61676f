"""`.nemo` checkpoints of a resnet CTC and a subencoder transducer, written
by the test with NeMo's extra entries, load in the port as the JAX
converter loads them, and each subsampling mode's CTC model exports
(`torch.export`) to a program equal to the live forward.
"""

import os

import numpy as np
import pytest
import torch

from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer
from conformer_nemo_tpu_torch.audio.features import log_mel_spectrogram
from conformer_nemo_tpu_torch.utils.export import load_exported

from test_torch_nemo import _check_both, _nemo_config, _nemo_state, _write_nemo
from test_torch_portable import ENC as PENC
from test_torch_portable import RNNT, ROOT

torch.set_num_threads(2)


NEMO_CASES = {"resnet": ("ctc", "conformer_ctc_char.yaml"),
              "subencoder": ("rnnt", "conformer_transducer_char.yaml")}


@pytest.mark.parametrize("mode", sorted(NEMO_CASES))
def test_nemo_checkpoint_loads(mode, tmp_path):
    """A `.nemo` of a resnet CTC and of a subencoder transducer, written by
    the test (the front end's BatchNorm2d counters included), converts in
    the port and in the JAX package to the same weights, and the port's
    restore transcribes as the source model."""
    kind, config = NEMO_CASES[mode]
    cls = ConformerCTC if kind == "ctc" else ConformerTransducer
    over = {**PENC, "model.encoder.subsampling": mode,
            "model.encoder.subsampling_conv_channels": 8, **(RNNT if kind == "rnnt" else {})}
    pm = cls.from_config_file(os.path.join(ROOT, "configs", config), overrides=over,
                              device="cpu", dtype=torch.float32, seed=3)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in pm.model.parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=gen))
        for name, b in pm.model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    sd = _nemo_state(pm)
    for k in list(sd):
        if ".pre_encode." in k and k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(5)
    assert any(".batchnorm1.num_batches_tracked" in k for k in sd)
    nemo = _write_nemo(str(tmp_path / f"{mode}.nemo"), _nemo_config(pm), sd)
    restored, _ = _check_both(kind, pm, nemo, tmp_path)
    assert restored._encoder_config.subsampling == mode


@pytest.mark.parametrize("mode,factor", [("vggnet", 4), ("resnet", 4), ("subencoder", 8),
                                         ("stacking", 4), ("none", 1)])
def test_export_every_mode(mode, factor, tmp_path):
    """`export` of a CTC model of each front end: the reloaded program
    gives the live model's log-probs and lengths bit for bit."""
    pm = ConformerCTC.from_config_file(
        os.path.join(ROOT, "configs", "conformer_ctc_char.yaml"), device="cpu",
        dtype=torch.float32, seed=4,
        overrides={**PENC, "model.encoder.subsampling": mode,
                   "model.encoder.subsampling_factor": factor,
                   "model.encoder.subsampling_conv_channels": 8})
    path = str(tmp_path / "m.tar.gz")
    pm.export(path, batch_size=2, seconds=0.5)
    rng = np.random.RandomState(2)
    audio = torch.from_numpy((0.1 * rng.randn(2, 8000)).astype(np.float32))
    lens = torch.tensor([8000, 5000], dtype=torch.int32)
    out = load_exported(path)["forward"](audio, lens)
    with torch.no_grad():
        feats, fl = log_mel_spectrogram(pm.cfg.preprocessor, audio, lens)
        live = pm.model(feats, fl)
    assert torch.equal(out[1], live[1])
    assert torch.equal(out[0], live[0])
