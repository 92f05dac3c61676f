"""Weight bridge round trip: NeMo-named state_dict -> JAX converter ->
the port's ctc_state_dict_from_jax must give back the same arrays, bit for
bit, and load strictly into the port's model."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.convert.nemo_weights import convert_ctc_model_state
from conformer_nemo_tpu.models.conformer import ConformerEncoderConfig as JaxEncoderConfig
from conformer_nemo_tpu.models.ctc_model import CTCModelConfig as JaxCTCConfig
from conformer_nemo_tpu_torch.convert.jax_params import ctc_state_dict_from_jax
from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig
from conformer_nemo_tpu_torch.models.ctc_model import CTCModel, CTCModelConfig

torch.set_num_threads(2)

V = 37
VARIANTS = {
    "batch_norm": dict(conv_norm_type="batch_norm"),
    "layer_norm": dict(conv_norm_type="layer_norm"),
    "shared_biases_narrow_subsampling": dict(untie_biases=False, subsampling_conv_channels=24),
    "abs_pos_feat_out": dict(self_attention_model="abs_pos", feat_out=48),
}


def _configs(**kw):
    enc = dict(feat_in=80, n_layers=2, d_model=64, n_heads=4, conv_kernel_size=15, **kw)
    port = CTCModelConfig(encoder=ConformerEncoderConfig(dtype=torch.float32, **enc), num_classes=V)
    jax_cfg = JaxCTCConfig(encoder=JaxEncoderConfig(dtype=jnp.float32, **enc), num_classes=V)
    return port, jax_cfg


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_jax_params_bridge_inverts_nemo_converter(variant):
    port_cfg, jax_cfg = _configs(**VARIANTS[variant])
    model = CTCModel(port_cfg)
    rng = np.random.RandomState(0)
    with torch.no_grad():  # random NeMo-named values; shared biases stay tied
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            vals = rng.randn(*t.shape).astype(np.float32)
            if name.endswith("running_var"):
                vals = np.abs(vals) + 0.5
            t.copy_(torch.from_numpy(vals))
    nemo_sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}

    jax_vars = convert_ctc_model_state(nemo_sd, jax_cfg)
    back = ctc_state_dict_from_jax(jax_vars, port_cfg)

    assert sorted(back) == sorted(nemo_sd)
    for k, want in nemo_sd.items():
        got = back[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    CTCModel(port_cfg).load_state_dict(back, strict=True)
