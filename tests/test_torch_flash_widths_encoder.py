"""One Conformer layer at Conformer-CTC Small's and XLarge's widths through
the flash path, against the JAX package's.

Small: d_model 176, 4 heads (d1 = 44 + 176 = 220, dv = 44: the CUDA route
pads them to 224 and 48); XLarge: d_model 1024, 8 heads (d1 1152, dv 128);
both with 4x feed-forward and a 31-wide depthwise convolution, one layer,
T 40, flash forced, fp32 on both sides (the port's kernels' plain versions,
the JAX package's Pallas kernels in interpret mode under `jax.jit`), on
weights bridged by `ctc_state_dict_from_jax`; the pre-encode's convolution
channels cut to 32 (its width is not the attention's). The loss is a fixed
random projection of the log-probs over the valid frames. Loss and every
parameter's gradient within bf16 rounding: 2^-8 of the loss and of each
tensor's largest gradient (the two sides sum in different orders; a
gradient zero in exact arithmetic, the key bias and the depthwise bias, is
held against the largest of any tensor).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.models.conformer import ConformerEncoderConfig as JaxEncoderConfig
from conformer_nemo_tpu.models.ctc_model import CTCModel as JaxCTCModel
from conformer_nemo_tpu.models.ctc_model import CTCModelConfig as JaxCTCConfig
from conformer_nemo_tpu_torch.convert.jax_params import ctc_state_dict_from_jax
from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig
from conformer_nemo_tpu_torch.models.ctc_model import CTCModel, CTCModelConfig

torch.set_num_threads(2)

BF16_ROUNDING = 2.0 ** -8
ZERO_GRAD = ("self_attn.linear_k.bias", "conv.depthwise_conv.bias")

ENCODERS = {
    "small": dict(d_model=176, n_heads=4),
    "xlarge": dict(d_model=1024, n_heads=8),
}


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_one_layer_encoder_gradients_match_jax_at_width(name):
    enc = dict(feat_in=80, n_layers=1, ff_expansion_factor=4, conv_kernel_size=31,
               subsampling_conv_channels=32, dropout=0.0, dropout_att=0.0, dropout_emb=0.0,
               use_flash_attention=True, **ENCODERS[name])
    v_out = 29
    jax_cfg = JaxCTCConfig(encoder=JaxEncoderConfig(dtype=jnp.float32, **enc),
                           num_classes=v_out)
    port_cfg = CTCModelConfig(encoder=ConformerEncoderConfig(dtype=torch.float32, **enc),
                              num_classes=v_out)
    # the JAX package's init_ctc_state, compiled (eager flax init takes seconds)
    variables = jax.jit(lambda key: JaxCTCModel(jax_cfg).init(
        key, jnp.zeros((1, 80, 64), jnp.float32), jnp.full((1,), 64, jnp.int32),
        train=False))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 80, 160).astype(np.float32)  # T 40 after the 4x subsampling
    lens = np.array([160, 111], np.int32)
    weight = rng.randn(2, 40, v_out + 1).astype(np.float32)
    params = jax.device_get(variables["params"])
    stats = jax.device_get(variables["batch_stats"])

    def jax_loss(p):
        lp, el = JaxCTCModel(jax_cfg).apply({"params": p, "batch_stats": stats},
                                            jnp.asarray(feats), jnp.asarray(lens), train=False)
        valid = jnp.arange(lp.shape[1])[None, :, None] < el[:, None, None]
        return jnp.sum(jnp.where(valid, lp * weight, 0.0))

    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_loss))(params)

    model = CTCModel(port_cfg).eval()
    model.load_state_dict(ctc_state_dict_from_jax({"params": params, "batch_stats": stats},
                                                  port_cfg))
    lp, el = model(torch.from_numpy(feats), torch.from_numpy(lens))
    assert lp.shape[1] == 40 and model.encoder.layers[0].self_attn.use_flash(40, el)
    valid = torch.arange(lp.shape[1])[None, :, None] < el[:, None, None]
    loss = torch.where(valid, lp * torch.from_numpy(weight), torch.zeros(())).sum()
    loss.backward()

    assert abs(loss.item() - float(loss_j)) <= BF16_ROUNDING * abs(float(loss_j))
    want = ctc_state_dict_from_jax({"params": jax.device_get(grads_j), "batch_stats": stats},
                                   port_cfg)
    got = {n: p.grad for n, p in model.named_parameters()}
    largest = max(float(w.abs().max()) for n, w in want.items() if n in got)
    for n, g in got.items():
        w = want[n]
        scale = largest if n.endswith(ZERO_GRAD) else float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= BF16_ROUNDING * scale, (n, err, scale)
