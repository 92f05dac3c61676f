"""Port CTCModel (encoder + head) vs the JAX CTCModel on the same weights.

The JAX variables come from `init_ctc_state`, are perturbed with numpy
noise (so biases, norm scales and BatchNorm statistics are all exercised)
and cross through the weight bridge. Both sides run float32; the JAX flash
path runs its Pallas kernel in interpret mode on the CPU backend, the
port's its plain version. Log-probs agree within 1e-4 (fp32 summation-order
differences through 2 layers and a log_softmax); encoder lengths exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conformer_nemo_tpu.models.conformer import ConformerEncoderConfig as JaxEncoderConfig
from conformer_nemo_tpu.models.ctc_model import CTCModel as JaxCTCModel
from conformer_nemo_tpu.models.ctc_model import CTCModelConfig as JaxCTCConfig
from conformer_nemo_tpu.train.trainer import init_ctc_state
from conformer_nemo_tpu_torch.convert.jax_params import ctc_state_dict_from_jax
from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig, check_flash_dtype
from conformer_nemo_tpu_torch.models.ctc_model import CTCModel, CTCModelConfig

torch.set_num_threads(2)

V = 37
ATOL = 1e-4
PATHS = {
    "dense": dict(use_flash_attention=False),
    "flash": dict(use_flash_attention=True),
    "rel_shift": dict(use_flash_attention=False, dropout_emb=0.1),
    "banded_flash": dict(use_flash_attention=True, att_context_size=(12, 4)),
    "abs_pos_layer_norm": dict(self_attention_model="abs_pos", conv_norm_type="layer_norm"),
    "shared_biases": dict(untie_biases=False, use_flash_attention="auto",
                          flash_attention_min_t=16),
}


def _perturbed_numpy(tree, rng):
    def leaf(x):
        x = np.asarray(x, np.float32)
        return (x + 0.2 * rng.randn(*x.shape)).astype(np.float32)

    return jax.tree.map(leaf, dict(tree))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_ctc_model_matches_jax(path):
    enc = dict(feat_in=80, n_layers=2, d_model=64, n_heads=4, conv_kernel_size=15, **PATHS[path])
    jax_cfg = JaxCTCConfig(encoder=JaxEncoderConfig(dtype=jnp.float32, **enc), num_classes=V)
    port_cfg = CTCModelConfig(encoder=ConformerEncoderConfig(dtype=torch.float32, **enc),
                              num_classes=V)
    state = init_ctc_state(jax_cfg, optax.sgd(0.1), jax.random.PRNGKey(0), (1, 80, 64))
    rng = np.random.RandomState(0)
    variables = {"params": _perturbed_numpy(state.params, rng)}
    if state.batch_stats:
        stats = _perturbed_numpy(state.batch_stats, rng)
        for layer in stats["encoder"].values():  # keep variances positive
            layer["conv"]["norm"]["var"] = np.abs(layer["conv"]["norm"]["var"]) + 0.5
        variables["batch_stats"] = stats

    feats = rng.randn(3, 80, 150).astype(np.float32)
    lens = np.array([150, 117, 33], np.int32)
    lp_j, el_j = JaxCTCModel(jax_cfg).apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(feats), jnp.asarray(lens), train=False)

    model = CTCModel(port_cfg).eval()
    model.load_state_dict(ctc_state_dict_from_jax(variables, port_cfg))
    with torch.inference_mode():
        lp_p, el_p = model(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(el_p.numpy(), np.asarray(el_j))
    assert lp_p.shape == lp_j.shape
    np.testing.assert_allclose(lp_p.numpy(), np.asarray(lp_j), rtol=0, atol=ATOL)
    if PATHS[path].get("use_flash_attention") is True or path == "shared_biases":
        assert model.encoder.layers[0].self_attn.use_flash(lp_p.shape[1], el_p)


# (cfg fields, device, refusal or None): the CUDA flash kernels take bf16,
# fp16 and fp32 at dv <= 128, and in the 16-bit types d1 up to the forward's
# shared memory; a CUDA model that can reach the flash path in another dtype,
# or with use_flash_attention True at another depth, is refused up front
# (under "auto" such a depth takes the dense path)
FLASH_DTYPE_CASES = {
    "cuda_fp32_auto": (dict(dtype=torch.float32), "cuda", None),
    "cuda_fp32_flash": (dict(dtype=torch.float32, use_flash_attention=True), "cuda", None),
    "cuda_bf16_auto": (dict(dtype=torch.bfloat16), "cuda", None),
    "cuda_fp32_dense": (dict(dtype=torch.float32, use_flash_attention=False), "cuda", None),
    "cuda_fp32_rel_shift": (dict(dtype=torch.float32, dropout_emb=0.1), "cuda", None),
    "cuda_fp32_abs_pos": (dict(dtype=torch.float32, self_attention_model="abs_pos"), "cuda",
                          None),
    "cpu_fp32_flash": (dict(dtype=torch.float32, use_flash_attention=True), "cpu", None),
    "cuda_fp16_small_heads": (dict(dtype=torch.float16, d_model=176, n_heads=4), "cuda", None),
    "cuda_fp64_flash": (dict(dtype=torch.float64, use_flash_attention=True), "cuda",
                        "take torch.bfloat16, torch.float16, torch.float32"),
    # d1 = 72 + 1152 = 1224, past the 16-bit forward's 1216; fp32 streams the depth
    "cuda_bf16_past_forward_depth": (dict(dtype=torch.bfloat16, d_model=1152, n_heads=16,
                                          use_flash_attention=True),
                                     "cuda", "flash_attention_fwd_smem_bytes"),
    "cuda_bf16_past_forward_depth_auto": (dict(dtype=torch.bfloat16, d_model=1152, n_heads=16),
                                          "cuda", None),
    # d_head 144: past dv 128 in every dtype
    "cuda_fp32_dv_past_128": (dict(dtype=torch.float32, d_model=1152, n_heads=8,
                                   use_flash_attention=True), "cuda", "dv <= 128"),
    "cuda_fp32_dv_past_128_auto": (dict(dtype=torch.float32, d_model=1152, n_heads=8), "cuda",
                                   None),
    "cuda_fp32_past_forward_depth": (dict(dtype=torch.float32, d_model=1152, n_heads=16),
                                     "cuda", None),
}


class _FwdLimit:
    """Stand-in for the forward library's shared-memory query: a block's
    232,448 bytes reached at d1 1216, as the card's layout reports it."""

    flash_attention_fwd_smem_bytes = staticmethod(lambda d1, dv: 232448 + 128 * (d1 - 1216))


@pytest.mark.parametrize("case", sorted(FLASH_DTYPE_CASES))
def test_check_flash_dtype(case, monkeypatch):
    from conformer_nemo_tpu_torch.ops import flash_attention as fa

    monkeypatch.setattr(fa, "load", lambda source: _FwdLimit())
    fields, device, refused = FLASH_DTYPE_CASES[case]
    cfg = ConformerEncoderConfig(**fields)
    if refused:
        with pytest.raises(ValueError, match=refused) as err:
            check_flash_dtype(cfg, torch.device(device))
        assert "model.encoder.use_flash_attention=False" in str(err.value)
    else:
        check_flash_dtype(cfg, torch.device(device))
