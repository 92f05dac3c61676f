"""Every subsampling mode of the port's encoder vs the JAX package's.

The modes: the conv front ends vggnet, resnet and subencoder (the last two
the fork's own, with 2-D training BatchNorms), stacking, and the factor-1
`pre_encode` Linear, at factors 4 and 8 (factor 1 for the Linear), with
striding beside them as the control. The JAX variables come from its
`init_ctc_state`, are perturbed with numpy noise (BatchNorm statistics
included, variances kept positive) and cross through the weight bridge;
both sides run float32 on the same numpy features, with padded rows of
odd lengths (the pools' ceil rule, stacking's pad from the batch's T).

Tolerances: encoder outputs and CTC log-probs 1e-4 absolute (fp32 sums in
other orders through the front end and a layer); lengths exact; the
BatchNorm statistics a training forward writes 1e-5 absolute; the bridge
both ways bit for bit. Two train steps per mode are in
test_torch_subsampling_steps.py, the `.nemo` loads and exports in
test_torch_subsampling_export.py (the three files spread over the test
workers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conformer_nemo_tpu.audio.features import MelFeatureConfig as JaxMelConfig
from conformer_nemo_tpu.models.conformer import ConformerEncoderConfig as JaxEncoderConfig
from conformer_nemo_tpu.models.ctc_model import CTCModel as JaxCTCModel
from conformer_nemo_tpu.models.ctc_model import CTCModelConfig as JaxCTCConfig
from conformer_nemo_tpu.train.trainer import init_ctc_state as jax_init_state
from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig
from conformer_nemo_tpu_torch.convert.jax_params import (
    ctc_state_dict_from_jax,
    ctc_variables_to_jax,
)
from conformer_nemo_tpu_torch.models.conformer import (
    ConformerEncoderConfig,
    encoder_lengths,
    frame_factor,
)
from conformer_nemo_tpu_torch.models.ctc_model import CTCModel, CTCModelConfig

torch.set_num_threads(2)

V = 11
ATOL = 1e-4
STATS_ATOL = 1e-5
RTOL = 1e-4
ENC = dict(feat_in=20, n_layers=1, d_model=32, n_heads=2, conv_kernel_size=7,
           subsampling_conv_channels=8, dropout=0.0, dropout_att=0.0, dropout_emb=0.0)
CASES = [("striding", 4), ("vggnet", 4), ("vggnet", 8), ("resnet", 4), ("resnet", 8),
         ("subencoder", 4), ("subencoder", 8), ("stacking", 4), ("stacking", 8), ("none", 1)]


def _configs(mode, factor, feat_in=20, **extra):
    enc = dict(ENC, feat_in=feat_in, subsampling=mode, subsampling_factor=factor, **extra)
    jcfg = JaxCTCConfig(preprocessor=JaxMelConfig(features=feat_in, dither=0.0),
                        encoder=JaxEncoderConfig(dtype=jnp.float32, **enc), num_classes=V)
    pcfg = CTCModelConfig(preprocessor=MelFeatureConfig(features=feat_in, dither=0.0),
                          encoder=ConformerEncoderConfig(dtype=torch.float32, **enc),
                          num_classes=V)
    return jcfg, pcfg


def _perturbed(tree, rng, positive=False):
    def leaf(x):
        x = np.asarray(x, np.float32)
        y = x + 0.2 * rng.randn(*x.shape).astype(np.float32)
        return np.abs(y) + 0.5 if positive else y

    return jax.tree.map(leaf, dict(tree))


def _variables(jcfg, seed=0):
    shape = (1, jcfg.encoder.feat_in, 64)
    state = jax_init_state(jcfg, optax.sgd(0.1), jax.random.PRNGKey(seed), shape)
    rng = np.random.RandomState(seed)
    out = {"params": _perturbed(state.params, rng)}
    if state.batch_stats:
        stats = jax.device_get(state.batch_stats)
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, x: _perturbed({"x": x}, rng, positive=path[-1].key == "var")["x"],
            dict(stats))
    return out


def _feats(feat_in, t=77, seed=1):
    rng = np.random.RandomState(seed)
    feats = rng.randn(3, feat_in, t).astype(np.float32)
    return feats, np.array([t, t - 18, 9], np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("mode,factor", CASES)
def test_encoder_matches_jax(mode, factor, train):
    jcfg, pcfg = _configs(mode, factor)
    variables = _variables(jcfg)
    feats, lens = _feats(jcfg.encoder.feat_in)
    jmodel = JaxCTCModel(jcfg)
    jvars = jax.tree.map(jnp.asarray, variables)
    if train and "batch_stats" in variables:
        (lp_j, el_j), upd = jmodel.apply(jvars, jnp.asarray(feats), jnp.asarray(lens), train=True,
                                         rngs={"dropout": jax.random.PRNGKey(0)},
                                         mutable=["batch_stats"])
        want_stats = {"params": variables["params"],
                      "batch_stats": jax.device_get(upd["batch_stats"])}
    else:
        lp_j, el_j = jmodel.apply(jvars, jnp.asarray(feats), jnp.asarray(lens), train=train,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        want_stats = variables
    model = CTCModel(pcfg)
    model.load_state_dict(ctc_state_dict_from_jax(variables, pcfg))
    model.train(train)
    with torch.no_grad():
        lp_p, el_p = model(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(el_p.numpy(), np.asarray(el_j))
    np.testing.assert_array_equal(
        encoder_lengths(pcfg.encoder, torch.from_numpy(lens), feats.shape[-1]).numpy(),
        np.asarray(el_j))
    assert lp_p.shape == lp_j.shape
    np.testing.assert_allclose(lp_p.numpy(), np.asarray(lp_j), rtol=0, atol=ATOL)
    want = ctc_state_dict_from_jax(want_stats, pcfg)
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=STATS_ATOL,
                                       err_msg=k)
    if mode in ("resnet", "subencoder") and train:
        pre = [k for k in want if k.startswith("encoder.pre_encode.") and "running" in k]
        assert len(pre) == 2 * {"resnet": 2, "subencoder": 3}[mode] * int(np.log2(factor))
        assert not torch.equal(want[pre[0]], ctc_state_dict_from_jax(variables, pcfg)[pre[0]])


@pytest.mark.parametrize("mode,factor", CASES)
def test_weight_bridge_round_trips(mode, factor):
    """JAX -> port -> JAX and port -> JAX -> port, bit for bit, BatchNorm
    statistics of the front end included; the frame factor is the one the
    lengths show."""
    jcfg, pcfg = _configs(mode, factor)
    variables = _variables(jcfg)
    sd = ctc_state_dict_from_jax(variables, pcfg)
    model = CTCModel(pcfg)
    model.load_state_dict(sd)  # strict: every entry has its place
    back = ctc_variables_to_jax(model.state_dict(), pcfg)
    a, b = _flat(variables), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    again = ctc_state_dict_from_jax(back, pcfg)
    assert all(torch.equal(again[k], v) for k, v in sd.items())
    t = 64 * frame_factor(pcfg.encoder)
    out = encoder_lengths(pcfg.encoder, torch.tensor([t]), t + 7)
    assert abs(int(out[0]) - 64) <= 2


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown subsampling mode"):
        CTCModel(dataclasses.replace(_configs("striding", 4)[1], encoder=ConformerEncoderConfig(
            **dict(ENC, subsampling="dw_striding"))))
