"""The LSTM's trained bias is the JAX package's leaf, under weight decay.

The JAX LSTM trains b - c (c = forget_gate_bias) and adds c to the forget
gate at run time; so does the port. A leaf that held c would be decayed
by adamw's `weight_decay * params` term, moving the forget chunk by an
extra lr * wd * c a step. Two adamw steps of the tiny transducer of
tests/test_torch_rnnt_train_step.py at a constant lr of 1.0 and
weight_decay 0.1 (where that extra is 0.1 a step) are compared with the
JAX `make_rnnt_train_step`: loss and gradient norms at relative 1e-4, the
bias leaf at 1e-4 absolute (Adam's first step moves every entry by lr
times the sign of its gradient, so the leaves agree to rounding where the
signs agree). Then the edges keep NeMo's convention: a state_dict or an
archive from before the repair restores to the same state_dict, and a
train-state checkpoint gives the leaf back bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.audio.features import MelFeatureConfig as JaxMelConfig
from conformer_nemo_tpu.models import rnnt as jax_rnnt
from conformer_nemo_tpu.models.conformer import ConformerEncoderConfig as JaxEncoderConfig
from conformer_nemo_tpu.train import optim as jax_optim
from conformer_nemo_tpu.train import rnnt_trainer as jax_trainer
from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig
from conformer_nemo_tpu_torch.convert.jax_params import (
    rnnt_state_dict_from_jax,
    rnnt_variables_to_jax,
)
from conformer_nemo_tpu_torch.models import rnnt as port
from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig
from conformer_nemo_tpu_torch.train import checkpoint as ckpt
from conformer_nemo_tpu_torch.train import optim as port_optim
from conformer_nemo_tpu_torch.train.rnnt_trainer import (
    RNNTTrainConfig,
    init_rnnt_state,
    make_rnnt_train_step,
)

torch.set_num_threads(2)

V = 7
RTOL = 1e-4
LEAF_ATOL = 1e-4
ENC = dict(feat_in=16, n_layers=1, d_model=24, n_heads=2, ff_expansion_factor=2,
           conv_kernel_size=7, conv_norm_type="layer_norm", dropout=0.0, dropout_att=0.0)
PRE = "decoder.prediction.dec_rnn.lstm."


def _batch(seed):
    rng = np.random.RandomState(seed)
    n = 6400
    audio = (0.1 * rng.randn(2, n)).astype(np.float32)
    audio[1, 4800:] = 0.0
    return {"audio": audio, "audio_lens": np.array([n, 4800], np.int32),
            "tokens": rng.randint(0, V, (2, 4)).astype(np.int32),
            "token_lens": np.array([4, 2], np.int32)}


def _configs():
    dec = dict(vocab_size=V, pred_hidden=16, dropout=0.0)
    jcfg = jax_trainer.RNNTTrainConfig(
        preprocessor=JaxMelConfig(features=16, dither=0.0),
        model=jax_rnnt.RNNTModelConfig(
            encoder=JaxEncoderConfig(dtype=jnp.float32, **ENC),
            decoder=jax_rnnt.RNNTDecoderConfig(dtype=jnp.float32, **dec),
            joint=jax_rnnt.RNNTJointConfig(joint_hidden=16, dropout=0.0, dtype=jnp.float32)))
    pcfg = RNNTTrainConfig(
        preprocessor=MelFeatureConfig(features=16, dither=0.0),
        model=port.RNNTModelConfig(
            encoder=ConformerEncoderConfig(dtype=torch.float32, **ENC),
            decoder=port.RNNTDecoderConfig(dtype=torch.float32, **dec),
            joint=port.RNNTJointConfig(joint_hidden=16, dropout=0.0, dtype=torch.float32)))
    return jcfg, pcfg


def _opt(lib):
    return lib.make_optimizer("adamw", lambda count: 1.0, weight_decay=0.1, betas=(0.9, 0.98))


@pytest.fixture(scope="module")
def start():
    jcfg, pcfg = _configs()
    jopt = _opt(jax_optim)
    jstate = jax_trainer.init_rnnt_state(jcfg, jopt, jax.random.PRNGKey(0), (1, 16, 64))
    return jcfg, pcfg, jopt, jax.device_get(jstate)


def _port_model(params, pcfg):
    model = port.RNNTModel(pcfg.model)
    model.load_state_dict(rnnt_state_dict_from_jax({"params": params}, pcfg.model))
    return model


def test_adamw_weight_decay_moves_the_leaf_as_jax(start):
    jcfg, pcfg, jopt, host = start
    jstate = jax.tree.map(jnp.array, host)
    jstep = jax_trainer.make_rnnt_train_step(jcfg, jopt)
    opt = _opt(port_optim)
    state = init_rnnt_state(_port_model(host.params, pcfg), opt)
    step = make_rnnt_train_step(pcfg, opt)
    h = pcfg.model.decoder.pred_hidden
    for i in range(2):
        batch = _batch(i)
        jstate, m_j = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        m_p = step(state, batch)
        for key in ("loss", "grad_norm", "decoder_grad_norm"):
            np.testing.assert_allclose(float(m_p[key]), float(m_j[key]), rtol=RTOL,
                                       err_msg=f"{key} at step {i + 1}")
    leaf = state.model.decoder.prediction.dec_rnn.lstm.bias_l0.detach().numpy()
    want = np.asarray(jstate.params["decoder"]["lstm0_b"])
    np.testing.assert_allclose(leaf[h: 2 * h], want[h: 2 * h], rtol=0, atol=LEAF_ATOL)
    np.testing.assert_allclose(leaf, want, rtol=0, atol=LEAF_ATOL)


def test_nemo_convention_at_the_edges(start, tmp_path):
    """The state_dict writes the leaf + c as bias_ih and zeros as bias_hh;
    a NeMo state_dict (and so an archive written before the repair, which
    restores through one) loads and writes back the same tensors; the
    JAX variables of the port's state_dict are the leaf; a train-state
    checkpoint restores the leaf bit for bit, though fl(b + c) - c is not b."""
    _, pcfg, _, host = start
    c = float(pcfg.model.decoder.forget_gate_bias)
    h = pcfg.model.decoder.pred_hidden
    sd = rnnt_state_dict_from_jax({"params": host.params}, pcfg.model)
    model = port.RNNTModel(pcfg.model)
    model.load_state_dict(sd)
    back = model.state_dict()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    assert not back[PRE + "bias_hh_l0"].any()
    leaf = model.decoder.prediction.dec_rnn.lstm.bias_l0
    b = np.asarray(host.params["decoder"]["lstm0_b"])
    np.testing.assert_array_equal(leaf.detach().numpy(), b)  # b + c - c is b for b near 0
    np.testing.assert_array_equal(
        rnnt_variables_to_jax(back, pcfg.model)["params"]["decoder"]["lstm0_b"], b)
    with torch.no_grad():
        leaf[h: 2 * h] = torch.linspace(-1e-3, 1e-3, h) + 1.2345678e-4
    opt = port_optim.make_optimizer("adamw", lambda count: 1.0)
    state = init_rnnt_state(model, opt)
    ckpt.save_train_state(str(tmp_path), state, 1)
    fresh = init_rnnt_state(port.RNNTModel(pcfg.model), opt)
    ckpt.restore_train_state(str(tmp_path), fresh)
    got = fresh.model.decoder.prediction.dec_rnn.lstm.bias_l0
    assert torch.equal(got, leaf)
    rounded = fresh.model.state_dict()[PRE + "bias_ih_l0"][h: 2 * h] - c
    assert not torch.equal(rounded, leaf[h: 2 * h].detach())
