"""Port RNN-T train step vs the JAX package's `make_rnnt_train_step`.

A tiny Conformer-Transducer (1 layer, d_model 24, prediction and joint
width 16, V 7, fp32) starts from the JAX package's initial weights
(crossed through `rnnt_state_dict_from_jax`) and takes the same batches,
one of them with a loader zero row, with dropout, dither and SpecAugment
off, under adamw + Noam. Loss, gradient norm and the encoder / decoder /
joint gradient norms are compared at relative 1e-4 (fp32 on both sides,
summed in other orders). The port's LSTM trains one bias per layer, as
the JAX package does (its state_dict writes it as NeMo's bias_ih +
bias_hh), so the norms and the optimizer steps match with nothing taken
out or put back. The parameters after two steps are compared too: Adam moves a
weight by about lr times the sign of its gradient, so entries agree to
1e-6 absolute except where a gradient is at rounding level on either side
and its sign is noise (the attention key bias, whose gradient is zero in
exact arithmetic, and the low-frequency columns of linear_pos); every entry
is held to the most a sign flip can move it, 4 x the summed learning
rates, and most entries of every tensor to 1e-6. Then skip_nan_grad and the variational
noise, whose rate is checked statistically.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.audio.features import MelFeatureConfig as JaxMelConfig
from conformer_nemo_tpu.models import rnnt as jax_rnnt
from conformer_nemo_tpu.models.conformer import ConformerEncoderConfig as JaxEncoderConfig
from conformer_nemo_tpu.train import lr_schedule as jax_lr
from conformer_nemo_tpu.train import optim as jax_optim
from conformer_nemo_tpu.train import rnnt_trainer as jax_trainer
from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig
from conformer_nemo_tpu_torch.convert.jax_params import rnnt_state_dict_from_jax
from conformer_nemo_tpu_torch.models import rnnt as port
from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig
from conformer_nemo_tpu_torch.train import lr_schedule as port_lr
from conformer_nemo_tpu_torch.train import optim as port_optim
from conformer_nemo_tpu_torch.train.optim import Transformation
from conformer_nemo_tpu_torch.train.rnnt_trainer import (
    RNNTTrainConfig,
    init_rnnt_state,
    make_rnnt_train_step,
)

torch.set_num_threads(2)

V = 7
RTOL = 1e-4
PARAM_ATOL = 1e-6
ENC = dict(feat_in=16, n_layers=1, d_model=24, n_heads=2, ff_expansion_factor=2,
           conv_kernel_size=7, conv_norm_type="layer_norm", dropout=0.0, dropout_att=0.0)
SCHED = {"name": "NoamAnnealing", "d_model": 24, "warmup_steps": 100, "min_lr": 1e-6}
ZERO_GRAD = ("self_attn.linear_k.bias",)


def _batch(seed, nan=False):
    rng = np.random.RandomState(seed)
    n = 6400
    audio = (0.1 * rng.randn(3, n)).astype(np.float32)
    audio[1, 4800:] = 0.0
    audio[2] = 0.0  # the loader's zero row
    if nan:
        audio[0, 10] = np.nan
    return {"audio": audio, "audio_lens": np.array([n, 4800, 0], np.int32),
            "tokens": rng.randint(0, V, (3, 4)).astype(np.int32),
            "token_lens": np.array([4, 2, 0], np.int32)}


def _configs(vn_std=0.0, vn_start=0):
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
            joint=port.RNNTJointConfig(joint_hidden=16, dropout=0.0, dtype=torch.float32)),
        variational_noise_std=vn_std, variational_noise_start=vn_start)
    return jcfg, pcfg


def _opt(lib_optim, lib_lr):
    return lib_optim.make_optimizer("adamw", lib_lr.make_lr_schedule(SCHED, 1.0),
                                    weight_decay=1e-3, betas=(0.9, 0.98))


def _port_model(jax_state, pcfg):
    model = port.RNNTModel(pcfg.model)
    model.load_state_dict(rnnt_state_dict_from_jax(
        {"params": jax.device_get(jax_state.params)}, pcfg.model))
    return model


@pytest.fixture(scope="module")
def jax_init():
    jcfg, pcfg = _configs()
    opt = _opt(jax_optim, jax_lr)
    state = jax_trainer.init_rnnt_state(jcfg, opt, jax.random.PRNGKey(0), (1, 16, 64))
    return jcfg, pcfg, opt, jax.device_get(state)


@pytest.fixture
def jax_start(jax_init):
    """A fresh copy of the initial JAX state (the JAX step donates its state)."""
    jcfg, pcfg, opt, host = jax_init
    return jcfg, pcfg, opt, jax.tree.map(jnp.array, host)


def test_train_steps_match_jax(jax_start):
    jcfg, pcfg, jopt, jstate = jax_start
    jstep = jax_trainer.make_rnnt_train_step(jcfg, jopt)
    opt = _opt(port_optim, port_lr)
    state = init_rnnt_state(_port_model(jstate, pcfg), opt)
    step = make_rnnt_train_step(pcfg, opt)
    schedule = port_lr.make_lr_schedule(SCHED, 1.0)
    lr_sum = 0.0
    for i in range(2):
        batch = _batch(i)
        lr_sum += schedule(state.opt_state["count"])
        jstate, m_j = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        m_p = step(state, batch)
        assert math.isfinite(float(m_p["loss"]))
        for key in ("loss", "grad_norm", "encoder_grad_norm", "decoder_grad_norm",
                    "joint_grad_norm"):
            np.testing.assert_allclose(float(m_p[key]), float(m_j[key]), rtol=RTOL,
                                       err_msg=key)
    want = dict(_port_model(jstate, pcfg).named_parameters())
    agree = {}
    for name, p in state.model.named_parameters():
        g, w = p.detach().numpy(), want[name].detach().numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=4 * lr_sum, err_msg=name)
        if not name.endswith(ZERO_GRAD):
            agree[name] = (np.abs(g - w) <= PARAM_ATOL).mean()
    # the tight check covers most of every tensor; the least is linear_pos,
    # whose low-frequency columns get gradients at rounding level (~87%)
    assert min(agree.values()) >= 0.8, min(agree.items(), key=lambda kv: kv[1])
    assert np.mean(list(agree.values())) >= 0.97
    assert state.step == int(jstate.step) == 2


def test_lstm_bias_pair_steps_like_jax_bias(jax_start):
    """The port trains one LSTM bias, as JAX trains b: one optimizer step
    moves the NeMo pair the state_dict writes (bias_ih + bias_hh) as JAX
    moves b, not twice as far, and bias_hh stays zero."""
    jcfg, pcfg, jopt, jstate = jax_start
    jstep = jax_trainer.make_rnnt_train_step(jcfg, jopt)
    opt = _opt(port_optim, port_lr)
    state = init_rnnt_state(_port_model(jstate, pcfg), opt)
    pre = "decoder.prediction.dec_rnn.lstm."
    assert [n for n, _ in state.model.named_parameters() if n.startswith(pre + "bias")] == \
        [pre + "bias_l0"]
    pair = lambda sd: (sd[pre + "bias_ih_l0"] + sd[pre + "bias_hh_l0"]).clone()
    before = pair(state.model.state_dict())
    b0 = np.asarray(jstate.params["decoder"]["lstm0_b"])
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in _batch(0).items()})
    make_rnnt_train_step(pcfg, opt)(state, _batch(0))
    db = np.asarray(jstate.params["decoder"]["lstm0_b"]) - b0
    lr = port_lr.make_lr_schedule(SCHED, 1.0)(0)
    after = state.model.state_dict()
    assert not after[pre + "bias_hh_l0"].any()
    moved = (pair(after) - before).numpy()
    assert (np.abs(moved - db) <= PARAM_ATOL).mean() >= 0.9
    np.testing.assert_allclose(moved, db, rtol=0, atol=4 * lr)


def _probe_grads(pcfg, model, batch):
    grads = []

    def capture(g, state, params):
        grads.extend(x.detach().clone() for x in g)
        return [torch.zeros_like(x) for x in g], state

    probe = Transformation(lambda params: {}, capture)
    metrics = make_rnnt_train_step(pcfg, probe)(init_rnnt_state(model, probe), batch)
    return grads, metrics


def test_variational_noise_on_decoder_gradients(jax_start):
    _, pcfg, _, jstate = jax_start
    names = [n for n, _ in _port_model(jstate, pcfg).named_parameters()]
    clean, _ = _probe_grads(pcfg, _port_model(jstate, pcfg), _batch(0))
    _, noisy_cfg = _configs(vn_std=0.5)
    noisy, m = _probe_grads(noisy_cfg, _port_model(jstate, noisy_cfg), _batch(0))
    diff = torch.cat([(a - b).flatten() for n, a, b in zip(names, noisy, clean)
                      if n.startswith("decoder.")])
    sigma = 0.5 / math.sqrt(2 * diff.numel())
    assert abs(diff.mean().item()) < 5 * 0.5 / math.sqrt(diff.numel())
    assert abs(diff.std().item() - 0.5) < 5 * sigma
    for n, a, b in zip(names, noisy, clean):
        if not n.startswith("decoder."):
            assert torch.equal(a, b), n
    _, late_cfg = _configs(vn_std=0.5, vn_start=5)  # not active before step 5
    late, _ = _probe_grads(late_cfg, _port_model(jstate, late_cfg), _batch(0))
    assert all(torch.equal(a, b) for a, b in zip(late, clean))


def test_skip_nan_grad_leaves_the_state(jax_start):
    _, pcfg, _, jstate = jax_start
    opt = _opt(port_optim, port_lr)
    state = init_rnnt_state(_port_model(jstate, pcfg), opt)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    m = make_rnnt_train_step(pcfg, opt, skip_nan_grad=True)(state, _batch(1, nan=True))
    assert not math.isfinite(float(m["grad_norm"]))
    assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())
    assert state.step == 1 and state.opt_state["count"] == 0
