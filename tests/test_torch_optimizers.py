"""The ten optimizers of the port vs optax 0.2.6 (through the JAX package's
`make_optimizer`), wrapped as the JAX package wraps them, and in training.

1. Each optimizer alone and with clipping and accumulation against optax:
   tests/test_torch_optim.py::test_optimizer_registry_refuses_unported.
2. The factored axes (`factored_dims`) of every port parameter are the
   JAX leaf's two axes, mapped through the weight bridge's layouts.
3. Two train steps of a tiny CTC model (d_model 128, so that its linears
   factor) and of a tiny transducer, under novograd and adafactor, against
   the JAX package's train step from the same weights: loss and gradient
   norm relative 1e-4 at both steps, parameters after them within 1e-4
   absolute, except entries whose gradient is at rounding level on either
   side (sign noise that adafactor's per-row scale turns into a full-size
   step; and the two biases whose gradient is zero in exact arithmetic),
   which are held to the most such a step can move them.
4. Over gloo, dp1 x tp2 steps of novograd and adafactor (a resnet front
   end, replicated, its BatchNorms local to the data group) against one
   process of the port: the per-leaf reductions (novograd's gradient norm,
   adafactor's factored means and block RMSs) sum a sharded leaf's ranks,
   so the gathered parameters after two steps equal one process's within
   1e-4 absolute (the ranks' sums round in another order, and a per-leaf
   normaliser, adafactor's block-RMS clip over a leaf whose rounding-level
   entries take full steps, spreads that over the leaf), and entries whose sign
   is rounding (the two biases whose gradient is zero in exact arithmetic,
   and entries below 1e-4 of their tensor's largest gradient in a step,
   such as linear_pos's low-frequency columns) within a step's reach; the
   BatchNorm statistics, which follow the depthwise bias, within 1e-3;
   the losses within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.audio.features import MelFeatureConfig as JaxMelConfig
from conformer_nemo_tpu.models import rnnt as jax_rnnt
from conformer_nemo_tpu.models.conformer import ConformerEncoderConfig as JaxEncoderConfig
from conformer_nemo_tpu.models.ctc_model import CTCModelConfig as JaxCTCConfig
from conformer_nemo_tpu.train import lr_schedule as jlr
from conformer_nemo_tpu.train import optim as jopt
from conformer_nemo_tpu.train import rnnt_trainer as jax_rnnt_trainer
from conformer_nemo_tpu.train.trainer import init_ctc_state as jax_init_ctc
from conformer_nemo_tpu.train.trainer import make_ctc_train_step as jax_ctc_step
from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig
from conformer_nemo_tpu_torch.convert.jax_params import (
    ctc_state_dict_from_jax,
    rnnt_state_dict_from_jax,
)
from conformer_nemo_tpu_torch.convert.jax_train_state import param_index
from conformer_nemo_tpu_torch.models import rnnt as port_rnnt
from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig
from conformer_nemo_tpu_torch.models.ctc_model import CTCModel, CTCModelConfig
from conformer_nemo_tpu_torch.train import lr_schedule as plr
from conformer_nemo_tpu_torch.train import optim as popt
from conformer_nemo_tpu_torch.train.rnnt_trainer import RNNTTrainConfig, init_rnnt_state
from conformer_nemo_tpu_torch.train.rnnt_trainer import make_rnnt_train_step
from conformer_nemo_tpu_torch.train.trainer import init_ctc_state, make_ctc_train_step
from test_torch_distributed_step import global_batch, write_batches
from torch_dist_worker import run_world

torch.set_num_threads(2)

STEP_RTOL = 1e-4
PARAM_ATOL = 1e-4
NOISE_FLOOR = 1e-4
TP_ATOL = 1e-4  # as PARAM_ATOL: adafactor's block-RMS clip reads the noise entries too
# the conv BatchNorm's running mean takes a tenth of the depthwise bias's
# batch mean each step, and with it that bias's rounding-sign steps
STATS_ATOL = 1e-3
# gradients zero in exact arithmetic (softmax's shift; training BatchNorm
# after the depthwise conv and after the resnet front end's convolutions):
# every entry's sign is rounding, which a per-leaf normaliser (novograd's
# norm, adafactor's RMS) turns into a full step
ZERO_GRAD = ("self_attn.linear_k.bias", "conv.depthwise_conv.bias", ".conv1.bias",
             ".conv2.bias")


def _jax_ctc_cfg(enc):
    return JaxCTCConfig(preprocessor=JaxMelConfig(dither=0.0),
                        encoder=JaxEncoderConfig(dtype=jnp.float32, **enc), num_classes=9)


def _port_ctc_cfg(enc):
    return CTCModelConfig(preprocessor=MelFeatureConfig(dither=0.0),
                          encoder=ConformerEncoderConfig(dtype=torch.float32, **enc),
                          num_classes=9)


CTC_ENC = dict(feat_in=80, n_layers=1, d_model=128, n_heads=2, ff_expansion_factor=2,
               conv_kernel_size=7, subsampling_conv_channels=8, dropout=0.0, dropout_att=0.0,
               dropout_emb=0.0)


def test_factored_axes_are_the_jax_leafs():
    """adafactor factors each port parameter over the axes that hold the
    JAX leaf's two factored axes (the bridge's transposes), and both or
    neither are factored."""
    jcfg, pcfg = _jax_ctc_cfg(CTC_ENC), _port_ctc_cfg(CTC_ENC)
    jstate = jax_init_ctc(jcfg, jopt.make_optimizer("sgd", 0.1), jax.random.PRNGKey(0),
                          (1, 80, 64))
    model = CTCModel(pcfg)
    index = param_index(model)
    leaves = {tuple(k.key for k in path): np.asarray(x) for path, x in
              jax.tree_util.tree_leaves_with_path(jax.device_get(jstate.params))}
    factored = 0
    for name, p in model.named_parameters():
        path, axes = index[name].path, index[name].axes
        jdims = popt.factored_dims(leaves[path].shape)
        pdims = popt.factored_dims(tuple(p.shape))
        assert (jdims is None) == (pdims is None), name
        if jdims is not None:
            factored += 1
            assert {axes[d] for d in pdims} == set(jdims), name
    assert factored >= 8


def _batch(seed, rows=2, v=9):
    rng = np.random.RandomState(seed)
    n = 8000
    audio = (0.1 * rng.randn(rows, n)).astype(np.float32)
    audio[1, 6000:] = 0.0
    return {"audio": audio, "audio_lens": np.array([n, 6000], np.int32),
            "tokens": rng.randint(0, v, (rows, 4)).astype(np.int32),
            "token_lens": np.array([4, 2], np.int32)}


def _check_params(got: dict, want: dict, noise: dict, reach: float) -> None:
    for k, w in want.items():
        g, w = got[k].detach().numpy(), w.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=reach, err_msg=k)
        if k.endswith(ZERO_GRAD):
            continue
        signal = ~noise.get(k, np.zeros(g.shape, bool))
        np.testing.assert_allclose(g[signal], w[signal], rtol=0, atol=PARAM_ATOL, err_msg=k)


def _noise(grads: list, names: list, noise: dict) -> None:
    for n, g in zip(names, grads):
        a = g.abs().numpy()
        noise[n] = noise.get(n, np.zeros(a.shape, bool)) | (a < NOISE_FLOOR * max(a.max(), 1e-30))


def _probe(opt):
    """Wrap `opt` so that each update records the gradients it was given."""
    seen = []

    def update(grads, state, params):
        seen.append([g.detach().clone() for g in grads])
        return opt.update(grads, state, params)

    return popt.Transformation(opt.init, update), seen


@pytest.mark.parametrize("name", ["novograd", "adafactor"])
def test_ctc_train_steps_match_jax(name):
    sched = {"name": "NoamAnnealing", "d_model": 128, "warmup_steps": 10}
    jcfg, pcfg = _jax_ctc_cfg(CTC_ENC), _port_ctc_cfg(CTC_ENC)
    jo = jopt.make_optimizer(name, jlr.make_lr_schedule(sched, 0.5), weight_decay=1e-3)
    jstate = jax_init_ctc(jcfg, jo, jax.random.PRNGKey(0), (1, 80, 64))
    jstep = jax_ctc_step(jcfg, jo)
    model = CTCModel(pcfg)
    model.load_state_dict(ctc_state_dict_from_jax(
        {"params": jax.device_get(jstate.params),
         "batch_stats": jax.device_get(jstate.batch_stats)}, pcfg))
    po, seen = _probe(popt.make_optimizer(name, plr.make_lr_schedule(sched, 0.5),
                                          weight_decay=1e-3))
    state = init_ctc_state(model, po)
    step = make_ctc_train_step(pcfg, po)
    names = [n for n, _ in model.named_parameters()]
    noise: dict = {}
    for i in range(2):
        b = _batch(i)
        jstate, m_j = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        m_p = step(state, b)
        _noise(seen[-1], names, noise)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m_p[key]), float(m_j[key]), rtol=STEP_RTOL,
                                       err_msg=f"{name} {key} step {i + 1}")
    want = ctc_state_dict_from_jax({"params": jax.device_get(jstate.params)}, pcfg)
    got = dict(state.model.named_parameters())
    # a sign flip moves an entry by at most ~2 x lr x its leaf's RMS a step
    _check_params(got, {k: v for k, v in want.items() if k in got}, noise, reach=0.05)


RNNT_ENC = dict(feat_in=16, n_layers=1, d_model=24, n_heads=2, ff_expansion_factor=2,
                conv_kernel_size=7, conv_norm_type="layer_norm", dropout=0.0, dropout_att=0.0)


@pytest.mark.parametrize("name", ["novograd", "adafactor"])
def test_transducer_train_steps_match_jax(name):
    """The transducer's LSTM bias leaf is JAX's b - c: adafactor's parameter
    scale and novograd's decay term read the same leaf on both sides."""
    sched = {"name": "NoamAnnealing", "d_model": 24, "warmup_steps": 10}
    dec = dict(vocab_size=7, pred_hidden=16, dropout=0.0)
    jcfg = jax_rnnt_trainer.RNNTTrainConfig(
        preprocessor=JaxMelConfig(features=16, dither=0.0),
        model=jax_rnnt.RNNTModelConfig(
            encoder=JaxEncoderConfig(dtype=jnp.float32, **RNNT_ENC),
            decoder=jax_rnnt.RNNTDecoderConfig(dtype=jnp.float32, **dec),
            joint=jax_rnnt.RNNTJointConfig(joint_hidden=16, dropout=0.0, dtype=jnp.float32)))
    pcfg = RNNTTrainConfig(
        preprocessor=MelFeatureConfig(features=16, dither=0.0),
        model=port_rnnt.RNNTModelConfig(
            encoder=ConformerEncoderConfig(dtype=torch.float32, **RNNT_ENC),
            decoder=port_rnnt.RNNTDecoderConfig(dtype=torch.float32, **dec),
            joint=port_rnnt.RNNTJointConfig(joint_hidden=16, dropout=0.0, dtype=torch.float32)))
    jo = jopt.make_optimizer(name, jlr.make_lr_schedule(sched, 0.5), weight_decay=1e-3)
    jstate = jax_rnnt_trainer.init_rnnt_state(jcfg, jo, jax.random.PRNGKey(0), (1, 16, 64))
    jstep = jax_rnnt_trainer.make_rnnt_train_step(jcfg, jo)
    model = port_rnnt.RNNTModel(pcfg.model)
    model.load_state_dict(rnnt_state_dict_from_jax({"params": jax.device_get(jstate.params)},
                                                   pcfg.model))
    po, seen = _probe(popt.make_optimizer(name, plr.make_lr_schedule(sched, 0.5),
                                          weight_decay=1e-3))
    state = init_rnnt_state(model, po)
    step = make_rnnt_train_step(pcfg, po)
    names = [n for n, _ in model.named_parameters()]
    noise: dict = {}
    for i in range(2):
        b = _batch(i, v=7)
        jstate, m_j = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        m_p = step(state, b)
        _noise(seen[-1], names, noise)
        for key in ("loss", "grad_norm", "decoder_grad_norm"):
            np.testing.assert_allclose(float(m_p[key]), float(m_j[key]), rtol=STEP_RTOL,
                                       err_msg=f"{name} {key} step {i + 1}")
    leaf = state.model.decoder.prediction.dec_rnn.lstm.bias_l0.detach().numpy()
    np.testing.assert_allclose(leaf, np.asarray(jstate.params["decoder"]["lstm0_b"]), rtol=0,
                               atol=PARAM_ATOL)


# the resnet front end: replicated under tensor parallelism, its 2-D
# BatchNorms synchronised over the data group only
DIST_ENC = dict(feat_in=16, n_layers=1, d_model=128, n_heads=2, ff_expansion_factor=2,
                conv_kernel_size=7, subsampling="resnet", subsampling_conv_channels=4,
                dropout=0.0, dropout_att=0.0, dropout_emb=0.0, use_flash_attention=False)
DIST_SCHED = {"name": "NoamAnnealing", "d_model": 128, "warmup_steps": 10}


@pytest.mark.parametrize("name", ["novograd", "adafactor"])
def test_tp2_steps_match_one_process(name, tmp_path):
    cfg = CTCModelConfig(preprocessor=MelFeatureConfig(features=16, dither=0.0),
                         encoder=ConformerEncoderConfig(dtype=torch.float32, **DIST_ENC),
                         num_classes=11)
    torch.manual_seed(0)
    model = CTCModel(cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.1 * torch.randn(p.shape))
    weights = str(tmp_path / "w.pt")
    torch.save(model.state_dict(), weights)
    batches = [global_batch(0, rows=2), global_batch(1, rows=2)]
    results = run_world(str(tmp_path), "steps", 2, family="ctc", enc=DIST_ENC, vocab=11,
                        weights=weights, batches=write_batches(tmp_path, batches),
                        sched=DIST_SCHED, lr=0.5, grad_clip=1.0, data=1, model=2, optim=name)
    local = results[1]["local"]
    assert local["encoder.layers.0.self_attn.linear_q.weight"].shape == (64, 128)
    opt, seen = _probe(popt.make_optimizer(name, plr.make_lr_schedule(DIST_SCHED, 0.5),
                                           weight_decay=1e-3, betas=(0.9, 0.98), grad_clip=1.0))
    state = init_ctc_state(model, opt)
    step = make_ctc_train_step(cfg, opt)
    names = [n for n, _ in model.named_parameters()]
    noise: dict = {}
    for i, b in enumerate(batches):
        m = step(state, b)
        _noise(seen[-1], names, noise)
        np.testing.assert_allclose(results[0]["metrics"][i]["loss"], float(m["loss"]),
                                   rtol=1e-5, err_msg=f"loss at step {i + 1}")
    for k, v in state.model.state_dict().items():
        for r in results:
            g, w = r["full"][k].numpy(), v.numpy()
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(g, w, rtol=0, atol=STATS_ATOL, err_msg=k)
                continue
            np.testing.assert_allclose(g, w, rtol=0, atol=0.05, err_msg=k)
            if not k.endswith(ZERO_GRAD):
                signal = ~noise[k]
                np.testing.assert_allclose(g[signal], w[signal], rtol=0, atol=TP_ATOL,
                                           err_msg=k)
