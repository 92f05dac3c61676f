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
both ways bit for bit. Two train steps of a tiny CTC model per mode
against `make_ctc_train_step` (adamw + Noam, dropout, dither and
SpecAugment off): loss and gradient norm relative 1e-4, BatchNorm
statistics 1e-5 absolute. Then `.nemo` checkpoints of a resnet CTC and a
subencoder transducer, written by the test with NeMo's extra entries,
load in the port as the JAX converter loads them, and each mode's CTC
model exports (`torch.export`) to a program equal to the live forward.
"""

import dataclasses
import os

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
from conformer_nemo_tpu.train import lr_schedule as jax_lr
from conformer_nemo_tpu.train import optim as jax_optim
from conformer_nemo_tpu.train.trainer import init_ctc_state as jax_init_state
from conformer_nemo_tpu.train.trainer import make_ctc_train_step as jax_train_step
from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer
from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig, log_mel_spectrogram
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
from conformer_nemo_tpu_torch.train import lr_schedule as port_lr
from conformer_nemo_tpu_torch.train import optim as port_optim
from conformer_nemo_tpu_torch.train.trainer import init_ctc_state, make_ctc_train_step
from conformer_nemo_tpu_torch.utils.export import load_exported

from test_torch_nemo import _check_both, _nemo_config, _nemo_state, _write_nemo
from test_torch_portable import ENC as PENC
from test_torch_portable import RNNT, ROOT

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


@pytest.mark.parametrize("mode,factor", [c for c in CASES if c[0] != "striding"])
def test_two_train_steps_match_jax(mode, factor):
    sched = {"name": "NoamAnnealing", "d_model": 32, "warmup_steps": 1000, "min_lr": 1e-6}
    jcfg, pcfg = _configs(mode, factor, feat_in=80)
    jopt = jax_optim.make_optimizer("adamw", jax_lr.make_lr_schedule(sched, 2.0),
                                    weight_decay=1e-3)
    jstate = jax_init_state(jcfg, jopt, jax.random.PRNGKey(0), (1, 80, 64))
    jstep = jax_train_step(jcfg, jopt)
    variables = {"params": jax.device_get(jstate.params),
                 "batch_stats": jax.device_get(jstate.batch_stats)}
    model = CTCModel(pcfg)
    model.load_state_dict(ctc_state_dict_from_jax(variables, pcfg))
    popt = port_optim.make_optimizer("adamw", port_lr.make_lr_schedule(sched, 2.0),
                                     weight_decay=1e-3)
    state = init_ctc_state(model, popt)
    step = make_ctc_train_step(pcfg, popt)
    rng = np.random.RandomState(5)
    for i in range(2):
        n = 12000
        audio = (0.1 * rng.randn(2, n)).astype(np.float32)
        audio[1, 9000:] = 0.0
        batch = {"audio": audio, "audio_lens": np.array([n, 9000], np.int32),
                 "tokens": rng.randint(0, V, (2, 5)).astype(np.int32),
                 "token_lens": np.array([5, 3], np.int32)}
        jstate, m_j = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        m_p = step(state, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m_p[key]), float(m_j[key]), rtol=RTOL,
                                       err_msg=f"{key} at step {i + 1}")
    want = ctc_state_dict_from_jax({"params": jax.device_get(jstate.params),
                                    "batch_stats": jax.device_get(jstate.batch_stats)}, pcfg)
    for k, v in state.model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=STATS_ATOL,
                                       err_msg=k)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown subsampling mode"):
        CTCModel(dataclasses.replace(_configs("striding", 4)[1], encoder=ConformerEncoderConfig(
            **dict(ENC, subsampling="dw_striding"))))


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
