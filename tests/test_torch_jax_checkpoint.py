"""Resumable checkpoints across the packages (convert/jax_train_state.py,
train/checkpoint.py).

The JAX package trains a tiny model (d_model 128, so adafactor factors its
linears) three steps with its own train step and writes `state.msgpack`
with its own `save_train_state`; the port restores the directory through
`restore_train_state`, under five optimizer setups (adamw clipped,
adafactor accumulating over 2 micro-batches, novograd clipped, and for
the transducer adamw and rmsprop clipped and accumulating). Checked:

- the restored parameters and BatchNorm statistics are the JAX state's
  through the weight bridge, bit for bit (the LSTM bias leaf as the JAX
  leaf itself), and the step is the JAX step;
- the port's optimizer state written back (`opt_state_to_jax`) is the
  file's tree leaf for leaf, bit for bit, and the port's whole train
  state written as a `state.msgpack` restores in the JAX package to the
  JAX state bit for bit (the key aside, which crosses by a rule);
- step 4 on the same batch, with dither, SpecAugment and dropout off:
  loss and gradient norm relative 1e-4 (fp32 both sides, other summation
  orders, as tests/test_torch_train_step.py), the state after it within
  1e-4 absolute, but where a gradient's sign is rounding (the two biases
  whose gradient is zero in exact arithmetic, and entries whose step-4
  gradient is below 1e-4 of their tensor's largest, such as linear_pos's
  low-frequency columns): those within the most a step moves them (0.05).

The files crossing both ways through `fit` are in
test_torch_jax_checkpoint_files.py (the two files spread over the test
workers).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from conformer_nemo_tpu.audio.features import MelFeatureConfig as JaxMelConfig
from conformer_nemo_tpu.models import rnnt as jax_rnnt
from conformer_nemo_tpu.models.conformer import ConformerEncoderConfig as JaxEncoderConfig
from conformer_nemo_tpu.models.ctc_model import CTCModelConfig as JaxCTCConfig
from conformer_nemo_tpu.train import checkpoint as jax_ckpt
from conformer_nemo_tpu.train import lr_schedule as jlr
from conformer_nemo_tpu.train import optim as jopt
from conformer_nemo_tpu.train import rnnt_trainer as jax_rnnt_trainer
from conformer_nemo_tpu.train import trainer as jax_trainer
from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig
from conformer_nemo_tpu_torch.convert import flax_msgpack
from conformer_nemo_tpu_torch.convert import jax_train_state as jts
from conformer_nemo_tpu_torch.convert.jax_params import (
    ctc_state_dict_from_jax,
    rnnt_state_dict_from_jax,
)
from conformer_nemo_tpu_torch.models import rnnt as port_rnnt
from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig
from conformer_nemo_tpu_torch.models.ctc_model import CTCModel, CTCModelConfig
from conformer_nemo_tpu_torch.train import checkpoint as ckpt
from conformer_nemo_tpu_torch.train import lr_schedule as plr
from conformer_nemo_tpu_torch.train import optim as popt
from conformer_nemo_tpu_torch.train.rnnt_trainer import RNNTTrainConfig, init_rnnt_state
from conformer_nemo_tpu_torch.train.rnnt_trainer import make_rnnt_train_step
from conformer_nemo_tpu_torch.train.trainer import init_ctc_state, make_ctc_train_step

torch.set_num_threads(2)

RTOL = 1e-4
PARAM_ATOL = 1e-4
# gradients zero in exact arithmetic (softmax's shift, training BatchNorm):
# their sign is rounding on either side, held to the most a step can move
ZERO_GRAD = ("self_attn.linear_k.bias", "conv.depthwise_conv.bias")
REACH = 0.05
NOISE_FLOOR = 1e-4  # of a tensor's largest gradient: below it a sign is noise
V = 9
SCHED = {"name": "NoamAnnealing", "d_model": 128, "warmup_steps": 10}
CTC_ENC = dict(feat_in=80, n_layers=1, d_model=128, n_heads=2, ff_expansion_factor=2,
               conv_kernel_size=7, subsampling_conv_channels=8, dropout=0.0, dropout_att=0.0,
               dropout_emb=0.0)
RNNT_ENC = dict(CTC_ENC, feat_in=16, conv_norm_type="layer_norm")
DEC = dict(vocab_size=V, pred_hidden=16, dropout=0.0)
CASES = {  # family, optimizer, clipping, micro-batches per update
    "ctc_adamw_clip": ("ctc", "adamw", 1.0, 1),
    "ctc_adafactor_accumulate": ("ctc", "adafactor", None, 2),
    "ctc_novograd_clip": ("ctc", "novograd", 1.0, 1),
    "rnnt_adamw": ("rnnt", "adamw", None, 1),
    "rnnt_rmsprop_clip_accumulate": ("rnnt", "rmsprop", 1.0, 2),
}


def _batch(seed):
    rng = np.random.RandomState(seed)
    n = 8000
    audio = (0.1 * rng.randn(2, n)).astype(np.float32)
    audio[1, 6000:] = 0.0
    return {"audio": audio, "audio_lens": np.array([n, 6000], np.int32),
            "tokens": rng.randint(0, V, (2, 4)).astype(np.int32),
            "token_lens": np.array([4, 2], np.int32)}


def _optimizers(name, clip, every):
    """-> (the JAX optimizer, the port's, the gradients the port's saw)."""
    kw = dict(weight_decay=1e-3, grad_clip=clip)
    port = popt.with_grad_accumulation(
        popt.make_optimizer(name, plr.make_lr_schedule(SCHED, 0.5), **kw), every)
    seen = []

    def update(grads, state, params):
        seen.append([g.detach().clone() for g in grads])
        return port.update(grads, state, params)

    return (jopt.with_grad_accumulation(
                jopt.make_optimizer(name, jlr.make_lr_schedule(SCHED, 0.5), **kw), every),
            popt.Transformation(port.init, update), seen)


def _sides(family, jo, po):
    """-> (JAX state, JAX step, port train state, port step, state_dict_from_jax)."""
    if family == "ctc":
        jcfg = JaxCTCConfig(preprocessor=JaxMelConfig(dither=0.0),
                            encoder=JaxEncoderConfig(dtype=jnp.float32, **CTC_ENC),
                            num_classes=V)
        pcfg = CTCModelConfig(preprocessor=MelFeatureConfig(dither=0.0),
                              encoder=ConformerEncoderConfig(dtype=torch.float32, **CTC_ENC),
                              num_classes=V)
        jstate = jax_trainer.init_ctc_state(jcfg, jo, jax.random.PRNGKey(0), (1, 80, 64))
        pstate = init_ctc_state(CTCModel(pcfg), po)
        return (jstate, jax_trainer.make_ctc_train_step(jcfg, jo), pstate,
                make_ctc_train_step(pcfg, po), lambda v: ctc_state_dict_from_jax(v, pcfg))
    jcfg = jax_rnnt_trainer.RNNTTrainConfig(
        preprocessor=JaxMelConfig(features=16, dither=0.0),
        model=jax_rnnt.RNNTModelConfig(
            encoder=JaxEncoderConfig(dtype=jnp.float32, **RNNT_ENC),
            decoder=jax_rnnt.RNNTDecoderConfig(dtype=jnp.float32, **DEC),
            joint=jax_rnnt.RNNTJointConfig(joint_hidden=16, dropout=0.0, dtype=jnp.float32)))
    pcfg = RNNTTrainConfig(
        preprocessor=MelFeatureConfig(features=16, dither=0.0),
        model=port_rnnt.RNNTModelConfig(
            encoder=ConformerEncoderConfig(dtype=torch.float32, **RNNT_ENC),
            decoder=port_rnnt.RNNTDecoderConfig(dtype=torch.float32, **DEC),
            joint=port_rnnt.RNNTJointConfig(joint_hidden=16, dropout=0.0, dtype=torch.float32)))
    jstate = jax_rnnt_trainer.init_rnnt_state(jcfg, jo, jax.random.PRNGKey(0), (1, 16, 64))
    pstate = init_rnnt_state(port_rnnt.RNNTModel(pcfg.model), po)
    return (jstate, jax_rnnt_trainer.make_rnnt_train_step(jcfg, jo), pstate,
            make_rnnt_train_step(pcfg, po), lambda v: rnnt_state_dict_from_jax(v, pcfg.model))


def _host(jstate):
    return {"params": jax.device_get(jstate.params),
            "batch_stats": jax.device_get(jstate.batch_stats)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_resumes_a_jax_checkpoint(case, tmp_path):
    family, name, clip, every = CASES[case]
    jo, po, seen = _optimizers(name, clip, every)
    jstate, jstep, pstate, pstep, from_jax = _sides(family, jo, po)
    for i in range(3):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in _batch(i).items()})
    ckpt_dir = str(tmp_path / "jax")
    jax_ckpt.save_train_state(ckpt_dir, jstate, 3)
    host = jax.device_get(jstate)
    restored, meta = ckpt.restore_train_state(ckpt_dir, pstate)
    assert restored is pstate and meta["step"] == 3 and pstate.step == 3

    want = from_jax(_host(jstate))
    for k, v in pstate.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    if family == "rnnt":
        np.testing.assert_array_equal(
            pstate.model.decoder.prediction.dec_rnn.lstm.bias_l0.detach().numpy(),
            np.asarray(host.params["decoder"]["lstm0_b"]))
    with open(os.path.join(ckpt_dir, "step_3", jts.STATE_FILE), "rb") as f:
        file_opt = _flat(flax_msgpack.loads(f.read())["opt_state"])
    indices = jts._index_list(pstate.model)
    back = _flat(jts.opt_state_to_jax(pstate.opt_state, indices, name, clip is not None))
    assert back.keys() == file_opt.keys()
    for k in back:
        np.testing.assert_array_equal(back[k], file_opt[k], err_msg=k)

    # the port's state written for the JAX package restores to the JAX state
    out = tmp_path / "back" / "step_3"
    out.mkdir(parents=True)
    jts.write_train_state(str(out / jts.STATE_FILE), pstate, name, clip)
    (out / "meta.json").write_text('{"step": 3, "metrics": {}}')
    template = jax.tree.map(jnp.zeros_like, host)
    with open(out / jts.STATE_FILE, "rb") as f:
        again = serialization.from_bytes(template, f.read())
    a = serialization.to_state_dict(again)
    b = serialization.to_state_dict(host)
    fa, fb = _flat({k: v for k, v in a.items() if k != "rng"}), _flat(
        {k: v for k, v in b.items() if k != "rng"})
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)

    batch = _batch(3)
    jstate, m_j = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    m_p = pstep(pstate, batch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m_p[key]), float(m_j[key]), rtol=RTOL, err_msg=key)
    want = from_jax(_host(jstate))
    names = [n for n, _ in pstate.model.named_parameters()]
    noise = {jts._sd_key(n, want): (g.abs() < NOISE_FLOOR * g.abs().max()).numpy()
             for n, g in zip(names, seen[-1])}
    for k, v in pstate.model.state_dict().items():
        g, w = v.numpy(), want[k].numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=REACH, err_msg=k)
        if not k.endswith(ZERO_GRAD):
            signal = ~noise.get(k, np.zeros(g.shape, bool))
            np.testing.assert_allclose(g[signal], w[signal], rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)


def test_generator_and_key_rule():
    key = np.array([3, 0xFFFF0001], np.uint32)
    gen = jts.generator_from_key(key)
    assert gen.initial_seed() == (3 << 32) | 0xFFFF0001
    state = gen.get_state()
    k = jts.key_from_generator(gen)
    assert k.dtype == np.uint32 and k.shape == (2,)
    assert torch.equal(gen.get_state(), state)  # the live generator did not move
    assert jts.generator_from_key(k).initial_seed() == ((int(k[0]) << 32) | int(k[1])) & (
        (1 << 63) - 1)


def test_index_maps_every_entry_once():
    """Each JAX leaf's entries are the port parameter's, each once (the
    pre-encode's row permutation and the conv layouts included)."""
    cfg = CTCModelConfig(encoder=ConformerEncoderConfig(
        dtype=torch.float32, **dict(CTC_ENC, subsampling="resnet")), num_classes=V)
    model = CTCModel(cfg)
    index = jts.param_index(model)
    for name, p in model.named_parameters():
        li = index[name]
        flat = li.index.reshape(-1)
        assert flat.numel() == int(np.prod(li.shape)) == p.numel(), name
        assert torch.equal(torch.sort(flat).values, torch.arange(p.numel())), name
    assert index["encoder.pre_encode.out.weight"].axes == (1, 0)
    assert index["encoder.pre_encode.conv.0.conv1.weight"].axes == (3, None, 0, 1)  # 1 input
    assert index["encoder.pre_encode.conv.2.conv1.weight"].axes == (3, 2, 0, 1)
