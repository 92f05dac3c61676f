"""The port's RNN-T model against the JAX package's `RNNTModel`.

A tiny transducer (1 Conformer layer, d_model 32, prediction and joint
width 16, V 11, fp32) starts from the JAX package's initialised weights,
crossed through `rnnt_state_dict_from_jax`, and takes the same features and
targets (seeded numpy). The per-sample nll and every parameter gradient are
compared on the whole-batch dense joint, the `fused_batch_size` sub-batched
dense joint and the flash joint (JAX: Pallas in interpret mode; the port:
the K4 / K3 plain versions on the CPU). The port trains one LSTM bias per
layer as JAX does (its state_dict writes it as NeMo's bias_ih + bias_hh),
so the gradient of b is compared against the port's bias_l0. Tolerances: nll relative 1e-5; gradients 2e-4 relative and 1e-5 absolute
(fp32; the encoder and the lattice sum in other orders).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.models.conformer import ConformerEncoderConfig as JaxEncoderConfig
from conformer_nemo_tpu.models import rnnt as jax_rnnt
from conformer_nemo_tpu_torch.convert.jax_params import rnnt_state_dict_from_jax
from conformer_nemo_tpu_torch.models import rnnt as port
from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig
from conformer_nemo_tpu_torch.ops import rnnt_joint

V = 11
ENC = dict(feat_in=24, n_layers=1, d_model=32, n_heads=2, ff_expansion_factor=2,
           subsampling_factor=2, conv_kernel_size=9, conv_norm_type="layer_norm", dropout=0.0,
           dropout_att=0.0)
NLL_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-5


def _cfgs(joint_impl, fuse=False, fused_bs=16, **dec):
    dec = dict(vocab_size=V, pred_hidden=16, dropout=0.0, **dec)
    joint = dict(joint_hidden=16, dropout=0.0, fuse_loss_wer=fuse, fused_batch_size=fused_bs)
    jcfg = jax_rnnt.RNNTModelConfig(
        encoder=JaxEncoderConfig(dtype=jnp.float32, **ENC),
        decoder=jax_rnnt.RNNTDecoderConfig(dtype=jnp.float32, **dec),
        joint=jax_rnnt.RNNTJointConfig(dtype=jnp.float32, **joint),
        lattice_impl="scan", joint_impl=joint_impl, joint_flash_bt=8)
    pcfg = port.RNNTModelConfig(
        encoder=ConformerEncoderConfig(dtype=torch.float32, **ENC),
        decoder=port.RNNTDecoderConfig(dtype=torch.float32, **dec),
        joint=port.RNNTJointConfig(dtype=torch.float32, **joint),
        joint_impl=joint_impl, joint_flash_bt=8)
    return jcfg, pcfg


def _batch(b=4):
    rng = np.random.RandomState(0)
    feats = rng.randn(b, 24, 20).astype(np.float32)
    lens = np.array([20, 16, 12, 20][:b], np.int32)
    tgt = rng.randint(0, V, (b, 5)).astype(np.int32)
    tl = np.array([5, 3, 0, 4][:b], np.int32)
    return feats, lens, tgt, tl


def _grads_as_parameters(grads, pcfg):
    """JAX gradients under the port's parameter names: b's gradient (bridged
    as bias_ih, with zeros as bias_hh) becomes bias_l0's."""
    nofgb = dataclasses.replace(pcfg, decoder=dataclasses.replace(pcfg.decoder,
                                                                  forget_gate_bias=0.0))
    sd = rnnt_state_dict_from_jax({"params": grads}, nofgb)
    for k in [k for k in sd if ".bias_ih_l" in k]:
        hh = sd.pop(k.replace("bias_ih", "bias_hh"))
        assert not hh.any()
        sd[k.replace("bias_ih", "bias")] = sd.pop(k)
    return sd


@pytest.mark.parametrize("path", ["dense", "subbatch", "flash"])
def test_model_nll_and_gradients_match_jax(path):
    joint_impl = "flash" if path == "flash" else "dense"
    jcfg, pcfg = _cfgs(joint_impl, fuse=path == "subbatch", fused_bs=2)
    feats, lens, tgt, tl = _batch()
    jm = jax_rnnt.RNNTModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0), *(jnp.asarray(x) for x in (feats, lens, tgt, tl)))[
        "params"]
    cot = np.array([1.0, 0.5, 2.0, 1.5], np.float32)

    def loss(p):
        nll = jm.apply({"params": p}, *(jnp.asarray(x) for x in (feats, lens, tgt, tl)),
                       train=False)
        return jnp.sum(jnp.asarray(cot) * nll), nll

    (_, nll_j), g_j = jax.value_and_grad(loss, has_aux=True)(params)

    model = port.RNNTModel(pcfg).eval()
    model.load_state_dict(rnnt_state_dict_from_jax({"params": jax.device_get(params)}, pcfg))
    nll_p = model(*(torch.from_numpy(x) for x in (feats, lens, tgt, tl)))
    (torch.from_numpy(cot) * nll_p).sum().backward()
    np.testing.assert_allclose(nll_p.detach().numpy(), np.asarray(nll_j), rtol=NLL_TOL)
    want = _grads_as_parameters(jax.device_get(g_j), pcfg)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def _prednet(**dec):
    jcfg = jax_rnnt.RNNTDecoderConfig(vocab_size=8, pred_hidden=16, dtype=jnp.float32, **dec)
    pcfg = port.RNNTDecoderConfig(vocab_size=8, pred_hidden=16, dtype=torch.float32, **dec)
    net = jax_rnnt.PredictionNetwork(jcfg)
    targets = np.random.RandomState(1).randint(0, 8, (2, 5)).astype(np.int32)
    params = net.init(jax.random.PRNGKey(3), jnp.asarray(targets))["params"]
    full = port.RNNTModelConfig(decoder=pcfg,
                                encoder=ConformerEncoderConfig(dtype=torch.float32, **ENC))
    sd = rnnt_state_dict_from_jax({"params": {"encoder": _dummy_encoder(), "decoder": params,
                                              "joint": _dummy_joint()}}, full)
    mine = port.PredictionNetwork(pcfg)
    mine.load_state_dict({k[len("decoder."):]: v for k, v in sd.items()
                          if k.startswith("decoder.")})
    return net, params, mine, targets


@functools.lru_cache(maxsize=1)
def _dummy_encoder():
    m = jax_rnnt.RNNTModel(_cfgs("dense")[0])
    feats, lens, tgt, tl = _batch(1)
    return m.init(jax.random.PRNGKey(0), *(jnp.asarray(x) for x in (feats, lens, tgt, tl)))[
        "params"]["encoder"]


def _dummy_joint():
    z = np.zeros((16, 16), np.float32)
    return {"enc": {"kernel": np.zeros((32, 16), np.float32), "bias": np.zeros(16, np.float32)},
            "pred": {"kernel": z, "bias": np.zeros(16, np.float32)},
            "out_kernel": np.zeros((16, V + 1), np.float32),
            "out_bias": np.zeros(V + 1, np.float32)}


@pytest.mark.parametrize("dec", [{}, {"norm": "layer"}, {"t_max": 50}, {"forget_gate_bias": 0.0}])
def test_prednet_matches_jax_and_step_matches_sequence(dec):
    net, params, mine, targets = _prednet(**dec)
    want = np.asarray(net.apply({"params": params}, jnp.asarray(targets)))
    with torch.no_grad():
        got = mine(torch.from_numpy(targets))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        # the decode step, fed SOS then the targets, retraces the sequence
        state = mine.zero_state(2)
        label = torch.full((2,), 8, dtype=torch.int64)
        for u in range(targets.shape[1] + 1):
            g, state = mine.step(label, state)
            torch.testing.assert_close(g, got[:, u], rtol=1e-5, atol=1e-6)
            if u < targets.shape[1]:
                label = torch.from_numpy(targets[:, u]).long()


def test_prednet_init_rules():
    """Chrono init (forget = log U(1, t_max-1), input = -forget, no constant),
    forget_gate_bias not in the trained leaf but in the state_dict's
    bias_ih (bias_hh zeros),
    weights_init_scale, blank embeds to zero."""
    gen = torch.Generator().manual_seed(0)
    chrono = port.PredictionNetwork(port.RNNTDecoderConfig(vocab_size=8, pred_hidden=16,
                                                           t_max=50, dtype=torch.float32))
    chrono.reset_parameters(gen)
    b = chrono.prediction.dec_rnn.lstm.bias_l0.detach()
    assert (b[16:32] >= 0).all() and (b[16:32] <= np.log(49.0) + 1e-6).all()
    torch.testing.assert_close(b[:16], -b[16:32])
    plain = port.PredictionNetwork(port.RNNTDecoderConfig(vocab_size=8, pred_hidden=16,
                                                          dtype=torch.float32))
    plain.reset_parameters(torch.Generator().manual_seed(0))
    lstm = plain.prediction.dec_rnn.lstm
    assert not lstm.bias_l0.detach().any()  # the leaf holds no constant
    sd = plain.state_dict()
    pre = "prediction.dec_rnn.lstm."
    assert torch.equal(sd[pre + "bias_ih_l0"][16:32], torch.ones(16))
    assert torch.equal(sd[pre + "bias_hh_l0"], torch.zeros(64))
    assert pre + "bias_l0" not in sd
    # loading sums NeMo's pair and subtracts forget_gate_bias from the
    # forget chunk, into the one bias (the JAX leaf), and the pair round-trips
    sd[pre + "bias_hh_l0"] = torch.full((64,), 0.25)
    want = sd[pre + "bias_ih_l0"].clone() + 0.25
    want[16:32] -= 1.0
    plain.load_state_dict(sd)
    torch.testing.assert_close(lstm.bias_l0.detach(), want)
    assert torch.equal(plain.state_dict()[pre + "bias_hh_l0"], torch.zeros(64))
    scaled = port.PredictionNetwork(port.RNNTDecoderConfig(
        vocab_size=8, pred_hidden=16, weights_init_scale=0.5, dtype=torch.float32))
    scaled.reset_parameters(torch.Generator().manual_seed(0))
    torch.testing.assert_close(scaled.prediction.dec_rnn.lstm.weight_ih_l0,
                               0.5 * lstm.weight_ih_l0)
    w = lstm.weight_hh_l0.detach()
    torch.testing.assert_close(w.T @ w, torch.eye(16), atol=1e-5, rtol=0)  # orthogonal
    emb = plain._embed(torch.tensor([[8, 3]]))
    assert emb[0, 0].abs().max() == 0 and emb[0, 1].abs().max() > 0


def test_resolve_joint_and_lattice_impl(monkeypatch):
    # "auto" asks the joint library whether the flash backward takes H; this
    # machine has no CUDA compiler, so a stand-in says it does (H 640 fits)
    monkeypatch.setattr(rnnt_joint, "_lib", lambda: types.SimpleNamespace(
        rnnt_joint_smem_bytes=lambda h, v, which: 0))
    cfg = port.RNNTModelConfig(decoder=port.RNNTDecoderConfig(vocab_size=295))
    assert cfg.resolve_joint_impl(16, 420, 50, "cpu") == "dense"
    assert cfg.resolve_joint_impl(16, 420, 50, "cuda") == "dense"  # 0.6 GB < 5 GB
    assert cfg.resolve_joint_impl(8, 3000, 301, "cuda") == "flash"  # 12.8 GB > 5 GB
    assert dataclasses.replace(cfg, joint_impl="flash").resolve_joint_impl(1, 8, 2, "cpu") == \
        "flash"
    assert cfg.resolved_lattice_impl("cpu") == "plain"
    assert cfg.resolved_lattice_impl("cuda") == "kernel"
