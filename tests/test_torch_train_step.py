"""Port CTC train step vs the JAX package's `make_ctc_train_step`.

A tiny Conformer-CTC (2 layers, d_model 64, fp32 compute, BatchNorm, flash
attention forced on: the JAX side runs its Pallas kernels in interpret
mode, the port the kernels' plain versions) starts from the same weights
(crossed through `ctc_state_dict_from_jax`) and takes the same batches,
with dropout, dither and SpecAugment off so that no random stream is
involved, under adamw + Noam from the same config. Loss, gradient norm,
parameters and BatchNorm statistics are compared after each step, with and
without `skip_nan_grad` on an injected non-finite batch.

Tolerances: loss and gradient norm relative 1e-4 (both sides fp32; the
forward and backward sum in different orders: online vs dense softmax,
conv algorithms; measured 2e-6). BatchNorm statistics absolute 1e-5.
Parameters: Adam moves a weight by about lr times the sign of its
gradient, so weights are compared at 1e-6 absolute, well below the
1.6e-5 the two steps move them. Where a step's gradient is at fp32
rounding on either side, its sign is noise and Adam turns it into a
+-lr step: the two biases whose gradient is zero in exact arithmetic (the
attention key bias, under softmax's shift invariance; the depthwise-conv
bias, which training BatchNorm subtracts), and entries whose gradient in
some step is below 1e-4 of their tensor's largest (the low-frequency
columns of linear_pos fall there). Those are held only to the most a sign
flip can move them, 4 x the summed learning rates.

The batch's zero row (loader padding) reaches LayerNorm with zero variance
and BatchNorm couples it back into the loss, so the gradient norm at this
initialisation is ~6e8 on both sides; it agrees all the same.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.models.conformer import ConformerEncoderConfig as JaxEncoderConfig
from conformer_nemo_tpu.models.ctc_model import CTCModelConfig as JaxCTCConfig
from conformer_nemo_tpu.audio.features import MelFeatureConfig as JaxMelConfig
from conformer_nemo_tpu.train import lr_schedule as jax_lr
from conformer_nemo_tpu.train import optim as jax_optim
from conformer_nemo_tpu.train.trainer import init_ctc_state as jax_init_state
from conformer_nemo_tpu.train.trainer import make_ctc_train_step as jax_train_step
from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig
from conformer_nemo_tpu_torch.convert.jax_params import ctc_state_dict_from_jax
from conformer_nemo_tpu_torch.models import conformer as port_conformer
from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig, fast_dropout
from conformer_nemo_tpu_torch.models.ctc_model import CTCModel, CTCModelConfig
from conformer_nemo_tpu_torch.train import lr_schedule as port_lr
from conformer_nemo_tpu_torch.train import optim as port_optim
from conformer_nemo_tpu_torch.train.trainer import init_ctc_state, make_ctc_train_step

torch.set_num_threads(2)

V = 29
RTOL = 1e-4
PARAM_ATOL = 1e-6
STATS_ATOL = 1e-5
NOISE_FLOOR = 1e-4  # of a tensor's largest gradient in a step
# gradients zero in exact arithmetic: their sign is rounding on either side
ZERO_GRAD = ("self_attn.linear_k.bias", "conv.depthwise_conv.bias")
ENC = dict(feat_in=80, n_layers=2, d_model=64, n_heads=4, conv_kernel_size=15, dropout=0.0,
           dropout_att=0.0, dropout_emb=0.0, use_flash_attention=True)
SCHED = {"name": "NoamAnnealing", "d_model": 64, "warmup_steps": 1000, "min_lr": 1e-6}


def _batch(seed, nan=False):
    rng = np.random.RandomState(seed)
    n = 16000
    audio = (0.1 * rng.randn(3, n)).astype(np.float32)
    lens = np.array([n, 11200, 0], np.int32)  # the last row is loader padding
    audio[1, 11200:] = 0.0
    audio[2] = 0.0
    if nan:
        audio[0, 100] = np.nan
    tokens = rng.randint(0, V, (3, 8)).astype(np.int32)
    return {"audio": audio, "audio_lens": lens, "tokens": tokens,
            "token_lens": np.array([8, 5, 0], np.int32)}


def _jax_side(skip_nan_grad):
    cfg = JaxCTCConfig(preprocessor=JaxMelConfig(dither=0.0),
                       encoder=JaxEncoderConfig(dtype=jnp.float32, **ENC), num_classes=V)
    opt = jax_optim.make_optimizer("adamw", jax_lr.make_lr_schedule(SCHED, 2.0),
                                   weight_decay=1e-3, betas=(0.9, 0.98))
    state = jax_init_state(cfg, opt, jax.random.PRNGKey(0), (1, 80, 64))
    return state, jax_train_step(cfg, opt, skip_nan_grad=skip_nan_grad), cfg


def _port_side(jax_state):
    cfg = CTCModelConfig(preprocessor=MelFeatureConfig(dither=0.0),
                         encoder=ConformerEncoderConfig(dtype=torch.float32, **ENC),
                         num_classes=V)
    model = CTCModel(cfg)
    variables = {"params": jax.device_get(jax_state.params),
                 "batch_stats": jax.device_get(jax_state.batch_stats)}
    model.load_state_dict(ctc_state_dict_from_jax(variables, cfg))
    opt = port_optim.make_optimizer("adamw", port_lr.make_lr_schedule(SCHED, 2.0),
                                    weight_decay=1e-3, betas=(0.9, 0.98))
    return init_ctc_state(model, opt), opt, cfg


def _assert_state_matches(port_state, jax_state, cfg, noise, lr_sum):
    """noise: {param name: bool mask of entries whose sign is rounding}."""
    variables = {"params": jax.device_get(jax_state.params),
                 "batch_stats": jax.device_get(jax_state.batch_stats)}
    want = ctc_state_dict_from_jax(variables, cfg)
    got = port_state.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        if k not in noise:  # BatchNorm statistics (NaN on both sides after a NaN batch)
            np.testing.assert_allclose(g, w, rtol=0, atol=STATS_ATOL, err_msg=k)
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=4 * lr_sum, err_msg=k)
        if not k.endswith(ZERO_GRAD):
            signal = ~noise[k]
            np.testing.assert_allclose(g[signal], w[signal], rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)


def _update_noise(noise, names, mu_old, mu_new, b1=0.9):
    """Mark the entries whose gradient this step (from Adam's first moment)
    is below NOISE_FLOOR of their tensor's largest."""
    for n, m0, m1 in zip(names, mu_old, mu_new):
        g = ((m1 - b1 * m0) / (1 - b1)).abs().numpy()
        noise[n] |= g < NOISE_FLOOR * g.max()


@pytest.mark.parametrize("skip_nan_grad", [False, True])
def test_train_steps_match_jax(skip_nan_grad):
    jax_state, jax_step, _ = _jax_side(skip_nan_grad)
    port_state, opt, cfg = _port_side(jax_state)
    step = make_ctc_train_step(cfg, opt, skip_nan_grad=skip_nan_grad)
    # with skip_nan_grad, the middle batch's gradient is NaN and is skipped;
    # the BatchNorm statistics of that forward go NaN on both sides
    batches = [_batch(0), _batch(1, nan=True), _batch(2)] if skip_nan_grad else \
        [_batch(0), _batch(1)]
    names = [n for n, _ in port_state.model.named_parameters()]
    noise = {n: np.zeros(p.shape, bool) for n, p in port_state.model.named_parameters()}
    schedule = port_lr.make_lr_schedule(SCHED, 2.0)
    lr_sum = 0.0
    for i, batch in enumerate(batches):
        jax_state, m_j = jax_step(jax_state, {k: jnp.asarray(v) for k, v in batch.items()})
        mu_old, count = port_state.opt_state["mu"], port_state.opt_state["count"]
        m_p = step(port_state, batch)
        if batch["audio"].sum() != batch["audio"].sum():  # the NaN batch
            assert not math.isfinite(float(m_p["grad_norm"]))
            assert port_state.opt_state["mu"] is mu_old  # nothing was updated
        else:
            np.testing.assert_allclose(float(m_p["loss"]), float(m_j["loss"]), rtol=RTOL)
            np.testing.assert_allclose(float(m_p["grad_norm"]), float(m_j["grad_norm"]),
                                       rtol=RTOL)
            _update_noise(noise, names, mu_old, port_state.opt_state["mu"])
            lr_sum += schedule(count)
        _assert_state_matches(port_state, jax_state, cfg, noise, lr_sum)
    # the tight check covers most of every tensor (linear_pos: ~73%)
    assert max(m.mean() for n, m in noise.items() if not n.endswith(ZERO_GRAD)) < 0.3
    assert port_state.step == int(jax_state.step) == len(batches)
    if skip_nan_grad:  # the skipped step did not advance the optimizer
        assert port_state.opt_state["count"] == 2


def _tiny_model(**enc):
    cfg = CTCModelConfig(encoder=ConformerEncoderConfig(
        dtype=torch.float32, **{**ENC, "dropout": 0.1, "use_flash_attention": "auto", **enc}),
        num_classes=V)
    model = CTCModel(cfg)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    return model


def _grads(model, feats, lens, seed):
    lp, _ = model(feats, lens, dropout_seed=seed)
    loss = (lp * torch.linspace(-1, 1, lp.shape[-1])).sum()
    return torch.autograd.grad(loss, list(model.parameters()))


def test_remat_keeps_gradients_and_updates_batchnorm_once():
    """Dropout on, a fixed seed: gradients with remat on and off agree (the
    recomputed layers draw the same masks), and the BatchNorm statistics
    take exactly one momentum update per forward."""
    feats = torch.from_numpy(np.random.RandomState(0).randn(2, 80, 64).astype(np.float32))
    lens = torch.tensor([64, 40], dtype=torch.int32)
    plain = _tiny_model().train()
    remat = _tiny_model(remat=True).train()
    remat.load_state_dict(plain.state_dict())
    bn = "encoder.layers.1.conv.batch_norm.running_var"
    before = plain.state_dict()[bn].clone()
    g_plain = _grads(plain, feats, lens, seed=7)
    g_remat = _grads(remat, feats, lens, seed=7)
    for a, b in zip(g_plain, g_remat):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    after_plain, after_remat = plain.state_dict()[bn], remat.state_dict()[bn]
    torch.testing.assert_close(after_remat, after_plain, rtol=0, atol=0)
    assert not torch.equal(after_plain, before)
    # another seed draws other masks
    g_other = _grads(plain, feats, lens, seed=8)
    assert not all(torch.equal(a, b) for a, b in zip(g_plain, g_other))


def test_fast_dropout_rate_and_mean():
    x = torch.ones(1_000_000)
    for rate in (0.1, 0.25):
        t = round(rate * 256)
        y = fast_dropout(x, rate, seed=3)
        dropped = (y == 0).float().mean().item()
        sigma = math.sqrt(t / 256 * (1 - t / 256) / x.numel())
        assert abs(dropped - t / 256) < 5 * sigma  # the realised rate is t/256
        assert abs(y.mean().item() - 1.0) < 5 * sigma / (1 - t / 256)  # mean preserved
        assert torch.equal(y, fast_dropout(x, rate, seed=3))  # a pure function of the seed
    assert fast_dropout(x, 0.1, None) is x and fast_dropout(x, 0.001, 3) is x


@pytest.mark.parametrize("dropout_att,training,flash", [(0.1, True, False), (0.1, False, True),
                                                         (0.0, True, True)])
def test_flash_dispatch_respects_attention_dropout(dropout_att, training, flash):
    """The JAX dispatch: the flash kernel has no dropout epilogue, so a
    training model with attention dropout takes the dense path."""
    model = _tiny_model(use_flash_attention=True, dropout_att=dropout_att)
    attn = model.encoder.layers[0].self_attn
    model.train(training)
    assert attn.use_flash(100, torch.tensor([100])) is flash


def test_sin_cos_tables_built_once_keep_outputs_bit_identical(monkeypatch):
    """The encoder builds the sin/cos tables once per forward; running the
    same layers with tables rebuilt per layer (the earlier design) gives
    bit-identical log-probs."""
    model = _tiny_model(use_flash_attention=True).eval()
    feats = torch.from_numpy(np.random.RandomState(1).randn(2, 80, 64).astype(np.float32))
    lens = torch.tensor([64, 33], dtype=torch.int32)
    calls = []
    build = port_conformer.sin_cos_tables
    monkeypatch.setattr(port_conformer, "sin_cos_tables",
                        lambda *a: calls.append(a) or build(*a))
    with torch.inference_mode():
        lp, _ = model(feats, lens)
    assert len(calls) == 1
    rebuilt = [layer.self_attn.forward for layer in model.encoder.layers]
    for layer, fwd in zip(model.encoder.layers, rebuilt):
        def per_layer(x, pos_emb, sin_cos, *rest, fwd=fwd, **kw):
            t = x.shape[1]
            pos = np.arange(t, dtype=np.float64)[:, None] * port_conformer._inv_freq(64)[None]
            tables = tuple(torch.from_numpy(f(pos)).to(x.device, torch.float32)
                           for f in (np.sin, np.cos))
            return fwd(x, pos_emb, tables, *rest, **kw)
        monkeypatch.setattr(layer.self_attn, "forward", per_layer)
    with torch.inference_mode():
        lp_rebuilt, _ = model(feats, lens)
    assert torch.equal(lp, lp_rebuilt)
