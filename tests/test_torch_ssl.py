"""The port's SSL pretraining against the JAX package's, on the CPU.

Covers `masked_patch_augmentation` and `crop_or_pad_spectrogram`
(the JAX draws fed in), each module of models/ssl.py (the reconstruction
decoder's stride-2 transposed convolution at odd and even T, the Gumbel
quantizer with the JAX Gumbel draws, the wav2vec feature encoder), the
contrastive loss with and without quantised targets and its gradients (the
JAX `q_rng, neg_rng` split reproduced with jax.random), the SSL step end to
end (loss and every gradient), the `.cntpu` archives both ways, and `fit`
+ `transfer_encoder_to` in the port.

Tolerances (both sides fp32): module outputs 1e-5 absolute after
normalisation (different summation orders; measured ~1e-6); losses 1e-5
relative; gradients 1e-4 of each tensor's largest entry. Masks, indices,
lengths and archives exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conformer_nemo_tpu.api_ssl import SpeechSSLModel as JaxSSLModel
from conformer_nemo_tpu.audio import spec_augment as jsa
from conformer_nemo_tpu.audio.features import MelFeatureConfig as JaxMel
from conformer_nemo_tpu.models import ssl as jssl
from conformer_nemo_tpu.models.conformer import ConformerEncoderConfig as JaxEncCfg
from conformer_nemo_tpu.ops import contrastive_loss as jcl
from conformer_nemo_tpu.train.trainer import TrainState as JaxTrainState
from conformer_nemo_tpu_torch.api_ssl import SpeechSSLModel, mask_inputs
from conformer_nemo_tpu_torch.audio import spec_augment as psa
from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig
from conformer_nemo_tpu_torch.convert.jax_params import (
    mirrored_from_jax,
    ssl_state_dict_from_jax,
    ssl_variables_to_jax,
)
from conformer_nemo_tpu_torch.data.audio_io import write_wav
from conformer_nemo_tpu_torch.models import ssl as pssl
from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig
from conformer_nemo_tpu_torch.ops import contrastive_loss as pcl

torch.set_num_threads(2)

ATOL = 1e-5
RTOL = 1e-5
GRAD_REL = 1e-4
# gradients zero in exact arithmetic (BatchNorm subtracts the depthwise bias;
# softmax's shift invariance cancels the key bias): rounding on either side
ZERO_GRAD = ("depthwise_bias", "linear_k")
ZERO_ATOL = 1e-5
ENC = dict(feat_in=16, n_layers=1, d_model=32, n_heads=4, subsampling_factor=4,
           conv_kernel_size=7, dropout=0.0, dropout_att=0.0, dropout_emb=0.0)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _load(module, variables, prefix=""):
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in mirrored_from_jax(variables, module, prefix).items()}
    module.load_state_dict(sd, strict=True)


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# -- spectrogram augmentations -------------------------------------------


@pytest.mark.parametrize("lens", [[40, 40, 40], [40, 25, 9], [40, 12, 3]],
                         ids=["equal", "degraded", "pad-row"])
def test_masked_patch_augmentation_matches_jax(lens):
    b, d, t, patch, n = 3, 5, 40, 4, 5
    spec = np.random.RandomState(0).randn(b, d, t).astype(np.float32) + 3.0
    key = jax.random.PRNGKey(7)
    want = jsa.masked_patch_augmentation(key, jnp.asarray(spec), jnp.asarray(lens), patch, n)
    scores = jax.random.uniform(key, (b, t // patch))
    got = psa.masked_patch_augmentation(torch.from_numpy(spec), torch.tensor(lens), patch, n,
                                        scores=torch.from_numpy(np.array(scores)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the generator path masks as many patches a row
    drawn = psa.masked_patch_augmentation(torch.from_numpy(spec), torch.tensor(lens), patch, n,
                                          generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal((drawn.numpy() == 0).sum(axis=(1, 2)),
                                  (np.asarray(want) == 0).sum(axis=(1, 2)))


@pytest.mark.parametrize("t,length", [(30, 20), (20, 30), (21, 30)], ids=["crop", "pad", "pad-odd"])
def test_crop_or_pad_matches_jax(t, length):
    b, d = 3, 4
    spec = np.random.RandomState(1).randn(b, d, t).astype(np.float32)
    lens = np.array([t, t - 3, 5], np.int32)
    key = jax.random.PRNGKey(3)
    want, want_lens = jsa.crop_or_pad_spectrogram(key, jnp.asarray(spec), jnp.asarray(lens),
                                                  length)
    offsets = (torch.from_numpy(np.asarray(jax.random.randint(key, (b,), 0, t - length + 1)))
               if t > length else None)
    got, got_lens = psa.crop_or_pad_spectrogram(torch.from_numpy(spec), torch.from_numpy(lens),
                                                length, offsets=offsets)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))


# -- models/ssl.py ----------------------------------------------------------


@pytest.mark.parametrize("t", [7, 10], ids=["odd-T", "even-T"])
def test_reconstruction_decoder_matches_jax(t):
    jcfg = jssl.ReconstructionDecoderConfig(feat_in=12, feat_out=6, feat_hidden=8,
                                            stride_layers=2, non_stride_layers=1, kernel_size=5,
                                            dtype=jnp.float32)
    pcfg = pssl.ReconstructionDecoderConfig(feat_in=12, feat_out=6, feat_hidden=8,
                                            stride_layers=2, non_stride_layers=1, kernel_size=5,
                                            dtype=torch.float32)
    x = np.random.RandomState(2).randn(2, t, 12).astype(np.float32)
    jdec = jssl.ReconstructionDecoder(jcfg)
    variables = _np_tree(jax.jit(lambda: jdec.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                   train=False))())

    def train_then_infer(v):  # one compiled program: a training forward, then inference
        out, upd = jdec.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        return out, upd, jdec.apply({"params": v["params"], **upd}, jnp.asarray(x), train=False)

    want, upd, want_eval = jax.jit(train_then_infer)(variables)
    pdec = pssl.ReconstructionDecoder(pcfg)
    _load(pdec, variables)
    got = pdec.train()(torch.from_numpy(x))
    assert got.shape == (2, 4 * t, 6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    for i in range(2):  # the running statistics after one training forward
        np.testing.assert_allclose(getattr(pdec, f"up{i}_bn").running_var.numpy(),
                                   np.asarray(upd["batch_stats"][f"up{i}_bn"]["var"]), atol=ATOL)
    pdec.eval()  # inference with the updated statistics
    np.testing.assert_allclose(pdec(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want_eval), atol=ATOL)


def test_gumbel_quantizer_matches_jax():
    jcfg = jssl.GumbelVQConfig(dim=12, num_vars=10, groups=2, vq_dim=8)
    pcfg = pssl.GumbelVQConfig(dim=12, num_vars=10, groups=2, vq_dim=8)
    x = np.random.RandomState(3).randn(2, 6, 12).astype(np.float32)
    jvq = jssl.GumbelVectorQuantizer(jcfg)
    variables = _np_tree(jax.jit(lambda: jvq.init(jax.random.PRNGKey(0), jnp.asarray(x), 2.0,
                                                  train=False))())
    pvq = pssl.GumbelVectorQuantizer(pcfg)
    _load(pvq, variables)
    key = jax.random.PRNGKey(5)
    temp = float(jssl.gumbel_temperature(jcfg, jnp.int32(1000)))  # a traced step, as in fit
    assert pssl.gumbel_temperature(pcfg, 1000) == pytest.approx(temp, rel=1e-6)
    assert pssl.gumbel_temperature(pcfg, 10 ** 7) == 0.5
    (jq, jppl), (jq_eval, _) = jax.jit(lambda v: (
        jvq.apply(v, jnp.asarray(x), temp, train=True, rng=key),
        jvq.apply(v, jnp.asarray(x), temp, train=False)))(variables)
    noise = torch.from_numpy(np.asarray(jax.random.gumbel(key, (2, 6, 2, 10))))
    pq, pppl = pvq(torch.from_numpy(x), temp, train=True, noise=noise)
    np.testing.assert_allclose(pq.detach().numpy(), np.asarray(jq), atol=ATOL)
    assert float(pppl.detach()) == pytest.approx(float(jppl), rel=RTOL)
    pq, _ = pvq(torch.from_numpy(x), temp, train=False)
    np.testing.assert_allclose(pq.detach().numpy(), np.asarray(jq_eval), atol=ATOL)


@pytest.mark.parametrize("mode", ["layer_norm", "group_norm"])
def test_conv_feature_encoder_matches_jax(mode):
    layers = ((8, 10, 5), (8, 3, 2))
    jcfg = jssl.ConvFeatureEncoderConfig(conv_layers=layers, extractor_mode=mode,
                                         dtype=jnp.float32)
    pcfg = pssl.ConvFeatureEncoderConfig(conv_layers=layers, extractor_mode=mode,
                                         dtype=torch.float32)
    wav = np.random.RandomState(4).randn(2, 500).astype(np.float32)
    lens = np.array([500, 300], np.int32)
    jenc = jssl.ConvFeatureEncoder(jcfg)
    variables = _np_tree(jax.jit(lambda: jenc.init(jax.random.PRNGKey(1), jnp.asarray(wav),
                                                   jnp.asarray(lens)))())
    want, want_lens = jax.jit(lambda v: jenc.apply(v, jnp.asarray(wav),
                                                   jnp.asarray(lens)))(variables)
    penc = pssl.ConvFeatureEncoder(pcfg)
    _load(penc, variables)
    got, got_lens = penc(torch.from_numpy(wav), torch.from_numpy(lens))
    assert got.shape == (2, 8, 49)  # (500 - 10) // 5 + 1 = 99, (99 - 3) // 2 + 1 = 49
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))


# -- the contrastive loss ---------------------------------------------------


def _loss_inputs(b=2, d=6, t=24, masked_rows=((0, 20), (4, 16))):
    rs = np.random.RandomState(5)
    spec = rs.randn(b, d, t).astype(np.float32)
    masks = np.zeros((b, d, t), np.float32)
    for r, (lo, hi) in enumerate(masked_rows):
        masks[r, :, lo:hi] = 1.0
    spec[1, :, 0:4] = spec[1, :, 4:8]  # a negative equal to its positive
    return spec, masks


@pytest.mark.parametrize("quantized,negatives", [(False, 3), (True, 3), (False, 9)],
                         ids=["projected", "quantised", "wrapped"])
def test_contrastive_loss_and_grads_match_jax(quantized, negatives):
    spec, masks = _loss_inputs()
    b, d, t = spec.shape
    k, proj = 2, 8
    kw = dict(in_dim=d, proj_dim=proj, combine_time_steps=k, num_negatives=negatives,
              quantized_targets=quantized, codebook_size=10, num_groups=2)
    jloss = jcl.ContrastiveLoss(jcl.ContrastiveLossConfig(**kw))
    tp = t // k
    out = np.random.RandomState(6).randn(b, tp, proj).astype(np.float32)
    key = jax.random.PRNGKey(11)
    variables = _np_tree(jax.jit(lambda: jloss.init(
        jax.random.PRNGKey(0), jnp.asarray(spec), jnp.asarray(masks), jnp.asarray(out),
        step=3, rng=key))())

    def jfn(params, dec):
        return jloss.apply({"params": params}, jnp.asarray(spec), jnp.asarray(masks), dec,
                           step=3, rng=key, train=True)

    want, (gp, gd) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(variables["params"],
                                                                       jnp.asarray(out))
    q_rng, neg_rng = jax.random.split(key)
    noise = {"neg": torch.from_numpy(np.asarray(jax.random.gumbel(neg_rng, (b, tp, tp))))}
    if quantized:
        noise["q"] = torch.from_numpy(np.asarray(jax.random.gumbel(q_rng, (b, tp, 2, 10))))
    ploss = pcl.ContrastiveLoss(pcl.ContrastiveLossConfig(**kw))
    _load(ploss, {"params": variables["params"], "batch_stats": {}})
    dec = torch.from_numpy(out).requires_grad_(True)
    got = ploss(torch.from_numpy(spec), torch.from_numpy(masks), dec, step=3, noise=noise)
    got.backward()
    assert float(got) == pytest.approx(float(want), rel=RTOL)
    assert _max_rel(dec.grad.numpy(), gd) < GRAD_REL
    grads = mirrored_from_jax({"params": _np_tree(gp), "batch_stats": {}}, ploss)
    for name, p in ploss.named_parameters():
        assert _max_rel(p.grad.numpy(), grads[name]) < GRAD_REL, name


# -- the SSL step and the archives -------------------------------------------


def _configs(quantized):
    jenc = JaxEncCfg(**ENC, conv_norm_type="batch_norm", dtype=jnp.float32)
    penc = ConformerEncoderConfig(**ENC, conv_norm_type="batch_norm", dtype=torch.float32)
    loss = dict(in_dim=16, proj_dim=8, combine_time_steps=4, num_negatives=4,
                quantized_targets=quantized, codebook_size=12)
    return (jenc, jcl.ContrastiveLossConfig(**loss)), (penc, pcl.ContrastiveLossConfig(**loss))


@pytest.fixture(scope="module")
def jax_ssl():
    """A quantised-target model in both packages (the projected head is
    held against JAX in the loss's own test)."""
    (jenc, jloss), (penc, ploss) = _configs(True)
    jm = JaxSSLModel(encoder=jenc, mel=JaxMel(features=16), loss=jloss, patch_size=4,
                     mask_patches=3)
    spec = jnp.zeros((1, 16, 64), jnp.float32)
    variables = jax.jit(lambda: jm.net.init(jax.random.PRNGKey(0), spec, spec, spec,
                                            jnp.full((1,), 64, jnp.int32), step=0,
                                            rng=jax.random.PRNGKey(0), train=False))()
    opt = optax.adamw(1e-3)
    jm.state = JaxTrainState.create(variables["params"], variables["batch_stats"],
                                    opt.init(variables["params"]), jax.random.PRNGKey(1))
    pm = SpeechSSLModel(encoder=penc, mel=MelFeatureConfig(features=16), loss=ploss,
                        patch_size=4, mask_patches=3, device="cpu")
    return jm, pm


def test_ssl_step_matches_jax(jax_ssl):
    jm, pm = jax_ssl
    variables = _np_tree({"params": jm.state.params, "batch_stats": jm.state.batch_stats})
    pm.model.load_state_dict(ssl_state_dict_from_jax(variables, pm.enc_cfg, pm.dec_cfg,
                                                     pm.loss_cfg))
    b, d, t = 2, 16, 64
    spec = np.random.RandomState(8).randn(b, d, t).astype(np.float32)
    lens = np.array([64, 52], np.int32)
    spec[1, :, 52:] = 0.0
    key = jax.random.PRNGKey(4)
    jmasked = jsa.masked_patch_augmentation(key, jnp.asarray(spec), jnp.asarray(lens), 4, 3)
    scores = torch.from_numpy(np.asarray(jax.random.uniform(key, (b, t // 4))))
    masked, spec_masks = mask_inputs(torch.from_numpy(spec), torch.from_numpy(lens), 4, 3,
                                     scores=scores)
    np.testing.assert_array_equal(masked.numpy(), np.asarray(jmasked))
    in_len = (np.arange(t)[None, :] < lens[:, None])[:, None, :]
    np.testing.assert_array_equal(spec_masks.numpy(),
                                  ((np.abs(np.asarray(jmasked)) < 1e-5) & in_len)
                                  .astype(np.float32))
    loss_key = jax.random.PRNGKey(9)

    def jfn(params):
        (loss, _), upd = jm.net.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(spec),
            jnp.asarray(spec_masks.numpy()), jmasked, jnp.asarray(lens), step=5, rng=loss_key,
            train=True, mutable=["batch_stats"])
        return loss, upd

    (want, upd), grads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(variables["params"])
    q_rng, neg_rng = jax.random.split(loss_key)
    tp = t // 4
    noise = {"neg": torch.from_numpy(np.asarray(jax.random.gumbel(neg_rng, (b, tp, tp))))}
    if pm.loss_cfg.quantized_targets:
        noise["q"] = torch.from_numpy(np.asarray(jax.random.gumbel(q_rng, (b, tp, 2, 12))))
    got = pm.loss(torch.from_numpy(spec), torch.from_numpy(lens), masked, spec_masks, step=5,
                  noise=noise)
    got.backward()
    pm.model.eval()
    assert float(got) == pytest.approx(float(want), rel=RTOL)
    pgrads = ssl_variables_to_jax(
        {**pm.model.state_dict(), **{n: p.grad for n, p in pm.model.named_parameters()}},
        pm.enc_cfg, pm.dec_cfg, pm.loss_cfg)["params"]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(_np_tree(grads))[0])
    flat_p = dict(jax.tree_util.tree_flatten_with_path(pgrads)[0])
    assert flat_j.keys() == flat_p.keys()
    for path, g in flat_j.items():
        err = np.abs(flat_p[path] - g).max()
        if any(z in jax.tree_util.keystr(path) for z in ZERO_GRAD):
            assert err <= ZERO_ATOL, path
        else:
            assert err <= GRAD_REL * np.abs(g).max(), path
    # the encoder's BatchNorm statistics after the training forward
    var = pm.model.encoder.layers[0].conv.batch_norm.running_var.numpy()
    np.testing.assert_allclose(var, np.asarray(upd["batch_stats"]["encoder"]["layers_0"]["conv"]
                                               ["norm"]["var"]), atol=ATOL)


def test_ssl_archives_cross_both_ways(jax_ssl, tmp_path):
    jm, pm = jax_ssl
    jpath, ppath = str(tmp_path / "jax.cntpu"), str(tmp_path / "port.cntpu")
    jm.save_portable(jpath)
    pm.restore_weights(jpath)
    want = _np_tree({"params": jm.state.params, "batch_stats": jm.state.batch_stats})
    got = pm.portable_variables
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert {p for p, _ in flat_w} == set(flat_g)
    for path, leaf in flat_w:
        np.testing.assert_array_equal(flat_g[path], leaf)
    with torch.no_grad():  # move the port's weights, then back to the JAX package
        for p in pm.model.parameters():
            p.add_(0.25)
    pm.save_portable(ppath)
    jm2 = JaxSSLModel(encoder=jm.enc_cfg, mel=jm.mel, loss=jm.loss_cfg, patch_size=4,
                      mask_patches=3)
    jm2.state = jm.state  # the template restore_weights fills
    jm2.restore_weights(ppath)
    back = dict(jax.tree_util.tree_flatten_with_path(
        _np_tree({"params": jm2.state.params, "batch_stats": jm2.state.batch_stats}))[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(pm.portable_variables)[0]:
        np.testing.assert_array_equal(back[path], leaf)


def _manifest(tmp_path, n=4):
    rs = np.random.RandomState(0)
    rows = []
    for i in range(n):
        dur = 0.5 + 0.1 * i
        tt = np.arange(int(dur * 16000)) / 16000
        sig = (0.3 * np.sin(2 * np.pi * (200 + 50 * i) * tt)
               + 0.02 * rs.randn(len(tt))).astype(np.float32)
        path = str(tmp_path / f"u{i}.wav")
        write_wav(path, sig, 16000)
        rows.append({"audio_filepath": path, "duration": dur, "text": ""})
    manifest = str(tmp_path / "m.json")
    with open(manifest, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return manifest


def test_ssl_fit_restore_and_transfer(tmp_path):
    from conformer_nemo_tpu_torch.api import ConformerCTC
    from conformer_nemo_tpu_torch.data.tokenizers import CharTokenizer

    manifest = _manifest(tmp_path)
    enc = ConformerEncoderConfig(**{**ENC, "feat_in": 32}, conv_norm_type="layer_norm",
                                 dtype=torch.float32)
    loss = pcl.ContrastiveLossConfig(in_dim=32, proj_dim=16, num_negatives=4, reduce="mean")
    model = SpeechSSLModel(encoder=enc, mel=MelFeatureConfig(features=32), loss=loss,
                           patch_size=4, mask_patches=4, device="cpu")
    out = model.fit(manifest, max_steps=3, batch_size=4, lr=2e-3, log_every_n_steps=1)
    assert out["steps"] == 3 and all(np.isfinite(h["loss"]) for h in out["history"])
    path = str(tmp_path / "ssl.cntpu")
    model.save_portable(path)
    model2 = SpeechSSLModel(encoder=enc, mel=MelFeatureConfig(features=32), loss=loss,
                            patch_size=4, mask_patches=4, device="cpu", seed=3)
    model2.restore_weights(path)
    for (n, a), b in zip(model.model.state_dict().items(), model2.model.state_dict().values()):
        assert torch.equal(a, b), n
    cfg = {"model": {"sample_rate": 16000, "labels": [" ", "a", "b"],
                     "preprocessor": {"features": 32},
                     "encoder": {**{k: v for k, v in ENC.items()}, "feat_in": 32,
                                 "conv_norm_type": "layer_norm"},
                     "train_ds": {"manifest_filepath": manifest, "batch_size": 2},
                     "optim": {"name": "adamw", "lr": 0.1,
                               "sched": {"name": "NoamAnnealing", "d_model": 32,
                                         "warmup_steps": 10}}},
           "trainer": {"max_epochs": 1}}
    asr = ConformerCTC(cfg, CharTokenizer([" ", "a", "b"]), dtype=torch.float32, device="cpu")
    model.transfer_encoder_to(asr)
    for (n, a), b in zip(model.model.encoder.state_dict().items(),
                         asr.model.encoder.state_dict().values()):
        assert torch.equal(a, b), n
    assert np.isfinite(asr.fit(manifest, max_steps=1)["last_loss"])
    wide = ConformerCTC({**cfg, "model": {**cfg["model"], "encoder": {
        **cfg["model"]["encoder"], "d_model": 64}}}, CharTokenizer([" ", "a", "b"]),
        dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="encoder configs differ"):
        model.transfer_encoder_to(wide)
