"""The port's convolutional encoder (models/conv_asr.py) against the JAX
package's, on the CPU.

Every block kind runs on the same features and weights (bridged by
`label_state_dict_from_jax`) in both packages, in inference and in training
mode (batch statistics, the running statistics after the forward): the
separable, strided, residual and 1x1 blocks, squeeze-excite with global and
limited context, stride_last, kernel_size_factor, the max and stride_add
residuals, Jasper-DR panes, grouped and dilated convolutions, and the
ParallelBlock with its sum and conv residuals. The random draws cannot match
streams, so the port's are injected: the SE context start and the tower
dropout weights are set to each value they can take, and the JAX training
output must equal the port's at one of them; the port's own draws are
checked for range and rate.

Tolerance: 1e-5 absolute on outputs of unit scale (both fp32; convolution
summation orders differ; measured ~1e-6). Lengths and parameter trees
exactly.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.models import conv_asr as jca
from conformer_nemo_tpu_torch.convert.jax_params import (
    _mirror_leaves,
    label_state_dict_from_jax,
    label_variables_to_jax,
)
from conformer_nemo_tpu_torch.models import conv_asr as pca

torch.set_num_threads(2)

ATOL = 1e-5

B = pca.JasperBlockConfig
CASES = {
    "small": (16, [dict(filters=16, repeat=1, kernel=11, stride=2, residual=False,
                        separable=True),
                   dict(filters=16, repeat=2, kernel=11, residual=True, separable=True),
                   dict(filters=24, repeat=1, kernel=1, residual=False)]),
    "se": (8, [dict(filters=8, repeat=1, kernel=5, residual=True, se=True)]),
    "stride_last": (8, [dict(filters=8, repeat=2, kernel=5, stride=2, residual=False,
                             stride_last=True)]),
    "kernel_factor": (8, [dict(filters=8, repeat=1, kernel=11, residual=False,
                               kernel_size_factor=0.5)]),
    "max": (8, [dict(filters=8, repeat=1, kernel=5, residual=True, residual_mode="max")]),
    "stride_add": (8, [dict(filters=8, repeat=2, kernel=5, stride=2, residual=True,
                            residual_mode="stride_add")]),
    "dense": (8, [dict(filters=8, repeat=1, kernel=5, residual=True, residual_dense=True)] * 3),
    "grouped_dilated": (8, [dict(filters=8, repeat=1, kernel=5, dilation=2, groups=2,
                                 residual=True)]),
    "parallel_conv": (8, [dict(filters=8, repeat=1, kernel=(5, 9, 13), residual=True,
                               separable=True, parallel_residual_mode="conv")]),
    "parallel_sum": (8, [dict(filters=8, repeat=1, kernel=(3, 7), residual=True)]),
}


def _cfgs(case, **extra):
    feat_in, blocks = CASES[case]
    jb = tuple(jca.JasperBlockConfig(**{**b, **extra}) for b in blocks)
    pb = tuple(pca.JasperBlockConfig(**{**b, **extra}) for b in blocks)
    return (jca.ConvASREncoderConfig(feat_in=feat_in, blocks=jb, dtype=jnp.float32),
            pca.ConvASREncoderConfig(feat_in=feat_in, blocks=pb, dtype=torch.float32))


def _inputs(feat_in, t=32, seed=0):
    rs = np.random.RandomState(seed)
    feats = rs.randn(2, feat_in, t).astype(np.float32)
    return feats, np.array([t, t - 9], np.int32)


def _pair(case, **extra):
    jcfg, pcfg = _cfgs(case, **extra)
    feats, lens = _inputs(jcfg.feat_in)
    jenc = jca.ConvASREncoder(jcfg)
    variables = jax.jit(lambda: jenc.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                                          jnp.asarray(lens), train=False))()
    variables = jax.tree.map(lambda x: np.asarray(x, np.float32), variables)
    penc = pca.ConvASREncoder(pcfg)
    penc.load_state_dict(label_state_dict_from_jax(variables, penc))
    return jenc, variables, penc, feats, lens


def _jax_train(jenc, variables, feats, lens, key):
    return jax.jit(lambda v: jenc.apply(v, jnp.asarray(feats), jnp.asarray(lens), train=True,
                                        rngs={"dropout": key}, mutable=["batch_stats"]))(
        variables)


@pytest.mark.parametrize("case", sorted(CASES))
def test_encoder_matches_jax(case):
    jenc, variables, penc, feats, lens = _pair(case)
    want, want_lens = jax.jit(lambda v: jenc.apply(v, jnp.asarray(feats), jnp.asarray(lens),
                                                   train=False))(variables)
    got, got_lens = penc.eval()(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    (want, _), upd = _jax_train(jenc, variables, feats, lens, jax.random.PRNGKey(1))
    got, _ = penc.train()(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    stats = label_variables_to_jax(penc.state_dict(), penc)["batch_stats"]
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(stats)[0],
                                 jax.tree_util.tree_flatten_with_path(upd["batch_stats"])[0]):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, err_msg=str(path))


def test_masking_isolates_padding():
    _, _, penc, feats, lens = _pair("small")
    penc.eval()
    out, out_len = penc(torch.from_numpy(feats), torch.from_numpy(lens))
    feats2 = feats.copy()
    feats2[1, :, lens[1]:] = 99.0
    out2, _ = penc(torch.from_numpy(feats2), torch.from_numpy(lens))
    valid = int(out_len[1])
    np.testing.assert_allclose(out[1, :, : valid - 8].detach().numpy(),
                               out2[1, :, : valid - 8].detach().numpy(), atol=1e-4)


@pytest.mark.parametrize("k,s,d", [(33, 2, 1), (11, 1, 1), (29, 1, 2), (1, 2, 1), (4, 3, 2)])
def test_conv_out_length_matches_jax(k, s, d):
    lens = np.array([0, 1, 37, 100, 101], np.int32)
    np.testing.assert_array_equal(pca.conv_out_length(torch.from_numpy(lens), k, s, d).numpy(),
                                  np.asarray(jca.conv_out_length(jnp.asarray(lens), k, s, d)))


def test_quartznet_15x5_tree_matches_jax():
    jcfg = jca.ConvASREncoderConfig(feat_in=64, blocks=tuple(jca.quartznet_15x5_blocks()),
                                    dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jca.ConvASREncoder(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 128)), jnp.array([128]), train=False))
    pcfg = pca.ConvASREncoderConfig(feat_in=64, blocks=tuple(pca.quartznet_15x5_blocks()),
                                    dtype=torch.float32)
    with torch.device("meta"):
        penc = pca.ConvASREncoder(pcfg)
    sd = penc.state_dict()
    want = {(coll,) + tuple(k.key for k in path): tuple(leaf.shape)
            for coll in ("params", "batch_stats")
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes[coll])[0]}
    got = {(coll,) + path: tuple(fn(np.zeros(sd[key].shape)).shape)
           for key, (coll, path, fn) in _mirror_leaves(penc).items()}
    assert got == want
    n = sum(p.numel() for p in penc.parameters())
    assert 15e6 < n < 22e6, n / 1e6


def test_se_context_window_start_and_swap(monkeypatch):
    """Inference pools the first window; training pools from a random start,
    and the JAX training output is the port's at one injected start."""
    jb = [jca.JasperBlockConfig(filters=8, repeat=1, kernel=5, residual=False, se=True)]
    pb = [pca.JasperBlockConfig(filters=8, repeat=1, kernel=5, residual=False, se=True)]
    pb_cw = pca.change_se_context_window(pb, 8)
    assert pb_cw[0].se_context_window == 8
    mixed = pca.change_se_context_window([B(se=False), B(se=True)], 16)
    assert mixed[0].se_context_window == -1 and mixed[1].se_context_window == 16
    jenc = jca.ConvASREncoder(jca.ConvASREncoderConfig(
        feat_in=8, blocks=tuple(jca.change_se_context_window(jb, 8)), dtype=jnp.float32))
    penc = pca.ConvASREncoder(pca.ConvASREncoderConfig(feat_in=8, blocks=tuple(pb_cw),
                                                       dtype=torch.float32))
    rs = np.random.RandomState(0)
    feats = (rs.rand(1, 8, 24) + np.arange(24)[None, None, :]).astype(np.float32)
    lens = np.array([24], np.int32)
    variables = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                                                   jnp.asarray(lens), train=False))
    penc.load_state_dict(label_state_dict_from_jax(variables, penc))
    want, _ = jenc.apply(variables, jnp.asarray(feats), jnp.asarray(lens), train=False)
    got, _ = penc.eval()(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    (want, _), _ = _jax_train(jenc, variables, feats, lens, jax.random.PRNGKey(4))
    outs = []
    for start in range(24 - 8):
        monkeypatch.setattr(pca, "_se_start", lambda gen, high, dev, s=start: s)
        penc.load_state_dict(label_state_dict_from_jax(variables, penc))
        outs.append(penc.train()(torch.from_numpy(feats), torch.from_numpy(lens))[0])
    errs = [float(np.abs(o.detach().numpy() - np.asarray(want)).max()) for o in outs]
    assert min(errs) <= ATOL, errs
    monkeypatch.undo()
    gen = torch.Generator().manual_seed(0)
    starts = [pca._se_start(gen, 16, "cpu") for _ in range(400)]
    assert set(starts) == set(range(16))


def test_tower_dropout_weights(monkeypatch):
    """The JAX tower-dropout output is the port's at one of the keep
    patterns; the port redraws until a tower survives, at rate 1 - p."""
    jenc, variables, penc, feats, lens = _pair("parallel_sum", aggregation_mode="dropout",
                                               block_dropout=0.5)
    (want, _), _ = _jax_train(jenc, variables, feats, lens, jax.random.PRNGKey(7))
    errs = []
    for keep in itertools.product([0.0, 2.0], repeat=2):
        if not any(keep):
            continue
        monkeypatch.setattr(pca, "_tower_weights", lambda g, n, p, d, k=keep: torch.tensor(k))
        penc.load_state_dict(label_state_dict_from_jax(variables, penc))
        got, _ = penc.train()(torch.from_numpy(feats), torch.from_numpy(lens))
        errs.append(float(np.abs(got.detach().numpy() - np.asarray(want)).max()))
    assert min(errs) <= ATOL, errs
    monkeypatch.undo()
    gen = torch.Generator().manual_seed(1)
    draws = torch.stack([pca._tower_weights(gen, 2, 0.5, "cpu") for _ in range(2000)])
    assert bool((draws.sum(1) > 0).all()) and set(draws.unique().tolist()) == {0.0, 2.0}
    # P(a tower kept | not both dropped) = 0.5 / 0.75
    assert abs(float((draws > 0).float().mean()) - 2 / 3) < 0.03


def test_block_dropout_rate():
    feat_in = 8
    cfg = pca.ConvASREncoderConfig(feat_in=feat_in, blocks=(
        pca.JasperBlockConfig(filters=64, repeat=1, kernel=1, residual=False, dropout=0.3),),
        dtype=torch.float32)
    enc = pca.ConvASREncoder(cfg).train()
    feats, lens = _inputs(feat_in, t=256)
    with pytest.raises(ValueError, match="generator"):
        enc(torch.from_numpy(feats), torch.from_numpy(lens))
    out, _ = enc(torch.from_numpy(feats), torch.from_numpy(lens), torch.Generator().manual_seed(0))
    relu_pos = out[:, :, :200] != 0
    enc.eval()
    ref, _ = enc(torch.from_numpy(feats), torch.from_numpy(lens))
    kept = float(relu_pos.sum()) / float((ref[:, :, :200] > 0).sum())
    assert abs(kept - 0.7) < 0.03


def test_configs_are_the_jax_packages():
    assert ([f.name for f in dataclasses.fields(pca.JasperBlockConfig)]
            == [f.name for f in dataclasses.fields(jca.JasperBlockConfig)])
    assert [dataclasses.asdict(b) for b in pca.quartznet_15x5_blocks()] == [
        dataclasses.asdict(b) for b in jca.quartznet_15x5_blocks()]
    for k, f in [(11, 1.0), (11, 0.5), (12, 0.5), (3, 0.1)]:
        assert pca.compute_new_kernel_size(k, f) == jca.compute_new_kernel_size(k, f)
