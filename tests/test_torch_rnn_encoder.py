"""The port's RNN encoder and LSTM head (models/rnn_encoder.py) against the
JAX package's, on the CPU, on the JAX modules' initial weights crossed by
convert/jax_params.py (`rnn_encoder_state_dict_from_jax`,
`lstm_decoder_state_dict_from_jax`; both bridges exact both ways).

Front ends: striding (conv), stacking, and factor 1 (a linear layer);
bidirectional and forward-only; the LSTM head on the encoder's output,
forward-only and bidirectional with two layers. Dropout off (eval mode).
Tolerances: fp32 outputs within 1e-5 of the JAX output's largest magnitude
(measured ~1e-6: the products sum in other orders); bf16 within 2e-2 of it
(the gates' products round to bf16 on both sides, one ulp is 4e-3
relative); lengths equal; the fp32 encoder's parameter gradients of a
fixed projection of its output within 1e-4 of each tensor's largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.models import rnn_encoder as jre
from conformer_nemo_tpu_torch.convert import jax_params as bridge
from conformer_nemo_tpu_torch.models import rnn_encoder as pre

torch.set_num_threads(2)

FP32_REL = 1e-5
BF16_REL = 2e-2
GRAD_REL = 1e-4
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
ENC_CASES = {
    "striding_bi": dict(subsampling="striding", subsampling_factor=4, bidirectional=True),
    "striding_uni": dict(subsampling="striding", subsampling_factor=4, bidirectional=False),
    "stacking_bi": dict(subsampling="stacking", subsampling_factor=4, bidirectional=True),
    "factor1_uni": dict(subsampling="striding", subsampling_factor=1, bidirectional=False),
}
BASE = dict(feat_in=16, n_layers=2, d_model=12, proj_size=10, subsampling_conv_channels=6,
            dropout=0.0)


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(3, 16, 37).astype(np.float32), np.array([37, 30, 21], np.int32)


def _jax_encoder(case, jdt):
    cfg = jre.RNNEncoderConfig(dtype=jdt, **BASE, **ENC_CASES[case])
    enc = jre.RNNEncoder(cfg)
    feats, lens = _inputs()
    v = jax.jit(lambda: enc.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(lens)))()
    return enc, jax.tree.map(np.asarray, v)


def _port_encoder(case, pdt, variables):
    cfg = pre.RNNEncoderConfig(dtype=pdt, **BASE, **ENC_CASES[case])
    m = pre.RNNEncoder(cfg)
    m.load_state_dict(bridge.rnn_encoder_state_dict_from_jax(variables, cfg))
    return m.eval(), cfg


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(ENC_CASES))
def test_encoder_matches_jax(case, dtype):
    jdt, pdt = DTYPES[dtype]
    enc, v = _jax_encoder(case, jdt)
    feats, lens = _inputs()
    want, want_lens = jax.jit(lambda v, f, l: enc.apply(v, f, l))(v, feats, lens)
    m, cfg = _port_encoder(case, pdt, v)
    with torch.no_grad():
        got, got_lens = m(torch.from_numpy(feats), torch.from_numpy(lens))
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    tol = FP32_REL if dtype == "fp32" else BF16_REL
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()
    back = bridge.rnn_encoder_variables_to_jax(m.state_dict(), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(v)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, v)))


HEAD_CASES = {"uni_1": dict(bidirectional=False, num_layers=1),
              "bi_2": dict(bidirectional=True, num_layers=2)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_lstm_decoder_head_matches_jax(case, dtype):
    jdt, pdt = DTYPES[dtype]
    kw = dict(feat_in=10, num_classes=7, lstm_hidden_size=8, **HEAD_CASES[case])
    head = jre.LSTMDecoder(jre.LSTMDecoderConfig(dtype=jdt, **kw))
    x = np.random.RandomState(3).randn(3, 10, 9).astype(np.float32)
    v = jax.tree.map(np.asarray, jax.jit(lambda: head.init(jax.random.PRNGKey(1),
                                                           jnp.asarray(x)))())
    want = np.asarray(jax.jit(head.apply)(v, x), np.float32)
    cfg = pre.LSTMDecoderConfig(dtype=pdt, **kw)
    m = pre.LSTMDecoder(cfg)
    m.load_state_dict(bridge.lstm_decoder_state_dict_from_jax(v, cfg))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 9, 8)
    tol = FP32_REL if dtype == "fp32" else BF16_REL
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    back = bridge.lstm_decoder_variables_to_jax(m.state_dict(), cfg)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, v)))


def test_encoder_gradients_match_jax():
    enc, v = _jax_encoder("striding_bi", jnp.float32)
    feats, lens = _inputs(1)
    w = np.random.RandomState(2).randn(3, 10, 10).astype(np.float32)

    def loss(params):
        out, _ = enc.apply({**v, "params": params}, feats, lens)
        return jnp.sum(out * w)

    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(v["params"]))
    m, cfg = _port_encoder("striding_bi", torch.float32, v)
    out, _ = m(torch.from_numpy(feats), torch.from_numpy(lens))
    (out * torch.from_numpy(w)).sum().backward()
    got = bridge.rnn_encoder_variables_to_jax(
        {**m.state_dict(), **{n: p.grad for n, p in m.named_parameters()}}, cfg)["params"]
    flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        assert np.abs(flat[path] - g).max() <= GRAD_REL * np.abs(g).max(), path


def test_create_draws_from_the_seed_and_dropout_needs_a_seed():
    cfg = pre.RNNEncoderConfig(dtype=torch.float32, **{**BASE, "dropout": 0.5},
                               **ENC_CASES["striding_bi"])
    a = pre.RNNEncoder.create(cfg, device="cpu", seed=3)
    b = pre.RNNEncoder.create(cfg, device="cpu", seed=3)
    assert not a.training
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    wh = a.lstm0_fwd.wh.detach()  # orthogonal rows: wh wh^T = I (H x 4H)
    assert torch.allclose(wh @ wh.T, torch.eye(12), atol=1e-5)
    feats, lens = (torch.from_numpy(x) for x in _inputs())
    a.train()
    with pytest.raises(ValueError, match="dropout_seed"):
        a(feats, lens)
    y1, _ = a(feats, lens, dropout_seed=7)
    y2, _ = a(feats, lens, dropout_seed=7)
    assert torch.equal(y1, y2)
    assert not torch.equal(y1, a(feats, lens, dropout_seed=8)[0])
    head = pre.LSTMDecoder.create(pre.LSTMDecoderConfig(feat_in=10, dtype=torch.float32),
                                  device="cpu")
    lp = head(a.eval()(feats, lens)[0])
    assert lp.shape == (3, 10, 29)
    assert torch.allclose(lp.exp().sum(-1), torch.ones(3, 10))
