"""The port's batched greedy RNN-T decoder against the JAX package's
`rnnt_greedy_decode_batched`, on the same fp32 weights (bridged by
`rnnt_state_dict_from_jax`) and the same encoder output (seeded numpy):
tokens, lengths and emission frames must be equal, with ragged lengths,
a zero-length row and a token buffer that overflows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.decode.rnnt_greedy import rnnt_greedy_decode_batched as jax_greedy
from conformer_nemo_tpu.models import rnnt as jax_rnnt
from conformer_nemo_tpu.models.conformer import ConformerEncoderConfig as JaxEncoderConfig
from conformer_nemo_tpu_torch.convert.jax_params import rnnt_state_dict_from_jax
from conformer_nemo_tpu_torch.decode.rnnt_decoding import RNNTDecoding
from conformer_nemo_tpu_torch.decode.rnnt_greedy import rnnt_greedy_decode_batched
from conformer_nemo_tpu_torch.models import rnnt as port
from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig

V = 9
ENC = dict(feat_in=16, n_layers=1, d_model=24, n_heads=2, ff_expansion_factor=2,
           subsampling_factor=2, conv_kernel_size=7, conv_norm_type="layer_norm")


@pytest.fixture(scope="module")
def models():
    dec = dict(vocab_size=V, pred_hidden=16, dropout=0.0)
    jcfg = jax_rnnt.RNNTModelConfig(
        encoder=JaxEncoderConfig(dtype=jnp.float32, **ENC),
        decoder=jax_rnnt.RNNTDecoderConfig(dtype=jnp.float32, **dec),
        joint=jax_rnnt.RNNTJointConfig(joint_hidden=16, dtype=jnp.float32))
    pcfg = port.RNNTModelConfig(
        encoder=ConformerEncoderConfig(dtype=torch.float32, **ENC),
        decoder=port.RNNTDecoderConfig(dtype=torch.float32, **dec),
        joint=port.RNNTJointConfig(joint_hidden=16, dtype=torch.float32))
    jm = jax_rnnt.RNNTModel(jcfg)
    rng = np.random.RandomState(0)
    params = jax.device_get(jm.init(
        jax.random.PRNGKey(1), jnp.asarray(rng.randn(1, 16, 12), jnp.float32),
        jnp.asarray([12], jnp.int32), jnp.zeros((1, 3), jnp.int32),
        jnp.asarray([3], jnp.int32))["params"])
    # a blank bias of +1.5 mixes blank and label emissions on random weights
    params["joint"]["out_bias"] = np.array(params["joint"]["out_bias"])
    params["joint"]["out_bias"][V] = 1.5
    pm = port.RNNTModel(pcfg).eval()
    pm.load_state_dict(rnnt_state_dict_from_jax({"params": params}, pcfg))
    return jm, {"params": params}, pm


@pytest.mark.parametrize("max_symbols,max_tokens", [(3, None), (5, 6)])
def test_greedy_tokens_equal_jax(models, max_symbols, max_tokens):
    jm, variables, pm = models
    rng = np.random.RandomState(2)
    enc = (rng.randn(4, 15, 24) * 2.0).astype(np.float32)
    lens = np.array([15, 9, 0, 4], np.int32)
    want = jax_greedy(jm, variables, jnp.asarray(enc), jnp.asarray(lens),
                      max_symbols=max_symbols, max_tokens=max_tokens, return_timestamps=True)
    got = rnnt_greedy_decode_batched(pm, torch.from_numpy(enc), torch.from_numpy(lens),
                                     max_symbols=max_symbols, max_tokens=max_tokens,
                                     return_timestamps=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    n = got[1].numpy()
    assert n[2] == 0 and n[0] > 3  # the zero-length row emits nothing


def test_decoding_facade(models):
    _, _, pm = models

    class Tok:
        def ids_to_text(self, ids):
            return " ".join(map(str, ids))

    enc = torch.from_numpy(np.random.RandomState(3).randn(2, 6, 24).astype(np.float32))
    lens = torch.tensor([6, 3])
    dec = RNNTDecoding(pm, Tok(), {"strategy": "greedy", "greedy": {
        "max_symbols": 2, "preserve_alignments": True}})
    ids = dec.decode(enc, lens)
    assert [len(a) for a in dec.last_alignments] == [len(i) for i in ids]
    assert dec.decode_to_text(enc, lens) == [" ".join(map(str, i)) for i in ids]
    beam = RNNTDecoding(pm, Tok(), {"strategy": "beam"})  # ported: no alignments kept
    assert len(beam.decode(enc, lens)) == 2 and beam.last_alignments is None
    with pytest.raises(ValueError, match="unknown decoding strategy"):
        RNNTDecoding(pm, Tok(), {"strategy": "beamsearch_ngram"})
