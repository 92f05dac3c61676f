"""The port's RNN-T beam searches against the JAX package's, on the same
fp32 weights (bridged by `rnnt_state_dict_from_jax`, seeded as
tests/test_torch_rnnt_greedy.py) and the same encoder output (seeded
numpy), with ragged lengths and a zero-length row:

- `BeamRNNTInfer` default / tsd / alsd / maes: the n-best lists
  (return_best_hypothesis false) have the same label sequences in the same
  order and scores within 1e-4, with and without score_norm; so the best
  hypothesis is the same;
- `rnnt_beam_batched_decode` (beam_batch): the best tokens and lengths are
  equal (the JAX function returns no score; its dead slots tie at -1e30,
  which `torch.topk` orders otherwise, so only the best is compared);
- the `RNNTDecoding` facade with the JAX facade's defaults, every strategy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.decode.rnnt_beam import BeamRNNTInfer as JaxBeam
from conformer_nemo_tpu.decode.rnnt_beam_batched import rnnt_beam_batched_decode as jax_batched
from conformer_nemo_tpu.decode.rnnt_decoding import RNNTDecoding as JaxDecoding
from conformer_nemo_tpu.models import rnnt as jax_rnnt
from conformer_nemo_tpu.models.conformer import ConformerEncoderConfig as JaxEncoderConfig
from conformer_nemo_tpu_torch.convert.jax_params import rnnt_state_dict_from_jax
from conformer_nemo_tpu_torch.decode.rnnt_beam import BeamRNNTInfer
from conformer_nemo_tpu_torch.decode.rnnt_beam_batched import rnnt_beam_batched_decode
from conformer_nemo_tpu_torch.decode.rnnt_decoding import RNNTDecoding
from conformer_nemo_tpu_torch.models import rnnt as port
from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig

torch.set_num_threads(2)

V = 9
ENC = dict(feat_in=16, n_layers=1, d_model=24, n_heads=2, ff_expansion_factor=2,
           subsampling_factor=2, conv_kernel_size=7, conv_norm_type="layer_norm")
SCORE_ATOL = 1e-4


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
    # biases of +0.3 on blank and +2 on label 2: every search's best emits labels
    params["joint"]["out_bias"] = np.array(params["joint"]["out_bias"])
    params["joint"]["out_bias"][V] = 0.3
    params["joint"]["out_bias"][2] = 2.0
    pm = port.RNNTModel(pcfg).eval()
    pm.load_state_dict(rnnt_state_dict_from_jax({"params": params}, pcfg))
    enc = (np.random.RandomState(2).randn(3, 11, 24) * 2.0).astype(np.float32)
    lens = np.array([11, 6, 0], np.int32)
    return jm, {"params": params}, pm, enc, lens


KNOBS = dict(beam_size=3, tsd_max_sym_exp=3, alsd_max_target_len=0.5)


@pytest.mark.parametrize("score_norm", [True, False])
@pytest.mark.parametrize("search", ["default", "tsd", "alsd", "maes"])
def test_nbest_equal_jax(models, search, score_norm):
    jm, variables, pm, enc, lens = models
    want = JaxBeam(jm, variables, search_type=search, score_norm=score_norm,
                   return_best_hypothesis=False, **KNOBS)(enc, lens)
    got = BeamRNNTInfer(pm, search_type=search, score_norm=score_norm,
                        return_best_hypothesis=False, **KNOBS)(torch.from_numpy(enc), lens)
    assert len(got) == len(want) == 3
    for g_list, w_list in zip(got, want):
        assert [h.y_sequence for h in g_list] == [h.y_sequence for h in w_list]
        assert [h.timestep for h in g_list] == [h.timestep for h in w_list]
        np.testing.assert_allclose([h.score for h in g_list], [h.score for h in w_list],
                                   rtol=0, atol=SCORE_ATOL)
    assert got[0][0].y_sequence and not got[2][0].y_sequence
    best = BeamRNNTInfer(pm, search_type=search, score_norm=score_norm,
                         **KNOBS)(torch.from_numpy(enc), lens)
    assert [b.y_sequence for b in best] == [n[0].y_sequence for n in got]


@pytest.mark.parametrize("score_norm", [True, False])
@pytest.mark.parametrize("beam_size,max_sym_exp", [(3, 3), (4, 2)])
def test_beam_batch_best_equal_jax(models, beam_size, max_sym_exp, score_norm):
    jm, variables, pm, enc, lens = models
    kw = dict(beam_size=beam_size, max_sym_exp=max_sym_exp, score_norm=score_norm)
    w_tok, w_len = jax_batched(jm, variables, jnp.asarray(enc), jnp.asarray(lens), **kw)
    tok, tl, score = rnnt_beam_batched_decode(pm, torch.from_numpy(enc), torch.from_numpy(lens),
                                              **kw)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(w_len))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(w_tok))
    assert tl[0] > 0 and tl[2] == 0 and torch.isfinite(score).all()


@pytest.mark.parametrize("strategy", ["greedy", "greedy_batch", "beam", "tsd", "alsd", "maes",
                                      "beam_batch"])
def test_facade_equal_jax(models, strategy):
    jm, variables, pm, enc, lens = models

    class Tok:
        def ids_to_text(self, ids):
            return " ".join(map(str, ids))

    cfg = {"strategy": strategy, "greedy": {"max_symbols": 3},
           "beam": {"tsd_max_sym_exp": 3, "alsd_max_target_len": 0.5,
                    "return_best_hypothesis": False}}
    want = JaxDecoding(jm, variables, Tok(), cfg).decode(enc, lens)
    dec = RNNTDecoding(pm, Tok(), cfg)
    assert dec.decode(torch.from_numpy(enc), torch.from_numpy(lens)) == want
    assert dec.decode_to_text(torch.from_numpy(enc), torch.from_numpy(lens)) == [
        " ".join(map(str, ids)) for ids in want]
