"""The JAX package's overfit-model beam tests (tests/test_rnnt_beam.py),
on the port: a tiny transducer overfits two utterances in JAX (150 Adam
steps), its fp32 weights are bridged into the port
(`rnnt_state_dict_from_jax`), and on its encoder output

- every per-sample strategy (default, tsd, alsd, maes) recovers the
  memorised targets, and the default beam's best equals greedy's;
- the n-best list comes back sorted by the normalised score;
- the facade recovers them with greedy_batch, beam, alsd and beam_batch;
- `beam_batch` recovers them, and its best sequence's lattice nll (the
  sum over alignments, under the port's own joint) is at most greedy's +
  1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conformer_nemo_tpu.models.rnnt import RNNTModel as JaxRNNTModel
from conformer_nemo_tpu_torch.convert.jax_params import rnnt_state_dict_from_jax
from conformer_nemo_tpu_torch.data.tokenizers import CharTokenizer
from conformer_nemo_tpu_torch.decode.rnnt_beam import BeamRNNTInfer
from conformer_nemo_tpu_torch.decode.rnnt_beam_batched import rnnt_beam_batched_decode
from conformer_nemo_tpu_torch.decode.rnnt_decoding import RNNTDecoding
from conformer_nemo_tpu_torch.decode.rnnt_greedy import rnnt_greedy_decode_batched
from conformer_nemo_tpu_torch.models import rnnt as port
from conformer_nemo_tpu_torch.models.conformer import ConformerEncoderConfig
from conformer_nemo_tpu_torch.ops.rnnt_loss import rnnt_loss_from_logits

from test_rnnt_model import V, _init_model, tiny_rnnt_cfg

torch.set_num_threads(2)


def _port_config():
    """tests/test_rnnt_model.py's tiny_rnnt_cfg in the port's classes."""
    return port.RNNTModelConfig(
        encoder=ConformerEncoderConfig(feat_in=16, n_layers=1, d_model=32, n_heads=2,
                                       ff_expansion_factor=2, conv_kernel_size=7,
                                       conv_norm_type="layer_norm", dropout=0.0,
                                       dropout_att=0.0, dtype=torch.float32),
        decoder=port.RNNTDecoderConfig(vocab_size=V, pred_hidden=24, dropout=0.0,
                                       dtype=torch.float32),
        joint=port.RNNTJointConfig(joint_hidden=24, dropout=0.0, dtype=torch.float32))


@pytest.fixture(scope="module")
def overfit_model():
    model, variables, feats, fl, tg, tl = _init_model(tiny_rnnt_cfg(), b=2, t=64, u=3, seed=7)
    params = variables["params"]
    opt = optax.adam(3e-3)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(
            lambda p: jnp.mean(model.apply({"params": p}, feats, fl, tg, tl)))(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    for _ in range(150):
        params, opt_state, _ = step(params, opt_state)
    enc, enc_lens = model.apply({"params": params}, feats, fl, train=False,
                                method=JaxRNNTModel.encode)
    pcfg = _port_config()
    pm = port.RNNTModel(pcfg).eval()
    pm.load_state_dict(rnnt_state_dict_from_jax({"params": jax.device_get(params)}, pcfg))
    return (pm, torch.from_numpy(np.array(enc)), torch.from_numpy(np.array(enc_lens)),
            np.asarray(tg))


@pytest.mark.parametrize("strategy", ["default", "tsd", "alsd", "maes"])
def test_beam_recovers_targets(overfit_model, strategy):
    pm, enc, enc_lens, targets = overfit_model
    best = BeamRNNTInfer(pm, beam_size=3, search_type=strategy, tsd_max_sym_exp=4,
                         alsd_max_target_len=0.5)(enc, enc_lens)
    assert [b.y_sequence for b in best] == targets.tolist(), strategy


def test_beam_equals_greedy_and_nbest_is_sorted(overfit_model):
    pm, enc, enc_lens, targets = overfit_model
    tokens, lens = rnnt_greedy_decode_batched(pm, enc, enc_lens, max_symbols=3)
    best = BeamRNNTInfer(pm, beam_size=4, search_type="default", score_norm=False)(enc, enc_lens)
    assert best[0].y_sequence == tokens[0, : int(lens[0])].tolist() == targets[0].tolist()
    nbest = BeamRNNTInfer(pm, beam_size=3, search_type="default",
                          return_best_hypothesis=False)(enc[:1], enc_lens[:1])[0]
    norm = [h.score / max(len(h.y_sequence), 1) for h in nbest]
    assert len(nbest) >= 1 and norm == sorted(norm, reverse=True)


@pytest.mark.parametrize("strategy", ["greedy_batch", "beam", "alsd", "beam_batch"])
def test_decoding_facade_recovers_targets(overfit_model, strategy):
    pm, enc, enc_lens, targets = overfit_model
    tok = CharTokenizer(list("abcdef")[:V])
    dec = RNNTDecoding(pm, tok, {"strategy": strategy, "greedy": {"max_symbols": 3},
                                 "beam": {"beam_size": 3 if strategy == "beam_batch" else 2,
                                          "tsd_max_sym_exp": 3, "alsd_max_target_len": 0.5}})
    assert dec.decode(enc, enc_lens) == targets.tolist(), strategy
    assert all(isinstance(t, str) and t for t in dec.decode_to_text(enc, enc_lens))


def _lattice_nll(pm, enc, enc_lens, tokens, lens) -> list:
    """Each sequence's RNN-T nll (the sum over its alignments)."""
    out = []
    for i in range(enc.shape[0]):
        u = int(lens[i])
        tg = tokens[i: i + 1, :u].long()
        with torch.no_grad():
            logits = pm.joint(enc[i: i + 1], pm.decoder(tg))
        out.append(float(rnnt_loss_from_logits(logits, tg, enc_lens[i: i + 1],
                                               torch.tensor([u]), pm.cfg.blank_id)[0]))
    return out


def test_beam_batch_recovers_targets_and_scores_no_worse_than_greedy(overfit_model):
    pm, enc, enc_lens, targets = overfit_model
    tokens, lens, _ = rnnt_beam_batched_decode(pm, enc, enc_lens, beam_size=3, max_sym_exp=3)
    for i in range(2):
        assert tokens[i, : int(lens[i])].tolist() == targets[i].tolist()
    gt, gl = rnnt_greedy_decode_batched(pm, enc, enc_lens, max_symbols=3)
    bt, bl, _ = rnnt_beam_batched_decode(pm, enc, enc_lens, beam_size=4, max_sym_exp=3,
                                         score_norm=False)
    for g, b in zip(_lattice_nll(pm, enc, enc_lens, gt, gl), _lattice_nll(pm, enc, enc_lens, bt, bl)):
        assert b <= g + 1e-3, (g, b)
