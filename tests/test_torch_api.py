"""Port ConformerCTC.transcribe vs the JAX ConformerCTC.transcribe.

Both models are built from configs/conformer_ctc_bpe.yaml with tiny
overrides and the SentencePiece fixture tokenizer (V = 295); the port takes
the JAX model's (perturbed) weights through the bridge. Inputs: the fixture
WAVs plus a synthesized 3.3 s WAV that takes the whole-utterance long-form
path (threshold lowered to 2 s). Texts and hypothesis token ids must be
identical; log-probs agree within 1e-4 (fp32, summation order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.api import ConformerCTC as JaxConformerCTC
from conformer_nemo_tpu.data.tokenizers import SentencePieceTokenizer as JaxSPTokenizer
from conformer_nemo_tpu_torch.api import ConformerCTC, TranscriptionHypothesis
from conformer_nemo_tpu_torch.convert.jax_params import ctc_state_dict_from_jax
from conformer_nemo_tpu_torch.data.audio_io import write_wav
from conformer_nemo_tpu_torch.data.tokenizers import SentencePieceTokenizer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
CONFIG = os.path.join(ROOT, "configs", "conformer_ctc_bpe.yaml")
OVERRIDES = {
    "model.tokenizer.model_file": os.path.join(FIXTURES, "sp_bpe_bytefallback.model"),
    "model.encoder.n_layers": 2,
    "model.encoder.d_model": 64,
    "model.encoder.n_heads": 4,
    "model.encoder.conv_kernel_size": 15,
}
ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = JaxConformerCTC.from_config_file(CONFIG, overrides=OVERRIDES, dtype=jnp.float32)
    state = jm._init_state(jm._make_optimizer())
    rng = np.random.RandomState(0)
    noisy = lambda x: np.asarray(x, np.float32) + 0.2 * rng.randn(*np.shape(x)).astype(np.float32)
    params = jax.tree.map(noisy, state.params)
    stats = jax.tree.map(lambda x: np.abs(noisy(x)) + 0.5, state.batch_stats)
    jm.state = state.replace(params=jax.tree.map(jnp.asarray, params),
                             batch_stats=jax.tree.map(jnp.asarray, stats))
    pm = ConformerCTC.from_config_file(CONFIG, overrides=OVERRIDES, dtype=torch.float32,
                                       device="cpu")
    pm.load_state_dict(ctc_state_dict_from_jax({"params": params, "batch_stats": stats}, pm.cfg))
    return jm, pm


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    speech = os.path.join(FIXTURES, "speech")
    out = [os.path.join(speech, f) for f in ("utt0.wav", "utt2.wav", "utt4.wav")]
    rng = np.random.RandomState(7)
    n = int(3.3 * 16000)
    wav = 0.05 * rng.randn(n) + 0.2 * np.sin(2 * np.pi * 440.0 * np.arange(n) / 16000)
    long_path = str(tmp_path_factory.mktemp("wav") / "long.wav")
    write_wav(long_path, wav.astype(np.float32))
    return out + [long_path]


KW = dict(batch_size=2, longform_threshold_s=2.0)


def test_transcribe_logprobs_match_jax(models, paths):
    jm, pm = models
    lp_j = jm.transcribe(paths, logprobs=True, **KW)
    lp_p = pm.transcribe(paths, logprobs=True, **KW)
    assert len(lp_p) == len(paths)
    for a, b in zip(lp_p, lp_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=ATOL)


def test_transcribe_texts_and_hypotheses_match_jax(models, paths):
    jm, pm = models
    assert pm.transcribe(paths, **KW) == jm.transcribe(paths, **KW)
    hyp_p = pm.transcribe(paths, return_hypotheses=True, **KW)
    hyp_j = jm.transcribe(paths, return_hypotheses=True, **KW)
    for a, b in zip(hyp_p, hyp_j):
        assert isinstance(a, TranscriptionHypothesis)
        assert a.y_sequence == b.y_sequence and a.text == b.text
        assert a.score == pytest.approx(b.score, rel=1e-5, abs=1e-3)
    assert any(h.y_sequence for h in hyp_p)  # the comparison is not vacuous


@pytest.mark.parametrize("model_file", ["sp_bpe_bytefallback.model", "sp_unigram.model"])
def test_sentencepiece_ids_to_text_matches_jax(model_file):
    path = os.path.join(FIXTURES, model_file)
    port_tok, jax_tok = SentencePieceTokenizer(path), JaxSPTokenizer(path)
    assert port_tok.vocab_size == jax_tok.vocab_size
    rng = np.random.RandomState(3)
    for _ in range(50):
        ids = rng.randint(-2, port_tok.vocab_size + 2, size=rng.randint(0, 30)).tolist()
        assert port_tok.ids_to_text(ids) == jax_tok.ids_to_text(ids)
    # every piece on its own, byte pieces included
    for i in range(port_tok.vocab_size):
        assert port_tok.ids_to_text([i]) == jax_tok.ids_to_text([i])
