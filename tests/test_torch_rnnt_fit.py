"""`ConformerTransducer.fit` on the CPU: a tiny config (2 layers, d_model
64, prediction and joint width 32) trains two steps on a 4-utterance
manifest with validation (greedy WER and, with compute_eval_loss, the
loss), through the flash joint and through the dense one (on the CPU the
K3 / K4 wrappers run their plain versions), returns a finite loss, leaves
the model in eval mode and transcribes; the beam strategies and word
timestamps run; buffered decode, export and change_vocabulary run; what
is not ported raises."""

import json
import math
import os

import numpy as np
import pytest
import torch

from conformer_nemo_tpu_torch.api import ConformerTransducer, TranscriptionHypothesis
from conformer_nemo_tpu_torch.data.audio_io import write_wav
from conformer_nemo_tpu_torch.data.tokenizers import SentencePieceTokenizer
from conformer_nemo_tpu_torch.utils.export import load_exported

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "conformer_transducer_bpe.yaml")
TINY = {
    "model.tokenizer.model_file": os.path.join(ROOT, "tests", "fixtures",
                                               "sp_bpe_bytefallback.model"),
    "model.encoder.n_layers": 2, "model.encoder.d_model": 64, "model.encoder.n_heads": 4,
    "model.model_defaults.pred_hidden": 32, "model.model_defaults.joint_hidden": 32,
    "model.train_ds.batch_size": 2, "model.validation_ds.batch_size": 2,
    "model.train_ds.num_workers": 2, "model.compute_eval_loss": True,
    "model.decoding.greedy.max_symbols": 3,
}


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp("rnnt_fit")
    rng = np.random.RandomState(0)
    with open(d / "train.json", "w", encoding="utf-8") as f:
        for i, text in enumerate(["hello world", "the quick brown fox", "speech", "a test"]):
            n = int(rng.uniform(1.0, 2.0) * 16000)
            write_wav(str(d / f"{i}.wav"), (0.1 * rng.randn(n)).astype(np.float32))
            f.write(json.dumps({"audio_filepath": f"{i}.wav", "duration": n / 16000,
                                "text": text}) + "\n")
    return str(d / "train.json")


@pytest.mark.parametrize("joint_impl", ["flash", "dense"])
def test_fit_on_cpu_then_transcribe(manifest, joint_impl):
    model = ConformerTransducer.from_config_file(
        CONFIG, overrides={**TINY, "model.joint.joint_impl": joint_impl}, device="cpu",
        dtype=torch.float32)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = model.fit(manifest, manifest, max_steps=2)
    assert out["steps"] == 2 and math.isfinite(out["last_loss"])
    assert math.isfinite(out["val"]["loss"]) and out["val"]["words"] > 0
    assert not model.model.training
    after = model.state_dict()
    for key in ("joint.joint_net.2.weight", "decoder.prediction.dec_rnn.lstm.weight_hh_l0",
                "encoder.layers.1.self_attn.linear_q.weight"):
        assert not torch.equal(after[key], before[key]), key
    wavs = [os.path.join(os.path.dirname(manifest), f"{i}.wav") for i in range(2)]
    texts = model.transcribe(wavs)
    hyps = model.transcribe(wavs, return_hypotheses=True)
    assert [h.text for h in hyps] == texts and all(isinstance(h, TranscriptionHypothesis)
                                                   for h in hyps)
    assert all(len(h.timestep) == len(h.y_sequence) for h in hyps)
    assert all(sorted(h.timestep) == h.timestep for h in hyps)


def test_transducer_refuses_what_is_not_ported(manifest, tmp_path):
    model = ConformerTransducer.from_config_file(CONFIG, overrides=TINY, device="cpu",
                                                 dtype=torch.float32)
    model.change_decoding_strategy({"strategy": "greedy", "greedy": {"max_symbols": 2}})
    assert model.decoding.max_symbols == 2
    wav = os.path.join(os.path.dirname(manifest), "0.wav")
    model.change_decoding_strategy({"strategy": "beam", "beam": {"beam_size": 2}})
    assert isinstance(model.transcribe([wav])[0], str)  # the beam strategies are ported
    words = model.transcribe_with_timestamps([wav])[0]  # and word timestamps
    assert all(w.duration_s > 0 for w in words)
    with pytest.raises(ValueError, match="unknown decoding strategy"):
        model.change_decoding_strategy({"strategy": "beamsearch_ngram"})
    # buffered decode, export and change_vocabulary are ported
    model.change_decoding_strategy({"strategy": "greedy_batch", "greedy": {"max_symbols": 2}})
    assert isinstance(model.transcribe_buffered([wav], frame_len=0.8, total_buffer=1.6)[0], str)
    fns = load_exported(model.export(str(tmp_path / "rnnt.pt2.tar.gz"), batch_size=1,
                                     seconds=0.5))
    assert set(fns) == {"encoder", "decoder_joint"}
    tok = SentencePieceTokenizer(os.path.join(ROOT, "tests", "fixtures", "sp_unigram.model"))
    model.change_vocabulary(tok)
    assert model.model.joint.out.out_features == tok.vocab_size + 1
    with pytest.raises(ValueError, match="CTC-only"):
        model.transcribe([os.path.join(os.path.dirname(manifest), "0.wav")], logprobs=True)
    with pytest.raises(ValueError, match="loss_name"):
        ConformerTransducer.from_config_file(
            CONFIG, overrides={**TINY, "model.loss.loss_name": "tdt"}, device="cpu",
            dtype=torch.float32)
