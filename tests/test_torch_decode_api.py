"""Word timestamps, the decoding strategies through the API, and the two
CLI entry points' new options, on the CPU (fp32, tiny: 2 layers, d_model
64; the transducer's prediction and joint width 32):

- decode/timestamps.py equals the JAX module on the same ids (char and
  SentencePiece tokenizers, per-frame probabilities, CTM lines);
- `transcribe_with_timestamps` of both model families against the JAX
  API on the same weights (the JAX model's archive restored in the port):
  CTC words equal; transducer words and starts equal, and each token spans
  one frame [t, t + 1) (the JAX API gives it t + 1 frames, so the oracle is
  the JAX greedy frames grouped by the JAX `words_from_alignments` with
  one-frame tokens);
- CTC `beamsearch_ngram` through `change_decoding_strategy` with an ARPA:
  the JAX API's texts, and the port's decoder applied directly to
  `transcribe(logprobs=True)`; the transducer's strategies give the JAX
  API's texts;
- `scripts/evaluate.main` runs every strategy with the JAX script's beam
  options (a CTC LM as ARPA and as a probing KenLM .bin), and
  `scripts/transcribe_speech.main --timestamps --ctm-dir --output` writes
  the JAX script's CTM and JSONL rows.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_nemo_tpu.data.tokenizers import CharTokenizer as JaxChar
from conformer_nemo_tpu.data.tokenizers import SentencePieceTokenizer as JaxSP
from conformer_nemo_tpu.decode import timestamps as jax_ts
from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer
from conformer_nemo_tpu_torch.data.audio_io import write_wav
from conformer_nemo_tpu_torch.data.tokenizers import CharTokenizer, SentencePieceTokenizer
from conformer_nemo_tpu_torch.decode import timestamps
from conformer_nemo_tpu_torch.decode.ctc_beam import BeamSearchDecoderWithLM
from conformer_nemo_tpu_torch.scripts import evaluate, transcribe_speech

from test_kenlm_probing import write_probing_binary
from test_torch_portable import ARTIFACTS, _jax_model

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SP_MODEL = os.path.join(ROOT, "tests", "fixtures", "sp_bpe_bytefallback.model")
EDGE_ARPA = os.path.join(ROOT, "tests", "fixtures", "lm_edge.arpa")
RNNT_STRATEGIES = ("greedy", "greedy_batch", "beam", "tsd", "alsd", "maes", "beam_batch")


def _words(ws) -> list:
    return [(w.word, w.start_s, w.duration_s, w.probability) for w in ws]


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("decode_api")
    rng = np.random.RandomState(3)
    paths, lines = [], []
    for i, (secs, text) in enumerate([(1.3, "the cat"), (2.1, "sat on the mat"),
                                      (0.7, "a test")]):
        n = int(secs * 16000)
        t = np.arange(n) / 16000
        path = str(d / f"u{i}.wav")
        write_wav(path, (0.05 * rng.randn(n) + 0.2 * np.sin(2 * np.pi * 300 * (i + 1) * t))
                  .astype(np.float32))
        paths.append(path)
        lines.append(json.dumps({"audio_filepath": path, "duration": secs, "text": text}))
    manifest = str(d / "m.json")
    with open(manifest, "w") as f:
        f.write("\n".join(lines) + "\n")
    return paths, manifest


@pytest.fixture(scope="module")
def edge_arpa(tmp_path_factory):
    """A copy of the fixture LM: the decoder writes its .binlm cache beside it."""
    path = str(tmp_path_factory.mktemp("lm") / "lm_edge.arpa")
    shutil.copy(EDGE_ARPA, path)
    return path


@pytest.fixture(scope="module")
def ctc(tmp_path_factory):
    """(JAX model, its archive, the port's restore of it), fp32."""
    jm = _jax_model("ctc", "bpe", seed=1)
    path = str(tmp_path_factory.mktemp("ctc") / "ctc.cntpu")
    jm.save_portable(path, artifacts=ARTIFACTS)
    return jm, path, ConformerCTC.restore_portable(path, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def rnnt(tmp_path_factory):
    jm = _jax_model("rnnt", "bpe", seed=2)
    path = str(tmp_path_factory.mktemp("rnnt") / "rnnt.cntpu")
    jm.save_portable(path, artifacts=ARTIFACTS)
    return jm, path, ConformerTransducer.restore_portable(path, dtype=torch.float32, device="cpu")


def test_timestamp_functions_equal_jax(tmp_path):
    rng = np.random.RandomState(0)
    labels = [" ", "a", "b", "c", "d"]
    for port_tok, jax_tok, blank, v in (
            (CharTokenizer(labels), JaxChar(labels), len(labels), len(labels) + 1),
            (SentencePieceTokenizer(SP_MODEL), JaxSP(SP_MODEL), 295, 40)):
        ids = rng.randint(0, v, (3, 50))
        ids[:, ::3] = blank  # blanks between repeats
        lens = np.array([50, 31, 0])
        probs = rng.uniform(0.1, 1.0, (3, 50)).astype(np.float32)
        got = timestamps.ctc_frame_alignments(ids, lens, blank, probs)
        want = jax_ts.ctc_frame_alignments(ids, lens, blank, probs)
        key = lambda us: [(u.token_id, u.start_frame, u.length, u.probability) for u in us]
        assert [key(u) for u in got] == [key(u) for u in want]
        assert sum(len(u) for u in got) > 20 and got[2] == []
        for g, w in zip(got, want):
            assert _words(timestamps.words_from_alignments(g, port_tok, 0.04)) == _words(
                jax_ts.words_from_alignments(w, jax_tok, 0.04))
        tokens = port_tok.ids_to_tokens(list(range(v)))
        assert tokens == jax_tok.ids_to_tokens(list(range(v)))
        assert timestamps.ctm_lines("utt", got[0], tokens, 0.04) == jax_ts.ctm_lines(
            "utt", want[0], tokens, 0.04)
        a = timestamps.write_ctm(str(tmp_path / "a.ctm"), "utt", got[1], tokens, 0.08)
        b = jax_ts.write_ctm(str(tmp_path / "b.ctm"), "utt", want[1], tokens, 0.08)
        assert open(a).read() == open(b).read()


def test_ctc_timestamps_equal_jax(ctc, wavs):
    jm, _, pm = ctc
    paths, _ = wavs
    got = pm.transcribe_with_timestamps(paths, batch_size=2)
    want = jm.transcribe_with_timestamps(paths, batch_size=2)
    assert [_words(g) for g in got] == [_words(w) for w in want]
    assert sum(len(g) for g in got) > 0


def test_transducer_timestamps_one_frame_per_token(rnnt, wavs):
    from conformer_nemo_tpu.decode.timestamps import FrameAlignedToken, words_from_alignments

    jm, _, pm = rnnt
    paths, _ = wavs
    got = pm.transcribe_with_timestamps(paths, batch_size=2)
    want_api = jm.transcribe_with_timestamps(paths, batch_size=2)
    stride = 0.01 * 4
    want = []
    for i in range(0, len(paths), 2):
        chunk = paths[i: i + 2]
        from conformer_nemo_tpu.data.audio_io import load_audio

        ws = [load_audio(p, target_sr=16000) for p in chunk]
        t_cap = int(np.ceil(max(len(w) for w in ws) / 1600.0)) * 1600
        audio = np.zeros((len(ws), t_cap), np.float32)
        lens = np.array([len(w) for w in ws], np.int32)
        for r, w in enumerate(ws):
            audio[r, : len(w)] = w
        toks, tlens, steps = jm._greedy_with_timestamps(audio, lens)
        for r in range(len(ws)):
            units = [FrameAlignedToken(int(toks[r, j]), int(steps[r, j]), 1)
                     for j in range(int(tlens[r]))]
            want.append(words_from_alignments(units, jm.tokenizer, stride))
    assert [_words(g) for g in got] == [_words(w) for w in want]
    assert [[(w.word, w.start_s) for w in g] for g in got] == [
        [(w.word, w.start_s) for w in g] for g in want_api]
    assert sum(len(g) for g in got) > 0
    for g in got:
        assert all(w.duration_s > 0 for w in g)


def test_ctc_beamsearch_ngram_through_the_api(ctc, wavs, edge_arpa):
    jm, _, pm = ctc
    paths, _ = wavs
    greedy = pm.transcribe(paths, batch_size=2)
    beam = {"beam_width": 16, "alpha": 1.0, "beta": 1.5, "lm_path": edge_arpa}
    cfg = {"strategy": "beamsearch_ngram", "beam": beam}
    pm.change_decoding_strategy(cfg)
    jm.change_decoding_strategy({"strategy": "beamsearch_ngram", "beam": dict(beam)})
    texts = pm.transcribe(paths, batch_size=2)
    assert texts == jm.transcribe(paths, batch_size=2)
    assert pm.transcribe(paths, batch_size=2) == texts  # the cached decoder
    # the port's decoder on transcribe(logprobs=True)'s arrays
    lps = pm.transcribe(paths, batch_size=2, logprobs=True)
    dec = BeamSearchDecoderWithLM(pm.tokenizer.ids_to_tokens(list(range(pm.tokenizer.vocab_size))),
                                  **beam)
    direct = [dec(lp[None])[0][0][0].replace("▁", " ").strip() for lp in lps]
    assert texts == direct
    pm.change_decoding_strategy({"strategy": "greedy"})
    assert pm.transcribe(paths, batch_size=2) == greedy
    with pytest.raises(ValueError, match="unknown CTC decoding strategy"):
        pm.change_decoding_strategy({"strategy": "beam"})


@pytest.mark.parametrize("strategy", RNNT_STRATEGIES)
def test_transducer_strategy_through_the_api(rnnt, wavs, strategy):
    jm, _, pm = rnnt
    paths, _ = wavs
    cfg = {"strategy": strategy, "greedy": {"max_symbols": 3},
           "beam": {"beam_size": 2, "tsd_max_sym_exp": 2, "alsd_max_target_len": 0.5,
                    "return_best_hypothesis": False}}
    pm.change_decoding_strategy(cfg)
    jm.change_decoding_strategy(json.loads(json.dumps(cfg)))
    texts = pm.transcribe(paths, batch_size=2)
    assert texts == jm.transcribe(paths, batch_size=2)
    hyps = pm.transcribe(paths, batch_size=2, return_hypotheses=True)
    assert [h.text for h in hyps] == texts
    greedy = strategy in ("greedy", "greedy_batch")
    assert all((h.timestep is not None) == greedy for h in hyps)


@pytest.mark.parametrize("model_type,extra", [
    ("ctc", ["--decoding-strategy", "greedy"]),
    ("ctc", ["--decoding-strategy", "beamsearch_ngram", "--beam-size", "8"]),
    ("ctc", ["--decoding-strategy", "beamsearch_ngram", "--lm-path", "ARPA",
             "--beam-alpha", "0.5", "--beam-beta", "1.0"]),
    ("ctc", ["--decoding-strategy", "beamsearch_ngram", "--lm-path", "PROBING", "--kenlm-bin"]),
    *[("rnnt", ["--decoding-strategy", s, "--beam-size", "2"]) for s in RNNT_STRATEGIES],
])
def test_evaluate_runs_each_strategy(ctc, rnnt, wavs, edge_arpa, tmp_path, model_type, extra):
    archive = (ctc if model_type == "ctc" else rnnt)[1]
    _, manifest = wavs
    extra = [edge_arpa if x == "ARPA" else x for x in extra]
    if "PROBING" in extra:
        extra[extra.index("PROBING")] = str(tmp_path / "lm.bin")
        write_probing_binary(EDGE_ARPA, str(tmp_path / "lm.bin"))
    wer = evaluate.main(["--model", archive, "--model-type", model_type, "--device", "cpu",
                         "--manifest", manifest, "--batch-size", "2", *extra])
    # the JAX script's decoding config on the script's own restore of the archive
    cls = ConformerCTC if model_type == "ctc" else ConformerTransducer
    model = cls.restore_portable(archive, device="cpu")
    args = evaluate.argparse.Namespace(
        model_type=model_type, decoding_strategy=extra[1], beam_size=4, beam_alpha=1.0,
        beam_beta=1.5, lm_path=None, kenlm_bin="--kenlm-bin" in extra)
    for flag, name, cast in (("--beam-size", "beam_size", int), ("--lm-path", "lm_path", str),
                             ("--beam-alpha", "beam_alpha", float),
                             ("--beam-beta", "beam_beta", float)):
        if flag in extra:
            setattr(args, name, cast(extra[extra.index(flag) + 1]))
    model.change_decoding_strategy(evaluate.decoding_config(args))
    from conformer_nemo_tpu_torch.decode.wer import word_error_rate

    hyps = model.transcribe(wavs[0], batch_size=2)
    assert wer == word_error_rate(hyps, ["the cat", "sat on the mat", "a test"])


def test_transcribe_speech_timestamps_and_ctm(ctc, wavs, tmp_path, capsys):
    _, archive, _ = ctc
    paths, _ = wavs
    out, ctm_dir = str(tmp_path / "hyps.jsonl"), str(tmp_path / "ctm")
    texts = transcribe_speech.main(["--model", archive, "--device", "cpu", "--audio", *paths,
                                    "--batch-size", "2", "--timestamps", "--ctm-dir", ctm_dir,
                                    "--output", out])
    printed = capsys.readouterr().out.split("\n")[:-1]
    model = ConformerCTC.restore_portable(archive, device="cpu")
    words = model.transcribe_with_timestamps(paths, batch_size=2)
    assert texts == model.transcribe(paths, batch_size=2)
    # the JAX script's lines: texts, each file's words, then one "wrote" per file
    want = [f"{p}\t{t}" for p, t in zip(paths, texts)]
    want += [f"  {w.start_s:7.2f} {w.start_s + w.duration_s:7.2f}  {w.word}"
             for ws in words for w in ws]
    want += [f"wrote {os.path.join(ctm_dir, f'u{i}.ctm')}" for i in range(len(paths))]
    assert printed == want
    assert sum(len(ws) for ws in words) > 0
    for i, ws in enumerate(words):
        with open(os.path.join(ctm_dir, f"u{i}.ctm")) as f:
            assert f.read() == "".join(f"u{i} 1 {w.start_s:.3f} {w.duration_s:.3f} {w.word} "
                                       f"{w.probability:1.3f}\n" for w in ws)
    with open(out) as f:
        rows = [json.loads(line) for line in f]
    assert [r["pred_text"] for r in rows] == texts
    assert [r["words"] for r in rows] == [
        [{"word": w.word, "start": round(w.start_s, 3), "end": round(w.start_s + w.duration_s, 3)}
         for w in ws] for ws in words]
