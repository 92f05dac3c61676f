"""The port's n-gram LM files against the JAX package's:

- `lm_score` equals the hand-computed Katz backoff oracle of
  tests/test_ctc_beam.py on tests/fixtures/lm_edge.arpa, and the JAX
  decoder's score;
- a `.binlm` cache written by either package loads in the other (the ARPA
  is spoiled after the cache is written, so only the cache can give the
  same decode), from its own path too;
- a corrupt cache is dropped, the ARPA parsed, and the cache written anew;
- the layout-exact probing and trie-family KenLM `.bin` fixtures
  (tests/test_kenlm_probing.py, tests/test_kenlm_trie.py writers) decode
  with kenlm_bin as the JAX decoder decodes them, and the unquantised ones
  as their ARPA does;
- other KenLM binaries, and readable ones without the opt-in, raise with
  the JAX message, word for word; `parse_header` agrees with the JAX one.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from conformer_nemo_tpu.decode import kenlm_binary as jax_kenlm
from conformer_nemo_tpu.decode.ctc_beam import BeamSearchDecoderWithLM as JaxBeam
from conformer_nemo_tpu_torch.decode import kenlm_binary
from conformer_nemo_tpu_torch.decode.ctc_beam import BeamSearchDecoderWithLM

from test_ctc_beam import _synth_kenlm_binary
from test_kenlm_probing import SENTENCES, write_probing_binary
from test_kenlm_trie import write_trie_binary

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGE_ARPA = os.path.join(ROOT, "tests", "fixtures", "lm_edge.arpa")
VOCAB = [" ", "a", "c", "e", "h", "m", "s", "t"]
KW = dict(beam_width=8, alpha=1.0, beta=0.5)
CACHE_ARPA = """\\data\\
ngram 1=5
ngram 2=3

\\1-grams:
-0.5\t<s>\t-0.3
-0.7\t</s>
-0.4\tab\t-0.2
-0.9\tba\t-0.1
-1.5\t<unk>

\\2-grams:
-0.2\t<s> ab
-0.6\tab ba
-0.8\tba </s>

\\end\\
"""


def _fields(hdr):
    return None if hdr is None else dataclasses.asdict(hdr)


def _log_probs(seed: int, t: int, v: int) -> np.ndarray:
    logits = np.random.RandomState(seed).randn(t, v).astype(np.float32) * 2.0
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


def test_lm_score_hand_oracle():
    dec = BeamSearchDecoderWithLM(["a", " "], lm_path=EDGE_ARPA, lm_binary_cache=False)
    ref = JaxBeam(["a", " "], lm_path=EDGE_ARPA, lm_binary_cache=False)
    cases = [
        (["<s>"], "the", -0.30),
        (["<s>", "the"], "cat", -0.20),
        (["the", "cat"], "sat", -0.25),
        (["the", "cat"], "mat", -0.15 - 0.90),
        (["cat", "sat"], "mat", -0.10 - 0.2 - 1.3),
        (["the"], "zebra", -0.4 - 1.2),
        (["sat", "the"], "</s>", 0.0 - 0.4 - 1.0),
        (["<s>", "the", "cat"], "sat", -0.25),
        (["zebra", "cat"], "sat", -0.50),
    ]
    for ctx, w, expect in cases:
        got = dec.lm_score(ctx, w)
        assert got == pytest.approx(expect, abs=1e-6), (ctx, w, got)
        assert got == ref.lm_score(ctx, w)
    with pytest.raises(ValueError, match="no LM loaded"):
        BeamSearchDecoderWithLM(["a"]).lm_score([], "a")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_binlm_cache_crosses_packages(writer, tmp_path):
    arpa = tmp_path / "lm.arpa"
    arpa.write_text(CACHE_ARPA)
    vocab = [" ", "a", "b"]
    lp = _log_probs(0, 20, len(vocab) + 1)
    write_cls, read_cls = ((BeamSearchDecoderWithLM, JaxBeam) if writer == "port"
                           else (JaxBeam, BeamSearchDecoderWithLM))
    want = write_cls(vocab, lm_path=str(arpa), **KW)._decode_one(lp, nbest=4)
    cache = str(arpa) + ".binlm"
    assert os.path.exists(cache)
    # spoil the ARPA: a re-parse would decode otherwise, the cache decodes the same
    arpa.write_text("\\data\\\nngram 1=1\n\n\\1-grams:\n-9.0\t<unk>\n\n\\end\\\n")
    os.utime(cache)
    assert read_cls(vocab, lm_path=str(arpa), **KW)._decode_one(lp, nbest=4) == want
    assert read_cls(vocab, lm_path=cache, **KW)._decode_one(lp, nbest=4) == want
    spoiled = read_cls(vocab, lm_path=str(arpa), lm_binary_cache=False, **KW)
    assert spoiled._decode_one(lp, nbest=4) != want


def test_corrupt_cache_falls_back_to_the_arpa(tmp_path):
    arpa = tmp_path / "lm.arpa"
    arpa.write_text(CACHE_ARPA)
    vocab = ["a", "b", " "]
    lp = _log_probs(1, 12, 4)
    ref = BeamSearchDecoderWithLM(vocab, lm_path=str(arpa), lm_binary_cache=False,
                                  **KW)._decode_one(lp, nbest=2)
    cache = str(arpa) + ".binlm"
    for garbage in (b"CNLM0001" + b"\xff" * 64, b"CNLM0001" + b"\x02" * 8, b"junk"):
        with open(cache, "wb") as f:
            f.write(garbage)
        os.utime(cache)  # newer than the ARPA: the cache is tried first
        assert BeamSearchDecoderWithLM(vocab, lm_path=str(arpa), **KW)._decode_one(
            lp, nbest=2) == ref
        with open(cache, "rb") as f:
            assert f.read() != garbage  # written anew from the ARPA
        assert JaxBeam(vocab, lm_path=cache, **KW)._decode_one(lp, nbest=2) == ref


@pytest.fixture(scope="module")
def kenlm_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("kenlm")
    files = {"probing": str(d / "probing.bin"), "trie": str(d / "trie.bin"),
             "quant_trie": str(d / "quant_trie.bin"), "array_trie": str(d / "array_trie.bin")}
    write_probing_binary(EDGE_ARPA, files["probing"])
    write_trie_binary(EDGE_ARPA, files["trie"])
    write_trie_binary(EDGE_ARPA, files["quant_trie"], quantized=True)
    write_trie_binary(EDGE_ARPA, files["array_trie"], bhiksha_bits=22)
    return files


@pytest.mark.parametrize("kind", ["probing", "trie", "quant_trie", "array_trie"])
def test_kenlm_bin_decodes_as_jax_and_its_arpa(kind, kenlm_files):
    path = kenlm_files[kind]
    hdr = kenlm_binary.parse_header(path)
    assert _fields(hdr) == _fields(jax_kenlm.parse_header(path)) and hdr.model_type == kind
    port = BeamSearchDecoderWithLM(VOCAB, lm_path=path, kenlm_bin=True, **KW)
    jax_ = JaxBeam(VOCAB, lm_path=path, kenlm_bin=True, **KW)
    arpa = BeamSearchDecoderWithLM(VOCAB, lm_path=EDGE_ARPA, lm_binary_cache=False, **KW)
    lp = np.stack([_log_probs(s, 30, len(VOCAB) + 1) for s in (2, 3)])
    got = port(lp, nbest=3)
    assert got == jax_(lp, nbest=3)
    want = arpa(lp, nbest=3)
    assert [[t for t, _ in n] for n in got] == [[t for t, _ in n] for n in want]
    for n_got, n_want in zip(got, want):
        np.testing.assert_allclose([s for _, s in n_got], [s for _, s in n_want], atol=1e-4)
    for sent in SENTENCES:
        ctx = ["<s>"]
        for w in sent.split() + ["</s>"]:
            assert port.lm_score(ctx, w) == jax_.lm_score(ctx, w)
            assert port.lm_score(ctx, w) == pytest.approx(arpa.lm_score(ctx, w), abs=2e-6)
            ctx.append(w)
    # the older spelling of the opt-in
    assert BeamSearchDecoderWithLM(VOCAB, lm_path=path, kenlm_probing=True, **KW)(
        lp, nbest=3) == got


def _rejection(cls, path, **kw) -> str:
    with pytest.raises(ValueError) as e:
        cls(["a", " "], lm_path=path, **kw)
    return str(e.value)


def test_other_kenlm_binaries_raise_with_the_jax_guidance(kenlm_files, tmp_path):
    rest = str(tmp_path / "rest.bin")
    _synth_kenlm_binary(rest, model_type=1)
    garbage = str(tmp_path / "garbage.bin")
    with open(garbage, "wb") as f:
        f.write(b"mmap lm http://kheafield.com/code format version 5\n\0" + bytes(range(64)))
    for path, kw in ((rest, {}), (rest, {"kenlm_bin": True}), (garbage, {"kenlm_bin": True}),
                     (kenlm_files["probing"], {}), (kenlm_files["trie"], {})):
        msg = _rejection(BeamSearchDecoderWithLM, path, **kw)
        assert msg == _rejection(JaxBeam, path, **kw)
        assert "ARPA" in msg and "lmplz" in msg
    assert "rest_probing" in _rejection(BeamSearchDecoderWithLM, rest)
    assert "kenlm_bin=True" in _rejection(BeamSearchDecoderWithLM, kenlm_files["trie"])
    shutil.copy(kenlm_files["probing"], tmp_path / "cut.bin")
    with open(tmp_path / "cut.bin", "r+b") as f:
        f.truncate(os.path.getsize(kenlm_files["probing"]) - 40)
    msg = _rejection(BeamSearchDecoderWithLM, str(tmp_path / "cut.bin"), kenlm_bin=True)
    assert msg == _rejection(JaxBeam, str(tmp_path / "cut.bin"), kenlm_bin=True)
    for path in (rest, garbage, EDGE_ARPA, str(tmp_path / "absent.bin")):
        assert kenlm_binary.is_kenlm_binary(path) == jax_kenlm.is_kenlm_binary(path)
        assert _fields(kenlm_binary.parse_header(path)) == _fields(jax_kenlm.parse_header(path))
