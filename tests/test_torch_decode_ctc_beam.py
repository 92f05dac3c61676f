"""The port's CTC prefix beam search (`BeamSearchDecoderWithLM` over its
own copy of the native decoder, data/csrc/ctc_beam.cpp) against the JAX
package's (built from native/ctc_beam), on the same seeded numpy
log-probs. The two run the same C++, so the n-best texts and scores must
be equal exactly: without an LM, with the committed tests/fixtures/
lm_edge.arpa and with an ARPA written here, over batches with ragged
lengths on several threads, and over a SentencePiece vocabulary. Also:
the native library builds from the port's sources into ops/_build/, and
`ops/build.py` rebuilds a host library when a header it includes is
newer than the library."""

import ctypes
import os
import time

import numpy as np
import pytest

from conformer_nemo_tpu.decode.ctc_beam import BeamSearchDecoderWithLM as JaxBeam
from conformer_nemo_tpu_torch.data.tokenizers import SentencePieceTokenizer
from conformer_nemo_tpu_torch.decode.ctc_beam import BeamSearchDecoderWithLM
from conformer_nemo_tpu_torch.ops import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGE_ARPA = os.path.join(ROOT, "tests", "fixtures", "lm_edge.arpa")
SP_MODEL = os.path.join(ROOT, "tests", "fixtures", "sp_bpe_bytefallback.model")
# the letters of the edge LM's words, and the space between words
VOCAB = [" ", "a", "c", "e", "h", "m", "s", "t"]
BIGRAM_ARPA = """\\data\\
ngram 1=6
ngram 2=4

\\1-grams:
-0.5\t<s>\t-0.3
-0.7\t</s>
-0.4\tcat\t-0.2
-0.9\tmat\t-0.1
-0.8\tthe\t-0.2
-1.5\t<unk>

\\2-grams:
-0.2\t<s> the
-0.3\tthe cat
-0.6\tcat mat
-0.8\tmat </s>

\\end\\
"""


def _log_probs(seed: int, b: int, t: int, v: int, scale: float = 2.0) -> np.ndarray:
    logits = np.random.RandomState(seed).randn(b, t, v).astype(np.float32) * scale
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


@pytest.fixture(scope="module")
def bigram_arpa(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm") / "bigram.arpa")
    with open(path, "w") as f:
        f.write(BIGRAM_ARPA)
    return path


@pytest.mark.parametrize("beam_width", [1, 8, 64])
def test_no_lm_equal_jax(beam_width):
    lp = _log_probs(0, 3, 30, len(VOCAB) + 1)
    kw = dict(beam_width=beam_width, num_cpus=2)
    got = BeamSearchDecoderWithLM(VOCAB, **kw)(lp, nbest=4)
    assert got == JaxBeam(VOCAB, **kw)(lp, nbest=4)
    assert all(len(n) >= 1 and n[0][0] for n in got)


@pytest.mark.parametrize("lm", ["edge", "bigram"])
@pytest.mark.parametrize("alpha,beta", [(1.0, 1.5), (2.0, 0.0)])
def test_with_lm_equal_jax(lm, alpha, beta, bigram_arpa):
    path = EDGE_ARPA if lm == "edge" else bigram_arpa
    lp = _log_probs(1, 4, 40, len(VOCAB) + 1)
    lens = np.array([40, 33, 7, 1])
    kw = dict(beam_width=16, alpha=alpha, beta=beta, lm_path=path, lm_binary_cache=False,
              num_cpus=3)
    port, jax_ = BeamSearchDecoderWithLM(VOCAB, **kw), JaxBeam(VOCAB, **kw)
    got = port(lp, seq_lens=lens, nbest=5)
    assert got == jax_(lp, seq_lens=lens, nbest=5)
    # the LM moves the search: the same log-probs decode otherwise without it
    plain = BeamSearchDecoderWithLM(VOCAB, beam_width=16)(lp, seq_lens=lens, nbest=5)
    assert [n[0] for n in plain] != [n[0] for n in got]
    for ctx, w in ((["<s>"], "the"), (["the"], "cat"), (["cat"], "zebra"), ([], "mat")):
        assert port.lm_score(ctx, w) == jax_.lm_score(ctx, w)


def test_sentencepiece_vocabulary_equal_jax():
    tok = SentencePieceTokenizer(SP_MODEL)
    vocab = tok.ids_to_tokens(list(range(tok.vocab_size)))
    lp = _log_probs(2, 2, 25, len(vocab) + 1, scale=3.0)
    kw = dict(beam_width=8, alpha=1.0, beta=1.5, lm_path=EDGE_ARPA, lm_binary_cache=False)
    got = BeamSearchDecoderWithLM(vocab, **kw)(lp, nbest=3)
    assert got == JaxBeam(vocab, **kw)(lp, nbest=3)
    assert all(n and n[0][0] for n in got)


def test_wrong_class_count_raises():
    with pytest.raises(ValueError, match="vocabulary has 8 labels and the blank"):
        BeamSearchDecoderWithLM(VOCAB)(np.zeros((1, 5, 4), np.float32))


def test_library_builds_from_the_ports_sources():
    lib = build.host_library("ctc_beam")
    assert lib._name == os.path.join(build.BUILD_DIR, "libctc_beam.so")
    source, _, _, headers = build.HOST_LIBS["ctc_beam"]
    assert (source, headers) == ("ctc_beam.cpp", ("kenlm_probing.h", "kenlm_trie.h"))
    for f in (source, *headers):
        assert os.path.isfile(os.path.join(build.HOST_CSRC_DIR, f))


def test_a_newer_header_rebuilds_the_library(tmp_path, monkeypatch):
    """A library is stale when its source or any header it lists is newer."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "dep.h").write_text("#define VALUE 1\n")
    (csrc / "lib.c").write_text('#include "dep.h"\nint value(void) { return VALUE; }\n')
    monkeypatch.setattr(build, "HOST_CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "HOST_LIBS", {"lib": ("lib.c", ("gcc", "-O2"), (), ("dep.h",))})
    assert build._build_host("lib", force=False)
    assert not build._build_host("lib", force=False)  # fresh
    so = os.path.join(build.BUILD_DIR, "liblib.so")
    (csrc / "dep.h").write_text("#define VALUE 2\n")
    past = time.time() - 60
    os.utime(so, (past, past))  # the library is older than the header only
    os.utime(csrc / "lib.c", (past - 60, past - 60))
    assert build._build_host("lib", force=False)  # the header is newer: rebuilt
    assert not build._build_host("lib", force=False)
    assert ctypes.CDLL(so).value() == 2
    os.utime(so, (past, past))
    os.utime(csrc / "dep.h", (past - 60, past - 60))
    os.utime(csrc / "lib.c", (past + 30, past + 30))
    assert build._build_host("lib", force=False)  # so is a newer source
