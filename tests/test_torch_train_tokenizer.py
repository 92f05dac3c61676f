"""The port's BPE tokenizer trainer against the JAX package's
`train_bpe_tokenizer` (Hugging Face tokenizers' BpeTrainer, the oracle on
this machine).

Corpora: the repo's fixture transcripts (the speech manifest and the
SentencePiece fixtures' corpus, mixed case) and seeded random words over an
alphabet with Vietnamese diacritics and characters NFKC folds (ligatures,
full-width letters, superscripts, compatibility forms). Settings: vocab
64, 300 and more than the corpus can make, lowercase on and off. The
port's `tokenizer.json` must have the library's vocab and merges, and
`text_to_ids` must agree through both packages' readers on the corpus and
on unseen text. Then the CLI end to end, host-only (no device argument).
"""

import json
import os

import numpy as np
import pytest

from conformer_nemo_tpu.data.tokenizers import HFTokenizer
from conformer_nemo_tpu.data.tokenizers import train_bpe_tokenizer as jax_train
from conformer_nemo_tpu_torch.data.bpe_trainer import train_bpe_tokenizer
from conformer_nemo_tpu_torch.data.hf_tokenizer import HFJsonTokenizer
from conformer_nemo_tpu_torch.data.manifest import read_manifest
from conformer_nemo_tpu_torch.scripts import train_tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
ALPHABET = list("abcdeghiklmnopqrstuvxy") + list(
    "àáảãạăằắẳẵặâầấẩẫậđèéẻẽẹêềếểễệìíỉĩịòóỏõọôồốổỗộơờớởỡợùúủũụưừứửữựỳýỷỹỵ"
    "ÀÁĐÊƠƯ") + ["ﬁ", "ﬂ", "Ａ", "ｂ", "²", "Å", "ǅ", "ſ", "…"]


def _fixture_texts():
    texts = [s.text for s in read_manifest(os.path.join(FIXTURES, "speech", "manifest.json"))]
    with open(os.path.join(FIXTURES, "sp_corpus.txt"), encoding="utf-8") as f:
        texts += [line.rstrip("\n") for line in f]
    return texts + [t.title() for t in texts]  # upper case, for lowercase on and off


def _random_texts(seed, n=300):
    rng = np.random.RandomState(seed)
    words = ["".join(rng.choice(ALPHABET, rng.randint(1, 9))) for _ in range(400)]
    return [" ".join(rng.choice(words, rng.randint(1, 14))) for _ in range(n)]


CORPORA = {"fixtures": _fixture_texts, "vietnamese_nfkc": lambda: _random_texts(0)}


@pytest.mark.parametrize("lowercase", [True, False])
@pytest.mark.parametrize("vocab_size", [64, 300, 100000])
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_trainer_matches_the_library(tmp_path, corpus, vocab_size, lowercase):
    texts = CORPORA[corpus]()
    want_tok = jax_train(texts, vocab_size, str(tmp_path / "jax.json"), lowercase=lowercase)
    got_tok = train_bpe_tokenizer(texts, vocab_size, str(tmp_path / "port.json"),
                                  lowercase=lowercase)
    with open(tmp_path / "jax.json", encoding="utf-8") as f:
        want = json.load(f)
    with open(tmp_path / "port.json", encoding="utf-8") as f:
        got = json.load(f)
    assert got["model"]["vocab"] == want["model"]["vocab"]
    assert got["model"]["merges"] == want["model"]["merges"]
    assert got == want  # the normalizer, pre-tokenizer, decoder and added token too
    if vocab_size == 100000:  # more than the corpus makes: it ran out of pairs
        assert len(want["model"]["vocab"]) < vocab_size
    assert got_tok.vocab_size == want_tok.vocab_size
    unseen = _random_texts(7, 20) + ["Hello  World", "  leading and trailing  ", "ﬁne Ａb²"]
    port_reader, jax_reader = HFJsonTokenizer(str(tmp_path / "port.json")), HFTokenizer(
        str(tmp_path / "jax.json"))
    for text in texts + unseen:
        ids = jax_reader.text_to_ids(text)
        assert port_reader.text_to_ids(text) == ids, text
        assert got_tok.text_to_ids(text) == ids, text


def test_cli_trains_host_only(tmp_path):
    manifest = tmp_path / "train.json"
    texts = _random_texts(3, 50) + _fixture_texts()
    with open(manifest, "w", encoding="utf-8") as f:
        for i, t in enumerate(texts):
            f.write(json.dumps({"audio_filepath": f"{i}.wav", "duration": 1.0, "text": t},
                               ensure_ascii=False) + "\n")
    out = tmp_path / "tok"
    tok = train_tokenizer.main(["--manifest", str(manifest), "--vocab-size", "96", "--out",
                                str(out), "--no-lowercase"])
    jax_train(texts, 96, str(tmp_path / "jax.json"), lowercase=False)
    with open(out / "tokenizer.json", encoding="utf-8") as f:
        got = json.load(f)
    with open(tmp_path / "jax.json", encoding="utf-8") as f:
        want = json.load(f)
    assert got == want and tok.vocab_size == len(want["model"]["vocab"])
    with pytest.raises(SystemExit):  # the JAX script's flags and nothing else
        train_tokenizer.main(["--manifest", str(manifest), "--out", str(out), "--device", "cpu"])
