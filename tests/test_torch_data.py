"""Port host-side data path vs the JAX package: `text_to_ids` of the
SentencePiece and char tokenizers, manifests, the bucket plan and the
collated batches (serial and thread-pool loaders). All exact."""

import json
import os

import numpy as np
import pytest
import yaml

from conformer_nemo_tpu.data import dataset as jds
from conformer_nemo_tpu.data import manifest as jman
from conformer_nemo_tpu.data import tokenizers as jtok
from conformer_nemo_tpu_torch.data import dataset as pds
from conformer_nemo_tpu_torch.data import manifest as pman
from conformer_nemo_tpu_torch.data import tokenizers as ptok
from conformer_nemo_tpu_torch.data.audio_io import write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")

TEXTS = [
    "hello world", "  The  Quick brown fox\tjumps ", "speech recognition with conformers",
    "naïve café — déjà vu", "日本語のテキスト", "emoji 🙂 and ümlaut", "", "   ",
    "a" * 40, "numbers 12345 and punctuation, too!",
]


@pytest.mark.parametrize("model", ["sp_bpe_bytefallback.model", "sp_unigram.model"])
def test_sentencepiece_text_to_ids_matches_jax(model):
    path = os.path.join(FIXTURES, model)
    port, ref = ptok.SentencePieceTokenizer(path), jtok.SentencePieceTokenizer(path)
    with open(os.path.join(FIXTURES, "sp_corpus.txt"), encoding="utf-8") as f:
        corpus = [line.strip() for line in f][:50]
    for text in TEXTS + corpus:
        ids = port.text_to_ids(text)
        assert ids == ref.text_to_ids(text), text
        assert port.ids_to_text(ids) == ref.ids_to_text(ids)
    if "bytefallback" in model:  # a character outside the vocabulary takes byte pieces
        ids = port.text_to_ids("日")
        assert [port.pieces[i] for i in ids if port.types[i] == 6]


def test_char_tokenizer_text_to_ids_matches_jax():
    with open(os.path.join(ROOT, "configs", "conformer_ctc_char.yaml"), encoding="utf-8") as f:
        labels = yaml.safe_load(f)["model"]["labels"]
    port, ref = ptok.CharTokenizer(labels), jtok.CharTokenizer(labels)
    for text in TEXTS + ["Xin chào thế giới", "UPPER  lower"]:
        assert port.text_to_ids(text) == ref.text_to_ids(text), text


def _write_corpus(tmp_path, n=11, seed=0):
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        secs = float(np.round(rng.uniform(0.3, 2.5), 2))
        samples = int(round(secs * 16000))
        write_wav(str(tmp_path / f"u{i}.wav"), (0.1 * rng.randn(samples)).astype(np.float32))
        item = {"duration": secs}
        item["audio_filepath" if i % 3 else "audio_file"] = f"u{i}.wav"  # relative paths
        if i == 4:
            (tmp_path / "t4.txt").write_text(" text from a file \n", encoding="utf-8")
            item["text_filepath"] = str(tmp_path / "t4.txt")
        elif i == 5:
            item["normalized_text"] = "normalized text"
        else:
            item["text"] = TEXTS[i % len(TEXTS)]
        if i == 6:
            item.update(offset=0.1, lang="en", duration=secs - 0.1)
        lines.append(json.dumps(item, ensure_ascii=False))
    path = tmp_path / "manifest.json"
    path.write_text("\n".join(lines) + "\n\n", encoding="utf-8")
    return str(path)


def test_manifest_matches_jax(tmp_path):
    path = _write_corpus(tmp_path)
    as_tuple = lambda s: (s.audio_file, s.duration, s.text, s.offset, s.lang)
    assert [as_tuple(s) for s in pman.iter_manifest(path)] == \
        [as_tuple(s) for s in jman.iter_manifest(path)]
    for kw in (dict(min_duration=0.5, max_duration=2.0), dict(max_number=4),
               dict(sort_by_duration=True)):
        got = pman.read_manifest(f"{path},{path}", **kw)
        want = jman.read_manifest(f"{path},{path}", **kw)
        assert [as_tuple(s) for s in got] == [as_tuple(s) for s in want], kw


@pytest.mark.parametrize("num_workers", [0, 2])
def test_bucket_plan_and_batches_match_jax(tmp_path, num_workers):
    path = _write_corpus(tmp_path)
    model = os.path.join(FIXTURES, "sp_bpe_bytefallback.model")
    port_ds = pds.BucketedAudioTextDataset(pman.read_manifest(path),
                                           ptok.SentencePieceTokenizer(model), n_buckets=3)
    ref_ds = jds.BucketedAudioTextDataset(jman.read_manifest(path),
                                          jtok.SentencePieceTokenizer(model), n_buckets=3)
    assert port_ds.boundaries == ref_ds.boundaries
    assert port_ds.token_caps == ref_ds.token_caps
    assert port_ds.bucket_of == ref_ds.bucket_of
    kw = dict(shuffle=True, seed=3, bucketing_batch_size=[4, 3, 2])
    port = pds.BucketedLoader(port_ds, 4, num_workers=num_workers, **kw)
    ref = jds.BucketedLoader(ref_ds, 4, num_workers=0, **kw)
    for _ in range(2):  # two epochs
        assert port._plan() == ref._plan()
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            for field in ("audio", "audio_lens", "tokens", "token_lens"):
                np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
            assert g.texts == w.texts
            assert g.audio.dtype == np.float32
    assert (port_ds.boundaries == pds.make_bucket_boundaries(
        [s.duration for s in port_ds.samples], 3))
