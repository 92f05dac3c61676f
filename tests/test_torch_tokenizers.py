"""The port's tokenizers against the JAX package's, on the same strings:
token ids equal (exactly) and texts equal (exactly).

- aggregate (multilang): the fixture SentencePiece models as `en` (BPE,
  byte fallback) and `es` (unigram), ids per language and mixed-language
  decodes, including ids on both sides of each offset;
- word (`type: word`, vocab file or dir), `vocab.txt` char labels (case
  kept), the "en" char parser over awkward strings (numbers, money, times,
  ordinals, abbreviations, accents, punctuation);
- `tokenizer.json` through the port's own reader against the JAX
  `HFTokenizer` (the `tokenizers` package): the JAX package's own
  `train_bpe_tokenizer` output (NFKC + Lowercase, Metaspace, BPE) and a
  BERT-style WordPiece file;
- `build_tokenizer` follows the JAX package's precedence case for case;
  an unknown parser or tokenizer.json component raises, naming it.
"""

import json
import os

import pytest
from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers, trainers

from conformer_nemo_tpu.data import tokenizers as jt
from conformer_nemo_tpu_torch.data import tokenizers as pt
from conformer_nemo_tpu_torch.data.hf_tokenizer import HFJsonTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
EN, ES = os.path.join(FIXTURES, "sp_bpe_bytefallback.model"), os.path.join(FIXTURES,
                                                                          "sp_unigram.model")
with open(os.path.join(FIXTURES, "sp_corpus.txt"), encoding="utf-8") as _f:
    CORPUS = [line.strip() for line in _f if line.strip()]
AWKWARD = [
    "", " ", "  Hello   World  ", "naïve café ÉCOLE", "x\ty\nz", "中文字符 test",
    "don't stop, it's fine!", "[UNK] abc <unk>", "ǅemal ﬁne", "a--b...c??", "😀 emoji",
    "ab́c", "\x00\x01ctrl", "Dr. Smith paid $5.50 at 10:30am on the 21st of Jan.",
    "1,234,567 people & 3% more + 12 co. st. mr. 2.5", "$1 and $1,000,000.01", "7th 22nd 3rd",
    "Mrs. O'Neil's 100 km/h — “quoted” text…", "ÀÉÎÕÜ çñ ß", "12:00 9:05pm 1999",
]
AGG_CFG = {"type": "agg", "langs": {"en": {"model_file": EN}, "es": {"model_file": ES}}}


def test_aggregate_ids_and_texts_match_jax():
    port, ref = pt.build_tokenizer(AGG_CFG), jt.build_tokenizer(AGG_CFG)
    assert port.vocab_size == ref.vocab_size == 295 + 288
    assert port.offsets == ref.offsets == {"en": 0, "es": 295}
    for text in CORPUS + AWKWARD:
        for lang in ("en", "es"):
            ids = port.text_to_ids(text, lang)
            assert ids == ref.text_to_ids(text, lang), (text, lang)
            assert port.ids_to_text(ids) == ref.ids_to_text(ids)
    # runs of both languages, and the ids about each offset
    mixed = (port.text_to_ids(CORPUS[0], "en") + port.text_to_ids(CORPUS[1], "es")
             + port.text_to_ids(CORPUS[2], "en") + [0, 294, 295, 296, 582])
    assert port.ids_to_text(mixed) == ref.ids_to_text(mixed)
    assert [port._owner(i) for i in (0, 294, 295, 582)] == [
        ("en", 0), ("en", 294), ("es", 0), ("es", 287)]
    with pytest.raises(ValueError, match="out of range"):
        port.ids_to_text([-1])


def test_word_and_vocab_txt_tokenizers_match_jax(tmp_path):
    words = ["hello", "world", "the", "cat", "<unk>"]
    (tmp_path / "vocab.txt").write_text("\n".join(words) + "\n", encoding="utf-8")
    for cfg in ({"type": "word", "dir": str(tmp_path)},
                {"type": "word", "vocab_file": str(tmp_path / "vocab.txt")}):
        port, ref = pt.build_tokenizer(cfg), jt.build_tokenizer(cfg)
        assert port.vocab_size == ref.vocab_size
        for text in ("hello world", "the dog  cat ", "", "Hello"):
            assert port.text_to_ids(text) == ref.text_to_ids(text)
            assert port.ids_to_text(port.text_to_ids(text)) == ref.ids_to_text(
                ref.text_to_ids(text))
    chars = tmp_path / "chars"
    chars.mkdir()
    (chars / "vocab.txt").write_text("\n".join([" ", "a", "B", "c", "ñ"]), encoding="utf-8")
    port, ref = (m.build_tokenizer({"type": "wpe", "dir": str(chars)}) for m in (pt, jt))
    assert isinstance(port, pt.CharTokenizer)
    for text in ("aB c", "ABC abc", " ñaB "):
        assert port.text_to_ids(text) == ref.text_to_ids(text)
        assert port.ids_to_text(port.text_to_ids(text)) == ref.ids_to_text(ref.text_to_ids(text))


def test_en_parser_matches_jax():
    labels = [" ", *"abcdefghijklmnopqrstuvwxyz", "'"]
    port, ref = pt.CharTokenizer(labels, parser="en"), jt.CharTokenizer(labels, parser="en")
    base = pt.CharTokenizer(labels)
    changed = 0
    for text in CORPUS + AWKWARD:
        ids = port.text_to_ids(text)
        assert ids == ref.text_to_ids(text), text
        assert port.ids_to_text(ids) == ref.ids_to_text(ids)
        changed += ids != base.text_to_ids(text)
    assert changed >= 10  # the parser really ran: numbers, money and accents became words
    assert port.ids_to_text(port.text_to_ids("$5.50")) == "five dollars and fifty cents"
    for mod in (pt, jt):
        with pytest.raises(ValueError, match="unknown parser"):
            mod.CharTokenizer(labels, parser="de")


@pytest.fixture(scope="module")
def hf_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf")
    bpe = str(d / "bpe.json")
    jt.train_bpe_tokenizer(CORPUS, 120, bpe)  # the JAX package's own trainer
    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer(lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.decoder = decoders.WordPiece()
    tok.train_from_iterator(CORPUS, trainers.WordPieceTrainer(vocab_size=150,
                                                              special_tokens=["[UNK]", "[PAD]"]))
    wp = str(d / "wp.json")
    tok.save(wp)
    # byte-level fallback, fused unknowns and a suffix-style BPE with ByteFallback+Fuse decoders
    tok = Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=True, byte_fallback=True,
                               end_of_word_suffix="</w>"))
    tok.normalizer = normalizers.Sequence([normalizers.NFD(), normalizers.StripAccents(),
                                           normalizers.Strip()])
    tok.pre_tokenizer = pre_tokenizers.Sequence([pre_tokenizers.WhitespaceSplit(),
                                                 pre_tokenizers.Punctuation()])
    tok.decoder = decoders.Sequence([decoders.ByteFallback(), decoders.BPEDecoder()])
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=160, special_tokens=["<unk>", "<0x41>", "<0xC3>", "<0xA9>"],
        end_of_word_suffix="</w>"))
    bpe2 = str(d / "bpe_suffix.json")
    tok.save(bpe2)
    # the SentencePiece-style layout of many published BPE files: no
    # pre-tokenizer, spaces replaced in the normalizer, a decoder chain
    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=140, special_tokens=["<unk>", "<0xC3>", "<0xA9>", "<0xE4>"]))
    sp_style = str(d / "sp_style.json")
    tok.save(sp_style)
    # Whitespace and the other split behaviours, NFKD, a continuing-subword prefix
    tok = Tokenizer(models.BPE(unk_token="<unk>", continuing_subword_prefix="##"))
    tok.normalizer = normalizers.Sequence([normalizers.NFKD(), normalizers.Lowercase()])
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.WhitespaceSplit(), pre_tokenizers.Punctuation("contiguous"),
        pre_tokenizers.Punctuation("merged_with_previous"), pre_tokenizers.Whitespace()])
    tok.decoder = decoders.WordPiece()
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=130, special_tokens=["<unk>"], continuing_subword_prefix="##"))
    splits = str(d / "splits.json")
    tok.save(splits)
    return {"bpe": bpe, "wordpiece": wp, "bpe_suffix": bpe2, "sp_style": sp_style,
            "splits": splits}


@pytest.mark.parametrize("kind", ["bpe", "wordpiece", "bpe_suffix", "sp_style", "splits"])
def test_tokenizer_json_matches_jax_hf_tokenizer(hf_files, kind, tmp_path):
    path = hf_files[kind]
    port, ref = HFJsonTokenizer(path), jt.HFTokenizer(path)
    assert port.vocab_size == ref.vocab_size
    for text in CORPUS + AWKWARD + ["é É", "A <0x41> B"]:
        ids = port.text_to_ids(text)
        assert ids == ref.text_to_ids(text), (kind, text)
        assert port.ids_to_text(ids) == ref.ids_to_text(ids), (kind, text)
    # the builder's dir rule reads tokenizer.json first
    d = tmp_path / "dir"
    d.mkdir()
    with open(path, encoding="utf-8") as f:
        (d / "tokenizer.json").write_text(f.read(), encoding="utf-8")
    with open(EN, "rb") as f:
        (d / "tokenizer.model").write_bytes(f.read())
    assert isinstance(pt.build_tokenizer({"dir": str(d)}), HFJsonTokenizer)
    assert pt.build_tokenizer({"dir": str(d)}).text_to_ids(CORPUS[0]) == \
        jt.build_tokenizer({"dir": str(d)}).text_to_ids(CORPUS[0])


@pytest.mark.parametrize("section,value,name", [
    ("pre_tokenizer", {"type": "ByteLevel", "add_prefix_space": False}, "ByteLevel"),
    ("normalizer", {"type": "Precompiled", "precompiled_charsmap": ""}, "Precompiled"),
    ("decoder", {"type": "CTC"}, "CTC"),
    ("post_processor", {"type": "TemplateProcessing"}, "TemplateProcessing"),
])
def test_tokenizer_json_unknown_component_raises(hf_files, tmp_path, section, value, name):
    with open(hf_files["bpe"], encoding="utf-8") as f:
        spec = json.load(f)
    spec[section] = value
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec), encoding="utf-8")
    with pytest.raises(NotImplementedError, match=name):
        HFJsonTokenizer(str(path))


def test_build_tokenizer_cases_follow_jax(tmp_path):
    """labels, agg, word, model_file, then dir's tokenizer.json >
    tokenizer.model > vocab.txt; an empty dir raises as the JAX builder does."""
    assert isinstance(pt.build_tokenizer({"labels": ["a", "b"]}), pt.CharTokenizer)
    assert isinstance(pt.build_tokenizer(AGG_CFG), pt.AggregateTokenizer)
    assert isinstance(pt.build_tokenizer({"model_file": ES}), pt.SentencePieceTokenizer)
    d = tmp_path / "sp"
    d.mkdir()
    with open(ES, "rb") as f:
        (d / "tokenizer.model").write_bytes(f.read())
    (d / "vocab.txt").write_text("a\nb\n", encoding="utf-8")
    assert isinstance(pt.build_tokenizer({"type": "bpe", "dir": str(d)}),
                      pt.SentencePieceTokenizer)
    nested = {"type": "agg", "langs": {"en": {"type": "bpe", "dir": str(d)},
                                       "es": {"model_file": EN}}}
    port, ref = pt.build_tokenizer(nested), jt.build_tokenizer(nested)
    assert port.text_to_ids("hola", "en") == ref.text_to_ids("hola", "en")
    empty = tmp_path / "empty"
    empty.mkdir()
    for mod in (pt, jt):
        with pytest.raises(FileNotFoundError, match="no tokenizer artifacts"):
            mod.build_tokenizer({"dir": str(empty)})
    with pytest.raises(ValueError, match="neither model_file nor dir"):
        pt.build_tokenizer({"type": "bpe", "dir": "???"})
