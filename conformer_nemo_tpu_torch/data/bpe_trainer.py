"""Train a BPE `tokenizer.json` without the `tokenizers` package.

The JAX package's `train_bpe_tokenizer` (conformer_nemo_tpu/data/
tokenizers.py) trains with Hugging Face tokenizers' `BpeTrainer` at its
defaults; a host may lack that package, so this module does the same
training in Python and writes the same `tokenizer.json`:

- normalizer: NFKC, then Lowercase (unless lowercase=False);
- pre-tokenizer and decoder: Metaspace ("▁", prepend "always", split);
- model: BPE with unk_token "<unk>", no continuing-subword prefix, no
  end-of-word suffix, no dropout;
- `<unk>` as the one special token: id 0 and an added token.

The training is BpeTrainer's: the words are the pre-tokenized pieces of
the normalized texts, counted; the vocabulary starts with `<unk>`, then
every character of the words in code-point order; each merge takes the
pair of adjacent symbols with the highest count over all words (weighted
by the word's count), ties going to the smaller (left id, right id); the
merged token gets the next id unless that string is already a token; it
stops at `vocab_size` tokens or when no pair is left. Counts update
lazily as the library's do: a queue of (count, pair, the words it was
seen in), an entry whose count has gone stale pushed back with the
current one, and each merge's new pairs queued with the words they formed
in. The normalizer and the pre-tokenizer are the port's reader's
(`hf_tokenizer`), which encode as the library does, so a text is split
into the same words in training and in encoding.
"""

from __future__ import annotations

import heapq
import itertools
import json
import os
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Tuple

from conformer_nemo_tpu_torch.data.hf_tokenizer import (
    HFJsonTokenizer,
    _normalizer,
    _pre_tokenizer,
)

UNK = "<unk>"
METASPACE = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
             "split": True}


def normalizer_spec(lowercase: bool = True) -> dict:
    norms = [{"type": "NFKC"}] + ([{"type": "Lowercase"}] if lowercase else [])
    return {"type": "Sequence", "normalizers": norms}


def count_words(texts: Iterable[str], lowercase: bool = True) -> Dict[str, int]:
    """{word: count} of the texts' pre-tokenized pieces after normalizing,
    in the order the words first appear."""
    normalize = _normalizer(normalizer_spec(lowercase))
    pre_tokenize = _pre_tokenizer(METASPACE)
    counts: Counter = Counter()
    for text in texts:
        counts.update(w for w, _ in pre_tokenize([(normalize(text), True)]))
    return dict(counts)


def _merge(symbols: List[int], a: int, b: int, new: int) -> List[Tuple[Tuple[int, int], int]]:
    """Replace every (a, b) of `symbols` by `new`, left to right, in place.
    -> the changes of pair counts within the word: ((left, right), +-1)."""
    changes = []
    i = 0
    while i < len(symbols):
        if symbols[i] == a and i + 1 < len(symbols) and symbols[i + 1] == b:
            if i > 0:
                changes.append(((symbols[i - 1], a), -1))
                changes.append(((symbols[i - 1], new), 1))
            symbols[i:i + 2] = [new]
            if i < len(symbols) - 1:
                changes.append(((b, symbols[i + 1]), -1))
                changes.append(((new, symbols[i + 1]), 1))
        i += 1
    return changes


def train_bpe(word_counts: Dict[str, int], vocab_size: int,
              special_tokens: Tuple[str, ...] = (UNK,)) -> Tuple[Dict[str, int], List[list]]:
    """BpeTrainer's training over {word: count}. -> (vocab {token: id},
    merges [[left, right], ...] in the order made)."""
    vocab: Dict[str, int] = {}
    tokens: List[str] = []

    def add(token: str) -> int:
        if token not in vocab:
            vocab[token] = len(tokens)
            tokens.append(token)
        return vocab[token]

    for t in special_tokens:
        add(t)
    for c in sorted({c for w in word_counts for c in w}, key=ord):
        add(c)
    words = [[vocab[c] for c in w] for w in word_counts]
    counts = list(word_counts.values())

    pair_counts: Dict[Tuple[int, int], int] = defaultdict(int)
    where: Dict[Tuple[int, int], set] = defaultdict(set)
    for i, (w, n) in enumerate(zip(words, counts)):
        for pair in zip(w, w[1:]):
            pair_counts[pair] += n
            where[pair].add(i)
    # a max-queue by count, then the smaller pair; `seq` orders equal entries
    queue: list = []
    seq = itertools.count()

    def push(pair, count, pos):
        heapq.heappush(queue, (-count, pair, next(seq), pos))

    def push_new():
        for pair, pos in where.items():
            if pair_counts[pair] > 0:
                push(pair, pair_counts[pair], pos)
        where.clear()

    push_new()
    merges: List[list] = []
    while len(vocab) < vocab_size and queue:
        neg, pair, _, pos = heapq.heappop(queue)
        if -neg != pair_counts[pair]:  # stale: back with the current count
            push(pair, pair_counts[pair], pos)
            continue
        if -neg < 1:
            break
        new = add(tokens[pair[0]] + tokens[pair[1]])
        merges.append([tokens[pair[0]], tokens[pair[1]]])
        for i in pos:
            for p, change in _merge(words[i], pair[0], pair[1], new):
                pair_counts[p] += change * counts[i]
                if change > 0:
                    where[p].add(i)
        push_new()
    return vocab, merges


def tokenizer_json(vocab: Dict[str, int], merges: List[list], lowercase: bool = True) -> dict:
    """The `tokenizer.json` of a trained BPE, as `Tokenizer.save` writes it."""
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": vocab[UNK], "content": UNK, "single_word": False,
                          "lstrip": False, "rstrip": False, "normalized": False,
                          "special": True}],
        "normalizer": normalizer_spec(lowercase),
        "pre_tokenizer": dict(METASPACE),
        "post_processor": None,
        "decoder": dict(METASPACE),
        "model": {"type": "BPE", "dropout": None, "unk_token": UNK,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }


def train_bpe_tokenizer(texts: Iterable[str], vocab_size: int, out_path: str,
                        lowercase: bool = True) -> HFJsonTokenizer:
    """Train a BPE tokenizer on transcripts and write its `tokenizer.json`
    to out_path. -> the written file, read back."""
    vocab, merges = train_bpe(count_words(texts, lowercase), vocab_size)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(tokenizer_json(vocab, merges, lowercase), f, ensure_ascii=False, indent=2)
    return HFJsonTokenizer(out_path)
