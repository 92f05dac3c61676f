"""Train a BPE tokenizer from manifest transcripts (port of
scripts/train_tokenizer.py).

    python -m conformer_nemo_tpu_torch.scripts.train_tokenizer --manifest train.json \
        --vocab-size 128 --out tokenizer_dir/ [--no-lowercase]

Writes `tokenizer_dir/tokenizer.json`: the JAX script's tokenizer (Hugging
Face tokenizers' BpeTrainer at its defaults over NFKC + Lowercase and
Metaspace), trained by the port's own `data.bpe_trainer`, without the
`tokenizers` package. Host-only: it takes no device.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from conformer_nemo_tpu_torch.data.bpe_trainer import train_bpe_tokenizer
from conformer_nemo_tpu_torch.data.manifest import read_manifest


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--vocab-size", type=int, default=128)
    ap.add_argument("--out", required=True)
    ap.add_argument("--no-lowercase", action="store_true")
    args = ap.parse_args(argv)

    texts = [s.text for s in read_manifest(args.manifest)]
    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, "tokenizer.json")
    tok = train_bpe_tokenizer(texts, vocab_size=args.vocab_size, out_path=out_path,
                              lowercase=not args.no_lowercase)
    print(f"trained {tok.vocab_size}-piece tokenizer -> {out_path}")
    return tok


if __name__ == "__main__":
    main()
