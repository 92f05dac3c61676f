"""WER or CER of a portable `.cntpu` model on a manifest.

    python -m conformer_nemo_tpu_torch.scripts.evaluate \
        --model model.cntpu --manifest test.json [--model-type rnnt] [--cer] [--device cpu] \
        [--decoding-strategy S] [--beam-size N] [--lm-path lm.arpa] [--beam-alpha A] \
        [--beam-beta B] [--kenlm-bin]

The JAX script's options and decoding configs: for rnnt, --decoding-strategy
greedy | greedy_batch | beam | tsd | alsd | maes | beam_batch with
{"greedy": {"max_symbols": 10}, "beam": {"beam_size": --beam-size,
"tsd_max_sym_exp": 2}}; for ctc, greedy | beamsearch_ngram with beam_width
--beam-size, alpha, beta, an n-gram LM (ARPA text, or a probing or
trie-family KenLM .bin with --kenlm-bin) and kenlm_bin.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from conformer_nemo_tpu_torch.decode.rnnt_decoding import BEAM as RNNT_BEAM
from conformer_nemo_tpu_torch.decode.rnnt_decoding import GREEDY as RNNT_GREEDY
from conformer_nemo_tpu_torch.scripts.common import add_device_arg, parse_overrides

STRATEGIES = {"ctc": ("greedy", "beamsearch_ngram"), "rnnt": RNNT_GREEDY + RNNT_BEAM}
NAMES = {"ctc": "CTC", "rnnt": "RNN-T"}


def decoding_config(args) -> dict:
    """The JAX script's decoding config for --decoding-strategy."""
    if args.model_type == "rnnt":
        return {"strategy": args.decoding_strategy, "greedy": {"max_symbols": 10},
                "beam": {"beam_size": args.beam_size, "tsd_max_sym_exp": 2}}
    return {"strategy": args.decoding_strategy,
            "beam": {"beam_width": args.beam_size, "alpha": args.beam_alpha,
                     "beta": args.beam_beta, "lm_path": args.lm_path,
                     "kenlm_bin": args.kenlm_bin}}


def main(argv: Optional[Sequence[str]] = None) -> float:
    """-> the WER (or CER)."""
    _, leftover = parse_overrides(sys.argv[1:] if argv is None else list(argv))
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--model-type", choices=["ctc", "rnnt"], default="ctc")
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--cer", action="store_true")
    ap.add_argument("--decoding-strategy", default=None,
                    help="rnnt: greedy_batch | beam_batch | beam | tsd | alsd | maes; "
                         "ctc: greedy | beamsearch_ngram")
    ap.add_argument("--beam-size", type=int, default=4)
    ap.add_argument("--lm-path", default=None,
                    help="n-gram LM for ctc beamsearch_ngram: ARPA text, or a probing or "
                         "trie-family KenLM .bin with --kenlm-bin")
    ap.add_argument("--beam-alpha", type=float, default=1.0)
    ap.add_argument("--beam-beta", type=float, default=1.5)
    ap.add_argument("--kenlm-bin", "--kenlm-probing", dest="kenlm_bin", action="store_true",
                    help="read probing and trie-family (incl. -a array) KenLM .bin LMs "
                         "directly (decode/ctc_beam.py BeamSearchDecoderWithLM)")
    add_device_arg(ap)
    args = ap.parse_args(leftover)
    strategy = args.decoding_strategy
    if strategy and strategy not in STRATEGIES[args.model_type]:  # before any work
        raise ValueError(f"unknown {NAMES[args.model_type]} decoding strategy {strategy!r}")

    from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer
    from conformer_nemo_tpu_torch.data.manifest import read_manifest
    from conformer_nemo_tpu_torch.decode.wer import word_error_rate

    cls = ConformerCTC if args.model_type == "ctc" else ConformerTransducer
    model = cls.restore_portable(args.model, device=args.device)
    if strategy:
        model.change_decoding_strategy(decoding_config(args))
    samples = read_manifest(args.manifest)
    hyps = model.transcribe([s.audio_file for s in samples], batch_size=args.batch_size)
    metric = word_error_rate(hyps, [s.text for s in samples], use_cer=args.cer)
    print(f"{'CER' if args.cer else 'WER'}: {metric:.4f}  ({len(samples)} utts)", flush=True)
    return metric


if __name__ == "__main__":
    main()
