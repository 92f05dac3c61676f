"""WER or CER of a portable `.cntpu` model on a manifest, greedy decoding.

    python -m conformer_nemo_tpu_torch.scripts.evaluate \
        --model model.cntpu --manifest test.json [--model-type rnnt] [--cer] [--device cpu]

The beam strategies (rnnt: beam, beam_batch, tsd, alsd, maes; ctc:
beamsearch_ngram) and an n-gram LM (`--lm-path`) are not ported yet and
raise before any work.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from conformer_nemo_tpu_torch.decode.rnnt_decoding import BEAM as RNNT_BEAM
from conformer_nemo_tpu_torch.scripts.common import add_device_arg, parse_overrides

# the JAX package's beam strategies, not ported yet
BEAM = {"ctc": ("beamsearch_ngram",), "rnnt": RNNT_BEAM}


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
                    help="rnnt: greedy_batch | greedy; ctc: greedy")
    # the JAX script's beam options, accepted so its command lines run here
    ap.add_argument("--beam-size", type=int, default=4)
    ap.add_argument("--lm-path", default=None)
    ap.add_argument("--beam-alpha", type=float, default=1.0)
    ap.add_argument("--beam-beta", type=float, default=1.5)
    ap.add_argument("--kenlm-bin", "--kenlm-probing", dest="kenlm_bin", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(leftover)
    strategy = args.decoding_strategy
    if args.lm_path or strategy in BEAM[args.model_type]:
        raise NotImplementedError(
            f"decoding strategy {strategy!r}{' with an n-gram LM' if args.lm_path else ''} is not "
            "ported yet (ROADMAP.md queue 1 item 8); greedy decoding is")
    if args.model_type == "ctc" and strategy not in (None, "greedy"):
        raise ValueError(f"unknown CTC decoding strategy {strategy!r}")

    from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer
    from conformer_nemo_tpu_torch.data.manifest import read_manifest
    from conformer_nemo_tpu_torch.decode.wer import word_error_rate

    cls = ConformerCTC if args.model_type == "ctc" else ConformerTransducer
    model = cls.restore_portable(args.model, device=args.device)
    if strategy and args.model_type == "rnnt":
        model.change_decoding_strategy({"strategy": strategy, "greedy": {"max_symbols": 10}})
    samples = read_manifest(args.manifest)
    hyps = model.transcribe([s.audio_file for s in samples], batch_size=args.batch_size)
    metric = word_error_rate(hyps, [s.text for s in samples], use_cer=args.cer)
    print(f"{'CER' if args.cer else 'WER'}: {metric:.4f}  ({len(samples)} utts)", flush=True)
    return metric


if __name__ == "__main__":
    main()
