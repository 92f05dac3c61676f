"""Offline transcription from a portable `.cntpu` archive (either package's).

    python -m conformer_nemo_tpu_torch.scripts.transcribe_speech \
        --model model.cntpu [--model-type ctc|rnnt] [--device cpu] \
        --audio a.wav b.wav [--manifest test.json --wer] [--output hyps.jsonl] \
        [--timestamps [--ctm-dir DIR]]

Prints one `path<TAB>text` line per file. With --timestamps, each file's
words follow as `  start end  word` lines, --ctm-dir writes one
`<name>.ctm` per file (`<name> 1 <start> <duration> <word> <prob>`), and
--output's JSONL rows gain their `words`: the JAX script's output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from conformer_nemo_tpu_torch.scripts.common import add_device_arg, parse_overrides


def main(argv: Optional[Sequence[str]] = None) -> list:
    """-> the texts, in the order of --audio then the manifest's files."""
    _, leftover = parse_overrides(sys.argv[1:] if argv is None else list(argv))
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True, help=".cntpu portable archive")
    ap.add_argument("--model-type", choices=["ctc", "rnnt"], default="ctc")
    ap.add_argument("--audio", nargs="*", default=[])
    ap.add_argument("--manifest", default=None)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--wer", action="store_true")
    ap.add_argument("--output", default=None, help="write hypotheses JSONL")
    ap.add_argument("--timestamps", action="store_true",
                    help="emit word timestamps; with --ctm-dir, write one .ctm per file")
    ap.add_argument("--ctm-dir", default=None)
    add_device_arg(ap)
    args = ap.parse_args(leftover)

    from conformer_nemo_tpu_torch.api import ConformerCTC, ConformerTransducer
    from conformer_nemo_tpu_torch.data.manifest import read_manifest
    from conformer_nemo_tpu_torch.decode.timestamps import word_ctm_line
    from conformer_nemo_tpu_torch.decode.wer import word_error_rate

    cls = ConformerCTC if args.model_type == "ctc" else ConformerTransducer
    model = cls.restore_portable(args.model, device=args.device)
    paths, refs = list(args.audio), []
    if args.manifest:
        for s in read_manifest(args.manifest):
            paths.append(s.audio_file)
            refs.append(s.text)
    hyps = model.transcribe(paths, batch_size=args.batch_size)
    for p, h in zip(paths, hyps):
        print(f"{p}\t{h}")
    word_ts = None
    if args.timestamps:
        word_ts = model.transcribe_with_timestamps(paths, batch_size=args.batch_size)
        for words in word_ts:
            for w in words:
                print(f"  {w.start_s:7.2f} {w.start_s + w.duration_s:7.2f}  {w.word}")
        if args.ctm_dir:
            os.makedirs(args.ctm_dir, exist_ok=True)
            for p, words in zip(paths, word_ts):
                uniq = os.path.splitext(os.path.basename(p))[0]
                out = os.path.join(args.ctm_dir, uniq + ".ctm")
                with open(out, "w", encoding="utf-8") as f:
                    for w in words:
                        f.write(word_ctm_line(uniq, w) + "\n")
                print(f"wrote {out}")
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            for i, (p, h) in enumerate(zip(paths, hyps)):
                row = {"audio_filepath": p, "pred_text": h}
                if word_ts is not None:
                    row["words"] = [{"word": w.word, "start": round(w.start_s, 3),
                                     "end": round(w.start_s + w.duration_s, 3)}
                                    for w in word_ts[i]]
                f.write(json.dumps(row) + "\n")
    if args.wer and refs:
        print(f"WER: {word_error_rate(hyps[-len(refs):], refs):.4f}")
    sys.stdout.flush()
    return hyps


if __name__ == "__main__":
    main()
