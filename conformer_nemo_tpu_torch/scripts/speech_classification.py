"""Train, restore and run a speech-command classification (or VAD) model.

    python -m conformer_nemo_tpu_torch.scripts.speech_classification \
        --train-manifest train.json --val-manifest val.json \
        --labels yes no up down --max-steps 2000 --out model.cntpu [--device cpu]
    python -m conformer_nemo_tpu_torch.scripts.speech_classification \
        --model model.cntpu --predict a.wav b.wav [--device cpu]

Manifest rows carry `audio_filepath`, `duration` and a `label` (or
`command` / `target`). The archive restores in either package.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from conformer_nemo_tpu_torch.scripts.common import add_device_arg


def main(argv: Optional[Sequence[str]] = None):
    """-> (model, fit result or None, predictions or None)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-manifest")
    ap.add_argument("--val-manifest")
    ap.add_argument("--labels", nargs="*", default=None,
                    help="label set; default: extracted from the train manifest")
    ap.add_argument("--model", help="restore a portable .cntpu instead of training")
    ap.add_argument("--predict", nargs="*", default=None, help="audio files to classify")
    ap.add_argument("--max-steps", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--fixed-seconds", type=float, default=4.0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--features", type=int, default=64)
    ap.add_argument("--out", default=None)
    add_device_arg(ap)
    args = ap.parse_args(sys.argv[1:] if argv is None else list(argv))
    if not args.model and not args.train_manifest:
        ap.error("provide --train-manifest (to train) or --model (to restore)")

    from conformer_nemo_tpu_torch.api_label import ClassificationModel
    from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig

    result = preds = None
    if args.model:
        model = ClassificationModel.restore_portable(args.model, device=args.device)
    else:
        labels = args.labels
        if not labels:
            from conformer_nemo_tpu_torch.data.audio_to_label import (
                extract_labels,
                read_label_manifest,
            )

            labels = extract_labels(read_label_manifest(args.train_manifest))
            print(f"extracted {len(labels)} labels: {labels}", flush=True)
        model = ClassificationModel(labels=labels, mel=MelFeatureConfig(features=args.features),
                                    device=args.device)
        result = model.fit(args.train_manifest, args.val_manifest, max_steps=args.max_steps,
                           batch_size=args.batch_size, fixed_seconds=args.fixed_seconds,
                           lr=args.lr, augment=True)
        print(f"trained: {result['steps']} steps, "
              f"last={result['history'][-1] if result['history'] else None}", flush=True)
        if "val" in result:
            print(f"val: {result['val']}", flush=True)
        if args.out:
            model.save_portable(args.out)
            print(f"portable: {args.out}", flush=True)
    if args.predict:
        preds = model.predict(args.predict, fixed_seconds=args.fixed_seconds)
        for path, label in zip(args.predict, preds):
            print(f"{path}\t{label}", flush=True)
    return model, result, preds


if __name__ == "__main__":
    main()
